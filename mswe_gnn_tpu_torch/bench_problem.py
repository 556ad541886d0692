"""The flagship problem of the JAX package's bench (bench.py:75-120), rebuilt
through the port: a 152x152 dk15-class grid in 3 scales, previous_t=3,
T=48 frames (a 47-step rollout), and the MSGNN of F=64, K=5, mlp_layers=3,
PReLU/tanh, with_WL and learned residuals, in bf16.

The state is random but plausible, drawn from seed 0 in the same order as
bench.py draws it, so both packages build the same graph. The weights are
initialised by the port from build_model's default seed (torch.Generator),
so they are not the JAX package's numbers.

``build_bench_sample(num_scales=1)`` gives the same grid's single-scale dual
graph (23,108 nodes, padded to 23,168), the graph of the single-scale GNN,
and ``build_pareto_gnn_model`` that model as ``configs/pareto_gnn.yaml``
defines it (GNN / SWEGNN, F=64, K=10, 2 layers, mlp_layers 3, float32,
251,604 parameters), through ``config.with_defaults`` as the CLI builds it.

``build_bench_sample(storm=True)`` gives the record storm fields
(``add_storm_forcing``: wind stress WX, WY and a pressure low P, three
forcing columns that the model appends to the static features at every
step), which ``build_bench_model`` counts among the node features.

``build_bench_sample(band=True)`` attaches the band plan with its defaults,
as bench.py:121-131 does; ``BenchTrainStep`` is the train step of
bench.py:304-341 (``bench_training``): a 6-step pushforward with remat,
``velocity_scaler=7.0`` and ``make_optimizer(opts, 1)``. The rollout problem
at batch b is ``concat_graphs([sample] * b)``, made by the caller as
bench.py:355-359 does; ``build_bench_train_step(batch=b)`` trains that union,
as bench.py:311-314 does (the union carries no band plan); its
``multiscale`` flag is False for the single-scale GNN.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from mswe_gnn_tpu_torch import config as config_lib
from mswe_gnn_tpu_torch import resolve_device, tree_leaves, tree_to
from mswe_gnn_tpu_torch.data.dataset import (
    SimulationRecord, fit_dataset_scalers, make_spec, process_record,
    to_temporal_samples,
)
from mswe_gnn_tpu_torch.data.simulate import random_dem_fn
from mswe_gnn_tpu_torch.data.synthetic import add_storm_forcing, make_multiscale_grid
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models.registry import build_model
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan
from mswe_gnn_tpu_torch.training.train import (Optimizer, TrainerOptions, clone_tree,
                                               make_optimizer, train_step)


NUM_SCALES, PREVIOUS_T = 3, 3
TRAIN_ROLLOUT_STEPS = 6
PARETO_GNN_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "configs", "pareto_gnn.yaml")


def build_bench_sample(nx=152, ny=152, T=48, band=False, num_scales=NUM_SCALES,
                       storm=False):
    """-> (full-rollout FloodGraph on the CPU, MultiscaleMesh). Smaller
    ``nx``/``ny``/``T`` give the same problem at a size the CPU tests take;
    ``band`` attaches the band plan (``attach_band_plan`` defaults);
    ``num_scales=1`` gives the grid's single-scale dual graph; ``storm``
    adds the storm fields of ``add_storm_forcing`` (seed 0), scaled per
    field (``forcing_scaler: standard``)."""
    mesh, rng_state = _bench_mesh(nx, ny, num_scales)
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    n = mesh.num_nodes
    wd = np.abs(rng.normal(0.4, 0.3, (n, T))).astype(np.float32)
    vx = rng.normal(0, 0.3, (n, T)).astype(np.float32)
    vy = rng.normal(0, 0.3, (n, T)).astype(np.float32)
    nbc = len(mesh.ghosts.ghost_nodes)
    bc = np.abs(rng.normal(0.2, 0.1, (nbc, T))).astype(np.float32)
    rec = SimulationRecord(mesh=mesh, wd=wd, vx=vx, vy=vy, bc_per_length=bc,
                           temporal_res=120.0)
    if storm:
        rec = add_storm_forcing(rec, seed=0)
    scalers = fit_dataset_scalers([rec], {"area_scaler": "standard",
                                          "edge_length_scaler": "standard",
                                          "forcing_scaler": "standard"})
    proc = process_record(rec, scalers)
    spec = make_spec(mesh, nbc, pad_multiple=128)
    sample = to_temporal_samples(proc, spec, previous_t=PREVIOUS_T,
                                 rollout_steps=-1)[0]
    if band:
        sample = attach_band_plan(sample)
    return sample, mesh


@functools.lru_cache(maxsize=None)
def _bench_mesh(nx, ny, num_scales):
    """The grid of ``build_bench_sample`` and the state of its seed-0
    generator after the terrain's draws, built once a process (its
    transfer edges take seconds at 152x152; the mesh is only read)."""
    rng = np.random.default_rng(0)
    dem_fn = random_dem_fn(rng, extent=nx * 100.0, relief=4.0)
    mesh = make_multiscale_grid(nx, ny, 100.0, num_scales, dem_fn, n_bc=4)
    return mesh, rng.bit_generator.state


def build_bench_model(sample, device=None, **overrides):
    """-> (cfg, params, apply_fn) of the bench model on ``device`` (default:
    the GPU), weights from build_model's default seed; ``overrides`` replace
    keys of its model dict (e.g. ``learned_pooling=True``)."""
    return build_model(
        {"model_type": "MSGNN", "hid_features": 64, "K": 5, "mlp_layers": 3,
         "learned_residuals": True, "with_WL": True, "gnn_activation": "tanh",
         "mlp_activation": "prelu", "compute_dtype": "bfloat16",
         "flat_hop_threshold": 2048, **overrides},
        num_node_features=sample.num_node_features,
        num_edge_features=sample.edge_attr.shape[1],
        num_scales=sample.spec.num_scales, previous_t=sample.previous_t,
        device=device)


def build_pareto_gnn_model(sample, device=None, **overrides):
    """-> (cfg, params, apply_fn) of ``configs/pareto_gnn.yaml``'s model
    (its ``models`` group over ``config.with_defaults``, as the CLI builds
    it; ``overrides`` replace keys of that group, e.g. ``type_GNN``) on
    ``device`` (default: the GPU), weights from the config's seed."""
    cfg = config_lib.with_defaults(config_lib.read_config(PARETO_GNN_CONFIG))
    return build_model(
        {**cfg["models"], **overrides},
        num_node_features=sample.num_node_features,
        num_edge_features=sample.edge_attr.shape[1],
        num_scales=sample.spec.num_scales,
        previous_t=cfg["temporal_dataset_parameters"]["previous_t"], device=device)


@dataclasses.dataclass
class BenchTrainStep:
    """The train step of bench_training on one graph, a union or a batch
    placed on a mesh (``parallel.sharding.MeshBatch``); calling it takes one
    step on the parameters' device, updates ``params`` in place and returns
    the loss (a tensor)."""
    apply_fn: object
    cfg: object
    params: dict
    graph: object
    opts: TrainerOptions
    optimizer: Optimizer
    opt_state: dict
    rollout_steps: int = TRAIN_ROLLOUT_STEPS
    multiscale: bool = True

    def __call__(self):
        _, _, loss = train_step(self.params, self.opt_state, self.graph,
                                apply_fn=self.apply_fn, cfg=self.cfg,
                                rollout_steps=self.rollout_steps, opts=self.opts,
                                multiscale=self.multiscale, optimizer=self.optimizer,
                                device=tree_leaves(self.params)[0].device)
        return loss


def build_bench_train_step(sample, cfg, params, apply_fn, device=None,
                           batch=1, multiscale=True) -> BenchTrainStep:
    """bench_training's settings on ``device`` (default: the GPU): the
    graph, or the union of ``batch`` copies of it, and a copy of the
    parameters moved there, a fresh optimizer; ``multiscale`` as the
    trainer passes it (False for the single-scale GNN)."""
    device = resolve_device(device)
    sample = concat_graphs([sample] * batch)
    opts = TrainerOptions(batch_size=batch, velocity_scaler=7.0, remat=True)
    optimizer = make_optimizer(opts, steps_per_epoch=1)
    params = clone_tree(tree_to(params, device))
    return BenchTrainStep(apply_fn=apply_fn, cfg=cfg, params=params,
                          graph=sample.to(device), opts=opts, optimizer=optimizer,
                          opt_state=optimizer.init(params), multiscale=multiscale)
