"""Shared inputs for the tests of the PyTorch port (tests/test_torch_port_*.py):
the same records, samples and weights for the JAX package and the port."""
import jax
import numpy as np
import torch

from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate

# PyTorch on one thread for the whole test process, set once at import: every
# xdist worker collects every test file, and the workers share the machine's
# cores, which a port step's many small ops would otherwise oversubscribe.
torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # inter-op work already started in this process
    pass

SCALER_KINDS = {"area_scaler": "standard", "edge_length_scaler": "standard"}
# small but fast: the verify recipe's 16x16, 3-scale corpus
GEN_KW = dict(seed=0, nx=16, ny=16, num_scales=3, total_hours=12, substeps=8)


def temporal_samples(ds, records, previous_t=2, rollout_steps=4):
    """Scalers fitted on all records, one union spec, samples of record 0."""
    scalers = ds.fit_dataset_scalers(records, SCALER_KINDS)
    procs = [ds.process_record(r, scalers) for r in records]
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 8)
                          for r in records])
    return spec, ds.to_temporal_samples(procs[0], spec, previous_t=previous_t,
                                        rollout_steps=rollout_steps)


def sample_pair(n_records=2, previous_t=2, rollout_steps=4, index=1, num_scales=3):
    """(JAX FloodGraph, port FloodGraph) of the same temporal sample, on the
    16x16 corpus in ``num_scales`` scales."""
    gen_kw = dict(GEN_KW, num_scales=num_scales)
    _, jg = temporal_samples(jax_dataset, jax_generate(n_records, **gen_kw),
                             previous_t, rollout_steps)
    _, tg = temporal_samples(port_dataset, port_generate(n_records, **gen_kw),
                             previous_t, rollout_steps)
    return jg[index], tg[index]


def numpy_tree(params):
    """A JAX parameter pytree as nested dicts/lists of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)


def jax_bench_sample(nx, ny, T, num_scales=3):
    """The sample of bench.py:75-120 (build_bench_problem) built by the JAX
    package at a small grid, without its model: padded to multiples of 128
    rows, as the band planner needs (``num_scales`` 1: the single-scale
    dual graph)."""
    from mswe_gnn_tpu.data.simulate import random_dem_fn
    from mswe_gnn_tpu.data.synthetic import make_multiscale_grid

    rng = np.random.default_rng(0)
    dem_fn = random_dem_fn(rng, extent=nx * 100.0, relief=4.0)
    mesh = make_multiscale_grid(nx, ny, 100.0, num_scales, dem_fn, n_bc=4)
    n = mesh.num_nodes
    wd = np.abs(rng.normal(0.4, 0.3, (n, T))).astype(np.float32)
    vx = rng.normal(0, 0.3, (n, T)).astype(np.float32)
    vy = rng.normal(0, 0.3, (n, T)).astype(np.float32)
    nbc = len(mesh.ghosts.ghost_nodes)
    bc = np.abs(rng.normal(0.2, 0.1, (nbc, T))).astype(np.float32)
    rec = jax_dataset.SimulationRecord(mesh=mesh, wd=wd, vx=vx, vy=vy,
                                       bc_per_length=bc, temporal_res=120.0)
    scalers = jax_dataset.fit_dataset_scalers([rec], SCALER_KINDS)
    proc = jax_dataset.process_record(rec, scalers)
    spec = jax_dataset.make_spec(mesh, nbc, pad_multiple=128)
    return jax_dataset.to_temporal_samples(proc, spec, previous_t=3, rollout_steps=-1)[0]


def bench_sample_pair(nx=16, ny=16, T=6, num_scales=3):
    """(JAX FloodGraph, port FloodGraph) of the bench problem's sample at an
    ``nx`` x ``ny`` grid with ``T`` frames in ``num_scales`` scales, both
    without a band plan."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_sample

    return (jax_bench_sample(nx, ny, T, num_scales),
            build_bench_sample(nx, ny, T, num_scales=num_scales)[0])


def without_subnormal_targets(jg, pg):
    """Both graphs with the subnormal entries of ``y`` set to 0. XLA on the
    CPU flushes subnormal floats to zero and PyTorch does not, so a target
    of 1e-40 would count as wet in one package and dry in the other (the
    synthetic solver leaves a few such depths)."""
    y = np.asarray(jg.y)
    y = np.where(np.abs(y) < np.finfo(np.float32).tiny, np.float32(0), y)
    return jg.replace(y=jax.numpy.asarray(y)), pg.replace(y=torch.from_numpy(y.copy()))
