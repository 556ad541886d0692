"""Experiment CLI: config -> data -> train -> evaluate -> report (port of
mswe_gnn_tpu/main.py, modes ``train``, ``eval`` and ``sweep``):

  python3 -m mswe_gnn_tpu_torch.main train --config configs/synthetic.yaml --out runs/x
  python3 -m mswe_gnn_tpu_torch.main eval  --config ... --ckpt runs/x/best --out runs/x_eval
  python3 -m mswe_gnn_tpu_torch.main sweep --config configs/pareto.yaml \
      --sweep-id ENTITY/PROJECT/ID --count 4 --out runs/sweep

Runs on the GPU; ``--device cpu`` runs on the CPU, and without a GPU and
without ``--device`` it raises. Data comes from one of three sources, as the
config says:

- ``dataset_parameters.dataset_folder``: the reference's pickled datasets
  (``<folder>/train|test/<name>.pkl``, data/torch_compat.py);
- ``dataset_parameters.map_folder``: raw D-HYDRO map files
  (``output_<i>_map.nc`` and ``overview.csv``, data/netcdf.py; NetCDF-4 files
  need h5py, classic NetCDF-3 files do not);
- otherwise the built-in synthetic generator (``synthetic_data`` config
  group; grid or triangulated meshes, storm forcing), cached as ``.npz``
  under ``MSWE_DATA_CACHE`` (default ``runs/data_cache``).

A ``parallel: {mode, data, graph}`` block (JAX main.py:388-432) spreads the
training over devices, listed by ``--device`` as a comma-separated list
(which may repeat one device; default: every visible GPU):

- ``mode: gspmd`` (the default) with data x graph > 1: a ``data x graph``
  mesh filled row by row from the list (too few devices raise); each batch's
  graphs go over the data rows, each row's union over its graph devices
  (``parallel/sharding.py``, ``parallel/gspmd.py``);
- ``mode: ring_halo`` with graph = P > 1: the MSGNN over P ring partitions
  (``parallel/dist_swegnn.py``), one a device of a list of P; samples and
  test graphs are ring-reordered, batches hold one graph. ``data`` > 1
  gives the data = 1 result (JAX replicates the ring over ``data``; the
  port runs it once). For another model, or where the ring plan fails, the
  run falls back to the GSPMD mesh and says so, as JAX does; an MSGNN with
  learned pooling whose ring plan holds raises, as JAX's ring path
  asserts.

The test evaluation runs on the first device, as JAX's runs unsharded.

Several processes train one run (JAX main.py:334-357): ``--dist-num-processes
N --dist-process-id I [--dist-coordinator HOST:PORT]``, or ``MSWE_MULTIHOST=1``
under ``torchrun`` (``env://``). Each process holds ``data / N`` rows of the
mesh on its own devices (``--device`` lists one process's), builds the same
corpus, and trains its share of every global batch; loss pieces and
gradients are all-reduced. Only process 0 writes logs, checkpoints and the
summary; the others wait for it at the end. On a relaunch process 0 resumes
from its autosave and hands its whole state to the others
(``Trainer.sync_from_main``), so they need not share its directory. The
processes of one host are counted by ``--dist-local-rank`` /
``--dist-local-world`` or ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; without
them the run is taken to be on one host. The backend (printed) is NCCL when
the process runs on CUDA devices and its host has a card for every local
rank, else gloo: the CPU, or more ranks than cards, since NCCL refuses two
ranks on one card. A failed ``init_process_group`` or collective ends the
run with an error; nothing switches backend.

``train`` and ``eval`` write the report figures into ``--out`` (JAX
main.py:295-330): the summary figures of ``SpatialAnalysis.save_reports``
and the best / worst simulations' panels and videos. They need matplotlib;
where it is missing the CLI prints ``report figures skipped: matplotlib is
not installed`` and finishes. ``sweep`` runs ``--count`` trials under a
wandb sweep agent (``run_sweep``; needs wandb, one process only), each a
``train`` of the agent's overrides merged over the config into
``<out>/trial_<run id>``.
Checkpoints are the port's npz format (training/checkpoint.py); an orbax
checkpoint of the JAX package is converted first (tests/torch_port_convert.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch import config as config_lib
from mswe_gnn_tpu_torch import resolve_device
from mswe_gnn_tpu_torch.cache import enable_compilation_cache
from mswe_gnn_tpu_torch.data.dataset import (fit_dataset_scalers, make_spec,
                                             process_record, to_temporal_samples,
                                             union_spec)
from mswe_gnn_tpu_torch.data.netcdf import load_map_folder
from mswe_gnn_tpu_torch.data.npz_store import load_records, record_arrays, save_records
from mswe_gnn_tpu_torch.data.synthetic import GENERATOR_VERSION, generate_dataset
from mswe_gnn_tpu_torch.data.torch_compat import load_reference_pickle
from mswe_gnn_tpu_torch.graph import FloodGraph, concat_graphs
from mswe_gnn_tpu_torch.models import build_model, count_params
from mswe_gnn_tpu_torch.parallel.dist_swegnn import ring_plan_failure
from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn, prepare_ring_graphs
from mswe_gnn_tpu_torch.parallel.sharding import make_mesh, process_index
from mswe_gnn_tpu_torch.training.checkpoint import restore_params_only, save_checkpoint
from mswe_gnn_tpu_torch.training.rollout import rollout
from mswe_gnn_tpu_torch.training.train import Trainer, TrainerOptions
from mswe_gnn_tpu_torch.utils.analysis import SpatialAnalysis
from mswe_gnn_tpu_torch.utils.logging import MetricLogger
from mswe_gnn_tpu_torch.utils.visualization import PlotRollout, require_matplotlib

EXIT_RELAUNCH = 75      # --epoch-budget spent: relaunch to resume from the autosave


def _generate_cached(sd: Dict, temporal_res: float):
    """Synthetic records with a content-keyed ``.npz`` disk cache (the JAX
    package's key; the cache directory is ``MSWE_DATA_CACHE``, default
    ``runs/data_cache``; delete it to invalidate). Each writer writes its own
    temporary file and moves it into place atomically."""
    key_src = json.dumps({**sd, "temporal_res": temporal_res,
                          "gen_version": GENERATOR_VERSION}, sort_keys=True)
    cache_dir = os.environ.get("MSWE_DATA_CACHE", "runs/data_cache")
    path = os.path.join(cache_dir,
                        hashlib.sha256(key_src.encode()).hexdigest()[:16] + ".npz")
    if os.path.exists(path):
        return load_records(path)
    records = generate_dataset(
        sd["n_sims"], seed=sd.get("seed", 0), nx=sd["nx"], ny=sd["ny"],
        dx=sd.get("dx", 100.0), num_scales=sd["num_scales"],
        total_hours=sd["total_hours"], temporal_res=temporal_res,
        n_bc=sd.get("n_bc", 2), substeps=sd.get("substeps", 20),
        mesh_type=sd.get("mesh_type", "grid"),
        peak_discharge=float(sd.get("peak_discharge", 150.0)),
        storm=bool(sd.get("storm_forcing", False)))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        save_records(tmp, records)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return records


def corpus_digest(records: Sequence) -> str:
    """sha256 over every mesh array and the wd, vx, vy and bc_per_length
    series of ``records`` (key, dtype, shape and bytes of each, in order):
    equal digests mean the same corpus bit for bit."""
    h = hashlib.sha256()
    for i, rec in enumerate(records):
        for key, arr in record_arrays(rec, f"r{i}/").items():
            arr = np.ascontiguousarray(arr)
            h.update(f"{key}|{arr.dtype.str}|{arr.shape}|".encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _solver_label(cfg: Dict) -> str:
    """Which solver produced the test records' ``solver_seconds``: real
    D-HYDRO wall times ('dhydro') for map-NetCDF/pickle data, the built-in
    generator ('synthetic_solver', NOT comparable with the reference's
    speed-ups) otherwise."""
    dp = cfg.get("dataset_parameters", {})
    return ("dhydro" if dp.get("map_folder") or dp.get("dataset_folder")
            else "synthetic_solver")


def train_test_split(items: Sequence, test_size, random_state) -> Tuple[list, list]:
    """(train, test) lists as ``sklearn.model_selection.train_test_split(items,
    test_size=test_size, random_state=random_state)`` gives them (its
    ``ShuffleSplit``), in numpy: ``ceil(test_size * n)`` test items for a
    fraction (an int is a count), from ``RandomState(random_state)
    .permutation(n)``: its head is the test list and the rest the train
    list, each in permutation order."""
    n = len(items)
    n_test = (int(test_size) if isinstance(test_size, (int, np.integer))
              else int(math.ceil(float(test_size) * n)))
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} with {n} items leaves an empty split")
    perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def _load_reference_split(dp: Dict):
    """The reference's pickled datasets with the reference's split
    (reference utils/dataset.py:292-331): the train pickle
    ``<dataset_folder>/train/<train_dataset_name>.pkl`` shuffled by ``seed``
    and cut to ``train_size``; the test pickle from ``.../test/``, size 100,
    seed 0 (not shuffled); validation split off the train records."""
    folder = dp["dataset_folder"]
    seed = dp.get("seed", 42)
    train_records = load_reference_pickle(
        os.path.join(folder, "train", dp["train_dataset_name"] + ".pkl"),
        size=dp.get("train_size", 100), seed=seed)
    test_records = load_reference_pickle(
        os.path.join(folder, "test",
                     dp.get("test_dataset_name", dp["train_dataset_name"]) + ".pkl"),
        size=100, seed=0)
    val_prcnt = dp.get("val_prcnt", 0.25)
    if val_prcnt:
        train_records, val_records = train_test_split(train_records, val_prcnt, seed)
    else:
        val_records = train_records
    return train_records, val_records, test_records


def prepare_data(cfg: Dict) -> Tuple[List[FloodGraph], List[FloodGraph],
                                     List[FloodGraph], Dict, object]:
    """Build train/val/test temporal datasets (reference main.py:26-56).
    Reference pickles come with their own train and test files; from a map
    folder or the synthetic generator the last 20% of the records are the
    test split, and a seeded permutation of the rest gives validation and
    training."""
    sd = cfg["synthetic_data"]
    dp = cfg["dataset_parameters"]
    tdp = cfg["temporal_dataset_parameters"]
    rng = np.random.default_rng(dp.get("seed", 0))

    if dp.get("dataset_folder"):
        train_records, val_records, test_records = _load_reference_split(dp)
        records = train_records + val_records + test_records
    else:
        if dp.get("map_folder"):
            records = load_map_folder(
                dp["map_folder"], dp["temporal_res"],
                num_scales=sd.get("num_scales", 1),
                overview_file=dp.get("overview_file"),
                dem_folder=dp.get("dem_folder"),
                hydrograph_folder=dp.get("hydrograph_folder"),
                limit=dp.get("train_size"))
        else:
            records = _generate_cached(sd, dp["temporal_res"])

        n = len(records)
        n_test = max(1, int(round(n * 0.2)))
        test_records = records[-n_test:]
        pool = records[:-n_test]
        n_val = max(1, int(round(len(pool) * dp.get("val_prcnt", 0.25))))
        perm = rng.permutation(len(pool))
        val_records = [pool[i] for i in perm[:n_val]]
        train_records = [pool[i] for i in perm[n_val:]]

    scalers = fit_dataset_scalers(train_records, cfg["scalers"])
    feats = dict(node_features=cfg["selected_node_features"],
                 edge_features=cfg["selected_edge_features"],
                 slope_method=dp.get("slope_method", "edge"))
    # padded over ALL records, so that every sample shares one spec
    spec = union_spec([
        make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes),
                  pad_multiple=sd.get("pad_multiple", 64))
        for r in records])

    def build(records_, rollout_steps, params=None):
        params = params if params is not None else tdp
        out = []
        for r in records_:
            proc = process_record(r, scalers, **feats)
            out += to_temporal_samples(
                proc, spec, previous_t=params["previous_t"],
                rollout_steps=rollout_steps,
                time_start=params.get("time_start", 0),
                time_stop=params.get("time_stop", -1))
        return out

    train = build(train_records, tdp["rollout_steps"])
    val = build(val_records, -1)     # full-rollout validation (reference train.py:157)
    # test windowing falls back to train params minus rollout_steps
    # (reference utils/dataset.py:547-557)
    test_params = dict(config_lib.temporal_test_parameters(cfg),
                       previous_t=tdp["previous_t"])
    test = build(test_records, -1, params=test_params)
    return train, val, test, scalers, test_records


def build_experiment_model(cfg: Dict, sample: FloodGraph, device=None):
    """(model cfg, parameters on ``device``, apply) for the ``models`` group;
    the number of scales comes from the data (reference main.py:60)."""
    tdp = cfg["temporal_dataset_parameters"]
    return build_model(
        cfg["models"], num_node_features=sample.num_node_features,
        num_edge_features=sample.edge_attr.shape[1],
        num_scales=sample.spec.num_scales,
        previous_t=tdp["previous_t"], device=device)


def trainer_options(cfg: Dict) -> TrainerOptions:
    to, lr = cfg["trainer_options"], cfg["lr_info"]
    return TrainerOptions(
        type_loss=to["type_loss"], only_where_water=to["only_where_water"],
        batch_size=to["batch_size"], conservation=to["conservation"],
        velocity_scaler=to["velocity_scaler"],
        curriculum_epoch=to["curriculum_epoch"], patience=to["patience"],
        max_epochs=to["max_epochs"],
        best_metric=to.get("best_metric", "val_CSI_005"),
        watch_every=int(to.get("watch_every", 0)),
        remat=bool(to.get("remat", False)),
        max_rollout_steps=cfg["temporal_dataset_parameters"]["rollout_steps"],
        learning_rate=lr["learning_rate"], weight_decay=lr["weight_decay"],
        gamma=lr["gamma"], step_size=lr["step_size"])


def restore_weights(path: str, params_template):
    """The parameters of the port's checkpoint ``path``. An orbax checkpoint
    of the JAX package raises: convert it first."""
    for where in (path, os.path.join(path, "params")):
        if os.path.exists(os.path.join(where, "_CHECKPOINT_METADATA")):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint of the JAX package; the port reads its own "
                "npz checkpoints only. Convert it with tests/torch_port_convert.py "
                "(python3 -m tests.torch_port_convert SRC DST).")
    return restore_params_only(path, params_template)


def split_union(pred: np.ndarray, spec, b: int) -> List[np.ndarray]:
    """[N_tiled, 2, T] union prediction -> b per-graph [N, 2, T]."""
    base_counts = [c // b for c in spec.node_counts]
    ptr = spec.node_ptr
    outs = []
    for g_ in range(b):
        parts = [pred[ptr[s] + g_ * base_counts[s]: ptr[s] + (g_ + 1) * base_counts[s]]
                 for s in range(spec.num_scales)]
        outs.append(np.concatenate(parts, axis=0))
    return outs


FIGURES_SKIPPED = "report figures skipped: matplotlib is not installed"


def evaluate(apply_fn, model_cfg, params, test: List[FloodGraph],
             out_dir: Optional[str] = None,
             numerical_times: Optional[List[float]] = None,
             test_records=None, render: bool = True,
             solver_label: str = "solver", eval_batch_size: int = 1,
             device=None, ring_perm: Optional[np.ndarray] = None) -> Dict:
    """Timed full-rollout test evaluation + spatial analysis
    (reference main.py:138-166). With ``out_dir`` it also writes the
    summary figures there (``SpatialAnalysis.save_reports``), and with
    ``test_records`` (the records carrying the meshes) and ``render`` the
    reference's figure set of the best and worst simulations (reference
    main.py:171-181), after the timed rollouts. Where matplotlib is missing
    it prints ``FIGURES_SKIPPED`` instead. ``ring_perm`` is the ring order
    of ``test`` (``prepare_ring_graphs``), undone before drawing.

    ``eval_batch_size`` > 1 rolls out ``concat_graphs`` unions of that many
    test graphs and attributes elapsed/b to each simulation; per-graph
    predictions and metrics are those of batch 1 (a disconnected union). A
    warm-up rollout runs on the first graph and on each union size first,
    outside the timing; a timing ends when the prediction is back on the
    host, after the device is done."""
    device = resolve_device(device)
    steps = int(test[0].y.shape[-1])

    def roll(graph):
        return rollout(apply_fn, params, model_cfg, graph, steps=steps,
                       device=device).cpu().numpy()

    roll(test[0])
    rollouts, times = [], []
    b = max(1, int(eval_batch_size))
    warmed = set()
    for i in range(0, len(test), b):
        chunk = test[i:i + b]
        if len(chunk) > 1:
            union = concat_graphs(chunk)
            if len(chunk) not in warmed:     # exclude this size's first run
                roll(union)
                warmed.add(len(chunk))
            t0 = time.perf_counter()
            pred = roll(union)
            dt = (time.perf_counter() - t0) / len(chunk)
            rollouts += split_union(pred, union.spec, len(chunk))
            times += [dt] * len(chunk)
        else:
            t0 = time.perf_counter()
            rollouts.append(roll(chunk[0]))
            times.append(time.perf_counter() - t0)

    analysis = SpatialAnalysis(rollouts, test, prediction_times=times,
                               numerical_times=numerical_times,
                               solver_label=solver_label)
    summary = analysis.summary()
    if out_dir:
        try:
            require_matplotlib()
        except ImportError:
            print(FIGURES_SKIPPED, flush=True)
            return summary
        analysis.save_reports(out_dir)
        if render and test_records is not None:
            _render_rollout_reports(analysis, rollouts, test, test_records, out_dir,
                                    ring_perm)
    return summary


def mesh_order(arr: np.ndarray, perm: Optional[np.ndarray]) -> np.ndarray:
    """Rows of ``arr`` in ring order (``perm[new] = old``) back in the
    mesh's own order; ``arr`` itself without a permutation."""
    if perm is None:
        return arr
    out = np.empty_like(arr)
    out[perm] = arr
    return out


def _render_rollout_reports(analysis, rollouts, test, test_records, out_dir: str,
                            ring_perm: Optional[np.ndarray] = None) -> None:
    """The best and worst simulations' figures (reference main.py:171-181,
    PlotRollout panels, utils/visualization.py:515-1156): rollout frame,
    FAT, CSI/F1, Froude and mass-conservation panels; the videos of the best
    one. Each graph is drawn in its mesh's own order."""
    rank = analysis.ranking()
    cons = analysis.mass_conservation_series()
    for label in ("best", "worst"):
        i = rank[label]
        rec = test_records[i]
        g = test[i]
        real = mesh_order(g.y.cpu().numpy(), ring_perm)
        pr = PlotRollout(rec.mesh, mesh_order(rollouts[i], ring_perm), real,
                         temporal_res=float(rec.temporal_res),
                         node_ptr=np.asarray(g.spec.node_ptr))
        t_wet = int(np.argmax(real[:rec.mesh.meshes[0].num_faces, 0].sum(0)))
        pr.frame(t_wet, out_path=os.path.join(out_dir, f"rollout_{label}.png"))
        pr.fat_comparison(out_path=os.path.join(out_dir, f"fat_{label}.png"))
        pr.csi_f1_panel(out_path=os.path.join(out_dir, f"csi_f1_{label}.png"))
        pr.froude_map(out_path=os.path.join(out_dir, f"froude_{label}.png"))
        pr.conservation_panel(
            cons[i], inflow_series=analysis.inflow_volume_series(i),
            out_path=os.path.join(out_dir, f"conservation_{label}.png"))
        if label == "best":
            pr.create_video(os.path.join(out_dir, "rollout_best.gif"))
            pr.create_multiscale_video(os.path.join(out_dir, "rollout_best_multiscale.gif"))


FALLBACK = "ring_halo unavailable (non-MSGNN model or ring plan failure); falling back to GSPMD"


def _device_list(device) -> Optional[List[torch.device]]:
    """``--device`` as a list of devices: a comma-separated string, a
    sequence, or one device; None stays None."""
    if device is None:
        return None
    if isinstance(device, str):
        device = [d.strip() for d in device.split(",") if d.strip()]
    elif isinstance(device, (torch.device, int)):
        device = [device]
    return [torch.device(d) for d in device]


@dataclasses.dataclass
class Layout:
    """Where a run trains: ``ring`` the ring-halo partition devices, else
    ``mesh`` (``sharding.make_mesh``), else one ``device``; ``home`` holds
    the parameters and evaluates."""
    home: torch.device
    ring: Optional[List[torch.device]] = None
    mesh: Optional[List[List[torch.device]]] = None


def _mesh(n_data: int, n_graph: int, devices) -> List[List[torch.device]]:
    mesh = make_mesh(n_data, n_graph, devices)
    print(f"device mesh: data={n_data} x graph={n_graph}; this process's rows "
          + " | ".join(", ".join(str(d) for d in row) for row in mesh))
    return mesh


def parallel_layout(cfg: Dict, devices: Optional[List[torch.device]] = None) -> Layout:
    """The devices of the config's ``parallel`` block (JAX main.py:388-432):
    a ring_halo block with graph > 1 gives its ring (``devices`` lists its P
    parts; ``data`` is not replicated), a model other than the MSGNN falls
    back to the GSPMD mesh (printing JAX's line), ``gspmd`` with data x
    graph > 1 gives the mesh; otherwise one device. A list of more than one
    device without a parallel block raises, and so do too few devices."""
    par = cfg.get("parallel") or {}
    n_data, n_graph = int(par.get("data", 1)), int(par.get("graph", 1))
    mode = par.get("mode", "gspmd")
    if mode not in ("gspmd", "ring_halo"):
        raise ValueError(f"parallel.mode {mode!r}: 'gspmd' or 'ring_halo'")
    if mode == "ring_halo" and n_graph > 1:
        if process_index()[1] > 1:
            raise ValueError("ring_halo runs in one process; launch one, or use mode: gspmd")
        if cfg["models"]["model_type"] == "MSGNN":
            if devices is not None and len(devices) != n_graph:
                raise ValueError(f"parallel.graph = {n_graph} ring partitions need {n_graph} "
                                 f"devices, --device lists {len(devices)}")
            if n_data > 1:
                print(f"ring_halo: parallel.data = {n_data} runs the ring once (JAX "
                      "replicates it over data: the same result)")
            ring = make_mesh(1, n_graph, devices)[0]
            return Layout(home=ring[0], ring=ring)
        print(FALLBACK)
    if n_data * n_graph > 1:
        mesh = _mesh(n_data, n_graph, devices)
        return Layout(home=mesh[0][0], mesh=mesh)
    if devices is not None and len(devices) > 1:
        raise ValueError(f"--device lists {len(devices)} devices, but the config has no "
                         "parallel ring_halo block or GSPMD mesh that uses them")
    return Layout(home=resolve_device(devices and devices[0]))


def _ring_data(n_parts: int, *splits) -> List[Tuple[List[FloodGraph], np.ndarray]]:
    """Each split ring-reordered with one permutation (``prepare_ring_graphs``)
    -> (graphs, permutation) a split."""
    return [prepare_ring_graphs(split, n_parts) for split in splits]


def _ring_apply(cfg: Dict, model_cfg, template: FloodGraph, devices):
    """The ring ``apply_fn`` of the config's ``parallel`` block over
    ``devices``, or None (printing why) when the template is not
    ring-adjacent at that many parts."""
    par = cfg["parallel"]
    kw = dict(overlap=bool(par.get("overlap", False)),
              halo_width=int(par.get("halo_width", 1)))
    apply_fn = make_dist_apply_fn(devices, model_cfg, template, **kw)
    if apply_fn is None:
        print(f"ring_halo at {len(devices)} parts: "
              f"{ring_plan_failure(template, len(devices), **kw)}")
        return None
    print(f"ring-halo graph parallelism: {len(devices)}-way over "
          f"{', '.join(str(d) for d in devices)}")
    return apply_fn


def _ring_or_mesh(cfg: Dict, layout: Layout, model_cfg, template: FloodGraph,
                  devices) -> Optional[Callable]:
    """The ring ``apply_fn`` for a ring layout, built on the ring-reordered
    ``template``; where the plan fails, the layout falls back to the GSPMD
    mesh in place (JAX main.py:415-418) and this returns None."""
    apply_fn = _ring_apply(cfg, model_cfg, prepare_ring_graphs([template], len(layout.ring))[0][0],
                           layout.ring)
    if apply_fn is None:
        print(FALLBACK)
        par = cfg["parallel"]
        layout.ring = None
        layout.mesh = _mesh(int(par.get("data", 1)), int(par.get("graph", 1)), devices)
        layout.home = layout.mesh[0][0]
    return apply_fn


def _eval_batch_size(cfg: Dict, ring) -> int:
    """``eval_batch_size``, 1 under ring_halo: the plans hold one graph (JAX
    main.py:491-496)."""
    return 1 if ring else int(cfg["trainer_options"].get("eval_batch_size", 1))


def _barrier() -> None:
    """All processes meet here (JAX main.py:465-476, 500-504): none exits
    while process 0 still writes and evaluates."""
    if process_index()[1] > 1:
        import torch.distributed as dist

        dist.barrier()


def run_training(cfg: Dict, out_dir: str, epoch_budget: Optional[int] = None,
                 device=None) -> Dict:
    """Train, save ``best`` and ``last``, evaluate the best parameters on the
    test split -> the summary. With ``epoch_budget``, trains at most that
    many epochs in this call, autosaves and returns ``{"__resume__": True,
    "epoch": ...}`` while epochs remain; a later call resumes from
    ``<out_dir>/autosave``. ``device`` is one device, or under a parallel
    block the list of devices (``parallel_layout``), the first of which
    holds the parameters and the data. Across processes only process 0
    writes and evaluates; the others return ``{"non_main_process": True,
    ...}``."""
    cfg = config_lib.with_defaults(cfg)
    devices = _device_list(device)
    rank, world = process_index()
    is_main = rank == 0
    if world > 1:
        print(f"multi-process: process {rank}/{world}")
    layout = parallel_layout(cfg, devices)
    if world > 1 and layout.home.type == "cuda":
        torch.cuda.set_device(layout.home)       # the device NCCL's barriers use
    logger = MetricLogger(out_dir, config=cfg) if is_main else None
    try:
        train, val, test, _, test_records = prepare_data(cfg)
        print(f"dataset: {len(train)} train / {len(val)} val / {len(test)} test samples")
        print(f"corpus: {len(test_records)} test records, sha256 "
              f"{corpus_digest(test_records)}")
        opts = trainer_options(cfg)
        model_cfg, params, apply_fn = build_experiment_model(cfg, train[0], device=layout.home)
        ring_perm = None
        if layout.ring:
            ring_apply = _ring_or_mesh(cfg, layout, model_cfg, train[0], devices)
            if ring_apply is not None:
                (train, _), (val, _), (test, ring_perm) = _ring_data(
                    len(layout.ring), train, val, test)
                apply_fn = ring_apply
                if opts.batch_size != 1:
                    # one partitioned graph a step: the plans are the template's
                    print("ring_halo: forcing batch_size=1")
                    opts = dataclasses.replace(opts, batch_size=1)
        print(f"model: {cfg['models']['model_type']}, {count_params(params)} params, "
              f"on {layout.home}")
        if cfg.get("saved_model"):
            params = restore_weights(cfg["saved_model"], params)
            print(f"warm-started from {cfg['saved_model']}")

        autosave_dir = os.path.join(out_dir, "autosave")
        tr = Trainer(apply_fn, model_cfg, params, opts, train, val,
                     multiscale=cfg["models"]["model_type"] == "MSGNN",
                     log_fn=logger.log if logger else None,
                     checkpoint_dir=autosave_dir if is_main else None,
                     batch_layout=cfg["trainer_options"].get("batch_layout", "concat"),
                     mesh=layout.mesh, device=layout.home)
        if logger is not None and opts.watch_every > 0:
            tr.watch_fn = logger.watch       # wandb histograms; nothing local-first
        # process 0 resumes from its autosave, and hands its state to the others
        if is_main and os.path.exists(os.path.join(autosave_dir, "meta.json")):
            print(f"resumed from epoch {tr.resume(autosave_dir)}")
        if world > 1:
            tr.sync_from_main()

        stop_at = (opts.max_epochs if epoch_budget is None
                   else min(opts.max_epochs, tr.start_epoch + epoch_budget))
        tr.fit(max_epochs=stop_at)
        reached = (int(tr.history[-1]["epoch"]) + 1) if tr.history else tr.start_epoch
        if is_main:
            tr.save(autosave_dir, reached)
        if reached >= stop_at and stop_at < opts.max_epochs:
            print(f"epoch budget exhausted at {reached}/{opts.max_epochs}; "
                  "relaunch to continue")
            return {"__resume__": True, "epoch": reached}
        _barrier()                                  # every process trained every step
        if not is_main:
            _barrier()                              # process 0 has evaluated
            return {"non_main_process": True, "epochs": reached}
        try:
            save_checkpoint(os.path.join(out_dir, "best"), tr.best_params,
                            epoch=len(tr.history), history=tr.history)
            save_checkpoint(os.path.join(out_dir, "last"), tr.params,
                            epoch=len(tr.history), history=tr.history)
            summary = evaluate(apply_fn, model_cfg, tr.best_params, test, out_dir=out_dir,
                               numerical_times=[r.solver_seconds for r in test_records],
                               test_records=test_records, solver_label=_solver_label(cfg),
                               eval_batch_size=_eval_batch_size(cfg, layout.ring),
                               device=layout.home, ring_perm=ring_perm)
            summary["n_params"] = count_params(tr.best_params)
            logger.summary(summary)
        finally:
            _barrier()
    finally:
        if logger is not None:
            logger.close()
    print(json.dumps(summary, indent=2, default=float))
    return summary


def deep_merge(dst: Dict, src: Dict) -> Dict:
    """``dst`` with ``src`` merged in, dict into dict, key by key; ``src``
    wins elsewhere."""
    out = dict(dst)
    for k, v in src.items():
        out[k] = (deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def run_sweep(base_cfg: Dict, sweep_id: str, out_dir: str, count: int = 1,
              device=None) -> None:
    """A wandb sweep agent's trials (JAX main.py:509-538; reference
    main.py:189-196): ``count`` trials of ``wandb.agent(sweep_id)``, each
    ``run_training`` of the agent's dotted-key overrides deep-merged over
    ``base_cfg``, into ``<out_dir>/trial_<run id>`` on ``device``. The
    trial's ``MetricLogger`` attaches to the agent's run, so every epoch's
    metrics reach the sweep controller; the run is finished here."""
    import wandb

    def _one():
        run = wandb.init()
        overrides = config_lib.fix_dotted_keys(dict(run.config))
        try:
            run_training(deep_merge(base_cfg, overrides),
                         os.path.join(out_dir, f"trial_{run.id}"), device=device)
        finally:
            run.finish()

    wandb.agent(sweep_id, function=_one, count=count)


def run_eval(cfg: Dict, ckpt: str, out_dir: str, device=None) -> Dict:
    """Evaluate the checkpoint ``ckpt`` on the test split; writes
    ``<out_dir>/summary.json`` and the report figures -> the summary.
    ``device`` as in
    ``run_training``: under a ring_halo block the test graphs run through
    the ring; under a GSPMD mesh the evaluation runs on its first device."""
    cfg = config_lib.with_defaults(cfg)
    devices = _device_list(device)
    layout = parallel_layout(cfg, devices)
    _, _, test, _, test_records = prepare_data(cfg)
    print(f"corpus: {len(test_records)} test records, sha256 {corpus_digest(test_records)}")
    model_cfg, params, apply_fn = build_experiment_model(cfg, test[0], device=layout.home)
    params = restore_weights(ckpt, params)
    ring_perm = None
    if layout.ring:
        ring_apply = _ring_or_mesh(cfg, layout, model_cfg, test[0], devices)
        if ring_apply is not None:
            (test, ring_perm), = _ring_data(len(layout.ring), test)
            apply_fn = ring_apply
    summary = evaluate(apply_fn, model_cfg, params, test, out_dir=out_dir,
                       numerical_times=[r.solver_seconds for r in test_records],
                       test_records=test_records, solver_label=_solver_label(cfg),
                       eval_batch_size=_eval_batch_size(cfg, layout.ring), device=layout.home,
                       ring_perm=ring_perm)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    print(json.dumps(summary, indent=2, default=float))
    return summary


def dist_backend(devices: Optional[List[torch.device]], local_world: int) -> str:
    """NCCL when this process runs on CUDA devices (``devices``, default the
    GPUs) and its host has a card for each of its ``local_world`` ranks;
    gloo otherwise: on the CPU, or with more ranks than cards (NCCL refuses
    two ranks on one card)."""
    on_cpu = devices is not None and all(d.type == "cpu" for d in devices)
    if on_cpu or torch.cuda.device_count() < local_world:
        return "gloo"
    return "nccl"


def init_distributed(args) -> bool:
    """Join this process to the run's process group before any device is
    touched (JAX main.py:334-357) -> whether it did: ``--dist-num-processes N
    --dist-process-id I [--dist-coordinator HOST:PORT]`` (default
    ``localhost:12355``), or ``MSWE_MULTIHOST=1`` with ``torchrun``'s
    environment (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).

    The rank among the host's processes and their count pick the default
    devices (``sharding.make_mesh``) and the backend (``dist_backend``):
    ``--dist-local-rank`` / ``--dist-local-world``, else ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``, else the global rank and process count, which
    holds for one host. The local rank is exported as ``LOCAL_RANK``, as
    torchrun does. The backend is printed; a failure raises."""
    import torch.distributed as dist

    if args.dist_num_processes:
        world, rank = args.dist_num_processes, args.dist_process_id or 0
        init = f"tcp://{args.dist_coordinator or 'localhost:12355'}"
    elif os.environ.get("MSWE_MULTIHOST") == "1":
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
    else:
        return False

    def local(flag, env, default) -> int:
        return int(flag if flag is not None else os.environ.get(env, default))

    local_rank = local(args.dist_local_rank, "LOCAL_RANK", rank)
    local_world = local(args.dist_local_world, "LOCAL_WORLD_SIZE", world)
    os.environ["LOCAL_RANK"] = str(local_rank)
    devices = _device_list(args.device)
    backend = dist_backend(devices, local_world)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    print(f"process group: rank {rank} of {world} (local {local_rank} of {local_world}), "
          f"backend {backend}", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="mswe_gnn_tpu_torch experiment CLI")
    ap.add_argument("mode", choices=["train", "eval", "sweep"])
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (eval mode)")
    ap.add_argument("--sweep-id", default=None,
                    help="wandb sweep id (sweep mode): entity/project/id")
    ap.add_argument("--count", type=int, default=1,
                    help="trials to run under the sweep agent (sweep mode)")
    ap.add_argument("--out", default="runs/latest")
    ap.add_argument("--epoch-budget", type=int, default=None,
                    help=f"max epochs in this process; exits {EXIT_RELAUNCH} when hit "
                         "(relaunch, and training resumes from the autosave)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU); under a "
                         "parallel block, a comma-separated list of this process's devices, "
                         "which may repeat one (e.g. cuda:0,cuda:1 or cpu,cpu)")
    ap.add_argument("--dist-coordinator", default=None,
                    help="HOST:PORT of process 0 for a multi-process run "
                         "(default localhost:12355)")
    ap.add_argument("--dist-num-processes", type=int, default=None,
                    help="processes in the run; starts torch.distributed")
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--dist-local-rank", type=int, default=None,
                    help="this process's rank among its host's (default LOCAL_RANK, else the "
                         "process id: one host)")
    ap.add_argument("--dist-local-world", type=int, default=None,
                    help="the processes on this host (default LOCAL_WORLD_SIZE, else "
                         "--dist-num-processes: one host)")
    args = ap.parse_args(argv)
    if args.mode == "sweep":
        if not args.sweep_id:
            ap.error("--sweep-id is required for sweep")
        if args.dist_num_processes or os.environ.get("MSWE_MULTIHOST") == "1":
            raise ValueError("sweep runs its trials in one process: drop "
                             "--dist-num-processes (and MSWE_MULTIHOST)")
    distributed = init_distributed(args)
    enable_compilation_cache()
    try:
        cfg = config_lib.read_config(args.config) if args.config else {}
        cfg = config_lib.fix_dotted_keys(cfg)
        if args.mode == "sweep":
            run_sweep(cfg, args.sweep_id, args.out, count=args.count, device=args.device)
            return 0
        if args.mode == "train":
            result = run_training(cfg, args.out, epoch_budget=args.epoch_budget,
                                  device=args.device)
            return EXIT_RELAUNCH if result.get("__resume__") else 0
        if not args.ckpt:
            ap.error("--ckpt is required for eval")
        run_eval(cfg, args.ckpt, args.out, device=args.device)
        return 0
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
