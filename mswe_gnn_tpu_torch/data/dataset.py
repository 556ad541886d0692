"""Dataset assembly: features, scaling, pooling, temporal windowing -> FloodGraph.

Port of mswe_gnn_tpu/data/dataset.py (numpy, as there; the graphs it
emits hold torch tensors). Re-design of the reference dataset layer
(reference utils/dataset.py:74-479):
one *simulation* (mesh + WD/VX/VY series + BC) becomes many *temporal samples*
— each a padded :class:`FloodGraph` whose dynamic window holds ``previous_t``
past (h, |q|) steps and whose target holds ``rollout_steps`` future steps.

All padding/sorting happens here, once, on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from mswe_gnn_tpu_torch.data.meshing import MultiscaleMesh
from mswe_gnn_tpu_torch.data.scaling import (
    Scaler, apply_scaler, fit_multiscale_scaler, fit_scaler,
)
from mswe_gnn_tpu_torch.graph import FloodGraph, GraphSpec, build_flood_graph, round_up

DEFAULT_NODE_FEATURES = {"slopes": False, "slope": False, "area": True, "DEM": True}
DEFAULT_EDGE_FEATURES = {"edge_length": True, "edge_relative_distance": False,
                         "edge_slope": False}


@dataclasses.dataclass
class SimulationRecord:
    """One raw simulation attached to its (multiscale) mesh.

    ``wd/vx/vy`` cover ALL scales (coarse scales pooled from the finest run,
    reference database/graph_creation.py:1137-1169); ``bc_per_length [Nbc, T]``
    is inflow per unit BC-edge length (reference utils/dataset.py:275).
    """
    mesh: MultiscaleMesh
    wd: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    bc_per_length: np.ndarray
    temporal_res: float  # minutes
    solver_seconds: float = 0.0  # numerical-solver wall time (speed-up metric,
                                 # reference database/overview.csv + misc.py:70-114)
    # exogenous per-node forcing fields [N, Ff, T] (e.g. wind stress WX/WY and
    # pressure P of the reference's storm-surge extension,
    # reference utils/adforce_dataset.py:80, 245); known for all t, fed to the
    # model at each rollout step alongside the static features
    forcing: Optional[np.ndarray] = None
    forcing_names: tuple = ()


def pool_to_scales(values: np.ndarray, mesh: MultiscaleMesh,
                   reduce: str = "mean") -> np.ndarray:
    """Pool finest-scale temporal values onto every coarser scale with
    scatter ``reduce`` in {'mean', 'max', 'add'} (reference
    database/graph_creation.py:1137-1169 pool_multiscale_attributes).
    ``values`` is [F0(+ghosts), T] on the finest scale; output is
    [N_total, T]."""
    if reduce not in ("mean", "max", "add"):
        raise ValueError(f"unknown reduce {reduce!r}")
    out = np.zeros((mesh.num_nodes, values.shape[1]))
    n0 = mesh.node_ptr[1] - mesh.node_ptr[0]
    out[:n0] = values[:n0]
    cur = values[:n0]
    for s in range(mesh.num_scales - 1):
        lvl = slice(mesh.intra_edge_ptr[s], mesh.intra_edge_ptr[s + 1])
        coarse = mesh.intra_edge_index[0, lvl] - mesh.node_ptr[s + 1]
        fine = mesh.intra_edge_index[1, lvl] - mesh.node_ptr[s]
        nc = mesh.node_ptr[s + 2] - mesh.node_ptr[s + 1]
        if reduce == "max":
            acc = np.full((nc, values.shape[1]), -np.inf)
            np.maximum.at(acc, coarse, cur[fine])
            cur = np.where(np.isinf(acc), 0.0, acc)  # childless cells -> 0
        else:
            sums = np.zeros((nc, values.shape[1]))
            np.add.at(sums, coarse, cur[fine])
            if reduce == "mean":
                cnts = np.zeros(nc)
                np.add.at(cnts, coarse, 1.0)
                sums /= np.maximum(cnts, 1.0)[:, None]
            cur = sums
        out[mesh.node_ptr[s + 1]: mesh.node_ptr[s + 2]] = cur
    return out


def fit_dataset_scalers(records: Sequence[SimulationRecord],
                        kinds: Dict[str, Optional[str]]) -> Dict[str, object]:
    """Fit all scalers on the training records only
    (reference utils/scaling.py:112-141)."""
    ms = records[0].mesh
    L = ms.num_scales

    def node_per_scale(attr):
        return [[getattr(m, attr) for r in records for m in [r.mesh.meshes[s]]]
                for s in range(L)]

    def edge_per_scale(attr):
        return [[getattr(r.mesh.meshes[s], attr) for r in records] for s in range(L)]

    scalers: Dict[str, object] = {}
    scalers["DEM_scaler"] = fit_scaler(
        kinds.get("DEM_scaler"), [r.mesh.concat_nodes("dem") for r in records],
        to_min=True)
    scalers["WD_scaler"] = fit_scaler(kinds.get("WD_scaler"), [r.wd for r in records])
    # velocity scaler fits the vector norm (reference utils/scaling.py:59-61, 139)
    scalers["V_scaler"] = fit_scaler(
        kinds.get("V_scaler"),
        [np.sqrt(r.vx ** 2 + r.vy ** 2) for r in records])
    scalers["slope_scaler"] = fit_scaler(
        kinds.get("slope_scaler"),
        [r.mesh.concat_edges("edge_slope") for r in records])
    scalers["area_scaler"] = fit_multiscale_scaler(
        kinds.get("area_scaler"), node_per_scale("area"))
    scalers["edge_length_scaler"] = fit_multiscale_scaler(
        kinds.get("edge_length_scaler"), edge_per_scale("face_distance"))
    scalers["edge_slope_scaler"] = fit_multiscale_scaler(
        kinds.get("edge_slope_scaler"), edge_per_scale("edge_slope"))
    # one scaler per forcing feature (wind/pressure magnitudes differ by
    # orders of magnitude, so per-column fitting is required)
    with_forcing = [r for r in records if r.forcing is not None]
    if with_forcing and kinds.get("forcing_scaler"):
        n_f = with_forcing[0].forcing.shape[1]
        scalers["forcing_scaler"] = [
            fit_scaler(kinds["forcing_scaler"],
                       [r.forcing[:, f] for r in with_forcing])
            for f in range(n_f)]
    else:
        scalers["forcing_scaler"] = None
    return scalers


def _per_scale_node_attr(mesh: MultiscaleMesh, attr: str,
                         scalers: Optional[List[Scaler]]) -> np.ndarray:
    parts = []
    for s, m in enumerate(mesh.meshes):
        sc = scalers[s] if isinstance(scalers, list) else scalers
        parts.append(apply_scaler(sc, getattr(m, attr)))
    return np.concatenate(parts)


def _per_scale_edge_attr(mesh: MultiscaleMesh, attr: str,
                         scalers: Optional[List[Scaler]]) -> np.ndarray:
    parts = []
    for s, m in enumerate(mesh.meshes):
        sc = scalers[s] if isinstance(scalers, list) else scalers
        parts.append(apply_scaler(sc, getattr(m, attr)))
    return np.concatenate(parts)


@dataclasses.dataclass
class ProcessedSimulation:
    """Scaled per-simulation arrays, ready for temporal windowing
    (output contract of reference utils/dataset.py:232-289)."""
    mesh: MultiscaleMesh
    x_static: np.ndarray        # [N, S]
    edge_attr: np.ndarray       # [E, Fe]
    wd: np.ndarray              # [N, T] scaled water depth
    q: np.ndarray               # [N, T] |q| = |(v*h)|
    bc_per_length: np.ndarray   # [Nbc, T]
    area: np.ndarray            # [N] raw area (for conservation)
    dem: np.ndarray             # [N] raw DEM
    temporal_res: float
    forcing: Optional[np.ndarray] = None  # [N, Ff, T] scaled exogenous fields


def process_record(rec: SimulationRecord, scalers: Dict[str, object],
                   node_features: Dict[str, bool] = None,
                   edge_features: Dict[str, bool] = None,
                   slope_method: str = "edge") -> ProcessedSimulation:
    """Scale + select features for one simulation
    (reference utils/dataset.py:74-230). ``slope_method`` selects the
    per-node slope estimator ('edge' | 'lstsq', see :func:`_node_slopes`)."""
    nf = dict(DEFAULT_NODE_FEATURES, **(node_features or {}))
    ef = dict(DEFAULT_EDGE_FEATURES, **(edge_features or {}))
    mesh = rec.mesh

    cols = []
    if nf.get("slopes"):
        # per-node slope vector from the DEM gradient
        sx, sy = _node_slopes(mesh, slope_method)
        cols.append(apply_scaler(scalers.get("slope_scaler"), np.stack([sx, sy], -1)))
    if nf.get("slope"):
        sx, sy = _node_slopes(mesh, slope_method)
        cols.append(apply_scaler(scalers.get("slope_scaler"),
                                 np.sqrt(sx ** 2 + sy ** 2))[:, None])
    if nf.get("area"):
        cols.append(_per_scale_node_attr(mesh, "area", scalers.get("area_scaler"))[:, None])
    if nf.get("DEM"):
        dem = mesh.concat_nodes("dem")
        cols.append(apply_scaler(scalers.get("DEM_scaler"), dem, to_min=True)[:, None])
    x_static = (np.concatenate(cols, axis=1) if cols
                else np.ones((mesh.num_nodes, 1)))

    ecols = []
    if ef.get("edge_length"):
        ecols.append(_per_scale_edge_attr(mesh, "face_distance",
                                          scalers.get("edge_length_scaler"))[:, None])
    if ef.get("edge_relative_distance"):
        rel = mesh.concat_edges("face_relative_distance")
        dist = mesh.concat_edges("face_distance")
        ecols.append(rel / dist[:, None])
    if ef.get("edge_slope"):
        ecols.append(_per_scale_edge_attr(mesh, "edge_slope",
                                          scalers.get("edge_slope_scaler"))[:, None])
    edge_attr = (np.concatenate(ecols, axis=1) if ecols
                 else np.ones((mesh.edge_index.shape[1], 1)))

    # dynamic: h and |q| = h * |v| (reference utils/dataset.py:199-230)
    wd = apply_scaler(scalers.get("WD_scaler"), rec.wd)
    vx = apply_scaler(scalers.get("V_scaler"), rec.vx) * wd
    vy = apply_scaler(scalers.get("V_scaler"), rec.vy) * wd
    q = np.sqrt(vx ** 2 + vy ** 2)

    forcing = None
    if rec.forcing is not None:
        fsc = scalers.get("forcing_scaler")
        forcing = np.stack([
            apply_scaler(fsc[f] if isinstance(fsc, list) else fsc,
                         rec.forcing[:, f])
            for f in range(rec.forcing.shape[1])], axis=1).astype(np.float32)

    return ProcessedSimulation(
        mesh=mesh, x_static=x_static.astype(np.float32),
        edge_attr=edge_attr.astype(np.float32),
        wd=wd.astype(np.float32), q=q.astype(np.float32),
        bc_per_length=rec.bc_per_length.astype(np.float32),
        area=mesh.concat_nodes("area").astype(np.float32),
        dem=mesh.concat_nodes("dem").astype(np.float32),
        temporal_res=rec.temporal_res, forcing=forcing)


def _node_slopes(mesh: MultiscaleMesh, method: str = "edge"):
    """Per-node terrain slopes.

    ``method='edge'`` (default): average of directed edge slopes
    (reference utils/dataset.py:49-57 analog — cheap, edge-local).
    ``method='lstsq'``: the reference's least-squares plane fit over a
    radius+KNN neighborhood per scale (reference
    database/graph_creation.py:1004-1031), via :func:`data.interp.get_slopes`.
    """
    if method == "lstsq":
        from mswe_gnn_tpu_torch.data.interp import get_slopes

        sxs, sys_ = [], []
        for m in mesh.meshes:
            # the radius scales with the mesh's own spacing, so that coarse
            # scales keep a local neighborhood
            spacing = float(np.median(m.face_distance)) if m.num_edges else 1.0
            sx, sy = get_slopes(m.face_xy, m.dem, neighborhood_size=2.0 * spacing)
            sxs.append(sx)
            sys_.append(sy)
        return np.concatenate(sxs), np.concatenate(sys_)
    if method != "edge":
        raise ValueError(f"unknown slope_method {method!r}")
    ei = mesh.edge_index
    rel = mesh.concat_edges("face_relative_distance")
    dist = mesh.concat_edges("face_distance")
    es = mesh.concat_edges("edge_slope")
    unit = rel / dist[:, None]
    n = mesh.num_nodes
    sx = np.zeros(n); sy = np.zeros(n); cnt = np.zeros(n)
    np.add.at(sx, ei[0], es * unit[:, 0])
    np.add.at(sy, ei[0], es * unit[:, 1])
    np.add.at(cnt, ei[0], 1.0)
    cnt = np.maximum(cnt, 1.0)
    return sx / cnt, sy / cnt


def make_spec(mesh: MultiscaleMesh, num_bc: int, pad_multiple: int = 8) -> GraphSpec:
    """Padded GraphSpec for a mesh (shared across a dataset when sizes match
    after rounding; distinct meshes share one spec via :func:`union_spec`)."""
    node_counts = tuple(round_up(m.num_faces, pad_multiple) for m in mesh.meshes)
    edge_counts = tuple(round_up(m.num_edges, pad_multiple) for m in mesh.meshes)
    intra_counts = tuple(
        round_up(int(mesh.intra_edge_ptr[i + 1] - mesh.intra_edge_ptr[i]), pad_multiple)
        for i in range(mesh.num_scales - 1))

    def deg(dst, n):
        if len(dst) == 0:
            return 4
        return round_up(max(int(np.bincount(dst, minlength=n).max()), 1), 4)

    ei = mesh.edge_index
    in_degree = deg(ei[1], mesh.num_nodes)
    pool_degree = deg(mesh.intra_edge_index[0], mesh.num_nodes)
    unpool_degree = deg(mesh.intra_edge_index[1], mesh.num_nodes)
    return GraphSpec(node_counts=node_counts, edge_counts=edge_counts,
                     intra_edge_counts=intra_counts,
                     num_bc=round_up(max(num_bc, 1), pad_multiple),
                     in_degree=in_degree, pool_degree=pool_degree,
                     unpool_degree=unpool_degree)


def union_spec(specs: Sequence[GraphSpec]) -> GraphSpec:
    """Elementwise-max spec so differently sized meshes share one compiled shape."""
    s0 = specs[0]
    return GraphSpec(
        node_counts=tuple(max(s.node_counts[i] for s in specs)
                          for i in range(len(s0.node_counts))),
        edge_counts=tuple(max(s.edge_counts[i] for s in specs)
                          for i in range(len(s0.edge_counts))),
        intra_edge_counts=tuple(max(s.intra_edge_counts[i] for s in specs)
                                for i in range(len(s0.intra_edge_counts))),
        num_bc=max(s.num_bc for s in specs),
        in_degree=max(s.in_degree for s in specs),
        pool_degree=max(s.pool_degree for s in specs),
        unpool_degree=max(s.unpool_degree for s in specs))


def to_temporal_samples(
    sim: ProcessedSimulation,
    spec: GraphSpec,
    previous_t: int = 2,
    rollout_steps: int = 1,
    time_start: int = 0,
    time_stop: int = -1,
) -> List[FloodGraph]:
    """Sliding-window conversion of one simulation into training samples
    (reference utils/dataset.py:410-479).

    ``rollout_steps=-1`` emits a single full-simulation rollout sample.
    Dry-bed condition: ``previous_t - 1`` zero steps are prepended so the
    first sample starts from an (almost) dry domain.
    """
    mesh = sim.mesh
    T = sim.wd.shape[1]
    stop = T if time_stop == -1 else (time_stop % T) + 1
    horizon = stop - time_start
    if rollout_steps < 0:
        n_samples, rollout = 1, horizon - 1
    else:
        rollout = rollout_steps
        n_samples = horizon - rollout
    assert n_samples >= 1 and rollout >= 1, (T, time_start, time_stop, rollout_steps)

    p = previous_t
    # dry-bed padding (reference utils/dataset.py:371-380, 429-431)
    wd = np.concatenate([np.zeros((sim.wd.shape[0], p - 1), np.float32), sim.wd], 1)
    q = np.concatenate([np.zeros((sim.q.shape[0], p - 1), np.float32), sim.q], 1)
    bc = np.concatenate([
        np.zeros((sim.bc_per_length.shape[0], p - 1), np.float32),
        sim.bc_per_length, sim.bc_per_length[:, -1:]], 1)
    forc = None
    if sim.forcing is not None:
        # exogenous forcing gets the same dry-bed padding + final repeat as
        # the BC series; windows index it identically (current input time of
        # rollout step t = padded column t + p - 1)
        forc = np.concatenate([
            np.zeros(sim.forcing.shape[:2] + (p - 1,), np.float32),
            sim.forcing, sim.forcing[:, :, -1:]], axis=2)

    ghosts = mesh.ghosts
    raw_node_counts = tuple(m.num_faces for m in mesh.meshes)
    raw_edge_counts = tuple(m.num_edges for m in mesh.meshes)
    raw_intra = tuple(int(mesh.intra_edge_ptr[i + 1] - mesh.intra_edge_ptr[i])
                      for i in range(mesh.num_scales - 1))

    samples = []
    for init in range(time_start, time_start + n_samples):
        # interleaved (h, |q|) history: columns [h_t-p+1, q_t-p+1, ..., h_t, q_t]
        hist = np.empty((wd.shape[0], 2 * p), np.float32)
        hist[:, 0::2] = wd[:, init: init + p]
        hist[:, 1::2] = q[:, init: init + p]
        # future targets [N, 2, rollout]
        y = np.stack([wd[:, init + p: init + p + rollout],
                      q[:, init + p: init + p + rollout]], axis=1)
        bc_win = bc[:, init: init + p + rollout]

        samples.append(build_flood_graph(
            x_static=sim.x_static,
            x_dynamic=hist,
            edge_index=mesh.edge_index,
            edge_attr=sim.edge_attr,
            spec=spec,
            raw_node_counts=raw_node_counts,
            raw_edge_counts=raw_edge_counts,
            intra_edge_index=mesh.intra_edge_index,
            raw_intra_edge_counts=raw_intra,
            bc_nodes=ghosts.ghost_nodes if ghosts else None,
            bc_values=bc_win,
            bc_edge_length=ghosts.edge_bc_length if ghosts else None,
            bc_kind=ghosts.type_bc if ghosts else 2,
            area=sim.area,
            dem=sim.dem,
            y=y,
            forcing=(forc[:, :, init: init + p + rollout]
                     if forc is not None else None),
            previous_t=p,
            temporal_res=sim.temporal_res,
        ))
    return samples
