"""Loader for reference-format datasets (PyG pickles from the Zenodo archive);
port of mswe_gnn_tpu/data/torch_compat.py.

The reference stores simulations as pickled lists of torch_geometric ``Data``
objects (reference database/graph_creation.py:1681-1703, utils/load.py:19-38,
Zenodo DOI 10.5281/zenodo.13326595). This module converts them into
:class:`SimulationRecord` so the pipeline consumes them unchanged.

The pickles are read with plain ``pickle``, not ``torch.load``. Where
``torch_geometric`` is missing, its classes and those of the reference's
``database`` package are replaced at unpickle time by a stub that keeps
their state; the tensors inside are plain torch either way.
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np
import torch

from mswe_gnn_tpu_torch.data.dataset import SimulationRecord
from mswe_gnn_tpu_torch.data.meshing import GhostCells, Mesh, MultiscaleMesh


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def convert_pyg_data(data) -> SimulationRecord:
    """One reference ``Data`` object -> SimulationRecord.

    Expects the attribute contract of reference convert_mesh_to_pyg
    (database/graph_creation.py:1483-1582): WD/VX/VY [N,T], DEM, area,
    edge_index (global dual graph), node_ptr/edge_ptr/intra_edge_ptr/
    intra_mesh_edge_index for multiscale, node_BC/edge_BC_length/BC/type_BC.
    """
    node_ptr = _to_np(data.node_ptr).astype(np.int64) if hasattr(data, "node_ptr") \
        else np.asarray([0, _to_np(data.WD).shape[0]])
    edge_ptr = _to_np(data.edge_ptr).astype(np.int64) if hasattr(data, "edge_ptr") \
        else np.asarray([0, _to_np(data.edge_index).shape[1]])
    L = len(node_ptr) - 1

    edge_index = _to_np(data.edge_index).astype(np.int64)
    face_distance = _to_np(data.face_distance).astype(np.float64)
    rel = (_to_np(data.face_relative_distance).astype(np.float64)
           if hasattr(data, "face_relative_distance")
           else np.zeros((edge_index.shape[1], 2)))
    edge_slope = (_to_np(data.edge_slope).astype(np.float64)
                  if hasattr(data, "edge_slope")
                  else np.zeros(edge_index.shape[1]))
    dem = _to_np(data.DEM).astype(np.float64).ravel()
    area = _to_np(data.area).astype(np.float64).ravel()
    pos = (_to_np(data.pos).astype(np.float64) if hasattr(data, "pos")
           and data.pos is not None else None)

    meshes: List[Mesh] = []
    for s in range(L):
        nsl = slice(node_ptr[s], node_ptr[s + 1])
        esl = slice(edge_ptr[s], edge_ptr[s + 1])
        ei = edge_index[:, esl] - node_ptr[s]
        n = node_ptr[s + 1] - node_ptr[s]
        meshes.append(Mesh(
            face_xy=(pos[nsl] if pos is not None and pos.shape[0] >= node_ptr[-1]
                     else np.zeros((n, 2))),
            area=area[nsl], dem=dem[nsl], dual_edge_index=ei,
            face_distance=face_distance[esl], face_relative_distance=rel[esl],
            edge_slope=edge_slope[esl],
            shared_length=face_distance[esl],  # wall length not stored; proxy
            boundary_faces=np.asarray([], dtype=np.int64)))

    ghosts = None
    if hasattr(data, "node_BC"):
        bc = _to_np(data.BC)
        ghosts = GhostCells(
            ghost_nodes=_to_np(data.node_BC).astype(np.int64).ravel(),
            bc_faces=_to_np(data.node_BC).astype(np.int64).ravel(),
            edge_bc_length=_to_np(data.edge_BC_length).astype(np.float64).ravel(),
            type_bc=int(_to_np(data.type_BC).ravel()[0]))

    if L > 1:
        intra = _to_np(data.intra_mesh_edge_index).astype(np.int64)
        intra_ptr = _to_np(data.intra_edge_ptr).astype(np.int64)
    else:
        intra = np.zeros((2, 0), np.int64)
        intra_ptr = np.asarray([0])

    mesh = MultiscaleMesh(meshes=meshes, node_ptr=node_ptr, edge_ptr=edge_ptr,
                          intra_edge_ptr=intra_ptr, intra_edge_index=intra,
                          ghosts=ghosts)

    wd = _to_np(data.WD).astype(np.float32)
    vx = _to_np(data.VX).astype(np.float32)
    vy = _to_np(data.VY).astype(np.float32)
    # hydrograph BC [n_bc, 2, T] -> inflow series; normalized later like the
    # reference (utils/dataset.py:266-275)
    bc_raw = _to_np(data.BC)
    if bc_raw.ndim == 3:
        series = bc_raw[:, 1, :]
    else:
        series = np.ones((1, wd.shape[1])) * float(np.ravel(bc_raw)[0])
    bc_per_length = series / ghosts.edge_bc_length[:, None] if ghosts is not None else series

    return SimulationRecord(mesh=mesh, wd=wd, vx=vx, vy=vy,
                            bc_per_length=bc_per_length.astype(np.float32),
                            temporal_res=60.0)


class _StubPyG:
    """Shape-polymorphic stand-in for any torch_geometric class in a pickle
    stream. Absorbs whatever state pickle hands it and exposes the tensors
    the way ``convert_pyg_data`` reads them (attribute access, including
    through PyG 2.x's ``_store._mapping`` indirection)."""

    def __init__(self, *args, **kwargs):
        for k, v in kwargs.items():
            self.__dict__[k] = v

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)

    def __getattr__(self, name):
        d = object.__getattribute__(self, "__dict__")
        for holder in ("_store", "_global_store"):
            store = d.get(holder)
            if store is not None:
                m = store.__dict__.get("_mapping") if hasattr(store, "__dict__") \
                    else None
                if isinstance(m, dict) and name in m:
                    return m[name]
        m = d.get("_mapping")
        if isinstance(m, dict) and name in m:
            return m[name]
        raise AttributeError(name)


class _StubUnpickler(pickle.Unpickler):
    """Unpickler that substitutes torch_geometric (and the reference's
    ``database`` package) classes with :class:`_StubPyG`, so Zenodo pickles
    load with plain torch only."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("torch_geometric", "database"):
            return _StubPyG
        return super().find_class(module, name)


def load_reference_pickle(path: str, size: Optional[int] = None,
                          seed: int = 42,
                          allow_stub: bool = True) -> List[SimulationRecord]:
    """Load a reference .pkl dataset (reference utils/load.py:19-38).

    Uses torch_geometric when importable; otherwise (``allow_stub``)
    substitutes its classes with a generic stub at unpickle time — the
    tensors inside are plain torch and survive either way."""
    import random

    try:
        import torch_geometric  # noqa: F401
        have_pyg = True
    except ImportError:
        have_pyg = False
    if not have_pyg and not allow_stub:
        raise ImportError(
            "loading reference pickles requires torch_geometric, or pass "
            "allow_stub=True to substitute its classes at unpickle time")

    with open(path, "rb") as f:
        dataset = pickle.load(f) if have_pyg else _StubUnpickler(f).load()
    if seed != 0:
        random.Random(seed).shuffle(dataset)
    if size is not None:
        dataset = dataset[:size]
    return [convert_pyg_data(d) for d in dataset]
