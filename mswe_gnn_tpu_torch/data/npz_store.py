"""Simulation records in one ``.npz`` file: the port's records cache.

The JAX package caches records in HDF5 (``mswe_gnn_tpu/data/io.py``, h5py);
the machine with the GPU has no h5py, so the port keeps them as numpy
arrays in an ``.npz``, read back bit for bit, with no pickle. The two formats
do not read each other's files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from mswe_gnn_tpu_torch.data.dataset import SimulationRecord
from mswe_gnn_tpu_torch.data.meshing import GhostCells, Mesh, MultiscaleMesh

_MESH_FIELDS = tuple(f.name for f in dataclasses.fields(Mesh))
_MULTISCALE = ("node_ptr", "edge_ptr", "intra_edge_ptr", "intra_edge_index")
_GHOSTS = ("ghost_nodes", "bc_faces", "edge_bc_length")
_SERIES = ("wd", "vx", "vy", "bc_per_length")


def record_arrays(rec: SimulationRecord, prefix: str = "") -> Dict[str, np.ndarray]:
    """Every array of a record under a stable key: its meshes, the
    multiscale tables, the ghost cells, the series and the forcing fields
    where it has them, in that order."""
    out = {}
    for s, mesh in enumerate(rec.mesh.meshes):
        for name in _MESH_FIELDS:
            out[f"{prefix}mesh{s}/{name}"] = getattr(mesh, name)
    for name in _MULTISCALE:
        out[f"{prefix}{name}"] = getattr(rec.mesh, name)
    if rec.mesh.ghosts is not None:
        for name in _GHOSTS:
            out[f"{prefix}ghosts/{name}"] = getattr(rec.mesh.ghosts, name)
    for name in _SERIES:
        out[f"{prefix}{name}"] = getattr(rec, name)
    if rec.forcing is not None:
        out[f"{prefix}forcing"] = rec.forcing
    return {k: np.asarray(v) for k, v in out.items()}


def save_records(path: str, records: Sequence[SimulationRecord]) -> None:
    """Write ``records`` to the file ``path``, named as given (``np.savez``
    would add ``.npz`` to a name without it)."""
    arrays = {"num_records": np.asarray(len(records))}
    for i, rec in enumerate(records):
        p = f"r{i}/"
        arrays.update(record_arrays(rec, p))
        arrays[p + "num_scales"] = np.asarray(len(rec.mesh.meshes))
        arrays[p + "temporal_res"] = np.asarray(rec.temporal_res, np.float64)
        arrays[p + "solver_seconds"] = np.asarray(rec.solver_seconds, np.float64)
        if rec.mesh.ghosts is not None:
            arrays[p + "ghosts/type_bc"] = np.asarray(rec.mesh.ghosts.type_bc)
        if rec.forcing is not None:
            arrays[p + "forcing_names"] = np.asarray(rec.forcing_names, dtype=str)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_records(path: str) -> List[SimulationRecord]:
    """The records of a ``save_records`` file, in the order written."""
    records = []
    with np.load(path, allow_pickle=False) as data:
        for i in range(int(data["num_records"])):
            p = f"r{i}/"
            meshes = [Mesh(**{name: data[f"{p}mesh{s}/{name}"] for name in _MESH_FIELDS})
                      for s in range(int(data[p + "num_scales"]))]
            ghosts = None
            if p + "ghosts/type_bc" in data:
                ghosts = GhostCells(**{name: data[f"{p}ghosts/{name}"] for name in _GHOSTS},
                                    type_bc=int(data[p + "ghosts/type_bc"]))
            mesh = MultiscaleMesh(meshes=meshes, ghosts=ghosts,
                                  **{name: data[p + name] for name in _MULTISCALE})
            records.append(SimulationRecord(
                mesh=mesh, **{name: data[p + name] for name in _SERIES},
                temporal_res=float(data[p + "temporal_res"]),
                solver_seconds=float(data[p + "solver_seconds"]),
                forcing=data[p + "forcing"] if p + "forcing" in data else None,
                forcing_names=(tuple(str(n) for n in data[p + "forcing_names"])
                               if p + "forcing" in data else ())))
    return records
