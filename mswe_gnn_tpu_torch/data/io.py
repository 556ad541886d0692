"""Dataset persistence and lazy loading (HDF5; port of
mswe_gnn_tpu/data/io.py, reading and writing the same files).

Replaces the reference's pickle database (reference database/graph_creation.py:
save_database :1681, utils/load.py:19-38) and the experimental lazy NetCDF
dataset (reference utils/adforce_dataset.py:20-273) with an HDF5 store:

- ``save_records`` / ``load_records`` — whole-simulation records with their
  multiscale meshes, one HDF5 group per simulation.
- ``LazyFloodDataset`` — index-mapped lazy access: temporal samples are
  materialized on demand (file handles cached, mesh consistency validated,
  corrupt entries skipped with a warning — the adforce behaviors).

h5py is imported by the functions that need it, so that this module imports
where h5py is missing (the GPU machine has none); there every HDF5 function
raises an ImportError that names h5py. The port's CLI caches its records as
``.npz`` (data/npz_store.py) and does not come here.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence

from mswe_gnn_tpu_torch.data.dataset import (
    ProcessedSimulation, SimulationRecord, make_spec, process_record,
    to_temporal_samples, union_spec,
)
from mswe_gnn_tpu_torch.data.meshing import GhostCells, Mesh, MultiscaleMesh

_MESH_FIELDS = ("face_xy", "area", "dem", "dual_edge_index", "face_distance",
                "face_relative_distance", "edge_slope", "shared_length",
                "boundary_faces")


def require_h5py():
    """The h5py module; raises an ImportError that names it where it is
    missing."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5 files need h5py, which is not installed; the "
                          "port's records cache is .npz (data/npz_store.py)") from e
    return h5py


def _write_mesh(grp, mesh: Mesh) -> None:
    for f in _MESH_FIELDS:
        grp.create_dataset(f, data=getattr(mesh, f))


def _read_mesh(grp) -> Mesh:
    return Mesh(**{f: grp[f][...] for f in _MESH_FIELDS})


def save_records(path: str, records: Sequence[SimulationRecord]) -> None:
    h5py = require_h5py()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["n_records"] = len(records)
        for i, rec in enumerate(records):
            g = f.create_group(f"sim_{i}")
            g.attrs["temporal_res"] = rec.temporal_res
            g.attrs["solver_seconds"] = rec.solver_seconds
            g.attrs["num_scales"] = rec.mesh.num_scales
            for name in ("wd", "vx", "vy", "bc_per_length"):
                g.create_dataset(name, data=getattr(rec, name))
            if rec.forcing is not None:
                g.create_dataset("forcing", data=rec.forcing)
                g.attrs["forcing_names"] = list(rec.forcing_names)
            mg = g.create_group("mesh")
            mg.create_dataset("node_ptr", data=rec.mesh.node_ptr)
            mg.create_dataset("edge_ptr", data=rec.mesh.edge_ptr)
            mg.create_dataset("intra_edge_ptr", data=rec.mesh.intra_edge_ptr)
            mg.create_dataset("intra_edge_index", data=rec.mesh.intra_edge_index)
            for s, m in enumerate(rec.mesh.meshes):
                _write_mesh(mg.create_group(f"scale_{s}"), m)
            gh = rec.mesh.ghosts
            if gh is not None:
                hg = mg.create_group("ghosts")
                hg.attrs["type_bc"] = gh.type_bc
                hg.create_dataset("ghost_nodes", data=gh.ghost_nodes)
                hg.create_dataset("bc_faces", data=gh.bc_faces)
                hg.create_dataset("edge_bc_length", data=gh.edge_bc_length)


def _read_record(g) -> SimulationRecord:
    mg = g["mesh"]
    L = int(g.attrs["num_scales"])
    meshes = [_read_mesh(mg[f"scale_{s}"]) for s in range(L)]
    ghosts = None
    if "ghosts" in mg:
        hg = mg["ghosts"]
        ghosts = GhostCells(ghost_nodes=hg["ghost_nodes"][...],
                            bc_faces=hg["bc_faces"][...],
                            edge_bc_length=hg["edge_bc_length"][...],
                            type_bc=int(hg.attrs["type_bc"]))
    mesh = MultiscaleMesh(
        meshes=meshes, node_ptr=mg["node_ptr"][...], edge_ptr=mg["edge_ptr"][...],
        intra_edge_ptr=mg["intra_edge_ptr"][...],
        intra_edge_index=mg["intra_edge_index"][...], ghosts=ghosts)
    return SimulationRecord(
        mesh=mesh, wd=g["wd"][...], vx=g["vx"][...], vy=g["vy"][...],
        bc_per_length=g["bc_per_length"][...],
        temporal_res=float(g.attrs["temporal_res"]),
        solver_seconds=float(g.attrs.get("solver_seconds", 0.0)),
        forcing=g["forcing"][...] if "forcing" in g else None,
        forcing_names=tuple(str(n) for n
                            in g.attrs.get("forcing_names", ())))


def load_records(path: str, size: Optional[int] = None,
                 seed: int = 42) -> List[SimulationRecord]:
    """Load (optionally shuffled + truncated) records
    (reference utils/load.py:19-38 semantics)."""
    import random

    h5py = require_h5py()
    with h5py.File(path, "r") as f:
        n = int(f.attrs["n_records"])
        keys = [f"sim_{i}" for i in range(n)]
        if seed != 0:
            random.Random(seed).shuffle(keys)
        if size is not None:
            keys = keys[:size]
        return [_read_record(f[k]) for k in keys]


class LazyFloodDataset:
    """Index-mapped lazy temporal dataset over one or more HDF5 stores.

    The adforce-style loader (reference utils/adforce_dataset.py:20-273):
    builds a global (file, sim, t) index without materializing samples,
    validates mesh consistency across files, caches open file handles and
    processed simulations, and skips corrupt entries with a warning.
    """

    def __init__(self, paths: Sequence[str], scalers: Dict,
                 previous_t: int = 2, rollout_steps: int = 1,
                 pad_multiple: int = 64,
                 node_features: Optional[Dict] = None,
                 edge_features: Optional[Dict] = None,
                 cache_sims: int = 4):
        require_h5py()      # before the per-file ``except`` below can hide it
        self.paths = list(paths)
        self.scalers = scalers
        self.previous_t = previous_t
        self.rollout_steps = rollout_steps
        self.node_features = node_features
        self.edge_features = edge_features
        self._handles: Dict[str, object] = {}
        self._sim_cache: Dict[tuple, ProcessedSimulation] = {}
        self._cache_sims = cache_sims

        self.index: List[tuple] = []  # (path, sim_key, init_time)
        specs = []
        for path in self.paths:
            try:
                f = self._open(path)
                n = int(f.attrs["n_records"])
            except Exception as e:  # corrupt file
                warnings.warn(f"skipping unreadable dataset file {path}: {e}")
                continue
            for i in range(n):
                key = f"sim_{i}"
                try:
                    g = f[key]
                    T = g["wd"].shape[1]
                    rec_spec = (int(g.attrs["num_scales"]),)
                except Exception as e:
                    warnings.warn(f"skipping corrupt {path}:{key}: {e}")
                    continue
                specs.append(rec_spec)
                if specs[0] != rec_spec:
                    warnings.warn(f"skipping {path}:{key}: mesh scales "
                                  f"{rec_spec} != {specs[0]}")
                    continue
                for t in range(max(T - rollout_steps, 0)):
                    self.index.append((path, key, t))
        # one padded spec across the whole collection
        recs = [self._record(p, k) for p, k in
                dict.fromkeys((p, k) for p, k, _ in self.index)]
        self.spec = union_spec([
            make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes) if r.mesh.ghosts
                      else 1, pad_multiple=pad_multiple) for r in recs])

    def _open(self, path: str):
        if path not in self._handles:
            self._handles[path] = require_h5py().File(path, "r")
        return self._handles[path]

    def _record(self, path: str, key: str) -> SimulationRecord:
        return _read_record(self._open(path)[key])

    def _processed(self, path: str, key: str) -> ProcessedSimulation:
        ck = (path, key)
        if ck not in self._sim_cache:
            if len(self._sim_cache) >= self._cache_sims:
                self._sim_cache.pop(next(iter(self._sim_cache)))
            self._sim_cache[ck] = process_record(
                self._record(path, key), self.scalers,
                node_features=self.node_features,
                edge_features=self.edge_features)
        return self._sim_cache[ck]

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        path, key, t = self.index[i]
        proc = self._processed(path, key)
        # window [t, t + rollout]: exactly one temporal sample
        return to_temporal_samples(
            proc, self.spec, previous_t=self.previous_t,
            rollout_steps=self.rollout_steps, time_start=t,
            time_stop=t + self.rollout_steps)[0]

    def close(self) -> None:
        for f in self._handles.values():
            f.close()
        self._handles.clear()
