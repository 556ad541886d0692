"""Raw D-HYDRO map-NetCDF ingestion (+ writer for round-trip tests); port
of mswe_gnn_tpu/data/netcdf.py.

The reference converts solver outputs ``output_<i>_map.nc`` directly into
training data (reference database/graph_creation.py:650-702 mesh import,
:1483-1582 conversion; reference utils/miscellaneous.py:70-108 solver-timing
lookup). This module is the framework's equivalent: anyone holding raw
UGRID ``mesh2d_*`` map files can build :class:`SimulationRecord`s without
pickles or a prior HDF5 export.

NetCDF-4 files ARE HDF5 and are read with h5py; classic NetCDF-3 files are
read with ``scipy.io.netcdf_file``. Both are imported inside the functions.
Where h5py is missing (the GPU machine has none), a file that begins with
the HDF5 signature raises an ImportError that names h5py and any other file
is read as NetCDF-3; where h5py is present, the behaviour is the JAX
package's (a file h5py cannot open is read as NetCDF-3). Variables
used (UGRID conventions, same names the reference reads):

  mesh2d_node_x/y      [Nv]      primal vertex coordinates
  mesh2d_face_x/y      [F]       cell centers (the GNN nodes)
  mesh2d_edge_nodes    [E, 2]    1-based vertex pair per wall
  mesh2d_edge_type     [E]       1 normal, 2 BC inflow, 3 other boundary
  mesh2d_edge_faces    [E, 2]    1-based adjacent cells (0/fill = none)
  mesh2d_face_nodes    [F, M]    1-based vertices per cell (fill-padded)
  mesh2d_waterdepth    [T, F]    water depth h
  mesh2d_ucx/ucy       [T, F]    cell velocities
  mesh2d_flowelem_bl   [F]       bed level (optional DEM fallback)
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mswe_gnn_tpu_torch.data.dataset import SimulationRecord, pool_to_scales
from mswe_gnn_tpu_torch.data.meshing import (
    EDGE_BC, EDGE_BOUNDARY, EDGE_NORMAL, Mesh,
    add_ghost_cells, stack_meshes,
)

_FILL = -999
_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _read_h5(path: str, names: Sequence[str]) -> Optional[Dict[str, np.ndarray]]:
    try:
        import h5py
    except ImportError:
        with open(path, "rb") as f:
            if f.read(8) == _HDF5_SIGNATURE:
                raise ImportError(f"{path} is an HDF5 (NetCDF-4) file, which needs h5py; "
                                  "h5py is not installed (classic NetCDF-3 files are "
                                  "read with scipy)") from None
        return None  # not HDF5 -> classic NetCDF-3
    try:
        f = h5py.File(path, "r")
    except OSError:
        return None  # not HDF5 -> classic NetCDF-3
    out = {}
    with f:
        for n in names:
            if n not in f:
                continue
            ds = f[n]
            a = np.asarray(ds[()])
            fill = ds.attrs.get("_FillValue")
            if fill is not None and np.issubdtype(a.dtype, np.integer):
                a = np.where(a == np.asarray(fill).ravel()[0], _FILL, a)
            out[n] = a
    return out


def _read_nc3(path: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for n in names:
            if n not in f.variables:
                continue
            v = f.variables[n]
            a = np.asarray(v[()])
            fill = getattr(v, "_FillValue", None)
            if fill is not None and np.issubdtype(a.dtype, np.integer):
                a = np.where(a == np.asarray(fill).ravel()[0], _FILL, a)
            out[n] = a
    return out


def read_map_variables(path: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Read named variables from a NetCDF-4 (HDF5) or classic NetCDF-3 file.
    Integer fill values are normalized to -999."""
    got = _read_h5(path, names)
    if got is None:
        got = _read_nc3(path, names)
    return got


_TOPO_VARS = ("mesh2d_node_x", "mesh2d_node_y", "mesh2d_face_x",
              "mesh2d_face_y", "mesh2d_edge_nodes", "mesh2d_edge_type",
              "mesh2d_edge_faces", "mesh2d_face_nodes", "mesh2d_flowelem_bl")


def _polygon_area_per_face(node_xy, face_nodes, valid) -> np.ndarray:
    """Shoelace area per cell; ``face_nodes [F, M]`` 0-based, fill-masked."""
    F, M = face_nodes.shape
    counts = valid.sum(1)
    safe = np.where(valid, face_nodes, 0)
    xy = node_xy[safe]                                  # [F, M, 2]
    area = np.zeros(F)
    rows = np.arange(F)
    for m in range(M):
        nxt = np.where(m + 1 < counts, m + 1, 0)        # wrap within count
        x1, y1 = xy[:, m, 0], xy[:, m, 1]
        x2, y2 = xy[rows, nxt, 0], xy[rows, nxt, 1]
        area += np.where(m < counts, x1 * y2 - x2 * y1, 0.0)
    return np.abs(area) / 2.0


def mesh_from_map_netcdf(path: str, dem: Optional[np.ndarray] = None,
                         dem_file: Optional[str] = None,
                         dem_interp: str = "nearest"
                         ) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    """Build a :class:`Mesh` (dual-graph view) from a ``*_map.nc`` file.

    Returns (mesh, bc_faces, bc_wall_lengths): cells adjacent to
    ``edge_type == 2`` walls carry the inflow boundary condition
    (reference graph_creation.py:650-702, 1322-1338).

    DEM priority: explicit ``dem`` array > ``dem_file`` (x y z text,
    interpolated onto cell centers with ``dem_interp`` in
    'nearest' | 'linear' | 'cubic' — reference Mesh._import_DEM /
    interpolate_variable, graph_creation.py:834-845, 1046-1070) >
    ``mesh2d_flowelem_bl`` bed level in the file > zeros.
    """
    v = read_map_variables(path, _TOPO_VARS)
    node_xy = np.stack([v["mesh2d_node_x"], v["mesh2d_node_y"]], axis=1)
    face_xy = np.stack([v["mesh2d_face_x"], v["mesh2d_face_y"]], axis=1)
    F = face_xy.shape[0]

    face_nodes = np.asarray(v["mesh2d_face_nodes"])
    valid = face_nodes > 0
    area = _polygon_area_per_face(node_xy, face_nodes - 1, valid)

    if dem is None:
        if dem_file is not None and os.path.exists(dem_file):
            pts = np.loadtxt(dem_file)
            from mswe_gnn_tpu_torch.data.interp import interpolate_variable

            dem = interpolate_variable(face_xy, pts[:, :2], pts[:, 2],
                                       method=dem_interp)
        elif "mesh2d_flowelem_bl" in v:
            dem = np.asarray(v["mesh2d_flowelem_bl"], np.float64)
        else:
            dem = np.zeros(F)
    dem = np.asarray(dem, np.float64)

    edge_faces = np.asarray(v["mesh2d_edge_faces"], np.int64) - 1  # -1/fill = none
    edge_nodes = np.asarray(v["mesh2d_edge_nodes"], np.int64) - 1
    edge_type = np.asarray(v["mesh2d_edge_type"], np.int64)
    has_both = (edge_faces >= 0).all(axis=1)
    wall_len = np.linalg.norm(node_xy[edge_nodes[:, 0]]
                              - node_xy[edge_nodes[:, 1]], axis=1)

    # interior walls -> directed dual edges, both directions
    f0, f1 = edge_faces[has_both, 0], edge_faces[has_both, 1]
    src = np.concatenate([f0, f1])
    dst = np.concatenate([f1, f0])
    shared = np.concatenate([wall_len[has_both]] * 2)
    dual = np.stack([src, dst])
    rel = face_xy[dst] - face_xy[src]
    dist = np.maximum(np.linalg.norm(rel, axis=1), 1e-12)
    slope = (dem[src] - dem[dst]) / dist

    boundary_edge = ~has_both
    bfaces = np.unique(edge_faces[boundary_edge].ravel())
    bfaces = bfaces[bfaces >= 0]

    bc_edge = (edge_type == EDGE_BC)
    bc_faces = edge_faces[bc_edge]
    bc_faces = np.asarray([fa[fa >= 0][0] for fa in bc_faces], np.int64)
    bc_lengths = wall_len[bc_edge]

    mesh = Mesh(face_xy=face_xy, area=area, dem=dem, dual_edge_index=dual,
                face_distance=dist, face_relative_distance=rel,
                edge_slope=slope, shared_length=shared,
                boundary_faces=bfaces)
    return mesh, bc_faces, bc_lengths


def _boundary_polygon(node_xy, edge_nodes, edge_type) -> np.ndarray:
    """Order the boundary walls (type > 1) into one closed vertex loop."""
    bnd = edge_nodes[edge_type > EDGE_NORMAL]
    nxt = {}
    for a, b in bnd:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    start = int(bnd[0, 0])
    loop, prev, cur = [start], -1, start
    for _ in range(len(bnd)):
        cands = [n for n in nxt[cur] if n != prev]
        if not cands:
            break
        prev, cur = cur, cands[0]
        if cur == start:
            break
        loop.append(cur)
    return node_xy[np.asarray(loop, np.int64)]


def record_from_map_netcdf(
    path: str,
    hydrograph: np.ndarray,
    temporal_res: float,
    dem_file: Optional[str] = None,
    num_scales: int = 1,
    coarsen_factor: float = 2.0,
    type_bc: int = 2,
    solver_seconds: float = 0.0,
    seed: int = 0,
) -> SimulationRecord:
    """One raw ``*_map.nc`` solver output -> :class:`SimulationRecord`.

    ``hydrograph [T]`` is the total inflow discharge time series (the
    reference reads it from its Hydrograph/overview files and repeats it per
    ghost node, reference graph_creation.py:1578-1580). Instantaneous-sample
    alignment is kept (D-HYDRO semantics) — no zero-order-hold shift.

    ``num_scales > 1`` re-meshes coarser scales from the mesh's own boundary
    polygon with the native CDT engine (the reference re-meshes with
    MeshKernel from a polygon file, graph_creation.py:1526-1540), transfers
    by containment, and mean-pools the dynamics.
    """
    dyn = read_map_variables(
        path, ("mesh2d_waterdepth", "mesh2d_ucx", "mesh2d_ucy"))
    wd = np.asarray(dyn["mesh2d_waterdepth"], np.float64).T   # [F, T]
    vx = np.asarray(dyn["mesh2d_ucx"], np.float64).T
    vy = np.asarray(dyn["mesh2d_ucy"], np.float64).T

    mesh0, bc_faces, bc_lengths = mesh_from_map_netcdf(path, dem_file=dem_file)
    finest, ghosts = add_ghost_cells(mesh0, bc_faces, type_bc=type_bc)
    # exact BC wall lengths from the file (add_ghost_cells approximates
    # them as sqrt(area) when the primal mesh is unknown)
    ghosts.edge_bc_length = np.asarray(bc_lengths, np.float64)

    meshes = [finest]
    if num_scales > 1:
        from scipy.spatial import cKDTree

        from mswe_gnn_tpu_torch.data.triangulate import triangulate_polygon

        topo = read_map_variables(path, _TOPO_VARS)
        node_xy = np.stack([topo["mesh2d_node_x"], topo["mesh2d_node_y"]],
                           axis=1)
        poly = _boundary_polygon(node_xy,
                                 np.asarray(topo["mesh2d_edge_nodes"]) - 1,
                                 np.asarray(topo["mesh2d_edge_type"]))
        tree = cKDTree(mesh0.face_xy)

        def dem_fn(x, y):
            _, idx = tree.query(np.stack([x, y], axis=1))
            return mesh0.dem[idx]

        target = float(np.median(mesh0.face_distance))
        rng = np.random.default_rng(seed)
        for s in range(1, num_scales):
            meshes.append(triangulate_polygon(
                poly, target * coarsen_factor ** s, dem_fn, rng))
    ms = stack_meshes(meshes, ghosts=ghosts)

    def with_ghosts(a):
        return np.concatenate([a, a[ghosts.bc_faces]], axis=0)

    wd_all = pool_to_scales(with_ghosts(wd), ms)
    vx_all = pool_to_scales(with_ghosts(vx), ms)
    vy_all = pool_to_scales(with_ghosts(vy), ms)

    hydro = np.asarray(hydrograph, np.float64)
    assert hydro.shape[0] == wd.shape[1], (
        f"hydrograph length {hydro.shape[0]} != map time steps {wd.shape[1]}")
    per_ghost = hydro[None, :] / max(len(ghosts.ghost_nodes), 1)
    bc_per_length = per_ghost / ghosts.edge_bc_length[:, None]

    return SimulationRecord(mesh=ms, wd=wd_all, vx=vx_all, vy=vy_all,
                            bc_per_length=bc_per_length,
                            temporal_res=temporal_res,
                            solver_seconds=solver_seconds)


def numerical_times(overview_csv: str, seeds: Sequence[int],
                    model_hours: Optional[float] = None) -> np.ndarray:
    """Per-simulation numerical-solver seconds from an ``overview.csv``
    (columns ``seed, mesh_num_faces, simulation_time[h],
    computation_time[s]``), optionally rescaled to the modelled horizon —
    the reference's speed-up bookkeeping (utils/miscellaneous.py:70-108)."""
    rows = {}
    with open(overview_csv) as f:
        for r in csv.DictReader(f):
            rows[int(float(r["seed"]))] = (float(r["computation_time[s]"]),
                                           float(r["simulation_time[h]"]))
    out = []
    for s in seeds:
        secs, sim_h = rows[int(s)]
        ratio = 1.0 if model_hours is None else model_hours / sim_h
        out.append(secs * ratio)
    return np.asarray(out)


def grid_map_variables(nx: int, ny: int, dx: float, wd: np.ndarray, vx: np.ndarray,
                       vy: np.ndarray, bc_faces: Sequence[int],
                       dem: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """The ``mesh2d_*`` variables of a D-HYDRO-style map file for a regular
    grid, in the file's orientation (1-based indices, series ``[T, F]``).

    Cells are column-major to match :func:`data.meshing.grid_mesh` (cell
    (i, j) -> face i*ny + j). ``wd/vx/vy`` are [F, T]. BC walls (left side of
    each ``bc_faces`` cell, which must lie on the i=0 column) get
    ``edge_type 2``."""
    F = nx * ny
    assert wd.shape[0] == F
    bc_faces = np.asarray(bc_faces, np.int64)
    assert np.all(bc_faces // ny == 0), "BC cells must lie on the i=0 column"

    def vid(i, j):  # vertex (i, j), i in [0, nx], j in [0, ny]
        return i * (ny + 1) + j

    node_x = np.repeat(np.arange(nx + 1) * dx, ny + 1).astype(np.float64)
    node_y = np.tile(np.arange(ny + 1) * dx, nx + 1).astype(np.float64)

    face_nodes = np.zeros((F, 4), np.int64)
    for i in range(nx):
        for j in range(ny):
            f = i * ny + j
            face_nodes[f] = (vid(i, j), vid(i + 1, j),
                             vid(i + 1, j + 1), vid(i, j + 1))
    face_x = node_x[face_nodes].mean(1)
    face_y = node_y[face_nodes].mean(1)

    edge_nodes, edge_faces, edge_type = [], [], []
    bc_set = set(int(b) for b in bc_faces)
    # vertical walls (between (i-1, j) and (i, j)): normal along x
    for i in range(nx + 1):
        for j in range(ny):
            a, b = vid(i, j), vid(i, j + 1)
            left = (i - 1) * ny + j if i > 0 else -1
            right = i * ny + j if i < nx else -1
            edge_nodes.append((a, b))
            edge_faces.append((left, right))
            if left >= 0 and right >= 0:
                edge_type.append(EDGE_NORMAL)
            elif i == 0 and right in bc_set:
                edge_type.append(EDGE_BC)
            else:
                edge_type.append(EDGE_BOUNDARY)
    # horizontal walls (between (i, j-1) and (i, j))
    for i in range(nx):
        for j in range(ny + 1):
            a, b = vid(i, j), vid(i + 1, j)
            below = i * ny + (j - 1) if j > 0 else -1
            above = i * ny + j if j < ny else -1
            edge_nodes.append((a, b))
            edge_faces.append((below, above))
            edge_type.append(EDGE_NORMAL if (below >= 0 and above >= 0)
                             else EDGE_BOUNDARY)

    out = {"mesh2d_node_x": node_x, "mesh2d_node_y": node_y,
           "mesh2d_face_x": face_x, "mesh2d_face_y": face_y,
           "mesh2d_face_nodes": face_nodes + 1,
           "mesh2d_edge_nodes": np.asarray(edge_nodes, np.int64) + 1,
           "mesh2d_edge_faces": np.asarray(edge_faces, np.int64) + 1,
           "mesh2d_edge_type": np.asarray(edge_type, np.int64),
           "mesh2d_waterdepth": np.asarray(wd).T,
           "mesh2d_ucx": np.asarray(vx).T, "mesh2d_ucy": np.asarray(vy).T}
    if dem is not None:
        out["mesh2d_flowelem_bl"] = np.asarray(dem)
    return out


# the integer fill value of each variable that has one, as the writers store it
_FILL_VALUES = {"mesh2d_face_nodes": -999, "mesh2d_edge_faces": 0}
# the NetCDF-3 dimensions of each variable
_NC3_DIMS = {"mesh2d_node_x": ("nmesh2d_node",), "mesh2d_node_y": ("nmesh2d_node",),
             "mesh2d_face_x": ("nmesh2d_face",), "mesh2d_face_y": ("nmesh2d_face",),
             "mesh2d_face_nodes": ("nmesh2d_face", "max_nmesh2d_face_nodes"),
             "mesh2d_edge_nodes": ("nmesh2d_edge", "Two"),
             "mesh2d_edge_faces": ("nmesh2d_edge", "Two"),
             "mesh2d_edge_type": ("nmesh2d_edge",),
             "mesh2d_waterdepth": ("time", "nmesh2d_face"),
             "mesh2d_ucx": ("time", "nmesh2d_face"), "mesh2d_ucy": ("time", "nmesh2d_face"),
             "mesh2d_flowelem_bl": ("nmesh2d_face",)}


def write_grid_map_netcdf(path: str, nx: int, ny: int, dx: float,
                          wd: np.ndarray, vx: np.ndarray, vy: np.ndarray,
                          bc_faces: Sequence[int],
                          dem: Optional[np.ndarray] = None,
                          classic: bool = False) -> None:
    """Write a D-HYDRO-style ``mesh2d_*`` map file for a regular grid
    (:func:`grid_map_variables`) — the writer side of the ingestion
    round-trip tests, and an exporter for downstream UGRID tooling.

    The default is the JAX package's file: the HDF5 / NetCDF-4 layout via
    h5py. ``classic=True`` writes classic NetCDF-3 with
    ``scipy.io.netcdf_file`` instead (no h5py needed), its integers as
    int32, the widest integer the format has."""
    variables = grid_map_variables(nx, ny, dx, wd, vx, vy, bc_faces, dem)
    if classic:
        from scipy.io import netcdf_file

        with netcdf_file(path, "w") as f:
            for name, value in variables.items():
                for dim, size in zip(_NC3_DIMS[name], value.shape):
                    if dim not in f.dimensions:
                        f.createDimension(dim, size)
                if np.issubdtype(value.dtype, np.integer):
                    value = value.astype(np.int32)
                var = f.createVariable(name, value.dtype, _NC3_DIMS[name])
                var[:] = value
                if name in _FILL_VALUES:
                    var._FillValue = np.int32(_FILL_VALUES[name])
        return
    from mswe_gnn_tpu_torch.data.io import require_h5py

    with require_h5py().File(path, "w") as f:
        for name, value in variables.items():
            ds = f.create_dataset(name, data=value)
            if name in _FILL_VALUES:
                ds.attrs["_FillValue"] = np.int64(_FILL_VALUES[name])


def load_map_folder(folder: str, temporal_res: float,
                    num_scales: int = 1,
                    overview_file: Optional[str] = None,
                    dem_folder: Optional[str] = None,
                    hydrograph_folder: Optional[str] = None,
                    limit: Optional[int] = None) -> List[SimulationRecord]:
    """Ingest a raw-simulation folder: every ``output_<i>_map.nc`` becomes a
    :class:`SimulationRecord` (the reference's create_mesh_dataset loop,
    database/graph_creation.py:1584-1623).

    Sidecar conventions (all optional):
      overview.csv                      solver timings (``overview_file``
                                        overrides; default <folder>/overview.csv)
      <dem_folder>/DEM_<i>.xyz          terrain (x y z text)
      <hydrograph_folder>/Hydrograph_<i>.csv|npy
                                        inflow series; without one, the BC
                                        series is reconstructed from the
                                        stored depths' volume changes

    A folder without map files raises FileNotFoundError (the JAX package
    returns no records, and its caller fails later on the empty list).
    """
    import glob
    import re as _re

    paths = sorted(glob.glob(os.path.join(folder, "output_*_map.nc")),
                   key=lambda p: int(_re.search(r"output_(\d+)_map", p).group(1)))
    if not paths:
        raise FileNotFoundError(f"no output_<i>_map.nc file in {folder}")
    if limit:
        paths = paths[:limit]
    overview = overview_file or os.path.join(folder, "overview.csv")
    times = {}
    if os.path.exists(overview):
        with open(overview) as f:
            for r in csv.DictReader(f):
                times[int(float(r["seed"]))] = float(r["computation_time[s]"])

    records = []
    for p in paths:
        i = int(_re.search(r"output_(\d+)_map", p).group(1))
        dem_file = (os.path.join(dem_folder, f"DEM_{i}.xyz")
                    if dem_folder else None)
        hydro = None
        if hydrograph_folder:
            for ext, loader in ((".npy", np.load),
                                (".csv", lambda q: np.loadtxt(q, delimiter=",",
                                                              ndmin=2)[:, -1])):
                hp = os.path.join(hydrograph_folder, f"Hydrograph_{i}{ext}")
                if os.path.exists(hp):
                    hydro = np.asarray(loader(hp), np.float64).ravel()
                    break
        if hydro is None:
            # reconstruct total inflow from stored volume changes:
            # Q[t] ~= sum_f area_f * (h[t] - h[t-1]) / dt  (clipped at 0)
            v = read_map_variables(p, ("mesh2d_waterdepth",))
            wd = np.asarray(v["mesh2d_waterdepth"], np.float64).T
            mesh0, _, _ = mesh_from_map_netcdf(p)
            dvol = (mesh0.area[:, None] * np.diff(wd, axis=1)).sum(0)
            hydro = np.concatenate([[0.0], np.maximum(dvol, 0.0)
                                    / (temporal_res * 60.0)])
        records.append(record_from_map_netcdf(
            p, hydro, temporal_res, dem_file=dem_file, num_scales=num_scales,
            solver_seconds=times.get(i, 0.0)))
    return records
