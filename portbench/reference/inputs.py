"""The benchmark's inputs, made from a seed with numpy alone.

A frozen copy of the port's synthetic grid generator
(``data/synthetic.py::make_multiscale_grid`` with
``data/simulate.py::random_dem_fn`` and ``data/meshing.py``'s grid, ghost
cells and nearest-centre transfer edges), kept here so that later changes to
the port cannot change what the benchmark feeds it. It gives raw arrays
only: the harness hands them to the port's data path, and the plain
reference (``reference/model.py``) reads the same arrays.

A study is one mesh (the terrain drawn from the seed) and ``n_scenarios``
scenarios on it: water depth and velocities at every node and frame, drawn
from the laws ``bench_problem.py`` draws them from, and an inflow per unit boundary length
at the ghost cells. Every seed gives the same sizes; only values differ.
"""
from __future__ import annotations

import numpy as np


def random_dem(rng: np.random.Generator, extent: float, relief: float = 4.0,
               n_modes: int = 8):
    """Smooth random terrain: a tilt plus ``n_modes`` cosine modes
    (``simulate.py::random_dem_fn``)."""
    amps = rng.uniform(0.2, 1.0, n_modes)
    amps = amps / amps.sum() * relief
    freqs = rng.uniform(0.5, 2.5, (n_modes, 2)) * (2 * np.pi / extent)
    phases = rng.uniform(0, 2 * np.pi, n_modes)
    tilt = rng.uniform(-relief, relief, 2) / extent

    def dem(x, y):
        z = tilt[0] * x + tilt[1] * y
        for a, (fx, fy), p in zip(amps, freqs, phases):
            z = z + a * np.cos(fx * x + fy * y + p)
        return z - z.min()

    return dem


def _edge_geometry(face_xy, dem, edge_index):
    rel = face_xy[edge_index[1]] - face_xy[edge_index[0]]
    dist = np.maximum(np.linalg.norm(rel, axis=1), 1e-12)
    slope = (dem[edge_index[0]] - dem[edge_index[1]]) / dist
    return dist, rel, slope


def grid_mesh(nx: int, ny: int, dx: float, dem_fn) -> dict:
    """A regular quad mesh's dual graph; cell (i, j) is node ``i * ny + j``
    and every wall gives two directed edges, in ``meshing.grid_mesh``'s
    order."""
    xs = (np.arange(nx) + 0.5) * dx
    ys = (np.arange(ny) + 0.5) * dx
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    face_xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
    dem = dem_fn(face_xy[:, 0], face_xy[:, 1]).astype(np.float64)
    fid = np.arange(nx * ny).reshape(nx, ny)
    # per cell in (i, j) order: the +i wall's two edges, then the +j wall's
    right = np.zeros((nx, ny), bool)
    right[:-1, :] = True
    up = np.zeros((nx, ny), bool)
    up[:, :-1] = True
    per_cell = []
    for has, nb in ((right, np.roll(fid, -1, axis=0)), (up, np.roll(fid, -1, axis=1))):
        pairs = np.stack([np.stack([fid, nb], -1), np.stack([nb, fid], -1)], -2)  # [nx,ny,2,2]
        per_cell.append(np.where(has[..., None, None], pairs, -1))
    edges = np.concatenate(per_cell, axis=2).reshape(-1, 2)
    edge_index = edges[edges[:, 0] >= 0].T.astype(np.int64)
    dist, rel, slope = _edge_geometry(face_xy, dem, edge_index)
    return {"face_xy": face_xy, "area": np.full(nx * ny, dx * dx), "dem": dem,
            "edge_index": edge_index, "face_distance": dist,
            "face_relative_distance": rel, "edge_slope": slope,
            "shared_length": np.full(edge_index.shape[1], dx)}


def add_ghost_cells(mesh: dict, bc_faces: np.ndarray) -> tuple:
    """Ghost cells mirroring ``bc_faces`` outward, with directed
    ghost -> face edges (``meshing.add_ghost_cells``) -> (mesh, ghosts)."""
    f = len(mesh["area"])
    centers = mesh["face_xy"][bc_faces]
    dirs = centers - mesh["face_xy"].mean(0)
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-9)
    spacing = np.sqrt(mesh["area"][bc_faces])
    face_xy = np.concatenate([mesh["face_xy"], centers + dirs * spacing[:, None]])
    dem = np.concatenate([mesh["dem"], mesh["dem"][bc_faces]])
    ghost_ids = f + np.arange(len(bc_faces))
    edge_index = np.concatenate(
        [mesh["edge_index"], np.stack([ghost_ids, bc_faces.astype(np.int64)])], axis=1)
    dist, rel, slope = _edge_geometry(face_xy, dem, edge_index)
    out = {"face_xy": face_xy, "area": np.concatenate([mesh["area"], mesh["area"][bc_faces]]),
           "dem": dem, "edge_index": edge_index, "face_distance": dist,
           "face_relative_distance": rel, "edge_slope": slope,
           "shared_length": np.concatenate([mesh["shared_length"], spacing])}
    ghosts = {"ghost_nodes": ghost_ids, "bc_faces": np.asarray(bc_faces, np.int64),
              "edge_bc_length": spacing}
    return out, ghosts


def lattice_owner(points: np.ndarray, nx: int, ny: int, h: float) -> np.ndarray:
    """Index of the nearest cell centre of the ``nx`` x ``ny`` lattice of
    spacing ``h`` for every point, the lowest index winning a tie: the
    answer of ``meshing.nearest_center``'s brute-force search, taken per
    axis (the lattice is separable), in milliseconds instead of seconds."""
    def axis(u, n):
        return np.clip(np.ceil(u / h - 1.0), 0, n - 1).astype(np.int64)
    return axis(points[:, 0], nx) * ny + axis(points[:, 1], ny)


def make_mesh(grid: dict, seed: int) -> dict:
    """The multiscale grid of ``grid`` (``nx``, ``ny``, ``dx``,
    ``num_scales``, ``n_bc``) on terrain drawn from ``seed`` -> ``meshes``
    (finest first, ghost cells on the finest), ``ghosts`` (finest-local ids,
    which are also global ids) and the transfer edges ``intra [(coarse,
    fine)]`` per level, in each scale's local ids."""
    nx, ny, dx = grid["nx"], grid["ny"], float(grid["dx"])
    rng = np.random.default_rng(seed)
    dem_fn = random_dem(rng, extent=nx * dx, relief=4.0)
    j0 = ny // 2 - grid["n_bc"] // 2
    bc_faces = np.arange(j0, j0 + grid["n_bc"], dtype=np.int64)      # cells (0, j)
    finest, ghosts = add_ghost_cells(grid_mesh(nx, ny, dx, dem_fn), bc_faces)
    meshes = [finest]
    for s in range(1, grid["num_scales"]):
        f = 2 ** s
        meshes.append(grid_mesh(max(nx // f, 1), max(ny // f, 1), dx * f, dem_fn))
    intra = []
    for s in range(1, len(meshes)):
        f = 2 ** s
        owner = lattice_owner(meshes[s - 1]["face_xy"], max(nx // f, 1), max(ny // f, 1),
                              dx * f)
        intra.append(np.stack([owner, np.arange(len(owner), dtype=np.int64)]))
    return {"meshes": meshes, "ghosts": ghosts, "intra": intra}


def make_scenarios(mesh: dict, frames: int, n_scenarios: int, seed: int) -> list:
    """``n_scenarios`` scenarios on ``mesh``: ``wd``, ``vx``, ``vy`` [N, T]
    over every scale's nodes and ``bc_per_length`` [ghosts, T], float32
    normals as ``bench_problem.py`` draws them, from a stream of the seed's
    own (``[seed, 1]``), so that the scenarios never change the mesh."""
    n = sum(len(m["area"]) for m in mesh["meshes"])
    nbc = len(mesh["ghosts"]["ghost_nodes"])
    rng = np.random.default_rng([seed, 1])

    def normal(mean, std, rows):
        return mean + std * rng.standard_normal((rows, frames), dtype=np.float32)

    return [{"wd": np.abs(normal(0.4, 0.3, n)), "vx": normal(0.0, 0.3, n),
             "vy": normal(0.0, 0.3, n), "bc_per_length": np.abs(normal(0.2, 0.1, nbc))}
            for _ in range(n_scenarios)]
