"""End-to-end synthetic dataset generation (mesh + simulation + record).

Port of mswe_gnn_tpu/data/synthetic.py: regular multiscale grid meshes or
random-polygon triangulated hierarchies (data/triangulate.py), random
cosine-mode terrain, Weibull hydrographs, the diffusive-wave solver of
data/simulate.py and translating storm fields (wind stress and a pressure
low) that drive the solver and ride on the record as ``forcing``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from mswe_gnn_tpu_torch.data.dataset import SimulationRecord, pool_to_scales
from mswe_gnn_tpu_torch.data.meshing import (
    Mesh, MultiscaleMesh, add_ghost_cells, grid_mesh, stack_meshes,
)
from mswe_gnn_tpu_torch.data.simulate import (
    random_dem_fn, random_hydrograph, run_diffusive_wave,
)
from mswe_gnn_tpu_torch.data.triangulate import triangulated_hierarchy

# The JAX package's GENERATOR_VERSION (bumped when generated records change
# meaning); main._generate_cached keys its disk cache on it.
# v2: BC/forcing series are zero-order-hold aligned — column t holds the
# forcing of the interval (t, t+1] (see generate_simulation_record).
GENERATOR_VERSION = 2
STORM_FIELDS = ("WX", "WY", "P")


def make_multiscale_grid(nx: int, ny: int, dx: float, num_scales: int,
                         dem_fn, n_bc: int = 2, type_bc: int = 2
                         ) -> MultiscaleMesh:
    """L-level grid hierarchy with ghost cells on the finest scale.

    BC faces sit on the left boundary mid-height (a breach inflow).
    """
    meshes: List[Mesh] = []
    base = grid_mesh(nx, ny, dx, dem_fn)
    # BC faces: contiguous run on the left edge (i = 0), centered in y
    j0 = ny // 2 - n_bc // 2
    bc_faces = np.asarray([0 * ny + (j0 + k) for k in range(n_bc)], dtype=np.int64)
    finest, ghosts = add_ghost_cells(base, bc_faces, type_bc=type_bc)
    meshes.append(finest)
    for s in range(1, num_scales):
        f = 2 ** s
        meshes.append(grid_mesh(max(nx // f, 1), max(ny // f, 1), dx * f, dem_fn))
    return stack_meshes(meshes, ghosts=ghosts)


def make_multiscale_tri(rng: np.random.Generator, dem_fn, num_scales: int,
                        avg_radius: float, target_edge: float,
                        n_bc: int = 2, type_bc: int = 2,
                        with_dike: bool = False) -> MultiscaleMesh:
    """Random-polygon triangulated hierarchy with ghost cells
    (the reference's MeshKernel path, graph_creation.py:473-528)."""
    meshes = triangulated_hierarchy(rng, dem_fn, num_scales=num_scales,
                                    avg_radius=avg_radius,
                                    target_edge=target_edge,
                                    with_dike=with_dike)
    base = meshes[0]
    # BC faces: boundary cells nearest a random boundary location
    # (reference dhydro_utils.py:134-150)
    bfaces = base.boundary_faces
    anchor = bfaces[int(rng.integers(0, len(bfaces)))]
    d = np.linalg.norm(base.face_xy[bfaces] - base.face_xy[anchor], axis=1)
    bc_faces = np.sort(bfaces[np.argsort(d)[:n_bc]]).astype(np.int64)
    finest, ghosts = add_ghost_cells(base, bc_faces, type_bc=type_bc)
    return stack_meshes([finest] + meshes[1:], ghosts=ghosts)


def _strip_ghosts(mesh_with_ghosts: Mesh, n_ghost: int) -> Mesh:
    """Physical sub-mesh: drop the trailing ghost cells and their edges."""
    n_phys = mesh_with_ghosts.num_faces - n_ghost
    keep = ((mesh_with_ghosts.dual_edge_index[0] < n_phys)
            & (mesh_with_ghosts.dual_edge_index[1] < n_phys))
    return Mesh(
        face_xy=mesh_with_ghosts.face_xy[:n_phys],
        area=mesh_with_ghosts.area[:n_phys],
        dem=mesh_with_ghosts.dem[:n_phys],
        dual_edge_index=mesh_with_ghosts.dual_edge_index[:, keep],
        face_distance=mesh_with_ghosts.face_distance[keep],
        face_relative_distance=mesh_with_ghosts.face_relative_distance[keep],
        edge_slope=mesh_with_ghosts.edge_slope[keep],
        shared_length=mesh_with_ghosts.shared_length[keep],
        boundary_faces=mesh_with_ghosts.boundary_faces)


def generate_simulation_record(
    seed: int,
    nx: int = 32,
    ny: int = 32,
    dx: float = 100.0,
    num_scales: int = 3,
    total_hours: float = 48.0,
    temporal_res: float = 60.0,
    n_bc: int = 2,
    peak_discharge: float = 150.0,
    substeps: int = 20,
    mesh_type: str = "grid",
    storm: bool = False,
    storm_wind_scale: float = 2.0,
    storm_pressure_scale: float = 1500.0,
) -> SimulationRecord:
    """One full synthetic simulation on a multiscale mesh; the same record
    as the JAX package's for the same arguments.

    ``mesh_type``: 'grid' (regular quad cells) or 'triangulated' (random
    irregular polygon + constrained Delaunay hierarchy).

    ``storm=True`` draws a translating cyclone (``make_storm_fields``) that
    drives the solver (wind setup and inverse barometer) and lands on
    ``SimulationRecord.forcing`` as WX, WY, P, pooled to every scale. The
    defaults are storm-sized: ~2 N/m^2 peak stress and a 15 hPa low."""
    if mesh_type not in ("grid", "triangulated"):
        raise ValueError(f"unknown mesh_type {mesh_type!r}")

    rng = np.random.default_rng(seed)
    dem_fn = random_dem_fn(rng, extent=nx * dx, relief=4.0)
    if mesh_type == "grid":
        mesh = make_multiscale_grid(nx, ny, dx, num_scales, dem_fn, n_bc=n_bc)
    else:
        mesh = make_multiscale_tri(rng, dem_fn, num_scales, avg_radius=nx * dx / 2.0,
                                   target_edge=dx, n_bc=n_bc)
    ghosts = mesh.ghosts
    finest = mesh.meshes[0]

    hydro = random_hydrograph(rng, total_hours=total_hours,
                              dt_minutes=temporal_res,
                              peak_discharge=peak_discharge)
    # simulate on the physical (non-ghost) cells of the finest mesh
    phys = _strip_ghosts(finest, len(ghosts.ghost_nodes))
    fields = None
    if storm:
        fields = make_storm_fields(phys.face_xy, len(hydro), rng,
                                   wind_scale=storm_wind_scale,
                                   pressure_scale=storm_pressure_scale)
    t0 = time.time()
    sim = run_diffusive_wave(
        phys, ghosts.bc_faces, hydro, dt_minutes=temporal_res, substeps=substeps,
        wind=fields[:, :2] if fields is not None else None,
        pressure=fields[:, 2] if fields is not None else None)
    solver_seconds = time.time() - t0

    # ghost rows mirror their BC face (reference graph_creation.py:1466-1481)
    def with_ghosts(a):
        return np.concatenate([a, a[ghosts.bc_faces]], axis=0)

    wd = pool_to_scales(with_ghosts(sim.wd), mesh)
    vx = pool_to_scales(with_ghosts(sim.vx), mesh)
    vy = pool_to_scales(with_ghosts(sim.vy), mesh)

    # Zero-order-hold alignment (see mswe_gnn_tpu/data/synthetic.py): column
    # t of the BC series holds the inflow of the interval (t, t+1] that the
    # rollout step from frame t predicts, i.e. hydro[t+1]. Per-ghost inflow
    # per unit BC-edge length (reference utils/dataset.py:275).
    hydro_zoh = np.concatenate([hydro[1:], hydro[-1:]])
    per_ghost = hydro_zoh[None, :] / max(len(ghosts.ghost_nodes), 1)
    bc_per_length = per_ghost / ghosts.edge_bc_length[:, None]

    forcing, forcing_names = None, ()
    if storm:
        # the same zero-order-hold shift: fields[:, :, t] drives interval t,
        # and with_step_forcing feeds the column at the last input frame
        f0 = with_ghosts(np.concatenate([fields[:, :, 1:], fields[:, :, -1:]],
                                        axis=2))       # [N0, 3, T]
        forcing = np.stack([pool_to_scales(f0[:, f], mesh) for f in range(3)],
                           axis=1).astype(np.float32)
        forcing_names = STORM_FIELDS

    return SimulationRecord(mesh=mesh, wd=wd, vx=vx, vy=vy,
                            bc_per_length=bc_per_length,
                            temporal_res=temporal_res,
                            solver_seconds=solver_seconds,
                            forcing=forcing, forcing_names=forcing_names)


def generate_dataset(n_sims: int, seed: int = 0, **kwargs) -> List[SimulationRecord]:
    return [generate_simulation_record(seed + i, **kwargs) for i in range(n_sims)]


def make_storm_fields(xy: np.ndarray, T: int, rng: np.random.Generator,
                      wind_scale: float = 0.5,
                      pressure_scale: float = 500.0) -> np.ndarray:
    """A translating smooth cyclone at the points ``xy`` -> ``[N, 3, T]``:
    WX, WY wind stress [N/m^2] and P pressure anomaly [Pa] (the exogenous
    fields of the reference's storm-surge extension, reference
    utils/adforce_dataset.py:80, 243-260). A Gaussian envelope around a
    centre that moves on a straight line across the domain, with the wind
    tangential to the radius (cyclonic)."""
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    extent = float(np.max(hi - lo))
    p0 = lo + rng.uniform(0.1, 0.4, 2) * (hi - lo)
    p1 = lo + rng.uniform(0.6, 0.9, 2) * (hi - lo)
    radius = extent * rng.uniform(0.2, 0.35)
    fields = np.zeros((xy.shape[0], 3, T), np.float32)
    for t in range(T):
        c = p0 + (p1 - p0) * (t / max(T - 1, 1))
        d = xy - c[None, :]
        envelope = np.exp(-(d ** 2).sum(axis=1) / (2 * radius ** 2))
        fields[:, 0, t] = wind_scale * envelope * (-d[:, 1] / radius)
        fields[:, 1, t] = wind_scale * envelope * (d[:, 0] / radius)
        fields[:, 2, t] = -pressure_scale * envelope
    return fields


def add_storm_forcing(rec: SimulationRecord, seed: int = 0,
                      wind_scale: float = 0.5,
                      pressure_scale: float = 500.0) -> SimulationRecord:
    """``rec`` with storm fields attached as input features only: the water
    series stay as they are. ``generate_simulation_record(storm=True)``
    gives a storm that drives the solver."""
    rng = np.random.default_rng(seed)
    mesh = rec.mesh
    xy = mesh.meshes[0].face_xy   # [N0, 2], the ghost rows (mirrored BC faces) included
    fields = make_storm_fields(xy, rec.wd.shape[1], rng, wind_scale=wind_scale,
                               pressure_scale=pressure_scale)
    pooled = np.stack([pool_to_scales(fields[:, f], mesh) for f in range(3)],
                      axis=1).astype(np.float32)
    return dataclasses.replace(rec, forcing=pooled, forcing_names=STORM_FIELDS)
