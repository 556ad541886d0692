"""Synthetic flood-simulation generator (ground-truth producer).

Replaces the reference's offline D-HYDRO pipeline (reference
database/dhydro_utils.py:286-397) — which requires a licensed Windows solver —
with a self-contained diffusive-wave shallow-water solver on the cell graph,
plus random terrain and random inflow hydrographs. Used for unit tests,
end-to-end demos and the bench problem (a copy of
mswe_gnn_tpu/data/simulate.py, which the port does not import).

Physics (explicit diffusive-wave / Manning approximation):
    WL_i   = DEM_i + h_i
    flux_ij = C * w_ij * h_up^(5/3) * (WL_i - WL_j) / dist_ij      [m^3/s]
    dh_i/dt = (sum_j flux_ji - sum_j flux_ij + Q_i) / A_i
with upwind depth h_up = h of the higher-WL cell. Inflow Q enters at the
BC faces from a random Weibull-shaped hydrograph (reference
dhydro_utils.py:152-194).

Optional storm forcing (the physics behind the reference's storm-surge
extension, reference utils/adforce_dataset.py): a pressure anomaly P [Pa]
enters through the inverse-barometer effective level WL + P/(rho g), and a
surface wind stress tau [N/m^2] tilts the water surface by the steady wind
setup balance, adding tau·u_hat / (rho g h) to the edge slope.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from mswe_gnn_tpu_torch.data.meshing import Mesh


def random_dem_fn(rng: np.random.Generator, extent: float, relief: float = 5.0,
                  n_modes: int = 8) -> Callable:
    """Smooth random terrain: sum of random low-frequency cosine modes.

    A licence-free stand-in for the reference's Perlin-noise DEM
    (reference database/dhydro_utils.py:36-85).
    """
    amps = rng.uniform(0.2, 1.0, n_modes)
    amps = amps / amps.sum() * relief
    freqs = rng.uniform(0.5, 2.5, (n_modes, 2)) * (2 * np.pi / extent)
    phases = rng.uniform(0, 2 * np.pi, n_modes)
    tilt = rng.uniform(-relief, relief, 2) / extent

    def dem(x, y):
        z = tilt[0] * x + tilt[1] * y
        for a, (fx, fy), p in zip(amps, freqs, phases):
            z = z + a * np.cos(fx * x + fy * y + p)
        return z - z.min() if np.ndim(z) else z

    return dem


def random_hydrograph(rng: np.random.Generator, total_hours: float = 96.0,
                      dt_minutes: float = 60.0, peak_discharge: float = 150.0,
                      shape: float = 2.0) -> np.ndarray:
    """Weibull-shaped inflow hydrograph [m^3/s] sampled every ``dt_minutes``
    (reference database/dhydro_utils.py:152-194)."""
    t = np.arange(0, total_hours + 1e-9, dt_minutes / 60.0)
    scale = rng.uniform(0.15, 0.4) * total_hours
    k = rng.uniform(1.5, shape + 1.5)
    x = t / scale
    q = (k / scale) * x ** (k - 1) * np.exp(-(x ** k))
    q = q / q.max() * peak_discharge * rng.uniform(0.5, 1.5)
    return q


@dataclasses.dataclass
class Simulation:
    """One ground-truth run: depth + velocity fields over time on a mesh."""
    wd: np.ndarray     # [F, T] water depth [m]
    vx: np.ndarray     # [F, T] velocity x [m/s]
    vy: np.ndarray     # [F, T] velocity y [m/s]
    bc_hydrograph: np.ndarray   # [T] inflow discharge [m^3/s] (total)
    bc_faces: np.ndarray        # faces receiving inflow
    dt_minutes: float


RHO_WATER = 1000.0   # kg/m^3
GRAVITY = 9.81       # m/s^2


def run_diffusive_wave(
    mesh: Mesh,
    bc_faces: np.ndarray,
    hydrograph: np.ndarray,
    dt_minutes: float = 60.0,
    substeps: int = 60,
    conveyance: float = 8.0,
    wind: Optional[np.ndarray] = None,      # [F, 2, T] surface stress [N/m^2]
    pressure: Optional[np.ndarray] = None,  # [F, T] pressure anomaly [Pa]
    min_wind_depth: float = 0.05,           # [m] depth floor in the setup term
    h0: Optional[np.ndarray] = None,        # [F] initial depth (default dry)
) -> Simulation:
    """Explicit diffusive-wave solve; outputs sampled every ``dt_minutes``.

    ``wind``/``pressure`` are exogenous storm fields held constant within each
    output interval. Wind adds momentum through the water surface (setup
    slope tau/(rho g h)); pressure shifts the effective level (inverse
    barometer). Neither adds or removes mass."""
    F = mesh.num_faces
    T = len(hydrograph)
    src, dst = mesh.dual_edge_index
    w = mesh.shared_length
    dist = mesh.face_distance
    area = mesh.area
    dem = mesh.dem
    rel = mesh.face_relative_distance / dist[:, None]  # unit vectors src->dst

    # one direction per wall is enough for the physics; keep edges with src<dst
    keep = src < dst
    s1, d1, w1, l1 = src[keep], dst[keep], w[keep], dist[keep]
    u1 = rel[keep]

    h = np.zeros(F) if h0 is None else np.asarray(h0, float).copy()
    wd = np.zeros((F, T))
    vx = np.zeros((F, T))
    vy = np.zeros((F, T))
    dt = dt_minutes * 60.0 / substeps

    q_per_face = np.zeros(F)
    for t in range(T):
        q_in = hydrograph[t] / max(len(bc_faces), 1)
        mom_x = np.zeros(F)
        mom_y = np.zeros(F)
        # inverse-barometer level offset and along-edge wind stress for this
        # output interval (exogenous fields are piecewise-constant in t)
        p_level = pressure[:, t] / (RHO_WATER * GRAVITY) if pressure is not None else 0.0
        if wind is not None:
            tau_edge = 0.5 * (wind[s1, :, t] + wind[d1, :, t])   # [E1, 2]
            tau_along = (tau_edge * u1).sum(axis=1)              # src->dst comp.
        for _ in range(substeps):
            wl = dem + h + p_level
            grad = (wl[s1] - wl[d1]) / l1
            if wind is not None:
                # steady wind-setup balance: rho g h dWL/dx = tau. The wetter
                # endpoint sets the effective depth; dry walls feel no wind
                # (their conveyance h_up^(5/3) is 0 anyway).
                h_e = np.maximum(np.maximum(h[s1], h[d1]), min_wind_depth)
                grad = grad + tau_along / (RHO_WATER * GRAVITY * h_e)
            h_up = np.where(grad > 0, h[s1], h[d1])
            flux = conveyance * w1 * np.power(np.maximum(h_up, 0.0), 5.0 / 3.0) * grad
            # stability: never move more water than the upwind cell holds
            donor_area = np.where(grad > 0, area[s1], area[d1])
            max_flux = np.maximum(h_up, 0.0) * donor_area / dt * 0.25
            flux = np.clip(flux, -max_flux, max_flux)

            dh = np.zeros(F)
            np.add.at(dh, d1, flux)
            np.subtract.at(dh, s1, flux)
            q_per_face[:] = 0.0
            q_per_face[bc_faces] = q_in
            h = np.maximum(h + dt * (dh + q_per_face) / area, 0.0)

            np.add.at(mom_x, s1, flux * u1[:, 0])
            np.add.at(mom_x, d1, flux * u1[:, 0])
            np.add.at(mom_y, s1, flux * u1[:, 1])
            np.add.at(mom_y, d1, flux * u1[:, 1])

        wd[:, t] = h
        # cell velocity = mean wall flux / (depth * cell width)
        width = np.sqrt(area)
        denom = np.maximum(h, 1e-3) * width * 2.0 * substeps
        vx[:, t] = np.where(h > 1e-3, mom_x / denom, 0.0)
        vy[:, t] = np.where(h > 1e-3, mom_y / denom, 0.0)

    return Simulation(wd=wd, vx=vx, vy=vy, bc_hydrograph=hydrograph,
                      bc_faces=np.asarray(bc_faces), dt_minutes=dt_minutes)
