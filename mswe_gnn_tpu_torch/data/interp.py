"""Spatial interpolation and slope estimation for mesh attributes (port of
mswe_gnn_tpu/data/interp.py, the same numpy and scipy calls).

Host preprocessing utilities mirroring the reference's scattered-data helpers
(reference database/graph_creation.py:1004-1031 ``get_slopes``,
:1046-1086 ``interpolate_variable``/``interpolate_temporal_variable``):
least-squares plane-fit terrain slopes over a radius+KNN neighborhood, and
scipy-griddata interpolation with the reference's NaN backfill semantics.

These run once per dataset on the host. scipy is imported inside the
functions that use it, so that importing this module needs numpy only.
"""
from __future__ import annotations

import numpy as np


def get_slopes(coords: np.ndarray, dem: np.ndarray,
               neighborhood_size: float = 200.0,
               min_neighbours: int = 5):
    """Per-point terrain slope from a least-squares plane fit.

    The neighborhood of each point is the union of all points within
    ``neighborhood_size`` and its ``min_neighbours`` nearest neighbours
    (self excluded, as in the reference's radius_neighbors_graph/
    kneighbors_graph with include_self=False); a plane
    ``z = c0 + c1*x + c2*y`` is lstsq-fit to the neighborhood's DEM and
    ``(c1, c2)`` is the slope vector (reference
    database/graph_creation.py:1004-1031).

    Returns ``(slope_x, slope_y)``, each ``[N]``.
    """
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, np.float64)
    dem = np.asarray(dem, np.float64)
    n = coords.shape[0]
    tree = cKDTree(coords)
    radius_nb = tree.query_ball_point(coords, r=float(neighborhood_size))
    k = min(min_neighbours + 1, n)              # +1: query returns self too
    _, knn = tree.query(coords, k=k)
    knn = np.atleast_2d(knn)

    slope_x = np.zeros(n)
    slope_y = np.zeros(n)
    for i in range(n):
        nb = set(radius_nb[i])
        nb.update(int(j) for j in knn[i])
        nb.discard(i)
        if not nb:
            continue
        idx = np.fromiter(nb, dtype=np.int64)
        a = np.column_stack((np.ones(idx.size), coords[idx]))
        sol, *_ = np.linalg.lstsq(a, dem[idx], rcond=None)
        slope_x[i] = sol[1]
        slope_y[i] = sol[2]
    return slope_x, slope_y


def interpolate_variable(interpolated_points: np.ndarray, points: np.ndarray,
                         value: np.ndarray, method: str = "nearest"
                         ) -> np.ndarray:
    """Scattered-data interpolation of ``value`` (known at ``points``) onto
    ``interpolated_points`` via scipy griddata; ``method`` is
    'nearest' | 'linear' | 'cubic'. Points outside the convex hull (NaN under
    linear/cubic) are backfilled by 1-D interpolation over the flattened
    output index, matching the reference's semantics exactly
    (reference database/graph_creation.py:1046-1070).
    """
    from scipy.interpolate import griddata

    out = griddata(np.asarray(points, np.float64), np.asarray(value, np.float64),
                   np.asarray(interpolated_points, np.float64), method=method)
    mask = np.isnan(out)
    if mask.any():
        if mask.all():
            raise ValueError("interpolate_variable: no finite values to "
                             "interpolate from")
        out[mask] = np.interp(np.flatnonzero(mask), np.flatnonzero(~mask),
                              out[~mask])
    return out


def interpolate_temporal_variable(interpolated_points: np.ndarray,
                                  points: np.ndarray,
                                  temporal_value: np.ndarray,
                                  method: str = "nearest") -> np.ndarray:
    """Per-time-step :func:`interpolate_variable` over a ``[M, T]`` series →
    ``[N, T]`` (reference database/graph_creation.py:1072-1086)."""
    return np.stack([
        interpolate_variable(interpolated_points, points,
                             temporal_value[:, t], method=method)
        for t in range(temporal_value.shape[1])], axis=1)
