"""Irregular-domain mesh generation: random polygons, dikes, triangulations.

Port of mswe_gnn_tpu/data/triangulate.py (numpy, as there). Replaces the
reference's MeshKernel/Triangle mesh factory (reference
database/graph_creation.py:148-344 polygon machinery, :456-528
triangulators): random irregular polygons (ellipticality / irregularity /
spikiness), optional dike cut-outs, constrained point sets triangulated by
the native C++ engine (``mswe_gnn_tpu_torch/native.py``), and a coarsening
hierarchy built by re-triangulating with larger target edge lengths.

Two differences from the JAX module, neither in the meshes it gives:

- the native engine is required: when it cannot be built the port raises
  instead of meshing with Qhull (``engine="qhull"`` still asks for Qhull,
  and so does a constrained triangulation that gives up, as in JAX);
- the distance from each interior point to the boundary samples is a
  chunked numpy search (``data/meshing.py::nearest_center``) instead of
  scipy's KD-tree. scipy is imported only for Qhull.

The dual graph (cell adjacency) produced here feeds the same ``Mesh``
container as the grid generator.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from mswe_gnn_tpu_torch import native
from mswe_gnn_tpu_torch.data.meshing import Mesh, _derive_edge_attrs, nearest_center, reorder_mesh


def _cross2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """z-component of the cross product of 2D vectors."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def generate_polygon(rng: np.random.Generator, center=(0.0, 0.0),
                     avg_radius: float = 1000.0, irregularity: float = 0.35,
                     spikiness: float = 0.2, num_vertices: int = 16,
                     ellipticality: float = 1.0) -> np.ndarray:
    """Random irregular polygon (reference database/graph_creation.py:148-197).

    ``irregularity`` jitters the angular spacing of vertices; ``spikiness``
    jitters their radius; ``ellipticality`` is the major/minor axis ratio
    (x stretched, reference graph_creation.py:190 — its domain factory
    samples it in [1, 2) and divides avg_radius by it, :320-321).
    """
    irregularity = np.clip(irregularity, 0, 1) * 2 * np.pi / num_vertices
    spikiness = np.clip(spikiness, 0, 1) * avg_radius

    steps = rng.uniform(2 * np.pi / num_vertices - irregularity,
                        2 * np.pi / num_vertices + irregularity, num_vertices)
    steps = steps / steps.sum() * 2 * np.pi
    angles = np.cumsum(steps) + rng.uniform(0, 2 * np.pi)
    radii = np.clip(rng.normal(avg_radius, spikiness, num_vertices),
                    0.3 * avg_radius, 1.7 * avg_radius)
    return np.stack([center[0] + radii * np.cos(angles) * ellipticality,
                     center[1] + radii * np.sin(angles)], axis=1)


def equidistant_perimeter(polygon: np.ndarray, spacing: float) -> np.ndarray:
    """Resample a polygon boundary at ~equal arc-length spacing
    (reference database/graph_creation.py:235-247)."""
    pts = []
    n = len(polygon)
    for i in range(n):
        a, b = polygon[i], polygon[(i + 1) % n]
        seg = np.linalg.norm(b - a)
        k = max(int(np.ceil(seg / spacing)), 1)
        for t in range(k):
            pts.append(a + (b - a) * t / k)
    return np.asarray(pts)


def point_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon test."""
    x, y = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), dtype=bool)
    n = len(polygon)
    j = n - 1
    for i in range(n):
        xi, yi = polygon[i]
        xj, yj = polygon[j]
        cross = (yi > y) != (yj > y)
        slope_x = (xj - xi) * (y - yi) / np.where(yj != yi, yj - yi, 1e-30) + xi
        inside ^= cross & (x < slope_x)
        j = i
    return inside


def triangulate_polygon(polygon: np.ndarray, target_edge: float,
                        dem_fn: Callable, rng: Optional[np.random.Generator] = None,
                        jitter: float = 0.25, engine: str = "auto",
                        smooth_iters: int = 2) -> Mesh:
    """Triangulate the interior of a polygon at a target edge length.

    Interior points on a jittered hex-like lattice + equidistant boundary
    points; triangulated by the native C++ constrained Delaunay engine
    (native/delaunay.cpp — the MeshKernel/Triangle replacement, reference
    graph_creation.py:456-528) with the polygon boundary as hard segments,
    followed by ``smooth_iters`` rounds of fixed-boundary Laplacian smoothing
    (the orthogonalization pass) and re-triangulation. Unconstrained
    scipy/Qhull Delaunay runs where the engine gives up on the points, or
    where ``engine='qhull'`` asks for it. The coarsening hierarchy
    (reference create_mesh_dhydro refinement, graph_creation.py:473-528) is
    built by calling this with doubled ``target_edge`` per level.
    """
    rng = rng or np.random.default_rng(0)
    lo = polygon.min(0) - target_edge
    hi = polygon.max(0) + target_edge
    xs = np.arange(lo[0], hi[0], target_edge)
    ys = np.arange(lo[1], hi[1], target_edge * np.sqrt(3) / 2)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gx[:, 1::2] += target_edge / 2  # hex offset
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    pts = pts + rng.uniform(-jitter, jitter, pts.shape) * target_edge
    inner = pts[point_in_polygon(pts, polygon)]
    boundary = equidistant_perimeter(polygon, target_edge)

    cells = None
    allpts = None
    if engine != "qhull":
        # interior points hugging the boundary make slivers; the native path
        # drops them (the boundary samples carry that resolution)
        d = np.linalg.norm(inner - boundary[nearest_center(inner, boundary)], axis=1)
        allpts = np.concatenate([boundary, inner[d > 0.35 * target_edge]], 0)
        nb = len(boundary)
        segs = np.stack([np.arange(nb), (np.arange(nb) + 1) % nb], 1)
        cells = native.cdt_triangulate(allpts, segs)
        if cells is not None and smooth_iters > 0:
            fixed = np.zeros(len(allpts), np.uint8)
            fixed[:nb] = 1
            allpts = native.laplacian_smooth(allpts, cells, fixed, iters=smooth_iters)
            cells = native.cdt_triangulate(allpts, segs)

    if cells is None:  # Qhull fallback (or engine='qhull')
        from scipy.spatial import Delaunay

        allpts = np.concatenate([boundary, inner], 0)
        cells = Delaunay(allpts).simplices

    centroids = allpts[cells].mean(1)
    cells = cells[point_in_polygon(centroids, polygon)]

    # degenerate-triangle cleanup (near-zero area)
    v = allpts[cells]
    area2 = np.abs(_cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    cells = cells[area2 > 1e-6 * target_edge ** 2]

    return mesh_from_triangulation(allpts, cells, dem_fn)


def mesh_from_triangulation(points: np.ndarray, cells: np.ndarray,
                            dem_fn: Callable) -> Mesh:
    """Dual (cell-adjacency) graph of a triangulation -> ``Mesh``.

    The adjacency comes from the native C++ core (native/meshcore.cpp)."""
    v = points[cells]
    face_xy = v.mean(1)
    area = 0.5 * np.abs(_cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    dem = dem_fn(face_xy[:, 0], face_xy[:, 1]).astype(np.float64)
    edge_index, walls, boundary = native.dual_graph_from_triangles(cells)
    shared = np.linalg.norm(points[walls[:, 0]] - points[walls[:, 1]], axis=1)
    dist, rel, slope = _derive_edge_attrs(face_xy, dem, edge_index)
    return Mesh(face_xy=face_xy, area=area, dem=dem,
                dual_edge_index=edge_index, face_distance=dist,
                face_relative_distance=rel, edge_slope=slope,
                shared_length=shared, boundary_faces=np.where(boundary)[0])


def polygon_is_simple(polygon: np.ndarray) -> bool:
    """True when no two non-adjacent polygon edges properly cross.

    O(n^2) offline check. A self-intersecting boundary makes the constrained
    triangulation impossible (two hard segments cannot cross) and its
    interior ill-defined; generators must reject such polygons."""
    n = len(polygon)
    b = polygon

    def orient(p, q, r):
        return np.sign((q[0] - p[0]) * (r[1] - p[1])
                       - (q[1] - p[1]) * (r[0] - p[0]))

    for i in range(n):
        p, q = b[i], b[(i + 1) % n]
        for j in range(i + 2, n):
            if i == 0 and j == n - 1:
                continue
            r, s = b[j], b[(j + 1) % n]
            if (orient(p, q, r) * orient(p, q, s) < 0
                    and orient(r, s, p) * orient(r, s, q) < 0):
                return False
    return True


def create_dike(polygon: np.ndarray, rng: np.random.Generator,
                width_frac: float = 0.08, max_tries: int = 12) -> np.ndarray:
    """Cut a dike (narrow notch) into one polygon edge
    (reference database/graph_creation.py:257-344).

    On a spiky polygon the inward notch can poke through the opposite side
    and make the boundary self-intersecting (which a constrained
    triangulation must reject); retry on other edges with a shrinking notch
    until the result is simple, else return the polygon un-notched."""
    frac = width_frac
    for attempt in range(max_tries):
        n = len(polygon)
        i = int(rng.integers(0, n))
        a, b = polygon[i], polygon[(i + 1) % n]
        mid = (a + b) / 2
        d = b - a
        w = d * frac
        inward = np.asarray([-d[1], d[0]])
        inward = inward / np.linalg.norm(inward) * np.linalg.norm(d) * frac * 2
        centroid = polygon.mean(0)
        if np.dot(inward, centroid - mid) < 0:
            inward = -inward
        notch = [mid - w / 2, mid - w / 2 + inward, mid + w / 2 + inward,
                 mid + w / 2]
        out = np.concatenate([polygon[: i + 1], np.asarray(notch),
                              polygon[i + 1:]], 0)
        if polygon_is_simple(out):
            return out
        frac *= 0.7
    return polygon


def triangulated_hierarchy(rng: np.random.Generator, dem_fn: Callable,
                           num_scales: int = 3, avg_radius: float = 1600.0,
                           target_edge: float = 100.0, with_dike: bool = False,
                           ellipticality: tuple = (1.0, 2.0)) -> List[Mesh]:
    """Random-polygon multiscale triangulated hierarchy (finest first).

    ``ellipticality`` is sampled uniformly per domain and the radius divided
    by it, matching the reference's domain factory
    (database/graph_creation.py:320-321, dhydro_utils.py:305)."""
    ell = float(rng.uniform(*ellipticality))
    poly = generate_polygon(rng, avg_radius=avg_radius / ell,
                            ellipticality=ell)
    if with_dike:
        poly = create_dike(poly, rng)
    # RCM-reorder each scale: CDT output order is insertion order (no band
    # structure); RCM gives the O(sqrt(N)) band profile the banded hop plans
    # against and improves the locality of the hop's gathers
    return [reorder_mesh(triangulate_polygon(poly, target_edge * (2 ** s),
                                             dem_fn, rng))
            for s in range(num_scales)]
