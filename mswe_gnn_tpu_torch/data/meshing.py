"""Host-side mesh construction: dual graphs, multiscale stacking, ghost cells.

A copy of the parts of mswe_gnn_tpu/data/meshing.py that the port's grid
and triangulated paths use, RCM reordering included (the port does not
import the JAX package). The GNN graph is the
*dual* graph of the mesh: nodes = cells/faces, edges = shared cell walls. A
``MultiscaleMesh`` stacks L meshes finest-first with global node numbering
and transfer edges (coarse idx, fine idx) built by cell containment.

One change: transfer edges find the nearest coarse centre by a chunked numpy
search instead of scipy's KD-tree, so the port needs numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# edge types (reference database/graph_creation.py edge-type convention)
EDGE_NORMAL = 1
EDGE_BC = 2
EDGE_BOUNDARY = 3
EDGE_GHOST = 4


@dataclasses.dataclass
class Mesh:
    """One single-scale mesh (dual-graph view).

    - ``face_xy [F, 2]`` cell-center coordinates
    - ``area [F]`` cell areas
    - ``dem [F]`` terrain elevation at cell centers
    - ``dual_edge_index [2, E]`` directed cell-adjacency edges (both
      directions present for interior walls)
    - ``face_distance [E]`` center-to-center distance
    - ``face_relative_distance [E, 2]`` center offset vector (dst - src)
    - ``edge_slope [E]`` (dem_src - dem_dst) / distance
    - ``shared_length [E]`` length of the shared wall (used for BC edges)
    """
    face_xy: np.ndarray
    area: np.ndarray
    dem: np.ndarray
    dual_edge_index: np.ndarray
    face_distance: np.ndarray
    face_relative_distance: np.ndarray
    edge_slope: np.ndarray
    shared_length: np.ndarray
    boundary_faces: np.ndarray  # indices of cells on the domain boundary

    @property
    def num_faces(self) -> int:
        return self.face_xy.shape[0]

    @property
    def num_edges(self) -> int:
        return self.dual_edge_index.shape[1]


def _derive_edge_attrs(face_xy, dem, edge_index):
    rel = face_xy[edge_index[1]] - face_xy[edge_index[0]]
    dist = np.linalg.norm(rel, axis=1)
    dist = np.maximum(dist, 1e-12)
    slope = (dem[edge_index[0]] - dem[edge_index[1]]) / dist
    return dist, rel, slope


def grid_mesh(nx: int, ny: int, dx: float, dem_fn, origin=(0.0, 0.0)) -> Mesh:
    """Regular quad-cell mesh on [0, nx*dx] x [0, ny*dx].

    ``dem_fn(x, y)`` evaluates terrain elevation at cell centers, so the same
    field stays consistent across refinement levels of a hierarchy.
    """
    xs = origin[0] + (np.arange(nx) + 0.5) * dx
    ys = origin[1] + (np.arange(ny) + 0.5) * dx
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    face_xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
    F = nx * ny
    area = np.full(F, dx * dx)
    dem = dem_fn(face_xy[:, 0], face_xy[:, 1]).astype(np.float64)

    def fid(i, j):
        return i * ny + j

    srcs, dsts = [], []
    for i in range(nx):
        for j in range(ny):
            if i + 1 < nx:
                srcs += [fid(i, j), fid(i + 1, j)]
                dsts += [fid(i + 1, j), fid(i, j)]
            if j + 1 < ny:
                srcs += [fid(i, j), fid(i, j + 1)]
                dsts += [fid(i, j + 1), fid(i, j)]
    edge_index = np.asarray([srcs, dsts], dtype=np.int64)
    dist, rel, slope = _derive_edge_attrs(face_xy, dem, edge_index)
    shared = np.full(edge_index.shape[1], dx)

    ii = np.arange(nx)[:, None].repeat(ny, 1)
    jj = np.arange(ny)[None, :].repeat(nx, 0)
    on_boundary = (ii == 0) | (ii == nx - 1) | (jj == 0) | (jj == ny - 1)
    boundary_faces = np.where(on_boundary.ravel())[0]

    return Mesh(face_xy=face_xy, area=area, dem=dem, dual_edge_index=edge_index,
                face_distance=dist, face_relative_distance=rel, edge_slope=slope,
                shared_length=shared, boundary_faces=boundary_faces)


def rcm_permutation(num_faces: int, edge_index: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the dual graph -> ``order`` such that
    ``order[new_id] = old_id``.

    Planar flood meshes reordered this way get an O(sqrt(N)) band profile,
    which (a) makes the banded hop applicable (ops/band_hop.py plans
    per-tile windows over consecutive node ranges) and (b) improves the
    locality of the hop's row gathers. Pure numpy BFS with degree-ascending
    tie-breaking (the classic CM heuristic), reversed.
    """
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    order_by_dst = np.argsort(dst, kind="stable")
    dst_sorted = dst[order_by_dst]
    nbr = src[order_by_dst]
    starts = np.searchsorted(dst_sorted, np.arange(num_faces + 1))
    degree = np.diff(starts)

    visited = np.zeros(num_faces, dtype=bool)
    order = np.empty(num_faces, dtype=np.int64)
    pos = 0
    for comp_start in np.argsort(degree, kind="stable"):
        if visited[comp_start]:
            continue
        visited[comp_start] = True
        order[pos] = comp_start
        head = pos
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            cand = nbr[starts[u]:starts[u + 1]]
            cand = cand[~visited[cand]]
            if cand.size:
                cand = np.unique(cand)                 # dedups, keeps ids sorted
                cand = cand[np.argsort(degree[cand], kind="stable")]
                visited[cand] = True
                order[pos:pos + cand.size] = cand
                pos += cand.size
    assert pos == num_faces
    return order[::-1].copy()                          # the "reverse" in RCM


def reorder_mesh(mesh: Mesh, order: Optional[np.ndarray] = None) -> Mesh:
    """Permute a mesh's faces (default: RCM) and re-sort edges by destination.

    ``order[new_id] = old_id``. Edge attributes are carried through the
    permutation (values are per directed edge and direction is preserved);
    edges are re-sorted (dst, src) to keep the destination-sorted invariant
    the dataset layer relies on.
    """
    if order is None:
        order = rcm_permutation(mesh.num_faces, mesh.dual_edge_index)
    inv = np.empty_like(order)
    inv[order] = np.arange(mesh.num_faces)
    ei = inv[mesh.dual_edge_index]
    esort = np.lexsort((ei[0], ei[1]))                 # by dst, then src
    return Mesh(
        face_xy=mesh.face_xy[order],
        area=mesh.area[order],
        dem=mesh.dem[order],
        dual_edge_index=ei[:, esort],
        face_distance=mesh.face_distance[esort],
        face_relative_distance=mesh.face_relative_distance[esort],
        edge_slope=mesh.edge_slope[esort],
        shared_length=mesh.shared_length[esort],
        boundary_faces=np.sort(inv[mesh.boundary_faces]),
    )


@dataclasses.dataclass
class GhostCells:
    """Ghost-cell boundary machinery (reference graph_creation.py:1340-1412).

    Ghost nodes mirror the BC-adjacent cells outside the domain; directed
    ghost -> interior edges inject the inflow condition.
    """
    ghost_nodes: np.ndarray      # node ids of ghost cells (in the augmented mesh)
    bc_faces: np.ndarray         # interior faces each ghost mirrors
    edge_bc_length: np.ndarray   # shared wall length per ghost (L_bc)
    type_bc: int                 # 1 = water depth, 2 = unit discharge


def add_ghost_cells(mesh: Mesh, bc_faces: np.ndarray, type_bc: int = 2) -> Tuple[Mesh, GhostCells]:
    """Append ghost cells mirroring ``bc_faces`` and directed ghost->face edges."""
    F = mesh.num_faces
    n = len(bc_faces)
    centers = mesh.face_xy[bc_faces]
    # mirror outward: away from the domain centroid
    centroid = mesh.face_xy.mean(0)
    dirs = centers - centroid
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-9)
    spacing = np.sqrt(mesh.area[bc_faces])
    ghost_xy = centers + dirs * spacing[:, None]

    face_xy = np.concatenate([mesh.face_xy, ghost_xy], axis=0)
    area = np.concatenate([mesh.area, mesh.area[bc_faces]])
    dem = np.concatenate([mesh.dem, mesh.dem[bc_faces]])

    ghost_ids = F + np.arange(n)
    ghost_edges = np.stack([ghost_ids, bc_faces.astype(np.int64)])  # directed
    edge_index = np.concatenate([mesh.dual_edge_index, ghost_edges], axis=1)
    dist, rel, slope = _derive_edge_attrs(face_xy, dem, edge_index)
    shared = np.concatenate([mesh.shared_length, spacing])

    aug = Mesh(face_xy=face_xy, area=area, dem=dem, dual_edge_index=edge_index,
               face_distance=dist, face_relative_distance=rel, edge_slope=slope,
               shared_length=shared, boundary_faces=mesh.boundary_faces)
    ghosts = GhostCells(ghost_nodes=ghost_ids, bc_faces=np.asarray(bc_faces),
                        edge_bc_length=spacing, type_bc=type_bc)
    return aug, ghosts


@dataclasses.dataclass
class MultiscaleMesh:
    """Stack of L meshes, finest first, with transfer edges
    (reference database/graph_creation.py:860-982).

    Global node numbering: scale-0 nodes, then scale-1, ... Edge blocks are
    per-scale contiguous; transfer (intra) edges are rows (coarse, fine).
    """
    meshes: List[Mesh]
    node_ptr: np.ndarray          # [L+1]
    edge_ptr: np.ndarray          # [L+1]
    intra_edge_ptr: np.ndarray    # [L]
    intra_edge_index: np.ndarray  # [2, EI] rows (coarse, fine), global ids
    ghosts: Optional[GhostCells] = None  # finest-scale ghosts, global ids

    @property
    def num_scales(self) -> int:
        return len(self.meshes)

    @property
    def num_nodes(self) -> int:
        return int(self.node_ptr[-1])

    def concat_nodes(self, attr: str) -> np.ndarray:
        return np.concatenate([getattr(m, attr) for m in self.meshes], axis=0)

    def concat_edges(self, attr: str) -> np.ndarray:
        return np.concatenate([getattr(m, attr) for m in self.meshes], axis=0)

    @property
    def edge_index(self) -> np.ndarray:
        """Global dual edges, scale-major."""
        blocks = [m.dual_edge_index + self.node_ptr[s]
                  for s, m in enumerate(self.meshes)]
        return np.concatenate(blocks, axis=1)


def nearest_center(points: np.ndarray, centers: np.ndarray,
                   chunk: int = 512) -> np.ndarray:
    """Index of the nearest of ``centers`` for every point (Euclidean; the
    lowest index wins a tie), searched in chunks of ``chunk`` points."""
    owner = np.empty(len(points), dtype=np.int64)
    for lo in range(0, len(points), chunk):
        diff = points[lo:lo + chunk, None, :] - centers[None, :, :]
        owner[lo:lo + chunk] = np.argmin((diff ** 2).sum(axis=2), axis=1)
    return owner


def containment_transfer_edges(fine: Mesh, coarse: Mesh) -> np.ndarray:
    """Transfer edges (coarse, fine) by nearest-coarse-center containment.

    The reference uses point-in-polygon of fine-face centers in coarse faces
    (database/graph_creation.py:422-436, 912-931); for the convex cells used
    here nearest-center assignment is equivalent.
    """
    owner = nearest_center(fine.face_xy, coarse.face_xy)
    return np.stack([owner, np.arange(fine.num_faces, dtype=np.int64)])


def stack_meshes(meshes: List[Mesh], ghosts: Optional[GhostCells] = None) -> MultiscaleMesh:
    """Build a MultiscaleMesh from per-scale meshes (finest first).

    ``ghosts`` are finest-scale ghost info (node ids already local to the
    finest mesh, which occupies the first block of the global numbering).
    """
    L = len(meshes)
    node_counts = [m.num_faces for m in meshes]
    edge_counts = [m.num_edges for m in meshes]
    node_ptr = np.cumsum([0, *node_counts])
    edge_ptr = np.cumsum([0, *edge_counts])

    intra_blocks = []
    for s in range(L - 1):
        te = containment_transfer_edges(meshes[s], meshes[s + 1])
        te_global = np.stack([te[0] + node_ptr[s + 1], te[1] + node_ptr[s]])
        intra_blocks.append(te_global)
    if intra_blocks:
        intra_edge_index = np.concatenate(intra_blocks, axis=1)
        intra_edge_ptr = np.cumsum([0, *[b.shape[1] for b in intra_blocks]])
    else:
        intra_edge_index = np.zeros((2, 0), dtype=np.int64)
        intra_edge_ptr = np.asarray([0])

    return MultiscaleMesh(meshes=meshes, node_ptr=node_ptr, edge_ptr=edge_ptr,
                          intra_edge_ptr=intra_edge_ptr,
                          intra_edge_index=intra_edge_index, ghosts=ghosts)
