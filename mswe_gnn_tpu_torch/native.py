"""The port's loader of the native mesh core (``native/meshcore.cpp`` and
``native/delaunay.cpp``, the constrained Delaunay engine), bound with
``ctypes``: the three entry points that ``data/triangulate.py`` needs, the
BFS node partitioner of the ring-halo path (``bfs_partition``, with its
numpy version ``bfs_partition_reference``), the ELL slot table that
``graph.build_edge_slot_table`` takes where its width is not fixed
(``build_ell_table``; the Python loop there is its plain version) and the
midpoint refinement ``refine_midpoint``.

The library is compiled with ``g++`` at first use, with ``native/Makefile``'s
own flags, into ``_build/`` beside the package (listed in ``.gitignore``),
through the kernels' build code (``ops/build.py``): the file name carries a
hash of the sources and the flags, so a changed source is rebuilt.
``native/libmeshcore.so`` is never written and ``make`` is never run.

There is no fallback: when the compiler is missing, the build fails or the
library does not load, this raises with the compiler's message. (The JAX
package warns and meshes with Qhull instead, which gives other meshes than
its records; an explicit ``engine="qhull"`` in ``data/triangulate.py``
stays available.) Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .ops.build import compile_libraries, keyed_path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("meshcore.cpp", "delaunay.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS and link line, so that the meshes are the bits of
# the JAX package's library built on the same machine
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return keyed_path("meshcore", [NATIVE_DIR / name for name in SOURCES], CXX_FLAGS,
                      BUILD_DIR)


def _gxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the mesh core of native/ is "
                           "compiled at first use, and the port has no fallback")
    return cxx


def build() -> Path:
    """Compile the mesh core unless it is built already -> the library's
    path. Raises with the compiler's output when the build fails."""
    job = (_gxx, CXX_FLAGS, [NATIVE_DIR / name for name in SOURCES], library_path())
    return Path(compile_libraries({"meshcore": job}, BUILD_DIR, "mesh core")
                ["meshcore"]["path"])


def _bind(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.dual_graph_from_triangles.restype = ctypes.c_int64
    lib.dual_graph_from_triangles.argtypes = [
        i64p, ctypes.c_int64, i64p, i64p, i64p, i64p, u8p]
    lib.cdt_triangulate.restype = ctypes.c_int64
    lib.cdt_triangulate.argtypes = [
        f64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.laplacian_smooth.restype = None
    lib.laplacian_smooth.argtypes = [
        f64p, ctypes.c_int64, i64p, ctypes.c_int64, u8p, ctypes.c_int64]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.bfs_partition.restype = None
    lib.bfs_partition.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i32p]
    lib.build_ell_table.restype = ctypes.c_int64
    lib.build_ell_table.argtypes = [
        i64p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.refine_midpoint.restype = ctypes.c_int64
    lib.refine_midpoint.argtypes = [
        f64p, ctypes.c_int64, i64p, ctypes.c_int64, f64p, i64p, i64p]


def _check_index(idx: np.ndarray, n: int, width: int, what: str) -> None:
    """Validates an index array before its pointer goes to native code."""
    if idx.ndim != 2 or idx.shape[1] != width:
        raise ValueError(f"{what}: expected [m, {width}], got {list(idx.shape)}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"{what}: an index lies outside 0..{n - 1}")


def load() -> ctypes.CDLL:
    """The mesh core, built first if it is not (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def dual_graph_from_triangles(cells: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triangle soup [F, 3] -> (edge_index [2, E], the shared wall's vertex
    pair of every directed edge [E, 2], boundary-face flags [F])."""
    lib = load()
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    _check_index(cells, 2 ** 32, 3, "cells")
    n = len(cells)
    cap = 6 * max(n, 1)
    src, dst = np.empty(cap, np.int64), np.empty(cap, np.int64)
    wa, wb = np.empty(cap, np.int64), np.empty(cap, np.int64)
    bnd = np.zeros(max(n, 1), np.uint8)
    e = lib.dual_graph_from_triangles(cells, n, src, dst, wa, wb, bnd)
    return (np.stack([src[:e], dst[:e]]), np.stack([wa[:e], wb[:e]], 1),
            bnd[:n].astype(bool))


def cdt_triangulate(points: np.ndarray, segments: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
    """Constrained Delaunay triangulation of ``points`` [n, 2] with the hard
    ``segments`` [m, 2] -> CCW triangles [n_tris, 3], or None when the
    engine gives up on these points (the caller then meshes with Qhull, as
    the JAX package does)."""
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    segs = (np.ascontiguousarray(segments, dtype=np.int64)
            if segments is not None and len(segments) else np.empty((0, 2), np.int64))
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points: expected [n, 2], got {list(pts.shape)}")
    _check_index(segs, n, 2, "segments")
    cap = 4 * max(n, 4)
    tris = np.empty((cap, 3), np.int64)
    m = lib.cdt_triangulate(pts, n, segs.reshape(-1), len(segs), tris.reshape(-1), cap)
    if m < 0:
        warnings.warn(f"cdt_triangulate failed (code {m}); using Qhull fallback")
        return None
    return tris[:m].copy()


def laplacian_smooth(points: np.ndarray, triangles: np.ndarray, fixed: np.ndarray,
                     iters: int = 3) -> np.ndarray:
    """Fixed-boundary Laplacian smoothing: each free vertex moves to the
    mean of its mesh neighbours, ``iters`` times -> the smoothed points."""
    lib = load()
    pts = np.array(points, dtype=np.float64, order="C")
    tris = np.ascontiguousarray(triangles, dtype=np.int64)
    fx = np.ascontiguousarray(fixed, dtype=np.uint8)
    _check_index(tris, len(pts), 3, "triangles")
    if fx.shape != (len(pts),):
        raise ValueError("fixed: expected one flag a point")
    lib.laplacian_smooth(pts, len(pts), tris.reshape(-1), len(tris), fx, int(iters))
    return pts


def _edges(edge_index: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    ei = np.asarray(edge_index)
    _check_index(np.ascontiguousarray(ei.T, dtype=np.int64), max(num_nodes, 1), 2,
                 "edge_index")
    return (np.ascontiguousarray(ei[0], dtype=np.int64),
            np.ascontiguousarray(ei[1], dtype=np.int64))


def bfs_partition(edge_index: np.ndarray, num_nodes: int, n_parts: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Locality-preserving node partition (JAX native.py:126-157, the
    library's ``bfs_partition``): every node's BFS position over the directed
    edges ``edge_index [2, E]`` (neighbours in edge order, a new search from
    each unvisited node in id order) -> ``(owner, order)`` int32, ``order``
    the new id of every node and ``owner`` its block of ``ceil(num_nodes /
    n_parts)`` consecutive new ids. Contiguous blocks of this order are the
    ring partitions of ``parallel/``."""
    lib = load()
    src, dst = _edges(edge_index, num_nodes)
    owner = np.empty(num_nodes, np.int32)
    order = np.empty(num_nodes, np.int32)
    lib.bfs_partition(src, dst, len(src), num_nodes, n_parts, owner, order)
    return owner, order


def bfs_partition_reference(edge_index: np.ndarray, num_nodes: int, n_parts: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of ``bfs_partition``: the JAX package's fallback
    where its library is missing (the port's ``bfs_partition`` has none)."""
    from collections import deque

    src, dst = _edges(edge_index, num_nodes)
    adj = [[] for _ in range(num_nodes)]
    for s, d in zip(src.tolist(), dst.tolist()):
        adj[s].append(d)
    order = np.full(num_nodes, -1, np.int32)
    nxt = 0
    for seed in range(num_nodes):
        if order[seed] != -1:
            continue
        order[seed] = nxt
        nxt += 1
        q = deque([seed])
        while q:
            for v in adj[q.popleft()]:
                if order[v] == -1:
                    order[v] = nxt
                    nxt += 1
                    q.append(v)
    block = -(-num_nodes // n_parts)
    return (order // block).astype(np.int32), order


def build_ell_table(dst: np.ndarray, edge_mask: np.ndarray, num_nodes: int,
                    round_to: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """The ELL slot table of the edges' destinations ``dst [E]`` (JAX
    native.py:107-123): for each node its real incoming edges (``edge_mask``
    > 0) in edge order, padded to the largest in-degree rounded up to
    ``round_to`` (at least ``round_to``) -> ``(table [N, D] int32, mask [N, D]
    float32)``. Two calls into the library: the first counts the widest
    row, the second fills the table."""
    lib = load()
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    mask = np.ascontiguousarray(edge_mask, dtype=np.float32)
    if mask.shape != dst.shape or dst.ndim != 1:
        raise ValueError(f"dst and edge_mask: expected [E] each, got {list(dst.shape)} and "
                         f"{list(mask.shape)}")
    _check_index(dst[:, None], max(num_nodes, 1), 1, "dst")
    max_deg = lib.build_ell_table(dst, mask, len(dst), num_nodes, 0, None, None)
    d = max(-(-max(int(max_deg), 1) // round_to) * round_to, round_to)
    table = np.zeros((num_nodes, d), np.int32)
    out_mask = np.zeros((num_nodes, d), np.float32)
    if lib.build_ell_table(dst, mask, len(dst), num_nodes, d, table.ctypes.data,
                           out_mask.ctypes.data) < 0:
        raise RuntimeError("build_ell_table: a row holds more edges than the first call "
                           "counted")
    return table, out_mask


def refine_midpoint(points: np.ndarray, triangles: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Red (4-way) midpoint refinement with deduplicated edge midpoints (JAX
    native.py:212-226, the library's path) -> ``(points [n + m, 2], triangles
    [4 n_tris, 3])``, ``m`` the number of distinct edges."""
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    tris = np.ascontiguousarray(triangles, dtype=np.int64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points: expected [n, 2], got {list(pts.shape)}")
    _check_index(tris, len(pts), 3, "triangles")
    n, nt = len(pts), len(tris)
    pts_out = np.empty((n + 3 * nt, 2), np.float64)
    tris_out = np.empty((4 * nt, 3), np.int64)
    n_out = np.zeros(1, np.int64)
    m = lib.refine_midpoint(pts, n, tris.reshape(-1), nt, pts_out, tris_out.reshape(-1), n_out)
    return pts_out[:int(n_out[0])].copy(), tris_out[:m].copy()
