"""The port's timing and tracing helpers (utils/profiling.py), its build cache
(cache.py) and the mesh core's ELL table and midpoint refinement (native.py)
against the JAX package's, on the CPU.

The native comparisons need the JAX package's own library where they read
it (``native.available()``, as tests/test_native.py); the port builds its
own mesh core with ``g++`` and has no fallback."""
import glob
import json
import time

import numpy as np
import pytest
import torch

from mswe_gnn_tpu import native as jax_native
from mswe_gnn_tpu.graph import build_edge_slot_table as jax_slot_table
from mswe_gnn_tpu_torch import cache, native
from mswe_gnn_tpu_torch.graph import build_edge_slot_table, edge_slot_table_reference
from mswe_gnn_tpu_torch.ops import build as kernel_build
from mswe_gnn_tpu_torch.utils import profiling

needs_jax_native = pytest.mark.skipif(not jax_native.available(),
                                      reason="the JAX package's mesh core is not built")


# ---------------------------------------------------------------- profiling

def test_timed_on_the_cpu():
    """``timed`` gives JAX's keys; a CPU result is timed by the host clock
    (a call that sleeps 10 ms takes at least that), warm-up calls are not
    timed and a tree of tensors is a result."""
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.01)
        return {"y": x * 2, "z": [x + 1]}

    out = profiling.timed(fn, torch.ones(3), reps=3, warmup=2)
    assert set(out) == {"median_s", "min_s", "mean_s"}
    assert len(calls) == 5
    assert 0.01 <= out["min_s"] <= out["median_s"] and out["min_s"] <= out["mean_s"]


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` under torch's CPU profiler writes a Chrome trace holding
    the body's operations."""
    with profiling.trace(str(tmp_path / "tr")) as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert glob.glob(str(tmp_path / "tr" / "*.json")) == [path]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_raises_where_it_cannot_write(tmp_path):
    """A deliberate difference from JAX, which swallows its tracer's
    failures: a trace that cannot be written raises."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        with profiling.trace(str(blocker / "tr")):
            torch.ones(2).sum()


# ---------------------------------------------------------------- the build cache

@pytest.mark.parametrize("how", ["argument", "environment", "default"])
def test_enable_compilation_cache_moves_both_builds(tmp_path, monkeypatch, how):
    """The argument, else ``MSWE_TORCH_CACHE``, else ``_build/`` beside the
    package, becomes the directory of the kernels' and the mesh core's
    libraries; the mesh core is then built there by ``g++`` and loads."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv(cache.ENV, raising=False)
    if how == "argument":
        monkeypatch.setenv(cache.ENV, str(tmp_path / "not_this"))
        want = cache.enable_compilation_cache(str(tmp_path / "arg"))
        assert want == (tmp_path / "arg").resolve()
    elif how == "environment":
        monkeypatch.setenv(cache.ENV, str(tmp_path / "env"))
        want = cache.enable_compilation_cache()
        assert want == (tmp_path / "env").resolve()
    else:
        want = cache.enable_compilation_cache()
        assert want == cache.DEFAULT_DIR
    assert kernel_build.library_path("hop").parent == want
    assert native.library_path().parent == want
    native.load()
    assert native.library_path().exists()
    table, mask = native.build_ell_table(np.array([1, 0, 1]), np.ones(3), 2)
    np.testing.assert_array_equal(table[:, 0], [1, 0])


# ---------------------------------------------------------------- the native ELL table

def grid_edges(n):
    """Both directions of every wall of an ``n`` x ``n`` grid, with padded
    edges (mask 0, pointing at node 0) at the end."""
    idx = np.arange(n * n).reshape(n, n)
    a = np.concatenate([idx[:, :-1].ravel(), idx[:-1].ravel()])
    b = np.concatenate([idx[:, 1:].ravel(), idx[1:].ravel()])
    ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    mask = np.ones(ei.shape[1], np.float32)
    pad = 6
    ei = np.concatenate([ei, np.zeros((2, pad), ei.dtype)], axis=1)
    return ei, np.concatenate([mask, np.zeros(pad, np.float32)]), n * n


def triangulated_edges(seed):
    """The dual graph of a random triangulation, a fifth of its edges
    masked as padding."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    tris = Delaunay(rng.random((80, 2))).simplices.astype(np.int64)
    ei, _, _ = native.dual_graph_from_triangles(tris)
    mask = (rng.random(ei.shape[1]) > 0.2).astype(np.float32)
    return ei, mask, len(tris)


@needs_jax_native
@pytest.mark.parametrize("graph", ["grid", "triangulated"])
@pytest.mark.parametrize("round_to", [1, 4, 8])
def test_native_ell_table_matches_jax_and_the_loop(graph, round_to):
    """The native table and mask equal JAX's native table and the port's
    Python loop (``edge_slot_table_reference``); ``build_edge_slot_table``
    takes the native one where the width is not fixed."""
    ei, mask, n = grid_edges(7) if graph == "grid" else triangulated_edges(3)
    table, out_mask = native.build_ell_table(ei[1], mask, n, round_to=round_to)
    assert table.dtype == np.int32 and out_mask.dtype == np.float32
    for t, m in (jax_native.build_ell_table(ei[1], mask, n, round_to=round_to),
                 edge_slot_table_reference(ei, mask, n, round_to=round_to),
                 build_edge_slot_table(ei, mask, n, round_to=round_to),
                 jax_slot_table(ei, mask, n, round_to=round_to)):
        np.testing.assert_array_equal(t, table)
        np.testing.assert_array_equal(m, out_mask)
    fixed = table.shape[1] + 4
    np.testing.assert_array_equal(build_edge_slot_table(ei, mask, n, d_fixed=fixed)[0],
                                  jax_slot_table(ei, mask, n, d_fixed=fixed)[0])


def test_native_ell_table_rejects_bad_destinations():
    with pytest.raises(ValueError, match="dst"):
        native.build_ell_table(np.array([0, 3]), np.ones(2), 3)
    with pytest.raises(ValueError, match="edge_mask"):
        native.build_ell_table(np.array([0, 1]), np.ones(3), 3)


@needs_jax_native
def test_refine_midpoint_matches_jax():
    """The refinement's points and triangles equal JAX's native ones."""
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(4).random((60, 2)) * 10
    tris = Delaunay(pts).simplices.astype(np.int64)
    got, want = native.refine_midpoint(pts, tris), jax_native.refine_midpoint(pts, tris)
    assert len(got[1]) == 4 * len(tris)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="triangles"):
        native.refine_midpoint(pts, tris + len(pts))
