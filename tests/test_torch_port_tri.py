"""Triangulated meshes in the port against the JAX package, and the trained
accuracy_tri weights through both.

- The port's mesh core loader (``mswe_gnn_tpu_torch/native.py``) builds
  ``native/`` with the Makefile's flags, so on one machine its three entry
  points give the bits of ``mswe_gnn_tpu.native``: compared exactly; a
  failed build raises.
- RCM reordering, triangulated records and their ``FloodGraph``s: exactly
  equal, field by field (both are the same numpy code on the same meshes).
- The trained weights (``results_repo/checkpoints/accuracy_tri_r5``, orbax,
  converted by ``tests/torch_port_convert.py``): the committed port
  checkpoint equals a fresh conversion bit for bit; ``apply_msgnn`` and a
  4-step rollout on a triangulated sample of ``configs/accuracy_tri.yaml``
  cut to nx=ny=16 agree with JAX within atol 1e-4 / rtol 1e-5 in float32
  (the matmuls and the hop's slot sum run in another order).
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import native as jax_native
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data import meshing as jax_meshing
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu.data.triangulate import triangulate_polygon as jax_triangulate
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.training.rollout import rollout as jax_rollout
from mswe_gnn_tpu_torch import native as port_native
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data import meshing as port_meshing
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate
from mswe_gnn_tpu_torch.data.triangulate import (equidistant_perimeter, generate_polygon,
                                                 point_in_polygon)
from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.training.checkpoint import restore_checkpoint
from mswe_gnn_tpu_torch.training.rollout import rollout as port_rollout
from tests.torch_port_common import GEN_KW, temporal_samples
from tests.torch_port_convert import ACCURACY_TRI, JAX_BEST, PORT_BEST, convert

ROOT = Path(__file__).resolve().parents[1]
TRI_KW = dict(GEN_KW, mesh_type="triangulated")


def polygon_points(seed):
    """A random polygon's boundary samples (the hard segments) and jittered
    interior points, as triangulate_polygon draws them."""
    rng = np.random.default_rng(seed)
    poly = generate_polygon(rng, avg_radius=500.0, ellipticality=1.3)
    boundary = equidistant_perimeter(poly, 100.0)
    inner = rng.uniform(poly.min(0), poly.max(0), (120, 2))
    inner = inner[point_in_polygon(inner, poly)]
    nb = len(boundary)
    segs = np.stack([np.arange(nb), (np.arange(nb) + 1) % nb], 1)
    return np.concatenate([boundary, inner], 0), segs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_entry_points_bit_equal(seed):
    """cdt_triangulate, laplacian_smooth and dual_graph_from_triangles:
    equal to the JAX package's library, exactly."""
    pts, segs = polygon_points(seed)
    tris = port_native.cdt_triangulate(pts, segs)
    np.testing.assert_array_equal(tris, jax_native.cdt_triangulate(pts, segs))
    fixed = np.zeros(len(pts), np.uint8)
    fixed[:len(segs)] = 1
    smooth = port_native.laplacian_smooth(pts, tris, fixed, iters=3)
    np.testing.assert_array_equal(smooth, jax_native.laplacian_smooth(pts, tris, fixed, 3))
    assert not np.array_equal(smooth, pts) and np.array_equal(smooth[fixed == 1],
                                                              pts[fixed == 1])
    for got, want in zip(port_native.dual_graph_from_triangles(tris),
                         jax_native.dual_graph_from_triangles(tris)):
        np.testing.assert_array_equal(got, want)


def test_native_rejects_bad_indices():
    pts, segs = polygon_points(0)
    with pytest.raises(ValueError, match="segments"):
        port_native.cdt_triangulate(pts, segs + len(pts))
    with pytest.raises(ValueError, match="triangles"):
        port_native.laplacian_smooth(pts, np.array([[0, 1, len(pts)]]),
                                     np.zeros(len(pts), np.uint8))


@pytest.mark.parametrize("fault", ["no compiler", "compile error"])
def test_mesh_core_build_failure_raises(tmp_path, monkeypatch, fault):
    """No fallback: when the mesh core cannot be built, triangulating raises
    with the reason (the JAX loader warns and meshes with Qhull)."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    if fault == "no compiler":
        monkeypatch.setattr(port_native.shutil, "which", lambda name: None)
        match = "no C\\+\\+ compiler"
    else:
        bad = tmp_path / "native"
        bad.mkdir()
        for name in port_native.SOURCES:
            (bad / name).write_text("this is not C++\n")
        monkeypatch.setattr(port_native, "NATIVE_DIR", bad)
        match = "mesh core build failed"
    with pytest.raises(RuntimeError, match=match):
        port_native.cdt_triangulate(*polygon_points(0))
    with pytest.raises(RuntimeError, match=match):
        port_generate(1, **dict(TRI_KW, nx=8, ny=8, total_hours=2, substeps=2))


def test_rcm_and_reorder_mesh_equal():
    """rcm_permutation and reorder_mesh on an unordered triangulated mesh."""
    poly = generate_polygon(np.random.default_rng(5), avg_radius=800.0)
    mesh = jax_triangulate(poly, 100.0, lambda x, y: 0.01 * x + np.sin(y / 300.0),
                           np.random.default_rng(6))
    order = port_meshing.rcm_permutation(mesh.num_faces, mesh.dual_edge_index)
    np.testing.assert_array_equal(
        order, jax_meshing.rcm_permutation(mesh.num_faces, mesh.dual_edge_index))
    assert not np.array_equal(order, np.arange(mesh.num_faces))
    got, want = port_meshing.reorder_mesh(mesh), jax_meshing.reorder_mesh(mesh)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)


@pytest.fixture(scope="module")
def tri_records():
    """Two triangulated records (seeds 0 and 1) at nx=ny=16 from each package."""
    return jax_generate(2, **TRI_KW), port_generate(2, **TRI_KW)


def test_tri_records_equal(tri_records):
    jax_recs, port_recs = tri_records
    for jr, pr in zip(jax_recs, port_recs):
        for name in ("wd", "vx", "vy", "bc_per_length"):
            np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name))
        for name in ("node_ptr", "edge_ptr", "intra_edge_ptr", "intra_edge_index"):
            np.testing.assert_array_equal(getattr(pr.mesh, name), getattr(jr.mesh, name))
        for jmesh, pmesh in zip(jr.mesh.meshes, pr.mesh.meshes):
            for f in dataclasses.fields(pmesh):
                np.testing.assert_array_equal(getattr(pmesh, f.name),
                                              getattr(jmesh, f.name), err_msg=f.name)
        for name in ("ghost_nodes", "bc_faces", "edge_bc_length"):
            np.testing.assert_array_equal(getattr(pr.mesh.ghosts, name),
                                          getattr(jr.mesh.ghosts, name))
    # triangles, not the grid's quads: more than 4 in-edges nowhere, walls vary
    fine = port_recs[0].mesh.meshes[0]
    assert np.bincount(fine.dual_edge_index[1]).max() <= 4
    assert np.ptp(fine.shared_length) > 0


@pytest.mark.parametrize("previous_t,rollout_steps", [(2, 4), (3, -1)])
def test_tri_flood_graphs_equal_field_by_field(tri_records, previous_t, rollout_steps):
    jax_recs, port_recs = tri_records
    jspec, jgraphs = temporal_samples(jax_dataset, jax_recs, previous_t, rollout_steps)
    pspec, pgraphs = temporal_samples(port_dataset, port_recs, previous_t, rollout_steps)
    assert dataclasses.astuple(pspec) == dataclasses.astuple(jspec)
    assert len(pgraphs) == len(jgraphs) > 0
    for jg, pg in zip(jgraphs, pgraphs):
        compared = 0
        for f in dataclasses.fields(FloodGraph):
            got = getattr(pg, f.name)
            if isinstance(got, torch.Tensor):
                want = np.asarray(getattr(jg, f.name))
                assert got.numpy().dtype == want.dtype, f.name
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
                compared += 1
        assert compared == 21


# ---------------------------------------------------------------- trained weights

@pytest.fixture(scope="module")
def trained():
    """The accuracy_tri_r5 weights, converted afresh, and a triangulated
    sample pair of configs/accuracy_tri.yaml's corpus cut to nx=ny=16 (two
    records, 12 hours; scalers fit on both, its padding, previous_t=3)."""
    jcfg, jtree, pcfg, pparams, meta = convert(str(ROOT / ACCURACY_TRI), str(ROOT / JAX_BEST))
    kw = dict(seed=0, nx=16, ny=16, num_scales=3, total_hours=12, substeps=20,
              temporal_res=120, peak_discharge=60.0, mesh_type="triangulated")

    def sample(ds, records):
        scalers = ds.fit_dataset_scalers(records, {"area_scaler": "standard",
                                                   "edge_length_scaler": "standard"})
        spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 64)
                              for r in records])
        return ds.to_temporal_samples(ds.process_record(records[1], scalers), spec,
                                      previous_t=3, rollout_steps=4)[0]

    jg = sample(jax_dataset, jax_generate(2, **kw))
    pg = sample(port_dataset, port_generate(2, **kw))
    return jcfg, jtree, pcfg, pparams, meta, jg, pg


def test_committed_trained_weights_equal_a_fresh_conversion(trained):
    _, _, _, pparams, meta, _, _ = trained
    committed, _, cmeta = restore_checkpoint(str(ROOT / PORT_BEST), pparams)
    leaves = jax.tree_util.tree_leaves(pparams)
    got = jax.tree_util.tree_leaves(committed)
    assert len(got) == len(leaves) and sum(p.numel() for p in leaves) == 601444
    assert all(torch.equal(a, b) for a, b in zip(got, leaves))
    assert cmeta["epoch"] == meta["epoch"] and cmeta["history"] == meta["history"]


def test_trained_weights_apply_and_rollout_match_jax(trained):
    """F=64, K=5, mlp_layers=3 trained weights: one forward and a 4-step
    rollout, float32, atol 1e-4 / rtol 1e-5; the wet front moves."""
    jcfg, jtree, pcfg, pparams, _, jg, pg = trained
    want = np.asarray(jax.jit(lambda p, g: jax_msgnn.apply_msgnn(p, jcfg, g))(jtree, jg))
    got = port_msgnn.apply_msgnn(pparams, pcfg, pg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    want_r = np.asarray(jax.jit(lambda p, g: jax_rollout(
        jax_msgnn.apply_msgnn, p, jcfg, g, steps=4))(jtree, jg))
    got_r = port_rollout(port_msgnn.apply_msgnn, pparams, pcfg, pg, steps=4,
                         device="cpu").numpy()
    assert got_r.shape == want_r.shape == (pg.num_nodes, 2, 4)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5, atol=1e-4)
    fine = pg.finest_slice()
    wet = got_r[fine, 0] > 0.05
    assert wet[:, -1].sum() > wet[:, 0].sum() > 0 and (~wet).any()
