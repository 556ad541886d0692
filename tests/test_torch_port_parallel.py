"""The port's ring-halo graph parallelism (mswe_gnn_tpu_torch/parallel/) and
its native BFS partitioner, against the JAX package on the CPU, with
``devices = ["cpu"] * P``.

- Every host-side plan builder gives the JAX package's arrays bit for bit,
  and returns None (or raises) where JAX's does.
- Each ring forward is held against JAX's single-device counterpart on the
  ring-reordered graph, with the port's weights handed to JAX (as
  test_torch_port_gnn.py does): JAX's own tests hold its shard_map path
  equal to its single-device one. Tolerances: one ring layer and the wide
  layer atol 1e-5; the GNN and MSGNN forwards atol 1e-4 (rtol 2e-5 for
  packed plans, whose slot sums run in another order); bf16 2e-2 (JAX's
  slot loop rounds every partial hop sum to bf16, the port once); the halo
  aggregates against a dense segment sum, 1e-5.
- The ring train step (rollout 2, conservation 0.01) against JAX's
  single-device ``train_step``: loss within 1e-5, updated parameters within
  rtol 5e-4 / atol 5e-6.
- The CLI on a cut ``configs/ring_halo.yaml`` (4 parts, micro width) against
  the port's own single-device run of the same config: summary within 1e-5;
  and the cases where the CLI raises instead of falling back.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mswe_gnn_tpu import native as jax_native
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu.graph import build_edge_slot_table as jax_slot_table
from mswe_gnn_tpu.models import gnn as jax_gnn
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.models import swegnn as jax_swegnn
from mswe_gnn_tpu.ops.segment import segment_sum as jax_segment_sum
from mswe_gnn_tpu.parallel import dist_swegnn as jax_dist
from mswe_gnn_tpu.parallel import dist_train as jax_dist_train
from mswe_gnn_tpu.parallel import halo as jax_halo
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch import native as port_native
from mswe_gnn_tpu_torch.compat.jax_params import to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models import gnn as port_gnn
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.models import swegnn as port_swegnn
from mswe_gnn_tpu_torch.parallel import dist_swegnn as port_dist
from mswe_gnn_tpu_torch.parallel import dist_train as port_dist_train
from mswe_gnn_tpu_torch.parallel import halo as port_halo
from mswe_gnn_tpu_torch.parallel.sharding import make_mesh
from mswe_gnn_tpu_torch.training import train as port_train
from tests.torch_port_common import SCALER_KINDS, without_subnormal_targets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = 4
TIMING_KEYS = ("mean_prediction_time_s", "speed_up_vs_synthetic_solver_mean",
               "speed_up_vs_synthetic_solver_std")
JAX_MSGNN = jax.jit(jax_msgnn.apply_msgnn, static_argnums=1)
JAX_BLOCK = jax.jit(jax_swegnn.apply_swegnn_block, static_argnums=1)


def t(x):
    return torch.from_numpy(np.array(x))


def cpus(n=PARTS):
    return ["cpu"] * n


def jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(params))


def banded_graph(n, reach=2):
    """Edges within +-reach, dst-sorted: the shape a BFS-ordered partition
    produces (tests/test_dist_swegnn.py:21)."""
    src, dst = [], []
    for i in range(n):
        for d in range(1, reach + 1):
            if i + d < n:
                src += [i, i + d]
                dst += [i + d, i]
    ei = np.asarray([src, dst], np.int32)
    return ei[:, np.argsort(ei[1], kind="stable")]


def assert_trees_equal(got, want, path="plan"):
    """Every leaf bit-equal (numpy and torch arrays, tuples, ints)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        b = np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------- shared problems

@pytest.fixture(scope="module")
def banded():
    """The 64-row banded graph of tests/test_dist_swegnn.py with its ELL table
    and node-id slot sources."""
    n = 64
    ei = banded_graph(n)
    tab, tmask = jax_slot_table(ei, np.ones(ei.shape[1], np.float32), n)
    return n, ei, tab, tmask, ei[0][tab]


def _samples(ds, generate, num_scales, pad):
    records = generate(2, seed=0, nx=16, ny=16, num_scales=num_scales, total_hours=12,
                       substeps=8)
    scalers = ds.fit_dataset_scalers(records, SCALER_KINDS)
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), pad)
                          for r in records])
    return [ds.to_temporal_samples(ds.process_record(r, scalers), spec, previous_t=2,
                                   rollout_steps=2) for r in records]


@pytest.fixture(scope="module")
def corpus():
    """Both records' temporal samples of the 16x16 3-scale corpus (JAX, port),
    padded to multiples of 8 rows."""
    return (_samples(jax_dataset, jax_generate, 3, 8),
            _samples(port_dataset, port_generate, 3, 8))


@pytest.fixture(scope="module")
def ring(corpus):
    """Three wet samples of record 0 ring-reordered for 4 parts, by each
    package: (JAX graphs, port graphs, JAX perm, port perm)."""
    jax_s, port_s = corpus
    sel = slice(5, 8)
    jg, jperm = jax_dist_train.prepare_ring_graphs(jax_s[0][sel], PARTS)
    pg, pperm = port_dist_train.prepare_ring_graphs(port_s[0][sel], PARTS)
    jg = [without_subnormal_targets(a, b)[0] for a, b in zip(jg, pg)]
    pg = [without_subnormal_targets(a, b)[1] for a, b in zip(jg, pg)]
    return jg, pg, jperm, pperm


def msgnn_pair(g, compute_dtype="float32", seed=0, **extra):
    kw = dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1], num_scales=g.spec.num_scales,
              hid_features=8, K=2, mlp_layers=2, previous_t=2, learned_residuals=True,
              with_WL=True, compute_dtype=compute_dtype, **extra)
    pcfg = port_msgnn.MSGNNConfig(**kw)
    pparams = port_msgnn.init_msgnn(torch.Generator().manual_seed(seed), pcfg)
    return jax_msgnn.MSGNNConfig(**kw), jax_tree(pparams), pcfg, pparams


# ---------------------------------------------------------------- the mesh

def test_make_mesh():
    grid = make_mesh(2, 3, ["cpu"] * 7)
    assert [len(r) for r in grid] == [3, 3]
    assert all(d == torch.device("cpu") for r in grid for d in r)
    assert make_mesh(1, 2, ["cpu", "meta"]) == [[torch.device("cpu"), torch.device("meta")]]
    with pytest.raises(ValueError, match="need 8 devices for a 1 x 8 mesh, have 4"):
        make_mesh(1, 8, cpus())
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices"):
            make_mesh(1, 2)


# ---------------------------------------------------------------- host-side plans

@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("pack", [False, True])
def test_slot_plan_matches_jax(banded, ring, pack, n_parts):
    n, _, _, tmask, src_slots = banded
    cases = [(src_slots, tmask, n, {})]
    # the reordered corpus graph: scale 0's processor table and level 0's
    # un-pool table (sources on the coarse scale)
    g = ring[1][0]
    spec = g.spec
    n0 = spec.node_counts[0]
    tab0 = np.maximum(g.in_edge_table[:n0].numpy() - spec.edge_ptr[0], 0)
    cases.append((g.edge_index[0, :spec.edge_counts[0]].numpy()[tab0],
                  g.in_edge_mask[:n0].numpy(), n0, {}))
    isl = spec.intra_edge_slice(0)
    coarse = g.intra_edge_index[0, isl].numpy() - spec.node_ptr[1]
    utab = np.maximum(g.unpool_table[:n0].numpy() - spec.intra_edge_ptr[0], 0)
    cases.append((coarse[utab], g.unpool_mask[:n0].numpy(), n0,
                  {"num_src_nodes": spec.node_counts[1]}))
    for src, mask, nodes, kw in cases:
        want = jax_dist.build_dist_slot_plan(src, mask, nodes, n_parts, pack_halo_slots=pack,
                                             **kw)
        got = port_dist.build_dist_slot_plan(src, mask, nodes, n_parts, pack_halo_slots=pack,
                                             **kw)
        assert want is not None
        assert_trees_equal(got, want)


def test_plans_reject_nonlocal_graphs(rng):
    """A random graph is not ring-local: None on both sides
    (tests/test_dist_swegnn.py:286, tests/test_halo_ring.py:52)."""
    n = 64
    src_slots = rng.integers(0, n, size=(n, 4)).astype(np.int32)
    mask = np.ones((n, 4), np.float32)
    for build in (jax_dist.build_dist_slot_plan, port_dist.build_dist_slot_plan):
        assert build(src_slots, mask, n, PARTS) is None
    for build in (jax_dist.build_wide_halo_plan, port_dist.build_wide_halo_plan):
        assert build(src_slots, mask, n, PARTS, 2) is None
    ei = np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)])
    for build in (jax_halo.build_ring_halo_plan, port_halo.build_ring_halo_plan):
        assert build(ei, n, PARTS) is None


@pytest.mark.parametrize("width", [2, 3])
def test_wide_plan_matches_jax(banded, rng, width):
    n, ei, tab, tmask, src_slots = banded
    ea = rng.normal(size=(ei.shape[1], 3)).astype(np.float32)
    ea_slots = (ea[tab] * tmask[..., None]).astype(np.float32)
    want = jax_dist.build_wide_halo_plan(src_slots, tmask, n, PARTS, width,
                                         ea_slots_global=ea_slots)
    got = port_dist.build_wide_halo_plan(src_slots, tmask, n, PARTS, width,
                                         ea_slots_global=ea_slots)
    assert want is not None and want["ring_ptr"] == got["ring_ptr"]
    assert_trees_equal(got, want)
    np.testing.assert_array_equal(port_dist.slot_ea_per_part(ea, tab, tmask, PARTS),
                                  jax_dist.slot_ea_per_part(ea, tab, tmask, PARTS))


GRAPH_ARRAYS = ("x_static", "x_dynamic", "node_mask", "area", "dem", "y", "edge_index",
                "edge_attr", "edge_mask", "intra_edge_index", "intra_edge_mask", "bc_nodes",
                "bc_mask", "bc_values", "in_edge_table", "in_edge_mask", "pool_table",
                "pool_mask", "unpool_table", "unpool_mask")


def test_reorder_matches_jax(ring):
    jg, pg, jperm, pperm = ring
    np.testing.assert_array_equal(pperm, jperm)
    assert not np.array_equal(pperm, np.arange(len(pperm)))
    for a, b in zip(pg, jg):
        assert vars(a.spec) == vars(b.spec) and a.ell_cache is None and a.band_plan is None
        for name in GRAPH_ARRAYS:
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)), err_msg=name)


@pytest.mark.parametrize("overlap,halo_width", [(False, 1), (True, 1), (False, 2)])
def test_msgnn_inputs_match_jax(ring, overlap, halo_width):
    jg, pg = ring[0][0], ring[1][0]
    want = jax_dist.build_dist_msgnn_inputs(jg, PARTS, overlap=overlap, halo_width=halo_width)
    got = port_dist.build_dist_msgnn_inputs(pg, PARTS, overlap=overlap, halo_width=halo_width)
    assert want is not None
    want = jax.tree_util.tree_map(np.asarray, want)
    assert_trees_equal(got, want)


def test_msgnn_inputs_fail_where_jax_fails(corpus):
    """At 8 parts the coarsest scale of the 16x16 corpus is not ring-adjacent:
    None on both sides, and the port names the plan."""
    jg, _ = jax_dist.reorder_graph_for_ring(corpus[0][0][5], 8)
    pg, _ = port_dist.reorder_graph_for_ring(corpus[1][0][5], 8)
    assert jax_dist.build_dist_msgnn_inputs(jg, 8) is None
    assert port_dist.build_dist_msgnn_inputs(pg, 8) is None
    assert "scale 2" in port_dist.ring_plan_failure(pg, 8)
    assert port_dist.ring_plan_failure(pg, PARTS) is None
    assert port_dist_train.make_dist_apply_fn(["cpu"] * 8, msgnn_pair(pg)[2], pg) is None


def test_prepare_ring_graphs_rejects_mixed_meshes():
    """Two samples of one simulation give one permutation on both sides; a
    sample of another mesh raises on both (tests/test_dist_train.py:96)."""
    def samples(ds, generate, nx):
        recs = generate(1, seed=3, nx=nx, ny=12, num_scales=2, total_hours=5, substeps=2)
        scalers = ds.fit_dataset_scalers(recs, SCALER_KINDS)
        spec = ds.make_spec(recs[0].mesh, len(recs[0].mesh.ghosts.ghost_nodes), 64)
        return ds.to_temporal_samples(ds.process_record(recs[0], scalers), spec,
                                      previous_t=2, rollout_steps=1)
    jax_12, jax_11 = (samples(jax_dataset, jax_generate, nx) for nx in (12, 11))
    port_12, port_11 = (samples(port_dataset, port_generate, nx) for nx in (12, 11))
    _, jperm = jax_dist_train.prepare_ring_graphs(jax_12[:2], PARTS)
    _, pperm = port_dist_train.prepare_ring_graphs(port_12[:2], PARTS)
    np.testing.assert_array_equal(pperm, jperm)
    with pytest.raises(AssertionError, match="GSPMD"):
        jax_dist_train.prepare_ring_graphs([jax_12[0], jax_11[0]], PARTS)
    with pytest.raises(ValueError, match="one mesh topology"):
        port_dist_train.prepare_ring_graphs([port_12[0], port_11[0]], PARTS)


def test_halo_plans_match_jax(rng):
    n, f = 64, 16
    ei = banded_graph(n)
    want = jax_halo.build_ring_halo_plan(ei, n, PARTS)
    got = port_halo.build_ring_halo_plan(ei, n, PARTS)
    assert want is not None
    assert_trees_equal(got, want)
    for a, b in zip(port_halo.remap_sources_to_halo(ei, got, PARTS),
                    jax_halo.remap_sources_to_halo(ei, want, PARTS)):
        assert_trees_equal(a, b)
    ea = rng.normal(size=(ei.shape[1], 3)).astype(np.float32)
    emask = (rng.random(ei.shape[1]) > 0.2).astype(np.float32)
    for a, b in zip(port_halo.partition_edges_by_dst(ei, ea, emask, n, PARTS),
                    jax_halo.partition_edges_by_dst(ei, ea, emask, n, PARTS)):
        assert_trees_equal(a, b)


# ---------------------------------------------------------------- native BFS partitioner

def _triangulated_dual():
    from mswe_gnn_tpu_torch.data.triangulate import triangulate_polygon

    poly = np.array([[0, 0], [2000, 0], [2000, 1200], [900, 1800], [0, 1200]], float)
    mesh = triangulate_polygon(poly, 150.0, lambda x, y: 0.001 * x + 0.002 * y,
                               rng=np.random.default_rng(0), engine="auto")
    return mesh.dual_edge_index, mesh.num_faces


@pytest.mark.parametrize("graph", ["chain", "triangulated"])
def test_bfs_partition_matches_jax(graph):
    """The native partitioner and its numpy version against JAX's, on the
    inputs of tests/test_native.py:49 (a chain, 4 parts) and :224 (a
    triangulated domain's dual graph, 1 part, and 3 parts)."""
    if graph == "chain":
        n = 64
        src = np.concatenate([np.arange(n - 1), np.arange(1, n)])
        dst = np.concatenate([np.arange(1, n), np.arange(n - 1)])
        cases = [(np.stack([src, dst]), n, PARTS)]
    else:
        ei, n = _triangulated_dual()
        cases = [(ei, n, 1), (ei, n, 3)]
    for ei, n, p in cases:
        want = jax_native.bfs_partition(ei, n, p)
        for got in (port_native.bfs_partition(ei, n, p),
                    port_native.bfs_partition_reference(ei, n, p)):
            for a, b in zip(got, want):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    owner, order = port_native.bfs_partition(*cases[-1])
    assert sorted(order.tolist()) == list(range(cases[-1][1]))


# ---------------------------------------------------------------- forwards

@pytest.mark.parametrize("with_grad,fe", [(True, 3), (False, 0)])
def test_dist_layer_matches_jax_block(banded, rng, with_grad, fe):
    """The ring SWEGNN layer (per-hop and width-2 / 3 plans) against JAX's
    single-device ``apply_swegnn_block``: atol 1e-5."""
    n, ei, tab, tmask, src_slots = banded
    f = 8
    kw = dict(static_node_features=f, dynamic_node_features=f, edge_features=fe, K=5,
              with_gradient=with_grad, mlp_layers=2, mlp_activation="prelu")
    pcfg = port_swegnn.SWEGNNConfig(**kw)
    params = port_swegnn.init_swegnn(torch.Generator().manual_seed(1), pcfg)
    x_s = rng.normal(size=(n, f)).astype(np.float32)
    x_d = rng.normal(size=(n, f)).astype(np.float32)
    x_d[rng.random(n) > 0.6] = 0.0
    ea = rng.normal(size=(ei.shape[1], fe)).astype(np.float32) if fe else None
    want = np.asarray(JAX_BLOCK(
        jax_tree(params), jax_swegnn.SWEGNNConfig(**kw), x_s, x_d, x_s, x_d,
        jnp.asarray(ei[0]), jnp.asarray(ei[1]), edge_attr=ea,
        agg_table=jnp.asarray(tab), agg_mask=jnp.asarray(tmask)))

    plan = port_dist.build_dist_slot_plan(src_slots, tmask, n, PARTS)
    ea_parts = (port_dist.slot_ea_per_part(ea, tab, tmask, PARTS) if fe
                else np.zeros((PARTS, n // PARTS, tab.shape[1], 0), np.float32))
    got = port_dist.make_dist_swegnn(cpus(), pcfg)(
        params, t(x_s), t(x_d), plan["src_tab"], plan["slot_mask"], ea_parts,
        plan["send_next"], plan["send_prev"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    ea_slots = (ea[tab] * tmask[..., None]).astype(np.float32) if fe else None
    for width in (2, 3):
        wp = port_dist.build_wide_halo_plan(src_slots, tmask, n, PARTS, width,
                                            ea_slots_global=ea_slots)
        ea_ext = wp["ext_ea"] if fe else np.zeros((PARTS, 2 * wp["halo"], tab.shape[1], 0),
                                                  np.float32)
        got = port_dist.make_dist_swegnn_wide(cpus(), pcfg, width, wp["ring_ptr"],
                                              wp["halo"])(
            params, t(x_s), t(x_d), wp["src_tab"], wp["slot_mask"], ea_parts,
            wp["ext_tab"], wp["ext_mask"], ea_ext, wp["send_next"], wp["send_prev"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=f"width {width}")


def test_dist_gnn_forward_matches_apply_gnn(ring):
    """The ring single-scale SWE-GNN against JAX's ``apply_gnn`` on the
    reordered corpus graph's finest scale, built as a one-scale graph by
    both packages' own builders: atol 1e-4."""
    from mswe_gnn_tpu.graph import GraphSpec as JaxSpec, build_flood_graph as jax_build
    from mswe_gnn_tpu_torch.graph import GraphSpec, build_flood_graph

    g = ring[1][0]
    spec = g.spec
    n, e = spec.node_counts[0], spec.edge_counts[0]
    n_real = int(g.node_mask[:n].sum())
    real = g.edge_mask[:e].numpy() > 0
    arrays = dict(x_static=g.x_static[:n_real].numpy(),
                  x_dynamic=g.x_dynamic[:n_real].numpy(),
                  edge_index=g.edge_index[:, :e].numpy()[:, real],
                  edge_attr=g.edge_attr[:e].numpy()[real],
                  raw_node_counts=(n_real,), raw_edge_counts=(int(real.sum()),), previous_t=2)
    counts = dict(node_counts=(n,), edge_counts=(e,), intra_edge_counts=(), num_bc=1)
    jg = jax_build(spec=JaxSpec(**counts), **arrays)
    pg = build_flood_graph(spec=GraphSpec(**counts), **arrays)
    kw = dict(num_node_features=pg.num_node_features,
              num_edge_features=pg.edge_attr.shape[1], hid_features=8, K=3, n_gnn_layers=2,
              mlp_layers=2, with_WL=True, learned_residuals=True, previous_t=2,
              gnn_activation="tanh")
    pcfg = port_gnn.GNNConfig(**kw)
    params = port_gnn.init_gnn(torch.Generator().manual_seed(2), pcfg)
    want = np.asarray(jax.jit(jax_gnn.apply_gnn, static_argnums=1)(
        jax_tree(params), jax_gnn.GNNConfig(**kw), jg))
    tab, tmask = pg.in_edge_table.numpy(), pg.in_edge_mask.numpy()
    plan = port_dist.build_dist_slot_plan(pg.edge_index[0].numpy()[tab], tmask, n, PARTS)
    assert plan is not None
    ea_parts = port_dist.slot_ea_per_part(pg.edge_attr.numpy(), tab, tmask, PARTS)
    got = port_dist.make_dist_gnn_forward(cpus(), pcfg)(
        params, pg.x_static, pg.x_dynamic, pg.node_mask, plan["src_tab"],
        plan["slot_mask"], ea_parts, plan["send_next"], plan["send_prev"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("overlap,halo_width", [(False, 1), (True, 1), (False, 2),
                                                (False, 3)])
def test_dist_msgnn_matches_apply_msgnn(ring, overlap, halo_width):
    """The ring MSGNN (``make_dist_apply_fn``) against JAX's single-device
    ``apply_msgnn`` on the reordered graph: atol 1e-4, and rtol 2e-5 on
    packed plans (their slot sums run in another order)."""
    jg, pg = ring[0][0], ring[1][0]
    jcfg, jparams, pcfg, params = msgnn_pair(pg)
    want = np.asarray(JAX_MSGNN(jparams, jcfg, jg))
    apply_fn = port_dist_train.make_dist_apply_fn(cpus(), pcfg, pg, overlap=overlap,
                                                  halo_width=halo_width)
    got = apply_fn(params, pcfg, pg).numpy()
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=2e-5 if overlap else 0, atol=1e-4)
    with pytest.raises(ValueError, match="batch 1"):
        apply_fn(params, pcfg, concat_graphs(ring[1][:2]))


def test_dist_msgnn_bf16_matches_jax(ring):
    """The bf16 policy through the ring against JAX's single-device bf16
    forward: atol 2e-2 (JAX's slot loop rounds every partial sum to bf16)."""
    jg, pg = ring[0][0], ring[1][0]
    jcfg, jparams, pcfg, params = msgnn_pair(pg, compute_dtype="bfloat16")
    want = np.asarray(JAX_MSGNN(jparams, jcfg, jg))
    got = port_dist_train.make_dist_apply_fn(cpus(), pcfg, pg)(params, pcfg, pg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("kind", ["spmd", "ring"])
def test_halo_aggregates_match_dense(rng, kind):
    n, f = 64, 16
    ei = banded_graph(n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=ei.shape[1]).astype(np.float32)
    want = np.asarray(jax_segment_sum(jnp.asarray(x)[ei[0]] * jnp.asarray(w)[:, None],
                                      jnp.asarray(ei[1]), n))
    block = n // PARTS
    if kind == "spmd":
        src_g, dst_l, attr, mask = port_halo.partition_edges_by_dst(
            ei, w[:, None], np.ones(ei.shape[1], np.float32), n, PARTS)
        got = port_halo.make_spmd_aggregate(cpus())(t(x), src_g, dst_l, attr[..., 0] * mask)
    else:
        plan = port_halo.build_ring_halo_plan(ei, n, PARTS)
        src_l, dst_l, emask = port_halo.remap_sources_to_halo(ei, plan, PARTS)
        wp = np.zeros_like(emask)
        for p in range(PARTS):
            sel = np.where(ei[1] // block == p)[0]
            wp[p, :len(sel)] = w[sel]
        got = port_halo.make_ring_halo_aggregate(cpus(), plan["halo"])(
            t(x), plan["send_next"], plan["send_prev"], src_l, dst_l, wp * emask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- training

def test_ring_train_step_matches_jax(ring):
    """One pushforward train step (rollout 2, conservation 0.01) through the
    ring ``apply_fn`` against JAX's single-device ``train_step``: loss within
    1e-5, updated parameters within rtol 5e-4 / atol 5e-6
    (tests/test_dist_train.py:50)."""
    jg, pg = ring[0][0], ring[1][0]
    jcfg, jparams, pcfg, params = msgnn_pair(pg, seed=3)
    kw = dict(batch_size=1, conservation=0.01, learning_rate=1e-3)
    jopts = jax_train.TrainerOptions(**kw)
    jopt = jax_train.make_optimizer(jopts, steps_per_epoch=1)
    want_p, _, want_loss = jax_train.train_step(
        jparams, jopt.init(jparams), jg, apply_fn=jax_msgnn.apply_msgnn, cfg=jcfg,
        rollout_steps=2, opts=jopts, multiscale=True, optimizer=jopt)
    popts = port_train.TrainerOptions(**kw)
    popt = port_train.make_optimizer(popts, steps_per_epoch=1)
    apply_fn = port_dist_train.make_dist_apply_fn(cpus(), pcfg, pg)
    got_p, _, loss = port_train.train_step(
        params, popt.init(params), pg, apply_fn=apply_fn, cfg=pcfg, rollout_steps=2,
        opts=popts, multiscale=True, optimizer=popt, device="cpu")
    assert abs(float(loss) - float(want_loss)) < 1e-5
    got_p = to_numpy_tree(got_p)
    assert (jax.tree_util.tree_structure(got_p)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want_p)))
    for a, b in zip(jax.tree_util.tree_leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-6)


def test_ring_eval_step_matches_single_device(ring):
    """Full-rollout validation metrics through the ring against the
    single-device port (tests/test_dist_train.py:80): within 2e-5."""
    pg = ring[1][1]
    _, _, pcfg, params = msgnn_pair(pg, seed=4)
    opts = port_train.TrainerOptions(batch_size=1)
    steps = int(pg.y.shape[-1])
    kw = dict(cfg=pcfg, steps=steps, opts=opts, multiscale=True, device="cpu")
    m1 = port_train.eval_step(params, pg, apply_fn=port_msgnn.apply_msgnn, **kw)
    m2 = port_train.eval_step(params, pg,
                              apply_fn=port_dist_train.make_dist_apply_fn(cpus(), pcfg, pg),
                              **kw)
    for k in m1:
        a, b = float(m1[k]), float(m2[k])
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) < 2e-5, (k, a, b)


# ---------------------------------------------------------------- the CLI

def ring_config(graph=PARTS):
    """configs/ring_halo.yaml at micro width (F=8, K=2, mlp_layers 2) with
    ``graph`` parts: its own corpus (4 simulations of 24x24, 3 scales) and
    epochs."""
    with open(os.path.join(ROOT, "configs", "ring_halo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["parallel"]["graph"] = graph
    cfg["models"].update(hid_features=8, K=2, mlp_layers=2)
    return cfg


def test_cli_ring_halo_matches_single_device(tmp_path, monkeypatch):
    """``main train`` and ``eval`` of the cut ring_halo.yaml over 4 CPU parts
    against ``run_training`` of the same config without its ``parallel``
    block: every summary value within 1e-5 (timings aside)."""
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    cfg = ring_config()
    cfg["trainer_options"]["batch_size"] = 2            # forced back to 1
    path = tmp_path / "ring.yaml"
    path.write_text(yaml.safe_dump(cfg))
    devices = ",".join(cpus())
    assert port_main.main(["train", "--config", str(path), "--out", str(tmp_path / "ring"),
                           "--device", devices]) == 0
    assert port_main.main(["eval", "--config", str(path), "--ckpt",
                           str(tmp_path / "ring" / "best"), "--out", str(tmp_path / "eval"),
                           "--device", devices]) == 0
    single = copy.deepcopy(cfg)
    single.pop("parallel")
    single["trainer_options"]["batch_size"] = 1
    want = port_main.run_training(single, str(tmp_path / "single"), device="cpu")
    for run in ("ring", "eval"):
        with open(tmp_path / run / "summary.json") as f:
            got = json.load(f)
        assert set(got) | {"n_params"} >= set(want) - {"n_params"}
        for k, v in got.items():
            if k not in TIMING_KEYS:
                assert abs(v - want[k]) < 1e-5, (run, k, v, want[k])


@pytest.mark.parametrize("case", ["too_few_devices", "data_parallel", "gnn", "failing_plan",
                                  "gspmd", "list_without_ring"])
def test_cli_ring_halo_raises(tmp_path, monkeypatch, capsys, case):
    """Where the device list does not fit the config, the port raises (and
    never trains on one device). Where the JAX package falls back to GSPMD
    (another model; the config's own corpus at its own 8 parts, whose level
    1 pool plan is not ring-adjacent) the port falls back too, prints JAX's
    line and trains on the mesh; ``data`` > 1 under ring_halo gives the
    ``data`` = 1 result; a ``gspmd`` block trains on its mesh."""
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    cfg, device = ring_config(), cpus()
    if case in ("too_few_devices", "list_without_ring"):
        if case == "too_few_devices":
            cfg["parallel"]["graph"] = 8
            match, err = "8 devices, --device lists 4", ValueError
        else:
            cfg.pop("parallel")
            match, err = "no parallel ring_halo block", ValueError
        with pytest.raises(err, match=match):
            port_main.run_training(cfg, str(tmp_path / "run"), device=device)
        assert not os.path.exists(tmp_path / "run" / "best")
        return
    if case == "data_parallel":
        cfg["parallel"]["data"] = 2
    elif case == "gnn":
        cfg["models"]["model_type"] = "GNN"
    elif case == "failing_plan":
        cfg["parallel"]["graph"] = 8
        device = ["cpu"] * 8
    else:
        cfg["parallel"] = {"mode": "gspmd", "graph": 2}
    summary = port_main.run_training(copy.deepcopy(cfg), str(tmp_path / "run"), device=device)
    text = capsys.readouterr().out
    assert os.path.exists(tmp_path / "run" / "best" / "meta.json")
    assert all(np.isfinite(v) for v in summary.values())
    fallback = ("ring_halo unavailable (non-MSGNN model or ring plan failure); falling back "
                "to GSPMD")
    assert (fallback in text) == (case in ("gnn", "failing_plan"))
    if case != "data_parallel":
        assert "device mesh: data=1 x graph=" in text
        return
    assert "4-way" in text and "device mesh" not in text
    cfg["parallel"]["data"] = 1
    want = port_main.run_training(cfg, str(tmp_path / "data1"), device=device)
    for k, v in summary.items():
        if k not in TIMING_KEYS:
            assert abs(v - want[k]) < 1e-5, (k, v, want[k])
