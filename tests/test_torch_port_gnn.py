"""The port's single-scale GNN, its Cheb / TAG / GAT baselines, the segment
reductions, the edge-major SWEGNN path and MSGNN's learned pooling, against
the JAX package on the CPU, on the same inputs (numpy, seeded) and the same
weights. The comparisons draw the weights with the port's init (the JAX
package's layout and distributions) and hand them to JAX as the bridge's
numpy tree: JAX's eager init compiles one random draw per distinct weight
shape, most of this file's time otherwise. JAX's own init of every model
type, and its load into the port through compat/jax_params.py, are held by
test_build_model_and_bridge_match_jax.

Tolerances: the segment reductions bit-equal or 1e-6 (the same float32 sums,
in another order); the convs and one SWEGNN layer atol 1e-5; a GNN forward
and a 4-step rollout atol 1e-4 (rtol 1e-5); one pushforward loss rtol 1e-5
and every gradient leaf within 1e-4 * max|leaf| + 1e-6; bfloat16 atol 2e-2
(the JAX slot loop rounds every partial hop sum to bf16, the port adds in
float32 and rounds once). The JAX side is jitted; the graph is the 16x16
grid's single-scale dual graph (hid 8, K 2, 2 layers), and pareto_gnn's
model at its full width (F=64, K=10) on the same graph.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import config as jax_config
from mswe_gnn_tpu.models import convs as jax_convs
from mswe_gnn_tpu.models import gnn as jax_gnn
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.models import swegnn as jax_swegnn
from mswe_gnn_tpu.models.prepare import prepare_graph as jax_prepare
from mswe_gnn_tpu.models.registry import build_model as jax_build_model
from mswe_gnn_tpu.models.registry import count_params as jax_count_params
from mswe_gnn_tpu.ops import segment as jax_segment
from mswe_gnn_tpu.ops.band_hop import attach_band_plan as jax_attach
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu.training.rollout import rollout as jax_rollout
from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.bench_problem import PARETO_GNN_CONFIG
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.models import build_model, convs as port_convs, count_params
from mswe_gnn_tpu_torch.models import gnn as port_gnn
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.models import swegnn as port_swegnn
from mswe_gnn_tpu_torch.models.prepare import prepare_graph as port_prepare
from mswe_gnn_tpu_torch.ops import segment as port_segment
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan as port_attach
from mswe_gnn_tpu_torch.training import train as port_train
from mswe_gnn_tpu_torch.training.rollout import rollout as port_rollout
from tests.test_torch_port_model import block_problem
from tests.torch_port_common import (bench_sample_pair, numpy_tree, sample_pair,
                                     without_subnormal_targets)

TYPES = ("SWEGNN", "GNN_L", "GNN_A", "GAT")
# one jitted JAX forward for every apply_gnn case: a case whose (config,
# shapes) was compiled before reuses it
JAX_APPLY = jax.jit(jax_gnn.apply_gnn, static_argnums=1)
SMALL = dict(hid_features=8, K=2, n_gnn_layers=2, mlp_layers=2, learned_residuals=True,
             with_WL=True, gnn_activation="tanh")


def t(x):
    return torch.from_numpy(np.array(x))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def jax_tree(params):
    """The port's parameter tree as the JAX package's (the bridge's numpy
    layout, as JAX arrays)."""
    return jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(params))


def gnn_kw(g, previous_t):
    return dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
                num_edge_features=g.edge_attr.shape[1], previous_t=previous_t)


def model_pair(g, type_gnn, seed=0, previous_t=2, **extra):
    """(JAX cfg, JAX params, port cfg, port params) of a small GNN
    (``extra`` replaces keys of ``SMALL``), the same weights on both sides."""
    kw = {**gnn_kw(g, previous_t), "type_gnn": type_gnn, **SMALL, **extra}
    pcfg = port_gnn.GNNConfig(**kw)
    pparams = port_gnn.init_gnn(gen(seed), pcfg)
    return jax_gnn.GNNConfig(**kw), jax_tree(pparams), pcfg, pparams


@pytest.fixture(scope="module")
def bench_single():
    """The bench problem's sample at 16x16 in one scale (JAX, port),
    previous_t 3, padded to 128 rows as the band planner needs."""
    return bench_sample_pair(16, 16, 4, num_scales=1)


@pytest.fixture(scope="module")
def single():
    """The 16x16 grid's single-scale dual graph (JAX, port), previous_t 2."""
    jg, pg = sample_pair(previous_t=2, rollout_steps=4, index=1, num_scales=1)
    assert pg.spec.num_scales == 1 and pg.num_nodes > pg.spec.node_counts[0] - 8
    return jg, pg


# ---------------------------------------------------------------- segment ops

@pytest.fixture(scope="module")
def segments():
    """Rows with ids that leave segments 3 and 7 empty, a 0/1 weight per row."""
    rng = np.random.default_rng(7)
    ids = rng.choice([0, 1, 2, 4, 5, 6, 8], size=40).astype(np.int32)
    data = rng.normal(size=(40, 5)).astype(np.float32)
    weights = (rng.random(40) < 0.7).astype(np.float32)
    return data, ids, weights


@pytest.mark.parametrize("op", ["gather", "sum", "mean", "mean_weights", "max"])
def test_segment_ops_match_jax(segments, op):
    data, ids, weights = segments
    n = 9
    if op == "gather":
        want = jax_segment.gather(jnp.asarray(data), jnp.asarray(ids))
        got = port_segment.gather(t(data), t(ids))
    elif op == "sum":
        want = jax_segment.segment_sum(jnp.asarray(data), jnp.asarray(ids), n)
        got = port_segment.segment_sum(t(data), t(ids), n)
    elif op == "max":
        want = jax_segment.segment_max(jnp.asarray(data), jnp.asarray(ids), n)
        got = port_segment.segment_max(t(data), t(ids), n)
    else:
        w = weights if op == "mean_weights" else None
        want = jax_segment.segment_mean(jnp.asarray(data), jnp.asarray(ids), n,
                                        weights=None if w is None else jnp.asarray(w))
        got = port_segment.segment_mean(t(data), t(ids), n,
                                        weights=None if w is None else t(w))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if op != "gather":
        assert np.all(got.numpy()[[3, 7]] == 0) and np.all(want[[3, 7]] == 0)
    if op in ("gather", "max"):
        np.testing.assert_array_equal(got.numpy(), want)      # no arithmetic


def test_segment_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    ei = rng.integers(0, 12, (2, 60)).astype(np.int64)
    extra = rng.normal(size=60)
    for a, b in zip(port_segment.sort_edges_by_dst(ei, extra),
                    jax_segment.sort_edges_by_dst(ei, extra)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_segment.sort_edges_by_dst(ei)[1],
                                  jax_segment.sort_edges_by_dst(ei)[1])
    np.testing.assert_array_equal(port_segment.coalesce_edges(ei),
                                  jax_segment.coalesce_edges(ei))
    raw = port_segment.segment_max_raw(torch.ones(2, 3), torch.tensor([0, 0]), 2)
    assert torch.all(raw[1] == float("-inf"))


# ---------------------------------------------------------------- convs

@pytest.fixture(scope="module")
def conv_graph():
    """A 20-node graph with padded edges (mask 0, pointing at node 0) and an
    isolated node (19): no real edge in or out."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 19, 70).astype(np.int32)
    dst = rng.integers(0, 19, 70).astype(np.int32)
    mask = np.ones(70, np.float32)
    src, dst = np.concatenate([src, np.zeros(10, np.int32)]), np.concatenate(
        [dst, np.full(10, 19, np.int32)])
    mask = np.concatenate([mask, np.zeros(10, np.float32)])
    x = rng.normal(size=(20, 8)).astype(np.float32)
    return x, src, dst, mask


@pytest.mark.parametrize("kind", ["cheb", "tag", "gat"])
def test_convs_match_jax(conv_graph, kind):
    x, src, dst, mask = conv_graph
    jcfg, pcfg, init, apply_j, apply_p = {
        "cheb": (jax_convs.ChebConfig(8, 6, 3), port_convs.ChebConfig(8, 6, 3),
                 port_convs.init_cheb, jax_convs.apply_cheb, port_convs.apply_cheb),
        "tag": (jax_convs.TAGConfig(8, 6, 2), port_convs.TAGConfig(8, 6, 2),
                port_convs.init_tag, jax_convs.apply_tag, port_convs.apply_tag),
        "gat": (jax_convs.GATConfig(8, 6), port_convs.GATConfig(8, 6),
                port_convs.init_gat, jax_convs.apply_gat, port_convs.apply_gat)}[kind]
    pparams = jax.tree_util.tree_map(lambda a: a + 0.1, init(gen(4), pcfg))  # a non-zero bias
    jparams = jax_tree(pparams)
    want = np.asarray(jax.jit(apply_j, static_argnums=1)(jparams, jcfg, x, src, dst, mask))
    got = apply_p(pparams, pcfg, t(x), t(src), t(dst), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind == "gat":
        # the isolated node gets its bias alone, in both packages
        np.testing.assert_allclose(got[19], np.asarray(jparams["bias"]), atol=1e-7)
    # the padded edges change nothing
    real = mask > 0
    again = apply_p(pparams, pcfg, t(x), t(src[real]), t(dst[real]), t(mask[real])).numpy()
    np.testing.assert_allclose(again, got, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- edge-major SWEGNN

@pytest.mark.parametrize("form,mode", [
    ("same", "gradient"), ("same", "no_gradient"), ("same", "upwind"),
    ("same", "gradient-bf16"), ("unpool", "no_gradient"), ("unpool", "gradient")])
def test_edge_major_block_matches_jax(rng, form, mode):
    """The segment-sum path (no agg_table) of one SWEGNN layer, with padded
    edges, against JAX (atol 1e-5), and against the port's own ELL path on
    the same edges (atol 1e-5). Under bf16 (atol 2e-2) only JAX is the
    reference: the edge-major path keeps the hop state in float32, as JAX's
    does, where the ELL path rounds it to bf16 after every hop."""
    f, same, bf16 = 8, form == "same", mode.endswith("bf16")
    tol = 2e-2 if bf16 else 1e-5
    kw = dict(static_node_features=f, dynamic_node_features=f, mlp_layers=2,
              with_gradient=mode != "no_gradient", upwind_mode=mode == "upwind",
              compute_dtype="bfloat16" if bf16 else "float32")
    if same:
        kw.update(edge_features=3, K=3)
        prob = block_problem(rng, n_dst=60, n_src=60, e=200, f=f, fe=3, same_block=True)
    else:
        kw.update(edge_features=0, K=1, with_filter_matrix=False)
        prob = block_problem(rng, n_dst=64, n_src=20, e=64, f=f, fe=0, same_block=False)
    x_s, x_d, x_s_dst, x_d_dst, src, dst, ea, table, mask = prob
    emask = (rng.random(len(src)) < 0.9).astype(np.float32)      # 10% padded edges
    jcfg, pcfg = jax_swegnn.SWEGNNConfig(**kw), port_swegnn.SWEGNNConfig(**kw)
    pparams = port_swegnn.init_swegnn(gen(5), pcfg)
    jparams = jax_tree(pparams)
    block = jax.jit(jax_swegnn.apply_swegnn_block,
                    static_argnames=("cfg", "same_block", "dst_sorted"))
    want = np.asarray(block(jparams, jcfg, x_s, x_d, x_s_dst, x_d_dst, src, dst,
                            edge_attr=ea, edge_mask=emask, same_block=same))
    args = (t(x_s), t(x_d), t(x_s_dst), t(x_d_dst), t(src), t(dst))
    ea_t = t(ea) if ea is not None else None
    got = port_swegnn.apply_swegnn_block(pparams, pcfg, *args, edge_attr=ea_t,
                                         edge_mask=t(emask), same_block=same).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    if bf16:
        return
    # the ELL path on the same real edges: a slot's mask is its edge's
    slot_mask = mask * emask[table]
    ell = port_swegnn.apply_swegnn_block(pparams, pcfg, *args, edge_attr=ea_t,
                                         same_block=same, agg_table=t(table).long(),
                                         agg_mask=t(slot_mask)).numpy()
    np.testing.assert_allclose(ell, got, rtol=1e-5, atol=1e-5)


def test_apply_swegnn_ranges_match_jax(rng):
    """The whole-graph layer with a dst_range: rows outside it are only
    H_0-transformed (swegnn.py:506-561)."""
    f = 8
    kw = dict(static_node_features=f, dynamic_node_features=f, edge_features=2, K=2,
              mlp_layers=2)
    jcfg, pcfg = jax_swegnn.SWEGNNConfig(**kw), port_swegnn.SWEGNNConfig(**kw)
    pparams = port_swegnn.init_swegnn(gen(6), pcfg)
    jparams = jax_tree(pparams)
    x_s = rng.normal(size=(50, f)).astype(np.float32)
    x_d = rng.normal(size=(50, f)).astype(np.float32)
    x_d[rng.random(50) < 0.4] = 0.0
    src = rng.integers(10, 40, 90).astype(np.int32)
    dst = np.sort(rng.integers(10, 40, 90)).astype(np.int32)
    ea = rng.normal(size=(90, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_swegnn.apply_swegnn,
                              static_argnames=("cfg", "src_range", "dst_range"))(
        jparams, jcfg, x_s, x_d, src, dst, edge_attr=ea, src_range=(10, 40),
        dst_range=(10, 40)))
    got = port_swegnn.apply_swegnn(pparams, pcfg, t(x_s), t(x_d), t(src), t(dst),
                                   edge_attr=t(ea), src_range=(10, 40),
                                   dst_range=(10, 40)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="identical or disjoint"):
        port_swegnn.apply_swegnn(pparams, pcfg, t(x_s), t(x_d), t(src), t(dst),
                                 edge_attr=t(ea), src_range=(0, 30), dst_range=(10, 40))


# ---------------------------------------------------------------- apply_gnn

@pytest.mark.parametrize("type_gnn,prepared", [
    pytest.param(k, p, id=f"{k}-{'prepared' if p else 'raw'}")
    for k in TYPES for p in (False, True)])
def test_apply_gnn_matches_jax(single, type_gnn, prepared):
    jg, pg = single
    jcfg, jparams, pcfg, pparams = model_pair(jg, type_gnn)
    if prepared:
        with torch.no_grad():
            pg2 = port_prepare(pparams, pcfg, pg)
        assert (pg2.ell_cache is not None) == (type_gnn == "SWEGNN")
        if type_gnn != "SWEGNN":
            assert pg2 is pg                          # a baseline has no cached path
        pg = pg2
    if prepared:
        jg = jax.jit(jax_prepare, static_argnums=1)(jparams, jcfg, jg)
    want = np.asarray(JAX_APPLY(jparams, jcfg, jg))
    with torch.no_grad():
        got = port_gnn.apply_gnn(pparams, pcfg, pg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (want[:, 0] > 0).any() and np.all(got[pg.node_mask.numpy() == 0] == 0)


def test_apply_gnn_band_plan_matches_jax(bench_single):
    """A band plan of the single scale (min_nodes 128 plans the 16x16 graph)
    sends the SWEGNN hops through the banded path; JAX runs its band kernel
    in interpret mode."""
    jg, pg = bench_single
    jg, pg = jax_attach(jg, min_nodes=128), port_attach(pg, min_nodes=128)
    assert pg.band_meta is not None and pg.band_meta[0] is not None
    jcfg, jparams, pcfg, pparams = model_pair(jg, "SWEGNN", seed=1, previous_t=3)
    want = np.asarray(JAX_APPLY(jparams, jcfg, jg))
    with torch.no_grad():
        got = port_gnn.apply_gnn(pparams, pcfg, pg).numpy()
        ell = port_gnn.apply_gnn(pparams, pcfg, pg.replace(band_plan=None,
                                                           band_meta=None)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, ell, rtol=1e-6, atol=1e-6)


def test_apply_gnn_bf16_matches_jax(single):
    jg, pg = single
    jcfg, jparams, pcfg, pparams = model_pair(jg, "SWEGNN", seed=2,
                                              compute_dtype="bfloat16")
    want = np.asarray(JAX_APPLY(jparams, jcfg, jg))
    with torch.no_grad():
        got = port_gnn.apply_gnn(pparams, pcfg, pg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("type_gnn", ["SWEGNN", "GAT"])
def test_gnn_rollout_matches_jax(single, type_gnn):
    jg, pg = single
    jcfg, jparams, pcfg, pparams = model_pair(jg, type_gnn, seed=3)
    want = np.asarray(jax.jit(jax_rollout, static_argnums=(0, 2, 4))(
        jax_gnn.apply_gnn, jparams, jcfg, jg, 4))
    got = port_rollout(port_gnn.apply_gnn, pparams, pcfg, pg, steps=4, device="cpu").numpy()
    assert got.shape == want.shape == (pg.num_nodes, 2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_gnn_train_step_matches_jax(single):
    """One pushforward loss of one rollout step and its gradients
    (multiscale=False, remat) and the port's ``train_step`` taking that
    step (K 1, one layer: the JAX gradient's compile is the cost here)."""
    jg, pg = without_subnormal_targets(*single)
    jcfg, jparams, pcfg, pparams = model_pair(jg, "SWEGNN", seed=4, n_gnn_layers=1, K=1)
    opt_kw = dict(batch_size=1, velocity_scaler=7.0)
    jopts = jax_train.TrainerOptions(**opt_kw)
    popts = port_train.TrainerOptions(remat=True, **opt_kw)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jax_train.pushforward_loss(jax_gnn.apply_gnn, p, jcfg, jg, 1, jopts,
                                             False)))(jparams)
    loss, grads = port_train.loss_and_grads(port_gnn.apply_gnn, pparams, pcfg, pg, 1,
                                            popts, False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = to_numpy_tree(grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(numpy_tree(want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)
    optimizer = port_train.make_optimizer(popts, steps_per_epoch=1)
    before = [p.clone() for p in tree_leaves(pparams)]
    _, _, step_loss = port_train.train_step(
        pparams, optimizer.init(pparams), pg, apply_fn=port_gnn.apply_gnn, cfg=pcfg,
        rollout_steps=1, opts=popts, multiscale=False, optimizer=optimizer, device="cpu")
    assert float(step_loss) == float(loss)
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(pparams)))


# ---------------------------------------------------------------- learned pooling

@pytest.fixture(scope="module")
def pooled():
    """MSGNN with learned pooling on the 2-scale 16x16 graph (one-layer
    MLPs: the JAX gradient's compile is the cost here), and a fixed random
    weight for every output."""
    jg, pg = sample_pair(previous_t=2, rollout_steps=4, index=3, num_scales=2)
    kw = dict(gnn_kw(jg, 2), num_scales=2, hid_features=8, K=1, mlp_layers=1,
              learned_residuals=True, with_WL=True, learned_pooling=True)
    pcfg = port_msgnn.MSGNNConfig(**kw)
    pparams = port_msgnn.init_msgnn(gen(8), pcfg)
    w = np.random.default_rng(9).normal(size=(pg.num_nodes, 2)).astype(np.float32)
    return jg, pg, jax_msgnn.MSGNNConfig(**kw), jax_tree(pparams), pcfg, pparams, w


def test_learned_pooling_matches_jax(pooled):
    """The forward, and the gradients of a weighted sum of its outputs, with
    the prepared cache on both sides: JAX then reduces over the transfer
    edges (msgnn.py:174-178, :198-199), as the port always does."""
    jg, pg, jcfg, jparams, pcfg, pparams, w = pooled

    def jax_fn(p, g):
        out = jax_msgnn.apply_msgnn(p, jcfg, jax_prepare(p, jcfg, g))
        return (out * w).sum(), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jparams, jg)
    work = jax.tree_util.tree_map(lambda a: a.detach().requires_grad_(True), pparams)
    got = port_msgnn.apply_msgnn(work, pcfg, port_prepare(work, pcfg, pg))
    grads = torch.autograd.grad((got * t(w)).sum(), tree_leaves(work))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    assert (np.asarray(want)[:, 0] > 0).mean() > 0.2
    for a, b in zip(grads, jax.tree_util.tree_leaves(want_g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)
    pool_leaves = jax.tree_util.tree_leaves(want_g["pooling_mlp"]["layers"])
    assert all(np.abs(np.asarray(leaf)).max() > 0 for leaf in pool_leaves)


# ---------------------------------------------------------------- registry, bridge

@pytest.mark.parametrize("model", [dict(model_type="GNN", type_GNN=k) for k in TYPES]
                         + [dict(model_type="MSGNN", learned_pooling=True)],
                         ids=list(TYPES) + ["MSGNN-learned_pooling"])
def test_build_model_and_bridge_match_jax(model):
    """``build_model`` over ``config.with_defaults``'s models group (which
    always adds ``learned_pooling`` and ``skip_connections``): the JAX
    config, the JAX tree layout and shapes; and the bridge, which carries
    JAX's weights over leaf by leaf and refuses a wrong shape or key."""
    models = {**jax_config.with_defaults({})["models"], "hid_features": 8, "K": 2, **model,
              "n_GNN_layers": 3}
    kw = dict(num_node_features=7, num_edge_features=2, num_scales=2, previous_t=2)
    jcfg, jparams, _ = jax_build_model(models, **kw)
    pcfg, pparams, _ = build_model(models, device="cpu", **kw)
    assert type(pcfg).__name__ == type(jcfg).__name__
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    assert {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__} == fields
    jtree = numpy_tree(jparams)
    ours = to_numpy_tree(pparams)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(jtree)
    assert count_params(pparams) == jax_count_params(jparams)
    back = to_numpy_tree(load_jax_params(jtree, pcfg, device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jtree)
    key = "pooling_mlp" if model["model_type"] == "MSGNN" else "node_decoder"
    jtree[key]["layers"][0]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=key):
        load_jax_params(jtree, pcfg, device="cpu")
    del jtree[key]
    with pytest.raises(ValueError, match="keys"):
        load_jax_params(jtree, pcfg, device="cpu")


@pytest.fixture(scope="module")
def pareto(bench_single):
    """configs/pareto_gnn.yaml's model at full width through the port's
    build_model (whose config equals JAX's: test_build_model_and_bridge_match_jax),
    on the 16x16 single-scale bench sample, with the weights build_model
    draws from the config's seed; JAX's tree is read by ``jax.eval_shape``
    of its init."""
    jg, pg = bench_single
    models = jax_config.with_defaults(jax_config.read_config(PARETO_GNN_CONFIG))["models"]
    pcfg, pparams, _ = build_model(models, device="cpu", **gnn_kw(jg, 3), num_scales=1)
    jcfg = jax_gnn.GNNConfig(**{f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__})
    jshapes = jax.eval_shape(lambda: jax_gnn.init_gnn(jax.random.PRNGKey(models["seed"]),
                                                      jcfg))
    return jg, pg, jcfg, jshapes, pcfg, pparams


def test_pareto_gnn_full_width_matches_jax(pareto):
    jg, pg, jcfg, jshapes, pcfg, pparams = pareto
    assert (pcfg.type_gnn, pcfg.hid_features, pcfg.K, pcfg.n_gnn_layers) == ("SWEGNN", 64,
                                                                              10, 2)
    assert jax_count_params(jshapes) == count_params(pparams) == 251_604
    jparams = jax_tree(pparams)
    assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(jshapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(jparams),
                                                  jax.tree_util.tree_leaves(jshapes)))
    want = np.asarray(JAX_APPLY(jparams, jcfg, jg))
    with torch.no_grad():
        got = port_gnn.apply_gnn(pparams, pcfg, pg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (want[:, 0] > 0).any()


# ---------------------------------------------------------------- the CLI

def test_gnn_micro_through_the_cli(tmp_path, monkeypatch):
    """A micro single-scale SWE-GNN config through the port's ``main``:
    ``train`` for 2 epochs and ``eval`` of its best checkpoint, on the CPU;
    a finite summary, the eval equal to the training one within 1e-5."""
    from tests.test_experiment import MICRO
    from mswe_gnn_tpu_torch import main as port_main

    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    cfg = copy.deepcopy(MICRO)
    cfg["models"].update(model_type="GNN", type_GNN="SWEGNN", n_GNN_layers=2, K=2)
    cfg["synthetic_data"]["num_scales"] = 1
    path = tmp_path / "gnn.yaml"
    path.write_text(json.dumps(cfg))          # JSON is YAML
    out = str(tmp_path / "run")
    assert port_main.main(["train", "--config", str(path), "--out", out,
                           "--device", "cpu"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        train_summary = json.load(f)
    assert all(np.isfinite(v) for v in train_summary.values())
    assert port_main.main(["eval", "--config", str(path), "--ckpt",
                           os.path.join(out, "best"), "--out", str(tmp_path / "eval"),
                           "--device", "cpu"]) == 0
    with open(tmp_path / "eval" / "summary.json") as f:
        eval_summary = json.load(f)
    for k, v in eval_summary.items():
        if k not in ("mean_prediction_time_s", "speed_up_vs_synthetic_solver_mean",
                     "speed_up_vs_synthetic_solver_std"):
            assert abs(train_summary[k] - v) < 1e-5, k
