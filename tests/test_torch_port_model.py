"""The port's model path against the JAX package's, on the same inputs and
the same JAX-initialised weights (loaded through compat/jax_params.py), with
the port on the CPU.

Tolerances (float32): one SWEGNN layer rtol 1e-5 / atol 1e-5, a whole MSGNN
forward and a 4-step rollout rtol 1e-5 / atol 1e-4. Both sides do the same
float32 operations; matmuls and the hop's slot sum run in another order.

bfloat16 (``compute_dtype``) is looser, atol 2e-2 on outputs of order 1-5:
the JAX slot loop rounds every partial hop sum to bf16 (``agg`` starts as
``zeros_like`` of the bf16 state, mswe_gnn_tpu/models/swegnn.py:452), while
the port's hop adds the D terms in float32 and rounds once, as the CUDA
kernel does; the differences, a few bf16 ulps per hop, feed 27 hops a step.
"""
import jax
import numpy as np
import pytest
import torch

from mswe_gnn_tpu.graph import build_edge_slot_table
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.models import swegnn as jax_swegnn
from mswe_gnn_tpu.training.rollout import rollout as jax_rollout
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.models import build_model, msgnn as port_msgnn
from mswe_gnn_tpu_torch.models import swegnn as port_swegnn
from mswe_gnn_tpu_torch.training.rollout import rollout as port_rollout
from tests.torch_port_common import numpy_tree, sample_pair

BENCH_MODEL = dict(hid_features=64, K=5, mlp_layers=3, learned_residuals=True,
                   with_WL=True, gnn_activation="tanh", mlp_activation="prelu")


def t(x):
    return torch.from_numpy(np.array(x))


def block_problem(rng, n_dst, n_src, e, f, fe, same_block):
    """Random block inputs with dry rows and an ELL in-edge table."""
    x_s = rng.normal(size=(n_src, f)).astype(np.float32)
    x_d = rng.normal(size=(n_src, f)).astype(np.float32)
    x_d[rng.random(n_src) < 0.5] = 0.0
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst, e)).astype(np.int32)
    ea = rng.normal(size=(e, fe)).astype(np.float32) if fe else None
    table, mask = build_edge_slot_table(np.stack([src, dst]), np.ones(e, np.float32),
                                        n_dst, round_to=4)
    if same_block:
        x_s_dst, x_d_dst = x_s, x_d
    else:
        x_s_dst = rng.normal(size=(n_dst, f)).astype(np.float32)
        x_d_dst = np.zeros((n_dst, f), np.float32)  # as after pooling
    return x_s, x_d, x_s_dst, x_d_dst, src, dst, ea, table, mask


@pytest.mark.parametrize("form,zero_flux", [
    pytest.param(form, zero, id=form + ("-zero_flux" if zero else ""))
    for zero in (False, True) for form in ("slot", "flat", "unpool")])
def test_swegnn_block_matches_jax(rng, form, zero_flux):
    """One SWEGNN layer with random biases, or (``zero_flux``) with a
    zero-flux edge; rtol 1e-5 / atol 1e-5."""
    f = 16
    if form == "unpool":
        kw = dict(edge_features=0, K=1, with_filter_matrix=False, with_gradient=False)
        prob = block_problem(rng, n_dst=96, n_src=30, e=96, f=f, fe=0, same_block=False)
    else:
        kw = dict(edge_features=5, K=3,
                  flat_hop_threshold=10 ** 9 if form == "flat" else 0)
        prob = block_problem(rng, n_dst=80, n_src=80, e=300, f=f, fe=5, same_block=True)
    cfg_kw = dict(static_node_features=f, dynamic_node_features=f, mlp_layers=3,
                  mlp_activation="prelu", **kw)
    jcfg = jax_swegnn.SWEGNNConfig(**cfg_kw)
    pcfg = port_swegnn.SWEGNNConfig(**cfg_kw)
    jparams = jax_swegnn.init_swegnn(jax.random.PRNGKey(3), jcfg)
    x_s, x_d, x_s_dst, x_d_dst, src, dst, ea, table, mask = prob
    same = form != "unpool"
    if zero_flux:
        # edge 0 joins two all-zero rows, has zero features, and the edge MLP
        # has no biases, so its flux is exactly 0 and its norm 0, which both
        # packages map to a zero flux (JAX swegnn.py:157-159, :211-213)
        for layer in jparams["edge_mlp"]["layers"]:
            if "b" in layer:
                layer["b"] = jax.numpy.zeros_like(layer["b"])
        x_s[src[0]] = x_d[src[0]] = 0.0
        x_s_dst[dst[0]] = x_d_dst[dst[0]] = 0.0
        if ea is not None:
            ea[0] = 0.0
    pparams = jax.tree_util.tree_map(lambda a: t(a), numpy_tree(jparams))
    if zero_flux:
        slot = [k for k in range(table.shape[1])
                if table[dst[0], k] == 0 and mask[dst[0], k]]
        flux = port_swegnn._edge_flux_slots(
            pparams, pcfg, t(x_s), t(x_d), t(x_s_dst), t(x_d_dst),
            t(src[table]).int(), t(ea[table]) if ea is not None else None, t(mask))
        assert len(slot) == 1 and torch.all(flux[dst[0], slot[0]] == 0)
        zero_real = (flux.abs().sum(-1) == 0) & (t(mask) > 0)
        assert torch.isfinite(flux).all() and int(zero_real.sum()) == 1   # edge 0 alone
    want = np.asarray(jax_swegnn.apply_swegnn_block(
        jparams, jcfg, x_s, x_d, x_s_dst, x_d_dst, src, dst, edge_attr=ea,
        same_block=same, agg_table=table, agg_mask=mask))
    got = port_swegnn.apply_swegnn_block(
        pparams, pcfg, t(x_s), t(x_d), t(x_s_dst), t(x_d_dst), t(src), t(dst),
        edge_attr=t(ea) if ea is not None else None, same_block=same,
        agg_table=t(table).long(), agg_mask=t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want == 0).all(axis=1).any() or form == "unpool"   # dry rows stay dry


@pytest.fixture(scope="module")
def bench_width():
    """A 16x16 sample and JAX weights of the bench model (F=64, K=5,
    mlp_layers=3, prelu/tanh, with_WL, learned residuals), previous_t=3."""
    jg, pg = sample_pair(previous_t=3, rollout_steps=4, index=1)
    kw = dict(num_node_features=jg.x_static.shape[1] + jg.x_dynamic.shape[1],
              num_edge_features=jg.edge_attr.shape[1], num_scales=3,
              previous_t=3, **BENCH_MODEL)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(0), jax_msgnn.MSGNNConfig(**kw))
    return jg, pg, kw, jparams


@pytest.mark.parametrize("compute_dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_apply_msgnn_bench_width_matches_jax(bench_width, compute_dtype, atol):
    jg, pg, kw, jparams = bench_width
    jcfg = jax_msgnn.MSGNNConfig(compute_dtype=compute_dtype, **kw)
    pcfg = port_msgnn.MSGNNConfig(compute_dtype=compute_dtype, **kw)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    want = np.asarray(jax_msgnn.apply_msgnn(jparams, jcfg, jg))
    got = port_msgnn.apply_msgnn(pparams, pcfg, pg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    wet = want[:, 0] > 0
    assert wet.any() and (~wet).any()          # the wet front is inside the domain
    assert np.all(got[np.asarray(jg.node_mask) == 0] == 0)


@pytest.mark.parametrize("compute_dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_rollout_matches_jax(compute_dtype, atol):
    jg, pg = sample_pair(previous_t=2, rollout_steps=4, index=0)
    kw = dict(num_node_features=jg.x_static.shape[1] + jg.x_dynamic.shape[1],
              num_edge_features=jg.edge_attr.shape[1], num_scales=3, previous_t=2,
              hid_features=16, K=2, learned_residuals=True, with_WL=True,
              compute_dtype=compute_dtype)
    jcfg = jax_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(1), jcfg)
    pcfg = port_msgnn.MSGNNConfig(**kw)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    want = np.asarray(jax_rollout(jax_msgnn.apply_msgnn, jparams, jcfg, jg, steps=4))
    got = port_rollout(port_msgnn.apply_msgnn, pparams, pcfg, pg, steps=4,
                       device="cpu").numpy()
    assert got.shape == want.shape == (pg.num_nodes, 2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    assert (got >= 0).all() and np.all(got[pg.node_mask.numpy() == 0] == 0)


def test_jax_params_bridge_roundtrip_and_checks():
    kw = dict(num_node_features=6, num_edge_features=1, num_scales=3, previous_t=2,
              hid_features=8, K=2, learned_residuals=True, with_WL=True)
    jparams = numpy_tree(jax_msgnn.init_msgnn(jax.random.PRNGKey(0),
                                              jax_msgnn.MSGNNConfig(**kw)))
    pcfg = port_msgnn.MSGNNConfig(**kw)
    back = to_numpy_tree(load_jax_params(jparams, pcfg, device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jparams)
    jparams["node_decoder"]["layers"][0]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="node_decoder"):
        load_jax_params(jparams, pcfg, device="cpu")
    del jparams["node_decoder"]
    with pytest.raises(ValueError, match="keys"):
        load_jax_params(jparams, pcfg, device="cpu")


def test_build_model_init_matches_jax_layout():
    """The port's own initialisation: the JAX tree layout and shapes, the same
    distributions (torch.nn.Linear's uniform bound, PReLU 0.25, 'exp'
    residual weights), numbers from a torch.Generator seed."""
    kw = dict(num_node_features=6, num_edge_features=1, num_scales=3, previous_t=2)
    model = dict(model_type="MSGNN", hid_features=8, K=2, learned_residuals=True,
                 with_WL=True, mlp_layers=3)
    cfg, params, apply_fn = build_model(model, device="cpu", seed=5, **kw)
    assert apply_fn is port_msgnn.apply_msgnn
    jcfg = jax_msgnn.MSGNNConfig(**{k: v for k, v in model.items() if k != "model_type"}, **kw)
    jparams = numpy_tree(jax_msgnn.init_msgnn(jax.random.PRNGKey(0), jcfg))
    ours = to_numpy_tree(params)
    assert (jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(jparams))
    jax.tree_util.tree_map(lambda a, b: a.shape == b.shape or pytest.fail("shape"), ours, jparams)
    for lin in ours["gnn_processor"][0]["edge_mlp"]["layers"]:
        bound = 1.0 / np.sqrt(lin["w"].shape[0])
        assert np.abs(lin["w"]).max() <= bound and np.abs(lin["b"]).max() <= bound
    np.testing.assert_array_equal(ours["residual_weights"], jparams["residual_weights"])
    assert ours["gnn_processor"][0]["edge_mlp"]["acts"][0]["alpha"][0] == 0.25
    _, again, _ = build_model(model, device="cpu", seed=5, **kw)
    jax.tree_util.tree_map(np.testing.assert_array_equal, to_numpy_tree(again), ours)


def test_unported_paths_raise():
    """A model, layer or slope method that neither package knows raises
    ValueError. The single-scale GNN, learned pooling and the edge-major
    SWEGNN path are ported (tests/test_torch_port_gnn.py), and so are storm
    forcing and lstsq slopes (tests/test_torch_port_forcing.py,
    tests/test_torch_port_data.py) and vmap-stacked batches, whose loss is
    their union's (tests/test_torch_port_mesh.py)."""
    from mswe_gnn_tpu_torch.data import dataset as port_dataset
    from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate
    from mswe_gnn_tpu_torch.graph import concat_graphs, stack_graphs
    from mswe_gnn_tpu_torch.training import train as port_train

    kw = dict(num_node_features=6, num_edge_features=1, num_scales=3, previous_t=2)
    forced = port_generate(1, nx=8, ny=8, num_scales=2, total_hours=4, substeps=2,
                           storm=True)[0]
    assert forced.forcing.shape == (forced.mesh.num_nodes, 3, forced.wd.shape[1])
    sx, sy = port_dataset._node_slopes(forced.mesh, "lstsq")
    assert sx.shape == sy.shape == (forced.mesh.num_nodes,)
    with pytest.raises(ValueError, match="slope_method"):
        port_dataset._node_slopes(forced.mesh, "plane")
    _, g = sample_pair(previous_t=2, rollout_steps=2, index=0)
    cfg, params, apply_fn = build_model({"hid_features": 8}, device="cpu",
                                        **dict(kw, num_node_features=g.x_static.shape[1]
                                               + g.x_dynamic.shape[1],
                                               num_edge_features=g.edge_attr.shape[1]))
    h = g.replace(x_dynamic=g.x_dynamic * 1.1)
    losses = [port_train.pushforward_loss(apply_fn, params, cfg, batch([g, h]), 1,
                                          port_train.TrainerOptions(), True)
              for batch in (stack_graphs, concat_graphs)]
    assert torch.equal(*losses)
    with pytest.raises(ValueError, match="unknown model"):
        build_model({"model_type": "UNet"}, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown type_gnn"):
        build_model({"model_type": "GNN", "type_GNN": "GCN"}, device="cpu", **kw)
