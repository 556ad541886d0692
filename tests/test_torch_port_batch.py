"""Concat batching in the port (graph.concat_graphs, stack_graphs,
DeviceConcatPlan, the union through the model, the loss, the rollout,
eval_step and the Trainer) against the JAX package, on the CPU.

The inputs are the synthetic 16x16, 3-scale samples of
``tests/torch_port_common.py`` (previous_t=2, 2 rollout steps), the weights
JAX-initialised and converted through ``compat/jax_params.py``; the targets'
subnormal entries are 0 for both packages (XLA on the CPU flushes them).

Tolerances:
- unions, tiled specs and device-assembled unions: bit-equal (the same
  numpy remaps; the device plan's closed form gives the same ids);
- the union's forward and rollout: f32 atol 1e-4, against JAX's
  single-block hop and against its per-graph chunk path forced by
  ``HOP_CHUNK_TARGET_ROWS = 1`` (the port always hops the union whole);
- the union's pushforward loss with the conservation term: rtol 1e-5, its
  gradients within 1e-4 * max|leaf| + 1e-6 of ``jax.grad``;
- ``eval_step(per_graph=True)``, per-graph conservation residuals and
  ``watch_norms``: rtol 1e-5 / atol 1e-5 (float32 sums in another order);
- a 2-epoch ``Trainer.fit`` at batch 2 with a ragged tail against the JAX
  ``Trainer``'s history: losses rtol 1e-4, metrics atol 1e-4 (two epochs
  of optimizer updates on float32 gradients summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import graph as jax_graph
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.models import swegnn as jax_swegnn
from mswe_gnn_tpu.training import loss as jax_loss
from mswe_gnn_tpu.training import rollout as jax_rollout
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu_torch import graph as port_graph
from mswe_gnn_tpu_torch import tree_map
from mswe_gnn_tpu_torch.bench_problem import build_bench_sample
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan as port_attach
from mswe_gnn_tpu_torch.training import loss as port_loss
from mswe_gnn_tpu_torch.training import rollout as port_rollout
from mswe_gnn_tpu_torch.training import train as port_train
from tests.torch_port_common import (GEN_KW, jax_generate, numpy_tree, port_generate,
                                     temporal_samples, without_subnormal_targets)


@pytest.fixture(scope="module")
def samples():
    """(JAX samples, port samples) of one record with 2 rollout steps, and
    the same with 4 (for rollouts and validation)."""
    jrecs, precs = jax_generate(2, **GEN_KW), port_generate(2, **GEN_KW)
    _, jg = temporal_samples(jax_dataset, jrecs, previous_t=2, rollout_steps=2)
    _, pg = temporal_samples(port_dataset, precs, previous_t=2, rollout_steps=2)
    pairs = [without_subnormal_targets(a, b) for a, b in zip(jg, pg)]
    _, jfull = temporal_samples(jax_dataset, jrecs, previous_t=2, rollout_steps=4)
    _, pfull = temporal_samples(port_dataset, precs, previous_t=2, rollout_steps=4)
    full = [without_subnormal_targets(a, b) for a, b in zip(jfull, pfull)]
    return ([a for a, _ in pairs], [b for _, b in pairs],
            [a for a, _ in full], [b for _, b in full])


def model_pair(g, hid=8, K=2):
    kw = dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1], num_scales=3,
              previous_t=g.previous_t, hid_features=hid, K=K, learned_residuals=True,
              with_WL=True)
    jcfg, pcfg = jax_msgnn.MSGNNConfig(**kw), port_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, pcfg, load_jax_params(numpy_tree(jparams), pcfg, device="cpu")


def assert_graphs_equal(port, jax_like):
    """Every tensor field of a port graph bit-equal to the other graph's
    (JAX or port), and the static fields equal."""
    compared = 0
    for f in dataclasses.fields(port_graph.FloodGraph):
        got = getattr(port, f.name)
        want = getattr(jax_like, f.name)
        if isinstance(got, torch.Tensor):
            want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
            assert got.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
            compared += 1
        elif f.name == "spec":
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
        elif f.name not in ("ell_cache", "band_plan"):
            assert got == want, f.name
    assert compared >= 20


@pytest.mark.parametrize("b", [1, 3])
def test_concat_graphs_and_tile_match_jax(samples, b):
    jg, pg, _, _ = samples
    ju, pu = jax_graph.concat_graphs(jg[:b]), port_graph.concat_graphs(pg[:b])
    assert pu.num_graphs == ju.num_graphs == b
    assert (dataclasses.astuple(pg[0].spec.tile(b))
            == dataclasses.astuple(jg[0].spec.tile(b)) == dataclasses.astuple(pu.spec))
    assert_graphs_equal(pu, ju)
    if b == 1:
        assert pu is pg[0]
    # a banded sample batches into an all-ELL union, as in JAX
    banded = port_attach(build_bench_sample(16, 16, 4)[0], min_nodes=128)
    assert banded.band_meta is not None
    union = port_graph.concat_graphs([banded] * b)
    assert (union.band_plan is None and union.band_meta is None) == (b > 1)
    assert union.finest_slice() == union.spec.node_slice(0)
    assert pu.to("cpu").num_graphs == pu.replace(y=None).num_graphs == b


def test_concat_graphs_refuses_mixed_batches(samples):
    _, pg, _, _ = samples
    other = dataclasses.replace(pg[0].spec, num_bc=pg[0].spec.num_bc + 8)
    with pytest.raises(ValueError, match="GraphSpec"):
        port_graph.concat_graphs([pg[0], pg[1].replace(spec=other)])
    with pytest.raises(ValueError, match="static settings"):
        port_graph.concat_graphs([pg[0], pg[1].replace(previous_t=3)])
    with pytest.raises(ValueError, match="static settings"):
        port_graph.stack_graphs([pg[0], pg[1].replace(bc_kind=1)])


def test_device_concat_plan_matches_concat_graphs(samples):
    """DeviceConcatPlan over the stack_graphs container equals the host
    union, repeated indices included; b=1 gives the sample (JAX
    tests/test_device_concat.py:25-76)."""
    _, pg, _, _ = samples
    stacked = port_graph.stack_graphs(pg[:5])
    assert stacked.x_static.shape == (5,) + tuple(pg[0].x_static.shape)
    plan = port_graph.DeviceConcatPlan(pg[0].spec, 3)
    for idx in ([0, 1, 2], [2, 0, 1], [1, 1, 3], [4, 4, 4]):
        assert_graphs_equal(plan(stacked, np.asarray(idx)),
                            port_graph.concat_graphs([pg[i] for i in idx]))
    one = port_graph.DeviceConcatPlan(pg[0].spec, 1)(stacked, [3])
    assert_graphs_equal(one, pg[3])
    with pytest.raises(ValueError, match="shape"):
        plan(stacked, [0, 1])


@pytest.mark.parametrize("chunked", [False, True])
def test_union_forward_matches_jax(samples, monkeypatch, chunked):
    """apply_msgnn on a 3-graph union against JAX's, with JAX's hop over
    the whole block and with its per-graph chunk path forced; each graph's
    rows also equal the port's forward of that graph alone."""
    jg, pg, _, _ = samples
    jcfg, jparams, pcfg, pparams = model_pair(pg[0], hid=16, K=2)
    ju, pu = jax_graph.concat_graphs(jg[:3]), port_graph.concat_graphs(pg[:3])
    if chunked:
        monkeypatch.setattr(jax_swegnn, "HOP_CHUNK_TARGET_ROWS", 1)
        assert jax_swegnn._hop_chunks(3 * 264, 3 * 264, 3) == 3
    # traced after the monkeypatch, so the chunk setting takes effect
    want = np.asarray(jax.jit(lambda p, g: jax_msgnn.apply_msgnn(p, jcfg, g))(jparams, ju))
    got = port_msgnn.apply_msgnn(pparams, pcfg, pu).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    spec = pg[0].spec
    for gi in range(3):
        single = port_msgnn.apply_msgnn(pparams, pcfg, pg[gi]).numpy()
        for s in range(3):
            lo = pu.spec.node_ptr[s] + gi * spec.node_counts[s]
            np.testing.assert_allclose(got[lo:lo + spec.node_counts[s]],
                                       single[spec.node_slice(s)], rtol=0, atol=1e-5)


def test_union_rollout_matches_jax(samples):
    """The rollout of a 2-graph union (bc_window and inject_bc on the union's
    BC arrays) against JAX's, and each graph's rows against its own
    rollout."""
    _, _, jfull, pfull = samples
    jcfg, jparams, pcfg, pparams = model_pair(pfull[0])
    ju, pu = jax_graph.concat_graphs(jfull[:2]), port_graph.concat_graphs(pfull[:2])
    steps = 3
    np.testing.assert_array_equal(port_rollout.bc_window(pu, 1).numpy(),
                                  np.asarray(jax_rollout.bc_window(ju, 1)))
    got = port_rollout.rollout(port_msgnn.apply_msgnn, pparams, pcfg, pu, steps,
                               device="cpu").numpy()
    want = np.asarray(jax_rollout.rollout(jax_msgnn.apply_msgnn, jparams, jcfg, ju, steps))
    assert got.shape == (pu.num_nodes, 2, steps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    spec = pfull[0].spec
    single = port_rollout.rollout(port_msgnn.apply_msgnn, pparams, pcfg, pfull[1], steps,
                                  device="cpu").numpy()
    for s in range(3):
        lo = pu.spec.node_ptr[s] + spec.node_counts[s]
        np.testing.assert_allclose(got[lo:lo + spec.node_counts[s]],
                                   single[spec.node_slice(s)], rtol=0, atol=1e-5)


def test_union_conservation_residual_is_per_graph(samples, rng):
    jg, pg, _, _ = samples
    ju, pu = jax_graph.concat_graphs(jg[:3]), port_graph.concat_graphs(pg[:3])
    pred = np.abs(rng.normal(0.3, 0.2, (pu.num_nodes, 1))).astype(np.float32)
    bc_now = np.asarray(jax_rollout.bc_step_inflow(ju, 0))
    np.testing.assert_array_equal(port_rollout.bc_step_inflow(pu, 0).numpy(), bc_now)
    inp = pu.x_dynamic[:, -2:-1]
    got = port_loss.conservation_residual(torch.from_numpy(pred), inp, pu,
                                          torch.from_numpy(bc_now.copy()))
    want = np.asarray(jax_loss.conservation_residual(jnp.asarray(pred), ju.x_dynamic[:, -2:-1],
                                                     ju, jnp.asarray(bc_now)))
    assert got.shape == (3,) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_union_pushforward_loss_and_grads_match_jax(samples):
    """One pushforward loss over a 3-graph union with the conservation term
    on, and its gradients, against jax.grad (float32, 2 steps, remat)."""
    jg, pg, _, _ = samples
    jcfg, jparams, pcfg, pparams = model_pair(pg[0], hid=8, K=1)
    ju, pu = jax_graph.concat_graphs(jg[2:5]), port_graph.concat_graphs(pg[2:5])
    opt_kw = dict(batch_size=3, velocity_scaler=7.0, conservation=0.5)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jax_train.pushforward_loss(jax_msgnn.apply_msgnn, p, jcfg, ju, 2,
                                             jax_train.TrainerOptions(**opt_kw), True)))(jparams)
    loss, grads = port_train.loss_and_grads(port_msgnn.apply_msgnn, pparams, pcfg, pu, 2,
                                            port_train.TrainerOptions(remat=True, **opt_kw),
                                            True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = to_numpy_tree(grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(numpy_tree(want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)


def test_eval_step_per_graph_matches_jax(samples):
    _, _, jfull, pfull = samples
    jcfg, jparams, pcfg, pparams = model_pair(pfull[0])
    ju, pu = jax_graph.concat_graphs(jfull[:3]), port_graph.concat_graphs(pfull[:3])
    steps = int(pu.y.shape[-1])
    want = jax_train.eval_step(jparams, ju, apply_fn=jax_msgnn.apply_msgnn, cfg=jcfg,
                               steps=steps, opts=jax_train.TrainerOptions(),
                               multiscale=True, per_graph=True)
    got = port_train.eval_step(pparams, pu, apply_fn=port_msgnn.apply_msgnn, cfg=pcfg,
                               steps=steps, opts=port_train.TrainerOptions(),
                               multiscale=True, per_graph=True, device="cpu")
    assert set(got) == set(want)
    assert got["per_graph_CSI_005"].shape == (3,) and got["per_graph_loss"].shape == (3, 2)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=1e-5, atol=1e-5)


def test_watch_norms_match_jax(samples):
    _, pg, _, _ = samples
    _, jparams, _, pparams = model_pair(pg[0])
    jprev = jax.tree_util.tree_map(lambda x: x * 0.9, jparams)
    pprev = tree_map(lambda x: x * 0.9, pparams)
    want = jax_train.watch_norms(jparams, jprev)
    got = port_train.watch_norms(pparams, pprev)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    assert port_train.watch_norms(pparams, prefix="w").keys() == \
        jax_train.watch_norms(jparams, prefix="w").keys()


def test_trainer_fit_batch_2_matches_jax(samples):
    """2 epochs at batch 2: 5 training samples (the ragged tail dropped), the
    same shuffle order; the port assembles its batches on the device
    (DeviceConcatPlan), the JAX Trainer on the host (the same unions, one
    compile less)."""
    jg, pg, jfull, pfull = samples
    jcfg, jparams, pcfg, pparams = model_pair(pg[0], hid=8, K=1)
    kw = dict(batch_size=2, max_epochs=2, curriculum_epoch=0, max_rollout_steps=2,
              learning_rate=1e-3, seed=7)
    jt = jax_train.Trainer(jax_msgnn.apply_msgnn, jcfg, jparams,
                           jax_train.TrainerOptions(**kw), jg[:5], jfull[:2],
                           device_dataset=False)
    pt = port_train.Trainer(port_msgnn.apply_msgnn, pcfg, pparams,
                            port_train.TrainerOptions(**kw), pg[:5], pfull[:2],
                            device="cpu")
    want, got = jt.fit(), pt.fit()
    assert pt.opt_state["count"] == 4 and pt.steps_per_epoch == 2
    assert [r["rollout_steps"] for r in got] == [r["rollout_steps"] for r in want] == [2, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        for k in ("val_loss", "val_CSI_005", "val_CSI_03"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy_tree(pt.params)),
                    jax.tree_util.tree_leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)
