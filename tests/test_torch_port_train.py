"""The port's training path (mswe_gnn_tpu_torch/training/{loss,train}.py,
utils/metrics.py) against the JAX package, on the CPU.

The targets' subnormal entries are set to 0 for both packages
(``without_subnormal_targets``): XLA on the CPU flushes subnormals to zero.

Tolerances:
- loss pieces and metrics: rtol 1e-6 / atol 1e-6 (the same float32
  reductions, in another order);
- one ``pushforward_loss`` and its gradients against ``jax.grad``
  (JAX-initialised weights, 2 rollout steps, with and without a band
  plan): in float32 the loss within rtol 1e-5 and every gradient leaf
  within 1e-4 * max|leaf| + 1e-6 (the matmuls and the hop sums run in
  another order, through a 2-step unroll); in bfloat16 the loss within
  2e-2 and the global gradient cosine >= 0.99 (the JAX slot loop and band
  kernel round every hop term to bf16, the port adds in float32 and rounds
  once, and autograd rounds at other points than JAX's transposes);
- the optimizer on identical gradients against optax over 3 steps, the
  clip and the staircase included: atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.ops.band_hop import attach_band_plan as jax_attach
from mswe_gnn_tpu.training import loss as jax_loss
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu.utils import metrics as jax_metrics
from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
from mswe_gnn_tpu_torch.graph import stack_graphs
from mswe_gnn_tpu_torch.models import build_model, msgnn as port_msgnn
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan as port_attach
from mswe_gnn_tpu_torch.training import loss as port_loss
from mswe_gnn_tpu_torch.training import train as port_train
from mswe_gnn_tpu_torch.training.rollout import bc_step_inflow
from mswe_gnn_tpu_torch.utils import metrics as port_metrics
from tests.torch_port_common import (bench_sample_pair, numpy_tree, sample_pair,
                                     without_subnormal_targets)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    return without_subnormal_targets(*sample_pair(previous_t=2, rollout_steps=3, index=1))


# ---------------------------------------------------------------- loss and metrics

@pytest.mark.parametrize("type_loss", ["RMSE", "MAE"])
@pytest.mark.parametrize("only_where_water", [True, False])
@pytest.mark.parametrize("multiscale", [True, False])
def test_step_loss_sums_match_jax(pair, rng, type_loss, only_where_water, multiscale):
    jg, pg = pair
    n = pg.num_nodes
    preds = np.abs(rng.normal(size=(n, 2))).astype(np.float32)
    preds[rng.random(n) < 0.3] = 0.0
    target = np.asarray(jg.y[..., 0])
    bc_now = np.asarray(jax_train.bc_step_inflow(jg, 0))
    np.testing.assert_array_equal(bc_step_inflow(pg, 0).numpy(), bc_now)
    kw = dict(type_loss=type_loss, only_where_water=only_where_water,
              multiscale=multiscale, conservation=0.3)
    js, jc, jk = jax_loss.step_loss_sums(jnp.asarray(preds), jnp.asarray(target), jg,
                                         bc_now=jnp.asarray(bc_now), **kw)
    ps, pc, pk = port_loss.step_loss_sums(t(preds), t(target), pg, bc_now=t(bc_now), **kw)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    assert float(pc) == float(jc) > 0
    np.testing.assert_allclose(float(pk), float(jk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(port_loss.conservation_residual(t(preds[:, :1]), pg.x_dynamic[:, -2:-1], pg,
                                              t(bc_now))),
        float(jax_loss.conservation_residual(jnp.asarray(preds[:, :1]),
                                             jg.x_dynamic[:, -2:-1], jg,
                                             jnp.asarray(bc_now))), rtol=1e-5, atol=1e-6)
    sums = rng.random((3, 2)).astype(np.float32)
    counts = np.array([5.0, 0.0, 7.0], np.float32)
    cons = rng.normal(size=3).astype(np.float32)
    ckw = dict(type_loss=type_loss, velocity_scaler=7.0, conservation=0.5)
    np.testing.assert_allclose(
        float(port_loss.combine_batch_loss(t(sums), t(counts), t(cons), **ckw)),
        float(jax_loss.combine_batch_loss(jnp.asarray(sums), jnp.asarray(counts),
                                          jnp.asarray(cons), **ckw)), rtol=1e-6)
    with pytest.raises(ValueError):
        port_loss.masked_error_sums(t(preds), t(preds[:, 0] > 0), "L3")


@pytest.mark.parametrize("only_where_water", [True, False])
@pytest.mark.parametrize("type_loss", ["RMSE", "MAE"])
@pytest.mark.parametrize("batched", [False, True])
def test_metrics_match_jax(rng, type_loss, only_where_water, batched):
    shape = (2, 60, 2, 5) if batched else (60, 2, 5)
    pred = np.abs(rng.normal(0, 0.2, shape)).astype(np.float32)
    real = np.abs(rng.normal(0, 0.2, shape)).astype(np.float32)
    pred[..., :7, :, :] = 0.0                          # rows dry in both
    real[..., :7, :, :] = 0.0
    real[..., 0, 2] = 0.0                              # a dry step: CSI is NaN
    pred[..., 0, 2] = 0.0
    mask = (rng.random(shape[:-2]) < 0.9).astype(np.float32)
    args_j = (jnp.asarray(pred), jnp.asarray(real), jnp.asarray(mask))
    args_p = (t(pred), t(real), t(mask))
    np.testing.assert_allclose(
        port_metrics.get_rollout_loss(*args_p, type_loss=type_loss,
                                      only_where_water=only_where_water).numpy(),
        np.asarray(jax_metrics.get_rollout_loss(*args_j, type_loss=type_loss,
                                                only_where_water=only_where_water)),
        rtol=1e-6, atol=1e-6)
    for fn in ("get_csi", "get_f1"):
        for thr in (0.0, 0.05, 0.3):
            np.testing.assert_allclose(
                getattr(port_metrics, fn)(*args_p, water_threshold=thr).numpy(),
                np.asarray(getattr(jax_metrics, fn)(*args_j, water_threshold=thr)),
                rtol=1e-6, atol=1e-6)
    assert np.isnan(port_metrics.get_csi(*args_p).numpy()[..., 2]).all()   # the dry step


# ---------------------------------------------------------------- pushforward loss

@pytest.fixture(scope="module")
def bench_pair():
    """The bench problem's sample at 16x16, with and without the band plan
    (min_nodes 128 plans scales 0 and 1)."""
    jg, pg = bench_sample_pair(16, 16, 4)
    return {False: (jg, pg),
            True: (jax_attach(jg, min_nodes=128), port_attach(pg, min_nodes=128))}


def flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("band,compute_dtype,remat", [
    (False, "float32", False), (True, "float32", True), (True, "bfloat16", False)])
def test_pushforward_loss_and_grads_match_jax(bench_pair, band, compute_dtype, remat):
    jg, pg = bench_pair[band]
    assert (pg.band_meta is not None) == band
    kw = dict(num_node_features=jg.x_static.shape[1] + jg.x_dynamic.shape[1],
              num_edge_features=jg.edge_attr.shape[1], num_scales=3, previous_t=3,
              hid_features=16, K=2, learned_residuals=True, with_WL=True,
              compute_dtype=compute_dtype)
    jcfg = jax_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(2), jcfg)
    pcfg = port_msgnn.MSGNNConfig(**kw)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    opt_kw = dict(batch_size=1, velocity_scaler=7.0)
    jopts = jax_train.TrainerOptions(**opt_kw)
    popts = port_train.TrainerOptions(remat=remat, **opt_kw)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_train.pushforward_loss(jax_msgnn.apply_msgnn, p, jcfg, jg, 2, jopts,
                                             True))(jparams)
    loss, grads = port_train.loss_and_grads(port_msgnn.apply_msgnn, pparams, pcfg, pg, 2,
                                            popts, True)
    got = to_numpy_tree(grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(numpy_tree(want))
    if compute_dtype == "float32":
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)
    else:
        assert abs(float(loss) - float(want_loss)) <= 2e-2
        a, b = flat(got), flat(want)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99
    assert all(np.abs(leaf).max() > 0 for leaf in jax.tree_util.tree_leaves(got))


# ---------------------------------------------------------------- optimizer

def test_optimizer_matches_optax():
    """3 steps on identical gradients: clipped (norm > 1), unclipped, clipped;
    the staircase drops the rate at step 2 (step_size 1 x 2 steps an epoch);
    decoupled weight decay on."""
    rng = np.random.default_rng(0)
    opts = dict(learning_rate=3e-3, gamma=0.5, step_size=1, grad_clip=1.0,
                weight_decay=0.01)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": [rng.normal(size=5).astype(np.float32), np.float32([0.25])]}
    grads = [jax.tree_util.tree_map(lambda p: (scale * rng.normal(size=p.shape))
                                    .astype(np.float32), params)
             for scale in (2.0, 0.05, 3.0)]
    jopt = jax_train.make_optimizer(jax_train.TrainerOptions(**opts), steps_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(jp)
    popt = port_train.make_optimizer(port_train.TrainerOptions(**opts), steps_per_epoch=2)
    pp = {"a": {"w": t(params["a"]["w"]).clone()}, "b": [t(p).clone() for p in params["b"]]}
    pstate = popt.init(pp)
    assert [popt.lr(i) for i in range(3)] == [3e-3, 3e-3, 1.5e-3]
    for g in grads:
        updates, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        popt.update({"a": {"w": t(g["a"]["w"])}, "b": [t(x) for x in g["b"]]}, pstate, pp)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6),
            to_numpy_tree(pp), numpy_tree(jp))
    assert pstate["count"] == 3
    norms = [np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree_util.tree_leaves(g)))
             for g in grads]
    assert norms[0] > 1 > norms[1] and norms[2] > 1


def test_curriculum_matches_jax():
    for ce in (0, 3):
        kw = dict(curriculum_epoch=ce, max_rollout_steps=4)
        jo, po = jax_train.TrainerOptions(**kw), port_train.TrainerOptions(**kw)
        assert [port_train.curriculum_rollout_steps(e, po) for e in range(15)] == \
            [jax_train.curriculum_rollout_steps(e, jo) for e in range(15)]
    losses = [1.0, 0.5, 0.5, 0.5, 0.004, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    for mode in ("epoch", "loss", "plateau"):
        kw = dict(curriculum_epoch=2, max_rollout_steps=3)
        jc = jax_train.CurriculumController(jax_train.TrainerOptions(**kw), mode=mode,
                                            patience=2)
        pc = port_train.CurriculumController(port_train.TrainerOptions(**kw), mode=mode,
                                             patience=2)
        for epoch, loss in enumerate(losses):
            assert pc.on_epoch_start(epoch) == jc.on_epoch_start(epoch)
            pc.on_epoch_end(loss)
            jc.on_epoch_end(loss)


# ---------------------------------------------------------------- train step and trainer

@pytest.fixture(scope="module")
def small_data():
    records = generate_dataset(2, seed=0, nx=16, ny=16, num_scales=3, total_hours=12,
                               substeps=8)
    scalers = port_dataset.fit_dataset_scalers(records, {"area_scaler": "standard"})
    procs = [port_dataset.process_record(r, scalers) for r in records]
    spec = port_dataset.union_spec([port_dataset.make_spec(
        r.mesh, len(r.mesh.ghosts.ghost_nodes), 8) for r in records])
    train = port_dataset.to_temporal_samples(procs[0], spec, previous_t=2,
                                             rollout_steps=2)[:3]
    val = port_dataset.to_temporal_samples(procs[1], spec, previous_t=2, rollout_steps=-1)
    g = train[0]
    cfg, params, apply_fn = build_model(
        {"hid_features": 8, "K": 1, "learned_residuals": True, "with_WL": True},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=2, device="cpu")
    return train, val, cfg, params, apply_fn


def test_trainer_fit_two_epochs_on_cpu(small_data):
    train, val, cfg, params, apply_fn = small_data
    opts = port_train.TrainerOptions(batch_size=1, max_epochs=2, curriculum_epoch=1,
                                     max_rollout_steps=2, remat=True)
    before = port_train.clone_tree(params)
    trainer = port_train.Trainer(apply_fn, cfg, params, opts, train, val, device="cpu")
    history = trainer.fit()
    assert [r["epoch"] for r in history] == [0, 1]
    assert [r["rollout_steps"] for r in history] == [1, 2]
    for r in history:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
        assert 0.0 <= r["val_CSI_005"] <= 1.0 or np.isnan(r["val_CSI_005"])
    assert trainer.opt_state["count"] == 2 * len(train)
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(trainer.params),
                                                  tree_leaves(before))]
    assert all(moved)
    # the caller's parameters are untouched; the best copy is a copy
    for a, b in zip(tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b)
    assert trainer.best_score is not None


def test_train_step_and_unported_paths_raise(small_data, monkeypatch):
    train, val, cfg, params, apply_fn = small_data
    opts = port_train.TrainerOptions(batch_size=1)
    optimizer = port_train.make_optimizer(opts, 1)
    p = port_train.clone_tree(params)
    cached = prepare_graph(p, cfg, train[0])
    with pytest.raises(ValueError, match="ell_cache"):
        port_train.train_step(p, optimizer.init(p), cached, apply_fn=apply_fn, cfg=cfg,
                              rollout_steps=1, opts=opts, multiscale=True,
                              optimizer=optimizer, device="cpu")
    # the vmap layout is ported (tests/test_torch_port_mesh.py): a stacked
    # batch evaluates, an unknown layout raises
    with pytest.raises(ValueError, match="'concat' or 'vmap'"):
        port_train.Trainer(apply_fn, cfg, params, port_train.TrainerOptions(batch_size=2),
                           train, val, device="cpu", batch_layout="rows")
    metrics = port_train.eval_step(p, stack_graphs(val[:2]), apply_fn=apply_fn, cfg=cfg,
                                   steps=2, opts=opts, multiscale=True, device="cpu")
    assert np.isfinite(metrics["val_loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    step_kw = dict(apply_fn=apply_fn, cfg=cfg, opts=opts, multiscale=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):        # no device given
        port_train.Trainer(apply_fn, cfg, params, opts, train, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.train_step(p, optimizer.init(p), train[0], rollout_steps=1,
                              optimizer=optimizer, **step_kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.eval_step(p, val[0], steps=2, **step_kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.find_max_batch_size(apply_fn, cfg, params, train, opts)


def test_eval_step_matches_jax():
    jg, pg = without_subnormal_targets(*sample_pair(previous_t=2, rollout_steps=-1, index=0))
    kw = dict(num_node_features=jg.x_static.shape[1] + jg.x_dynamic.shape[1],
              num_edge_features=jg.edge_attr.shape[1], num_scales=3, previous_t=2,
              hid_features=8, K=2, learned_residuals=True, with_WL=True)
    jcfg = jax_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(1), jcfg)
    pparams = load_jax_params(numpy_tree(jparams), port_msgnn.MSGNNConfig(**kw), device="cpu")
    steps = int(pg.y.shape[-1])
    want = jax_train.eval_step(jparams, jg, apply_fn=jax_msgnn.apply_msgnn, cfg=jcfg,
                               steps=steps, opts=jax_train.TrainerOptions(),
                               multiscale=True)
    got = port_train.eval_step(pparams, pg, apply_fn=port_msgnn.apply_msgnn,
                               cfg=port_msgnn.MSGNNConfig(**kw), steps=steps,
                               opts=port_train.TrainerOptions(), multiscale=True,
                               device="cpu")
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-5)
