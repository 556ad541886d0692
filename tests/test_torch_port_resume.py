"""The port's checkpoints, resume, heartbeat and batch tuner
(mswe_gnn_tpu_torch/training/{checkpoint,train}.py), on the CPU, port only
(JAX tests/test_resume_and_precision.py:15, :42 and :113).

On the CPU a train step is deterministic, so resuming is held bit for bit:
fit(3) equals fit(2), an autosave, a resume into a new Trainer and one more
epoch, in parameters, optimizer state and history.
"""
import os

import numpy as np
import pytest
import torch

from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.training import train as port_train
from mswe_gnn_tpu_torch.training.checkpoint import (restore_checkpoint, restore_params_only,
                                                    save_checkpoint)
from tests.torch_port_common import GEN_KW, port_generate, temporal_samples

OPTS = dict(batch_size=2, max_epochs=4, curriculum_epoch=2, max_rollout_steps=2,
            learning_rate=1e-3)


@pytest.fixture(scope="module")
def setup():
    _, graphs = temporal_samples(port_dataset, port_generate(2, **GEN_KW), previous_t=2,
                                 rollout_steps=2)
    g = graphs[0]
    cfg, params, apply_fn = build_model(
        {"hid_features": 8, "K": 1, "learned_residuals": True, "with_WL": True},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=2, device="cpu")
    return graphs[:4], graphs[4:6], cfg, params, apply_fn


def trainer(setup, **kw):
    train, val, cfg, params, apply_fn = setup
    return port_train.Trainer(apply_fn, cfg, params, port_train.TrainerOptions(**OPTS),
                              train, val, device="cpu", **kw)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def state_of(t):
    return t.optimizer.state_tree(t.opt_state, t.params)


@pytest.fixture(scope="module")
def fitted(setup, tmp_path_factory):
    """A Trainer fitted 3 epochs, autosaving after epoch 2 into its
    checkpoint directory."""
    ckpt = str(tmp_path_factory.mktemp("resume") / "autosave")
    tr = trainer(setup, checkpoint_dir=ckpt, checkpoint_every=2)
    tr.fit(max_epochs=3)
    return tr, ckpt


def test_fit_resume_equals_uninterrupted_fit(setup, fitted):
    whole, ckpt = fitted
    for name in ("meta.json", "params.npz", "opt_state.npz", "heartbeat",
                 "best_val/meta.json", "best_val/params.npz"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    two = trainer(setup)
    two.fit(max_epochs=2)
    resumed = trainer(setup, checkpoint_dir=ckpt + "_next")
    assert resumed.resume(ckpt) == 2 and resumed.start_epoch == 2
    # the restored state is the saved one, bit for bit, on the caller's device
    assert_trees_equal(resumed.params, two.params)
    assert_trees_equal(state_of(resumed), state_of(two))
    assert resumed.opt_state["count"] == 4
    assert resumed.rng.bit_generator.state == two.rng.bit_generator.state
    assert [r["epoch"] for r in resumed.history] == [0, 1]
    history = resumed.fit(max_epochs=3)
    assert [r["epoch"] for r in history] == [0, 1, 2]
    assert_trees_equal(resumed.params, whole.params)
    assert_trees_equal(state_of(resumed), state_of(whole))
    assert_trees_equal(resumed.best_params, whole.best_params)
    for got, want in zip(history, whole.history):
        assert {k: v for k, v in got.items() if k != "epoch_time"} == \
            {k: v for k, v in want.items() if k != "epoch_time"}


def test_best_val_and_early_stop_state_survive_resume(setup, fitted, tmp_path):
    whole, ckpt = fitted
    first = trainer(setup)
    first.resume(ckpt)
    # the best parameters come from <autosave>/best_val: the global best
    assert_trees_equal(first.best_params, whole.best_params)
    first.best_val_csi = 0.75
    first.epochs_without_improvement = 7
    again = str(tmp_path / "autosave")
    first.save(again, 3)
    save_checkpoint(os.path.join(again, "best_val"), first.best_params, epoch=2,
                    extra={"best_metric": first.opts.best_metric, "best_score": 0.5,
                           "best_val_loss": 1.25})
    second = trainer(setup)
    assert second.resume(again) == 3
    assert_trees_equal(second.best_params, whole.best_params)
    assert second.best_val_loss == first.best_val_loss
    assert second.best_score == first.best_score
    assert second.best_val_csi == 0.75 and second.epochs_without_improvement == 7


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 4, generator=g), "b16": torch.randn(5, generator=g).bfloat16(),
            "layers": [{"n": torch.arange(6)}, {"s": torch.tensor(0.5)}]}
    save_checkpoint(str(tmp_path), tree, opt_state={"count": torch.tensor(3)}, epoch=4,
                    history=[{"epoch": 3, "train_loss": float("nan")}], extra={"k": 1})
    like = {"w": torch.zeros(3, 4), "b16": torch.zeros(5, dtype=torch.bfloat16),
            "layers": [{"n": torch.zeros(6, dtype=torch.int64)}, {"s": torch.tensor(0.0)}]}
    params, opt, meta = restore_checkpoint(str(tmp_path), like, {"count": torch.tensor(0)})
    assert_trees_equal(params, tree)
    assert int(opt["count"]) == 3
    assert meta["epoch"] == 4 and meta["k"] == 1 and np.isnan(meta["history"][0]["train_loss"])
    assert_trees_equal(restore_params_only(str(tmp_path), like), tree)
    with pytest.raises(ValueError, match="expected"):
        restore_params_only(str(tmp_path), {**like, "w": torch.zeros(4, 3)})


def test_tune_batch_size_stops_at_oom_and_reraises_other_errors(setup, monkeypatch):
    train, _, cfg, params, apply_fn = setup
    opts = port_train.TrainerOptions(max_rollout_steps=1)
    kw = dict(candidates=(1, 2, 4), reps=1, device="cpu")
    best, rates = port_train.tune_batch_size(apply_fn, cfg, params, train[:2], opts, **kw)
    assert best in (1, 2) and sorted(rates) == [1, 2] and all(r > 0 for r in rates.values())
    real_step = port_train.train_step

    def oom_above_1(params, opt_state, batch, **step_kw):
        if batch.num_graphs > 1:
            raise torch.cuda.OutOfMemoryError("probe")
        return real_step(params, opt_state, batch, **step_kw)

    monkeypatch.setattr(port_train, "train_step", oom_above_1)
    best, rates = port_train.tune_batch_size(apply_fn, cfg, params, train, opts, **kw)
    assert best == 1 and list(rates) == [1]

    def kernel_fails(*args, **step_kw):
        raise RuntimeError("hop kernel launch failed with CUDA error 1")

    monkeypatch.setattr(port_train, "train_step", kernel_fails)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_train.tune_batch_size(apply_fn, cfg, params, train, opts, **kw)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_trainer_holds_one_device_copy_of_the_samples(setup, batch_size):
    """The sample lists stay as given; the device holds one copy of each:
    the graphs one by one at batch 1 (a batch is the resident graph), one
    ``stack_graphs`` copy that the unions are gathered from above it."""
    train, val, cfg, params, apply_fn = setup
    opts = port_train.TrainerOptions(**{**OPTS, "batch_size": batch_size})
    t = port_train.Trainer(apply_fn, cfg, params, opts, train, val, device="cpu")
    assert all(a is b for a, b in zip(t.train_graphs, train))
    stacked, each = t._device_copy(t.train_graphs, batch_size)
    assert t._device_copy(t.train_graphs, batch_size)[0] is stacked
    batches = list(t._batches(t.train_graphs, batch_size, shuffle=False))
    assert len(batches) == len(train) // batch_size
    if batch_size == 1:
        assert stacked is None and all(b is g for b, g in zip(batches, each))
    else:
        assert each is None and stacked.x_static.shape[0] == len(train)
        assert all(b.num_graphs == batch_size for b in batches)
