"""The port's wandb wiring (``utils/logging.py::MetricLogger``, the
``Trainer``'s ``watch_fn``) and sweep mode (``main.run_sweep``, ``main
sweep``) against the JAX package's, on the CPU, under one fake ``wandb``
module (modelled on tests/test_logging_wandb.py; the real package is on
neither machine and is never initialised here).

Both loggers run under the same fake: the records logged, the summaries,
the ``init`` arguments and the histograms (names and values, from the same
weights) are held equal, time stamps aside; the sweep's merged trial
configs and trial directories are equal with ``run_training`` stubbed on
both sides. One real port trial at tests/test_experiment.py's micro config
shows the records reaching the agent's run and the ``Trainer`` calling
``watch_fn``.
"""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from mswe_gnn_tpu import main as jax_main
from mswe_gnn_tpu.models import build_model as jax_build
from mswe_gnn_tpu.utils import logging as jax_logging
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params
from mswe_gnn_tpu_torch.models import build_model as port_build
from mswe_gnn_tpu_torch.utils import logging as port_logging
from tests.test_experiment import MICRO
from tests.torch_port_common import numpy_tree

LOGGERS = {"jax": jax_logging.MetricLogger, "port": port_logging.MetricLogger}


class FakeRun:
    def __init__(self, sweep_id="sweep123", config=None, run_id="run0"):
        self.sweep_id = sweep_id
        self.config = dict(config or {})
        self.id = run_id
        self.logged = []
        self.summary = {}
        self.finished = False
        self.module = None

    def log(self, metrics, **kw):
        self.logged.append((dict(metrics), dict(kw)))

    def finish(self):
        self.finished = True
        if self.module is not None and self.module.run is self:
            self.module.run = None          # as wandb.finish() ends the live run


class Histogram:
    def __init__(self, values):
        self.values = np.asarray(values)


@pytest.fixture()
def fake_wandb(monkeypatch):
    """A ``wandb`` module whose ``init`` records its arguments and opens a
    run (a sweep run, with the next of ``trial_configs`` as its config,
    where there are any), and whose ``agent`` calls the trial function
    ``count`` times."""
    mod = types.ModuleType("wandb")
    mod.run = None
    mod.Histogram = Histogram
    mod.init_calls, mod.agent_calls, mod.runs, mod.trial_configs = [], [], [], []

    def init(**kw):
        mod.init_calls.append(kw)
        config = mod.trial_configs[len(mod.runs)] if mod.trial_configs else None
        mod.run = FakeRun(config=config, run_id=f"run{len(mod.runs)}")
        mod.run.module = mod
        mod.runs.append(mod.run)
        return mod.run

    def agent(sweep_id, function, count):
        mod.agent_calls.append((sweep_id, count))
        for _ in range(count):
            function()

    mod.init, mod.agent = init, agent
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def drive(logger_cls, out_dir, **kw):
    m = logger_cls(str(out_dir), **kw)
    m.log({"epoch": 0, "val_loss": 1.0, "val_CSI_005": 0.5})
    m.log({"epoch": 1, "val_loss": 0.75, "val_CSI_005": 0.625})
    m.summary({"test_CSI_005": 0.6, "n_params": 12})
    m.close()
    return m


@pytest.mark.parametrize("live", ["sweep", "unrelated", "none"])
def test_logger_attaches_like_jax(tmp_path, fake_wandb, live):
    """A sweep's live run receives the records and summaries and is not
    finished; an unrelated live run and no run receive nothing; no logger
    opens a run without ``use_wandb``."""
    seen = {}
    for name, cls in LOGGERS.items():
        fake_wandb.run = {"sweep": FakeRun(), "unrelated": FakeRun(sweep_id=None),
                          "none": None}[live]
        run = fake_wandb.run
        drive(cls, tmp_path / name, config={"a": 1})
        seen[name] = run
        with open(tmp_path / name / "metrics.jsonl") as f:
            assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    assert fake_wandb.init_calls == []
    if live == "none":
        return
    jrun, prun = seen["jax"], seen["port"]
    assert prun.logged == jrun.logged
    assert prun.summary == jrun.summary
    assert prun.finished == jrun.finished is False
    assert (len(prun.logged) == 2) == (live == "sweep")


@pytest.mark.parametrize("live", [False, True])
def test_use_wandb_like_jax(tmp_path, fake_wandb, live):
    """``use_wandb``: without a live run both call ``init`` with the same
    project and config and finish the run they opened; with a live (non
    sweep) run both attach to it and leave it open."""
    runs = {}
    for name, cls in LOGGERS.items():
        fake_wandb.run = FakeRun(sweep_id=None) if live else None
        drive(cls, tmp_path / name, use_wandb=True, wandb_project="floods",
              config={"models": {"K": 2}})
        runs[name] = fake_wandb.run if live else fake_wandb.runs[-1]
    jrun, prun = runs["jax"], runs["port"]
    assert prun.logged == jrun.logged and len(prun.logged) == 2
    assert prun.summary == jrun.summary
    assert prun.finished == jrun.finished == (not live)
    if live:
        assert fake_wandb.init_calls == []
    else:
        assert fake_wandb.init_calls == [{"project": "floods", "config": {"models": {"K": 2}}}] * 2


def test_use_wandb_default_project_like_jax(tmp_path, fake_wandb):
    for name, cls in LOGGERS.items():
        cls(str(tmp_path / name), use_wandb=True).close()
    assert fake_wandb.init_calls == [{"project": "mswe-gnn-tpu", "config": None}] * 2


def test_watch_histograms_match_jax(tmp_path, fake_wandb):
    """``watch`` on the same weights (JAX's initialisation, converted): the
    same ``watch/...`` names, one a leaf, and the same values, logged
    without a step."""
    model = {"model_type": "MSGNN", "hid_features": 8, "K": 1}
    shapes = dict(num_node_features=6, num_edge_features=3, num_scales=2, previous_t=2)
    _, jparams, _ = jax_build(model, **shapes)
    pcfg, _, _ = port_build(model, device="cpu", **shapes)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    logged = {}
    for name, cls, params in (("jax", LOGGERS["jax"], jparams),
                              ("port", LOGGERS["port"], pparams)):
        fake_wandb.run = FakeRun()
        m = cls(str(tmp_path / name))
        m.watch(params, step=3)
        m.close()
        (rec, kw), = fake_wandb.run.logged
        assert kw == {} and rec["epoch"] == 3
        logged[name] = rec
    assert list(logged["port"]) == list(logged["jax"])
    assert len(logged["port"]) == 1 + len(list(port_logging.tree_paths(pparams))) == 51
    for k, v in logged["jax"].items():
        if k != "epoch":
            assert v.values.dtype == logged["port"][k].values.dtype == np.float32
            np.testing.assert_array_equal(logged["port"][k].values, v.values, err_msg=k)


def test_watch_without_a_run_does_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    m = port_logging.MetricLogger(str(tmp_path))
    m.watch({"w": torch.ones(2)}, step=0)
    m.close()


def test_use_wandb_without_wandb_raises(tmp_path, monkeypatch):
    """wandb hidden: ``use_wandb=True`` raises an ImportError that names it
    (JAX goes on local-first there: a deliberate difference); without
    ``use_wandb`` both write their files."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="wandb"):
        port_logging.MetricLogger(str(tmp_path / "a"), use_wandb=True)
    assert not (tmp_path / "a").exists()
    for name, cls in LOGGERS.items():
        drive(cls, tmp_path / name)
        assert (tmp_path / name / "summary.json").exists()


TRIALS = [{"models.K": 5, "models.hid_features": 16, "trainer_options.watch_every": 1},
          {"models.K": 4, "lr_info.gamma": 0.5, "trainer_options.max_epochs": 3}]


def test_sweep_configs_match_jax(tmp_path, fake_wandb, monkeypatch):
    """The agent's dotted-key overrides, deep-merged over the base config:
    the same trial configs and ``trial_<run id>`` directories on both sides,
    every trial's run finished, the agent called with the id and count."""
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_main, "run_training",
                        lambda cfg, out: seen["jax"].append((cfg, os.path.relpath(
                            out, tmp_path / "jax"))))
    monkeypatch.setattr(port_main, "run_training",
                        lambda cfg, out, device=None: seen["port"].append((cfg, os.path.relpath(
                            out, tmp_path / "port"), device)))
    base = json.loads(json.dumps(MICRO))
    for name, run_sweep, kw in (("jax", jax_main.run_sweep, {}),
                                ("port", port_main.run_sweep, {"device": "cpu"})):
        fake_wandb.trial_configs = TRIALS
        fake_wandb.runs = []
        run_sweep(base, "ent/proj/abc", str(tmp_path / name), count=2, **kw)
        assert all(run.finished for run in fake_wandb.runs) and len(fake_wandb.runs) == 2
    assert fake_wandb.agent_calls == [("ent/proj/abc", 2)] * 2
    assert [s[:2] for s in seen["port"]] == seen["jax"]
    assert [s[2] for s in seen["port"]] == ["cpu", "cpu"]
    assert [s[1] for s in seen["jax"]] == ["trial_run0", "trial_run1"]
    assert seen["jax"][0][0]["models"] == {"hid_features": 16, "mlp_layers": 2, "K": 5}
    assert seen["jax"][1][0]["lr_info"] == {"gamma": 0.5}
    assert base == MICRO


def test_sweep_cli(tmp_path, fake_wandb, monkeypatch):
    """``main sweep``: ``--sweep-id`` and ``--count`` reach the agent and
    ``--device`` each trial; without ``--sweep-id`` it errors; under
    ``--dist-num-processes`` it raises and names the flag."""
    seen = []
    monkeypatch.setattr(port_main, "run_training",
                        lambda cfg, out, device=None: seen.append((out, device)))
    fake_wandb.trial_configs = TRIALS
    path = tmp_path / "micro.yaml"
    path.write_text(json.dumps(MICRO))
    args = ["sweep", "--config", str(path), "--out", str(tmp_path / "s"), "--device", "cpu"]
    assert port_main.main(args + ["--sweep-id", "e/p/x", "--count", "2"]) == 0
    assert fake_wandb.agent_calls == [("e/p/x", 2)]
    assert seen == [(str(tmp_path / "s" / f"trial_run{i}"), "cpu") for i in range(2)]
    with pytest.raises(SystemExit):
        port_main.main(args)
    with pytest.raises(ValueError, match="--dist-num-processes"):
        port_main.main(args + ["--sweep-id", "e/p/x", "--dist-num-processes", "2"])
    assert len(fake_wandb.agent_calls) == 1


def test_sweep_trial_on_cpu(tmp_path, fake_wandb, monkeypatch):
    """One real trial of the port at the micro config through ``main
    sweep``: every epoch's record reaches the agent's run, the ``Trainer``
    calls ``watch_fn`` on every epoch (histograms of every leaf, finite),
    the summary reaches the run, the run is finished and the trial's
    directory holds its checkpoint and summary."""
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    fake_wandb.trial_configs = [{"trainer_options.watch_every": 1, "models.K": 2}]
    path = tmp_path / "micro.yaml"
    path.write_text(json.dumps(MICRO))
    assert port_main.main(["sweep", "--config", str(path), "--sweep-id", "e/p/x",
                           "--out", str(tmp_path / "s"), "--device", "cpu"]) == 0
    run, = fake_wandb.runs
    assert run.finished
    records = [rec for rec, _ in run.logged if "train_loss" in rec]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all({"val_loss", "val_CSI_005", "watch/node_decoder_norm"} <= set(r)
               for r in records)
    hists = [rec for rec, _ in run.logged if any(k.startswith("watch/") and
                                                 isinstance(v, Histogram)
                                                 for k, v in rec.items())]
    assert [h["epoch"] for h in hists] == [0, 1]
    trial = tmp_path / "s" / "trial_run0"
    with open(trial / "config.json") as f:
        assert json.load(f)["models"]["K"] == 2
    with np.load(trial / "best" / "params.npz") as saved:
        n_leaves = len(saved.files)
    for h in hists:
        values = [v.values for k, v in h.items() if k.startswith("watch/")]
        assert len(values) == n_leaves and all(np.isfinite(v).all() for v in values)
    with open(trial / "summary.json") as f:
        summary = json.load(f)
    assert run.summary == pytest.approx(summary)
    assert (trial / "best" / "params.npz").exists()
