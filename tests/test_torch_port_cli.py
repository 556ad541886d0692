"""The port's experiment CLI (``mswe_gnn_tpu_torch/main.py``) and what it
stands on (``config.py``, ``utils/metrics.py``, ``utils/analysis.py``,
``utils/logging.py``, ``data/npz_store.py``) against the JAX package's, on the
CPU.

Tolerances: the config and the host-side metrics are the same numpy or
float32 code, compared exactly or within 1e-6 relative (``get_velocity`` and
``get_froude`` run in torch and in XLA); ``SpatialAnalysis.summary()`` on the
same rollouts within 1e-6 relative (float32 sums in another order);
``run_training`` of tests/test_experiment.py's ``MICRO`` from the same
JAX-initialised weights: the same history keys, losses within 1e-4 relative
(two epochs of float32 training, each step's sums in another order);
``run_eval`` of the same weights: the summary within 1e-5 absolute, as
tests/test_experiment.py holds JAX's eval against its training summary.
"""
import copy
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import config as jax_config
from mswe_gnn_tpu import main as jax_main
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu.training.checkpoint import restore_params_only as jax_restore
from mswe_gnn_tpu.utils import analysis as jax_analysis
from mswe_gnn_tpu.utils import metrics as jax_metrics
from mswe_gnn_tpu_torch import config as port_config
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.npz_store import load_records, save_records
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate
from mswe_gnn_tpu_torch.training.checkpoint import save_checkpoint
from mswe_gnn_tpu_torch.utils import analysis as port_analysis
from mswe_gnn_tpu_torch.utils import metrics as port_metrics
from mswe_gnn_tpu_torch.utils.logging import MetricLogger
from tests.test_experiment import MICRO
from tests.torch_port_common import GEN_KW, SCALER_KINDS, numpy_tree
from tests.torch_port_convert import JAX_BEST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMING_KEYS = ("mean_prediction_time_s", "speed_up_vs_synthetic_solver_mean",
               "speed_up_vs_synthetic_solver_std")


@pytest.mark.parametrize("cfg", [{}, {"models": {"K": 9}, "extra": 3},
                                 {"temporal_test_dataset_parameters": {"previous_t": 5}}])
def test_config_matches_jax(cfg):
    assert port_config.DEFAULTS == jax_config.DEFAULTS
    full = port_config.with_defaults(cfg)
    assert full == jax_config.with_defaults(cfg)
    assert (port_config.temporal_test_parameters(full)
            == jax_config.temporal_test_parameters(full))
    dotted = {"models.K": 3, "lr_info.gamma": 0.5, **cfg}
    assert port_config.fix_dotted_keys(dotted) == jax_config.fix_dotted_keys(dotted)


@pytest.fixture(scope="module")
def wd_series():
    rng = np.random.default_rng(0)
    wd = np.maximum(rng.normal(0.1, 0.3, (40, 9)), 0).astype(np.float32)
    wd[:, 0] = 0.0
    wd[3, 0] = 0.4          # the wet front starts at node 3
    return wd


@pytest.mark.parametrize("name", ["wd_to_fat", "get_velocity", "get_froude", "get_speed_up",
                                  "get_sufficient_k_hops",
                                  "get_sufficient_k_hops_per_scale"])
def test_metrics_match_jax(wd_series, name):
    wd = wd_series
    q = np.abs(np.random.default_rng(1).normal(0, 0.5, wd.shape)).astype(np.float32)
    chain = np.stack([np.arange(39), np.arange(1, 40)])
    edge_index = np.concatenate([chain, chain[::-1]], axis=1)
    # two scales: nodes 0..20 and 21..39, each a chain both ways
    scales_ei = np.concatenate([chain[:, :20], chain[::-1, :20],
                                chain[:, 21:], chain[::-1, 21:]], axis=1)
    calls = {
        "wd_to_fat": lambda m: m.wd_to_fat(wd, 120.0, water_threshold=0.05, time_start=2),
        "get_velocity": lambda m: m.get_velocity(*(_arr(m, x) for x in (q, wd))),
        "get_froude": lambda m: m.get_froude(*(_arr(m, x) for x in (q, wd))),
        "get_speed_up": lambda m: m.get_speed_up(np.array([3.0, 5.0]), np.array([0.5, 2.0])),
        "get_sufficient_k_hops": lambda m: m.get_sufficient_k_hops(edge_index, wd),
        "get_sufficient_k_hops_per_scale": lambda m: m.get_sufficient_k_hops_per_scale(
            scales_ei, wd, [0, 40, 76], [0, 21, 40]),
    }
    got, want = calls[name](port_metrics), calls[name](jax_metrics)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-6)


def _arr(module, x):
    return torch.from_numpy(x) if module is port_metrics else jax.numpy.asarray(x)


def test_pareto_front_matches_jax():
    pts = np.random.default_rng(2).random((30, 2))
    for asc in (False, True):
        np.testing.assert_array_equal(port_analysis.get_pareto_front(pts, asc),
                                      jax_analysis.get_pareto_front(pts, asc))


def full_rollout_graphs(ds, records):
    """One full-rollout test graph per record (scalers fit on all)."""
    scalers = ds.fit_dataset_scalers(records, SCALER_KINDS)
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 8)
                          for r in records])
    return [ds.to_temporal_samples(ds.process_record(r, scalers), spec, previous_t=2,
                                   rollout_steps=-1)[0] for r in records]


def test_spatial_analysis_summary_matches_jax():
    """The same three rollouts (targets with noise, some rows dry) through
    both SpatialAnalysis: every summary value within 1e-6 relative."""
    kw = dict(GEN_KW, peak_discharge=400.0)
    jgs = full_rollout_graphs(jax_dataset, jax_generate(3, **kw))
    pgs = full_rollout_graphs(port_dataset, port_generate(3, **kw))
    rng = np.random.default_rng(3)
    preds = []
    for g in pgs:
        y = g.y.numpy()
        y = np.where(np.abs(y) < np.finfo(np.float32).tiny, 0, y)   # XLA flushes subnormals
        p = np.maximum(y + rng.normal(0, 0.05, y.shape), 0) * g.node_mask.numpy()[:, None, None]
        preds.append(p.astype(np.float32))
    jgs = [g.replace(y=jax.numpy.asarray(np.where(
        np.abs(np.asarray(g.y)) < np.finfo(np.float32).tiny, 0, np.asarray(g.y)))) for g in jgs]
    pgs = [g.replace(y=torch.from_numpy(np.asarray(j.y).copy())) for g, j in zip(pgs, jgs)]
    kw = dict(prediction_times=[0.5, 0.25, 0.125], numerical_times=[3.0, 2.0, 1.0],
              solver_label="synthetic_solver")
    want = jax_analysis.SpatialAnalysis(preds, jgs, **kw)
    got = port_analysis.SpatialAnalysis(preds, pgs, **kw)
    ws, gs = want.summary(), got.summary()
    assert set(gs) == set(ws)
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=1e-6, atol=1e-9, err_msg=k)
    assert ws["test_CSI_005"] > 0.5 and ws["test_mass_conservation_abs"] > 0
    assert got.ranking() == want.ranking()
    np.testing.assert_allclose(got.inflow_volume_series(1), want.inflow_volume_series(1),
                               rtol=1e-6)


def test_npz_store_and_corpus_digest(tmp_path):
    """Records round-trip the npz cache bit for bit, and the corpus digest
    of the port's records is the JAX records' (the same arrays)."""
    kw = dict(GEN_KW, nx=10, ny=10, total_hours=4, substeps=2, mesh_type="triangulated")
    recs = port_generate(2, **kw)
    path = tmp_path / "recs.npz"
    save_records(str(path), recs)
    back = load_records(str(path))
    digest = port_main.corpus_digest(recs)
    assert port_main.corpus_digest(back) == digest
    assert port_main.corpus_digest(jax_generate(2, **kw)) == digest
    assert port_main.corpus_digest(recs[:1]) != digest
    assert back[1].temporal_res == recs[1].temporal_res
    assert back[1].mesh.ghosts.type_bc == recs[1].mesh.ghosts.type_bc


# ---------------------------------------------------------------- run_training

def _history(out_dir):
    with open(os.path.join(out_dir, "best", "meta.json")) as f:
        return json.load(f)["history"]


@pytest.fixture(scope="module")
def micro_runs(tmp_path_factory):
    """MICRO through both packages' run_training from the same weights (JAX's
    initialisation, kept as JAX's run builds its model and handed to the
    port as ``saved_model``), and the port's run_eval of JAX's best weights,
    converted. Neither package's report figures are drawn: they change no
    number, and tests/test_torch_port_reports.py holds them."""
    base = tmp_path_factory.mktemp("micro")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSWE_DATA_CACHE", str(base / "cache"))
        mp.setattr(jax_main, "_render_rollout_reports", lambda *a, **k: None)
        mp.setattr(jax_analysis.SpatialAnalysis, "save_reports", lambda self, out: None)
        mp.setattr(port_main, "_render_rollout_reports", lambda *a, **k: None)
        mp.setattr(port_analysis.SpatialAnalysis, "save_reports", lambda self, out: None)
        init = {}
        build = jax_main.build_experiment_model

        def keep_initial_weights(cfg, sample):
            model = build(cfg, sample)
            init.update(template=model[1], numpy=numpy_tree(model[1]))
            return model

        mp.setattr(jax_main, "build_experiment_model", keep_initial_weights)
        jsum = jax_main.run_training(MICRO, str(base / "jax"))
        cfg = jax_config.with_defaults(MICRO)
        pcfg, _, _ = port_main.build_experiment_model(
            cfg, port_main.prepare_data(cfg)[0][0], device="cpu")
        save_checkpoint(str(base / "init"), load_jax_params(init["numpy"], pcfg,
                                                            device="cpu"))
        psum = port_main.run_training(dict(copy.deepcopy(MICRO),
                                           saved_model=str(base / "init")),
                                      str(base / "port"), device="cpu")
        jbest = load_jax_params(
            numpy_tree(jax_restore(str(base / "jax" / "best"), init["template"])),
            pcfg, device="cpu")
        save_checkpoint(str(base / "jax_best_port"), jbest)
        peval = port_main.run_eval(MICRO, str(base / "jax_best_port"),
                                   str(base / "port_eval"), device="cpu")
        pown = port_main.run_eval(MICRO, str(base / "port" / "best"),
                                  str(base / "port_own_eval"), device="cpu")
    return base, jsum, psum, peval, pown


def test_run_training_matches_jax(micro_runs):
    """History keys equal, losses within 1e-4 relative."""
    base, jsum, psum, _, _ = micro_runs
    jhist, phist = _history(base / "jax"), _history(base / "port")
    assert len(phist) == len(jhist) == 2
    for jr, pr in zip(jhist, phist):
        assert set(pr) == set(jr)
        assert pr["epoch"] == jr["epoch"] and pr["rollout_steps"] == jr["rollout_steps"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(pr[k], jr[k], rtol=1e-4, err_msg=k)
        for k in ("val_CSI_005", "val_CSI_03"):
            np.testing.assert_allclose(pr[k], jr[k], atol=1e-4, err_msg=k)
    assert set(psum) == set(jsum)
    for name in ("best", "last", "autosave", "metrics.jsonl", "metrics.csv", "config.json",
                 "summary.json"):
        assert os.path.exists(base / "port" / name), name
    with open(base / "port" / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


def test_run_eval_of_the_same_weights_matches_jax(micro_runs):
    """The port's run_eval of JAX's best weights against JAX's evaluation of
    them (its run_training summary): within 1e-5."""
    base, jsum, _, peval, _ = micro_runs
    assert set(peval) | {"n_params"} == set(jsum)
    for k, v in peval.items():
        if k not in TIMING_KEYS:
            assert abs(jsum[k] - v) < 1e-5, (k, v, jsum[k])
    assert all(np.isfinite(v) for v in peval.values())
    with open(base / "port_eval" / "summary.json") as f:
        assert json.load(f)["test_MAE_WD"] == peval["test_MAE_WD"]


def test_run_eval_reproduces_the_training_summary(micro_runs):
    """As tests/test_experiment.py holds JAX: the port's eval of its own
    best checkpoint gives its training summary, within 1e-5."""
    _, _, psum, _, pown = micro_runs
    for k, v in pown.items():
        if k not in TIMING_KEYS:
            assert abs(psum[k] - v) < 1e-5, k


def test_triangulated_micro_through_the_cli(tmp_path, monkeypatch):
    """MICRO on triangulated meshes through ``main``: an epoch budget of 1
    exits 75 after epoch 0, a relaunch resumes from the autosave and
    finishes, appending to metrics.jsonl, and ``eval`` of its best
    checkpoint gives the training summary within 1e-5."""
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    cfg = copy.deepcopy(MICRO)
    cfg["synthetic_data"].update(mesh_type="triangulated", nx=16, ny=16)
    cfg["trainer_options"]["eval_batch_size"] = 2
    cfg["synthetic_data"]["n_sims"] = 8
    path = tmp_path / "tri.yaml"
    path.write_text(json.dumps(cfg))          # JSON is YAML
    out = str(tmp_path / "run")
    args = ["train", "--config", str(path), "--out", out, "--device", "cpu"]
    assert port_main.main(args + ["--epoch-budget", "1"]) == port_main.EXIT_RELAUNCH
    assert not os.path.exists(os.path.join(out, "best"))
    assert port_main.main(args) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    with open(os.path.join(out, "summary.json")) as f:
        train_summary = json.load(f)
    assert port_main.main(["eval", "--config", str(path), "--ckpt",
                           os.path.join(out, "best"), "--out", str(tmp_path / "eval"),
                           "--device", "cpu"]) == 0
    with open(tmp_path / "eval" / "summary.json") as f:
        eval_summary = json.load(f)
    for k, v in eval_summary.items():
        if k not in TIMING_KEYS:
            assert abs(train_summary[k] - v) < 1e-5, k
    assert len(load_records(next(str(p) for p in (tmp_path / "cache").iterdir()))) == 8


@pytest.mark.parametrize("what", ["sweep", "dataset_folder", "map_folder", "parallel",
                                  "orbax", "wandb"])
def test_unported_cli_options_raise(tmp_path, monkeypatch, what):
    if what == "sweep":
        # sweep mode is ported (tests/test_torch_port_wandb.py): without a
        # --sweep-id it is a usage error
        with pytest.raises(SystemExit):
            port_main.main(["sweep", "--device", "cpu"])
    elif what in ("dataset_folder", "map_folder"):
        # both data paths are ported now (tests/test_torch_port_data.py): the
        # option reads its source, and a missing one raises
        cfg = port_config.with_defaults({"dataset_parameters": {
            what: "/nowhere", "train_dataset_name": "ds"}})
        with pytest.raises(FileNotFoundError, match="nowhere"):
            port_main.prepare_data(cfg)
    elif what == "parallel":
        # the data x graph mesh is ported (tests/test_torch_port_mesh.py): a
        # data-parallel block trains over the listed devices, and one
        # device is too few for it
        monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
        with pytest.raises(ValueError, match="need 2 devices"):
            port_main.run_training(dict(MICRO, parallel={"data": 2}), str(tmp_path),
                                   device="cpu")
        summary = port_main.run_training(dict(MICRO, parallel={"data": 2}),
                                         str(tmp_path / "mesh"), device="cpu,cpu")
        assert os.path.exists(os.path.join(tmp_path, "mesh", "best", "meta.json"))
        assert all(np.isfinite(v) for v in summary.values())
    elif what == "orbax":
        with pytest.raises(NotImplementedError, match="torch_port_convert"):
            port_main.restore_weights(os.path.join(ROOT, JAX_BEST), {})
    else:
        # wandb logging is ported (tests/test_torch_port_wandb.py): asking for
        # it where wandb cannot be imported raises an error that names it
        monkeypatch.setitem(sys.modules, "wandb", None)
        with pytest.raises(ImportError, match="wandb"):
            MetricLogger(str(tmp_path), use_wandb=True)
