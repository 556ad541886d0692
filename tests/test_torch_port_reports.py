"""The port's report figures (``utils/visualization.py``,
``SpatialAnalysis.save_reports`` and ``main.evaluate``'s render) against the
JAX package's, on the CPU, and the port without matplotlib.

Figures are compared artist by artist, not by pixels: each axes' title,
labels and limits, every collection's data array, offsets, colour limits and
path vertices, every line's x and y data and label. The plotted numbers are
the same numpy code on both sides, or FAT and CSI / F1 from torch float32
against jnp float32: within atol 1e-6. ``evaluate`` runs two different
forwards (the port's and JAX's on the same weights), so there only the files
written are compared, and the summaries at the CLI tests' 1e-5.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_simulation_record as jax_record
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_simulation_record as port_record
from mswe_gnn_tpu_torch.utils import analysis as port_analysis
from mswe_gnn_tpu_torch.utils import visualization as port_vis
from tests.torch_port_common import SCALER_KINDS, numpy_tree

plt = port_vis.require_matplotlib()
from matplotlib.collections import PathCollection  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

from mswe_gnn_tpu.utils import analysis as jax_analysis  # noqa: E402
from mswe_gnn_tpu.utils import visualization as jax_vis  # noqa: E402

ATOL = 1e-6
REPORT_FILES = {"csi_curves.png", "rollout_loss_box.png", "f1_curves.png",
                "execution_times_box.png", "mass_conservation.png"}
RENDER_FILES = {f"{kind}_{label}.png" for kind in ("rollout", "fat", "csi_f1", "froude",
                                                  "conservation")
                for label in ("best", "worst")} | {"rollout_best.gif",
                                                   "rollout_best_multiscale.gif"}
# the 11 files tests/test_data_components.py::test_evaluate_writes_full_report_set
# expects of the JAX package
EXPECTED_EVAL_FILES = {"csi_curves.png", "f1_curves.png", "execution_times_box.png",
                       "rollout_best.png", "rollout_worst.png", "fat_best.png",
                       "csi_f1_best.png", "froude_best.png", "conservation_best.png",
                       "rollout_best.gif", "rollout_best_multiscale.gif"}


def artists(fig) -> list:
    """What ``fig`` plots, axes by axes, as plain numbers and strings."""
    out = []
    for ax in fig.axes:
        entry = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
                 "ylabel": ax.get_ylabel(), "ylim": np.asarray(ax.get_ylim()),
                 "yscale": ax.get_yscale(), "collections": [], "lines": [],
                 "ticklabels": [t.get_text() for t in ax.get_xticklabels()]}
        for c in ax.collections:
            arr = c.get_array()
            item = {"type": type(c).__name__,
                    "array": None if arr is None else np.ma.filled(
                        np.ma.asarray(arr, dtype=float), np.nan),
                    "offsets": np.asarray(c.get_offsets(), float),
                    "clim": np.asarray([np.nan if v is None else v for v in c.get_clim()],
                                       float),
                    "cmap": c.get_cmap().name}
            if not isinstance(c, PathCollection):
                item["paths"] = [np.asarray(p.vertices, float) for p in c.get_paths()]
            entry["collections"].append(item)
        for line in ax.get_lines():
            entry["lines"].append({"x": np.asarray(line.get_xdata(), float),
                                   "y": np.asarray(line.get_ydata(), float),
                                   "label": line.get_label()})
        out.append(entry)
    return out


def assert_same_plot(got, want, where=""):
    """Two ``artists`` results: strings equal, numbers within ATOL (NaN
    where NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same_plot(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_plot(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, where
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True,
                                   err_msg=where)
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def rollout_record():
    """One 8x8, 2-scale record of each package (the same arrays) and the
    pred / real of tests/test_data_components.py:195-215."""
    kw = dict(nx=8, ny=8, num_scales=2, total_hours=5, substeps=2)
    jrec, prec = jax_record(1, **kw), port_record(1, **kw)
    np.testing.assert_array_equal(prec.wd, jrec.wd)
    np.testing.assert_array_equal(prec.mesh.meshes[0].face_xy, jrec.mesh.meshes[0].face_xy)
    pred = np.stack([jrec.wd, np.abs(jrec.vx) * jrec.wd], 1)   # all scales
    return jrec, prec, pred, pred * 0.9


def _plot_rollouts(rollout_record):
    jrec, prec, pred, real = rollout_record
    return (jax_vis.PlotRollout(jrec.mesh, pred, real, temporal_res=60.0),
            port_vis.PlotRollout(prec.mesh, pred, real, temporal_res=60.0))


PANELS = {
    "frame": lambda pr, T: pr.frame(T // 2),
    "frame_q": lambda pr, T: pr.frame(T - 1, variable=1),
    "fat_comparison": lambda pr, T: pr.fat_comparison(),
    "scales_plot": lambda pr, T: pr.scales_plot(),
    "csi_f1_panel": lambda pr, T: pr.csi_f1_panel(),
    "froude_map": lambda pr, T: pr.froude_map(),
    "conservation_panel": lambda pr, T: pr.conservation_panel(
        np.random.default_rng(0).normal(size=T - 1), inflow_series=np.ones(T - 1)),
}


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_plot_rollout_panels_match_jax(rollout_record, panel):
    jpr, ppr = _plot_rollouts(rollout_record)
    T = rollout_record[2].shape[-1]
    want = PANELS[panel](jpr, T)
    got = PANELS[panel](ppr, T)
    try:
        assert isinstance(got, Figure)
        assert len(got.axes) == len(want.axes) > 0
        assert_same_plot(artists(got), artists(want), panel)
    finally:
        plt.close(got)
        plt.close(want)


@pytest.mark.parametrize("fn", ["plot_dem", "plot_quiver", "plot_map"])
def test_map_functions_match_jax(rollout_record, fn):
    jrec, prec, pred, _ = rollout_record
    figs = []
    for mod, rec in ((port_vis, prec), (jax_vis, jrec)):
        fig, ax = plt.subplots()
        mesh = rec.mesh.meshes[0]
        if fn == "plot_dem":
            mod.plot_dem(mesh, ax=ax, breach_xy=mesh.face_xy[:2])
        elif fn == "plot_quiver":
            mod.plot_quiver(mesh, rec.vx[:mesh.num_faces, 3], rec.vy[:mesh.num_faces, 3],
                            ax=ax, stride=3)
        else:
            mod.plot_map(mesh, pred[:mesh.num_faces, 0, 2], ax=ax, title="h", vmin=0,
                         mask_zero=True)
        figs.append(fig)
    try:
        assert_same_plot(artists(figs[0]), artists(figs[1]), fn)
    finally:
        for fig in figs:
            plt.close(fig)


def test_videos_like_jax(rollout_record, tmp_path):
    """Both write GIFs of as many frames; an ``.mp4`` path becomes a
    ``.gif`` where ffmpeg is missing, on both sides."""
    from matplotlib import animation
    from PIL import Image

    jpr, ppr = _plot_rollouts(rollout_record)
    T = rollout_record[2].shape[-1]
    ext = ".mp4" if not animation.writers.is_available("ffmpeg") else ".gif"
    for name, pr in (("jax", jpr), ("port", ppr)):
        a = pr.create_video(str(tmp_path / f"{name}_v{ext}"), fps=2)
        b = pr.create_multiscale_video(str(tmp_path / f"{name}_ms{ext}"), fps=2)
        assert a == str(tmp_path / f"{name}_v.gif") and b == str(tmp_path / f"{name}_ms.gif")
        for p in (a, b):
            with Image.open(p) as im:
                assert im.n_frames == T, p
    assert not plt.get_fignums()


def _full_rollout_graphs(ds, records):
    scalers = ds.fit_dataset_scalers(records, SCALER_KINDS)
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes),
                                       pad_multiple=8) for r in records])
    return [ds.to_temporal_samples(ds.process_record(r, scalers), spec, previous_t=2,
                                   rollout_steps=-1)[0] for r in records]


@pytest.fixture(scope="module")
def report_inputs():
    """Two 8x8 records of each package (tests/test_data_components.py:219-251),
    their full-rollout test graphs, and the same noisy predictions for both
    (subnormal targets zeroed: XLA on the CPU flushes them)."""
    import jax.numpy as jnp

    kw = dict(nx=8, ny=8, num_scales=2, total_hours=4, substeps=2)
    jrecs = [jax_record(s, **kw) for s in range(2)]
    precs = [port_record(s, **kw) for s in range(2)]
    jgs = _full_rollout_graphs(jax_dataset, jrecs)
    pgs = _full_rollout_graphs(port_dataset, precs)
    tiny = np.finfo(np.float32).tiny
    jgs = [g.replace(y=jnp.asarray(np.where(np.abs(np.asarray(g.y)) < tiny, 0,
                                            np.asarray(g.y)))) for g in jgs]
    pgs = [g.replace(y=torch.from_numpy(np.asarray(j.y).copy())) for g, j in zip(pgs, jgs)]
    rng = np.random.default_rng(5)
    preds = [(np.maximum(g.y.numpy() + rng.normal(0, 0.05, g.y.shape), 0)
              * g.node_mask.numpy()[:, None, None]).astype(np.float32) for g in pgs]
    return jrecs, precs, jgs, pgs, preds


@pytest.fixture
def captured_figures(monkeypatch):
    """``Figure.savefig`` records what each saved figure plots, by file name."""
    seen = {}
    save = Figure.savefig

    def savefig(self, fname, *a, **k):
        seen[os.path.basename(str(fname))] = artists(self)
        return save(self, fname, *a, **k)

    monkeypatch.setattr(Figure, "savefig", savefig)
    return seen


@pytest.mark.parametrize("times", [True, False])
def test_save_reports_matches_jax(report_inputs, captured_figures, tmp_path, times):
    """The same rollouts and graphs through both ``SpatialAnalysis``: the
    same files (``execution_times_box.png`` only with prediction times),
    each non-empty, plotting the same numbers."""
    _, _, jgs, pgs, preds = report_inputs
    kw = (dict(prediction_times=[0.5, 0.25], numerical_times=[3.0, 2.0],
               solver_label="synthetic_solver") if times else {})
    plotted = {}
    for name, analysis, graphs in (("jax", jax_analysis, jgs), ("port", port_analysis, pgs)):
        out = tmp_path / name
        analysis.SpatialAnalysis(preds, graphs, **kw).save_reports(str(out))
        files = set(os.listdir(out))
        assert files == REPORT_FILES - (set() if times else {"execution_times_box.png"})
        assert all((out / f).stat().st_size > 0 for f in files)
        plotted[name] = dict(captured_figures)
        captured_figures.clear()
    assert set(plotted["port"]) == set(plotted["jax"])
    for f in plotted["jax"]:
        assert_same_plot(plotted["port"][f], plotted["jax"][f], f)
    assert not plt.get_fignums()


def test_evaluate_writes_jax_report_set(report_inputs, tmp_path):
    """``evaluate`` with ``test_records`` on both sides, from the same
    weights (tests/test_data_components.py:219-251: MSGNN F=8, K=1): the
    same files, the 11 of the JAX test among them, each non-empty; the
    summaries within 1e-5 (timings aside)."""
    from mswe_gnn_tpu import main as jax_main
    from mswe_gnn_tpu.models import build_model as jax_build
    from mswe_gnn_tpu.training.train import TrainerOptions
    from mswe_gnn_tpu_torch import main as port_main
    from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params
    from mswe_gnn_tpu_torch.models import build_model as port_build

    jrecs, precs, jgs, pgs, _ = report_inputs
    g = jgs[0]
    model = {"model_type": "MSGNN", "hid_features": 8, "K": 1}
    shapes = dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
                  num_edge_features=g.edge_attr.shape[1], num_scales=2, previous_t=2)
    jcfg, jparams, japply = jax_build(model, **shapes)
    pcfg, _, papply = port_build(model, device="cpu", **shapes)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    times = [r.solver_seconds for r in jrecs]
    want = jax_main.evaluate(japply, jcfg, jparams, jgs, TrainerOptions(batch_size=1),
                             out_dir=str(tmp_path / "jax"), numerical_times=times,
                             test_records=jrecs, solver_label="synthetic_solver")
    got = port_main.evaluate(papply, pcfg, pparams, pgs, out_dir=str(tmp_path / "port"),
                             numerical_times=times, test_records=precs,
                             solver_label="synthetic_solver", device="cpu")
    jfiles, pfiles = set(os.listdir(tmp_path / "jax")), set(os.listdir(tmp_path / "port"))
    assert pfiles == jfiles == REPORT_FILES | RENDER_FILES
    assert EXPECTED_EVAL_FILES <= pfiles
    assert all((tmp_path / "port" / f).stat().st_size > 0 for f in pfiles)
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "mean_prediction_time_s" and not k.startswith("speed_up"):
            assert abs(got[k] - v) < 1e-5, (k, got[k], v)
    assert not plt.get_fignums()


def test_ring_order_is_undone_before_drawing(report_inputs, monkeypatch, tmp_path):
    """Under ring_halo the test graphs and their rollouts are in ring order
    (``prepare_ring_graphs``, ``perm[new] = old``); ``_render_rollout_reports``
    hands ``PlotRollout`` every row back in its mesh's own order, as for the
    graphs never reordered. (JAX draws the ring-ordered rows at the mesh's
    cell centres: ROADMAP Queue 3.)"""
    from mswe_gnn_tpu_torch import main as port_main
    from mswe_gnn_tpu_torch.parallel.dist_train import prepare_ring_graphs

    _, precs, _, pgs, preds = report_inputs
    ring, perm = prepare_ring_graphs(pgs, 2)
    assert (perm[:precs[0].mesh.meshes[0].num_faces] != np.arange(
        precs[0].mesh.meshes[0].num_faces)).mean() > 0.5
    ring_preds = [p[perm] for p in preds]
    drawn = []

    class Recorder:
        def __init__(self, mesh, pred, real, temporal_res, node_ptr):
            drawn.append((pred, real))

        def __getattr__(self, name):
            return lambda *a, **k: None

    monkeypatch.setattr(port_main, "PlotRollout", Recorder)
    for graphs, rollouts, order in ((pgs, preds, None), (ring, ring_preds, perm)):
        analysis = port_analysis.SpatialAnalysis(rollouts, graphs)
        port_main._render_rollout_reports(analysis, rollouts, graphs, precs, str(tmp_path),
                                          order)
    assert len(drawn) == 4
    for (pred, real), (want_pred, want_real) in zip(drawn[2:], drawn[:2]):
        np.testing.assert_array_equal(pred, want_pred)
        np.testing.assert_array_equal(real, want_real)
    assert port_main.mesh_order(preds[0], None) is preds[0]


def test_without_matplotlib(monkeypatch, tmp_path, capsys, report_inputs):
    """matplotlib hidden: ``PlotRollout``, ``plot_map`` and ``save_reports``
    raise an ImportError that names it; a CPU ``eval`` through ``main``
    prints the skip line once, writes ``summary.json`` and no figure."""
    from mswe_gnn_tpu_torch import config as port_config
    from mswe_gnn_tpu_torch import main as port_main
    from mswe_gnn_tpu_torch.training.checkpoint import save_checkpoint
    from tests.test_experiment import MICRO

    _, precs, _, pgs, preds = report_inputs
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    cfg = port_config.with_defaults(MICRO)
    _, params, _ = port_main.build_experiment_model(cfg, port_main.prepare_data(cfg)[2][0],
                                                    device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), params)
    path = tmp_path / "micro.yaml"
    path.write_text(json.dumps(MICRO))             # JSON is YAML

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port_vis.PlotRollout(precs[0].mesh, preds[0], preds[0])
    with pytest.raises(ImportError, match="matplotlib"):
        port_vis.plot_map(precs[0].mesh.meshes[0], preds[0][:, 0, 0])
    with pytest.raises(ImportError, match="matplotlib"):
        port_analysis.SpatialAnalysis(preds, pgs).save_reports(str(tmp_path / "r"))
    assert not (tmp_path / "r").exists()
    capsys.readouterr()
    assert port_main.main(["eval", "--config", str(path), "--ckpt", str(tmp_path / "ckpt"),
                           "--out", str(tmp_path / "eval"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(port_main.FIGURES_SKIPPED) == 1
    assert os.listdir(tmp_path / "eval") == ["summary.json"]
