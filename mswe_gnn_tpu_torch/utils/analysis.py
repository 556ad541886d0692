"""Spatial / temporal evaluation harness over test rollouts (port of the
numeric part of mswe_gnn_tpu/utils/analysis.py).

Equivalent of the reference ``SpatialAnalysis``
(reference utils/miscellaneous.py:311-562): aggregates per-simulation rollout
errors, CSI/F1 curves in time, mass-conservation residuals, best/worst
ranking, prediction-time statistics and speed-up vs a numerical solver,
plus matplotlib report figures (``save_reports``; matplotlib is imported
there, and its absence raises an ImportError that names it). Multiscale
rollouts are restricted to the finest scale (reference
utils/miscellaneous.py:322-327). The metrics run in float32 on the CPU, as
the JAX package's do.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.training.loss import conservation_residual
from mswe_gnn_tpu_torch.utils.metrics import (get_csi, get_f1, get_rollout_loss,
                                              get_speed_up)


def get_pareto_front(points: np.ndarray, ascending: bool = False) -> np.ndarray:
    """Pareto front of a 2-objective array [n, 2]
    (reference utils/miscellaneous.py:245-264)."""
    order = np.lexsort((points[:, 1], points[:, 0]))
    if not ascending:
        order = order[::-1]
    sorted_pts = points[order]
    front = [sorted_pts[0]]
    for p in sorted_pts[1:]:
        if p[1] >= front[-1][1]:
            front.append(p)
    return np.asarray(front)


class SpatialAnalysis:
    def __init__(self, predicted_rollouts: Sequence[np.ndarray],
                 test_graphs: Sequence[FloodGraph],
                 prediction_times: Optional[Sequence[float]] = None,
                 numerical_times: Optional[Sequence[float]] = None,
                 thresholds: Sequence[float] = (0.05, 0.3),
                 solver_label: str = "solver"):
        if len(predicted_rollouts) != len(test_graphs):
            raise ValueError(f"{len(predicted_rollouts)} rollouts for "
                             f"{len(test_graphs)} test graphs")
        self.graphs = [g.to("cpu") for g in test_graphs]
        self.thresholds = tuple(thresholds)
        self.prediction_times = (list(prediction_times)
                                 if prediction_times is not None else None)
        self.numerical_times = (list(numerical_times)
                                if numerical_times is not None else None)
        # which solver produced numerical_times: 'dhydro' (real D-HYDRO wall
        # times, comparable with the reference's 242-1223x) or
        # 'synthetic_solver' (the built-in generator's own seconds, NOT
        # comparable; the label keeps the summary from being misread)
        self.solver_label = solver_label
        # restrict to the finest scale; float32 tensors for the metrics
        self.preds, self.reals, self.masks = [], [], []
        for pred, g in zip(predicted_rollouts, self.graphs):
            fs = g.spec.node_slice(0)
            self.preds.append(torch.from_numpy(np.ascontiguousarray(np.asarray(pred)[fs])))
            self.reals.append(g.y[fs])
            self.masks.append(g.node_mask[fs])

    def _per_sim(self, fn, **kw) -> np.ndarray:
        return np.stack([fn(p, r, m, **kw).numpy()
                         for p, r, m in zip(self.preds, self.reals, self.masks)])

    # --- scalar metrics -------------------------------------------------
    def rollout_losses(self, type_loss="MAE", only_where_water=True) -> np.ndarray:
        """Per-simulation [n_sims, 2] rollout errors
        (reference utils/miscellaneous.py:418-424)."""
        return self._per_sim(get_rollout_loss, type_loss=type_loss,
                             only_where_water=only_where_water)

    def csi_curves(self, threshold: float) -> np.ndarray:
        """[n_sims, T] CSI over time."""
        return self._per_sim(get_csi, water_threshold=threshold)

    def f1_curves(self, threshold: float) -> np.ndarray:
        return self._per_sim(get_f1, water_threshold=threshold)

    def mass_conservation_series(self) -> List[np.ndarray]:
        """Per-simulation signed conservation residual per step, 1e6 m^3
        (reference utils/miscellaneous.py:116-121)."""
        out = []
        for pred, g in zip(self.preds, self.graphs):
            T = pred.shape[-1]
            fs = g.spec.node_slice(0)
            series = []
            for t in range(1, T):
                # the injected value of rollout step t: the exact interval
                # inflow of zero-order-hold series (training's bc_step_inflow)
                bc_now = g.bc_values[:, g.previous_t + t - 1]
                full_prev = torch.zeros((g.num_nodes, 1), dtype=torch.float32)
                full_next = torch.zeros((g.num_nodes, 1), dtype=torch.float32)
                full_prev[fs] = pred[:, 0:1, t - 1]
                full_next[fs] = pred[:, 0:1, t]
                series.append(float(conservation_residual(full_next, full_prev, g, bc_now)))
            out.append(np.asarray(series))
        return out

    def inflow_volume_series(self, i: int) -> np.ndarray:
        """Per-step inflow volume [1e6 m^3] of simulation ``i`` (reference
        get_inflow_volume, utils/dataset.py:577-591)."""
        g = self.graphs[i]
        bc = g.bc_values.numpy()
        L = g.bc_edge_length.numpy() * g.bc_mask.numpy()
        T = self.preds[i].shape[-1]
        cols = [g.previous_t + t - 1 for t in range(1, T)]
        return np.asarray([(bc[:, c] * L).sum() * 60.0 * float(g.temporal_res)
                           for c in cols]) / 1e6

    def ranking(self) -> Dict[str, int]:
        """Best/worst simulation by water-depth rollout loss
        (reference main.py:171-181)."""
        losses = self.rollout_losses()[:, 0]
        return {"best": int(np.argmin(losses)), "worst": int(np.argmax(losses))}

    def summary(self) -> Dict[str, float]:
        losses = self.rollout_losses(type_loss="MAE")
        rmse = self.rollout_losses(type_loss="RMSE")
        out = {
            "test_MAE_WD": float(losses[:, 0].mean()),
            "test_MAE_Q": float(losses[:, 1].mean()),
            "test_RMSE_WD": float(rmse[:, 0].mean()),
            "test_RMSE_Q": float(rmse[:, 1].mean()),
        }
        for tau in self.thresholds:
            key = str(tau).replace("0.", "0")
            out[f"test_CSI_{key}"] = float(np.nanmean(self.csi_curves(tau)))
            out[f"test_F1_{key}"] = float(np.nanmean(self.f1_curves(tau)))
        cons = self.mass_conservation_series()
        out["test_mass_conservation_abs"] = float(
            np.mean([np.abs(c).mean() for c in cons]))
        if self.prediction_times:
            out["mean_prediction_time_s"] = float(np.mean(self.prediction_times))
            if self.numerical_times:
                mu, sd = get_speed_up(np.asarray(self.numerical_times),
                                      np.asarray(self.prediction_times))
                out[f"speed_up_vs_{self.solver_label}_mean"] = mu
                out[f"speed_up_vs_{self.solver_label}_std"] = sd
                if self.solver_label == "dhydro":
                    # only real solver timings give the reference-comparable keys
                    out["speed_up_mean"] = mu
                    out["speed_up_std"] = sd
        return out

    # --- figures --------------------------------------------------------
    def _curve_figure(self, plt, curves_of, name: str, color=None):
        style = {} if color is None else {"color": color}
        fig, axes = plt.subplots(1, len(self.thresholds), figsize=(11, 4))
        for ax, tau in zip(np.atleast_1d(axes), self.thresholds):
            curves = curves_of(tau)
            t = np.arange(curves.shape[1])
            mean, std = np.nanmean(curves, 0), np.nanstd(curves, 0)
            ax.plot(t, mean, marker="o", lw=2, **style)
            ax.fill_between(t, mean - std, mean + std, alpha=0.3, **style)
            ax.set_title(f"{name} @ {tau} m")
            ax.set_xlabel("rollout step")
            ax.set_ylim(0, 1)
        return fig

    def save_reports(self, out_dir: str) -> None:
        """The summary figures (JAX analysis.py:158-231): ``csi_curves.png``,
        ``rollout_loss_box.png``, ``f1_curves.png``,
        ``execution_times_box.png`` (where prediction times exist) and
        ``mass_conservation.png`` in ``out_dir``."""
        from mswe_gnn_tpu_torch.utils.visualization import require_matplotlib

        plt = require_matplotlib()
        os.makedirs(out_dir, exist_ok=True)

        def save(fig, name):
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, name), dpi=120)
            plt.close(fig)

        save(self._curve_figure(plt, self.csi_curves, "CSI"), "csi_curves.png")

        losses = self.rollout_losses()
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.boxplot([losses[:, 0], losses[:, 1]], tick_labels=["h [m]", "|q| [m2/s]"])
        ax.set_title("rollout MAE per simulation")
        save(fig, "rollout_loss_box.png")

        # F1 curves, the companion of the CSI ones
        save(self._curve_figure(plt, self.f1_curves, "F1", color="tab:green"),
             "f1_curves.png")

        # surrogate against numerical execution times (reference
        # SpatialAnalysis :311-562: the speed-up at a glance)
        if self.prediction_times:
            cols, labels = [np.asarray(self.prediction_times)], ["surrogate"]
            if self.numerical_times and np.asarray(self.numerical_times).max() > 0:
                cols.append(np.asarray(self.numerical_times))
                labels.append("numerical solver")
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.boxplot(cols, tick_labels=labels)
            ax.set_yscale("log")
            ax.set_ylabel("seconds per simulation")
            ax.set_title("execution time: surrogate vs numerical")
            save(fig, "execution_times_box.png")

        fig, ax = plt.subplots(figsize=(6, 4))
        for c in self.mass_conservation_series():
            ax.plot(np.arange(1, len(c) + 1), c, alpha=0.6)
        ax.set_title("mass conservation residual [1e6 m$^3$]")
        ax.set_xlabel("rollout step")
        save(fig, "mass_conservation.png")
