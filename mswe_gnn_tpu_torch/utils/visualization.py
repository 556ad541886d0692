"""Visualization: flood maps on unstructured meshes, rollout panels, FAT,
velocity quivers and animation export (port of
mswe_gnn_tpu/utils/visualization.py).

Re-design of the reference plotting stack (reference utils/visualization.py:
BasePlotMap :113, TemporalPlotMap :272, QuiverPlotMap :324, DEMPlotMap :417,
PlotRollout :515 with video export :896-1079). Cell values are drawn as
scatter plots on face centres, which works for grid and triangulated meshes
alike.

matplotlib is imported inside the functions (``require_matplotlib``), so the
package imports where it is missing; there every function here raises an
ImportError that names it. Figures are drawn headless (Agg) and written to
files. FAT and CSI / F1 come from the port's ``utils/metrics.py`` on CPU
float32 tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mswe_gnn_tpu_torch.data.meshing import Mesh, MultiscaleMesh
from mswe_gnn_tpu_torch.utils.metrics import get_csi, get_f1, wd_to_fat

WATER_NAMES = ["water depth h [m]", "|q| [m$^2$/s]"]


def require_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend; raises an ImportError that
    names matplotlib where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("report figures need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _float32(x) -> torch.Tensor:
    """A CPU float32 tensor of ``x``, as ``jnp.asarray`` makes one."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _marker_size(num_faces: int) -> float:
    return max(2.0, 4e4 / max(num_faces, 1))


def plot_map(mesh: Mesh, values: np.ndarray, ax=None, cmap: str = "Blues",
             title: str = "", vmin=None, vmax=None, colorbar: bool = True,
             mask_zero: bool = False):
    """One scalar field on cell centers (reference BasePlotMap semantics)."""
    plt = require_matplotlib()
    ax = ax or plt.gca()
    v = np.asarray(values, dtype=float).copy()
    if mask_zero:
        v[v == 0] = np.nan
    sc = ax.scatter(mesh.face_xy[:, 0], mesh.face_xy[:, 1], c=v,
                    s=_marker_size(mesh.num_faces), marker="s", cmap=cmap, vmin=vmin,
                    vmax=vmax, lw=0)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.set_xticks([]), ax.set_yticks([])
    if colorbar:
        plt.colorbar(sc, ax=ax, shrink=0.8)
    return sc


def plot_dem(mesh: Mesh, ax=None, breach_xy: Optional[np.ndarray] = None,
             title: str = "DEM"):
    """Terrain map with optional breach markers (reference DEMPlotMap :417)."""
    plt = require_matplotlib()
    ax = ax or plt.gca()
    sc = plot_map(mesh, mesh.dem, ax=ax, cmap="terrain", title=title)
    if breach_xy is not None:
        ax.scatter(breach_xy[:, 0], breach_xy[:, 1], marker="x", c="red", s=80)
    return sc


def plot_quiver(mesh: Mesh, vx: np.ndarray, vy: np.ndarray, ax=None,
                stride: int = 4, title: str = "velocity"):
    """Velocity field quiver (reference QuiverPlotMap :324)."""
    plt = require_matplotlib()
    ax = ax or plt.gca()
    idx = np.arange(0, mesh.num_faces, stride)
    ax.quiver(mesh.face_xy[idx, 0], mesh.face_xy[idx, 1], vx[idx], vy[idx],
              np.hypot(vx[idx], vy[idx]), cmap="viridis", scale_units="xy")
    ax.set_aspect("equal")
    ax.set_title(title)
    return ax


def _finish(plt, fig, out_path: Optional[str]):
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
    return fig


def _save_animation(plt, fig, anim, out_path: str, fps: int) -> str:
    """GIF through Pillow, or mp4 where ffmpeg exists (a ``.mp4`` path falls
    back to ``.gif`` without it) -> the path written."""
    from matplotlib import animation

    if out_path.endswith(".mp4") and animation.writers.is_available("ffmpeg"):
        anim.save(out_path, writer="ffmpeg", fps=fps)
    else:
        if out_path.endswith(".mp4"):
            out_path = out_path[:-4] + ".gif"
        anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


class PlotRollout:
    """Predicted vs real vs error panels over a rollout
    (reference PlotRollout :515).

    ``pred``/``real`` are [N, 2, T] over every scale of ``mesh`` (numpy);
    the panels draw the finest scale. ``node_ptr`` gives the per-scale block
    offsets of ``pred``/``real``: pass the graph spec's (padded) pointers
    when the arrays come from a padded FloodGraph; it defaults to the raw
    mesh pointers. Raises an ImportError naming matplotlib where it is
    missing."""

    def __init__(self, mesh: MultiscaleMesh, pred: np.ndarray, real: np.ndarray,
                 temporal_res: float = 60.0, node_ptr=None):
        self.plt = require_matplotlib()
        self.finest = mesh.meshes[0]
        self.mesh = mesh
        n0 = self.finest.num_faces
        self.node_ptr = np.asarray(node_ptr if node_ptr is not None else mesh.node_ptr)
        self.pred_all = np.asarray(pred)
        self.real_all = np.asarray(real)
        self.pred = self.pred_all[:n0]
        self.real = self.real_all[:n0]
        self.temporal_res = temporal_res

    def frame(self, t: int, variable: int = 0, out_path: Optional[str] = None):
        plt = self.plt
        vmax = float(max(self.real[:, variable].max(), 1e-6))
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        plot_map(self.finest, self.pred[:, variable, t], ax=axes[0],
                 title=f"predicted {WATER_NAMES[variable]} (t={t})", vmin=0, vmax=vmax,
                 mask_zero=True)
        plot_map(self.finest, self.real[:, variable, t], ax=axes[1],
                 title="simulated", vmin=0, vmax=vmax, mask_zero=True)
        err = self.pred[:, variable, t] - self.real[:, variable, t]
        lim = max(abs(err).max(), 1e-6)
        plot_map(self.finest, err, ax=axes[2], cmap="RdBu_r",
                 title="difference", vmin=-lim, vmax=lim)
        return _finish(plt, fig, out_path)

    def fat_comparison(self, water_threshold: float = 0.05,
                       out_path: Optional[str] = None):
        """Flood-arrival-time maps pred vs real (reference :845)."""
        plt = self.plt
        fat_p = wd_to_fat(_float32(self.pred[:, 0]), self.temporal_res,
                          water_threshold).numpy()
        fat_r = wd_to_fat(_float32(self.real[:, 0]), self.temporal_res,
                          water_threshold).numpy()
        vmax = float(max(fat_r.max(), 1e-6))
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        plot_map(self.finest, fat_p, ax=axes[0], cmap="plasma",
                 title="predicted FAT [h]", vmin=0, vmax=vmax)
        plot_map(self.finest, fat_r, ax=axes[1], cmap="plasma",
                 title="simulated FAT [h]", vmin=0, vmax=vmax)
        diff = fat_p - fat_r
        lim = max(abs(diff).max(), 1e-6)
        plot_map(self.finest, diff, ax=axes[2], cmap="RdBu_r",
                 title="difference [h]", vmin=-lim, vmax=lim)
        return _finish(plt, fig, out_path)

    def scales_plot(self, values_per_scale: Optional[Sequence[np.ndarray]] = None,
                    out_path: Optional[str] = None):
        """Side-by-side view of the mesh hierarchy (reference mesh_scale_plot :569)."""
        plt = self.plt
        L = self.mesh.num_scales
        fig, axes = plt.subplots(1, L, figsize=(5 * L, 5))
        axes = np.atleast_1d(axes)
        for s, (m, ax) in enumerate(zip(self.mesh.meshes, axes)):
            vals = values_per_scale[s] if values_per_scale is not None else m.dem
            plot_map(m, vals, ax=ax, cmap="terrain", title=f"scale {s} ({m.num_faces} cells)")
        return _finish(plt, fig, out_path)

    def csi_f1_panel(self, thresholds=(0.05, 0.3), out_path: Optional[str] = None):
        """CSI and F1 over the rollout for this simulation
        (reference PlotRollout._plot_metric, visualization.py:1087-1116)."""
        plt = self.plt
        p, r = _float32(self.pred), _float32(self.real)
        m = torch.ones(p.shape[0])
        tv = np.arange(p.shape[-1]) * self.temporal_res / 60.0
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        for ax, name, fn in ((axes[0], "CSI", get_csi), (axes[1], "F1", get_f1)):
            for tau in thresholds:
                ax.plot(tv, fn(p, r, m, water_threshold=tau).numpy(),
                        marker="o", ms=3, label=f"{name}_{tau}")
            ax.set_xlabel("Time [h]")
            ax.set_ylabel(f"{name} score")
            ax.set_ylim(0, 1)
            ax.grid(alpha=0.4)
            ax.legend(loc=4)
        return _finish(plt, fig, out_path)

    def froude_map(self, t: Optional[int] = None, out_path: Optional[str] = None):
        """Froude number maps pred vs real vs difference at time ``t``
        (defaults to the wettest frame; reference compare_Froude :863,
        get_Froude misc.py:50-54; velocity recovered as |q| / h)."""
        plt = self.plt
        g = 9.81

        def froude(arr_t):
            h, q = arr_t[:, 0], arr_t[:, 1]
            v = np.where(h > 1e-6, q / np.maximum(h, 1e-6), 0.0)
            return np.where(h > 0, v / np.sqrt(g * np.maximum(h, 1e-9)), 0.0)

        if t is None:
            t = int(np.argmax(self.real[:, 0].sum(0)))
        fr_p, fr_r = froude(self.pred[..., t]), froude(self.real[..., t])
        vmax = float(max(fr_r.max(), fr_p.max(), 1e-6))
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        plot_map(self.finest, fr_p, ax=axes[0], cmap="viridis",
                 title=f"predicted Froude (t={t})", vmin=0, vmax=vmax)
        plot_map(self.finest, fr_r, ax=axes[1], cmap="viridis",
                 title="simulated Froude", vmin=0, vmax=vmax)
        diff = fr_p - fr_r
        lim = max(abs(diff).max(), 1e-6)
        plot_map(self.finest, diff, ax=axes[2], cmap="RdBu_r",
                 title="difference", vmin=-lim, vmax=lim)
        return _finish(plt, fig, out_path)

    def conservation_panel(self, residual_series: np.ndarray,
                           inflow_series: Optional[np.ndarray] = None,
                           out_path: Optional[str] = None):
        """Mass-conservation error over the rollout (reference
        _plot_mass_conservation :1118): the signed residual a step and, with
        the inflow volume series, the cumulative error over the cumulative
        inflow."""
        plt = self.plt
        res = np.asarray(residual_series, float)         # [T-1], 1e6 m^3
        tv = (np.arange(len(res)) + 1) * self.temporal_res / 60.0
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(tv, res, marker="o", ms=3, label=r"per $\Delta$t [1e6 m$^3$]")
        if inflow_series is not None:
            inflow = np.maximum(np.asarray(inflow_series, float)[:len(res)], 1e-12)
            cum = np.cumsum(res) / np.cumsum(inflow)
            ax.plot(tv, cum, lw=2, label="cumulative / cumulative inflow [-]")
        ax.set_title("Mass conservation")
        ax.set_xlabel("Time [h]")
        ax.set_ylabel("Volume error")
        ax.grid(alpha=0.4)
        ax.legend()
        return _finish(plt, fig, out_path)

    def create_multiscale_video(self, out_path: str, variable: int = 0,
                                fps: int = 4, predicted: bool = True) -> str:
        """Animated per-scale view of the hierarchy over the rollout
        (reference create_multiscale_video :965): one panel per scale,
        showing how the V-cycle's coarse scales see the flood."""
        from matplotlib import animation

        plt = self.plt
        arr = self.pred_all if predicted else self.real_all
        L = self.mesh.num_scales
        T = arr.shape[-1]
        nptr = self.node_ptr
        vmax = float(max(arr[: nptr[1], variable].max(), 1e-6))
        fig, axes = plt.subplots(1, L, figsize=(5 * L, 5))
        axes = np.atleast_1d(axes)

        def block(s, m, t):
            b = arr[nptr[s]: nptr[s] + m.num_faces, variable, t].copy()
            b[b == 0] = np.nan
            return b

        scs = []
        for s, (m, ax) in enumerate(zip(self.mesh.meshes, axes)):
            sc = ax.scatter(m.face_xy[:, 0], m.face_xy[:, 1], c=block(s, m, 0),
                            s=_marker_size(m.num_faces), marker="s", cmap="Blues",
                            vmin=0, vmax=vmax, lw=0)
            ax.set_aspect("equal")
            ax.set_title(f"scale {s} ({m.num_faces} cells)")
            ax.set_xticks([]), ax.set_yticks([])
            scs.append(sc)
        ttl = fig.suptitle("t = 0")

        def update(t):
            for s, (sc, m) in enumerate(zip(scs, self.mesh.meshes)):
                sc.set_array(block(s, m, t))
            ttl.set_text(f"t = {t} ({t * self.temporal_res / 60:.0f} h)")
            return scs

        anim = animation.FuncAnimation(fig, update, frames=T, blit=False)
        return _save_animation(plt, fig, anim, out_path, fps)

    def create_video(self, out_path: str, variable: int = 0, fps: int = 4) -> str:
        """Animated rollout (reference create_video :896 / save_video :1079):
        writes .gif (Pillow), or .mp4 where ffmpeg exists."""
        from matplotlib import animation

        plt = self.plt
        T = self.pred.shape[-1]
        vmax = float(max(self.real[:, variable].max(), 1e-6))
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))

        def values(data, t):
            v = data[:, variable, t].copy()
            v[v == 0] = np.nan
            return v

        scs = []
        for ax, (data, label) in zip(axes, [(self.pred, "predicted"),
                                            (self.real, "simulated")]):
            sc = ax.scatter(self.finest.face_xy[:, 0], self.finest.face_xy[:, 1],
                            c=values(data, 0), s=_marker_size(self.finest.num_faces),
                            marker="s", cmap="Blues", vmin=0, vmax=vmax, lw=0)
            ax.set_aspect("equal")
            ax.set_title(f"{label} {WATER_NAMES[variable]}")
            ax.set_xticks([]), ax.set_yticks([])
            scs.append(sc)
        ttl = fig.suptitle("t = 0")

        def update(t):
            for sc, data in zip(scs, [self.pred, self.real]):
                sc.set_array(values(data, t))
            ttl.set_text(f"t = {t} ({t * self.temporal_res / 60:.0f} h)")
            return scs

        anim = animation.FuncAnimation(fig, update, frames=T, blit=False)
        return _save_animation(plt, fig, anim, out_path, fps)
