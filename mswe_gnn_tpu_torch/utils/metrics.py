"""Evaluation metrics: CSI, F1, rollout RMSE/MAE, FAT, Froude, speed-up and
the K-hop sufficiency diagnostic (port of mswe_gnn_tpu/utils/metrics.py).

Rollouts are [N, 2, T] (single) or [B, N, 2, T] (batched; a concat union's
finest block reshaped per graph, as ``eval_step(per_graph=True)`` does);
variable 0 is the water depth h, variable 1 is |q|. Padded nodes are masked
out.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _confusion(pred_roll, real_roll, node_mask, water_threshold):
    """TP/TN/FP/FN over the node axis, per time step
    (reference utils/miscellaneous.py:123-151); padded nodes count in no
    bucket."""
    pred_flood = pred_roll[..., 0, :] > water_threshold     # [..., N, T]
    real_flood = real_roll[..., 0, :] > water_threshold
    m = node_mask[..., None].float()                        # [..., N, 1]
    tp = ((pred_flood & real_flood) * m).sum(dim=-2)
    tn = ((~pred_flood & ~real_flood) * m).sum(dim=-2)
    fp = ((pred_flood & ~real_flood) * m).sum(dim=-2)
    fn = ((~pred_flood & real_flood) * m).sum(dim=-2)
    return tp, tn, fp, fn


def _ratio_or_nan(num, denom):
    return torch.where(denom > 0, num / torch.clamp(denom, min=1.0),
                       torch.full_like(num, float("nan")))


def csi_counts(pred_roll, real_roll, node_mask, water_threshold: float = 0.0):
    """The counts behind ``get_csi``, which add over graphs and devices:
    ``(tp, fp, fn)`` per time step."""
    tp, _, fp, fn = _confusion(pred_roll, real_roll, node_mask, water_threshold)
    return tp, fp, fn


def csi_from_counts(tp, fp, fn):
    """CSI per time step from ``csi_counts``; NaN where the denominator is 0."""
    return _ratio_or_nan(tp, tp + fn + fp)


def get_csi(pred_roll, real_roll, node_mask, water_threshold: float = 0.0):
    """Critical Success Index per time step; NaN where the denominator is 0
    (reference utils/miscellaneous.py:153-160)."""
    return csi_from_counts(*csi_counts(pred_roll, real_roll, node_mask, water_threshold))


def get_f1(pred_roll, real_roll, node_mask, water_threshold: float = 0.0):
    """F1 score per time step (reference utils/miscellaneous.py:162-169)."""
    tp, _, fp, fn = _confusion(pred_roll, real_roll, node_mask, water_threshold)
    return _ratio_or_nan(tp, tp + 0.5 * (fn + fp))


def rollout_error_sums(pred_roll, real_roll, node_mask, type_loss: str = "RMSE",
                       only_where_water: bool = False):
    """The sums behind ``get_rollout_loss``, which add over graphs and
    devices -> ``(error sums, count)``: with ``only_where_water`` the
    squared (RMSE) or absolute errors over the wet (node, time) entries
    ``[..., 2]`` and their count ``[...]``, otherwise over the nodes, per
    time ``[..., 2, T]``, and the node count ``[...]``."""
    diff = pred_roll - real_roll
    err = diff ** 2 if type_loss == "RMSE" else diff.abs()
    nm = node_mask.to(diff.dtype)
    if only_where_water:
        mask = (diff != 0).any(dim=-2) * nm[..., None]             # [..., N, T]
        return (err * mask[..., None, :]).sum(dim=(-3, -1)), mask.sum(dim=(-2, -1))
    return (err * nm[..., None, None]).sum(dim=-3), nm.sum(dim=-1)


def rollout_error(sums, count, type_loss: str = "RMSE", only_where_water: bool = False):
    """``rollout_error_sums``' sums -> the error per variable: the mean (its
    root for RMSE) over the wet entries, or per time over the nodes and
    then over time."""
    cnt = torch.clamp(count, min=1.0)
    if only_where_water:
        err = sums / cnt[..., None]
        return torch.sqrt(err) if type_loss == "RMSE" else err
    per_t = sums / cnt[..., None, None]
    return (torch.sqrt(per_t) if type_loss == "RMSE" else per_t).mean(dim=-1)


def get_rollout_loss(pred_roll, real_roll, node_mask, type_loss: str = "RMSE",
                     only_where_water: bool = False):
    """Per-simulation, per-variable rollout error
    (reference utils/miscellaneous.py:177-199): [N,2,T] -> [2], [B,N,2,T] ->
    [B,2].

    only_where_water=True: error over all (node, time) entries where any
    variable differs, one pooled mean per variable. Otherwise the per-time
    error over nodes, then the mean over time."""
    return rollout_error(*rollout_error_sums(pred_roll, real_roll, node_mask, type_loss,
                                             only_where_water), type_loss, only_where_water)


def wd_to_fat(wd, temporal_res: float, water_threshold: float = 0.0,
              time_start: int = 0):
    """Flood-arrival-time map in hours from a [N, T] water-depth sequence
    (reference utils/miscellaneous.py:56-68)."""
    total_time = time_start + wd.shape[-1]
    flooded_time = (wd > water_threshold).sum(-1)
    return (total_time - flooded_time) * temporal_res / 60.0


def get_velocity(discharge: torch.Tensor, water_depth: torch.Tensor,
                 epsilon: float = 0.01) -> torch.Tensor:
    """v = q/h with shallow-water cutoff (reference utils/miscellaneous.py:44-48)."""
    v = discharge / torch.clamp(water_depth, min=epsilon)
    return torch.where(water_depth > epsilon, v, torch.zeros_like(v))


def get_froude(velocity: torch.Tensor, water_depth: torch.Tensor) -> torch.Tensor:
    """Froude number v / sqrt(g h) (reference utils/miscellaneous.py:50-54)."""
    g = 9.81
    fr = velocity / torch.sqrt(g * torch.clamp(water_depth, min=1e-12))
    return torch.where(water_depth > 0, fr, torch.zeros_like(fr))


def get_speed_up(numerical_times: np.ndarray, model_times: np.ndarray) -> Tuple[float, float]:
    """Speed-up of the surrogate vs the numerical solver
    (reference utils/miscellaneous.py:110-114)."""
    ratio = np.asarray(numerical_times) / np.asarray(model_times)
    return float(ratio.mean()), float(ratio.std())


def get_sufficient_k_hops(edge_index: np.ndarray, wd: np.ndarray,
                          cover_percentage: float = 0.999, max_k: int = 50) -> int:
    """Minimum K so K-hop neighborhoods cover one-step wet-front growth
    (reference utils/miscellaneous.py:266-301). Host-side diagnostic."""
    src, dst = edge_index
    water_t1 = (wd[:, 1:] > 0)
    fake = (wd[:, :-1] > 0).astype(np.float64)

    def covered(f):
        hit = (f[water_t1] > 0).sum()
        need = water_t1.sum()
        return hit >= cover_percentage * need if cover_percentage < 1 else hit == need

    k = 0
    while not covered(fake):
        spread = np.zeros_like(fake)
        np.add.at(spread, dst, fake[src])
        fake = np.clip(spread + fake, 0, 1)
        k += 1
        if k > max_k:
            break
    return k


def get_sufficient_k_hops_per_scale(edge_index: np.ndarray, wd: np.ndarray,
                                    edge_ptr, node_ptr,
                                    cover_percentage: float = 0.999):
    """Per-scale receptive-field sufficiency
    (reference utils/miscellaneous.py:303-309)."""
    out = []
    for i in range(len(node_ptr) - 1):
        ei = edge_index[:, edge_ptr[i]: edge_ptr[i + 1]] - node_ptr[i]
        out.append(get_sufficient_k_hops(ei, wd[node_ptr[i]: node_ptr[i + 1]],
                                         cover_percentage))
    return out
