"""Evaluation metrics: CSI, F1 and the rollout RMSE/MAE (port of
mswe_gnn_tpu/utils/metrics.py:15-75; the other metrics of that module are
not ported yet).

Rollouts are [N, 2, T] (single) or [B, N, 2, T] (batched; a concat union's
finest block reshaped per graph, as ``eval_step(per_graph=True)`` does);
variable 0 is the water depth h, variable 1 is |q|. Padded nodes are masked
out.
"""
from __future__ import annotations

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


def get_csi(pred_roll, real_roll, node_mask, water_threshold: float = 0.0):
    """Critical Success Index per time step; NaN where the denominator is 0
    (reference utils/miscellaneous.py:153-160)."""
    tp, _, fp, fn = _confusion(pred_roll, real_roll, node_mask, water_threshold)
    return _ratio_or_nan(tp, tp + fn + fp)


def get_f1(pred_roll, real_roll, node_mask, water_threshold: float = 0.0):
    """F1 score per time step (reference utils/miscellaneous.py:162-169)."""
    tp, _, fp, fn = _confusion(pred_roll, real_roll, node_mask, water_threshold)
    return _ratio_or_nan(tp, tp + 0.5 * (fn + fp))


def get_rollout_loss(pred_roll, real_roll, node_mask, type_loss: str = "RMSE",
                     only_where_water: bool = False):
    """Per-simulation, per-variable rollout error
    (reference utils/miscellaneous.py:177-199): [N,2,T] -> [2], [B,N,2,T] ->
    [B,2].

    only_where_water=True: error over all (node, time) entries where any
    variable differs, one pooled mean per variable. Otherwise the per-time
    error over nodes, then the mean over time."""
    diff = pred_roll - real_roll
    nm = node_mask.to(diff.dtype)
    if only_where_water:
        www = (diff != 0).any(dim=-2)                              # [..., N, T]
        mask = www * nm[..., None]
        cnt = torch.clamp(mask.sum(dim=(-2, -1)), min=1.0)         # [...]
        if type_loss == "RMSE":
            s = (diff ** 2 * mask[..., None, :]).sum(dim=(-3, -1))  # [..., 2]
            return torch.sqrt(s / cnt[..., None])
        s = (diff.abs() * mask[..., None, :]).sum(dim=(-3, -1))
        return s / cnt[..., None]
    cnt = torch.clamp(nm.sum(dim=-1), min=1.0)
    if type_loss == "RMSE":
        per_t = torch.sqrt((diff ** 2 * nm[..., None, None]).sum(dim=-3)
                           / cnt[..., None, None])
        return per_t.mean(dim=-1)
    per_t = (diff.abs() * nm[..., None, None]).sum(dim=-3) / cnt[..., None, None]
    return per_t.mean(dim=-1)
