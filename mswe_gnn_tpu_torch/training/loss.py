"""Loss functions: masked RMSE/MAE, finest-scale restriction, velocity
weighting, and the mass-conservation penalty (port of
mswe_gnn_tpu/training/loss.py).

Static-shape masking as in the JAX package: where the reference compacts
rows (``diff[where_water]``), all rows are kept and masked sums with dynamic
counts give identical values. Padded nodes always have diff == 0 and are
additionally excluded through the node mask. A ``concat_graphs`` union gives
one conservation residual per graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS
from mswe_gnn_tpu_torch.graph import FloodGraph


def masked_error_sums(diff: torch.Tensor, valid: torch.Tensor, type_loss: str):
    """Per-variable (sum of |diff|^p over valid rows, count of valid rows).

    Sums instead of means let batched losses aggregate across graphs like
    the reference's concat-then-mean (reference training/loss.py:68-70)."""
    v = valid.to(diff.dtype)[:, None]
    if type_loss == "RMSE":
        s = (diff * diff * v).sum(dim=0)
    elif type_loss == "MAE":
        s = (diff.abs() * v).sum(dim=0)
    else:
        raise ValueError("type_loss must be 'RMSE' or 'MAE'")
    return s, v.sum()


def finalize_error(sums: torch.Tensor, count: torch.Tensor, type_loss: str) -> torch.Tensor:
    mean = sums / torch.clamp(count, min=1.0)
    return torch.sqrt(mean) if type_loss == "RMSE" else mean


def water_mask(diff: torch.Tensor) -> torch.Tensor:
    """Rows where prediction or target is nonzero
    (reference training/loss.py:25-35)."""
    return (diff != 0).any(dim=-1)


def loss_variable_scaler(velocity_scaler: float, device=None) -> torch.Tensor:
    """[1, velocity_scaler] weighting (reference training/loss.py:37-47)."""
    s = torch.ones(NUM_WATER_VARS, device=device)
    s[1] = velocity_scaler
    return s


def conservation_residual(pred_wd: torch.Tensor, input_wd: torch.Tensor,
                          graph: FloodGraph, bc_now: torch.Tensor) -> torch.Tensor:
    """Signed mass-conservation residual in 1e6 m^3, finest scale only
    (reference training/loss.py:120-168).

    ``pred_wd``/``input_wd`` [N, 1] water depth at t+1 and t, ``bc_now``
    [Nbc] the BC value at the step boundary per ghost node. A
    ``concat_graphs`` union gives the per-graph residuals ``[num_graphs]``
    (its finest block and BC arrays reshaped to ``[b, -1]``); one graph
    gives a scalar."""
    b = graph.num_graphs
    vol = graph.area[:, None] * (pred_wd - input_wd)
    fs = graph.finest_slice()
    predicted_inflow = (vol[fs] * graph.node_mask[fs, None]).reshape(b, -1).sum(dim=1)
    # theoretical inflow: sum(|q| * L_bc) * dt (reference utils/dataset.py:577-591)
    inflow = ((bc_now * graph.bc_edge_length * graph.bc_mask).reshape(b, -1).sum(dim=1)
              * (60.0 * graph.temporal_res))
    ghost = ((vol[:, 0].index_select(0, graph.bc_nodes.long()) * graph.bc_mask)
             .reshape(b, -1).sum(dim=1))
    res = (predicted_inflow - inflow - ghost) / 1e6
    return res if b > 1 else res[0]


def step_loss_sums(preds: torch.Tensor, target: torch.Tensor, graph: FloodGraph,
                   type_loss: str = "RMSE", only_where_water: bool = False,
                   multiscale: bool = True, bc_now: Optional[torch.Tensor] = None,
                   conservation: float = 0.0):
    """Loss pieces of one rollout step: (per-variable error sums [2], valid
    count, signed conservation residual). Combine them with
    :func:`combine_batch_loss` or as ``train.pushforward_loss`` does."""
    diff = preds - target
    if multiscale:
        fs = graph.finest_slice()
        diff_sel = diff[fs]
        nmask = graph.node_mask[fs]
    else:
        diff_sel = diff
        nmask = graph.node_mask
    valid = nmask > 0
    if only_where_water:
        valid = valid & water_mask(diff_sel)
    sums, count = masked_error_sums(diff_sel, valid, type_loss)
    if conservation != 0.0:
        wd_idx = NUM_WATER_VARS
        input_wd = graph.x_dynamic[:, -wd_idx::wd_idx]
        pred_wd = preds[:, 0::wd_idx]
        cons = conservation_residual(pred_wd, input_wd, graph, bc_now)
    else:
        cons = torch.zeros((), device=preds.device)
    return sums, count, cons


def combine_batch_loss(sums: torch.Tensor, counts: torch.Tensor, cons: torch.Tensor,
                       type_loss: str = "RMSE", velocity_scaler: float = 1.0,
                       conservation: float = 0.0) -> torch.Tensor:
    """Per-graph pieces ``sums [B, 2]``, ``counts [B]``, ``cons [B]`` -> the
    scalar training loss: errors concat-then-mean across the batch
    (reference training/loss.py:68-70, 107-110), the conservation term the
    |batch mean| of signed residuals (reference training/loss.py:112-116)."""
    err = finalize_error(sums.sum(dim=0), counts.sum(), type_loss)
    scaler = loss_variable_scaler(velocity_scaler, device=err.device)
    loss = torch.dot(err, scaler) / scaler.sum()
    if conservation != 0.0:
        loss = loss + conservation * cons.mean().abs()
    return loss
