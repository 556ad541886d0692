"""Shared flood-model behaviours: residual connections and small-water
masking (port of mswe_gnn_tpu/models/base.py)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS


def init_residual_weights(
    gen: torch.Generator,
    learned_residuals: Union[bool, str, None],
    previous_t: int,
    residuals_base: float = 2.0,
    residual_init: str = "exp",
    out_dim: int = NUM_WATER_VARS,
) -> Optional[torch.Tensor]:
    """Residual weights (reference models/models.py:36-48, 93-100).

    'exp': proportional to base**t, normalised to sum 1 (later steps weigh
    more); 'random': xavier-normal. Shapes: [previous_t, 1] for True,
    [previous_t, out_dim] for 'all'.
    """
    if learned_residuals not in (True, "all"):
        return None
    repeat = out_dim if learned_residuals == "all" else 1
    if residual_init == "exp":
        w = torch.tensor([residuals_base ** e for e in range(previous_t)],
                         dtype=torch.float32)
        w = w / w.sum()
        return w[:, None].repeat(1, repeat)
    if residual_init == "random":
        std = (2.0 / (previous_t + repeat)) ** 0.5
        return std * torch.randn(previous_t, repeat, generator=gen)
    raise ValueError("residual_init must be 'exp' or 'random'")


def add_residual_connection(
    x0: torch.Tensor,
    residual_weights: Optional[torch.Tensor],
    learned_residuals: Union[bool, str, None],
    previous_t: int,
    out_dim: int = NUM_WATER_VARS,
) -> torch.Tensor:
    """Residual from the input water states to the output
    (reference models/models.py:50-77). ``x0 [N, S + 2*previous_t]``; its last
    2*previous_t columns are the interleaved (h, |q|) history."""
    n = x0.shape[0]
    if learned_residuals is True:
        hist = x0[:, -previous_t * NUM_WATER_VARS:].reshape(n, previous_t, NUM_WATER_VARS)
        return torch.einsum("npv,p->nv", hist, residual_weights[:, 0])
    if learned_residuals == "all":
        hist = x0[:, -previous_t * out_dim:].reshape(n, previous_t, out_dim)
        return torch.einsum("npv,pv->nv", hist, residual_weights)
    if learned_residuals is False:
        return x0[:, -out_dim:]
    return torch.zeros(n, out_dim, dtype=x0.dtype, device=x0.device)


def mask_small_wd(x: torch.Tensor, epsilon: float = 0.0001) -> torch.Tensor:
    """Zero tiny water depths; zero |q| where h == 0
    (reference models/models.py:79-91)."""
    wd = x[:, 0::NUM_WATER_VARS]
    v = x[:, 1::NUM_WATER_VARS]
    wd = wd * (wd.abs() > epsilon)
    v = v * (wd != 0)
    return torch.cat([wd, v], dim=-1)
