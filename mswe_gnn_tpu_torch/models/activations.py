"""Activation functions with optional learned parameters (port of
mswe_gnn_tpu/models/activations.py).

relu / prelu / leakyrelu / elu / swish / sigmoid / tanh / None. PReLU carries
a single learned ``alpha`` (torch's ``PReLU(num_parameters=1)``, init 0.25),
stored in the parameter tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

VALID = ("relu", "prelu", "leakyrelu", "elu", "swish", "sigmoid", "tanh", None)


def init_activation(name: str | None) -> dict:
    """Return the (possibly empty) parameter dict for an activation."""
    if name not in VALID:
        raise ValueError(f"unknown activation {name!r}; options: {VALID}")
    if name == "prelu":
        return {"alpha": torch.tensor([0.25], dtype=torch.float32)}
    return {}


def apply_activation(name: str | None, params: dict, x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "prelu":
        return torch.where(x >= 0, x, params["alpha"] * x)
    if name == "leakyrelu":
        return F.leaky_relu(x, negative_slope=0.1)
    if name == "elu":
        return F.elu(x)
    if name == "swish":
        return F.silu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {name!r}")
