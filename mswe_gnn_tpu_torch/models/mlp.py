"""Functional MLP with the reference's layer recipe (port of
mswe_gnn_tpu/models/mlp.py).

Linear (optional bias) -> activation blocks, in -> hidden -> ... -> out, with
an activation after *every* linear including the last. Weights are stored
``[in, out]`` as in the JAX package, so its parameters load unchanged
(compat/jax_params.py).

Two options of ``init_mlp`` serve MeshGraphNets (models/meshgraphnet.py)
and change nothing at their defaults. The tree records both, and
``apply_mlp`` does what it finds: ``activate_final=False`` puts ``None`` in
the last ``acts`` slot, which leaves the last linear bare; ``layer_norm=True``
puts a LayerNorm's ``{"scale", "bias"}`` (ones, zeros) in the last layer's
``norms`` slot, applied to the output (eps 1e-5, in float32 whatever the
``compute_dtype``). The JAX MLP's ``norms`` slots mean something else (a
LayerNorm after every linear, applied by a flag) and it has no ``None``
slot; compat/jax_params.py loads only trees with neither, which are the
same in both packages.

Precision: ``matmul`` with a ``compute_dtype`` of bfloat16 rounds both
operands to bf16 and multiplies them in float32, giving a float32 result, as
the JAX package's ``jnp.matmul(..., preferred_element_type=float32)`` does
(``torch.matmul`` of two bf16 tensors would round the result to bf16 too).
Importing this module sets ``torch.backends.cuda.matmul.allow_tf32 = False``
so that float32 products on the GPU stay float32 and do not drop to TF32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mswe_gnn_tpu_torch.models.activations import apply_activation, init_activation

torch.backends.cuda.matmul.allow_tf32 = False


def _torch_linear_init(gen: torch.Generator, fan_in: int, fan_out: int,
                       bias: bool) -> dict:
    """torch.nn.Linear's default init: W and b uniform in +-1/sqrt(fan_in).
    Weight stored as [in, out]."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    p = {"w": torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=gen)}
    if bias:
        p["b"] = torch.empty(fan_out).uniform_(-bound, bound, generator=gen)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w``; with ``compute_dtype='bfloat16'`` the operands are rounded to
    bf16 and the product is taken and returned in float32."""
    if compute_dtype is None or compute_dtype == "float32":
        return x @ w
    cd = getattr(torch, compute_dtype)
    return torch.matmul(x.to(cd).float(), w.to(cd).float())


def mlp_sizes(input_size: int, output_size: int, hidden_size: int, n_layers: int):
    """Per-linear (fan_in, fan_out) pairs (reference models/models.py:121-141)."""
    if n_layers == 1:
        return [(input_size, output_size)]
    sizes = [(input_size, hidden_size)]
    sizes += [(hidden_size, hidden_size)] * (n_layers - 2)
    sizes += [(hidden_size, output_size)]
    return sizes


def init_mlp(gen: torch.Generator, input_size: int, output_size: int,
             hidden_size: int = 32, n_layers: int = 2, bias: bool = False,
             activation: Optional[str] = "relu", activate_final: bool = True,
             layer_norm: bool = False) -> dict:
    layers, acts, norms = [], [], []
    sizes = mlp_sizes(input_size, output_size, hidden_size, n_layers)
    for i, (fi, fo) in enumerate(sizes):
        last = i == len(sizes) - 1
        layers.append(_torch_linear_init(gen, fi, fo, bias))
        acts.append(init_activation(activation) if activate_final or not last else None)
        norms.append({"scale": torch.ones(fo), "bias": torch.zeros(fo)}
                     if layer_norm and last else {})
    return {"layers": layers, "acts": acts, "norms": norms}


def apply_mlp(params: dict, x: torch.Tensor, activation: Optional[str] = "relu",
              compute_dtype=None) -> torch.Tensor:
    for lin, act in zip(params["layers"], params["acts"]):
        x = matmul(x, lin["w"], compute_dtype)
        if "b" in lin:
            x = x + lin["b"]
        if act is not None:
            x = apply_activation(activation, act, x)
    # the SWE-GNN flux tail of a one-layer edge MLP is an MLP of no layers
    ln = params["norms"][-1] if params["norms"] else None
    if ln:
        x = F.layer_norm(x.float(), ln["scale"].shape, ln["scale"], ln["bias"], eps=1e-5)
    return x


def init_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                bias: bool = False) -> dict:
    """A bare linear layer (the SWEGNN filter matrices H_k)."""
    return _torch_linear_init(gen, fan_in, fan_out, bias)


def apply_linear(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    y = matmul(x, params["w"], compute_dtype)
    if "b" in params:
        y = y + params["b"]
    return y
