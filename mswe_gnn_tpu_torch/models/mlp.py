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
operands to bf16 and returns their product in float32, summed in float32, as
the JAX package's ``jnp.matmul(..., preferred_element_type=float32)`` does
(``torch.matmul`` of two bf16 tensors would round the result to bf16 too).
The product of two bf16 values is exact in float32, so the devices differ
only in the order of the sums. Every bf16 product runs through
``Bf16Matmul``: on CUDA the bf16 operands go straight to one tensor-core GEMM
with float32 accumulation and a float32 output; on the CPU, where PyTorch has
no such kernel, they are widened to float32 and multiplied there. The
backward is the same on both: float32 products of the float32 upstream
gradient, each rounded to bf16.
Importing this module sets ``torch.backends.cuda.matmul.allow_tf32 = False``
so that float32 products on the GPU stay float32 and do not drop to TF32.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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


class Bf16Matmul(torch.autograd.Function):
    """``x @ w`` (``w`` 2-D, ``x`` of any rank) of the bf16-rounded operands,
    summed in float32 and returned in float32: on CUDA one bf16 tensor-core
    GEMM, on the CPU the float32 product of the widened operands. Its backward
    is what autograd of ``x.to(bf16).float() @ w.to(bf16).float()`` gives:
    float32 GEMMs of the float32 upstream gradient, rounded to bf16 and
    returned in each operand's dtype. Only the bf16 operands are saved."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        if xb.is_cuda:
            y = torch.mm(xb, wb, out_dtype=torch.float32)
        else:
            y = xb.float().mm(wb.float())
        ctx.save_for_backward(xb, wb)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        dy = dy.reshape(-1, dy.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dy.mm(wb.float().t()).to(torch.bfloat16).to(ctx.x_dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = xb.float().t().mm(dy).to(torch.bfloat16).to(ctx.w_dtype)
        return dx, dw


# bf16 calls of matmul by (device type, K, N): "cuda" calls are the
# tensor-core GEMM, "cpu" calls the widened float32 product; reset with
# reset_matmul_calls()
matmul_calls: collections.Counter = collections.Counter()


def reset_matmul_calls() -> None:
    matmul_calls.clear()


def matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w``; with ``compute_dtype='bfloat16'`` the operands are rounded to
    bf16 and the product is summed and returned in float32 (module
    docstring, "Precision")."""
    if compute_dtype is None or compute_dtype == "float32":
        return x @ w
    if compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype {compute_dtype!r}: 'float32' or 'bfloat16'")
    matmul_calls[x.device.type, *w.shape] += 1
    return Bf16Matmul.apply(x, w)


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
