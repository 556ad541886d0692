"""The bf16 GEMM of the port's MLPs (``models/mlp.py::matmul``) on the CPU.

With ``compute_dtype='bfloat16'`` every product runs through
``Bf16Matmul``, which on the CPU computes what the chain
``torch.matmul(x.to(bf16).float(), w.to(bf16).float())`` computed before
CUDA had a path of its own: the same product and, under the same upstream
gradient, the same gradients. On the CPU both sides run the same float32
kernels, so every comparison here is to the bit. The card's tensor-core
product is held in ``tests/test_torch_port_cuda.py``.
"""
import json
import os

import pytest
import torch

from mswe_gnn_tpu_torch.models import mlp, registry, swegnn
from mswe_gnn_tpu_torch.training.rollout import rollout
import tests.torch_port_common  # noqa: F401  (PyTorch on one thread)

from portbench import system
from portbench.reference import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 77
BF16 = torch.bfloat16


def widened_chain(x, w, compute_dtype=None):
    """``matmul`` as it was before its CUDA path."""
    if compute_dtype is None or compute_dtype == "float32":
        return x @ w
    cd = getattr(torch, compute_dtype)
    return torch.matmul(x.to(cd).float(), w.to(cd).float())


def first_layer():
    """An edge MLP's first linear over ``[x_s_i | x_s_j | x_d_i | x_d_j |
    e_ij]`` (2 static, 64 dynamic features and one edge feature, hidden 64),
    as ``swegnn._first_layer_projections`` slices it by rows."""
    return torch.empty(2 * 2 + 2 * 64 + 1, 64).uniform_(
        -0.1, 0.1, generator=torch.Generator().manual_seed(3))


WEIGHTS = {
    "static_rows": lambda W: W[:2],               # W_ss: K = 2
    "dynamic_rows": lambda W: W[2 * 2 + 64: 2 * 2 + 2 * 64],   # W_dd: K = 64
    "whole": lambda W: W,
}


@pytest.mark.parametrize("x_grad", [True, False])
@pytest.mark.parametrize("weight", sorted(WEIGHTS))
@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("lead", [(37,), (29, 5)], ids=["2d", "3d"])
def test_bf16_matmul_on_the_cpu_is_the_widened_chain(lead, x_dtype, weight, x_grad):
    """``matmul``'s CPU path against the widened chain: the product, and the
    gradients of ``x`` and of the whole first-layer weight through its row
    slice, under one upstream gradient; each value and dtype to the bit.
    The call counts as a CPU call."""
    gen = torch.Generator().manual_seed(11)
    W0 = first_layer()
    k = WEIGHTS[weight](W0).shape[0]
    x0 = torch.randn(*lead, k, generator=gen).to(x_dtype)
    dy = torch.randn(*lead, 64, generator=gen)

    mlp.reset_matmul_calls()
    got = mlp.matmul(x0, WEIGHTS[weight](W0), "bfloat16")
    want = widened_chain(x0, WEIGHTS[weight](W0), "bfloat16")
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    assert mlp.matmul_calls == {("cpu", k, 64): 1}

    results = []
    for fn in (widened_chain, mlp.matmul):
        W = W0.clone().requires_grad_()
        x = x0.clone().requires_grad_(x_grad)
        y = fn(x, WEIGHTS[weight](W), "bfloat16")
        y.backward(dy)
        results.append((y, x.grad, W.grad))
    (y_old, dx_old, dw_old), (y_new, dx_new, dw_new) = results
    assert torch.equal(y_new, y_old)
    assert (dx_new is None) == (dx_old is None) == (not x_grad)
    if x_grad:
        assert dx_new.dtype == dx_old.dtype == x_dtype
        assert torch.equal(dx_new, dx_old)
    assert dw_new.dtype == torch.float32 and torch.equal(dw_new, dw_old)
    assert dw_new.abs().sum() > 0


def test_bf16_model_steps_on_the_cpu_are_the_widened_chain(monkeypatch):
    """The flagship msgnn-bench at its own widths on a small grid: a 2-step
    rollout on the CPU equals, to the bit, the same rollout with ``matmul``
    replaced by the widened chain, and every bf16 product of it counts as a
    CPU call, as many a step."""
    with open(os.path.join(ROOT, "portbench", "configs", "msgnn-bench.json")) as f:
        cfg = json.load(f)
    assert cfg["model"]["compute_dtype"] == "bfloat16"
    cfg["grid"].update(nx=16, ny=12, n_bc=2)
    cfg["frames"] = 4
    cfg["pad_multiple"] = 8
    mesh = inputs.make_mesh(cfg["grid"], SEED)
    sample = system.port_samples(mesh, inputs.make_scenarios(mesh, 4, 1, SEED), cfg)[0][0]
    mcfg, params, apply_fn = registry.build_model(
        cfg["model"], num_node_features=sample.num_node_features,
        num_edge_features=sample.edge_attr.shape[1], num_scales=sample.spec.num_scales,
        previous_t=cfg["previous_t"], seed=5, device="cpu")

    counts = []
    for steps in (1, 2):
        mlp.reset_matmul_calls()
        out = rollout(apply_fn, params, mcfg, sample, steps, device="cpu")
        counts.append(dict(mlp.matmul_calls))
    assert all(device == "cpu" for device, _, _ in counts[1])
    assert counts[1] == {key: 2 * n for key, n in counts[0].items()}
    assert sum(counts[0].values()) > 0

    for module in (mlp, swegnn):
        monkeypatch.setattr(module, "matmul", widened_chain)
    old = rollout(apply_fn, params, mcfg, sample, 2, device="cpu")
    assert torch.equal(out, old) and out.abs().max() > 0
