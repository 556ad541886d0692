"""How far the bench train step's bf16 gradients move between runs, through
the kernels and through autograd of the plain hops, with PyTorch's
deterministic algorithms off and on: the noise floor of ``chip_smoke.py``'s
gradient comparison (``hold_grads``).

For the bench graph with and without storm forcing, three passes of
``loss_and_grads`` through the kernels and three through the plain hops,
each pair read by ``chip_smoke.compare_grads`` (relative L2 and the three
leaves of largest max|diff| / max|leaf|). Needs the GPU and nvcc; from the
root of the repo:

    PYTHONPATH=. python3 tests/torch_port_grad_noise.py
"""
from __future__ import annotations

import torch

import chip_smoke
from mswe_gnn_tpu_torch.bench_problem import (build_bench_model, build_bench_sample,
                                              build_bench_train_step)
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan
from mswe_gnn_tpu_torch.training.train import loss_and_grads


def show(tag, r) -> None:
    print(f"{tag}: cosine {r['cos']:.9f}, relative L2 {r['rel']:.3e}, worst leaves "
          + "; ".join(f"{n} {q:.3e} (max|diff| {d:.3e}, max|leaf| {m:.3e})"
                      for n, q, d, m in r["worst"]), flush=True)


def passes(args):
    """-> three (loss, grads) through the kernels, three through the plain hops."""
    kernels = [loss_and_grads(*args) for _ in range(3)]
    with chip_smoke.plain_hops():
        plain = [loss_and_grads(*args) for _ in range(3)]
    torch.cuda.synchronize()
    return kernels, plain


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke.phase_build()
    for storm in (False, True):
        sample, _ = build_bench_sample(storm=storm)
        cfg, params, apply_fn = build_bench_model(sample, device="cuda")
        step = build_bench_train_step(attach_band_plan(sample), cfg, params, apply_fn,
                                      device="cuda")
        args = (apply_fn, step.params, cfg, step.graph, step.rollout_steps, step.opts, True)
        for det in (False, True):
            if det:
                with chip_smoke.deterministic("grad noise"):
                    kernels, plain = passes(args)
            else:
                kernels, plain = passes(args)
            tag = f"storm {storm}, deterministic {det}"
            for i in range(3):
                show(f"{tag}, kernels {i} vs plain {i}",
                     chip_smoke.compare_grads(*kernels[i], *plain[i]))
            for i in range(2):
                show(f"{tag}, kernels {i} vs kernels {i + 1}",
                     chip_smoke.compare_grads(*kernels[i], *kernels[i + 1]))
                show(f"{tag}, plain {i} vs plain {i + 1}",
                     chip_smoke.compare_grads(*plain[i], *plain[i + 1]))


if __name__ == "__main__":
    main()
