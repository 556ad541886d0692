"""Why the ring's float32 train-step gradients differ from the single-device
port's on a few leaves: the reading of ``chip_smoke.py`` phase 13 (b)
(``hold_ring_grads``) beside controls that only change rounding.

On the bench graph, ring-reordered, in float32, phase 5's 6-step
pushforward with remat, each gradient tree against the single-device
port's (``chip_smoke.compare_grads`` and the leaves past phase 5's limit
of 1e-4 max|leaf| + 1e-12):

- the ring at 8 and at 2 parts;
- one device on the graph's original row order (the same sums, reordered);
- one device through the plain hops (phase 5's own comparison);
- one device again (repeatability under deterministic algorithms);
- one device with ``x_dynamic`` one float32 ulp up (``* (1 + 2**-23)``):
  how far rounding alone moves each leaf.

And whether float32 matmuls over row blocks give the bits of one matmul
over all rows (the ring's encoders and flux MLPs run per part). Needs the
GPU and nvcc; from the root of the repo:

    PYTHONPATH=. python3 tests/torch_port_ring_grads.py
"""
from __future__ import annotations

import dataclasses

import torch

import chip_smoke
from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.bench_problem import build_bench_model, build_bench_sample
from mswe_gnn_tpu_torch.models.msgnn import apply_msgnn
from mswe_gnn_tpu_torch.parallel.dist_swegnn import reorder_graph_for_ring
from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn
from mswe_gnn_tpu_torch.training.train import TrainerOptions, loss_and_grads


def matmul_blocks(device) -> None:
    g = torch.Generator().manual_seed(0)
    for rows, k in ((23168, 64), (5888, 64), (92672, 192), (30592, 7)):
        x = torch.randn(rows, k, generator=g).to(device)
        w = torch.randn(k, 64, generator=g).to(device)
        whole = x @ w
        blocks = torch.cat([c @ w for c in x.chunk(8)])
        print(f"matmul [{rows}, {k}] @ [{k}, 64], whole vs 8 row blocks: bit-equal "
              f"{bool(torch.equal(whole, blocks))}, elements that differ "
              f"{int((whole != blocks).sum())} of {whole.numel()}", flush=True)


def main() -> None:
    smi = chip_smoke.phase_device()
    device = torch.device("cuda")
    matmul_blocks(device)
    sample, _ = build_bench_sample()
    cfg, params, _ = build_bench_model(sample, device=device)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ring_graph, _ = reorder_graph_for_ring(sample, 8)
    graph = ring_graph.to(device)
    opts = TrainerOptions(batch_size=1, velocity_scaler=7.0, remat=True)

    def grads(apply_fn, g, plain=False):
        with chip_smoke.deterministic("ring grads"):
            if plain:
                with chip_smoke.plain_hops():
                    return loss_and_grads(apply_fn, params, cfg, g, 6, opts, True)
            return loss_and_grads(apply_fn, params, cfg, g, 6, opts, True)

    single = grads(apply_msgnn, graph)
    runs = {
        "ring, 8 parts": grads(make_dist_apply_fn([device] * 8, cfg, graph), graph),
        "ring, 2 parts": grads(make_dist_apply_fn([device] * 2, cfg, graph), graph),
        "one device, the original row order": grads(apply_msgnn, sample.to(device)),
        "one device, plain hops": grads(apply_msgnn, graph, plain=True),
        "one device again": grads(apply_msgnn, graph),
        "one device, x_dynamic one ulp up": grads(
            apply_msgnn, graph.replace(x_dynamic=graph.x_dynamic * (1 + 2.0 ** -23))),
    }
    names = chip_smoke.leaf_names(single[1])
    for what, (loss, tree) in runs.items():
        r = chip_smoke.compare_grads(loss, tree, *single)
        past = [(n, float((a - b).abs().max()), float(b.abs().max()))
                for n, a, b in zip(names, tree_leaves(tree), tree_leaves(single[1]))
                if float((a - b).abs().max()) > 1e-4 * float(b.abs().max()) + 1e-12]
        print(f"{what} vs one device: loss rel {r['loss_rel']:.3e}, cosine {r['cos']:.9f}, "
              f"relative L2 {r['rel']:.3e}; worst leaves "
              + "; ".join(f"{n} {q:.3e} (max|diff| {d:.3e}, max|leaf| {m:.3e})"
                          for n, q, d, m in r["worst"])
              + f"; past phase 5's limit: {len(past)} "
              + "".join(f"({n}: max|diff| {d:.3e}, max|leaf| {m:.3e})" for n, d, m in past),
              flush=True)
    print(smi)


if __name__ == "__main__":
    main()
