"""Where the time of the port's bench rollout (or train step) goes, on one
NVIDIA GPU.

    python3 -m mswe_gnn_tpu_torch.profile_rollout [--train] [--trace PATH]

Builds the bench problem (bench_problem.py: 152x152 grid, 3 scales, F=64,
K=5, bf16, 47 steps), runs one rollout to warm up, then traces one rollout
with torch.profiler (CPU and CUDA activities) and prints one JSON line.
With ``--train`` it does the same for one train step of bench.py's
``bench_training`` instead (band plan attached, 6-step pushforward, remat,
batch 1), and ``steps`` counts the pushforward's model steps:

- ``wall_ms``: the traced run, host clock, ending in a synchronize;
- ``device_busy_ms``: the union of the GPU kernel and copy intervals, and
  ``idle_share`` = 1 - busy / wall;
- ``kernels_per_step``: GPU kernels launched per rollout step;
- ``top``: the kernels with the most device time (name, count, ms).

``--trace`` also writes the Chrome trace. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from mswe_gnn_tpu_torch.bench_problem import (build_bench_model, build_bench_sample,
                                              build_bench_train_step)
from mswe_gnn_tpu_torch.training.rollout import rollout


def device_intervals(prof):
    """(name, start_us, end_us) of every event the profiler saw on the GPU."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.start, evt.time_range.end))
    return out


def union_us(intervals) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trace", help="write the Chrome trace to this path")
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--train", action="store_true",
                        help="profile one bench train step instead of the rollout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_rollout: no CUDA device")
    device = torch.device("cuda")
    sample, _ = build_bench_sample(band=args.train)
    cfg, params, apply_fn = build_bench_model(sample, device=device)
    if args.train:
        run = build_bench_train_step(sample, cfg, params, apply_fn, device=device)
        steps = run.rollout_steps
    else:
        graph = sample.to(device)
        steps = sample.y.shape[-1]

        def run():
            rollout(apply_fn, params, cfg, graph, steps, device=device)
    run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_intervals(prof)
    if not events:
        sys.exit("profile_rollout: the profiler recorded no device activity")
    busy_ms = union_us([(s, e) for _, s, e in events]) / 1e3
    per_name = defaultdict(lambda: [0, 0.0])
    for name, start, end in events:
        per_name[name][0] += 1
        per_name[name][1] += (end - start) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    result = {
        "device": torch.cuda.get_device_name(0),
        "run": "train_step" if args.train else "rollout", "steps": steps,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(events) / steps,
        "top": [{"name": n[:80], "count": c, "ms": ms} for n, (c, ms) in top],
    }
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
