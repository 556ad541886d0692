"""Where the time of the port's bench rollout (or train step, or a
Trainer epoch) goes, on one NVIDIA GPU.

    python3 -m mswe_gnn_tpu_torch.profile_rollout [--train | --trainer] [--batch B]
                                                  [--model {MSGNN,GNN}] [--trace PATH]

Builds the bench problem (bench_problem.py: 152x152 grid, 3 scales, F=64,
K=5, bf16, 47 steps), runs one rollout to warm up, then traces one rollout
with torch.profiler (CPU and CUDA activities) and prints one JSON line.
With ``--train`` it does the same for one train step of bench.py's
``bench_training`` instead (band plan attached, 6-step pushforward, remat,
batch 1), and ``steps`` counts the pushforward's model steps. ``--batch B``
runs either on the concat union of B copies of the bench graph (no band
plan). ``--model GNN`` runs either on the single-scale GNN bench problem
instead: the same grid's single-scale graph (23,168 rows) and
configs/pareto_gnn.yaml's model (F=64, K=10, 2 layers, float32), its train
step with the band plan of its one scale and ``multiscale`` False. With ``--trainer`` it traces one epoch of ``Trainer.fit`` at batch B
instead, at demo_small's width (configs/demo_small.yaml: F=64, K=4,
mlp_layers=3, 3 scales) on a synthetic set of 64x64 grids (24 training
samples, 2-step pushforward, no validation), after two warm-up epochs;
``steps`` counts its train steps, ``untraced_wall`` times three more
epochs without the profiler (``utils/profiling.timed``: seconds, host
clock, each epoch ending in a synchronize),
``resident_mb`` is the device memory held after the warm-up and
``peak_mb`` the peak of the traced epoch:

- ``wall_ms``: the traced run, host clock, ending in a synchronize;
- ``device_busy_ms``: the union of the GPU kernel and copy intervals, and
  ``idle_share`` = 1 - busy / wall;
- ``kernels_per_step``: GPU kernels launched per rollout step;
- ``top``: the kernels with the most device time (name, count, ms);
- ``spans``: the port's span table of the traced run
  (``utils/profiling.span_table``): per span its count, host ms, device ms
  and self device ms (a ``mswe.sync.*`` span's count is the blocking reads
  of the device at its site).

``--trace`` also writes the Chrome trace. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from functools import partial

import torch
from torch.profiler import ProfilerActivity, profile

from mswe_gnn_tpu_torch.bench_problem import (build_bench_model, build_bench_sample,
                                              build_bench_train_step, build_pareto_gnn_model)
from mswe_gnn_tpu_torch.data.dataset import (fit_dataset_scalers, make_spec, process_record,
                                             to_temporal_samples, union_spec)
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.training.rollout import rollout
from mswe_gnn_tpu_torch.training.train import Trainer, TrainerOptions
from mswe_gnn_tpu_torch.utils.profiling import reset_spans, span_table, timed


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


def bench_run(train, batch, device, model="MSGNN"):
    """-> (a call of one bench rollout, or with ``train`` one bench train
    step, on the union of ``batch`` bench graphs; its model steps).
    ``model="GNN"``: the single-scale graph and pareto_gnn's model."""
    if model == "GNN":
        sample, _ = build_bench_sample(band=train, num_scales=1)
        cfg, params, apply_fn = build_pareto_gnn_model(sample, device=device)
    else:
        sample, _ = build_bench_sample(band=train)
        cfg, params, apply_fn = build_bench_model(sample, device=device)
    if train:
        run = build_bench_train_step(sample, cfg, params, apply_fn, device=device,
                                     batch=batch, multiscale=model == "MSGNN")
        return run, run.rollout_steps
    graph = concat_graphs([sample] * batch).to(device)
    steps = sample.y.shape[-1]
    return partial(rollout, apply_fn, params, cfg, graph, steps, device=device), steps


def trainer_epoch(batch, device):
    """-> (a call of one more epoch of a Trainer at batch ``batch``, made
    after two warm-up epochs; its train steps)."""
    records = generate_dataset(4, seed=0, nx=64, ny=64, num_scales=3, total_hours=12,
                               substeps=8)
    scalers = fit_dataset_scalers(records, {"area_scaler": "standard",
                                            "edge_length_scaler": "standard"})
    spec = union_spec([make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 128)
                       for r in records])
    train = [s for r in records for s in to_temporal_samples(
        process_record(r, scalers), spec, previous_t=3, rollout_steps=2)][:24]
    g = train[0]
    cfg, params, apply_fn = build_model(
        {"model_type": "MSGNN", "hid_features": 64, "K": 4, "mlp_layers": 3,
         "learned_residuals": True, "with_WL": True},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=3, device=device)
    opts = TrainerOptions(batch_size=batch, curriculum_epoch=1, max_rollout_steps=2,
                          velocity_scaler=7.0)
    trainer = Trainer(apply_fn, cfg, params, opts, train, [], device=device)
    trainer.fit(max_epochs=2)

    def run():
        trainer.start_epoch = len(trainer.history)
        trainer.fit(max_epochs=trainer.start_epoch + 1)
    return run, len(train) // batch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trace", help="write the Chrome trace to this path")
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--train", action="store_true",
                        help="profile one bench train step instead of the rollout")
    parser.add_argument("--trainer", action="store_true",
                        help="profile one Trainer epoch instead of the rollout")
    parser.add_argument("--batch", type=int, default=1,
                        help="graphs in the concat union (default 1)")
    parser.add_argument("--model", choices=("MSGNN", "GNN"), default="MSGNN",
                        help="the bench MSGNN (default) or the single-scale GNN of "
                             "configs/pareto_gnn.yaml on the single-scale graph")
    args = parser.parse_args(argv)
    if args.trainer and args.model != "MSGNN":
        parser.error("--trainer profiles demo_small's MSGNN only")
    if not torch.cuda.is_available():
        sys.exit("profile_rollout: no CUDA device")
    device = torch.device("cuda")
    extra = {}
    if args.trainer:
        run, steps = trainer_epoch(args.batch, device)
        extra["resident_mb"] = torch.cuda.memory_allocated() / 2 ** 20
        extra["untraced_wall"] = timed(run, reps=3, warmup=0)
        torch.cuda.reset_peak_memory_stats()
    else:
        run, steps = bench_run(args.train, args.batch, device, args.model)
        run()
    torch.cuda.synchronize()

    reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trainer:
        extra["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
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
        "run": "trainer_epoch" if args.trainer else "train_step" if args.train else "rollout",
        "model": args.model, "steps": steps, "batch": args.batch,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(events) / steps,
        "top": [{"name": n[:80], "count": c, "ms": ms} for n, (c, ms) in top],
        "spans": {name: {"count": row["count"], "host_ms": row["host_s"] * 1e3,
                         "device_ms": row["device_s"] * 1e3,
                         "self_device_ms": row["self_device_s"] * 1e3}
                  for name, row in span_table().items()},
        **extra,
    }
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
