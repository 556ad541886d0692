"""Multi-device dry run (port of ``dryrun_multichip``, __graft_entry__.py:58-120):
one full train step of a small MSGNN on an ``n``-device ``(data, graph)``
mesh, then one ring-halo train step of the flagship-width MSGNN (3 scales,
K=5, F=64) over all ``n`` devices.

    python3 -m mswe_gnn_tpu_torch.dryrun [--devices N] [--device cuda:0]

``--device`` is a comma-separated list of ``N`` devices, or one device that
every mesh entry repeats (``--device cpu`` runs on the CPU); the default is
the visible GPUs, which must number ``N``. Each step's loss is printed and
must be finite.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mswe_gnn_tpu_torch.data.dataset import (fit_dataset_scalers, make_spec, process_record,
                                             to_temporal_samples)
from mswe_gnn_tpu_torch.data.synthetic import generate_simulation_record
from mswe_gnn_tpu_torch.graph import stack_graphs
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn, prepare_ring_graphs
from mswe_gnn_tpu_torch.parallel.sharding import make_mesh, shard_batch
from mswe_gnn_tpu_torch.training.train import TrainerOptions, make_optimizer, train_step


def build_problem(device, nx=16, ny=16, num_scales=3, previous_t=3, rollout=2, batch=2,
                  hid=32, K=2, pad_multiple=8, seed=0):
    """JAX ``_build_problem`` (__graft_entry__.py:20-47) -> (cfg, params on
    ``device``, apply_fn, one sample, the stacked batch of the first
    ``batch`` samples)."""
    rec = generate_simulation_record(seed, nx=nx, ny=ny, num_scales=num_scales,
                                     total_hours=8, substeps=2)
    scalers = fit_dataset_scalers([rec], {"area_scaler": "standard",
                                          "edge_length_scaler": "standard"})
    spec = make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), pad_multiple=pad_multiple)
    samples = to_temporal_samples(process_record(rec, scalers), spec, previous_t=previous_t,
                                  rollout_steps=rollout)
    g = samples[0]
    cfg, params, apply_fn = build_model(
        {"model_type": "MSGNN", "hid_features": hid, "K": K, "mlp_layers": 2,
         "learned_residuals": True, "with_WL": True, "gnn_activation": "tanh"},
        num_node_features=g.num_node_features, num_edge_features=g.edge_attr.shape[1],
        num_scales=num_scales, previous_t=previous_t, device=device)
    return cfg, params, apply_fn, g, stack_graphs(samples[:batch])


def dryrun_multichip(devices) -> dict:
    """The mesh train step and the ring train step over ``devices`` (a list
    of n, which may repeat one) -> their losses; raises on a non-finite
    loss."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    home = devices[0]
    n_graph = 2 if n % 2 == 0 else 1
    n_data = n // n_graph
    # padded so that every scale block splits over the graph axis
    cfg, params, apply_fn, _, batch = build_problem(home, batch=max(2, n_data),
                                                    pad_multiple=max(8, 4 * n_graph))
    mesh = make_mesh(n_data, n_graph, devices)
    opts = TrainerOptions(batch_size=batch.x_static.shape[0])
    optimizer = make_optimizer(opts, steps_per_epoch=1)
    _, _, loss = train_step(params, optimizer.init(params), shard_batch(batch, mesh),
                            apply_fn=apply_fn, cfg=cfg, rollout_steps=2, opts=opts,
                            multiscale=True, optimizer=optimizer, device=home)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    print(f"dryrun_multichip ok: mesh=({n_data}x{n_graph}), loss={float(loss):.4f}")
    out = {"mesh_loss": float(loss)}

    # the ring-halo train step at the flagship width over all n devices
    cfg_h, params_h, _, g, _ = build_problem(home, nx=32, ny=32, hid=64, K=5,
                                             pad_multiple=max(8, n))
    [g], _ = prepare_ring_graphs([g], n)
    # width-2 halos first, then the packed per-hop plan (JAX's order)
    dist_apply = (make_dist_apply_fn(devices, cfg_h, g, halo_width=2)
                  or make_dist_apply_fn(devices, cfg_h, g, overlap=True))
    if dist_apply is None:
        print("dryrun halo: ring plan unavailable for this mesh (the GSPMD path remains "
              "the fallback)")
        return out
    opts_h = TrainerOptions(batch_size=1)
    optimizer_h = make_optimizer(opts_h, steps_per_epoch=1)
    _, _, loss_h = train_step(params_h, optimizer_h.init(params_h), g.to(home),
                              apply_fn=dist_apply, cfg=cfg_h, rollout_steps=2, opts=opts_h,
                              multiscale=True, optimizer=optimizer_h, device=home)
    if not np.isfinite(float(loss_h)):
        raise AssertionError(f"non-finite halo loss {float(loss_h)}")
    print(f"dryrun halo ok: {n}-way ring TRAIN step (3-scale K=5 F=64, {g.num_nodes} nodes), "
          f"loss={float(loss_h):.4f}")
    out["ring_loss"] = float(loss_h)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-device dry run of the port")
    ap.add_argument("--devices", type=int, default=8, help="mesh size n")
    ap.add_argument("--device", default=None,
                    help="n comma-separated devices, or one to repeat (default: the GPUs)")
    args = ap.parse_args(argv)
    if args.device is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d.strip()) for d in args.device.split(",") if d.strip()]
        if len(devices) == 1:
            devices = devices * args.devices
    if len(devices) != args.devices:
        raise ValueError(f"a dry run over {args.devices} devices, {len(devices)} given")
    dryrun_multichip(devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
