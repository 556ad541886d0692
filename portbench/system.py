"""The system under test: the benchmark's raw inputs handed to the port
(``mswe_gnn_tpu_torch``) through its public data path, its model built with
weights drawn on the card from the seed.

Nothing here computes a result: the port's data layer scales, pads and
tables the graph, its registry builds the model, its rollout and train step
run it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mswe_gnn_tpu_torch.data.dataset import (SimulationRecord, fit_dataset_scalers,
                                             make_spec, process_record, to_temporal_samples)
from mswe_gnn_tpu_torch.data.meshing import GhostCells, Mesh, MultiscaleMesh
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models.registry import build_model

SCALER_KINDS = {"area_scaler": "standard", "edge_length_scaler": "standard"}


def port_mesh(mesh: dict) -> MultiscaleMesh:
    """The raw multiscale grid as the port's ``MultiscaleMesh`` (global
    node ids, transfer edges as (coarse, fine) rows)."""
    meshes = [Mesh(face_xy=m["face_xy"], area=m["area"], dem=m["dem"],
                   dual_edge_index=m["edge_index"], face_distance=m["face_distance"],
                   face_relative_distance=m["face_relative_distance"],
                   edge_slope=m["edge_slope"], shared_length=m["shared_length"],
                   boundary_faces=np.zeros(0, np.int64))
              for m in mesh["meshes"]]
    node_ptr = np.cumsum([0, *[m.num_faces for m in meshes]])
    edge_ptr = np.cumsum([0, *[m.num_edges for m in meshes]])
    intra = [np.stack([te[0] + node_ptr[s + 1], te[1] + node_ptr[s]])
             for s, te in enumerate(mesh["intra"])]
    g = mesh["ghosts"]
    return MultiscaleMesh(
        meshes=meshes, node_ptr=node_ptr, edge_ptr=edge_ptr,
        intra_edge_ptr=np.cumsum([0, *[t.shape[1] for t in intra]]),
        intra_edge_index=(np.concatenate(intra, axis=1) if intra
                          else np.zeros((2, 0), np.int64)),
        ghosts=GhostCells(ghost_nodes=g["ghost_nodes"], bc_faces=g["bc_faces"],
                          edge_bc_length=g["edge_bc_length"], type_bc=2))


def port_samples(mesh: dict, scenarios: list, cfg: dict, windows=None) -> list:
    """Each scenario through ``process_record`` and ``to_temporal_samples``
    -> per scenario a list of FloodGraphs on the host. ``windows`` None
    gives each scenario's full-rollout sample; else ``windows[i]`` lists
    scenario i's first input frames of ``cfg["train"]["rollout_steps"]``-step
    training windows, one sample each."""
    ms = port_mesh(mesh)
    records = [SimulationRecord(mesh=ms, wd=s["wd"], vx=s["vx"], vy=s["vy"],
                                bc_per_length=s["bc_per_length"],
                                temporal_res=float(cfg["temporal_res"]))
               for s in scenarios]
    scalers = fit_dataset_scalers(records, SCALER_KINDS)
    spec = make_spec(ms, len(ms.ghosts.ghost_nodes), pad_multiple=cfg["pad_multiple"])
    p = cfg["previous_t"]
    out = []
    for i, rec in enumerate(records):
        proc = process_record(rec, scalers)
        if windows is None:
            out.append(to_temporal_samples(proc, spec, previous_t=p, rollout_steps=-1))
            continue
        steps = cfg["train"]["rollout_steps"]
        out.append([to_temporal_samples(proc, spec, previous_t=p, rollout_steps=steps,
                                         time_start=w, time_stop=w + steps)[0]
                    for w in windows[i]])
    return out


def unions(samples: list, batch: int) -> list:
    """Consecutive groups of ``batch`` samples, each a ``concat_graphs``
    union (a group of one is the sample itself)."""
    return [concat_graphs(samples[i:i + batch]) for i in range(0, len(samples), batch)]


def build(cfg: dict, sample, seed: int, device):
    """-> (model cfg, params, apply_fn) of ``cfg["model"]`` on ``device``,
    every parameter written by the benchmark (``draw_weights``)."""
    mcfg, params, apply_fn = build_model(
        cfg["model"], num_node_features=sample.num_node_features,
        num_edge_features=sample.edge_attr.shape[1], num_scales=sample.spec.num_scales,
        previous_t=cfg["previous_t"], seed=0, device=device)
    draw_weights(params, seed, device)
    return mcfg, params, apply_fn


def linear_leaves(tree) -> list:
    """(tensor, fan_in) of every weight and bias of a linear layer (a dict
    with a ``w`` of shape [in, out]), depth first in key order."""
    out = []
    if isinstance(tree, dict):
        if "w" in tree and isinstance(tree["w"], torch.Tensor):
            fan_in = tree["w"].shape[0]
            out += [(tree[k], fan_in) for k in sorted(tree) if k in ("w", "b")]
        else:
            for k in sorted(tree):
                out += linear_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += linear_leaves(v)
    return out


def fixed_leaves(tree) -> list:
    """(tensor, kind) of the parameters with a fixed initialisation: PReLU
    slopes (``alpha``) and the residual weights."""
    out = []
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        if isinstance(v, torch.Tensor) and k in ("alpha", "residual_weights"):
            out.append((v, k))
        else:
            out += fixed_leaves(v)
    return out


@torch.no_grad()
def draw_weights(params, seed: int, device) -> None:
    """Every linear layer's weight and bias uniform in +-1/sqrt(fan_in)
    (torch.nn.Linear's law) from ``seed``, by one draw on the card; every
    PReLU slope 0.25 (torch's) and the residual weights of ``previous_t``
    frames proportional to 2**t, summing to 1 (the reference's ``exp``
    initialisation). The port's own initial values are all overwritten."""
    leaves = linear_leaves(params)
    total = sum(t.numel() for t, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    at = 0
    for t, fan_in in leaves:
        t.copy_(flat[at:at + t.numel()].view_as(t) / math.sqrt(fan_in))
        at += t.numel()
    for t, kind in fixed_leaves(params):
        if kind == "alpha":
            t.fill_(0.25)
        else:
            w = 2.0 ** torch.arange(t.shape[0], dtype=t.dtype, device=t.device)
            t.copy_((w / w.sum())[:, None].expand_as(t))
