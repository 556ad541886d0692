"""Ring-halo training: the ring MSGNN forward packaged as an ``apply_fn`` (port
of mswe_gnn_tpu/parallel/dist_train.py), so that the trainer, the pushforward
loss, the rollout and the evaluation run through the graph-parallel path
unchanged.

The regime is one mesh shared by every sample (the temporal windows of one
simulation, or a corpus on one grid): its ring plans are built once, from a
template graph, and each call only splits the node features over the parts.
Gradients flow through the exchanges and the parameter copies by autograd
(``dist_swegnn.py``'s module docstring), so ``loss_and_grads`` through this
``apply_fn`` gives the single-device gradients up to float sums.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.parallel.dist_swegnn import (
    apply_ring_order, build_dist_msgnn_inputs, make_dist_msgnn_forward, place_dist_inputs,
    ring_order,
)


def make_dist_apply_fn(devices: Sequence, cfg, template: FloodGraph,
                       overlap: bool = False, halo_width: int = 1) -> Optional[Callable]:
    """``apply_fn(params, cfg, graph) -> [N, 2]`` through the ring MSGNN over
    ``devices`` (one part each, JAX dist_train.py:34-78), or None when the
    template's partition is not ring-adjacent (``dist_swegnn.
    ring_plan_failure`` says why).

    The plans are built from ``template`` and placed on the devices once;
    every graph passed in must share the template's topology and spec (the
    same mesh in the same ring order). The predictions come back on the
    graph's device, where the parameters are (the home device).
    ``overlap`` packs the halo slots (``build_dist_msgnn_inputs``);
    ``halo_width`` > 1 takes width-W plans; the two are exclusive."""
    devices = [torch.device(d) for d in devices]
    n_parts = len(devices)
    dist = build_dist_msgnn_inputs(template, n_parts, overlap=overlap, halo_width=halo_width)
    if dist is None:
        return None
    plans = place_dist_inputs(dist, devices)
    fwd = make_dist_msgnn_forward(devices, cfg)
    spec = template.spec
    node_ptr, L = spec.node_ptr, spec.num_scales

    def split(x: torch.Tensor, i: int) -> List[torch.Tensor]:
        return [b.to(d) for b, d in zip(x[node_ptr[i]: node_ptr[i + 1]].chunk(n_parts), devices)]

    def apply_fn(params, _cfg, g: FloodGraph) -> torch.Tensor:
        if g.spec != spec:
            raise ValueError(f"the ring plans were built for {spec}, not {g.spec}; the ring "
                             "path takes one graph of the template's mesh (batch 1)")
        dist_g = {**plans,
                  "x_static": [split(g.x_static, i) for i in range(L)],
                  "x_dynamic": [split(g.x_dynamic, i) for i in range(L)],
                  "node_mask": [split(g.node_mask, i) for i in range(L)]}
        home = g.x_static.device
        return torch.cat([o.to(home) for outs in fwd(params, dist_g) for o in outs], dim=0)

    return apply_fn


def _same_topology(a: FloodGraph, b: FloodGraph) -> bool:
    """Whether ``ring_order`` gives ``a`` and ``b`` one permutation: the
    arrays it reads are equal."""
    return a.spec == b.spec and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("edge_index", "edge_mask", "node_mask", "intra_edge_index",
                  "intra_edge_mask"))


def prepare_ring_graphs(graphs: Sequence[FloodGraph], n_parts: int
                        ) -> Tuple[List[FloodGraph], np.ndarray]:
    """Ring-reorder same-topology samples with ONE permutation, computed on the
    first (JAX dist_train.py:81-95) -> (reordered graphs, permutation). A
    sample whose order arrays equal the first's takes its permutation
    directly; another one is ordered itself, and raises when its
    permutation differs: mixed meshes take the GSPMD data x graph mesh
    (``parallel: {mode: gspmd}``)."""
    perm = ring_order(graphs[0])
    out = []
    for g in graphs:
        if g is not graphs[0] and not _same_topology(g, graphs[0]):
            if not np.array_equal(ring_order(g), perm):
                raise ValueError(
                    "ring_halo training requires every sample to share one mesh topology "
                    "(the large-single-mesh regime); mixed meshes take the GSPMD data x "
                    "graph mesh (parallel: {mode: gspmd})")
        out.append(apply_ring_order(g, perm))
    return out, perm
