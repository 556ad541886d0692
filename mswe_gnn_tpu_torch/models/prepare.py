"""Loop-invariant graph work, done once per rollout (port of
mswe_gnn_tpu/models/prepare.py: the MSGNN and the single-scale SWE-GNN).

Per rollout step the model would recompute work that depends only on the
parameters and the graph topology: the encoded edge features, the
slot-gathered edge features, the int32 slot-source tables that the hop
kernels read and, with gradients on, the out-slot tables (for every source
row, the slots that read it) that the hop backward kernels read; with
gradients off (the rollout) no backward runs, and they are left None.
``prepare_graph`` computes them once and stores them on
``FloodGraph.ell_cache``; the same operations run, once instead of T times.

Training builds the cache inside the loss, every step, with gradients on
(``training/train.py``), so that the edge encoder gets its gradient: a
graph that arrives with a cache attached would cut it off.

A ``concat_graphs`` union's tables are built the same way, on its global
rows: a scale block holds the graphs' sub-blocks back to back and every
slot reads a row of its own graph, so ``_check_rows`` holds each table to
the union's block.
"""
from __future__ import annotations

import torch

from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models.mlp import apply_mlp
from mswe_gnn_tpu_torch.ops.hop import out_slot_table


def _slot_sources(src_local: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """[E_local] source ids + [N, D] slot->edge table -> [N, D] int32 slot
    source rows."""
    return src_local.index_select(0, tab.reshape(-1)).view(tab.shape).to(torch.int32)


def _rebase(table: torch.Tensor, ptr: int) -> torch.Tensor:
    """Global ids -> ids local to a block starting at ``ptr``. Masked slots
    hold global id 0, which is clamped to the block's first entry (their
    contribution is multiplied by 0)."""
    return (table.long() - ptr).clamp_min(0)


def _check_rows(tab: torch.Tensor, rows: int, what: str) -> None:
    lo, hi = int(tab.min()), int(tab.max())
    if lo < 0 or hi >= rows:
        raise ValueError(f"{what} refers to rows [{lo}, {hi}] outside [0, {rows})")


def _out_table(srcs: torch.Tensor, n_src: int, mask: torch.Tensor, what: str):
    """The out-slot table of a hop for its backward kernel, or None with
    gradients off."""
    if not torch.is_grad_enabled():
        return None
    out_ptr, out_slots = out_slot_table(srcs, n_src, mask)
    _check_rows(out_slots, max(srcs.numel(), 1), what)
    return out_ptr, out_slots


def _msgnn_cache(params: dict, cfg, graph: FloodGraph) -> dict:
    spec = graph.spec
    edge_attr = graph.edge_attr
    if cfg.edge_mlp:
        edge_attr = apply_mlp(params["edge_encoder"], edge_attr,
                              activation=cfg.mlp_activation)
    scales = []
    for i in range(cfg.num_scales):
        nsl, esl = spec.node_slice(i), spec.edge_slice(i)
        tab = _rebase(graph.in_edge_table[nsl], spec.edge_ptr[i])
        src_local = graph.edge_index[0, esl].long() - spec.node_ptr[i]
        ea = edge_attr[esl]
        ea_slots = ea.index_select(0, tab.reshape(-1)).view(*tab.shape, -1)
        srcs = _slot_sources(src_local, tab)
        _check_rows(srcs, spec.node_counts[i], f"scale {i} slot sources")
        # masked slots carry zero flux: the out-slot table leaves them out
        # (this also serves the band kernels, whose real slots read the
        # same rows)
        out_table = _out_table(srcs, spec.node_counts[i], graph.in_edge_mask[nsl],
                               f"scale {i} out-slots")
        scales.append((tab, graph.in_edge_mask[nsl], srcs, ea_slots, out_table))
    pools, unpools = [], []
    for lvl in range(cfg.num_scales - 1):
        isl = spec.intra_edge_slice(lvl)
        fine_local = graph.intra_edge_index[1, isl].long() - spec.node_ptr[lvl]
        coarse_local = graph.intra_edge_index[0, isl].long() - spec.node_ptr[lvl + 1]
        csl, fsl = spec.node_slice(lvl + 1), spec.node_slice(lvl)
        ptab = _rebase(graph.pool_table[csl], spec.intra_edge_ptr[lvl])
        psrc = _slot_sources(fine_local, ptab)
        _check_rows(psrc, spec.node_counts[lvl], f"level {lvl} pool sources")
        pools.append((psrc, graph.pool_mask[csl]))
        utab = _rebase(graph.unpool_table[fsl], spec.intra_edge_ptr[lvl])
        usrc = _slot_sources(coarse_local, utab)
        _check_rows(usrc, spec.node_counts[lvl + 1], f"level {lvl} un-pool sources")
        out_table = _out_table(usrc, spec.node_counts[lvl + 1], graph.unpool_mask[fsl],
                               f"level {lvl} un-pool out-slots")
        unpools.append((utab, graph.unpool_mask[fsl], usrc, out_table))
    return {"scales": tuple(scales), "pools": tuple(pools),
            "unpools": tuple(unpools)}


def _gnn_cache(params: dict, cfg, graph: FloodGraph) -> dict:
    """The single-scale GNN's one table set, over every node of the graph
    (JAX prepare.py:63-74), in the layout of the MSGNN cache's scales (no
    pooling levels)."""
    edge_attr = graph.edge_attr
    if cfg.edge_mlp:
        edge_attr = apply_mlp(params["edge_encoder"], edge_attr,
                              activation=cfg.mlp_activation)
    tab = graph.in_edge_table.long()
    ea_slots = edge_attr.index_select(0, tab.reshape(-1)).view(*tab.shape, -1)
    srcs = _slot_sources(graph.edge_index[0].long(), tab)
    _check_rows(srcs, graph.num_nodes, "slot sources")
    out_table = _out_table(srcs, graph.num_nodes, graph.in_edge_mask, "out-slots")
    return {"scales": ((tab, graph.in_edge_mask, srcs, ea_slots, out_table),),
            "pools": (), "unpools": ()}


def prepare_graph(params: dict, cfg, graph: FloodGraph) -> FloodGraph:
    """Attach the loop-invariant ELL cache for ``cfg``'s model family
    (JAX prepare.py:77-89). The graph comes back unchanged when a cache is
    already attached or the model has no cached path (the Cheb / TAG / GAT
    baselines)."""
    if graph.ell_cache is not None:
        return graph
    kind = type(cfg).__name__     # by name: the model modules import this one
    if kind == "MSGNNConfig":
        return graph.replace(ell_cache=_msgnn_cache(params, cfg, graph))
    if kind == "GNNConfig" and getattr(cfg, "type_gnn", None) == "SWEGNN":
        return graph.replace(ell_cache=_gnn_cache(params, cfg, graph))
    return graph
