"""The model on a mesh row: its node rows split over the row's ``graph``
devices, the port's counterpart of the partitioning XLA's GSPMD inserts for
the JAX package's ``(data, graph)`` mesh (mswe_gnn_tpu/parallel/sharding.py
shards the node axes; XLA writes the collectives).

Row blocks with gathered sources: part p of a row holds rows ``[lo_p,
hi_p)`` of every scale (``Tensor.tensor_split``, so a count need not
divide). Before each hop, pooling and un-pooling step the row gathers the
whole source state, ``torch.cat`` of the blocks moved to each part's device
(``dist_swegnn.gather_all``), and each part runs the ELL hop kernel on its
own rows against it: the separate-source call ``ops/hop.py::hop(block,
whole, ...)`` whose slot table is the scale's own table cut to the block's
rows. Encoders, node MLPs and the decoder are row-local. The layers are
the ring path's (``dist_swegnn._dist_layer_local``, ``_pool_cross``) with
this "halo" of every other row, so a part follows the single-device model
operation for operation, its bf16 policy included; the split needs no ring
adjacency and works on every graph.

Gradients: the backward of a separate-source hop returns the block's and the
whole source's gradients apart (``hop_backward``), and autograd sums the
latter back over the blocks through the gather; the parameters are copied
to each part's device inside the forward (``dist_swegnn.replicate``), so
their gradients sum on the device the caller holds them on.

A ``RowModel`` places once: the slot tables cut into blocks, the out-slot
tables the hop backward reads (over the whole source scale) and the raw
slot edge features, on the parts' devices. A call then only splits the
node features. ``row_model`` keeps it across batches, so that a run whose
unions share their tables (every batch of one mesh's samples) builds it
once.

Covered: the MSGNN with mean pooling and the single-scale SWE-GNN. The
Cheb / TAG / GAT baselines and learned pooling raise under ``graph > 1``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch

from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models.prepare import _rebase, _slot_sources
from mswe_gnn_tpu_torch.ops.hop import out_slot_table
from mswe_gnn_tpu_torch.parallel.dist_swegnn import (_encode_ea, encode_dist_edges,
                                                     gnn_parts_forward, make_dist_msgnn_forward,
                                                     replicate)

# the fields a RowModel's plans are built from
TOPOLOGY = ("edge_index", "edge_attr", "in_edge_table", "in_edge_mask", "intra_edge_index",
            "pool_table", "pool_mask", "unpool_table", "unpool_mask")
LATER = ("waits for a later slice of the port (ROADMAP Queue 1); it runs at graph = 1, "
         "and data parallelism covers it")


def _blocks(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """``x [N, ...]`` -> its row blocks (``tensor_split``), block p on
    ``devices[p]``."""
    return [b.contiguous().to(d) for b, d in zip(x.tensor_split(len(devices)), devices)]


def _slot_plan(srcs: torch.Tensor, mask: torch.Tensor, n_src: int, devices,
               ea=None, backward: bool = True) -> dict:
    """A scale-local slot table ``srcs [N, D]`` (sources: rows of an
    ``n_src``-row state) cut into the parts' row blocks, in the layout of
    ``dist_swegnn.place_slot_plan``: one slot group that reads the gathered
    state, with each block's out-slot table over all ``n_src`` rows where
    a hop backward reads it, and the block's raw slot edge features
    ``ea``."""
    tabs = _blocks(srcs.to(torch.int32), devices)
    masks = _blocks(mask.float(), devices)
    group = {"lo": 0, "hi": srcs.shape[1], "buffered": True, "tab": tabs, "mask": masks,
             "out_table": [out_slot_table(t, n_src, m) if backward else None
                           for t, m in zip(tabs, masks)]}
    if ea is not None:
        group["ea"] = _blocks(ea.float(), devices)
    return {"groups": [group], "gather": True}


def _check_blocks(counts: Sequence[int], parts: int) -> None:
    if min(counts) < parts:
        raise ValueError(f"a scale of {min(counts)} rows cannot be split over {parts} "
                         f"devices (node counts {list(counts)})")


def msgnn_row_plans(graph: FloodGraph, devices) -> dict:
    """The MSGNN's placed row plans for ``graph`` (a union, on any device):
    per scale the processor table (``proc``), per level the pooling table
    (coarse rows, fine sources) and the un-pooling table (fine rows, coarse
    sources), the dicts ``make_dist_msgnn_forward`` reads."""
    spec = graph.spec
    _check_blocks(spec.node_counts, len(devices))
    proc, pool, unpool = [], [], []
    with torch.no_grad():
        for i in range(spec.num_scales):
            nsl, esl = spec.node_slice(i), spec.edge_slice(i)
            tab = _rebase(graph.in_edge_table[nsl], spec.edge_ptr[i])
            mask = graph.in_edge_mask[nsl]
            srcs = _slot_sources(graph.edge_index[0, esl].long() - spec.node_ptr[i], tab)
            ea = (graph.edge_attr[esl].index_select(0, tab.reshape(-1))
                  .view(*tab.shape, -1) * mask[..., None])
            proc.append(_slot_plan(srcs, mask, spec.node_counts[i], devices, ea))
        for lvl in range(spec.num_scales - 1):
            isl = spec.intra_edge_slice(lvl)
            fine = graph.intra_edge_index[1, isl].long() - spec.node_ptr[lvl]
            coarse = graph.intra_edge_index[0, isl].long() - spec.node_ptr[lvl + 1]
            csl, fsl = spec.node_slice(lvl + 1), spec.node_slice(lvl)
            ptab = _rebase(graph.pool_table[csl], spec.intra_edge_ptr[lvl])
            pool.append(_slot_plan(_slot_sources(fine, ptab), graph.pool_mask[csl],
                                   spec.node_counts[lvl], devices, backward=False))
            utab = _rebase(graph.unpool_table[fsl], spec.intra_edge_ptr[lvl])
            unpool.append(_slot_plan(_slot_sources(coarse, utab), graph.unpool_mask[fsl],
                                     spec.node_counts[lvl + 1], devices))
    return {"devices": list(devices), "proc": proc, "pool": pool, "unpool": unpool}


def gnn_row_plan(graph: FloodGraph, devices) -> dict:
    """The single-scale SWE-GNN's placed row plan: its one slot table over
    every node of the graph (as ``models/prepare.py::_gnn_cache``)."""
    _check_blocks([graph.num_nodes], len(devices))
    with torch.no_grad():
        tab = graph.in_edge_table.long()
        mask = graph.in_edge_mask
        srcs = _slot_sources(graph.edge_index[0].long(), tab)
        ea = graph.edge_attr.index_select(0, tab.reshape(-1)).view(*tab.shape, -1) * mask[..., None]
        return _slot_plan(srcs, mask, graph.num_nodes, devices, ea)


class RowModel:
    """``cfg``'s model over the row blocks of one row's graph (a union of
    the row's graphs): ``encode_edges(params)`` once a rollout or a loss,
    then ``model(params, graph, encoded)`` a step -> ``[N, 2]`` on the
    graph's device. ``graph`` must share the planned graph's topology (the
    rollout's and the loss's per-step graphs do: only node features
    change)."""

    def __init__(self, cfg, graph: FloodGraph, devices):
        self.devices = [torch.device(d) for d in devices]
        self.cfg = cfg
        kind = type(cfg).__name__
        self._fwd = None              # the MSGNN's forward; None for the GNN
        if kind == "MSGNNConfig":
            if cfg.learned_pooling:
                raise NotImplementedError(f"learned pooling under parallel.graph > 1 {LATER}")
            self.plans = msgnn_row_plans(graph, self.devices)
            self._fwd = make_dist_msgnn_forward(self.devices, cfg)
        elif kind == "GNNConfig" and cfg.type_gnn == "SWEGNN":
            self.plans = gnn_row_plan(graph, self.devices)
        else:
            raise NotImplementedError(
                f"{getattr(cfg, 'type_gnn', kind)} under parallel.graph > 1 {LATER}")
        self.spec = graph.spec
        self.tables = [getattr(graph, k) for k in TOPOLOGY]

    def fits(self, graph: FloodGraph) -> bool:
        """Whether ``graph`` has the tables this model was placed for."""
        return graph.spec == self.spec and all(
            torch.equal(a, getattr(graph, k)) for a, k in zip(self.tables, TOPOLOGY))

    def encode_edges(self, params) -> list:
        """The encoded slot edge features of every part (with gradients, in a
        loss)."""
        reps = replicate(params, self.devices)
        if self._fwd is not None:
            return encode_dist_edges(reps, self.cfg, self.plans)
        return [_encode_ea(reps, self.cfg, self.plans["groups"][0]["ea"])]

    def __call__(self, params, graph: FloodGraph, encoded=None) -> torch.Tensor:
        home = graph.x_static.device
        spec, devices = self.spec, self.devices
        if self._fwd is not None:
            def per_scale(x):
                return [_blocks(x[spec.node_slice(i)], devices) for i in range(spec.num_scales)]

            outs = self._fwd(params, {**self.plans, "x_static": per_scale(graph.x_static),
                                      "x_dynamic": per_scale(graph.x_dynamic),
                                      "node_mask": per_scale(graph.node_mask)}, encoded)
            blocks = [o for scale in outs for o in scale]
        else:
            blocks = gnn_parts_forward(replicate(params, devices), self.cfg, devices,
                                       _blocks(graph.x_static, devices),
                                       _blocks(graph.x_dynamic, devices),
                                       _blocks(graph.node_mask, devices), self.plans, encoded)
        return torch.cat([b.to(home) for b in blocks], dim=0)


_ROW_MODELS: "OrderedDict[tuple, RowModel]" = OrderedDict()
_KEEP = 8


def row_model(row, cfg) -> RowModel:
    """The placed ``RowModel`` of a ``sharding.RowBatch`` for ``cfg``: the
    one kept for the same config, spec and devices where the row's union
    has the tables it was placed for (``RowModel.fits``), else a new one,
    kept in its place (the last ``_KEEP`` keys are kept). One built under
    inference mode is kept apart: its tables cannot enter a backward."""
    key = (cfg, row.graph.spec, tuple(row.devices), torch.is_inference_mode_enabled())
    model = _ROW_MODELS.get(key)
    if model is None or not model.fits(row.graph):
        model = _ROW_MODELS[key] = RowModel(cfg, row.graph, row.devices)
    _ROW_MODELS.move_to_end(key)
    while len(_ROW_MODELS) > _KEEP:
        _ROW_MODELS.popitem(last=False)
    return model
