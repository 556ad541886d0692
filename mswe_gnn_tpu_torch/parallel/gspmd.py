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

The Cheb / TAG / GAT baselines split the same way, by edges: part p owns
the edges whose destination lies in its block, in their one-device order,
padded edges included. Before each adjacency mat-vec (Cheb: K - 1 a layer,
TAG: K) and each GAT layer the row gathers the whole state, and each part
reduces its own edges against it (``ops/segment.py``). The normalised
adjacency's edge coefficients read the degree of every source, so they are
computed over the whole graph once, when the model is placed, and cut into
the blocks. Learned pooling splits the transfer edges by their coarse node:
each part runs the pooling MLP over its own transfer edges, fine rows from
the gathered fine state, coarse rows from its own block, and takes the
segment mean over them. Each part's sums add the one-device sums' terms in
their order, so a placed forward on the CPU equals the one-device one up
to the rounding of a matmul over fewer rows.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import List, Sequence

import torch
import torch.nn.functional as F

from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models.activations import apply_activation
from mswe_gnn_tpu_torch.models.convs import _sym_norm_coeffs
from mswe_gnn_tpu_torch.models.mlp import apply_linear, apply_mlp
from mswe_gnn_tpu_torch.models.msgnn import _learned_pool_block
from mswe_gnn_tpu_torch.models.prepare import _rebase, _slot_sources
from mswe_gnn_tpu_torch.ops.hop import out_slot_table
from mswe_gnn_tpu_torch.ops.segment import gather, segment_max_raw, segment_sum
from mswe_gnn_tpu_torch.parallel.dist_swegnn import (_decode, _encode_ea, _split_x,
                                                     encode_dist_edges, gather_all,
                                                     gnn_parts_forward, make_dist_msgnn_forward,
                                                     replicate)

# the fields a RowModel's plans are built from
TOPOLOGY = ("edge_index", "edge_attr", "edge_mask", "in_edge_table", "in_edge_mask",
            "intra_edge_index", "intra_edge_mask", "pool_table", "pool_mask", "unpool_table",
            "unpool_mask")


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


def _bounds(n: int, parts: int) -> List[int]:
    """The boundaries of the row blocks ``_blocks`` cuts ``n`` rows into."""
    return [0, *itertools.accumulate(len(b) for b in torch.arange(n).tensor_split(parts))]


def _edge_blocks(rows: torch.Tensor, n: int, devices, **fields) -> dict:
    """The edges owned by each row block of ``n`` rows: those whose row
    ``rows`` (the destination) lies in the block, in their order. Returns
    ``dst_local`` (the row rebased to the block) and each of ``fields``
    (per-edge tensors) cut the same way, as lists over parts on the parts'
    devices."""
    bounds = _bounds(n, len(devices))
    out = {"dst_local": []}
    out.update({k: [] for k in fields})
    for p, d in enumerate(devices):
        idx = ((rows >= bounds[p]) & (rows < bounds[p + 1])).nonzero()[:, 0]
        out["dst_local"].append((rows[idx] - bounds[p]).to(d))
        for k, v in fields.items():
            out[k].append(v[idx].contiguous().to(d))
    return out


def _check_blocks(counts: Sequence[int], parts: int) -> None:
    if min(counts) < parts:
        raise ValueError(f"a scale of {min(counts)} rows cannot be split over {parts} "
                         f"devices (node counts {list(counts)})")


def msgnn_row_plans(graph: FloodGraph, devices, learned_pooling: bool = False) -> dict:
    """The MSGNN's placed row plans for ``graph`` (a union, on any device):
    per scale the processor table (``proc``), per level the pooling table
    (coarse rows, fine sources) and the un-pooling table (fine rows, coarse
    sources), the dicts ``make_dist_msgnn_forward`` reads. With
    ``learned_pooling`` a level's pooling plan is its transfer edges by
    coarse block instead (``fine``: fine rows of the scale, ``dst_local``:
    coarse rows of the block, ``mask``)."""
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
            if learned_pooling:
                pool.append(_edge_blocks(coarse, spec.node_counts[lvl + 1], devices, fine=fine,
                                         mask=graph.intra_edge_mask[isl].float()))
            else:
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


def baseline_row_plan(graph: FloodGraph, devices) -> dict:
    """A baseline's (Cheb / TAG / GAT) placed row plan: each block's edges
    by destination (``_edge_blocks``), their global sources and
    destinations, mask and normalised-adjacency coefficients, the latter
    computed over the whole graph (``models/convs.py::_sym_norm_coeffs``)."""
    n = graph.num_nodes
    _check_blocks([n], len(devices))
    with torch.no_grad():
        src, dst = graph.edge_index[0].long(), graph.edge_index[1].long()
        coeff, _ = _sym_norm_coeffs(src, dst, graph.edge_mask, n, add_self_loops=False)
        return _edge_blocks(dst, n, devices, src=src, dst=dst, mask=graph.edge_mask,
                            coeff=coeff)


def _learned_pool(cfg, devices):
    """The learned pooling of the MSGNN's row blocks, the ``pool`` of
    ``make_dist_msgnn_forward``: the pooling MLP over each block's transfer
    edges, ``[fine row | coarse row]``, the fine rows from the gathered fine
    state, the coarse rows the block's own after the processor's
    ``filters[0]`` (as ``models/msgnn.py::apply_msgnn``), then the segment
    mean onto the block's coarse rows."""
    def pool(reps, dist, lvl, x_fine, x_coarse):
        plan = dist["pool"][lvl]
        whole = gather_all(x_fine, devices)
        out = []
        for p, pp in enumerate(reps):
            feats = x_coarse[p]
            if cfg.with_filter_matrix:
                feats = apply_linear(pp["gnn_processor"][lvl]["filters"][0], feats)
            out.append(_learned_pool_block(pp, cfg, whole[p], feats, plan["fine"][p],
                                           plan["dst_local"][p], plan["mask"][p]))
        return out

    return pool


def _adj_matvec_parts(x: list, plan: dict, devices) -> list:
    """``A_norm x`` on each block: the whole ``x`` gathered, each block's
    edges scaled and summed onto its rows (``convs._adj_matvec``)."""
    whole = gather_all(x, devices)
    return [segment_sum(gather(w, s) * c[:, None], d, b.shape[0])
            for w, s, d, c, b in zip(whole, plan["src"], plan["dst_local"], plan["coeff"], x)]


def _lins(params: list, k: int, x: list) -> list:
    return [apply_linear(pp["lins"][k], xp) for pp, xp in zip(params, x)]


def _add(a: list, b: list) -> list:
    return [u + v for u, v in zip(a, b)]


def _cheb_parts(params: list, cfg, x: list, plan: dict, devices) -> list:
    """``convs.apply_cheb`` on row blocks."""
    tx_prev = x
    out = _lins(params, 0, x)
    if cfg.K > 1:
        tx = [-a for a in _adj_matvec_parts(x, plan, devices)]
        out = _add(out, _lins(params, 1, tx))
        for k in range(2, cfg.K):
            tx_next = [-2.0 * a - t for a, t in zip(_adj_matvec_parts(tx, plan, devices),
                                                    tx_prev)]
            tx_prev, tx = tx, tx_next
            out = _add(out, _lins(params, k, tx))
    return [o + pp["bias"] for o, pp in zip(out, params)]


def _tag_parts(params: list, cfg, x: list, plan: dict, devices) -> list:
    """``convs.apply_tag`` on row blocks."""
    out = _lins(params, 0, x)
    h = x
    for k in range(1, cfg.K + 1):
        h = _adj_matvec_parts(h, plan, devices)
        out = _add(out, _lins(params, k, h))
    return [o + pp["bias"] for o, pp in zip(out, params)]


def _gat_parts(params: list, x: list, plan: dict, devices, negative_slope: float = 0.2
               ) -> list:
    """``convs.apply_gat`` on row blocks: the attention logits read the
    whole gathered state at both ends of each block edge (the one-device
    mat-vecs), the masked softmax and the message sum run over the block's
    edges; a row without a real in-edge takes the bias."""
    h = [apply_linear(pp["lin"], xp) for pp, xp in zip(params, x)]
    whole = gather_all(h, devices)
    out = []
    for pp, hw, hb, src, dst, dl, m in zip(params, whole, h, plan["src"], plan["dst"],
                                           plan["dst_local"], plan["mask"]):
        n = hb.shape[0]
        alpha = gather(hw @ pp["att_src"], src) + gather(hw @ pp["att_dst"], dst)
        alpha = F.leaky_relu(alpha, negative_slope=negative_slope)
        alpha = torch.where(m > 0, alpha, torch.full_like(alpha, torch.finfo(alpha.dtype).min))
        seg_max = segment_max_raw(alpha, dl, n)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
        ex = torch.exp(alpha - gather(seg_max, dl)) * m
        denom = segment_sum(ex[:, None], dl, n)[:, 0]
        w = ex / gather(denom, dl).clamp_min(1e-16)
        out.append(segment_sum(gather(hw, src) * w[:, None], dl, n) + pp["bias"])
    return out


def baseline_parts_forward(reps: list, cfg, devices, x_static: list, x_dynamic: list,
                           node_mask: list, plan: dict) -> list:
    """A baseline GNN (``models/gnn.py::apply_gnn`` with ``type_gnn`` GNN_L,
    GNN_A or GAT) on row blocks -> each part's ``[B_p, 2]`` predictions.
    The node encoder, the activation and the decoder are row-local."""
    x0, h = [], []
    for pp, a, b in zip(reps, x_static, x_dynamic):
        x, s, d = _split_x(cfg, a, b)
        x0.append(x)
        h.append(apply_mlp(pp["node_encoder"], torch.cat([s, d], -1),
                           activation=cfg.mlp_activation))
    for layer in range(cfg.n_gnn_layers):
        conv = [pp["gnn_processor"][layer] for pp in reps]
        if cfg.type_gnn == "GNN_L":
            h = _cheb_parts(conv, cfg, h, plan, devices)
        elif cfg.type_gnn == "GNN_A":
            h = _tag_parts(conv, cfg, h, plan, devices)
        else:
            h = _gat_parts(conv, h, plan, devices)
        if cfg.gnn_activation is not None:
            h = [apply_activation(cfg.gnn_activation, pp["gnn_act"], hp)
                 for pp, hp in zip(reps, h)]
    return _decode(reps, cfg, h, x0, node_mask)


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
        self._fwd = None              # the MSGNN's forward
        if type(cfg).__name__ == "MSGNNConfig":
            self.kind = "msgnn"
            self.plans = msgnn_row_plans(graph, self.devices, cfg.learned_pooling)
            self._fwd = make_dist_msgnn_forward(
                self.devices, cfg, _learned_pool(cfg, self.devices) if cfg.learned_pooling
                else None)
        elif cfg.type_gnn == "SWEGNN":
            self.kind = "swegnn"
            self.plans = gnn_row_plan(graph, self.devices)
        else:
            self.kind = "baseline"
            self.plans = baseline_row_plan(graph, self.devices)
        self.spec = graph.spec
        self.tables = [getattr(graph, k) for k in TOPOLOGY]

    def fits(self, graph: FloodGraph) -> bool:
        """Whether ``graph`` has the tables this model was placed for."""
        return graph.spec == self.spec and all(
            torch.equal(a, getattr(graph, k)) for a, k in zip(self.tables, TOPOLOGY))

    def encode_edges(self, params) -> list:
        """The encoded slot edge features of every part (with gradients, in a
        loss)."""
        if self.kind == "baseline":
            return None                # a baseline encodes no edge features
        reps = replicate(params, self.devices)
        if self.kind == "msgnn":
            return encode_dist_edges(reps, self.cfg, self.plans)
        return [_encode_ea(reps, self.cfg, self.plans["groups"][0]["ea"])]

    def __call__(self, params, graph: FloodGraph, encoded=None) -> torch.Tensor:
        home = graph.x_static.device
        spec, devices = self.spec, self.devices
        if self.kind == "msgnn":
            def per_scale(x):
                return [_blocks(x[spec.node_slice(i)], devices) for i in range(spec.num_scales)]

            outs = self._fwd(params, {**self.plans, "x_static": per_scale(graph.x_static),
                                      "x_dynamic": per_scale(graph.x_dynamic),
                                      "node_mask": per_scale(graph.node_mask)}, encoded)
            blocks = [o for scale in outs for o in scale]
        elif self.kind == "baseline":
            blocks = baseline_parts_forward(replicate(params, devices), self.cfg, devices,
                                            _blocks(graph.x_static, devices),
                                            _blocks(graph.x_dynamic, devices),
                                            _blocks(graph.node_mask, devices), self.plans)
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
