"""Ring-halo graph parallelism for the SWEGNN layer and the MSGNN (port of
mswe_gnn_tpu/parallel/dist_swegnn.py).

Every scale's nodes are split into P contiguous blocks, part p of every
scale on ``devices[p]``; each part owns the ELL slot rows of its block
(dst-owned edges), so aggregation is local. Before a hop each part ships
its boundary rows to its ring neighbours and reads its sources from the
buffer ``[block | halo from p-1 | halo from p+1]``. A locality-preserving
node order (``reorder_graph_for_ring``'s BFS, or the native BFS
partitioner ``native.bfs_partition``) keeps every remote source on a
ring-adjacent part; a plan returns None where it does not.

The JAX package runs the parts as one ``shard_map`` over a mesh axis and
exchanges rows with ``ppermute``. The port drives the parts from one
process over a list of devices (``sharding.make_mesh``): the exchange
gathers the rows each part ships and moves them with ``Tensor.to`` to the
neighbour's device, and autograd carries the gradient back the other way,
the transpose JAX gives ``ppermute``. The parameters are copied to each
part's device inside the forward, so their gradients sum on the device the
caller holds them on, JAX's psum of a replicated parameter's cotangents.
A list that repeats one device (eight parts on one card, or on the CPU)
makes every copy a no-op; the math is the same.

Each part's hop runs the port's ELL hop (``ops/hop.py::hop``, the CUDA
kernel for CUDA tensors) with the block as ``dst_state``, the buffer as
``src_state`` and the plan's buffer-relative slot table, in place of the
JAX package's per-slot ``jnp.take`` loop. The out-slot tables that the hop's
backward kernel reads are built once, when a plan is placed on its devices.
Each part follows the single-device layer (``models/swegnn.py``) operation
for operation, its bf16 policy included.

The host-side plan builders are numpy and give the JAX package's arrays bit
for bit.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch import tree_to
from mswe_gnn_tpu_torch.graph import FloodGraph, build_edge_slot_table
from mswe_gnn_tpu_torch.models import base as base_model
from mswe_gnn_tpu_torch.models.activations import apply_activation
from mswe_gnn_tpu_torch.models.mlp import apply_linear, apply_mlp
from mswe_gnn_tpu_torch.models.swegnn import (SWEGNNConfig, _compute_dtype,
                                              _first_layer_projections, _flux_tail)
from mswe_gnn_tpu_torch.ops.hop import hop, out_slot_table


# ---------------------------------------------------------------- host-side plans

def build_dist_slot_plan(src_slots: np.ndarray, slot_mask: np.ndarray,
                         num_nodes: int, n_parts: int,
                         num_src_nodes: Optional[int] = None,
                         pack_halo_slots: bool = False) -> Optional[dict]:
    """Ring-halo plan of a node-partitioned ELL slot table (JAX
    dist_swegnn.py:42-143, the same arrays).

    ``src_slots [N, D]`` holds each destination row's source node ids;
    masked slots are ignored. Rows are owned in contiguous blocks of
    ``num_nodes / n_parts`` (sources in blocks of ``num_src_nodes /
    n_parts``). Returns None when a real source is owned by a part that is
    not ring-adjacent.

    -> ``src_tab [P, B, D]`` buffer-relative sources (own rows at [0, B),
    halo from p-1 at [B, B+H), from p+1 at [B+H, B+2H)), ``slot_mask [P, B,
    D]``, ``send_next`` / ``send_prev [P, H]`` (the local rows each part
    ships to p+1 / p-1; padding ships row 0, which no slot reads), ``halo``
    H, ``block`` (source block), ``dst_block``, ``n_parts``. With
    ``pack_halo_slots`` each row's halo slots move to the tail (stable), and
    the plan adds ``perm [P, B, D]`` (apply it to per-slot side tables) and
    ``n_interior``: slots below it read local rows only.
    """
    if num_nodes % n_parts:
        raise ValueError("pad the node count to a multiple of n_parts")
    num_src_nodes = num_nodes if num_src_nodes is None else num_src_nodes
    if num_src_nodes % n_parts:
        raise ValueError("pad the source node count to a multiple of n_parts")
    dst_block = num_nodes // n_parts
    block = num_src_nodes // n_parts
    src = np.asarray(src_slots)
    msk = np.asarray(slot_mask) > 0
    owner_dst = np.arange(num_nodes) // dst_block
    d_max = src.shape[1]

    # ring assumption: every real remote source is owned by p-1 or p+1
    for p in range(n_parts):
        mine = owner_dst == p
        owners = src[mine][msk[mine]] // block
        if not np.all((owners == p) | (owners == (p - 1) % n_parts)
                      | (owners == (p + 1) % n_parts)):
            return None
    reads = [np.unique(src[owner_dst == q][msk[owner_dst == q]]) for q in range(n_parts)]
    send_next, send_prev = [], []
    for p in range(n_parts):
        nxt_reads, prv_reads = reads[(p + 1) % n_parts], reads[(p - 1) % n_parts]
        send_next.append(nxt_reads[nxt_reads // block == p] - p * block)
        send_prev.append(prv_reads[prv_reads // block == p] - p * block)
    h = max([len(a) for a in send_next + send_prev] + [1])

    def pad(lists):
        tab = np.zeros((n_parts, h), np.int32)
        for p, a in enumerate(lists):
            tab[p, :len(a)] = a
        return tab

    # remap slot sources into each part's [local | from_prev | from_next] buffer
    src_tab = np.zeros((n_parts, dst_block, d_max), np.int32)
    out_mask = np.zeros((n_parts, dst_block, d_max), np.float32)
    for p in range(n_parts):
        nxt, prv = (p + 1) % n_parts, (p - 1) % n_parts
        lut = np.full(num_src_nodes, -1, np.int64)
        # in this order: with two parts, p-1 and p+1 are one part, and its
        # send_prev position wins, as in the JAX package's dict
        lut[prv * block + send_next[prv]] = block + np.arange(len(send_next[prv]))
        lut[nxt * block + send_prev[nxt]] = block + h + np.arange(len(send_prev[nxt]))
        s = src[p * dst_block:(p + 1) * dst_block].astype(np.int64)
        m = msk[p * dst_block:(p + 1) * dst_block]
        safe = np.clip(s, 0, num_src_nodes - 1)
        tab = np.where(safe // block == p, safe - p * block, lut[safe])
        src_tab[p] = np.where(m, tab, 0)
        out_mask[p] = m
    plan = {"src_tab": src_tab, "slot_mask": out_mask,
            "send_next": pad(send_next), "send_prev": pad(send_prev),
            "halo": h, "block": block, "dst_block": dst_block, "n_parts": n_parts}
    if pack_halo_slots:
        is_halo = (src_tab >= block) & (out_mask > 0)
        perm = np.argsort(is_halo, axis=-1, kind="stable")     # [P, B, D]
        plan["src_tab"] = np.take_along_axis(src_tab, perm, axis=-1)
        plan["slot_mask"] = np.take_along_axis(out_mask, perm, axis=-1)
        halo_per_slot = np.take_along_axis(is_halo, perm, axis=-1).any(axis=(0, 1))
        plan["perm"] = perm
        plan["n_interior"] = (int(np.argmax(halo_per_slot)) if halo_per_slot.any()
                              else d_max)
    return plan


def build_wide_halo_plan(src_slots: np.ndarray, slot_mask: np.ndarray,
                         num_nodes: int, n_parts: int, width: int,
                         ea_slots_global: Optional[np.ndarray] = None) -> Optional[dict]:
    """Width-``W`` ring-halo plan: one boundary exchange per ``W`` hops (JAX
    dist_swegnn.py:146-301, the same arrays). Each part receives the W-hop
    closure of its boundary (rings 1..W) once a window and updates the halo
    rows of rings 1..W-1 itself between exchanges.

    -> ``src_tab`` / ``slot_mask [P, B, D]``; ``send_next`` / ``send_prev
    [P, H]`` ring-major, H the sum of the rings' padded counts; ``ring_ptr``
    (prefix lengths of the ring segments, ``(0, h1, h1+h2, ...)``);
    ``ext_tab`` / ``ext_mask [P, 2H, D]``, the slot sources of the halo rows
    (previous side, then next side; real for rings 1..W-1 only); ``ext_ea
    [P, 2H, D, Fe]`` their raw edge features when ``ea_slots_global [N, D,
    Fe]`` is given; ``halo``, ``block``, ``width``, ``n_parts``. Returns None
    when a closure row is not owned by a ring-adjacent part.
    """
    if num_nodes % n_parts or width < 1:
        raise ValueError(f"{num_nodes} nodes, {n_parts} parts, width {width}")
    B = num_nodes // n_parts
    src = np.asarray(src_slots)
    msk = np.asarray(slot_mask) > 0
    d_max = src.shape[1]

    def sources_of(rows):
        if len(rows) == 0:
            return np.zeros(0, np.int64)
        r = np.asarray(rows)
        return np.unique(src[r][msk[r]])

    # rings[p][r] = sorted global ids at hop distance r+1 from p's block
    rings = []
    for p in range(n_parts):
        known = np.zeros(num_nodes, bool)
        known[p * B:(p + 1) * B] = True
        frontier = np.arange(p * B, (p + 1) * B)
        prings = []
        for _ in range(width):
            s = sources_of(frontier)
            s = s[~known[s]]
            owners = s // B
            if not np.all((owners == (p - 1) % n_parts) | (owners == (p + 1) % n_parts)):
                return None          # the closure escapes the ring neighbourhood
            prings.append(s)
            known[s] = True
            frontier = s
        rings.append(prings)

    # per-ring padded counts, uniform over parts and sides
    h_r = []
    for r in range(width):
        m = 1 if r == 0 else 0
        for p in range(n_parts):
            prv, nxt = (p - 1) % n_parts, (p + 1) % n_parts
            own = rings[p][r] // B
            m = max(m, int((own == prv).sum()), int((own == nxt).sum()))
        h_r.append(m)
    ring_ptr = tuple(np.cumsum([0] + h_r).tolist())
    H = ring_ptr[-1]

    halo_prev = np.zeros((n_parts, H), np.int64)   # global ids (0 = padding)
    halo_next = np.zeros((n_parts, H), np.int64)
    halo_prev_real = np.zeros((n_parts, H), bool)
    halo_next_real = np.zeros((n_parts, H), bool)
    pos = np.full((n_parts, num_nodes), -1, np.int64)   # global id -> buffer position
    for p in range(n_parts):
        prv, nxt = (p - 1) % n_parts, (p + 1) % n_parts
        for r in range(width):
            own = rings[p][r] // B
            for side, q, arr, real in ((0, prv, halo_prev, halo_prev_real),
                                       (1, nxt, halo_next, halo_next_real)):
                rows = rings[p][r][own == q]
                o = ring_ptr[r]
                arr[p, o:o + len(rows)] = rows
                real[p, o:o + len(rows)] = True
                pos[p, rows] = (B + H if side else B) + o + np.arange(len(rows))

    # what p ships = its neighbour's halo rows that p owns
    send_next = np.zeros((n_parts, H), np.int32)
    send_prev = np.zeros((n_parts, H), np.int32)
    for p in range(n_parts):
        nxt, prv = (p + 1) % n_parts, (p - 1) % n_parts
        send_next[p] = np.where(halo_prev_real[nxt], halo_prev[nxt] - p * B, 0)
        send_prev[p] = np.where(halo_next_real[prv], halo_next[prv] - p * B, 0)
        if not (np.all((send_next[p] >= 0) & (send_next[p] < B))
                and np.all((send_prev[p] >= 0) & (send_prev[p] < B))):
            raise AssertionError("a shipped row lies outside its block")

    src_tab = np.zeros((n_parts, B, d_max), np.int32)
    out_mask = np.zeros((n_parts, B, d_max), np.float32)
    ext_tab = np.zeros((n_parts, 2 * H, d_max), np.int32)
    ext_mask = np.zeros((n_parts, 2 * H, d_max), np.float32)
    fe = 0 if ea_slots_global is None else ea_slots_global.shape[-1]
    ext_ea = np.zeros((n_parts, 2 * H, d_max, fe), np.float32)
    for p in range(n_parts):
        def remap(g):
            g = np.asarray(g, np.int64)
            return np.where(g // B == p, g - p * B, pos[p, g])

        m = msk[p * B:(p + 1) * B]
        src_tab[p] = np.where(m, remap(src[p * B:(p + 1) * B]), 0)
        out_mask[p] = m
        if width == 1:
            continue
        # the halo rows of rings 1..width-1, the ones updated locally
        n_upd = ring_ptr[width - 1]
        for base, arr, real in ((0, halo_prev, halo_prev_real), (H, halo_next, halo_next_real)):
            rows = np.where(real[p, :n_upd])[0]
            gq = arr[p, rows]
            mq = msk[gq]
            ext_tab[p, base + rows] = np.where(mq, remap(src[gq]), 0)
            ext_mask[p, base + rows] = mq
            if fe:
                ext_ea[p, base + rows] = ea_slots_global[gq] * mq[..., None]
    return {"src_tab": src_tab, "slot_mask": out_mask,
            "send_next": send_next, "send_prev": send_prev,
            "ring_ptr": ring_ptr, "ext_tab": ext_tab, "ext_mask": ext_mask,
            "ext_ea": ext_ea, "halo": H, "block": B, "width": width,
            "n_parts": n_parts}


def slot_ea_per_part(edge_attr: np.ndarray, in_edge_table: np.ndarray,
                     in_edge_mask: np.ndarray, n_parts: int) -> np.ndarray:
    """Per-edge features gathered into the dst-owned per-part slot layout
    ``[P, B, D, Fe]`` (JAX dist_swegnn.py:1148-1160)."""
    n, d_max = np.asarray(in_edge_table).shape
    block = n // n_parts
    ea = np.asarray(edge_attr)
    tab = np.asarray(in_edge_table)
    mask = np.asarray(in_edge_mask)
    out = np.zeros((n_parts, block, d_max, ea.shape[1]), np.float32)
    for p in range(n_parts):
        rows = slice(p * block, (p + 1) * block)
        out[p] = ea[tab[rows]] * mask[rows][..., None]
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ring_order(graph: FloodGraph) -> np.ndarray:
    """``perm[new_global_id] = old_global_id`` of ``reorder_graph_for_ring``:
    scale 0's real nodes in BFS order over the symmetric adjacency (padding
    rows stay in place), each coarser scale's real nodes sorted by the mean
    new position of their fine children (the barycentric order), so that the
    cross-scale plans stay ring-adjacent. Depends on the edges, the node
    mask and the transfer edges only."""
    spec = graph.spec
    node_ptr = np.asarray(spec.node_ptr)
    edge_ptr = np.asarray(spec.edge_ptr)
    intra_ptr = np.asarray(spec.intra_edge_ptr)
    ei = _host(graph.edge_index)
    nmask = _host(graph.node_mask)
    perm = np.arange(spec.num_nodes, dtype=np.int64)
    scale_pos = {}                               # scale -> old local -> new local
    for i in range(spec.num_scales):
        lo, hi = node_ptr[i], node_ptr[i + 1]
        real = np.where(nmask[lo:hi] > 0)[0]
        n_real = len(real)
        if n_real == 0:
            scale_pos[i] = np.arange(hi - lo)
            continue
        if i == 0:
            esl = slice(edge_ptr[i], edge_ptr[i + 1])
            emask = _host(graph.edge_mask)[esl] > 0
            s = ei[0, esl][emask] - lo
            d = ei[1, esl][emask] - lo
            order = []
            seen = np.zeros(hi - lo, bool)
            seen[~np.isin(np.arange(hi - lo), real)] = True  # skip padding
            nbr: Dict[int, List[int]] = {}
            for a, b in zip(s.tolist(), d.tolist()):
                # symmetric: a ghost's edge to the interior is directed, but
                # the ghost must sit next to its boundary face
                nbr.setdefault(a, []).append(b)
                nbr.setdefault(b, []).append(a)
            for start in real.tolist():
                if seen[start]:
                    continue
                q = deque([start])
                seen[start] = True
                while q:
                    u = q.popleft()
                    order.append(u)
                    for v in sorted(nbr.get(u, [])):
                        if not seen[v]:
                            seen[v] = True
                            q.append(v)
            order = np.asarray(order, np.int64)
        else:
            isl = slice(intra_ptr[i - 1], intra_ptr[i])
            iei = _host(graph.intra_edge_index)
            im = _host(graph.intra_edge_mask)[isl] > 0
            coarse_l = iei[0, isl][im] - node_ptr[i]
            fine_l = iei[1, isl][im] - node_ptr[i - 1]
            fine_new = scale_pos[i - 1][fine_l].astype(np.float64)
            key = np.full(hi - lo, np.inf)
            cnt = np.bincount(coarse_l, minlength=hi - lo).astype(np.float64)
            sums = np.bincount(coarse_l, weights=fine_new, minlength=hi - lo)
            has = cnt > 0
            key[has] = sums[has] / cnt[has]
            order = real[np.argsort(key[real], kind="stable")]
        perm[lo: lo + n_real] = lo + order
        pos_local = np.arange(hi - lo)
        pos_local[order] = np.arange(n_real)
        scale_pos[i] = pos_local
    return perm


def apply_ring_order(graph: FloodGraph, perm: np.ndarray) -> FloodGraph:
    """The graph with its nodes in the order ``perm`` (``ring_order``): node
    arrays permuted (the forcing series too), edge endpoints remapped and
    each scale's edges re-sorted by destination, the ELL tables rebuilt at
    the spec's widths. The graph comes back on its own device, without an
    ``ell_cache`` or a band plan (both refer to the old order)."""
    spec = graph.spec
    L = spec.num_scales
    edge_ptr = np.asarray(spec.edge_ptr)
    intra_ptr = np.asarray(spec.intra_edge_ptr)
    N = spec.num_nodes
    pos = np.empty(N, np.int64)                  # old global id -> new
    pos[perm] = np.arange(N)

    ei_new = pos[_host(graph.edge_index).astype(np.int64)].astype(np.int32)
    ea_new = _host(graph.edge_attr).copy()
    em_new = _host(graph.edge_mask).copy()
    for i in range(L):
        esl = slice(edge_ptr[i], edge_ptr[i + 1])
        o = np.argsort(ei_new[1, esl], kind="stable")
        ei_new[:, esl] = ei_new[:, esl][:, o]
        ea_new[esl] = ea_new[esl][o]
        em_new[esl] = em_new[esl][o]
    iei = _host(graph.intra_edge_index)
    im_new = _host(graph.intra_edge_mask).copy()
    if spec.num_intra_edges > 0:
        iei_new = pos[iei.astype(np.int64)].astype(np.int32)
        for lvl in range(L - 1):
            isl = slice(intra_ptr[lvl], intra_ptr[lvl + 1])
            o = np.argsort(iei_new[0, isl], kind="stable")
            iei_new[:, isl] = iei_new[:, isl][:, o]
            im_new[isl] = im_new[isl][o]
    else:
        iei_new = iei
    in_tab, in_msk = build_edge_slot_table(ei_new, em_new, N, d_fixed=spec.in_degree)
    pool_tab, pool_msk = build_edge_slot_table(np.stack([iei_new[1], iei_new[0]]), im_new, N,
                                               d_fixed=spec.pool_degree)
    unpool_tab, unpool_msk = build_edge_slot_table(iei_new, im_new, N,
                                                   d_fixed=spec.unpool_degree)
    device = graph.x_static.device

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def nodes(x):
        return None if x is None else t(_host(x)[perm])

    return graph.replace(
        x_static=nodes(graph.x_static), x_dynamic=nodes(graph.x_dynamic),
        node_mask=nodes(graph.node_mask), area=nodes(graph.area), dem=nodes(graph.dem),
        y=nodes(graph.y), forcing=nodes(graph.forcing),
        edge_index=t(ei_new), edge_attr=t(ea_new), edge_mask=t(em_new),
        intra_edge_index=t(iei_new), intra_edge_mask=t(im_new),
        bc_nodes=t(pos[_host(graph.bc_nodes).astype(np.int64)].astype(np.int32)),
        in_edge_table=t(in_tab), in_edge_mask=t(in_msk),
        pool_table=t(pool_tab), pool_mask=t(pool_msk),
        unpool_table=t(unpool_tab), unpool_mask=t(unpool_msk),
        ell_cache=None, band_plan=None, band_meta=None)


def reorder_graph_for_ring(graph: FloodGraph, n_parts: int = 0
                           ) -> Tuple[FloodGraph, np.ndarray]:
    """Each scale's real nodes in BFS / barycentric order, so that contiguous
    partitions are ring-local (JAX dist_swegnn.py:711-853) -> ``(new graph,
    perm)``, ``perm[new_global_id] = old_global_id`` (identity on padding
    rows). The spec is unchanged. Unlike the JAX package, the forcing series
    is permuted with the other node arrays, and a cache or band plan of the
    old order is dropped (``apply_ring_order``)."""
    perm = ring_order(graph)
    return apply_ring_order(graph, perm), perm


def _msgnn_plans(graph: FloodGraph, n_parts: int, overlap: bool,
                 halo_width: int) -> Tuple[Optional[dict], Optional[str]]:
    """``build_dist_msgnn_inputs`` -> (inputs or None, why None)."""
    if overlap and halo_width > 1:
        raise ValueError("overlap packing and wide halos are mutually exclusive")
    spec = graph.spec
    L = spec.num_scales
    node_ptr = np.asarray(spec.node_ptr)
    edge_ptr = np.asarray(spec.edge_ptr)
    intra_ptr = np.asarray(spec.intra_edge_ptr)
    counts = spec.node_counts
    bad = [c for c in counts if c % n_parts]
    if bad:
        return None, f"padded node counts {list(counts)} do not divide by {n_parts}"

    def part(arr, i):
        a = _host(arr)[node_ptr[i]: node_ptr[i + 1]]
        return a.reshape((n_parts, counts[i] // n_parts) + a.shape[1:])

    ei = _host(graph.edge_index)
    iei = _host(graph.intra_edge_index)
    in_table, in_mask = _host(graph.in_edge_table), _host(graph.in_edge_mask)
    edge_attr = _host(graph.edge_attr)
    out = {"x_static": [], "x_dynamic": [], "node_mask": [],
           "proc": [], "pool": [], "unpool": []}
    n_interior, wide_meta = [], []
    for i in range(L):
        tab = np.maximum(in_table[node_ptr[i]: node_ptr[i + 1]] - edge_ptr[i], 0)
        tmask = in_mask[node_ptr[i]: node_ptr[i + 1]]
        src_local = ei[0, edge_ptr[i]: edge_ptr[i + 1]] - node_ptr[i]
        ea = edge_attr[edge_ptr[i]: edge_ptr[i + 1]]
        ea_slots_flat = (ea[tab] * tmask[..., None]).astype(np.float32)
        wide = None
        if halo_width > 1:
            wide = build_wide_halo_plan(src_local[tab], tmask, counts[i], n_parts,
                                        halo_width, ea_slots_global=ea_slots_flat)
        plan = (build_dist_slot_plan(src_local[tab], tmask, counts[i], n_parts,
                                     pack_halo_slots=overlap)
                if wide is None else wide)
        if plan is None:
            return None, f"scale {i}'s processor plan is not ring-adjacent at {n_parts} parts"
        ea_slots = ea_slots_flat.reshape((n_parts, counts[i] // n_parts)
                                         + (tab.shape[1], ea.shape[1]))
        if overlap:
            ea_slots = np.take_along_axis(ea_slots, plan.pop("perm")[..., None], axis=2)
            n_interior.append(plan.pop("n_interior"))
        proc = {"src_tab": plan["src_tab"], "smask": plan["slot_mask"], "ea": ea_slots,
                "send_next": plan["send_next"], "send_prev": plan["send_prev"]}
        if wide is not None:
            proc.update(ext_tab=plan["ext_tab"], ext_mask=plan["ext_mask"],
                        ext_ea=plan["ext_ea"])
            wide_meta.append((halo_width, plan["ring_ptr"], int(plan["halo"])))
        elif halo_width > 1:
            # this scale's W-hop closure escaped ring adjacency: per-hop plan
            wide_meta.append((1, None, None))
        out["proc"].append(proc)
        out["x_static"].append(part(graph.x_static, i))
        out["x_dynamic"].append(part(graph.x_dynamic, i))
        out["node_mask"].append(part(graph.node_mask, i))

    overlap_pool, overlap_unpool = [], []
    for lvl in range(L - 1):
        isl = slice(intra_ptr[lvl], intra_ptr[lvl + 1])
        fine_local = iei[1, isl] - node_ptr[lvl]
        coarse_local = iei[0, isl] - node_ptr[lvl + 1]
        for kind, tab_t, mask_t, rows, srcs, n_dst, n_src, packed in (
                ("pool", graph.pool_table, graph.pool_mask, lvl + 1, fine_local,
                 counts[lvl + 1], counts[lvl], overlap_pool),
                ("unpool", graph.unpool_table, graph.unpool_mask, lvl, coarse_local,
                 counts[lvl], counts[lvl + 1], overlap_unpool)):
            tab = np.maximum(_host(tab_t)[node_ptr[rows]: node_ptr[rows + 1]]
                             - intra_ptr[lvl], 0)
            mask = _host(mask_t)[node_ptr[rows]: node_ptr[rows + 1]]
            plan = build_dist_slot_plan(srcs[tab], mask, n_dst, n_parts,
                                        num_src_nodes=n_src, pack_halo_slots=overlap)
            if plan is None:
                return None, (f"level {lvl}'s {kind} plan (scale {lvl} <-> {lvl + 1}) is not "
                              f"ring-adjacent at {n_parts} parts")
            if overlap:
                plan.pop("perm")
                packed.append(plan.pop("n_interior"))
            out[kind].append({"src_tab": plan["src_tab"], "smask": plan["slot_mask"],
                              "send_next": plan["send_next"],
                              "send_prev": plan["send_prev"]})
    if overlap:
        out["overlap"] = tuple(n_interior)
        out["overlap_pool"] = tuple(overlap_pool)
        out["overlap_unpool"] = tuple(overlap_unpool)
    if halo_width > 1:
        out["wide_meta"] = tuple(wide_meta)
    return out, None


def build_dist_msgnn_inputs(graph: FloodGraph, n_parts: int, overlap: bool = False,
                            halo_width: int = 1) -> Optional[dict]:
    """Host-side ring partition of a multiscale graph for the distributed
    MSGNN (JAX dist_swegnn.py:856-987, the same arrays, numpy): one ring
    plan per scale (``proc``: ``src_tab``, ``smask``, ``ea`` raw slot edge
    features, ``send_next``, ``send_prev``) and per transfer level (``pool``
    fine -> coarse, ``unpool`` coarse -> fine), and the node features split
    per scale (``x_static``, ``x_dynamic``, ``node_mask``); every leaf
    part-major ``[P, ...]``. Returns None when a plan is not ring-adjacent
    or a scale's padded count does not divide by ``n_parts``
    (``ring_plan_failure`` says which).

    ``overlap`` packs every plan's halo slots to the tail and adds the
    per-scale and per-level interior slot counts (``overlap``,
    ``overlap_pool``, ``overlap_unpool``). ``halo_width`` > 1 builds
    width-W processor plans (``build_wide_halo_plan``) and adds
    ``wide_meta``, per scale ``(width, ring_ptr, halo)``, width 1 where a
    scale's closure escaped ring adjacency and it kept the per-hop plan.
    The two are mutually exclusive."""
    return _msgnn_plans(graph, n_parts, overlap, halo_width)[0]


def ring_plan_failure(graph: FloodGraph, n_parts: int, overlap: bool = False,
                      halo_width: int = 1) -> Optional[str]:
    """Why ``build_dist_msgnn_inputs`` returns None for these arguments (the
    first plan that fails), or None when it gives a plan."""
    return _msgnn_plans(graph, n_parts, overlap, halo_width)[1]


# ---------------------------------------------------------------- placement

def _as_tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _parts(arr, devices, dtype=None) -> List[torch.Tensor]:
    """``arr [P, ...]`` -> P contiguous tensors, part p on ``devices[p]``."""
    t = _as_tensor(arr, dtype)
    return [t[p].contiguous().to(devices[p]) for p in range(len(devices))]


def _slot_groups(d_max: int, n_interior: Optional[int]) -> List[Tuple[int, int, bool]]:
    """The slot ranges ``(lo, hi, buffered)`` one aggregation runs: all slots
    from the exchanged buffer, or for a packed plan (``n_interior``) the
    interior slots from the local block and the halo slots from the buffer
    (an empty range is left out)."""
    if n_interior is None:
        return [(0, d_max, True)]
    return [g for g in ((0, n_interior, False), (n_interior, d_max, True)) if g[1] > g[0]]


def place_slot_plan(plan: dict, devices: Sequence[torch.device], n_src_block: int,
                    n_interior: Optional[int] = None, ea=None) -> dict:
    """A slot plan (``src_tab``, ``smask``, ``send_next``, ``send_prev``, all
    ``[P, ...]``) on its parts' devices, cut into the slot groups one
    aggregation runs (``_slot_groups``). Each group holds, per part, its
    int32 slot table, its slot mask and the out-slot table of the hop
    backward over the rows it reads (``n_src_block``, or the buffer of
    ``n_src_block + 2H`` rows), and the group's raw slot edge features when
    ``ea [P, B, D, Fe]`` is given."""
    src_tab = _as_tensor(plan["src_tab"], torch.int32)
    smask = _as_tensor(plan["smask"], torch.float32)
    halo = _as_tensor(plan["send_next"]).shape[-1]
    groups = []
    for lo, hi, buffered in _slot_groups(src_tab.shape[-1], n_interior):
        tab = src_tab[:, :, lo:hi].contiguous()
        mask = smask[:, :, lo:hi].contiguous()
        n_src = n_src_block + 2 * halo if buffered else n_src_block
        group = {"lo": lo, "hi": hi, "buffered": buffered,
                 "tab": _parts(tab, devices), "mask": _parts(mask, devices),
                 "out_table": [tuple(t.to(d) for t in out_slot_table(tab[p], n_src, mask[p]))
                               for p, d in enumerate(devices)]}
        if ea is not None:
            group["ea"] = _parts(_as_tensor(ea, torch.float32)[:, :, lo:hi], devices)
        groups.append(group)
    return {"groups": groups, "halo": halo,
            "send_next": _parts(plan["send_next"], devices, torch.int64),
            "send_prev": _parts(plan["send_prev"], devices, torch.int64)}


def place_wide_plan(plan: dict, devices: Sequence[torch.device], width: int, ring_ptr,
                    halo: int, ea=None, ext_ea=None) -> dict:
    """A width-W processor plan on its parts' devices: the slot tables, the
    halo rows' tables, the send tables and the out-slot tables of every hop
    the layer runs (the block's, and each side's ``ring_ptr`` prefix of halo
    rows that a window updates)."""
    block = _as_tensor(plan["src_tab"]).shape[1]
    n_buf = block + 2 * halo
    src_tab = _as_tensor(plan["src_tab"], torch.int32)
    smask = _as_tensor(plan["smask"], torch.float32)
    ext_tab = _as_tensor(plan["ext_tab"], torch.int32)
    ext_mask = _as_tensor(plan["ext_mask"], torch.float32)
    ring_ptr = tuple(int(x) for x in ring_ptr)
    prefixes = sorted({ring_ptr[r] for r in range(1, width) if ring_ptr[r] > 0})
    placed = {"width": width, "ring_ptr": ring_ptr, "halo": halo,
              "src_tab": _parts(src_tab, devices), "smask": _parts(smask, devices),
              "ext_tab": _parts(ext_tab, devices), "ext_mask": _parts(ext_mask, devices),
              "send_next": _parts(plan["send_next"], devices, torch.int64),
              "send_prev": _parts(plan["send_prev"], devices, torch.int64),
              "out_table": [], "ext_out_table": []}
    for p, d in enumerate(devices):
        placed["out_table"].append(tuple(
            t.to(d) for t in out_slot_table(src_tab[p], n_buf, smask[p])))
        placed["ext_out_table"].append({
            (base, pfx): tuple(t.to(d) for t in out_slot_table(
                ext_tab[p, base:base + pfx], n_buf, ext_mask[p, base:base + pfx]))
            for base in (0, halo) for pfx in prefixes})
    if ea is not None:
        placed["ea"] = _parts(_as_tensor(ea, torch.float32), devices)
    if ext_ea is not None:
        placed["ext_ea"] = _parts(_as_tensor(ext_ea, torch.float32), devices)
    return placed


def place_dist_inputs(dist: dict, devices: Sequence) -> dict:
    """``build_dist_msgnn_inputs``'s plans (its metadata keys included) on
    the parts' devices, once per graph topology: per scale the processor
    plan (``place_slot_plan``, or ``place_wide_plan`` where ``wide_meta``
    gives the scale a width > 1), per level the pool and un-pool plans. The
    node features are not placed: ``make_dist_msgnn_forward`` takes them per
    call."""
    devices = [torch.device(d) for d in devices]
    overlap = dist.get("overlap")
    overlap_pool = dist.get("overlap_pool")
    overlap_unpool = dist.get("overlap_unpool")
    wide_meta = dist.get("wide_meta")
    proc = []
    for i, pl in enumerate(dist["proc"]):
        block = _as_tensor(pl["src_tab"]).shape[1]
        wm = None if wide_meta is None else wide_meta[i]
        if wm is not None and wm[0] > 1:
            proc.append(place_wide_plan(pl, devices, wm[0], wm[1], wm[2], ea=pl["ea"],
                                        ext_ea=pl["ext_ea"]))
        else:
            proc.append(place_slot_plan(pl, devices, block,
                                        None if overlap is None else overlap[i], ea=pl["ea"]))
    pool, unpool = [], []
    for lvl, (pp, up) in enumerate(zip(dist["pool"], dist["unpool"])):
        fine_block = _as_tensor(up["src_tab"]).shape[1]
        coarse_block = _as_tensor(pp["src_tab"]).shape[1]
        pool.append(place_slot_plan(pp, devices, fine_block,
                                    None if overlap_pool is None else overlap_pool[lvl]))
        unpool.append(place_slot_plan(up, devices, coarse_block,
                                      None if overlap_unpool is None
                                      else overlap_unpool[lvl]))
    return {"devices": devices, "proc": proc, "pool": pool, "unpool": unpool}


# ---------------------------------------------------------------- the ring exchange

def replicate(tree, devices: Sequence[torch.device]) -> list:
    """``tree`` on each device of ``devices`` (the parameter copy of each
    part); parts on one device share one copy."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = tree_to(tree, d)
    return [copies[d] for d in devices]


def _halo_rows(blocks: Sequence[torch.Tensor], send_next, send_prev,
               devices: Sequence[torch.device]):
    """One bidirectional boundary exchange over the ring (JAX
    dist_swegnn.py:304-313) -> ``(from_prev, from_next)``: part p receives
    the rows p-1 ships forward (its ``send_next``) and the rows p+1 ships
    back (its ``send_prev``), moved to ``devices[p]``."""
    n = len(blocks)
    fwd = [b.index_select(0, s) for b, s in zip(blocks, send_next)]
    bwd = [b.index_select(0, s) for b, s in zip(blocks, send_prev)]
    return ([fwd[(p - 1) % n].to(devices[p]) for p in range(n)],
            [bwd[(p + 1) % n].to(devices[p]) for p in range(n)])


def _halo_concat(blocks, send_next, send_prev, devices) -> List[torch.Tensor]:
    """Each part's ``[B, F]`` block -> its ``[B + 2H, F]`` buffer
    ``[block | halo from p-1 | halo from p+1]`` (JAX dist_swegnn.py:475-484)."""
    from_prev, from_next = _halo_rows(blocks, send_next, send_prev, devices)
    return [torch.cat([b, a, c], dim=0) for b, a, c in zip(blocks, from_prev, from_next)]


def gather_all(blocks: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """Every part's block gathered whole on each part's device (the JAX
    package's all-gather): ``[sum B_p, F]`` in part order, one
    concatenation a distinct device, shared by the parts on it."""
    whole: Dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in whole:
            whole[d] = torch.cat([b.to(d) for b in blocks], dim=0)
    return [whole[d] for d in devices]


def _exchange(plan: dict, blocks, devices) -> List[torch.Tensor]:
    """The source buffer of each part: the whole gathered state for a plan
    that reads every row (``gather``, the row blocks of parallel/gspmd.py),
    else the ring buffer ``[block | halo from p-1 | halo from p+1]``."""
    if plan.get("gather"):
        return gather_all(blocks, devices)
    return _halo_concat(blocks, plan["send_next"], plan["send_prev"], devices)


# ---------------------------------------------------------------- layers

def _slot_flux(params: dict, cfg: SWEGNNConfig, rows: torch.Tensor, proj_dst: torch.Tensor,
               tab: torch.Tensor, mask: torch.Tensor, ea) -> torch.Tensor:
    """The flux of a slot table whose sources are ``rows`` of the source
    projection -> ``[B, D, F]`` with the slot mask folded in (the slot path
    of ``models/swegnn.py::_edge_flux_slots``)."""
    h = rows.index_select(0, tab.reshape(-1)).view(*tab.shape, -1) + proj_dst[:, None, :]
    return _flux_tail(params, cfg, h, ea) * mask[:, :, None]


def _filter0(params: list, cfg: SWEGNNConfig, x: list) -> list:
    cd = _compute_dtype(cfg)
    if not cfg.with_filter_matrix:
        return list(x)
    return [apply_linear(pp["filters"][0], xp, compute_dtype=cd) for pp, xp in zip(params, x)]


def _update(params: dict, cfg: SWEGNNConfig, k: int, state: torch.Tensor,
            agg: torch.Tensor) -> torch.Tensor:
    """``state + H_k agg``, as the single-device hop loop adds a hop."""
    cd = _compute_dtype(cfg)
    if cfg.with_filter_matrix:
        agg = apply_linear(params["filters"][k], agg, compute_dtype=cd)
    if cd is not None:
        agg = agg.to(state.dtype)
    return state + agg


def _dist_layer_local(params: list, cfg: SWEGNNConfig, devices, x_s: list, x_d: list,
                      plan: dict, ea: Optional[list] = None, x_s_src: Optional[list] = None,
                      x_d_src: Optional[list] = None) -> list:
    """One SWEGNN layer over the ring (JAX dist_swegnn.py:487-615): every
    argument a list over parts. ``params`` holds each part's copy of the
    layer's parameters, ``plan`` is ``place_slot_plan``'s (or a row plan of
    parallel/gspmd.py, whose buffer is the whole gathered state:
    ``_exchange``), ``ea`` each group's encoded slot edge features (a list
    over groups of lists over parts), None without edge features.

    The flux takes one exchange of the source projection. With ``x_s_src``
    / ``x_d_src`` the sources are another, disjoint block (the un-pooling
    layer): its state is constant over the hops and its buffer is exchanged
    once; otherwise every hop exchanges the evolving state. A packed plan's
    interior slots hop against the local block and its halo slots against
    the buffer, two hop calls summed; the sums then differ from an unpacked
    plan's in their order only."""
    cd = _compute_dtype(cfg)
    same_block = x_s_src is None
    if same_block:
        x_s_src, x_d_src = x_s, x_d
    out = _filter0(params, cfg, x_d)
    out_src = out if same_block else _filter0(params, cfg, x_d_src)
    proj = [_first_layer_projections(pp, cfg, xs_src, xd_src, xs, xd)
            for pp, xs_src, xd_src, xs, xd in zip(params, x_s_src, x_d_src, x_s, x_d)]
    proj_src = [a for a, _ in proj]
    groups = plan["groups"]
    buffered = any(g["buffered"] for g in groups)
    buf_ps = _exchange(plan, proj_src, devices) if buffered else None
    flux = []
    for gi, g in enumerate(groups):
        fl = []
        for p, pp in enumerate(params):
            rows = buf_ps[p] if g["buffered"] else proj_src[p]
            s = _slot_flux(pp, cfg, rows, proj[p][1], g["tab"][p], g["mask"][p],
                           None if ea is None else ea[gi][p])
            fl.append(s.to(getattr(torch, cd)) if cd is not None else s)
        flux.append(fl)
    if cd is not None:
        # the hop state and the flux table live in bf16, as in the
        # single-device layer
        out = [o.to(getattr(torch, cd)) for o in out]
        out_src = out if same_block else [o.to(getattr(torch, cd)) for o in out_src]
    buf = buf_const = (_exchange(plan, out_src, devices)
                       if buffered and not same_block else None)
    for k in range(cfg.K):
        if buffered:
            buf = _exchange(plan, out, devices) if same_block else buf_const
        local = out if same_block else out_src
        new = []
        for p, pp in enumerate(params):
            agg = None
            for g, fl in zip(groups, flux):
                term = hop(out[p], buf[p] if g["buffered"] else local[p], g["tab"][p], fl[p],
                           with_gradient=cfg.with_gradient, upwind=cfg.upwind_mode,
                           out_table=g["out_table"][p])
                agg = term if agg is None else agg + term
            new.append(_update(pp, cfg, k + 1, out[p], agg))
        out = new
    return [o.to(x.dtype) for o, x in zip(out, x_d)] if cd is not None else out


def _dist_layer_wide(params: list, cfg: SWEGNNConfig, devices, x_s: list, x_d: list,
                     plan: dict, ea_local: Optional[list], ea_ext: Optional[list]) -> list:
    """A same-block SWEGNN layer on a width-W plan (JAX
    dist_swegnn.py:316-446): ceil(K/W) boundary exchanges instead of K.
    Between exchanges each part updates the halo rows of rings 1..W-1 itself
    with the same per-row math, through the same hop: the rows are
    ``dst_state``, the buffer ``src_state``. ``plan`` is
    ``place_wide_plan``'s; ``ea_local`` / ``ea_ext`` the encoded slot edge
    features of the block's and of the halo rows' slots."""
    cd = _compute_dtype(cfg)
    width, ring_ptr, H = plan["width"], plan["ring_ptr"], plan["halo"]
    sn, sp = plan["send_next"], plan["send_prev"]
    out = _filter0(params, cfg, x_d)
    proj = [_first_layer_projections(pp, cfg, xs, xd, xs, xd)
            for pp, xs, xd in zip(params, x_s, x_d)]
    hf = proj[0][0].shape[1]
    # one widened projection exchange a layer: the halo rows' own
    # destination projections come along for their flux
    hp, hn = _halo_rows([torch.cat([a, b], dim=-1) for a, b in proj], sn, sp, devices)
    ps_buf = [torch.cat([a, f[:, :hf], g[:, :hf]], dim=0) for (a, _), f, g in zip(proj, hp, hn)]
    pd_ext = [torch.cat([f[:, hf:], g[:, hf:]], dim=0) for f, g in zip(hp, hn)]
    upd = width > 1 and ring_ptr[width - 1] > 0

    def cast(x):
        return x.to(getattr(torch, cd)) if cd is not None else x

    s_local = [cast(_slot_flux(pp, cfg, ps_buf[p], proj[p][1], plan["src_tab"][p],
                               plan["smask"][p], None if ea_local is None else ea_local[p]))
               for p, pp in enumerate(params)]
    s_ext = ([cast(_slot_flux(pp, cfg, ps_buf[p], pd_ext[p], plan["ext_tab"][p],
                              plan["ext_mask"][p], None if ea_ext is None else ea_ext[p]))
              for p, pp in enumerate(params)] if upd else None)
    out = [cast(o) for o in out]
    kw = dict(with_gradient=cfg.with_gradient, upwind=cfg.upwind_mode)
    k = 0
    while k < cfg.K:
        w = min(width, cfg.K - k)
        hp, hn = _halo_rows(out, sn, sp, devices)
        ext_out = [torch.cat([a, b], dim=0) for a, b in zip(hp, hn)]      # [2H, F]
        for j in range(w):
            new_out, new_ext = [], []
            for p, pp in enumerate(params):
                buf = torch.cat([out[p], ext_out[p]], dim=0)
                agg = hop(out[p], buf, plan["src_tab"][p], s_local[p],
                          out_table=plan["out_table"][p], **kw)
                new_out.append(_update(pp, cfg, k + j + 1, out[p], agg))
                if j < w - 1 and upd and ring_ptr[w - 1 - j] > 0:
                    pfx = ring_ptr[w - 1 - j]    # the rings the remaining hops read
                    pieces = []
                    for base in (0, H):          # previous side, next side
                        rows = ext_out[p][base: base + pfx]
                        agg_e = hop(rows, buf, plan["ext_tab"][p][base: base + pfx],
                                    s_ext[p][base: base + pfx],
                                    out_table=plan["ext_out_table"][p][base, pfx], **kw)
                        pieces += [_update(pp, cfg, k + j + 1, rows, agg_e),
                                   ext_out[p][base + pfx: base + H]]
                    new_ext.append(torch.cat(pieces, dim=0))
                else:
                    new_ext.append(ext_out[p])
            out, ext_out = new_out, new_ext
        k += w
    return [o.to(x.dtype) for o, x in zip(out, x_d)] if cd is not None else out


def _split_rows(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """``[N, ...]`` -> P row blocks, block p on ``devices[p]``."""
    return [b.to(d) for b, d in zip(x.chunk(len(devices), dim=0), devices)]


def _gather_rows(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([b.to(device) for b in blocks], dim=0)


def make_dist_swegnn(devices: Sequence, cfg: SWEGNNConfig):
    """The ring SWEGNN layer on whole arrays (JAX dist_swegnn.py:618-644):
    ``layer(params, x_s, x_d, src_tab, smask, ea_slots, send_next,
    send_prev) -> [N, F]`` on ``x_d``'s device, with ``x_s`` / ``x_d [N,
    F]`` and the plan's ``[P, ...]`` tables (``build_dist_slot_plan``;
    ``ea_slots [P, B, D, Fe]``, ignored without edge features)."""
    devices = [torch.device(d) for d in devices]

    def layer(params, x_s, x_d, src_tab, smask, ea_slots, send_next, send_prev):
        block = x_d.shape[0] // len(devices)
        fe = cfg.edge_features > 0
        plan = place_slot_plan({"src_tab": src_tab, "smask": smask, "send_next": send_next,
                                "send_prev": send_prev}, devices, block,
                               ea=ea_slots if fe else None)
        ea = [plan["groups"][0]["ea"]] if fe else None
        out = _dist_layer_local(replicate(params, devices), cfg, devices,
                                _split_rows(x_s, devices), _split_rows(x_d, devices), plan, ea)
        return _gather_rows(out, x_d.device)

    return layer


def make_dist_swegnn_wide(devices: Sequence, cfg: SWEGNNConfig, width: int, ring_ptr,
                          halo: int):
    """The width-W ring layer on whole arrays (JAX dist_swegnn.py:449-472):
    ``layer(params, x_s, x_d, src_tab, smask, ea_local, ext_tab, ext_mask,
    ea_ext, send_next, send_prev) -> [N, F]`` with
    ``build_wide_halo_plan``'s tables."""
    devices = [torch.device(d) for d in devices]

    def layer(params, x_s, x_d, src_tab, smask, ea_local, ext_tab, ext_mask, ea_ext,
              send_next, send_prev):
        fe = cfg.edge_features > 0
        plan = place_wide_plan({"src_tab": src_tab, "smask": smask, "ext_tab": ext_tab,
                                "ext_mask": ext_mask, "send_next": send_next,
                                "send_prev": send_prev}, devices, width, ring_ptr, halo,
                               ea=ea_local if fe else None, ext_ea=ea_ext if fe else None)
        out = _dist_layer_wide(replicate(params, devices), cfg, devices,
                               _split_rows(x_s, devices), _split_rows(x_d, devices), plan,
                               plan.get("ea"), plan.get("ext_ea"))
        return _gather_rows(out, x_d.device)

    return layer


def _split_x(cfg, x_static: torch.Tensor, x_dynamic: torch.Tensor):
    """A part's input rows -> (x0, static, dynamic): the static / dynamic
    split with the water level as a static column."""
    n_s = cfg.static_node_features - int(cfg.with_WL)
    x = torch.cat([x_static, x_dynamic], dim=-1)
    s, d = x[:, :n_s], x[:, n_s:]
    if cfg.with_WL:
        s = torch.cat([s, (s[:, -1] + d[:, -cfg.out_dim])[:, None]], dim=-1)
    return x, s, d


def _encode_x(params: list, cfg, x_static: list, x_dynamic: list):
    """Each part's input rows -> (x0, encoded static, encoded dynamic)
    (``_split_x``)."""
    x0, xs, xd = [], [], []
    for pp, a, b in zip(params, x_static, x_dynamic):
        x, s, d = _split_x(cfg, a, b)
        x0.append(x)
        xs.append(apply_mlp(pp["static_node_encoder"], s, activation=cfg.mlp_activation))
        xd.append(apply_mlp(pp["dynamic_node_encoder"], d, activation=cfg.mlp_activation))
    return x0, xs, xd


def _activate(params: list, cfg, h: list) -> list:
    if cfg.gnn_activation is None:
        return h
    return [apply_activation(cfg.gnn_activation, pp["gnn_act"], hp) for pp, hp in zip(params, h)]


def _decode(params: list, cfg, h: list, x0: list, node_mask: list) -> list:
    """Each part's processed rows -> predictions, as the single-device
    decoder: decoder, residual, ReLU, the small-depth mask and the node
    mask."""
    out = []
    for pp, hp, x, m in zip(params, h, x0, node_mask):
        o = apply_mlp(pp["node_decoder"], hp, activation=cfg.mlp_activation)
        o = o + base_model.add_residual_connection(
            x, pp.get("residual_weights"), cfg.learned_residuals, cfg.previous_t,
            cfg.out_dim)
        o = base_model.mask_small_wd(torch.relu(o), epsilon=0.0001)
        out.append(o * m[:, None])
    return out


def _encode_ea(params: list, cfg, ea: list) -> list:
    if not cfg.edge_mlp:
        return ea
    return [apply_mlp(pp["edge_encoder"], e, activation=cfg.mlp_activation)
            for pp, e in zip(params, ea)]


def make_dist_gnn_forward(devices: Sequence, cfg):
    """The single-scale SWE-GNN over the ring (JAX dist_swegnn.py:647-708;
    ``cfg`` a ``models.gnn.GNNConfig`` with ``type_gnn='SWEGNN'``):
    ``forward(params, x_static, x_dynamic, node_mask, src_tab, smask,
    ea_slots, send_next, send_prev) -> [N, 2]`` on ``x_static``'s device,
    with ``build_dist_slot_plan``'s tables and the raw edge features in
    dst-owned slot layout ``ea_slots [P, B, D, Fe]`` (``slot_ea_per_part``).
    Encoders, decoder and residuals are row-local; the SWEGNN layers
    exchange boundary rows."""
    if cfg.type_gnn != "SWEGNN":
        raise ValueError(f"the ring path covers the SWEGNN processor, not {cfg.type_gnn}")
    devices = [torch.device(d) for d in devices]

    def forward(params, x_static, x_dynamic, node_mask, src_tab, smask, ea_slots,
                send_next, send_prev):
        block = x_static.shape[0] // len(devices)
        plan = place_slot_plan({"src_tab": src_tab, "smask": smask, "send_next": send_next,
                                "send_prev": send_prev}, devices, block, ea=ea_slots)
        reps = replicate(params, devices)
        out = gnn_parts_forward(reps, cfg, devices, _split_rows(x_static, devices),
                                _split_rows(x_dynamic, devices),
                                _split_rows(node_mask, devices), plan)
        return _gather_rows(out, x_static.device)

    return forward


def gnn_parts_forward(reps: list, cfg, devices, x_static: list, x_dynamic: list,
                      node_mask: list, plan: dict, ea: Optional[list] = None) -> list:
    """The single-scale SWE-GNN on parts (``cfg`` a ``GNNConfig`` with
    ``type_gnn='SWEGNN'``): each argument a list over parts, ``reps`` each
    part's parameter copy, ``plan`` a placed slot plan of one group whose
    ``ea`` holds the raw slot edge features; ``ea`` the encoded ones
    (``[encoded group 0 features]``), encoded here when not given ->
    each part's ``[B_p, 2]`` predictions."""
    swe_cfg = cfg.swegnn_cfg()
    x0, x_s, x_d = _encode_x(reps, cfg, x_static, x_dynamic)
    if ea is None:
        ea = [_encode_ea(reps, cfg, plan["groups"][0]["ea"])]
    h = x_d
    for layer in range(cfg.n_gnn_layers):
        h = _activate(reps, cfg, _dist_layer_local(
            [pp["gnn_processor"][layer] for pp in reps], swe_cfg, devices, x_s, x_d,
            plan, ea))
        x_d = h
    return _decode(reps, cfg, h, x0, node_mask)


def _pool_cross(x_fine: list, plan: dict, devices) -> list:
    """Mean pooling of fine rows onto the coarse block across parts (JAX
    dist_swegnn.py:1020-1038), a plain gather-sum in slot order, as
    ``models/msgnn.py::_pool_block``: interior slots of a packed plan read
    the local fine block, the others the exchanged buffer. A coarse row that
    receives nothing becomes zero."""
    groups = plan["groups"]
    buf = _exchange(plan, x_fine, devices) if any(g["buffered"] for g in groups) else None
    out = []
    for p, xf in enumerate(x_fine):
        n_dst = groups[0]["tab"][p].shape[0]
        sums = torch.zeros(n_dst, xf.shape[1], dtype=xf.dtype, device=xf.device)
        cnt = torch.zeros(n_dst, 1, dtype=torch.float32, device=xf.device)
        for g in groups:
            src = buf[p] if g["buffered"] else xf
            tab, mask = g["tab"][p], g["mask"][p]
            for d in range(tab.shape[1]):
                sums = sums + src.index_select(0, tab[:, d]) * mask[:, d:d + 1]
            cnt = cnt + mask.sum(dim=1, keepdim=True)
        out.append(torch.where(cnt > 0, sums / cnt.clamp_min(1.0), torch.zeros_like(sums)))
    return out


def encode_dist_edges(reps: list, cfg, dist: dict) -> list:
    """Each scale's slot edge features encoded per part (JAX
    dist_swegnn.py:1062-1074; each real edge sits in one slot): per scale,
    a list over slot groups of lists over parts, or for a width-W plan the
    pair (block's, halo rows'). ``reps`` holds each part's parameter
    copy."""
    ea_b = []
    for pl in dist["proc"]:
        if "groups" in pl:
            ea_b.append([_encode_ea(reps, cfg, g["ea"]) for g in pl["groups"]])
        else:
            ea_b.append((_encode_ea(reps, cfg, pl["ea"]), _encode_ea(reps, cfg, pl["ext_ea"])))
    return ea_b


def make_dist_msgnn_forward(devices: Sequence, cfg, pool: Optional[Callable] = None):
    """The multiscale MSGNN over the ring (JAX dist_swegnn.py:990-1145; ``cfg``
    a ``models.msgnn.MSGNNConfig``):
    ``forward(params, dist, ea_b=None) -> per scale, the list of each part's
    [B_i, 2] predictions`` (part p on ``devices[p]``; concatenating every
    scale's parts in order gives the graph's scale-major rows). ``dist`` is
    ``place_dist_inputs``'s plans with the node features added, per scale a
    list over parts: ``x_static``, ``x_dynamic``, ``node_mask``; ``ea_b``
    the encoded slot edge features (``encode_dist_edges``), encoded in the
    call when not given.

    Processors exchange boundary rows a hop (or a window, on a width-W
    plan); pooling and un-pooling exchange rows across adjacent scales'
    parts. ``pool(reps, dist, lvl, x_fine, x_coarse) -> each part's pooled
    coarse block`` replaces the mean pooling (``_pool_cross`` of
    ``dist["pool"][lvl]``): the row blocks of parallel/gspmd.py pass their
    learned pooling. The ring path has none, and raises for
    ``learned_pooling`` as JAX's asserts (dist_swegnn.py:1015)."""
    if cfg.learned_pooling and pool is None:
        raise ValueError("the ring path covers mean pooling; learned_pooling runs on one "
                         "device or on the data x graph mesh (parallel: {mode: gspmd})")
    devices = [torch.device(d) for d in devices]
    L = cfg.num_scales
    ks = cfg.k_schedule

    def forward(params, dist, ea_b=None):
        reps = replicate(params, devices)
        x0_b, xs_b, xd_b = [], [], []
        for i in range(L):
            x0, xs, xd = _encode_x(reps, cfg, dist["x_static"][i], dist["x_dynamic"][i])
            x0_b.append(x0)
            xs_b.append(xs)
            xd_b.append(xd)
        if ea_b is None:
            ea_b = encode_dist_edges(reps, cfg, dist)

        def processor(i: int, gnn_id: int) -> list:
            pl = dist["proc"][i]
            layer = [pp["gnn_processor"][gnn_id] for pp in reps]
            pcfg = cfg.processor_cfg(ks[gnn_id])
            if "groups" in pl:
                return _dist_layer_local(layer, pcfg, devices, xs_b[i], xd_b[i], pl, ea_b[i])
            return _dist_layer_wide(layer, pcfg, devices, xs_b[i], xd_b[i], pl, *ea_b[i])

        zeros_b = [[torch.zeros_like(b) for b in blocks] for blocks in xd_b]
        x_down_b = [None] * L
        x_up_b = [None] * L
        # downsweep: fine -> coarse; pooling replaces the state
        for i in range(L - 1):
            xd_b[i] = processor(i, i)
            x_down_b[i] = xd_b[i]
            pooled = (_pool_cross(xd_b[i], dist["pool"][i], devices) if pool is None
                      else pool(reps, dist, i, xd_b[i], xd_b[i + 1]))
            for j in range(L):
                xd_b[j] = zeros_b[j]
            xd_b[i + 1] = pooled
        x_down_b[L - 1] = xd_b[L - 1]
        # upsweep: coarse -> fine
        for i in range(L):
            scale = L - 1 - i
            xd_b[scale] = processor(scale, L - 1 + i)
            x_up_b[scale] = xd_b[scale]
            if i < L - 1:
                lvl = scale - 1
                xd_b[lvl] = _dist_layer_local(
                    [pp["intra_scale_gnn"][i] for pp in reps], cfg.intra_cfg(), devices,
                    xs_b[lvl], xd_b[lvl], dist["unpool"][lvl],
                    x_s_src=xs_b[scale], x_d_src=xd_b[scale])
                if cfg.skip_connections:
                    xd_b[lvl] = [a + b for a, b in zip(xd_b[lvl], x_down_b[lvl])]
        return tuple(_decode(reps, cfg, _activate(reps, cfg, x_up_b[i]), x0_b[i],
                             dist["node_mask"][i]) for i in range(L))

    return forward
