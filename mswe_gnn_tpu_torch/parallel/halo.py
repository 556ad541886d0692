"""Edge-partitioned graph parallelism with explicit exchanges (port of
mswe_gnn_tpu/parallel/halo.py), over a list of partition devices.

Nodes are split into P contiguous blocks, block p on ``devices[p]``; each
part owns the edges whose destination is local, so the scatter side needs
no exchange. The sources may be remote: the halo. ``gather_remote`` fetches
every block (the JAX package's ``all_gather``); the ring variant ships only
the boundary rows to the ring neighbours (``build_ring_halo_plan``,
``make_ring_halo_aggregate``). The segment sums are ``index_add``
(``ops/segment.py``), as they are XLA ops in the JAX package, not kernels.
The host-side plans are numpy and give the JAX package's arrays bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mswe_gnn_tpu_torch.ops.segment import segment_sum
from mswe_gnn_tpu_torch.parallel.dist_swegnn import _gather_rows, _halo_concat, _split_rows


def _part_arrays(arr, devices) -> List[torch.Tensor]:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    return [t[p].to(d) for p, d in enumerate(devices)]


def gather_remote(x_blocks: Sequence[torch.Tensor], src_global: Sequence[torch.Tensor],
                  devices: Sequence) -> List[torch.Tensor]:
    """Each part's rows of the node-partitioned array at its global indices
    ``src_global[p]`` (JAX halo.py:28-35): every block is moved to the part's
    device and concatenated (the all-gather), then indexed."""
    out = []
    for src, d in zip(src_global, devices):
        x_all = torch.cat([b.to(d) for b in x_blocks], dim=0)
        out.append(x_all.index_select(0, src.long()))
    return out


def partitioned_segment_sum(messages: torch.Tensor, dst_local: torch.Tensor,
                            n_local: int) -> torch.Tensor:
    """The dst-owned scatter of one part: local, no exchange (JAX
    halo.py:38-44)."""
    return segment_sum(messages, dst_local, num_segments=n_local)


def spmd_gather_scatter(x_blocks: Sequence[torch.Tensor], src_global, dst_local,
                        edge_weight, n_local: int, devices: Sequence) -> List[torch.Tensor]:
    """One weighted aggregation hop over the parts (JAX halo.py:47-58):
    ``y_i = sum over the locally owned edges (j -> i) of w_ij * x_j``, the
    remote ``x_j`` fetched by ``gather_remote``. Arguments and result are
    lists over parts."""
    xj = gather_remote(x_blocks, src_global, devices)
    return [partitioned_segment_sum(x * w[:, None], dst, n_local)
            for x, dst, w in zip(xj, dst_local, edge_weight)]


def make_spmd_aggregate(devices: Sequence):
    """``agg(x [N, F], src_global [P, E], dst_local [P, E], edge_weight [P,
    E]) -> [N, F]`` on ``x``'s device: ``spmd_gather_scatter`` over the parts
    (JAX halo.py:61-77)."""
    devices = [torch.device(d) for d in devices]

    def agg(x, src_g, dst_l, w):
        blocks = _split_rows(x, devices)
        out = spmd_gather_scatter(blocks, _part_arrays(src_g, devices),
                                  _part_arrays(dst_l, devices), _part_arrays(w, devices),
                                  blocks[0].shape[0], devices)
        return _gather_rows(out, x.device)

    return agg


def build_ring_halo_plan(edge_index, n_nodes: int, n_parts: int) -> Optional[dict]:
    """Boundary-only halo plan of an edge list over a ring (JAX
    halo.py:80-135): ``send_next`` / ``send_prev [P, H]`` (the local rows part
    p ships to p+1 / p-1) with their masks, ``halo`` H and ``block``. The
    node order must keep every remote source on a ring neighbour (a BFS
    order, ``native.bfs_partition``); returns None where it does not."""
    if n_nodes % n_parts:
        raise ValueError("pad the node count to a multiple of n_parts")
    block = n_nodes // n_parts
    src = np.asarray(edge_index[0])
    dst = np.asarray(edge_index[1])
    owner_src = src // block
    owner_dst = dst // block
    for p in range(n_parts):
        mine = owner_dst == p
        owners = np.unique(src[mine][owner_src[mine] != p]) // block
        if not np.all((owners == (p - 1) % n_parts) | (owners == (p + 1) % n_parts)
                      | (owners == p)):
            return None  # the halo spans non-adjacent parts
    send_next, send_prev = [], []
    for p in range(n_parts):
        mine = owner_src == p
        send_next.append(np.unique(src[mine & (owner_dst == (p + 1) % n_parts)]) - p * block)
        send_prev.append(np.unique(src[mine & (owner_dst == (p - 1) % n_parts)]) - p * block)
    h = max([len(a) for a in send_next + send_prev] + [1])

    def pad(lists):
        tab = np.zeros((n_parts, h), np.int32)
        msk = np.zeros((n_parts, h), np.float32)
        for p, a in enumerate(lists):
            tab[p, :len(a)] = a
            msk[p, :len(a)] = 1.0
        return tab, msk

    sn, sn_m = pad(send_next)
    sp, sp_m = pad(send_prev)
    return {"send_next": sn, "send_next_mask": sn_m, "send_prev": sp, "send_prev_mask": sp_m,
            "halo": h, "block": block}


def remap_sources_to_halo(edge_index, plan: dict, n_parts: int):
    """Each part's edge sources remapped into its buffer ``[block | halo from
    p-1 | halo from p+1]`` (JAX halo.py:138-176) -> ``(src_local [P, Emax],
    dst_local [P, Emax], mask [P, Emax])``, each part's edges in their
    original order."""
    block, h = plan["block"], plan["halo"]
    src = np.asarray(edge_index[0]).astype(np.int64)
    dst = np.asarray(edge_index[1]).astype(np.int64)
    owner_dst = dst // block
    emax = max(int(np.bincount(owner_dst, minlength=n_parts).max()), 1)
    src_l = np.zeros((n_parts, emax), np.int32)
    dst_l = np.zeros((n_parts, emax), np.int32)
    mask = np.zeros((n_parts, emax), np.float32)
    for p in range(n_parts):
        sel = np.where(owner_dst == p)[0]
        prv, nxt = (p - 1) % n_parts, (p + 1) % n_parts
        lut = np.full(block * n_parts, -1, np.int64)
        real = plan["send_next_mask"][prv] > 0
        lut[prv * block + plan["send_next"][prv][real]] = block + np.where(real)[0]
        real = plan["send_prev_mask"][nxt] > 0
        lut[nxt * block + plan["send_prev"][nxt][real]] = block + h + np.where(real)[0]
        s = src[sel]
        src_l[p, :len(sel)] = np.where(s // block == p, s - p * block, lut[s])
        dst_l[p, :len(sel)] = dst[sel] - p * block
        mask[p, :len(sel)] = 1.0
    return src_l, dst_l, mask


def make_ring_halo_aggregate(devices: Sequence, halo: int):
    """``agg(x [N, F], send_next, send_prev, src_local, dst_local, w) -> [N,
    F]`` on ``x``'s device: the weighted aggregation with a boundary-only
    ring exchange (JAX halo.py:179-204); the tables are
    ``build_ring_halo_plan``'s and ``remap_sources_to_halo``'s."""
    devices = [torch.device(d) for d in devices]

    def agg(x, send_next, send_prev, src_l, dst_l, w):
        blocks = _split_rows(x, devices)
        sn = [t.long() for t in _part_arrays(send_next, devices)]
        sp = [t.long() for t in _part_arrays(send_prev, devices)]
        if sn[0].shape[0] != halo:
            raise ValueError(f"send tables of {sn[0].shape[0]} rows, plan halo {halo}")
        bufs = _halo_concat(blocks, sn, sp, devices)
        out = [partitioned_segment_sum(b.index_select(0, s.long()) * ww[:, None], dd,
                                       blocks[0].shape[0])
               for b, s, dd, ww in zip(bufs, _part_arrays(src_l, devices),
                                       _part_arrays(dst_l, devices), _part_arrays(w, devices))]
        return _gather_rows(out, x.device)

    return agg


def partition_edges_by_dst(edge_index, edge_attr, edge_mask, n_nodes: int, n_parts: int):
    """Each edge assigned to the owner of its destination, the per-part lists
    padded to one length (JAX halo.py:207-238) -> ``(src_global [P, Emax],
    dst_local [P, Emax], attr [P, Emax, Fe], mask [P, Emax])``."""
    if n_nodes % n_parts:
        raise ValueError("pad the node count to a multiple of n_parts")
    block = n_nodes // n_parts
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    attr_in = np.asarray(edge_attr)
    owner = dst // block
    emax = max(int(np.bincount(owner, minlength=n_parts).max()) if len(src) else 1, 1)
    src_g = np.zeros((n_parts, emax), np.int32)
    dst_l = np.zeros((n_parts, emax), np.int32)
    attr = np.zeros((n_parts, emax) + attr_in.shape[1:], np.float32)
    mask = np.zeros((n_parts, emax), np.float32)
    for p in range(n_parts):
        sel = np.where(owner == p)[0]
        k = len(sel)
        src_g[p, :k] = src[sel]
        dst_l[p, :k] = dst[sel] - p * block
        attr[p, :k] = attr_in[sel]
        mask[p, :k] = np.asarray(edge_mask)[sel]
    return src_g, dst_l, attr, mask
