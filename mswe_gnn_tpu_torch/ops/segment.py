"""Segment (gather / scatter) reductions on padded COO edge arrays (port of
mswe_gnn_tpu/ops/segment.py).

Edge arrays have a fixed padded length and a mask; a padded entry points at
a valid node and is multiplied by zero before it is reduced, so it adds
nothing. An empty segment gives exactly 0, as in the JAX package
(segment.py:75, :93).

These are library calls, not hand-written kernels: the JAX package computes
them as XLA ops (``jax.ops.segment_sum`` / ``segment_max``), outside any
Pallas kernel, so they are no TPU kernel to port. Here they are
``index_add`` and ``scatter_reduce``, on the CPU and on the GPU alike
(``index_add`` on CUDA adds with atomics, so a float32 sum may differ from
the CPU's in its last bits). They serve the single-scale GNN's baselines
(models/convs.py), the edge-major SWEGNN path and MSGNN's learned pooling.

``sort_edges_by_dst`` and ``coalesce_edges`` are the host-side numpy
helpers, copied (the port imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``idx`` (``x[idx]``)."""
    return x.index_select(0, idx.long())


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets given by
    ``segment_ids`` (PyG ``scatter(..., reduce='sum')``)."""
    out = torch.zeros(num_segments, *data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of the rows of ``data`` per segment; an empty segment gives 0.
    ``weights`` (one per row, e.g. an edge mask) leave padded rows out of
    both the sum and the count."""
    if weights is not None:
        data = data * weights[:, None]
        counts = segment_sum(weights, segment_ids, num_segments)
    else:
        counts = segment_sum(torch.ones(data.shape[0], dtype=data.dtype, device=data.device),
                             segment_ids, num_segments)
    sums = segment_sum(data, segment_ids, num_segments)
    counts = counts[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1.0), torch.zeros_like(sums))


def segment_max_raw(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Max per segment with the identity of max for an empty one (``-inf``,
    or an integer type's least value), as ``jax.ops.segment_max`` gives it
    (the models' masked softmax reads this)."""
    ids = segment_ids.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    empty = (float("-inf") if data.is_floating_point() else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments, *data.shape[1:]), empty, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, ids, data, reduce="amax", include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max per segment; an empty segment gives 0 (the PyG convention)."""
    out = segment_max_raw(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[0], dtype=torch.int32, device=data.device),
                         segment_ids, num_segments)
    counts = counts.view(-1, *([1] * (data.dim() - 1)))
    return torch.where(counts > 0, out, torch.zeros_like(out))


def sort_edges_by_dst(edge_index: np.ndarray, *extras: np.ndarray):
    """Host-side: reorder a COO edge list so that destinations ascend.
    Returns the permuted ``edge_index``, each of ``extras`` permuted the
    same way, and the permutation."""
    order = np.argsort(edge_index[1], kind="stable")
    out = edge_index[:, order]
    permuted = tuple(e[order] for e in extras)
    return (out, *permuted, order) if extras else (out, order)


def coalesce_edges(edge_index: np.ndarray) -> np.ndarray:
    """Host-side: remove duplicate directed edges (the first one stays)."""
    key = edge_index[0].astype(np.int64) * (edge_index.max() + 1) + edge_index[1]
    _, keep = np.unique(key, return_index=True)
    return edge_index[:, np.sort(keep)]
