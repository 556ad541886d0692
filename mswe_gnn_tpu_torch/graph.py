"""Static-shape padded graph containers (port of mswe_gnn_tpu/graph.py).

Every mesh is padded to a fixed ``GraphSpec``. Scale-major layout: nodes and
edges of scale 0 (finest) come first, then scale 1, ... so a scale is a
contiguous row range. Host-side building is numpy, as in the JAX package; the
result is a ``FloodGraph`` of torch tensors that ``.to(device)`` moves.

Padded entries:
- padded nodes have ``node_mask == 0``; their features are zero.
- padded edges point at the last node of their scale with ``edge_mask == 0``.
- ELL table slots past a node's degree hold edge 0 with mask 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch import tree_to


@dataclasses.dataclass(frozen=True, eq=True)
class GraphSpec:
    """Static shape metadata for a padded multiscale graph.

    All counts are the *padded* per-scale sizes, finest scale first.
    """
    node_counts: Tuple[int, ...]          # padded nodes per scale
    edge_counts: Tuple[int, ...]          # padded dual-graph edges per scale
    intra_edge_counts: Tuple[int, ...]    # padded transfer edges between scale i and i+1
    num_bc: int                           # padded number of ghost (BC) nodes
    in_degree: int = 0                    # ELL table widths; 0 = derive from the mesh
    pool_degree: int = 0
    unpool_degree: int = 0

    @property
    def num_scales(self) -> int:
        return len(self.node_counts)

    @property
    def num_nodes(self) -> int:
        return int(sum(self.node_counts))

    @property
    def num_edges(self) -> int:
        return int(sum(self.edge_counts))

    @property
    def num_intra_edges(self) -> int:
        return int(sum(self.intra_edge_counts))

    @property
    def node_ptr(self) -> Tuple[int, ...]:
        return tuple(np.cumsum([0, *self.node_counts]).tolist())

    @property
    def edge_ptr(self) -> Tuple[int, ...]:
        return tuple(np.cumsum([0, *self.edge_counts]).tolist())

    @property
    def intra_edge_ptr(self) -> Tuple[int, ...]:
        return tuple(np.cumsum([0, *self.intra_edge_counts]).tolist())

    def node_slice(self, scale: int) -> slice:
        p = self.node_ptr
        return slice(p[scale], p[scale + 1])

    def edge_slice(self, scale: int) -> slice:
        p = self.edge_ptr
        return slice(p[scale], p[scale + 1])

    def intra_edge_slice(self, level: int) -> slice:
        p = self.intra_edge_ptr
        return slice(p[level], p[level + 1])


def _pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad ``x`` with ``fill`` along ``axis`` up to length ``n``."""
    cur = x.shape[axis]
    if cur > n:
        raise ValueError(f"cannot pad axis {axis} of length {cur} down to {n}")
    if cur == n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, n - cur)
    return np.pad(x, widths, constant_values=fill)


def round_up(n: int, multiple: int) -> int:
    return int(-(-n // multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class FloodGraph:
    """One padded (multiscale) flood-mesh sample as tensors.

    - ``x_static [N, S]``, ``x_dynamic [N, 2*previous_t]`` (interleaved h, |q|)
    - ``y [N, 2, T]`` ground-truth future steps (optional)
    - ``edge_index [2, E]`` int32, destination-sorted per scale
    - ``edge_attr [E, Fe]``, ``node_mask [N]``, ``edge_mask [E]``
    - ``intra_edge_index [2, EI]`` rows (coarse idx, fine idx)
    - ``bc_nodes [Nbc]`` int32 ghost node ids (padded entries are 0 and masked
      by ``bc_mask``), ``bc_values [Nbc, previous_t + T]``, ``bc_edge_length``
    - ``area [N]``, ``dem [N]``
    - ``forcing [N, Ff, previous_t + T]`` exogenous series (optional)
    - ELL tables ``[N, D]`` int32 of global edge ids with float masks:
      ``in_edge_table`` (incoming edges), ``pool_table`` (fine children),
      ``unpool_table`` (parent edges)
    - ``ell_cache``: loop-invariant tables attached by
      ``models.prepare.prepare_graph``
    - ``band_plan``: ``{"scales": (None | {"win", "idx_rel"}, ...)}``, the
      banded-hop plan of every scale, and ``band_meta``: its per-scale
      ``(ws, we)`` widths (None where a scale has no plan); attached on the
      host by ``ops.band_hop.attach_band_plan``
    """
    x_static: torch.Tensor
    x_dynamic: torch.Tensor
    edge_index: torch.Tensor
    edge_attr: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    intra_edge_index: torch.Tensor
    intra_edge_mask: torch.Tensor
    bc_nodes: torch.Tensor
    bc_mask: torch.Tensor
    bc_values: torch.Tensor
    bc_edge_length: torch.Tensor
    area: torch.Tensor
    dem: torch.Tensor
    in_edge_table: torch.Tensor
    in_edge_mask: torch.Tensor
    pool_table: torch.Tensor
    pool_mask: torch.Tensor
    unpool_table: torch.Tensor
    unpool_mask: torch.Tensor
    y: Optional[torch.Tensor] = None
    forcing: Optional[torch.Tensor] = None
    ell_cache: Optional[dict] = None
    band_plan: Optional[dict] = None
    band_meta: Optional[Tuple] = None
    spec: GraphSpec = None
    previous_t: int = 1
    bc_kind: int = 2
    temporal_res: float = 60.0

    @property
    def num_nodes(self) -> int:
        return self.x_static.shape[-2]

    def replace(self, **changes) -> "FloodGraph":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "FloodGraph":
        """The same graph with every tensor (the cache and the band plan
        included) on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: tree_to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, dict))})


def build_flood_graph(
    *,
    x_static: np.ndarray,
    x_dynamic: np.ndarray,
    edge_index: np.ndarray,
    edge_attr: np.ndarray,
    spec: GraphSpec,
    raw_node_counts: Tuple[int, ...],
    raw_edge_counts: Tuple[int, ...],
    intra_edge_index: Optional[np.ndarray] = None,
    raw_intra_edge_counts: Tuple[int, ...] = (),
    bc_nodes: Optional[np.ndarray] = None,
    bc_values: Optional[np.ndarray] = None,
    bc_edge_length: Optional[np.ndarray] = None,
    bc_kind: int = 2,
    area: Optional[np.ndarray] = None,
    dem: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    forcing: Optional[np.ndarray] = None,
    previous_t: int = 1,
    temporal_res: float = 60.0,
    dtype=np.float32,
) -> FloodGraph:
    """Assemble a padded ``FloodGraph`` (CPU tensors) from raw (unpadded,
    scale-major) arrays.

    ``raw_*_counts`` give the true per-scale sizes before padding; node and
    edge indices in the raw arrays must already refer to the *raw* scale-major
    node numbering — they are remapped to the padded numbering here.
    """
    ns = spec.num_scales
    assert len(raw_node_counts) == ns and len(raw_edge_counts) == ns

    raw_node_ptr = np.cumsum([0, *raw_node_counts])
    pad_node_ptr = np.asarray(spec.node_ptr)

    # raw node id -> padded node id (per-scale offset shift)
    total_raw_nodes = int(raw_node_ptr[-1])
    node_remap = np.zeros(total_raw_nodes, dtype=np.int64)
    for s in range(ns):
        raw_ids = np.arange(raw_node_ptr[s], raw_node_ptr[s + 1])
        node_remap[raw_ids] = raw_ids - raw_node_ptr[s] + pad_node_ptr[s]

    N = spec.num_nodes
    node_mask = np.zeros(N, dtype=dtype)
    for s in range(ns):
        node_mask[pad_node_ptr[s]: pad_node_ptr[s] + raw_node_counts[s]] = 1.0

    def pad_nodes(arr):
        if arr is None:
            return None
        arr = np.asarray(arr)
        out = np.zeros((N,) + arr.shape[1:], dtype=dtype)
        for s in range(ns):
            r0, r1 = raw_node_ptr[s], raw_node_ptr[s + 1]
            p0 = pad_node_ptr[s]
            out[p0: p0 + (r1 - r0)] = arr[r0:r1]
        return out

    x_static_p = pad_nodes(x_static)
    x_dynamic_p = pad_nodes(x_dynamic)
    area_p = pad_nodes(area if area is not None else np.ones(total_raw_nodes))
    dem_p = pad_nodes(dem if dem is not None else np.zeros(total_raw_nodes))
    y_p = pad_nodes(y)
    forcing_p = pad_nodes(forcing)

    # --- edges: per-scale pad; padded edges self-loop on the scale's last node
    raw_edge_ptr = np.cumsum([0, *raw_edge_counts])
    pad_edge_ptr = np.asarray(spec.edge_ptr)
    E = spec.num_edges
    ei = np.zeros((2, E), dtype=np.int32)
    ea = np.zeros((E,) + edge_attr.shape[1:], dtype=dtype)
    emask = np.zeros(E, dtype=dtype)
    for s in range(ns):
        r0, r1 = raw_edge_ptr[s], raw_edge_ptr[s + 1]
        p0 = pad_edge_ptr[s]
        n = r1 - r0
        block = node_remap[edge_index[:, r0:r1]]
        # destination-sort within the scale
        order = np.argsort(block[1], kind="stable")
        ei[:, p0: p0 + n] = block[:, order]
        ea[p0: p0 + n] = edge_attr[r0:r1][order]
        emask[p0: p0 + n] = 1.0
        ei[:, p0 + n: pad_edge_ptr[s + 1]] = pad_node_ptr[s + 1] - 1

    # --- intra (transfer) edges
    EI = spec.num_intra_edges
    if EI > 0:
        assert intra_edge_index is not None
        raw_ie_ptr = np.cumsum([0, *raw_intra_edge_counts])
        pad_ie_ptr = np.asarray(spec.intra_edge_ptr)
        iei = np.zeros((2, max(EI, 1)), dtype=np.int32)
        iemask = np.zeros(max(EI, 1), dtype=dtype)
        for lvl in range(ns - 1):
            r0, r1 = raw_ie_ptr[lvl], raw_ie_ptr[lvl + 1]
            p0 = pad_ie_ptr[lvl]
            n = r1 - r0
            block = node_remap[intra_edge_index[:, r0:r1]]
            order = np.argsort(block[0], kind="stable")  # sorted by coarse (dst)
            iei[:, p0: p0 + n] = block[:, order]
            iemask[p0: p0 + n] = 1.0
            anchor = pad_node_ptr[lvl + 2] - 1  # last node of the coarse scale
            iei[0, p0 + n: pad_ie_ptr[lvl + 1]] = anchor
            iei[1, p0 + n: pad_ie_ptr[lvl + 1]] = pad_node_ptr[lvl + 1] - 1
    else:
        iei = np.zeros((2, 1), dtype=np.int32)
        iemask = np.zeros(1, dtype=dtype)

    # --- boundary condition nodes
    nbc = spec.num_bc
    if bc_nodes is not None:
        raw_nbc = len(bc_nodes)
        bcn = np.zeros(nbc, dtype=np.int32)
        bcn[:raw_nbc] = node_remap[np.asarray(bc_nodes, dtype=np.int64)]
        bcm = np.zeros(nbc, dtype=dtype)
        bcm[:raw_nbc] = 1.0
        T1 = bc_values.shape[1]
        bcv = np.zeros((nbc, T1), dtype=dtype)
        bcv[:raw_nbc] = bc_values
        bel = np.ones(nbc, dtype=dtype)
        if bc_edge_length is not None:
            bel[:raw_nbc] = bc_edge_length
    else:
        bcn = np.zeros(nbc, dtype=np.int32)
        bcm = np.zeros(nbc, dtype=dtype)
        bcv = np.zeros((nbc, 1), dtype=dtype)
        bel = np.ones(nbc, dtype=dtype)

    in_tab, in_msk = build_edge_slot_table(ei, emask, N, round_to=4,
                                           d_fixed=spec.in_degree)
    pool_tab, pool_msk = build_edge_slot_table(
        np.stack([iei[1], iei[0]]), iemask, N, round_to=4,
        d_fixed=spec.pool_degree)
    unpool_tab, unpool_msk = build_edge_slot_table(iei, iemask, N, round_to=4,
                                                   d_fixed=spec.unpool_degree)

    t = torch.from_numpy
    return FloodGraph(
        in_edge_table=t(in_tab), in_edge_mask=t(in_msk),
        pool_table=t(pool_tab), pool_mask=t(pool_msk),
        unpool_table=t(unpool_tab), unpool_mask=t(unpool_msk),
        x_static=t(x_static_p), x_dynamic=t(x_dynamic_p),
        edge_index=t(ei), edge_attr=t(ea),
        node_mask=t(node_mask), edge_mask=t(emask),
        intra_edge_index=t(iei), intra_edge_mask=t(iemask),
        bc_nodes=t(bcn), bc_mask=t(bcm), bc_values=t(bcv), bc_edge_length=t(bel),
        area=t(area_p), dem=t(dem_p),
        y=t(y_p) if y_p is not None else None,
        forcing=t(forcing_p) if forcing_p is not None else None,
        spec=spec, previous_t=previous_t, bc_kind=int(bc_kind),
        temporal_res=float(temporal_res),
    )


def build_edge_slot_table(edge_index: np.ndarray, edge_mask: np.ndarray,
                          num_nodes: int, round_to: int = 4,
                          d_fixed: int = 0):
    """Host-side ELL table: for each node, the ids of its incoming (real)
    edges, padded to the max in-degree rounded up to ``round_to`` (or to
    ``d_fixed`` when set). Aggregation then becomes gathers, no scatter."""
    dst = np.asarray(edge_index[1])
    real = np.asarray(edge_mask) > 0
    indeg = np.bincount(dst[real], minlength=num_nodes)
    dmax = int(indeg.max()) if len(dst) else 1
    if d_fixed:
        if dmax > d_fixed:
            raise ValueError(f"mesh in-degree {dmax} exceeds the spec's table "
                             f"width {d_fixed}")
        dmax = d_fixed
    else:
        dmax = max(round_up(max(dmax, 1), round_to), round_to)
    table = np.zeros((num_nodes, dmax), np.int32)
    mask = np.zeros((num_nodes, dmax), np.float32)
    fill = np.zeros(num_nodes, np.int64)
    for e in np.where(real)[0]:
        n = dst[e]
        table[n, fill[n]] = e
        mask[n, fill[n]] = 1.0
        fill[n] += 1
    return table, mask
