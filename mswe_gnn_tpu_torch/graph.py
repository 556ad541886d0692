"""Static-shape padded graph containers (port of mswe_gnn_tpu/graph.py).

Every mesh is padded to a fixed ``GraphSpec``. Scale-major layout: nodes and
edges of scale 0 (finest) come first, then scale 1, ... so a scale is a
contiguous row range. Host-side building is numpy, as in the JAX package; the
result is a ``FloodGraph`` of torch tensors that ``.to(device)`` moves.

Batching is a disconnected union (``concat_graphs``, or ``DeviceConcatPlan``
over a device-resident ``stack_graphs`` container): one larger graph on the
tiled spec, whose scale blocks hold the graphs' sub-blocks back to back.

Padded entries:
- padded nodes have ``node_mask == 0``; their features are zero.
- padded edges point at the last node of their scale with ``edge_mask == 0``.
- ELL table slots past a node's degree hold edge 0 with mask 0.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch import native, tree_to


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

    def tile(self, b: int) -> "GraphSpec":
        """Spec of ``b`` same-spec graphs concatenated as one disconnected
        union, keeping the scale-major block structure (each scale block
        holds the b graphs' sub-blocks back to back)."""
        return GraphSpec(
            node_counts=tuple(b * c for c in self.node_counts),
            edge_counts=tuple(b * c for c in self.edge_counts),
            intra_edge_counts=tuple(b * c for c in self.intra_edge_counts),
            num_bc=b * self.num_bc,
            in_degree=self.in_degree, pool_degree=self.pool_degree,
            unpool_degree=self.unpool_degree)

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
    - ``num_graphs``: how many graphs a ``concat_graphs`` union holds (1 for
      one graph); each scale block holds their sub-blocks back to back
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
    num_graphs: int = 1

    @property
    def num_nodes(self) -> int:
        return self.x_static.shape[-2]

    @property
    def num_node_features(self) -> int:
        """The model's input columns a node: static, forcing (one a field,
        appended every step) and dynamic."""
        n_forcing = self.forcing.shape[-2] if self.forcing is not None else 0
        return self.x_static.shape[-1] + n_forcing + self.x_dynamic.shape[-1]

    def finest_slice(self) -> slice:
        return self.spec.node_slice(0)

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
    ``d_fixed`` when set). Aggregation then becomes gathers, no scatter.
    Without ``d_fixed`` the mesh core builds it (``native.build_ell_table``,
    as JAX graph.py:398-402; it raises where it cannot be built), else the
    plain version ``edge_slot_table_reference``."""
    if not d_fixed:
        return native.build_ell_table(np.asarray(edge_index[1]),
                                      np.asarray(edge_mask, np.float32), num_nodes, round_to)
    return edge_slot_table_reference(edge_index, edge_mask, num_nodes, round_to, d_fixed)


def edge_slot_table_reference(edge_index: np.ndarray, edge_mask: np.ndarray,
                              num_nodes: int, round_to: int = 4, d_fixed: int = 0):
    """The plain version of ``build_edge_slot_table``: a Python loop over
    the real edges."""
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


def ell_aggregate(msgs: torch.Tensor, table: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-edge messages ``[E, F]`` summed into nodes through the ELL table
    ``[N, D]`` and its mask: a gather and a sum (JAX graph.py:424-427)."""
    return (msgs[table.long()] * mask[..., None]).sum(dim=1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check_batchable(graphs) -> None:
    g0 = graphs[0]
    for g in graphs[1:]:
        if g.spec != g0.spec:
            raise ValueError("all graphs in a batch must share one GraphSpec")
        if g.previous_t != g0.previous_t or g.bc_kind != g0.bc_kind:
            raise ValueError("all graphs in a batch must share static settings")


def concat_graphs(graphs) -> FloodGraph:
    """Batch same-spec graphs as ONE disconnected-union graph (JAX
    graph.py:430-565), built on the host with numpy and returned on the
    first graph's device.

    Each scale block of the tiled spec (``GraphSpec.tile``) holds the b
    graphs' sub-blocks back to back, so every per-scale slice keeps working;
    index arrays (edge endpoints, ELL tables, BC nodes) are re-offset. The
    union carries no ``ell_cache`` and no band plan: a banded sample batches
    into an all-ELL union, as in the JAX package. ``b == 1`` returns the
    graph itself.

    Loss and metrics over the union equal the reference's concat-then-mean
    batch aggregation (reference training/loss.py:68-70); per-graph
    quantities reshape a scale block to ``[b, n_scale, ...]``.
    """
    _check_batchable(graphs)
    g0 = graphs[0]
    spec = g0.spec
    b = len(graphs)
    if b == 1:
        return g0
    tiled = spec.tile(b)
    ns = spec.num_scales
    node_ptr = np.asarray(spec.node_ptr)
    edge_ptr = np.asarray(spec.edge_ptr)
    intra_ptr = np.asarray(spec.intra_edge_ptr)

    def make_lut(ptr, t_ptr, counts):
        """old (per-graph) id -> union id, one row per graph"""
        lut = np.zeros((b, int(ptr[-1])), np.int64)
        for s in range(len(counts)):
            ids = np.arange(ptr[s], ptr[s + 1])
            for g in range(b):
                lut[g, ids] = t_ptr[s] + g * counts[s] + (ids - ptr[s])
        return lut

    node_lut = make_lut(node_ptr, tiled.node_ptr, spec.node_counts)
    edge_lut = make_lut(edge_ptr, tiled.edge_ptr, spec.edge_counts)
    intra_lut = (make_lut(intra_ptr, tiled.intra_edge_ptr, spec.intra_edge_counts)
                 if spec.num_intra_edges > 0 else np.zeros((b, 1), np.int64))

    def concat_by(ptr, counts, get):
        """Concatenate the per-scale blocks of a per-element array."""
        arrays = [_host(get(g)) for g in graphs]
        return np.concatenate([arrays[g][ptr[s]: ptr[s + 1]]
                               for s in range(len(counts)) for g in range(b)], axis=0)

    def node_cat(get):
        return concat_by(node_ptr, spec.node_counts, get)

    def edge_cat(get):
        return concat_by(edge_ptr, spec.edge_counts, get)

    def intra_cat(get):
        if spec.num_intra_edges == 0:
            return _host(get(g0))
        return concat_by(intra_ptr, spec.intra_edge_counts, get)

    eis = [_host(g.edge_index) for g in graphs]
    ieis = [_host(g.intra_edge_index) for g in graphs]
    ei = np.concatenate([node_lut[g][eis[g][:, edge_ptr[s]: edge_ptr[s + 1]]]
                         for s in range(ns) for g in range(b)], axis=1).astype(np.int32)
    iei_parts = [node_lut[g][ieis[g][:, intra_ptr[lvl]: intra_ptr[lvl + 1]]]
                 for lvl in range(ns - 1) for g in range(b)]
    iei = (np.concatenate(iei_parts, axis=1).astype(np.int32)
           if iei_parts else np.zeros((2, 1), np.int32))

    def table_cat(get_tab, lut):
        """ELL table rows in node order, entries remapped through ``lut``."""
        tabs = [_host(get_tab(g)) for g in graphs]
        return np.concatenate([lut[g][tabs[g][node_ptr[s]: node_ptr[s + 1]]]
                               for s in range(ns) for g in range(b)], axis=0).astype(np.int32)

    def bc_cat(get):
        return np.concatenate([_host(get(g)) for g in graphs], 0)

    bc_nodes = np.concatenate([node_lut[g][_host(graphs[g].bc_nodes).astype(np.int64)]
                               for g in range(b)]).astype(np.int32)
    t = torch.from_numpy
    union = FloodGraph(
        x_static=t(node_cat(lambda g: g.x_static)),
        x_dynamic=t(node_cat(lambda g: g.x_dynamic)),
        edge_index=t(ei),
        edge_attr=t(edge_cat(lambda g: g.edge_attr)),
        node_mask=t(node_cat(lambda g: g.node_mask)),
        edge_mask=t(edge_cat(lambda g: g.edge_mask)),
        intra_edge_index=t(iei),
        intra_edge_mask=t(intra_cat(lambda g: g.intra_edge_mask)),
        bc_nodes=t(bc_nodes),
        bc_mask=t(bc_cat(lambda g: g.bc_mask)),
        bc_values=t(bc_cat(lambda g: g.bc_values)),
        bc_edge_length=t(bc_cat(lambda g: g.bc_edge_length)),
        area=t(node_cat(lambda g: g.area)),
        dem=t(node_cat(lambda g: g.dem)),
        y=t(node_cat(lambda g: g.y)) if g0.y is not None else None,
        forcing=t(node_cat(lambda g: g.forcing)) if g0.forcing is not None else None,
        in_edge_table=t(table_cat(lambda g: g.in_edge_table, edge_lut)),
        in_edge_mask=t(node_cat(lambda g: g.in_edge_mask)),
        pool_table=t(table_cat(lambda g: g.pool_table, intra_lut)),
        pool_mask=t(node_cat(lambda g: g.pool_mask)),
        unpool_table=t(table_cat(lambda g: g.unpool_table, intra_lut)),
        unpool_mask=t(node_cat(lambda g: g.unpool_mask)),
        spec=tiled, previous_t=g0.previous_t, bc_kind=g0.bc_kind,
        temporal_res=g0.temporal_res, num_graphs=b)
    return union.to(g0.x_static.device)


def stack_graphs(graphs) -> FloodGraph:
    """Stack same-spec graphs along a new leading batch axis (JAX
    graph.py:567-580): every tensor field gains a ``[B]`` axis. A data
    container, the input of ``DeviceConcatPlan`` for a device-resident
    dataset, and the vmap layout's batch (``training/``, which folds it into
    the union of its graphs); it carries no ``ell_cache`` and no band plan
    (a union has neither)."""
    _check_batchable(graphs)
    stacked = {}
    for f in dataclasses.fields(FloodGraph):
        values = [getattr(g, f.name) for g in graphs]
        tensors = [isinstance(v, torch.Tensor) for v in values]
        if any(tensors) and not all(tensors):
            raise ValueError(f"graphs of a batch differ in whether they carry {f.name}")
        if all(tensors):
            stacked[f.name] = torch.stack(values, dim=0)
    return graphs[0].replace(ell_cache=None, band_plan=None, band_meta=None, **stacked)


class DeviceConcatPlan:
    """Batch assembly on the dataset's device (JAX graph.py:583-735):
    ``plan(stacked, idx) == concat_graphs([graphs[i] for i in idx])`` for
    ``stacked = stack_graphs(graphs)``, with no per-batch transfer but the
    ``[b]`` index vector.

    The whole same-spec sample set lives on the device once as a
    ``stack_graphs`` container; each batch is a gather plus an index remap
    in plain torch index ops on that device. The remap is the closed form of
    ``concat_graphs``'s lookup tables: ``new_id = (id - ptr[s]) +
    tiled_ptr[s] + slot * counts[s]``, where ``s`` is the scale owning ``id``
    (a ``searchsorted`` over the short ``ptr`` array).
    """

    def __init__(self, spec: GraphSpec, b: int):
        self.spec = spec
        self.b = b
        self.tiled = spec.tile(b)

        def perm(ptr, counts):
            g_of = np.concatenate([np.full(counts[s], g, np.int64)
                                   for s in range(len(counts)) for g in range(b)])
            r_of = np.concatenate([np.arange(ptr[s], ptr[s + 1], dtype=np.int64)
                                   for s in range(len(counts)) for g in range(b)])
            return torch.from_numpy(g_of), torch.from_numpy(r_of)

        def remap_tables(ptr, counts):
            t_ptr = np.cumsum([0, *[b * c for c in counts]])
            return (torch.as_tensor(ptr[:-1], dtype=torch.int64),
                    torch.as_tensor(t_ptr[:-1], dtype=torch.int64),
                    torch.as_tensor(counts, dtype=torch.int64))

        node_ptr = np.asarray(spec.node_ptr)
        edge_ptr = np.asarray(spec.edge_ptr)
        intra_ptr = np.asarray(spec.intra_edge_ptr)
        has_intra = spec.num_intra_edges > 0
        nbc = spec.num_bc
        self._host_tables = {
            "node_perm": perm(node_ptr, spec.node_counts),
            "edge_perm": perm(edge_ptr, spec.edge_counts),
            "intra_perm": perm(intra_ptr, spec.intra_edge_counts) if has_intra else None,
            "bc_perm": (torch.arange(b).repeat_interleave(nbc), torch.arange(nbc).repeat(b)),
            "node_remap": remap_tables(node_ptr, spec.node_counts),
            "edge_remap": remap_tables(edge_ptr, spec.edge_counts),
            "intra_remap": (remap_tables(intra_ptr, spec.intra_edge_counts)
                            if has_intra else None),
        }
        self._device_tables: dict = {}

    def _tables(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = tree_to(self._host_tables, device)
        return self._device_tables[key]

    @staticmethod
    def _remap(ids, slot, tables):
        """Closed-form lookup: the scale of every id, then an affine rebase."""
        ptr, t_ptr, counts = tables
        ids = ids.long()
        s = (torch.searchsorted(ptr, ids.contiguous(), right=True) - 1).clamp(0, len(ptr) - 1)
        return ((ids - ptr[s]) + t_ptr[s] + slot * counts[s]).to(torch.int32)

    @staticmethod
    def _gather(stacked_field, idx, perm):
        g_of, r_of = perm
        n = stacked_field.shape[1]
        flat = stacked_field.reshape((-1,) + tuple(stacked_field.shape[2:]))
        return flat.index_select(0, idx[g_of] * n + r_of)

    def __call__(self, stacked: FloodGraph, idx) -> FloodGraph:
        device = stacked.x_static.device
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(device)
        if tuple(idx.shape) != (self.b,):
            raise ValueError(f"idx must have shape ({self.b},), got {tuple(idx.shape)}")
        tb = self._tables(device)
        node_p, edge_p, intra_p, bc_p = (tb["node_perm"], tb["edge_perm"], tb["intra_perm"],
                                         tb["bc_perm"])
        gather = self._gather
        ei = gather(stacked.edge_index.transpose(1, 2), idx, edge_p)      # [Eu, 2]
        ei = self._remap(ei, edge_p[0][:, None], tb["node_remap"]).T.contiguous()
        if intra_p is not None:
            iei = gather(stacked.intra_edge_index.transpose(1, 2), idx, intra_p)
            iei = self._remap(iei, intra_p[0][:, None], tb["node_remap"]).T.contiguous()
            intra_mask = gather(stacked.intra_edge_mask, idx, intra_p)
        else:
            iei = stacked.intra_edge_index[idx[0]]
            intra_mask = stacked.intra_edge_mask[idx[0]]
        ng = node_p[0][:, None]
        in_tab = self._remap(gather(stacked.in_edge_table, idx, node_p), ng, tb["edge_remap"])
        pool_tab = gather(stacked.pool_table, idx, node_p)
        unpool_tab = gather(stacked.unpool_table, idx, node_p)
        if tb["intra_remap"] is not None:
            pool_tab = self._remap(pool_tab, ng, tb["intra_remap"])
            unpool_tab = self._remap(unpool_tab, ng, tb["intra_remap"])
        bc_nodes = self._remap(gather(stacked.bc_nodes, idx, bc_p), bc_p[0], tb["node_remap"])

        def nodes(f):
            return gather(f, idx, node_p)

        def edges(f):
            return gather(f, idx, edge_p)

        def bcs(f):
            return gather(f, idx, bc_p)

        return FloodGraph(
            x_static=nodes(stacked.x_static),
            x_dynamic=nodes(stacked.x_dynamic),
            edge_index=ei,
            edge_attr=edges(stacked.edge_attr),
            node_mask=nodes(stacked.node_mask),
            edge_mask=edges(stacked.edge_mask),
            intra_edge_index=iei,
            intra_edge_mask=intra_mask,
            bc_nodes=bc_nodes,
            bc_mask=bcs(stacked.bc_mask),
            bc_values=bcs(stacked.bc_values),
            bc_edge_length=bcs(stacked.bc_edge_length),
            area=nodes(stacked.area),
            dem=nodes(stacked.dem),
            y=nodes(stacked.y) if stacked.y is not None else None,
            forcing=nodes(stacked.forcing) if stacked.forcing is not None else None,
            in_edge_table=in_tab,
            in_edge_mask=nodes(stacked.in_edge_mask),
            pool_table=pool_tab,
            pool_mask=nodes(stacked.pool_mask),
            unpool_table=unpool_tab,
            unpool_mask=nodes(stacked.unpool_mask),
            spec=self.tiled, previous_t=stacked.previous_t, bc_kind=stacked.bc_kind,
            temporal_res=stacked.temporal_res, num_graphs=self.b)


@functools.lru_cache(maxsize=32)
def concat_plan(spec: GraphSpec, b: int) -> DeviceConcatPlan:
    """The ``DeviceConcatPlan`` of ``b`` graphs of ``spec``, built once a
    process (its host tables, and their copy on each device it ran on)."""
    return DeviceConcatPlan(spec, b)
