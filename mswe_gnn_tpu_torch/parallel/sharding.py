"""The device mesh and the placement of batches on it (port of
mswe_gnn_tpu/parallel/sharding.py).

The JAX package lays its devices out as a ``Mesh`` with axes ``("data",
"graph")`` and hands GSPMD a ``NamedSharding`` per array. The port drives
its devices from one controller per process, so its mesh is an ``[n_data,
n_graph]`` grid of ``torch.device``s (``make_mesh``) and a sharding becomes
a placement plan:

- ``batch_sharding`` / ``union_sharding`` give each tensor field of a batch
  the JAX package's ``PartitionSpec`` as a tuple, by the same rule (which
  leaves split over ``data``, ``graph`` or both, which stay whole);
- ``place`` (``shard_batch``, ``shard_union_batch``) follows the spec of
  the batch's node features: its graphs go over the data rows where the
  batch axis is split (a union's graphs too, which keeps every graph's
  rows on one row), each row's graphs become one ``concat_graphs`` union on
  the row's first device, and where the node axis is split the model on
  the row (``parallel/gspmd.py``) splits that union's node rows over the
  row's ``graph`` devices in row blocks, every scale alike. The edge
  tables become each block's slot tables there; BC arrays stay whole.

JAX's ``global_put`` and ``replicate`` have no counterpart here: a row's
union is gathered from the device-resident batch, and the parameters stay
on one device and are copied to a row's devices inside each forward
(``dist_swegnn.replicate``), so that autograd sums the copies' gradients.

A grid may repeat a device (eight entries of ``cuda:0``, or of ``cpu``), the
counterpart of the JAX package's virtual CPU mesh: the math is the same and
every move is a no-op.

Across processes (``torch.distributed`` initialised, ``main.py``) each
process holds ``n_data / world_size`` of the global mesh's rows, the grid
``make_mesh`` returns there; a row never spans processes. The global batch
is split over the global rows, and each process places the graphs of its
own rows.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch.graph import FloodGraph, concat_plan

DATA, GRAPH = "data", "graph"


def process_index() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) unless
    ``torch.distributed`` is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: int, n_graph: int = 1,
              devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """This process's ``[rows][n_graph]`` devices of a global ``n_data x
    n_graph`` mesh, filled row by row from ``devices`` (default: every
    visible CUDA device; across processes the local rank's share of them,
    ``LOCAL_RANK`` or the rank). In one process that is the whole mesh;
    across W processes each holds ``n_data / W`` rows. Raises when
    ``n_data`` does not divide by W or ``devices`` has fewer entries than
    the rows need, as the JAX package asserts."""
    rank, world = process_index()
    if n_data * n_graph < 1:
        raise ValueError(f"a mesh of {n_data} x {n_graph} devices")
    if n_data % world:
        raise ValueError(f"parallel.data = {n_data} does not divide over {world} processes")
    rows = n_data // world
    n = rows * n_graph
    if devices is None:
        first = n * int(os.environ.get("LOCAL_RANK", rank)) if world > 1 else 0
        devices = [torch.device("cuda", i)
                   for i in range(first, torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        where = f" in each of {world} processes" if world > 1 else ""
        raise ValueError(f"need {n} devices for a {rows} x {n_graph} mesh{where}, "
                         f"have {len(devices)}")
    return [devices[r * n_graph:(r + 1) * n_graph] for r in range(rows)]


def mesh_shape(mesh) -> Tuple[int, int]:
    """(global data rows, graph devices a row)."""
    return len(mesh) * process_index()[1], len(mesh[0])


def _tensor_fields(graph: FloodGraph) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(graph, f.name) for f in dataclasses.fields(graph)
            if isinstance(getattr(graph, f.name), torch.Tensor)}


def _stacked_spec(shape: tuple, n_data: int, n_graph: int) -> tuple:
    """JAX's spec of a stacked leaf (sharding.py:42-56): the leading axis on
    ``data`` where it divides by the data rows (a smaller batch stays
    whole), the node or edge axis on ``graph`` where it divides and holds
    at least two rows a device (BC arrays and small masks stay whole)."""
    if not shape:
        return ()
    parts = [None] * len(shape)
    if shape[0] % n_data == 0:
        parts[0] = DATA
    if len(shape) >= 2 and shape[1] >= 2 * n_graph and shape[1] % n_graph == 0:
        parts[1] = GRAPH
    return tuple(parts)


def _union_spec(shape: tuple, n_dev: int) -> tuple:
    """JAX's spec of a union leaf (sharding.py:100-110): the node or edge
    axis over all devices (``("data", "graph")``), ``edge_index [2, E]`` on
    its edge axis; a leaf whose axis does not divide by the device count,
    or holds fewer than two rows a device, stays whole."""
    if not shape:
        return ()
    axes = (DATA, GRAPH)
    if len(shape) == 2 and shape[0] == 2 and shape[1] % n_dev == 0 and shape[1] >= 2 * n_dev:
        return (None, axes)
    if shape[0] % n_dev == 0 and shape[0] >= 2 * n_dev:
        return (axes,) + (None,) * (len(shape) - 1)
    return ()


def batch_sharding(mesh, batch: FloodGraph) -> Dict[str, tuple]:
    """The ``PartitionSpec`` of every tensor field of a stacked batch, as a
    tuple (JAX sharding.py:35-56, ``shard_graph`` on)."""
    n_data, n_graph = mesh_shape(mesh)
    return {k: _stacked_spec(tuple(v.shape), n_data, n_graph)
            for k, v in _tensor_fields(batch).items()}


def union_sharding(mesh, batch: FloodGraph) -> Dict[str, tuple]:
    """The ``PartitionSpec`` of every tensor field of a ``concat_graphs``
    union, as a tuple (JAX sharding.py:87-110)."""
    n_data, n_graph = mesh_shape(mesh)
    return {k: _union_spec(tuple(v.shape), n_data * n_graph)
            for k, v in _tensor_fields(batch).items()}


# ---------------------------------------------------------------- placed batches

@dataclasses.dataclass
class RowBatch:
    """The graphs of one data row (global row ``row``): their ids in the
    global batch, their ``concat_graphs`` union on ``devices[0]`` (None when
    the row has none) and the devices whose row blocks the model splits it
    over (one device: the row runs unsplit)."""
    row: int
    devices: List[torch.device]
    index: np.ndarray
    graph: Optional[FloodGraph]


@dataclasses.dataclass
class MeshBatch:
    """A batch placed on a mesh: this process's rows of the ``n_rows``
    global data rows, the global batch's graph count and the layout it came
    in (``"stacked"`` or ``"union"``)."""
    rows: List[RowBatch]
    n_rows: int
    num_graphs: int
    layout: str


def place(stacked: FloodGraph, select, mesh, layout: str = "stacked") -> MeshBatch:
    """The batch of graphs ``select`` of a ``stack_graphs`` container
    (``stacked``, on any device) placed on the mesh, as the spec JAX gives
    the batch's node features says: ``batch_sharding``'s of the stacked
    batch ``[b, N, F]``, or for the ``"union"`` layout ``union_sharding``'s
    of the union ``[b N, F]``.

    - Batch axis on ``data`` (union: node axis over all devices): the
      graphs go over the global data rows in consecutive runs
      (``np.array_split``); else all go on row 0 (JAX replicates the batch
      over ``data``; the port computes it once).
    - Node axis on ``graph`` (union: the same split): the model splits each
      row's union over the row's devices (``parallel/gspmd.py``); else the
      row runs on its first device (JAX replicates the graph over
      ``graph``).

    Each of this process's rows is given the union of its graphs, gathered
    on ``stacked``'s device by a ``DeviceConcatPlan`` and moved to the row's
    first device."""
    rank, _ = process_index()
    n_data, n_graph = mesh_shape(mesh)
    select = np.asarray(select, np.int64)
    b = len(select)
    n, f = stacked.x_static.shape[1:]
    if layout == "stacked":
        spec = _stacked_spec((b, n, f), n_data, n_graph)
        split_rows, split_graph = spec[0] == DATA, spec[1] == GRAPH
    else:
        split_rows = split_graph = _union_spec((b * n, f), n_data * n_graph) != ()
    index = (np.array_split(np.arange(b), n_data) if split_rows
             else [np.arange(b)] + [np.arange(0)] * (n_data - 1))
    rows = []
    for r, devices in enumerate(mesh):
        row = rank * len(mesh) + r
        idx = index[row]
        union = None
        if len(idx):
            union = concat_plan(stacked.spec, len(idx))(stacked, select[idx]).to(devices[0])
        rows.append(RowBatch(row=row, devices=list(devices if split_graph else devices[:1]),
                             index=idx, graph=union))
    return MeshBatch(rows=rows, n_rows=n_data, num_graphs=b, layout=layout)


def shard_batch(batch: FloodGraph, mesh) -> MeshBatch:
    """Place a ``stack_graphs`` batch on the mesh (JAX sharding.py:75-78;
    ``place``)."""
    return place(batch, np.arange(batch.x_static.shape[0]), mesh)


def shard_union_batch(batch: FloodGraph, mesh) -> MeshBatch:
    """Place a ``concat_graphs`` union on the mesh (JAX sharding.py:113-116;
    ``place``). The JAX package splits the union's rows in one flat range
    over all devices; the port keeps each graph whole on one row and splits
    each row's union over the row's devices, with the same results."""
    return place(unstack_union(batch), np.arange(batch.num_graphs), mesh, layout="union")


def fold(stacked: FloodGraph) -> FloodGraph:
    """A ``stack_graphs`` batch -> the ``concat_graphs`` union of its graphs,
    assembled on its device (``DeviceConcatPlan``)."""
    b = stacked.x_static.shape[0]
    return concat_plan(stacked.spec, b)(stacked, np.arange(b))


def _unfold(x: torch.Tensor, counts, ptr, b: int, axis: int = 0) -> torch.Tensor:
    """``x`` with ``axis`` holding b graphs' blocks per scale back to back
    (``ptr`` the tiled offsets, ``counts`` one graph's) -> ``[b, ...]`` with
    ``axis`` holding one graph's blocks."""
    x = x.movedim(axis, 0)
    blocks = [x[ptr[s]:ptr[s + 1]].reshape(b, c, *x.shape[1:]) for s, c in enumerate(counts)]
    return torch.cat(blocks, dim=1).movedim(1, axis + 1)


def unfold_nodes(x: torch.Tensor, spec, b: int) -> torch.Tensor:
    """A union's node rows ``[N_tiled, ...]`` (``spec`` its tiled spec) ->
    each graph's ``[b, N, ...]`` in its own row order."""
    return _unfold(x, [c // b for c in spec.node_counts], spec.node_ptr, b)


def unstack_union(union: FloodGraph) -> FloodGraph:
    """A ``concat_graphs`` union -> the ``stack_graphs`` batch of its graphs
    (the inverse: ``DeviceConcatPlan(spec, b)(unstack_union(u), range(b))``
    is ``u`` bit for bit). Node, edge, transfer-edge and BC rows go back to
    their graphs, and every id (edge endpoints, ELL table entries, BC nodes)
    back to its graph's own numbering."""
    b = union.num_graphs
    tiled = union.spec
    base = dataclasses.replace(
        tiled, node_counts=tuple(c // b for c in tiled.node_counts),
        edge_counts=tuple(c // b for c in tiled.edge_counts),
        intra_edge_counts=tuple(c // b for c in tiled.intra_edge_counts),
        num_bc=tiled.num_bc // b)
    device = union.x_static.device

    def unfold(x, counts, ptr, axis=0):
        return _unfold(x, counts, ptr, b, axis)

    def local(ids, counts, t_ptr, ptr):
        """union ids -> each graph's own ids: (id - tiled_ptr[s]) mod c[s] + ptr[s]."""
        t_ptr_t = torch.as_tensor(t_ptr[:-1], dtype=torch.int64, device=device)
        ptr_t = torch.as_tensor(ptr[:-1], dtype=torch.int64, device=device)
        c_t = torch.as_tensor(counts, dtype=torch.int64, device=device)
        ids = ids.long()
        s = (torch.searchsorted(t_ptr_t, ids.contiguous(), right=True) - 1).clamp(
            0, len(counts) - 1)
        return ((ids - t_ptr_t[s]) % c_t[s] + ptr_t[s]).to(torch.int32)

    def nodes(x):
        return None if x is None else unfold(x, base.node_counts, tiled.node_ptr)

    def bcs(x):
        return x.reshape(b, -1, *x.shape[1:])

    node_l = (base.node_counts, tiled.node_ptr, base.node_ptr)
    edge_l = (base.edge_counts, tiled.edge_ptr, base.edge_ptr)
    intra_l = (base.intra_edge_counts, tiled.intra_edge_ptr, base.intra_edge_ptr)
    ei = unfold(union.edge_index, base.edge_counts, tiled.edge_ptr, axis=1)
    if base.num_intra_edges > 0:
        iei = local(unfold(union.intra_edge_index, base.intra_edge_counts,
                           tiled.intra_edge_ptr, axis=1), *node_l)
        imask = unfold(union.intra_edge_mask, base.intra_edge_counts, tiled.intra_edge_ptr)
        pool = local(nodes(union.pool_table), *intra_l)
        unpool = local(nodes(union.unpool_table), *intra_l)
    else:
        iei = union.intra_edge_index[None].expand(b, -1, -1).contiguous()
        imask = union.intra_edge_mask[None].expand(b, -1).contiguous()
        pool, unpool = nodes(union.pool_table), nodes(union.unpool_table)
    return union.replace(
        x_static=nodes(union.x_static), x_dynamic=nodes(union.x_dynamic),
        edge_index=local(ei, *node_l), edge_attr=unfold(union.edge_attr, *edge_l[:2]),
        node_mask=nodes(union.node_mask),
        edge_mask=unfold(union.edge_mask, *edge_l[:2]),
        intra_edge_index=iei, intra_edge_mask=imask,
        bc_nodes=local(bcs(union.bc_nodes), *node_l), bc_mask=bcs(union.bc_mask),
        bc_values=bcs(union.bc_values), bc_edge_length=bcs(union.bc_edge_length),
        area=nodes(union.area), dem=nodes(union.dem), y=nodes(union.y),
        forcing=nodes(union.forcing),
        in_edge_table=local(nodes(union.in_edge_table), *edge_l),
        in_edge_mask=nodes(union.in_edge_mask), pool_table=pool,
        pool_mask=nodes(union.pool_mask), unpool_table=unpool,
        unpool_mask=nodes(union.unpool_mask), spec=base, num_graphs=1,
        ell_cache=None, band_plan=None, band_meta=None)
