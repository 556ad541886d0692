"""Autoregressive rollout (port of mswe_gnn_tpu/training/rollout.py).

A Python loop over steps: inject the boundary condition into the ghost rows,
predict, shift the prediction into the dynamic window (reference
utils/dataset.py:486-529, training/train.py:67-95). A ``concat_graphs`` union
rolls out as one graph: its BC arrays hold every graph's ghost rows.

``rollout_batch`` (JAX rollout.py:130-132, a ``jax.vmap`` over a stacked
batch) folds the stacked batch into the union ``DeviceConcatPlan`` builds on
the device, rolls it out as one graph and unfolds the result to stacked
order. A batch placed on a mesh (``parallel/sharding.py``) rolls out row by
row: each data row its own graphs' union, split over the row's ``graph``
devices by ``parallel/gspmd.py``.
"""
from __future__ import annotations

from typing import Callable

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS, resolve_device, tree_to
from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.parallel.gspmd import row_model
from mswe_gnn_tpu_torch.parallel.sharding import MeshBatch, fold, unfold_nodes


def bc_window(graph: FloodGraph, step: int) -> torch.Tensor:
    """BC values seen by the ``previous_t`` input steps at rollout ``step``:
    columns step .. step+previous_t-1 of the dry-bed-padded series
    ``graph.bc_values [Nbc, previous_t + T]``."""
    if not 0 <= step <= graph.bc_values.shape[1] - graph.previous_t:
        raise IndexError(f"rollout step {step} is outside the BC series")
    return graph.bc_values[:, step: step + graph.previous_t]


def bc_midpoint(graph: FloodGraph, step: int) -> torch.Tensor:
    """Mean of the last two BC entries of window ``step + 1``: the value of
    the reference's conservation loss (reference training/train.py:138,
    ``BC[:,-2:,i+1].mean(1)``), a midpoint rule for instantaneous-sample BC
    series (JAX rollout.py:31-38)."""
    return bc_window(graph, step + 1)[:, -2:].mean(dim=1)


def bc_step_inflow(graph: FloodGraph, step: int) -> torch.Tensor:
    """Inflow driving rollout step ``step``'s transition: the BC value at the
    last input frame's timestamp (rollout.py:40-47), which the
    mass-conservation loss uses."""
    return bc_window(graph, step)[:, -1]


def inject_bc(x_dynamic: torch.Tensor, graph: FloodGraph,
              window: torch.Tensor) -> torch.Tensor:
    """Write BC values into the ghost-cell rows of the dynamic features
    (reference utils/dataset.py:486-497).

    ``window`` is [Nbc, previous_t]; the (bc_kind-1)-th interleaved column of
    every input step is overwritten for real ghost nodes. Padded
    ``bc_nodes`` entries are 0 and only ``bc_mask`` tells them apart, so the
    values and the row selection are masked before anything is written:
    a plain scatter would overwrite node 0.
    """
    n = x_dynamic.shape[0]
    p = graph.previous_t
    col = graph.bc_kind - 1
    idx = graph.bc_nodes.long()
    mask = graph.bc_mask.to(x_dynamic.dtype)
    bc_rows = torch.zeros(n, p, dtype=x_dynamic.dtype, device=x_dynamic.device)
    bc_rows.index_add_(0, idx, window.to(x_dynamic.dtype) * mask[:, None])
    hits = torch.zeros(n, dtype=x_dynamic.dtype, device=x_dynamic.device)
    hits.index_add_(0, idx, mask)
    x = x_dynamic.reshape(n, p, NUM_WATER_VARS).clone()
    x[:, :, col] = torch.where(hits[:, None] > 0, bc_rows, x[:, :, col])
    return x.reshape(n, p * NUM_WATER_VARS)


def with_step_forcing(graph: FloodGraph, step: int) -> FloodGraph:
    """Append the current-time exogenous forcing (column
    ``step + previous_t - 1`` of ``graph.forcing``) to the static features.
    No-op without forcing."""
    if graph.forcing is None:
        return graph
    cur = graph.forcing[:, :, step + graph.previous_t - 1]
    return graph.replace(x_static=torch.cat([graph.x_static, cur], dim=1))


def shift_prediction(x_dynamic: torch.Tensor, pred: torch.Tensor,
                     previous_t: int) -> torch.Tensor:
    """Drop the oldest input step, append the prediction
    (reference utils/dataset.py:508-529)."""
    if previous_t == 1:
        return pred
    return torch.cat([x_dynamic[:, NUM_WATER_VARS:], pred], dim=-1)


def _unroll(fwd: Callable, graph: FloodGraph, steps: int) -> torch.Tensor:
    """The autoregressive loop of ``fwd(graph at step t) -> [N, 2]`` ->
    predictions [N, 2, steps]."""
    x_dyn = graph.x_dynamic
    preds = []
    for t in range(steps):
        x_dyn = inject_bc(x_dyn, graph, bc_window(graph, t))
        pred = fwd(with_step_forcing(graph, t).replace(x_dynamic=x_dyn))
        x_dyn = shift_prediction(x_dyn, pred, graph.previous_t)
        preds.append(pred)
    return torch.stack(preds, dim=-1)


def rollout(apply_fn: Callable, params, cfg, graph: FloodGraph, steps: int,
            device=None) -> torch.Tensor:
    """Full autoregressive rollout -> predictions [N, 2, steps].

    Runs on ``device`` (default: the GPU; raises when there is none); the
    graph and the parameters are moved there. Loop-invariant tables are
    prepared once (models/prepare.py)."""
    device = resolve_device(device)
    graph = graph.to(device)
    params = tree_to(params, device)
    with torch.inference_mode():
        graph = prepare_graph(params, cfg, graph)
        return _unroll(lambda g: apply_fn(params, cfg, g), graph, steps)


def rollout_row(apply_fn: Callable, params, cfg, row, steps: int) -> torch.Tensor:
    """The rollout of one placed row (``sharding.RowBatch``) -> its union's
    predictions [N_row, 2, steps] on the row's first device: on one device
    ``rollout`` with ``apply_fn``, else ``cfg``'s model over the row's
    devices (``gspmd.RowModel``)."""
    if len(row.devices) == 1:
        return rollout(apply_fn, params, cfg, row.graph, steps, device=row.devices[0])
    model = row_model(row, cfg)
    with torch.inference_mode():
        encoded = model.encode_edges(params)
        return _unroll(lambda g: model(params, g, encoded), row.graph, steps)


def rollout_batch(apply_fn: Callable, params, cfg, batch, steps: int,
                  device=None) -> torch.Tensor:
    """Rollout of a stacked batch -> [B, N, 2, steps] (JAX
    rollout.py:130-132), each graph's rollout as ``rollout`` gives it alone.

    ``batch`` is a ``stack_graphs`` batch, folded into one union on
    ``device`` (default: the GPU), or a ``sharding.MeshBatch``: every row of
    this process rolls out its own graphs, and the predictions of this
    process's graphs come back in batch order on the first row's first
    device."""
    if not isinstance(batch, MeshBatch):
        union = fold(batch.to(resolve_device(device)))
        return unfold_nodes(rollout(apply_fn, params, cfg, union, steps, device=device),
                            union.spec, union.num_graphs)
    rows = [r for r in batch.rows if r.graph is not None]
    home = batch.rows[0].devices[0]
    return torch.cat([unfold_nodes(rollout_row(apply_fn, params, cfg, r, steps),
                                   r.graph.spec, len(r.index)).to(home) for r in rows])
