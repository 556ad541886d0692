"""Training: the pushforward rollout loss, AdamW with a staircase StepLR and
global-norm clipping, the curriculum, validation, early stopping, checkpoints
and resume (port of mswe_gnn_tpu/training/train.py).

- ``pushforward_loss`` unrolls the model over ``rollout_steps`` steps in a
  Python loop, with gradients through the whole unroll (no detach between
  steps), as the JAX package's ``lax.scan`` does. With ``opts.remat`` each
  step's model call runs under ``torch.utils.checkpoint`` (non-reentrant),
  as ``jax.checkpoint`` wraps ``apply_fn`` there. A batch is one graph or a
  ``concat_graphs`` union (``opts.batch_size`` graphs).
- The loop-invariant graph cache (models/prepare.py) is built inside the
  loss, with gradients on, so that the edge encoder is trained.
- The optimizer is ``optax.chain(clip_by_global_norm, adamw)`` written out:
  the clip is optax's (no epsilon added to the norm, unlike
  ``torch.nn.utils.clip_grad_norm_``), AdamW is ``torch.optim.AdamW`` with
  the options' weight decay (torch's default 0.01 is not the JAX
  package's), and the learning rate is the epoch staircase
  ``gamma ** (step // (step_size * steps_per_epoch))``.
- ``Trainer`` assembles its batches on the device (``DeviceConcatPlan``
  over a ``stack_graphs`` copy of each sample list), autosaves
  (``training/checkpoint.py``), resumes, and touches a heartbeat file.
- A stacked batch (the vmap layout, JAX train.py:295-299) is folded into the
  union of its graphs: the errors come from the sums and counts over the
  whole batch, the conservation term is the batch mean per step, as
  ``jax.vmap`` gives them. A batch placed on a mesh
  (``parallel/sharding.py``, ``Trainer(mesh=...)``) runs each data row's
  union on its row (row-split over its ``graph`` devices by
  ``parallel/gspmd.py``); each row's sums, counts, residuals and gradient
  go into the row's slot, are all-reduced across processes
  (``torch.distributed``) and summed in row order before the error is
  taken, so every process takes the same step, whichever holds a row.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mswe_gnn_tpu_torch import resolve_device, tree_leaves, tree_map, tree_to
from mswe_gnn_tpu_torch.graph import FloodGraph, concat_graphs, concat_plan, stack_graphs
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.parallel.gspmd import row_model
from mswe_gnn_tpu_torch.parallel.sharding import (MeshBatch, RowBatch, fold, place,
                                                  process_index, unfold_nodes)
from mswe_gnn_tpu_torch.training import loss as loss_lib
from mswe_gnn_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from mswe_gnn_tpu_torch.training.rollout import (bc_step_inflow, bc_window, inject_bc,
                                                 rollout, rollout_row, shift_prediction,
                                                 with_step_forcing)
from mswe_gnn_tpu_torch.utils.metrics import (csi_counts, csi_from_counts, get_csi,
                                             get_rollout_loss, rollout_error,
                                             rollout_error_sums)


@dataclasses.dataclass(frozen=True)
class TrainerOptions:
    """Mirrors the ``trainer_options`` + ``lr_info`` config groups
    (reference config.yaml:60-75; JAX train.py:40-100)."""
    type_loss: str = "RMSE"
    only_where_water: bool = True
    batch_size: int = 4
    conservation: float = 0.0
    velocity_scaler: float = 1.0
    curriculum_epoch: int = 20
    patience: int = 100
    max_epochs: int = 200
    max_rollout_steps: int = 6
    learning_rate: float = 3e-3
    weight_decay: float = 0.0
    gamma: float = 0.7
    step_size: int = 20
    grad_clip: float = 1.0
    seed: int = 42
    remat: bool = False                # checkpoint each step's model call
    spike_rollback_factor: float = 10.0
    spike_window: int = 8
    best_metric: str = "val_CSI_005"
    watch_every: int = 0               # per-module norms every N epochs; 0: off


# ---------------------------------------------------------------- param trees

def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def clone_tree(params):
    return tree_map(lambda p: p.detach().clone(), params)


# ---------------------------------------------------------------- optimizer

class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` of make_optimizer (JAX train.py:114-125), updating the
    parameter tensors in place."""

    def __init__(self, opts: TrainerOptions, steps_per_epoch: int):
        self.learning_rate = opts.learning_rate
        self.gamma = opts.gamma
        self.transition_steps = max(1, opts.step_size * steps_per_epoch)
        self.grad_clip = opts.grad_clip
        self.weight_decay = opts.weight_decay

    def lr(self, count: int) -> float:
        """optax.exponential_decay(..., staircase=True) at update ``count``."""
        return self.learning_rate * self.gamma ** (count // self.transition_steps)

    def init(self, params) -> dict:
        adamw = torch.optim.AdamW(tree_leaves(params), lr=self.learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=self.weight_decay)
        return {"adamw": adamw, "count": 0}

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: ``g / ||g|| * max`` where the global
        norm reaches ``max``, else ``g``; no epsilon, no host sync."""
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_clip
        return [torch.where(keep, g, (g / norm.to(g.dtype)) * self.grad_clip) for g in grads]

    def state_tree(self, state: dict, params) -> dict:
        """The optimizer state as a tree of tensors, for a checkpoint: the
        update count and AdamW's step and moments of every parameter, in
        ``tree_leaves(params)`` order (zeros before the first update, as
        AdamW would create them)."""
        adamw = state["adamw"]
        per = [adamw.state.get(p, {}) for p in tree_leaves(params)]
        return {"count": torch.tensor(state["count"], dtype=torch.int64),
                "step": [st.get("step", torch.tensor(0.0)) for st in per],
                "exp_avg": [st.get("exp_avg", torch.zeros_like(p))
                            for st, p in zip(per, tree_leaves(params))],
                "exp_avg_sq": [st.get("exp_avg_sq", torch.zeros_like(p))
                               for st, p in zip(per, tree_leaves(params))]}

    def load_state_tree(self, state: dict, params, tree: dict) -> None:
        """Puts a ``state_tree`` back into ``state`` for ``params``."""
        adamw = state["adamw"]
        for p, step, m, v in zip(tree_leaves(params), tree["step"], tree["exp_avg"],
                                 tree["exp_avg_sq"]):
            adamw.state[p] = {"step": step, "exp_avg": m, "exp_avg_sq": v}
        state["count"] = int(tree["count"])

    def update(self, grads, state: dict, params) -> None:
        """One update of ``params`` in place from the gradient tree ``grads``."""
        leaves = tree_leaves(params)
        clipped = self.clip(tree_leaves(grads))
        adamw = state["adamw"]
        for group in adamw.param_groups:
            group["lr"] = self.lr(state["count"])
        for p, g in zip(leaves, clipped):
            p.grad = g
        adamw.step()
        for p in leaves:
            p.grad = None
        state["count"] += 1


def make_optimizer(opts: TrainerOptions, steps_per_epoch: int) -> Optimizer:
    """AdamW with epoch-staircase StepLR decay and global-norm clipping."""
    return Optimizer(opts, steps_per_epoch)


# ---------------------------------------------------------------- curriculum

def curriculum_rollout_steps(epoch: int, opts: TrainerOptions) -> int:
    """Pushforward curriculum, 'epoch' mode (reference training/train.py:231-241)."""
    if opts.curriculum_epoch == 0:
        return opts.max_rollout_steps
    return min(epoch // opts.curriculum_epoch + 1, opts.max_rollout_steps)


class CurriculumController:
    """Curriculum modes (JAX train.py:135-178):

    - 'epoch'  : grow every ``curriculum_epoch`` epochs
    - 'loss'   : grow when train loss drops below ``loss_threshold``
    - 'plateau': grow after ``patience`` epochs without loss improvement
    """

    def __init__(self, opts: TrainerOptions, mode: str = "epoch",
                 loss_threshold: float = 0.01, patience: int = 5,
                 min_rel_improvement: float = 1e-3):
        if mode not in ("epoch", "loss", "plateau"):
            raise ValueError(f"unknown curriculum mode {mode!r}")
        self.opts = opts
        self.mode = mode
        self.loss_threshold = loss_threshold
        self.patience = patience
        self.min_rel_improvement = min_rel_improvement
        self.rollout_steps = 1 if opts.curriculum_epoch or mode != "epoch" \
            else opts.max_rollout_steps
        self._best = float("inf")
        self._stall = 0

    def on_epoch_start(self, epoch: int) -> int:
        if self.mode == "epoch":
            self.rollout_steps = curriculum_rollout_steps(epoch, self.opts)
        return self.rollout_steps

    def on_epoch_end(self, train_loss: float) -> None:
        grow = False
        if self.mode == "loss":
            grow = train_loss < self.loss_threshold
        elif self.mode == "plateau":
            if train_loss < self._best * (1 - self.min_rel_improvement):
                self._best = train_loss
                self._stall = 0
            else:
                self._stall += 1
                if self._stall >= self.patience:
                    grow = True
        if grow and self.rollout_steps < self.opts.max_rollout_steps:
            self.rollout_steps += 1
            self._best = float("inf")
            self._stall = 0


# ---------------------------------------------------------------- steps

class _SumOverProcesses(torch.autograd.Function):
    """``all_reduce`` (sum) of a tensor over the processes, whose backward is
    the identity: every process's loss is the same function of the summed
    pieces, so each passes its own pieces the gradient of that loss, and the
    parameter gradients are summed afterwards (``_mesh_loss_and_grads``)."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def _model_call(apply_fn: Callable, params, cfg, remat: bool) -> Callable:
    """``graph -> apply_fn(params, cfg, graph)``, under ``torch.utils.checkpoint``
    (non-reentrant) with ``remat``, as ``jax.checkpoint`` wraps it."""
    if remat:
        return lambda gt: checkpoint(apply_fn, params, cfg, gt, use_reentrant=False)
    return lambda gt: apply_fn(params, cfg, gt)


def _unroll_sums(fwd: Callable, g: FloodGraph, rollout_steps: int, opts: TrainerOptions,
                 multiscale: bool):
    """The pushforward unroll of ``fwd`` on ``g`` -> the loss pieces of every
    step: error sums ``[T, 2]``, counts ``[T]``, conservation residuals
    ``[T, num_graphs]``."""
    x_dyn = g.x_dynamic
    sums, counts, cons = [], [], []
    for t in range(rollout_steps):
        x_dyn = inject_bc(x_dyn, g, bc_window(g, t))
        gt = with_step_forcing(g, t).replace(x_dynamic=x_dyn)
        pred = fwd(gt)
        s, c, k = loss_lib.step_loss_sums(
            pred, g.y[..., t], gt, type_loss=opts.type_loss,
            only_where_water=opts.only_where_water, multiscale=multiscale,
            bc_now=bc_step_inflow(g, t) if opts.conservation != 0.0 else None,
            conservation=opts.conservation)
        x_dyn = shift_prediction(x_dyn, pred, g.previous_t)
        sums.append(s)
        counts.append(c)
        cons.append(k.reshape(-1).expand(g.num_graphs))
    return torch.stack(sums), torch.stack(counts), torch.stack(cons)


def _finish_loss(sums, counts, cons_sum, n_graphs: int, opts: TrainerOptions):
    """Loss pieces summed over a batch -> the loss: the errors from the
    sums and counts, the conservation term the |batch mean| of the signed
    residuals per step, the mean over the steps."""
    err = loss_lib.finalize_error(sums, counts[:, None], opts.type_loss)     # [T, 2]
    scaler = loss_lib.loss_variable_scaler(opts.velocity_scaler, device=err.device)
    per_step = err @ scaler / scaler.sum()                                # [T]
    if opts.conservation != 0.0:
        per_step = per_step + opts.conservation * (cons_sum / n_graphs).abs()
    return per_step.mean()


def _mesh_row_pieces(apply_fn: Callable, params, cfg, batch: MeshBatch, rollout_steps: int,
                     opts: TrainerOptions, multiscale: bool) -> List[tuple]:
    """Each of this process's rows with graphs -> ``(global row, its loss
    pieces [T, 4]``: error sums, count, residual sum``)`` on the parameters'
    device: the row's unroll, on one device the model itself on the row's
    union (the parameters copied there), else the row model of
    parallel/gspmd.py."""
    home = tree_leaves(params)[0].device
    out = []
    for row in batch.rows:
        if row.graph is None:
            continue
        if len(row.devices) == 1:
            p = tree_to(params, row.devices[0])
            g = prepare_graph(p, cfg, row.graph)
            fwd = _model_call(apply_fn, p, cfg, opts.remat)
        else:
            g = row.graph
            model = row_model(row, cfg)
            encoded = model.encode_edges(params)
            if opts.remat:
                def fwd(gt, model=model, encoded=encoded):
                    return checkpoint(model, params, gt, encoded, use_reentrant=False)
            else:
                def fwd(gt, model=model, encoded=encoded):
                    return model(params, gt, encoded)
        s, c, k = _unroll_sums(fwd, g, rollout_steps, opts, multiscale)
        out.append((row.row, torch.cat([s, c[:, None], k.sum(dim=1, keepdim=True)],
                                       dim=1).to(home)))
    return out


def _mesh_loss(pieces: List[tuple], batch: MeshBatch, rollout_steps: int,
               opts: TrainerOptions, home) -> torch.Tensor:
    """The loss from the rows' pieces: each in its global row's slot of an
    ``[n_rows, T, 4]`` tensor (across processes all-reduced: one process
    fills each slot, so the sum is exact), then summed over the rows in
    order, the same adds whichever process holds a row."""
    slots = torch.zeros(batch.n_rows, rollout_steps, 4, device=home)
    if pieces:
        rows = torch.as_tensor([r for r, _ in pieces], device=home)
        slots = slots.index_add(0, rows, torch.stack([p for _, p in pieces]))
    if process_index()[1] > 1:
        slots = _SumOverProcesses.apply(slots)
    total = slots.sum(dim=0)
    return _finish_loss(total[:, :2], total[:, 2], total[:, 3], batch.num_graphs, opts)


def pushforward_loss(apply_fn: Callable, params, cfg, batch, rollout_steps: int,
                     opts: TrainerOptions, multiscale: bool) -> torch.Tensor:
    """Mean over rollout steps of the batch-aggregated step loss (JAX
    train.py:243-304; reference training/train.py:125-145). On a
    ``concat_graphs`` union the errors are concat-then-mean over its graphs
    and the conservation term is the |batch mean| of their signed
    residuals. A ``stack_graphs`` batch (the vmap layout) is folded into
    that union: the sums and counts over the whole batch, the residuals'
    batch mean, as JAX's vmap branch gives them. A ``sharding.MeshBatch``
    runs row by row (``_mesh_loss``)."""
    if isinstance(batch, MeshBatch):
        pieces = _mesh_row_pieces(apply_fn, params, cfg, batch, rollout_steps, opts, multiscale)
        return _mesh_loss(pieces, batch, rollout_steps, opts, tree_leaves(params)[0].device)
    if batch.x_static.dim() == 3:
        batch = fold(batch)
    # hoist loop-invariant tables and encodings out of the unroll
    g = prepare_graph(params, cfg, batch)
    sums, counts, cons = _unroll_sums(_model_call(apply_fn, params, cfg, opts.remat), g,
                                      rollout_steps, opts, multiscale)
    return _finish_loss(sums, counts, cons.sum(dim=1), g.num_graphs, opts)


def loss_and_grads(apply_fn: Callable, params, cfg, batch, rollout_steps: int,
                   opts: TrainerOptions, multiscale: bool):
    """``jax.value_and_grad`` of :func:`pushforward_loss` in the parameters ->
    (loss, gradient tree with the parameters' layout). The parameters are
    not modified. A ``MeshBatch`` takes ``_mesh_loss_and_grads``."""
    work = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(work)
    if isinstance(batch, MeshBatch):
        loss, grads = _mesh_loss_and_grads(apply_fn, work, cfg, batch, rollout_steps, opts,
                                           multiscale)
        return loss, _unflatten(params, grads)
    with torch.enable_grad():
        loss = pushforward_loss(apply_fn, work, cfg, batch, rollout_steps, opts,
                                multiscale)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def _mesh_loss_and_grads(apply_fn: Callable, work, cfg, batch: MeshBatch, rollout_steps: int,
                         opts: TrainerOptions, multiscale: bool):
    """The loss and the gradients of a ``MeshBatch``, the gradients summed
    over the data rows in row order: each row's gradient is taken apart (its
    pieces' share of the loss's gradient), put in its global row's slot of
    an ``[n_rows, P]`` tensor, all-reduced across processes (one process
    fills each slot) and summed over the rows. So every process takes the
    same step, and a run gives the same step whichever processes hold its
    rows (JAX: GSPMD's all-reduce of the replicas' gradients)."""
    leaves = tree_leaves(work)
    home = leaves[0].device
    sizes = [p.numel() for p in leaves]
    per_row = torch.zeros(batch.n_rows, sum(sizes), device=home)
    with torch.enable_grad():
        pieces = _mesh_row_pieces(apply_fn, work, cfg, batch, rollout_steps, opts, multiscale)
        loss = _mesh_loss(pieces, batch, rollout_steps, opts, home)
        if pieces:
            d_pieces = torch.autograd.grad(loss, [p for _, p in pieces], retain_graph=True)
        for (row, p), d in zip(pieces, d_pieces if pieces else ()):
            g = torch.autograd.grad(p, leaves, grad_outputs=d, allow_unused=True)
            per_row[row] = torch.cat([(torch.zeros_like(x) if gx is None else gx).reshape(-1)
                                      for x, gx in zip(leaves, g)])
    if process_index()[1] > 1:
        import torch.distributed as dist

        dist.all_reduce(per_row)
    flat = per_row.sum(dim=0)
    return loss.detach(), [f.view_as(p) for f, p in zip(flat.split(sizes), leaves)]


def _on_device(params, device: torch.device) -> None:
    for p in tree_leaves(params):
        if p.device.type != device.type or (device.index is not None
                                            and p.device.index != device.index):
            raise ValueError(f"parameters on {p.device}, the step runs on {device}")


def train_step(params, opt_state, batch, *, apply_fn, cfg,
               rollout_steps: int, opts: TrainerOptions, multiscale: bool,
               optimizer: Optimizer, device=None):
    """One optimizer step on one graph, a union, a stacked batch or a batch
    placed on a mesh (JAX train.py:307-318) -> (params, opt_state, loss);
    the parameters are updated in place.

    Runs on ``device`` (default: the GPU; raises when there is none), where
    the parameters must already be; a graph is moved there (a placed batch
    stays on its mesh). The graph must arrive without an ``ell_cache``: the
    loss builds the cache itself, with gradients on, every step."""
    device = resolve_device(device)
    _on_device(params, device)
    if not isinstance(batch, MeshBatch):
        batch = batch.to(device)
    if not isinstance(batch, MeshBatch) and batch.ell_cache is not None:
        raise ValueError("train_step builds the graph cache inside the loss, with "
                         "gradients on; pass the graph without ell_cache")
    loss, grads = loss_and_grads(apply_fn, params, cfg, batch, rollout_steps, opts,
                                 multiscale)
    optimizer.update(grads, opt_state, params)
    return params, opt_state, loss


def eval_step(params, batch, *, apply_fn, cfg, steps: int,
              opts: TrainerOptions, multiscale: bool, per_graph: bool = False,
              device=None) -> Dict[str, object]:
    """Full-rollout validation metrics on one graph or a ``concat_graphs``
    union (JAX train.py:321-363; reference training/train.py:157-180) on
    ``device`` (default: the GPU; raises when there is none). Metrics are
    taken on the finest scale of a multiscale graph. A stacked batch or a
    ``MeshBatch`` takes ``_eval_placed``.

    With ``per_graph`` a union also gives per-simulation curves: the tiled
    spec keeps each scale's graphs back to back, so the finest block
    reshapes to ``[B, n0, ...]``: ``per_graph_CSI_005`` and
    ``per_graph_CSI_03`` ``[B]`` and ``per_graph_loss`` ``[B, 2]``, as
    numpy arrays."""
    if isinstance(batch, MeshBatch) or batch.x_static.dim() == 3:
        return _eval_placed(params, batch, apply_fn=apply_fn, cfg=cfg, steps=steps,
                             opts=opts, multiscale=multiscale, device=device)
    device = resolve_device(device)
    batch = batch.to(device)
    preds = rollout(apply_fn, params, cfg, batch, steps, device=device)
    real = batch.y[..., :steps]
    nmask = batch.node_mask
    if multiscale:
        fs = batch.finest_slice()
        preds, real, nmask = preds[fs], real[fs], nmask[fs]
    val_loss = get_rollout_loss(preds, real, nmask, type_loss=opts.type_loss,
                                only_where_water=opts.only_where_water).mean()
    csi005 = get_csi(preds, real, nmask, water_threshold=0.05)
    csi03 = get_csi(preds, real, nmask, water_threshold=0.3)
    out = {"val_loss": float(val_loss), "val_CSI_005": float(csi005.nanmean()),
           "val_CSI_03": float(csi03.nanmean())}
    if per_graph and batch.num_graphs > 1:
        b = batch.num_graphs
        n0 = preds.shape[0] // b
        pg = preds.reshape(b, n0, *preds.shape[1:])
        rg = real.reshape(b, n0, *real.shape[1:])
        mg = nmask.reshape(b, n0)
        host = lambda x: x.cpu().numpy()                                 # noqa: E731
        out["per_graph_CSI_005"] = host(get_csi(pg, rg, mg, water_threshold=0.05)
                                        .nanmean(dim=-1))
        out["per_graph_CSI_03"] = host(get_csi(pg, rg, mg, water_threshold=0.3)
                                       .nanmean(dim=-1))
        out["per_graph_loss"] = host(get_rollout_loss(
            pg, rg, mg, type_loss=opts.type_loss, only_where_water=opts.only_where_water))
    return out


def _per_graph_pieces(preds, real, nmask, opts: TrainerOptions) -> List[torch.Tensor]:
    """``[b, N, 2, T]`` -> the sums behind JAX's vmap metrics: the per-graph
    errors' sum, and each CSI's sum and count of non-NaN (graph, step)
    values."""
    pieces = [get_rollout_loss(preds, real, nmask, type_loss=opts.type_loss,
                               only_where_water=opts.only_where_water).sum()]
    for threshold in (0.05, 0.3):
        csi = get_csi(preds, real, nmask, water_threshold=threshold)
        pieces += [csi.nansum(), (~csi.isnan()).sum()]
    return pieces


def _per_graph_metrics(acc: List[float], n_graphs: int) -> Dict[str, float]:
    def mean(total, n):
        return total / n if n else float("nan")

    return {"val_loss": acc[0] / (2 * n_graphs), "val_CSI_005": mean(acc[1], acc[2]),
            "val_CSI_03": mean(acc[3], acc[4])}


def _pooled_pieces(preds, real, nmask, opts: TrainerOptions) -> List[torch.Tensor]:
    """``[N, 2, T]`` rows of a union -> the sums behind the union's metrics
    (``get_rollout_loss`` and ``get_csi`` of the whole union, JAX's concat
    branch): ``rollout_error_sums`` and each CSI's ``csi_counts``."""
    pieces = list(rollout_error_sums(preds, real, nmask, opts.type_loss, opts.only_where_water))
    for threshold in (0.05, 0.3):
        pieces += csi_counts(preds, real, nmask, threshold)
    return pieces


def _pooled_metrics(acc: torch.Tensor, steps: int, opts: TrainerOptions) -> Dict[str, float]:
    n_err = 2 if opts.only_where_water else 2 * steps
    sums = acc[:n_err].reshape(2, -1) if not opts.only_where_water else acc[:n_err]
    err = rollout_error(sums, acc[n_err], opts.type_loss, opts.only_where_water)
    out = {"val_loss": float(err.mean())}
    counts = acc[n_err + 1:].reshape(2, 3, steps)
    for name, (tp, fp, fn) in zip(("val_CSI_005", "val_CSI_03"), counts):
        out[name] = float(csi_from_counts(tp, fp, fn).nanmean())
    return out


def _eval_placed(params, batch, *, apply_fn, cfg, steps: int, opts: TrainerOptions,
                 multiscale: bool, device=None) -> Dict[str, float]:
    """``eval_step`` of a stacked batch or a ``MeshBatch``: the rollout of
    every row (``rollout_row``; a stacked batch is one row, its graphs'
    union), then the metrics from sums that add over rows and processes
    (all-reduced). A stacked batch or a ``MeshBatch`` of the stacked layout
    gives JAX's vmap metrics (train.py:364-379): ``val_loss`` the mean of
    the per-graph errors, the CSIs the nan-mean of the per-graph, per-step
    values; one of the union layout gives the metrics of the whole union
    (the concat branch, train.py:334-349)."""
    if not isinstance(batch, MeshBatch):
        device = resolve_device(device)
        union = fold(batch.to(device))
        batch = MeshBatch(rows=[RowBatch(row=0, devices=[device],
                                         index=np.arange(union.num_graphs), graph=union)],
                          n_rows=1, num_graphs=union.num_graphs, layout="stacked")
    pooled = batch.layout == "union"
    home = batch.rows[0].devices[0]
    acc = None
    for row in batch.rows:
        if row.graph is None:
            continue
        b, spec = len(row.index), row.graph.spec
        preds = unfold_nodes(rollout_row(apply_fn, params, cfg, row, steps), spec, b)
        real = unfold_nodes(row.graph.y[..., :steps], spec, b)
        nmask = unfold_nodes(row.graph.node_mask, spec, b)
        if multiscale:
            fs = slice(0, spec.node_counts[0] // b)
            preds, real, nmask = preds[:, fs], real[:, fs], nmask[:, fs]
        if pooled:
            flat = lambda x: x.reshape(-1, *x.shape[2:])                       # noqa: E731
            pieces = _pooled_pieces(flat(preds), flat(real), flat(nmask), opts)
        else:
            pieces = _per_graph_pieces(preds, real, nmask, opts)
        row_acc = torch.cat([x.double().reshape(-1) for x in pieces]).to(home)
        acc = row_acc if acc is None else acc + row_acc
    if acc is None:             # this process holds none of the batch's graphs
        size = 5 if not pooled else ((2 if opts.only_where_water else 2 * steps) + 1 + 6 * steps)
        acc = torch.zeros(size, dtype=torch.float64, device=home)
    if process_index()[1] > 1:
        import torch.distributed as dist

        dist.all_reduce(acc)
    if pooled:
        return _pooled_metrics(acc.cpu(), steps, opts)
    return _per_graph_metrics(acc.tolist(), batch.num_graphs)


def find_max_batch_size(apply_fn, cfg, params, graphs, opts: TrainerOptions,
                        multiscale: bool = True, start: int = 1, limit: int = 256,
                        device=None) -> int:
    """The largest batch size, doubling from ``start``, at which one train
    step of a stacked batch of the first graphs runs at
    ``opts.max_rollout_steps`` (JAX train.py:181-200; the reference's
    CurriculumBatchSizeFinder) -> at most ``min(limit, len(graphs))``.

    Only running out of device memory ends the probe; any other error
    raises, as in ``tune_batch_size`` (the JAX package stops at any
    exception)."""
    device = resolve_device(device)
    optimizer = make_optimizer(opts, steps_per_epoch=1)
    best, bs = 0, start
    while bs <= min(limit, len(graphs)):
        try:
            batch = stack_graphs(list(graphs[:bs])).to(device)
            p = clone_tree(tree_to(params, device))
            train_step(p, optimizer.init(p), batch, apply_fn=apply_fn, cfg=cfg,
                       rollout_steps=opts.max_rollout_steps, opts=opts,
                       multiscale=multiscale, optimizer=optimizer, device=device)
        except torch.cuda.OutOfMemoryError:
            break
        best, bs = bs, bs * 2
    return max(best, start)


def tune_batch_size(apply_fn, cfg, params, graphs, opts: TrainerOptions,
                    multiscale: bool = True, candidates=(1, 2, 4, 8, 16), reps: int = 3,
                    device=None):
    """Throughput batch tuner (JAX train.py:203-240): one train step at each
    concat batch size of ``candidates`` (while ``graphs`` has that many) at
    ``opts.max_rollout_steps``, a warm-up and then ``reps`` timed steps ->
    ``(fastest batch, {batch: simulations/s})``.

    Stops at the first batch size that runs out of device memory, the limit
    it probes. Any other error raises: a kernel that fails to build or
    launch must not read as a memory limit (the JAX tuner stops at any
    exception)."""
    device = resolve_device(device)
    optimizer = make_optimizer(opts, steps_per_epoch=1)
    rates: Dict[int, float] = {}
    best, best_rate = candidates[0], 0.0
    for bs in candidates:
        if bs > len(graphs):
            break
        try:
            batch = concat_graphs(list(graphs[:bs])).to(device)
            p = clone_tree(tree_to(params, device))
            st = optimizer.init(p)
            kw = dict(apply_fn=apply_fn, cfg=cfg, rollout_steps=opts.max_rollout_steps,
                      opts=opts, multiscale=multiscale, optimizer=optimizer, device=device)
            _, _, loss = train_step(p, st, batch, **kw)
            float(loss)                                   # warm-up, synchronised
            t0 = time.perf_counter()
            for _ in range(reps):
                _, _, loss = train_step(p, st, batch, **kw)
            float(loss)                                   # synchronise
            rates[bs] = bs * reps / (time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError:
            break
        if rates[bs] > best_rate:
            best, best_rate = bs, rates[bs]
    return best, rates


def watch_norms(params, prev=None, prefix: str = "watch") -> Dict[str, float]:
    """L2 norms of the parameters of every top-level module and, with
    ``prev``, of the net update since ``prev`` (JAX train.py:85-111; the
    reference's wandb ``watch(log='all')``, main.py:95)."""
    groups = sorted(params.items()) if isinstance(params, dict) else [("params", params)]
    prev_groups = dict(sorted(prev.items()) if isinstance(prev, dict)
                       else [("params", prev)]) if prev is not None else None
    sq: Dict[str, float] = {}
    dsq: Dict[str, float] = {}
    for key, tree in groups:
        leaves = tree_leaves(tree)
        prev_leaves = tree_leaves(prev_groups[key]) if prev_groups is not None else None
        for i, leaf in enumerate(leaves):
            sq[key] = sq.get(key, 0.0) + float(leaf.float().square().sum())
            if prev_leaves is not None:
                d = leaf.float() - prev_leaves[i].float()
                dsq[key] = dsq.get(key, 0.0) + float(d.square().sum())
    out = {f"{prefix}/{k}_norm": float(np.sqrt(v)) for k, v in sq.items()}
    out.update({f"{prefix}/{k}_update_norm": float(np.sqrt(v)) for k, v in dsq.items()})
    return out


# ---------------------------------------------------------------- trainer

class Trainer:
    """Curriculum fit, validation, early stopping, spike rollback,
    checkpoints and resume on one device or a mesh (JAX train.py:382-735).

    A private copy of the parameters is moved to ``device`` (default: the
    GPU); the sample lists stay as given, and each is copied to the device
    once, at its first epoch. A batch is a ``concat_graphs`` union of
    ``opts.batch_size`` graphs: where the batch holds more than one graph and
    the samples share a spec, the device holds one ``stack_graphs`` copy of
    the list and a ``DeviceConcatPlan`` assembles each union from it (the
    same union, bit for bit); otherwise it holds the graphs one by one, and a
    batch of one is the resident graph itself. ``best_params`` is a copy
    taken at each improvement of ``opts.best_metric``; with
    ``checkpoint_dir`` it is also saved to ``<checkpoint_dir>/best_val``, the
    whole state is autosaved every ``checkpoint_every`` epochs, and a
    ``heartbeat`` file is touched as training advances.

    The autosave also keeps the shuffle generator's state, so that a resumed
    run draws the batches an uninterrupted one would (the JAX package's
    resume restarts the generator from the seed).

    ``batch_layout="vmap"`` trains on stacked batches (JAX train.py:396-449);
    ``mesh`` (``sharding.make_mesh``) places every batch on it
    (``sharding.place``: the graphs over the data rows, each row's union
    split over its ``graph`` devices), in either layout. The parameters and
    the optimizer state stay on the mesh's first device, and each step copies
    the parameters to the other devices inside the forward, so that autograd
    sums every replica's gradient before the one optimizer step (JAX keeps a
    replica on every device and GSPMD sums the gradients: the same update).
    Across processes the gradients are all-reduced too, the parameters
    are broadcast from process 0 at construction, and ``sync_from_main``
    hands every process process 0's whole state (after a resume). The sample lists stay
    resident on that first device as one stacked copy, from which each
    row's union is gathered (the JAX package turns its device dataset off
    under a mesh, train.py:448-449).
    """

    def __init__(self, apply_fn, cfg, params, opts: TrainerOptions,
                 train_graphs: List[FloodGraph], val_graphs: List[FloodGraph],
                 multiscale: bool = True, log_fn: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
                 curriculum_mode: str = "epoch", batch_layout: str = "concat",
                 mesh=None, device=None):
        if batch_layout not in ("concat", "vmap"):
            raise ValueError(f"batch_layout {batch_layout!r}: 'concat' or 'vmap'")
        self.batch_layout = batch_layout
        self.device = resolve_device(device if mesh is None else mesh[0][0])
        # a stacked batch without a mesh runs as a one-device mesh
        self.mesh = mesh if mesh is not None or batch_layout == "concat" else [[self.device]]
        self.apply_fn = apply_fn
        self.cfg = cfg
        self.opts = opts
        self.multiscale = multiscale
        self.params = clone_tree(tree_to(params, self.device))
        if process_index()[1] > 1:
            import torch.distributed as dist

            for p in tree_leaves(self.params):
                dist.broadcast(p, 0)
        self.train_graphs = list(train_graphs)
        self.val_graphs = list(val_graphs)
        self.steps_per_epoch = max(1, len(train_graphs) // opts.batch_size)
        self.optimizer = make_optimizer(opts, self.steps_per_epoch)
        self.opt_state = self.optimizer.init(self.params)
        self.rng = np.random.default_rng(opts.seed)
        self.log_fn = log_fn or (lambda m: None)
        # called as watch_fn(params, epoch) on watched epochs, after the norms
        # (the CLI sets MetricLogger.watch: wandb histograms)
        self.watch_fn: Optional[Callable] = None
        self.history: List[Dict] = []
        self.best_params = clone_tree(self.params)
        self.best_val_loss = float("inf")
        self.best_val_csi = -float("inf")
        self.best_score: Optional[float] = None
        self.epochs_without_improvement = 0
        self._recent_losses: List[float] = []
        self._last_heartbeat = 0.0
        self.start_epoch = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.curriculum = CurriculumController(opts, mode=curriculum_mode)
        self._resident: Dict[tuple, tuple] = {}

    def _device_copy(self, graphs, batch_size: int):
        """The device copy of a sample list for batches of ``batch_size``,
        made once -> ``(stacked, each)``, one of them None: ``stacked`` is the
        ``stack_graphs`` copy that ``DeviceConcatPlan`` gathers unions from
        (batches of more than one graph over samples that share a spec),
        ``each`` the graphs moved one by one. The cache keeps the list
        itself, so a reused ``id`` cannot hand out another list's copy."""
        key = (id(graphs), batch_size > 1)
        hit = self._resident.get(key)
        if hit is None or hit[0] is not graphs:
            g0 = graphs[0]
            stack = (batch_size > 1 or self.mesh is not None) and all(
                g.spec == g0.spec and g.previous_t == g0.previous_t
                and g.bc_kind == g0.bc_kind and (g.y is None) == (g0.y is None)
                and (g.y is None or g.y.shape == g0.y.shape)
                and (g.forcing is None) == (g0.forcing is None)
                for g in graphs)
            if self.mesh is not None and not stack:
                raise ValueError("batches on a mesh need samples that share one spec")
            hit = ((graphs, stack_graphs(graphs).to(self.device), None) if stack
                   else (graphs, None, [g.to(self.device) for g in graphs]))
            self._resident[key] = hit
        return hit[1], hit[2]

    def _maybe_rollback(self, train_loss: float) -> bool:
        """Divergence guard (JAX train.py:468-507): on a loss spike (>= factor
        x the recent median) or a non-finite loss, restore the best-validation
        parameters in place; the optimizer state is kept on purpose."""
        factor = self.opts.spike_rollback_factor
        triggered = False
        if factor and np.isfinite(train_loss):
            recent = self._recent_losses[-self.opts.spike_window:]
            if len(recent) >= 3:
                ref = float(np.median(recent))
                triggered = train_loss > factor * max(ref, 1e-12)
        elif factor and not np.isfinite(train_loss):
            triggered = True
        if triggered and self.best_score is not None:
            self._copy_into_params(self.best_params)
            self._recent_losses.clear()
            return True
        if np.isfinite(train_loss):
            self._recent_losses.append(train_loss)
        return False

    def _copy_into_params(self, tree) -> None:
        """Parameters set from ``tree`` in place: the optimizer holds these
        very tensors."""
        with torch.no_grad():
            for p, v in zip(tree_leaves(self.params), tree_leaves(tree)):
                p.copy_(v)

    def save(self, path: str, epoch: int) -> None:
        """Checkpoint for crash recovery: parameters, optimizer state, the
        epoch to continue from, the history, the early-stop state and the
        shuffle generator's state."""
        save_checkpoint(path, self.params,
                        opt_state=self.optimizer.state_tree(self.opt_state, self.params),
                        epoch=epoch, history=self.history,
                        extra={"best_val_csi": self.best_val_csi,
                               "best_val_loss": self.best_val_loss,
                               "best_score": self.best_score,
                               "best_metric": self.opts.best_metric,
                               "epochs_without_improvement":
                                   self.epochs_without_improvement,
                               "rng_state": self.rng.bit_generator.state})

    def resume(self, path: str) -> int:
        """Restore the parameters (in place), the optimizer state, the
        history, the early-stop state and, from ``<path>/best_val``, the
        best parameters of a checkpoint; returns the epoch to continue
        from (JAX train.py:528-571)."""
        params, opt_tree, meta = restore_checkpoint(
            path, self.params, self.optimizer.state_tree(self.opt_state, self.params))
        self._copy_into_params(params)
        if opt_tree is not None:
            self.optimizer.load_state_tree(self.opt_state, self.params, opt_tree)
        self.history = meta.get("history", [])
        self.start_epoch = int(meta.get("epoch", 0))
        best_dir = os.path.join(path, "best_val")
        if os.path.exists(os.path.join(best_dir, "meta.json")):
            best, _, bmeta = restore_checkpoint(best_dir, self.params)
            self.best_params = best
            self.best_val_loss = float(bmeta.get("best_val_loss", float("inf")))
            if bmeta.get("best_metric", "val_loss") == self.opts.best_metric:
                bs = bmeta.get("best_score", bmeta.get("best_val_loss"))
                self.best_score = None if bs is None else float(bs)
            else:
                # saved under another selection metric: keep the parameters,
                # let the next validation set the score under this one
                self.best_score = None
            hist_csi = [r.get("val_CSI_005", 0.0) for r in self.history]
            self.best_val_csi = max(hist_csi) if hist_csi else 0.0
        if "best_val_csi" in meta:
            self.best_val_csi = float(meta["best_val_csi"])
        if "best_val_loss" in meta:
            self.best_val_loss = float(meta["best_val_loss"])
        if (meta.get("best_score") is not None
                and meta.get("best_metric") == self.opts.best_metric):
            self.best_score = float(meta["best_score"])
        self.epochs_without_improvement = int(meta.get("epochs_without_improvement", 0))
        if "rng_state" in meta:
            self.rng.bit_generator.state = meta["rng_state"]
        return self.start_epoch

    def sync_from_main(self) -> None:
        """Every process takes process 0's state, so that all of them step
        alike (JAX keeps one replicated state): the parameters, the
        optimizer state, the best parameters, the history, the epoch to
        continue from, the early-stop state and the shuffle generator's.
        After process 0 resumed, the others need not read its autosave."""
        import torch.distributed as dist

        def host(tree):
            return tree_map(lambda x: x.detach().cpu(), tree)

        def like(got, local):
            return _unflatten(local, [g.to(x.device) for g, x in
                                      zip(tree_leaves(got), tree_leaves(local))])

        fields = ("history", "start_epoch", "best_val_loss", "best_val_csi", "best_score",
                  "epochs_without_improvement")
        box = [None]
        if process_index()[0] == 0:
            box = [{"params": host(self.params), "best": host(self.best_params),
                    "opt": host(self.optimizer.state_tree(self.opt_state, self.params)),
                    "rng": self.rng.bit_generator.state,
                    **{k: getattr(self, k) for k in fields}}]
        dist.broadcast_object_list(box, src=0)
        got = box[0]
        self._copy_into_params(got["params"])
        self.best_params = like(got["best"], self.params)
        self.optimizer.load_state_tree(self.opt_state, self.params, like(
            got["opt"], self.optimizer.state_tree(self.opt_state, self.params)))
        self.rng.bit_generator.state = got["rng"]
        for k in fields:
            setattr(self, k, got[k])

    def _batches(self, graphs, batch_size: int, shuffle: bool, drop_tail: bool = True):
        """Unions of ``batch_size`` graphs in the generator's order (JAX
        train.py:583-604), or with a mesh their placement on it (``_place``).
        Training drops a ragged tail; validation (``drop_tail=False``) keeps
        it as a smaller batch."""
        idx = np.arange(len(graphs))
        if shuffle:
            self.rng.shuffle(idx)
        stacked, each = self._device_copy(graphs, batch_size)
        if self.mesh is not None:
            layout = "stacked" if self.batch_layout == "vmap" else "union"

            def build(sel):
                # JAX's _place (train.py:573-581): the batch on the mesh
                return place(stacked, sel, self.mesh, layout=layout)
        elif stacked is not None:
            def build(sel):
                return concat_plan(graphs[0].spec, len(sel))(stacked, np.asarray(sel, np.int64))
        else:
            def build(sel):
                return concat_graphs([each[j] for j in sel])
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            yield build(idx[i:i + batch_size])
        rem = len(idx) % batch_size
        if rem and len(idx) >= batch_size:
            if not drop_tail:
                yield build(idx[len(idx) - rem:])
        elif rem:
            yield build(idx)

    def _heartbeat(self) -> None:
        """Touch ``<checkpoint_dir>/heartbeat``, at most every 10 s: proof
        that the loop advances within an epoch, for a stall watchdog."""
        if not self.checkpoint_dir:
            return
        now = time.time()
        if now - self._last_heartbeat >= 10.0:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            with open(os.path.join(self.checkpoint_dir, "heartbeat"), "w") as f:
                f.write(f"{now}\n")
            self._last_heartbeat = now

    def fit(self, max_epochs: Optional[int] = None, val_every: int = 1):
        opts = self.opts
        max_epochs = max_epochs if max_epochs is not None else opts.max_epochs
        for epoch in range(self.start_epoch, max_epochs):
            rollout_steps = self.curriculum.on_epoch_start(epoch)
            t0 = time.time()
            watching = opts.watch_every > 0 and epoch % opts.watch_every == 0
            prev_params = clone_tree(self.params) if watching else None
            losses = []
            for batch in self._batches(self.train_graphs, opts.batch_size, True):
                self.params, self.opt_state, loss = train_step(
                    self.params, self.opt_state, batch, apply_fn=self.apply_fn,
                    cfg=self.cfg, rollout_steps=rollout_steps, opts=opts,
                    multiscale=self.multiscale, optimizer=self.optimizer,
                    device=self.device)
                losses.append(loss)
                self._heartbeat()
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            self.curriculum.on_epoch_end(train_loss)
            record = {"epoch": epoch, "rollout_steps": rollout_steps,
                      "train_loss": train_loss, "epoch_time": time.time() - t0}
            if watching:
                record.update(watch_norms(self.params, prev_params))
                if self.watch_fn is not None:
                    self.watch_fn(self.params, epoch)
            if self._maybe_rollback(train_loss):
                record["spike_rollback"] = 1
            if self.val_graphs and (epoch % val_every == 0 or epoch == max_epochs - 1):
                metrics = self.validate()
                record.update(metrics)
                self.best_val_loss = min(self.best_val_loss, metrics["val_loss"])
                score = metrics.get(opts.best_metric)
                mode_min = "loss" in opts.best_metric
                improved = (score is not None and np.isfinite(score)
                            and (self.best_score is None
                                 or (score < self.best_score if mode_min
                                     else score > self.best_score)))
                if improved:
                    self.best_score = float(score)
                    self.best_params = clone_tree(self.params)
                    if self.checkpoint_dir:
                        # the global best survives a restart from the autosave
                        save_checkpoint(os.path.join(self.checkpoint_dir, "best_val"),
                                        self.best_params, epoch=epoch,
                                        extra={"best_metric": opts.best_metric,
                                               "best_score": self.best_score,
                                               "best_val_loss": metrics["val_loss"]})
                # early stop on CSI@0.05, as the reference does (main.py:94)
                if metrics["val_CSI_005"] > self.best_val_csi + 1e-12:
                    self.best_val_csi = metrics["val_CSI_005"]
                    self.epochs_without_improvement = 0
                else:
                    self.epochs_without_improvement += val_every
                if self.epochs_without_improvement >= opts.patience:
                    self.history.append(record)
                    self.log_fn(record)
                    break
            self.history.append(record)
            self.log_fn(record)
            if self.checkpoint_dir and (epoch + 1) % self.checkpoint_every == 0:
                self.save(self.checkpoint_dir, epoch + 1)
        return self.history

    def validate(self) -> Dict[str, float]:
        """Metrics over the validation graphs in unions of up to
        ``batch_size``, the ragged tail kept; each union's metrics weighted
        by its graph count, a non-finite value left out of its mean (JAX
        train.py:713-735)."""
        steps = int(self.val_graphs[0].y.shape[-1])
        agg, weights = [], []
        bs = min(self.opts.batch_size, len(self.val_graphs))
        for batch in self._batches(self.val_graphs, bs, False, drop_tail=False):
            agg.append(eval_step(self.params, batch, apply_fn=self.apply_fn, cfg=self.cfg,
                                 steps=steps, opts=self.opts, multiscale=self.multiscale,
                                 device=self.device))
            weights.append(float(batch.num_graphs))
        out = {}
        w = np.asarray(weights, np.float64)
        for k in agg[0]:
            vals = np.asarray([m[k] for m in agg], np.float64)
            ok = np.isfinite(vals)
            out[k] = (float((vals[ok] * w[ok]).sum() / w[ok].sum())
                      if ok.any() else float("nan"))
        return out
