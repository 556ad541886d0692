"""Training: the pushforward rollout loss, AdamW with a staircase StepLR and
global-norm clipping, the curriculum, validation and early stopping (port of
mswe_gnn_tpu/training/train.py for single-graph batches).

- ``pushforward_loss`` unrolls the model over ``rollout_steps`` steps in a
  Python loop, with gradients through the whole unroll (no detach between
  steps), as the JAX package's ``lax.scan`` does. With ``opts.remat`` each
  step's model call runs under ``torch.utils.checkpoint`` (non-reentrant),
  as ``jax.checkpoint`` wraps ``apply_fn`` there.
- The loop-invariant graph cache (models/prepare.py) is built inside the
  loss, with gradients on, so that the edge encoder is trained.
- The optimizer is ``optax.chain(clip_by_global_norm, adamw)`` written out:
  the clip is optax's (no epsilon added to the norm, unlike
  ``torch.nn.utils.clip_grad_norm_``), AdamW is ``torch.optim.AdamW`` with
  the options' weight decay (torch's default 0.01 is not the JAX
  package's), and the learning rate is the epoch staircase
  ``gamma ** (step // (step_size * steps_per_epoch))``.

Not ported yet, and raising: checkpoints and resume, the heartbeat, watch
norms, the batch tuners, vmap-stacked batches and ``batch_size > 1``
(concat batching).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mswe_gnn_tpu_torch import resolve_device, tree_leaves, tree_map, tree_to
from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.training import loss as loss_lib
from mswe_gnn_tpu_torch.training.rollout import (bc_step_inflow, bc_window, inject_bc,
                                                 rollout, shift_prediction,
                                                 with_step_forcing)
from mswe_gnn_tpu_torch.utils.metrics import get_csi, get_rollout_loss


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
    watch_every: int = 0               # not ported: must stay 0


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

def pushforward_loss(apply_fn: Callable, params, cfg, batch: FloodGraph,
                     rollout_steps: int, opts: TrainerOptions,
                     multiscale: bool) -> torch.Tensor:
    """Mean over rollout steps of the step loss (JAX train.py:243-304,
    single-graph branch; reference training/train.py:125-145)."""
    if batch.x_static.dim() != 2:
        raise NotImplementedError("vmap-stacked batches are not ported")
    if opts.remat:
        def fwd(p, gt):
            return checkpoint(apply_fn, p, cfg, gt, use_reentrant=False)
    else:
        def fwd(p, gt):
            return apply_fn(p, cfg, gt)
    # hoist loop-invariant tables and encodings out of the unroll
    g = prepare_graph(params, cfg, batch)
    x_dyn = g.x_dynamic
    sums, counts, cons = [], [], []
    for t in range(rollout_steps):
        x_dyn = inject_bc(x_dyn, g, bc_window(g, t))
        gt = with_step_forcing(g, t).replace(x_dynamic=x_dyn)
        pred = fwd(params, gt)
        s, c, k = loss_lib.step_loss_sums(
            pred, g.y[..., t], gt, type_loss=opts.type_loss,
            only_where_water=opts.only_where_water, multiscale=multiscale,
            bc_now=bc_step_inflow(g, t) if opts.conservation != 0.0 else None,
            conservation=opts.conservation)
        x_dyn = shift_prediction(x_dyn, pred, g.previous_t)
        sums.append(s)
        counts.append(c)
        cons.append(k)
    err = loss_lib.finalize_error(torch.stack(sums), torch.stack(counts)[:, None],
                                  opts.type_loss)                       # [T, 2]
    scaler = loss_lib.loss_variable_scaler(opts.velocity_scaler, device=err.device)
    per_step = err @ scaler / scaler.sum()                                # [T]
    if opts.conservation != 0.0:
        per_step = per_step + opts.conservation * torch.stack(cons).abs()
    return per_step.mean()


def loss_and_grads(apply_fn: Callable, params, cfg, batch: FloodGraph,
                   rollout_steps: int, opts: TrainerOptions, multiscale: bool):
    """``jax.value_and_grad`` of :func:`pushforward_loss` in the parameters ->
    (loss, gradient tree with the parameters' layout). The parameters are
    not modified."""
    work = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(work)
    with torch.enable_grad():
        loss = pushforward_loss(apply_fn, work, cfg, batch, rollout_steps, opts,
                                multiscale)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def _on_device(params, device: torch.device) -> None:
    for p in tree_leaves(params):
        if p.device.type != device.type or (device.index is not None
                                            and p.device.index != device.index):
            raise ValueError(f"parameters on {p.device}, the step runs on {device}")


def train_step(params, opt_state, batch: FloodGraph, *, apply_fn, cfg,
               rollout_steps: int, opts: TrainerOptions, multiscale: bool,
               optimizer: Optimizer, device=None):
    """One optimizer step on one graph (JAX train.py:307-318) -> (params,
    opt_state, loss); the parameters are updated in place.

    Runs on ``device`` (default: the GPU; raises when there is none), where
    the parameters must already be; the graph is moved there. The graph
    must arrive without an ``ell_cache``: the loss builds the cache itself,
    with gradients on, every step."""
    device = resolve_device(device)
    _on_device(params, device)
    batch = batch.to(device)
    if batch.ell_cache is not None:
        raise ValueError("train_step builds the graph cache inside the loss, with "
                         "gradients on; pass the graph without ell_cache")
    loss, grads = loss_and_grads(apply_fn, params, cfg, batch, rollout_steps, opts,
                                 multiscale)
    optimizer.update(grads, opt_state, params)
    return params, opt_state, loss


def eval_step(params, batch: FloodGraph, *, apply_fn, cfg, steps: int,
              opts: TrainerOptions, multiscale: bool, device=None) -> Dict[str, float]:
    """Full-rollout validation metrics on one graph (JAX train.py:321-363,
    single-graph branch; reference training/train.py:157-180) on ``device``
    (default: the GPU; raises when there is none). Metrics are taken on the
    finest scale of a multiscale graph."""
    if batch.x_static.dim() != 2:
        raise NotImplementedError("vmap-stacked batches are not ported")
    device = resolve_device(device)
    batch = batch.to(device)
    preds = rollout(apply_fn, params, cfg, batch, steps, device=device)
    real = batch.y[..., :steps]
    nmask = batch.node_mask
    if multiscale:
        fs = batch.spec.node_slice(0)
        preds, real, nmask = preds[fs], real[fs], nmask[fs]
    val_loss = get_rollout_loss(preds, real, nmask, type_loss=opts.type_loss,
                                only_where_water=opts.only_where_water).mean()
    csi005 = get_csi(preds, real, nmask, water_threshold=0.05)
    csi03 = get_csi(preds, real, nmask, water_threshold=0.3)
    return {"val_loss": float(val_loss), "val_CSI_005": float(csi005.nanmean()),
            "val_CSI_03": float(csi03.nanmean())}


def find_max_batch_size(*args, **kwargs):
    raise NotImplementedError("the batch tuners need concat batching, not ported yet")


def tune_batch_size(*args, **kwargs):
    raise NotImplementedError("the batch tuners need concat batching, not ported yet")


def watch_norms(*args, **kwargs):
    raise NotImplementedError("watch norms are not ported yet")


# ---------------------------------------------------------------- trainer

class Trainer:
    """Curriculum fit, validation, early stopping and spike rollback on one
    device (JAX train.py:382-712), one graph a batch.

    The graphs and a private copy of the parameters are moved to ``device``
    (default: the GPU) once. ``best_params`` is a copy taken at each
    improvement of ``opts.best_metric``."""

    def __init__(self, apply_fn, cfg, params, opts: TrainerOptions,
                 train_graphs: List[FloodGraph], val_graphs: List[FloodGraph],
                 multiscale: bool = True, log_fn: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None,
                 curriculum_mode: str = "epoch", device=None):
        if opts.batch_size != 1:
            raise NotImplementedError("batch_size > 1 needs concat batching, "
                                      "not ported yet")
        if checkpoint_dir is not None:
            raise NotImplementedError("checkpoints, resume and the heartbeat are "
                                      "not ported yet")
        if opts.watch_every:
            raise NotImplementedError("watch norms are not ported yet")
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.cfg = cfg
        self.opts = opts
        self.multiscale = multiscale
        self.params = clone_tree(tree_to(params, self.device))
        self.train_graphs = [g.to(self.device) for g in train_graphs]
        self.val_graphs = [g.to(self.device) for g in val_graphs]
        self.steps_per_epoch = max(1, len(train_graphs) // opts.batch_size)
        self.optimizer = make_optimizer(opts, self.steps_per_epoch)
        self.opt_state = self.optimizer.init(self.params)
        self.rng = np.random.default_rng(opts.seed)
        self.log_fn = log_fn or (lambda m: None)
        self.history: List[Dict] = []
        self.best_params = clone_tree(self.params)
        self.best_val_loss = float("inf")
        self.best_val_csi = -float("inf")
        self.best_score: Optional[float] = None
        self.epochs_without_improvement = 0
        self._recent_losses: List[float] = []
        self.curriculum = CurriculumController(opts, mode=curriculum_mode)

    def save(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet")

    def resume(self, *args, **kwargs):
        raise NotImplementedError("resume is not ported yet")

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
            with torch.no_grad():
                for p, b in zip(tree_leaves(self.params), tree_leaves(self.best_params)):
                    p.copy_(b)
            self._recent_losses.clear()
            return True
        if np.isfinite(train_loss):
            self._recent_losses.append(train_loss)
        return False

    def _batches(self, graphs, shuffle: bool):
        idx = np.arange(len(graphs))
        if shuffle:
            self.rng.shuffle(idx)
        for i in idx:
            yield graphs[i]

    def fit(self, max_epochs: Optional[int] = None, val_every: int = 1):
        opts = self.opts
        max_epochs = max_epochs if max_epochs is not None else opts.max_epochs
        for epoch in range(max_epochs):
            rollout_steps = self.curriculum.on_epoch_start(epoch)
            t0 = time.time()
            losses = []
            for batch in self._batches(self.train_graphs, True):
                self.params, self.opt_state, loss = train_step(
                    self.params, self.opt_state, batch, apply_fn=self.apply_fn,
                    cfg=self.cfg, rollout_steps=rollout_steps, opts=opts,
                    multiscale=self.multiscale, optimizer=self.optimizer,
                    device=self.device)
                losses.append(loss)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            self.curriculum.on_epoch_end(train_loss)
            record = {"epoch": epoch, "rollout_steps": rollout_steps,
                      "train_loss": train_loss, "epoch_time": time.time() - t0}
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
        return self.history

    def validate(self) -> Dict[str, float]:
        """Mean of the per-graph metrics over the validation graphs (each
        graph one vote); a non-finite value is left out of its mean."""
        steps = int(self.val_graphs[0].y.shape[-1])
        agg = [eval_step(self.params, g, apply_fn=self.apply_fn, cfg=self.cfg,
                         steps=steps, opts=self.opts, multiscale=self.multiscale,
                         device=self.device)
               for g in self._batches(self.val_graphs, False)]
        out = {}
        for k in agg[0]:
            vals = np.asarray([m[k] for m in agg], np.float64)
            ok = np.isfinite(vals)
            out[k] = float(vals[ok].mean()) if ok.any() else float("nan")
        return out

