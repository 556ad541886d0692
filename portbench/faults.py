"""Faults planted underneath a run, to show that the comparison catches
them (``tests/test_portbench_faults.py`` on the CPU) and to read how far
each lies from the reference on the card (``calibrate.py --faults``).

- ``unchanged``: a step that returns its state unchanged (a rollout step
  that predicts its last input frame; a train step whose parameters come
  back as they went in);
- ``half``: half of the batch left out (a rollout's second half of every
  scale block zeroed; a train step on a union of the first half of its
  graphs, its loss the mean over them);
- ``altered``: an answer altered where it is produced (every prediction of
  the model scaled by 1.05; the loss a train step returns scaled by 1.05).

The cells run on one card, so no fault leaves out an exchange between cards.
"""
from __future__ import annotations

import contextlib

import torch

from mswe_gnn_tpu_torch.graph import concat_graphs

from portbench import modes, system

ALTERED = 1.05
FAULTS = {"rollout": ("unchanged", "half", "altered"),
          "train": ("unchanged", "half", "altered")}


def _wrap_model(fn):
    build = system.build

    def patched(*args, **kwargs):
        cfg, params, apply_fn = build(*args, **kwargs)
        return cfg, params, lambda p, c, g: fn(apply_fn, p, c, g)
    return patched


def _zero_half(out, layout):
    spec, _ = layout
    out = out.clone()
    for s in range(spec.num_scales):
        lo, n = spec.node_ptr[s], spec.node_counts[s]
        out[lo + n // 2: lo + n] = 0
    return out


def _rollout_half():
    rollout = modes.rollout

    def patched(apply_fn, params, cfg, graph, steps, device=None):
        return _zero_half(rollout(apply_fn, params, cfg, graph, steps, device=device),
                          (graph.spec, graph.num_graphs))
    return patched


def _train_unchanged():
    step = modes.train_step

    def patched(params, *args, **kwargs):
        before = [p.detach().clone() for p in modes.tree_leaves(params)]
        out = step(params, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(modes.tree_leaves(params), before):
                p.copy_(b)
        return out
    return patched


def _train_altered():
    step = modes.train_step

    def patched(*args, **kwargs):
        params, state, loss = step(*args, **kwargs)
        return params, state, loss * ALTERED
    return patched


def _half_unions(samples, batch):
    half = max(1, batch // 2)
    return [concat_graphs(samples[i:i + half]) for i in range(0, len(samples), batch)]


def _patches(fault: str, mode: str) -> list:
    """(owner, attribute, replacement) for ``fault`` under ``mode``."""
    if mode == "rollout":
        return {"unchanged": [(system, "build", _wrap_model(
                    lambda f, p, c, g: g.x_dynamic[:, -2:] * g.node_mask[:, None]))],
                "half": [(modes, "rollout", _rollout_half())],
                "altered": [(system, "build", _wrap_model(
                    lambda f, p, c, g: f(p, c, g) * ALTERED))]}[fault]
    return {"unchanged": [(modes, "train_step", _train_unchanged())],
            "half": [(system, "unions", _half_unions)],
            "altered": [(modes, "train_step", _train_altered())]}[fault]


@contextlib.contextmanager
def planted(fault, mode: str = None):
    """Plant ``fault`` (None: none) for the cell's ``mode`` while the block
    runs."""
    if fault is None:
        yield
        return
    patches = _patches(fault, mode)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, new in patches:
            setattr(owner, name, new)
        yield
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)
