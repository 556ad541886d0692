"""The numbers that decide ``correct``: how far what the program produced
lies from the plain reference, each a share of the reference's own scale.

Rollouts: ``rollout_rel_rmse``, the root of the summed squared gap over
every real node, variable and step over the root of the reference's summed
squares (the largest gap of a rollout swings from seed to seed as much as
the control's and separates nothing). Training, by the worst leaf or step: ``loss_gap`` (the three
losses), ``grad_gap`` (the norm of each leaf of the first clipped gradient)
and ``update_gap`` (the norm of each leaf's change over the three steps),
each the gap between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of ``update_gap``. Where a bf16 cell's
worst leaf swings as far as its control reads, two steadier numbers
separate them: ``first_loss_gap`` (the first step's loss alone: the
parameters are still the same on both sides) and ``grad_dir`` (the norm of
the first gradient's difference over the whole tree, over the reference's
norm).

A cell compares the numbers its limits file (``limits/<cell>.json``) lists,
each against its own limit.
"""
from __future__ import annotations

import json
import os
import statistics

import torch

QUIET_LEAF = 1e-3


def rollout_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = got.double() - want.double()
    return {"rollout_rel_rmse": float(diff.norm() / want.double().norm().clamp_min(1e-30))}


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]} if readings else {}


def _leaf_gaps(got, want, keep=None) -> float:
    n_got = [float(g.double().norm()) for g in got]
    n_want = [float(w.double().norm()) for w in want]
    idx = [i for i in range(len(n_want)) if keep is None or keep[i]]
    med = statistics.median(n_want[i] for i in idx)
    return max(abs(n_got[i] - n_want[i]) / max(n_want[i], med, 1e-30) for i in idx)


def train_gaps(losses, ref_losses, grads, ref_grads, change, ref_change) -> dict:
    g_norms = [float(g.double().norm()) for g in ref_grads]
    med = statistics.median(g_norms)
    moved = [n >= QUIET_LEAF * med for n in g_norms]
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(losses, ref_losses)),
            "first_loss_gap": abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-30),
            "grad_gap": _leaf_gaps(grads, ref_grads),
            "grad_dir": _rel_diff(grads, ref_grads),
            "update_gap": _leaf_gaps(change, ref_change, moved)}


def _rel_diff(got, want) -> float:
    """The norm of the difference of the flattened trees over the norm of
    the reference's."""
    num = sum(float((g.double() - w.double()).pow(2).sum()) for g, w in zip(got, want))
    den = sum(float(w.double().pow(2).sum()) for w in want)
    return (num / max(den, 1e-300)) ** 0.5


def limits(workload: str, root: str = os.path.dirname(os.path.abspath(__file__))) -> dict:
    """``{number: limit}`` of a cell, from ``limits/<workload>.json``."""
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def judge(readings: dict, lims: dict) -> tuple:
    """-> (correct, ``{number: {"value", "limit"}}``) over the numbers the
    limits name; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, lim in lims.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": lim}
        ok = ok and value == value and value <= lim
    return ok, out
