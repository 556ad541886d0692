"""Experiment metric logging: ``metrics.jsonl``, ``metrics.csv``,
``config.json`` and ``summary.json`` in the run directory, and wandb where a
run asks for it (port of mswe_gnn_tpu/utils/logging.py, local-first, with the
same metric names: train_loss, val_loss, val_CSI_005, val_CSI_03,
rollout_steps and the test metrics).

wandb is imported inside the constructor. A live wandb run is attached to
when ``use_wandb`` is set or when the run belongs to a sweep (the agent
opens it before training starts); with ``use_wandb`` and no live run the
logger opens its own and finishes it in ``close``. ``use_wandb=True`` where
wandb cannot be imported raises an ImportError that names it (the JAX
package goes on without wandb there); without ``use_wandb`` a missing wandb
changes nothing. ``metrics.jsonl`` is opened for appending, so a resumed run
goes on writing after the lines of the run it resumes, as the JAX package's
does.
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import torch


def _plain(v):
    return float(v) if hasattr(v, "__float__") else v


def tree_paths(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of every tensor of a parameter tree of dicts and lists,
    in ``jax.tree_util.tree_flatten_with_path``'s order: dict keys sorted,
    list entries by index; a key prints as itself, an index as ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (f"[{i}]",))
    elif tree is not None:
        yield prefix, tree


def _live_wandb(use_wandb: bool):
    """The wandb module, or None where it cannot be imported and
    ``use_wandb`` is not set."""
    try:
        import wandb
    except ImportError as e:
        if use_wandb:
            raise ImportError("use_wandb=True needs wandb, which is not installed") from e
        return None
    return wandb


class MetricLogger:
    def __init__(self, out_dir: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None, config: Optional[dict] = None):
        self._wandb = None
        self._owns_wandb = False
        wandb = _live_wandb(use_wandb)
        if wandb is not None:
            if wandb.run is not None and (use_wandb or getattr(wandb.run, "sweep_id", None)):
                # a sweep agent's trial run (opened before training starts),
                # or a run the caller opened and asked for: attach, and leave
                # finishing it to its opener. An unrelated live run is left alone.
                self._wandb = wandb.run
            elif use_wandb:
                self._wandb = wandb.init(project=wandb_project or "mswe-gnn-tpu",
                                         config=config)
                self._owns_wandb = True
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.csv_path = os.path.join(out_dir, "metrics.csv")
        self._csv_fields = None
        if config is not None:
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict) -> None:
        rec = {"time": time.time(), **{k: _plain(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self._csv_fields is None:
            self._csv_fields = list(rec)
            with open(self.csv_path, "w", newline="") as f:
                csv.DictWriter(f, self._csv_fields).writeheader()
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(f, self._csv_fields, extrasaction="ignore").writerow(rec)
        # echo to stdout so a live `tail -f` of the run log shows progress
        print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                          for k, v in metrics.items()}), flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics)

    def watch(self, params, step: int) -> None:
        """Histograms of every parameter leaf to the attached wandb run (the
        reference's ``wandb_logger.watch(model, log='all')``, main.py:95),
        named ``watch/<path>`` as the JAX package names them; nothing
        without a run (local-first runs get the Trainer's ``watch_norms``)."""
        if self._wandb is None:
            return
        import wandb

        hists = {"epoch": step}
        for path, leaf in tree_paths(params):
            hists["watch/" + "/".join(path)] = wandb.Histogram(
                leaf.detach().float().cpu().numpy().ravel())
        # no step=: wandb's own step runs ahead of the epoch (log() is called
        # once an epoch with several metrics), and a step behind it is dropped
        self._wandb.log(hists)

    def summary(self, metrics: Dict) -> None:
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump({k: _plain(v) for k, v in metrics.items()}, f, indent=2)
        if self._wandb is not None:
            for k, v in metrics.items():
                self._wandb.summary[k] = v

    def close(self) -> None:
        self.jsonl.close()
        if self._wandb is not None and self._owns_wandb:
            self._wandb.finish()
