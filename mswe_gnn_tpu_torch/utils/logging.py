"""Experiment metric logging: ``metrics.jsonl``, ``metrics.csv``,
``config.json`` and ``summary.json`` in the run directory (port of
mswe_gnn_tpu/utils/logging.py, local-first, with the same metric names:
train_loss, val_loss, val_CSI_005, val_CSI_03, rollout_steps and the test
metrics).

wandb is not ported: ``use_wandb=True`` raises. ``metrics.jsonl`` is opened
for appending, so a resumed run goes on writing after the lines of the run it
resumes, as the JAX package's does.
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


def _plain(v):
    return float(v) if hasattr(v, "__float__") else v


class MetricLogger:
    def __init__(self, out_dir: str, use_wandb: bool = False,
                 config: Optional[dict] = None):
        if use_wandb:
            raise NotImplementedError("use_wandb=True: wandb logging is not ported; the "
                                      "port writes metrics.jsonl, metrics.csv and "
                                      "summary.json")
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

    def summary(self, metrics: Dict) -> None:
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump({k: _plain(v) for k, v in metrics.items()}, f, indent=2)

    def close(self) -> None:
        self.jsonl.close()
