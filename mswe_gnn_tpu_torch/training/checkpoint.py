"""Checkpoints: save, restore and the fine-tune warm start (port of
mswe_gnn_tpu/training/checkpoint.py; reference: Lightning ModelCheckpoint and
the best-checkpoint reload, main.py:90-122; fine-tune, main.py:103-104).

The port's own format, one directory a checkpoint:

- ``params.npz`` (and ``opt_state.npz``): every tensor of the tree as a numpy
  array under its key path (``edge_encoder/layers/0/w``); a bfloat16 tensor
  is stored as its 16-bit pattern under ``<path>:bfloat16``;
- ``meta.json``: the epoch, the history and the caller's extra keys, as the
  JAX package writes it.

No pickle: ``np.load`` runs with ``allow_pickle=False``. Restoring takes the
tree's layout, dtypes and device from a template and puts every leaf back bit
for bit. Reading a JAX (orbax) checkpoint is not this module's work: the
tests convert JAX trees through ``compat/jax_params.py``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BF16 = ":bfloat16"


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
    elif tree is not None:
        raise TypeError(f"{prefix}: a checkpoint holds tensors, got {type(tree).__name__}")
    return out


def _unflatten(template, prefix: str, arrays):
    if isinstance(template, torch.Tensor):
        if template.dtype == torch.bfloat16:
            bits = torch.from_numpy(arrays[prefix + _BF16].copy())
            value = bits.view(torch.bfloat16)
        else:
            value = torch.from_numpy(arrays[prefix].copy())
        if tuple(value.shape) != tuple(template.shape) or value.dtype != template.dtype:
            raise ValueError(f"{prefix}: checkpoint holds {tuple(value.shape)} {value.dtype}, "
                             f"expected {tuple(template.shape)} {template.dtype}")
        return value.to(template.device)
    if isinstance(template, dict):
        return {k: _unflatten(v, f"{prefix}/{k}" if prefix else str(k), arrays)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, f"{prefix}/{i}" if prefix else str(i), arrays)
                              for i, v in enumerate(template))
    return template


def _save_tree(path: str, tree) -> None:
    arrays = {}
    for key, t in _flatten(tree, "", {}).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key + _BF16] = t.view(torch.int16).numpy()
        else:
            arrays[key] = t.numpy()
    np.savez(path, **arrays)


def _load_tree(path: str, template):
    with np.load(path, allow_pickle=False) as data:
        return _unflatten(template, "", data)


def save_checkpoint(path: str, params, opt_state=None, epoch: int = 0,
                    history: Optional[list] = None, extra: Optional[Dict] = None) -> None:
    """Write a checkpoint directory: the parameter tree, the optimizer state
    tree when given (``training.train.Optimizer.state_tree``), and
    ``meta.json`` with the epoch, the history and ``extra``."""
    os.makedirs(path, exist_ok=True)
    _save_tree(os.path.join(path, "params.npz"), params)
    if opt_state is not None:
        _save_tree(os.path.join(path, "opt_state.npz"), opt_state)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"epoch": epoch, "history": history or [], **(extra or {})}, f)


def restore_checkpoint(path: str, params_template, opt_state_template=None
                       ) -> Tuple[object, Optional[object], Dict]:
    """-> (params, opt_state, meta). The templates give the trees' layout,
    dtypes and device; ``opt_state`` is None without a template or without a
    saved optimizer state."""
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    params = _load_tree(os.path.join(path, "params.npz"), params_template)
    opt_state = None
    opt_path = os.path.join(path, "opt_state.npz")
    if opt_state_template is not None and os.path.exists(opt_path):
        opt_state = _load_tree(opt_path, opt_state_template)
    return params, opt_state, meta


def restore_params_only(path: str, params_template):
    """Fine-tune warm start: the weights only, for a fresh optimizer."""
    params, _, _ = restore_checkpoint(path, params_template)
    return params
