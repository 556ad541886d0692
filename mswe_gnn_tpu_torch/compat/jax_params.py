"""Parameter bridge between the JAX package and the port.

The JAX package keeps a model's parameters as a pytree of nested dicts and
lists (key names in mswe_gnn_tpu/models/msgnn.py:123-161 for the MSGNN,
``pooling_mlp`` included, and models/gnn.py:86-135 for the single-scale GNN
of every ``type_gnn``; weights stored ``[in, out]``); the port keeps the same
tree of torch tensors. So the bridge is a leaf-by-leaf conversion, checked
against the port's own tree for the config: every key, list length and
shape must match.

The caller hands in plain numpy leaves (``jax.tree_util.tree_map(np.asarray,
params)``); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from mswe_gnn_tpu_torch import resolve_device
from mswe_gnn_tpu_torch.models.gnn import GNNConfig, init_gnn
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig, init_msgnn


def _convert(tree, like, path: str, device):
    if isinstance(like, torch.Tensor):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: shape {arr.shape} != expected {tuple(like.shape)}")
        return torch.tensor(arr, dtype=like.dtype, device=device)
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: keys {got} != expected {sorted(like)}")
        return {k: _convert(tree[k], like[k], f"{path}.{k}", device) for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected a sequence of {len(like)}")
        return [_convert(t, l, f"{path}[{i}]", device)
                for i, (t, l) in enumerate(zip(tree, like))]
    raise TypeError(f"{path}: unexpected node {type(like).__name__}")


def load_jax_params(tree: dict, cfg: MSGNNConfig | GNNConfig, device=None) -> dict:
    """JAX ``init_msgnn``- or ``init_gnn``-layout tree of numpy arrays (as
    ``cfg`` is an MSGNN or a GNN config) -> the port's parameter tree on
    ``device`` (default: the GPU; raises when there is none)."""
    init = init_gnn if isinstance(cfg, GNNConfig) else init_msgnn
    like = init(torch.Generator().manual_seed(0), cfg)
    return _convert(tree, like, "params", resolve_device(device))


def to_numpy_tree(params):
    """The port's parameter tree, or a gradient tree of the same layout
    (``training.train.loss_and_grads``) -> the same tree of float32 numpy
    arrays, in the layout of the JAX package's parameters and ``jax.grad``."""
    if isinstance(params, torch.Tensor):
        return params.detach().to("cpu", torch.float32).numpy()
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_numpy_tree(v) for v in params]
    raise TypeError(f"unexpected parameter node {type(params).__name__}")
