"""Model registry (port of mswe_gnn_tpu/models/registry.py, MSGNN only)."""
from __future__ import annotations

import torch

from mswe_gnn_tpu_torch import resolve_device, tree_leaves, tree_to
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig, apply_msgnn, init_msgnn


def get_model(name: str):
    """Return (config_cls, init_fn, apply_fn) for a model family."""
    if name == "MSGNN":
        return MSGNNConfig, init_msgnn, apply_msgnn
    if name == "GNN":
        raise NotImplementedError("model_type='GNN' needs models/gnn.py, not ported yet")
    raise ValueError(f"unknown model {name!r}; options: 'GNN', 'MSGNN'")


def build_model(model_cfg: dict, num_node_features: int, num_edge_features: int,
                num_scales: int, previous_t: int, seed: int | None = None,
                device=None):
    """Build (cfg, params, apply) from a config.yaml-style ``models`` dict,
    with parameters initialised from ``seed`` (default 42) on ``device``
    (default: the GPU; raises when there is none)."""
    device = resolve_device(device)
    cfg_dict = dict(model_cfg)
    name = cfg_dict.pop("model_type", "MSGNN")
    seed = cfg_dict.pop("seed", seed if seed is not None else 42)
    cfg_cls, init_fn, apply_fn = get_model(name)
    for key in ("n_GNN_layers", "type_GNN", "dropout"):
        cfg_dict.pop(key, None)
    k = cfg_dict.pop("K", None)
    common = dict(num_node_features=num_node_features,
                  num_edge_features=num_edge_features,
                  previous_t=previous_t, num_scales=num_scales)
    if k is not None:
        common["K"] = tuple(k) if isinstance(k, (list, tuple)) else k
    cfg = cfg_cls(**common, **cfg_dict)
    params = init_fn(torch.Generator().manual_seed(int(seed)), cfg)
    return cfg, tree_to(params, device), apply_fn


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
