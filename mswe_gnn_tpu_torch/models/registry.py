"""Model registry (port of mswe_gnn_tpu/models/registry.py): the MSGNN, the
single-scale GNN and MeshGraphNets (``MGN``, the port's own: the JAX package
has no counterpart)."""
from __future__ import annotations

import torch

from mswe_gnn_tpu_torch import resolve_device, tree_leaves, tree_to
from mswe_gnn_tpu_torch.models.gnn import GNNConfig, apply_gnn, init_gnn
from mswe_gnn_tpu_torch.models.meshgraphnet import MGNConfig, apply_mgn, init_mgn
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig, apply_msgnn, init_msgnn


def get_model(name: str):
    """Return (config_cls, init_fn, apply_fn) for a model family."""
    if name == "GNN":
        return GNNConfig, init_gnn, apply_gnn
    if name == "MSGNN":
        return MSGNNConfig, init_msgnn, apply_msgnn
    if name == "MGN":
        return MGNConfig, init_mgn, apply_mgn
    raise ValueError(f"unknown model {name!r}; options: 'GNN', 'MSGNN', 'MGN'")


# the SWE-GNN keys that config.with_defaults adds to every ``models`` group,
# which MeshGraphNets has no use for
_SWEGNN_KEYS = ("K", "type_GNN", "gnn_activation", "edge_mlp", "normalize",
                "with_filter_matrix", "with_gradient", "learned_pooling",
                "skip_connections", "dropout")


def build_model(model_cfg: dict, num_node_features: int, num_edge_features: int,
                num_scales: int, previous_t: int, seed: int | None = None,
                device=None):
    """Build (cfg, params, apply) from a config.yaml-style ``models`` dict,
    with the JAX package's key handling (registry.py:37-51), with parameters
    initialised from ``seed`` (default 42) on ``device`` (default: the GPU;
    raises when there is none)."""
    device = resolve_device(device)
    cfg_dict = dict(model_cfg)
    name = cfg_dict.pop("model_type", "MSGNN")
    seed = cfg_dict.pop("seed", seed if seed is not None else 42)
    cfg_cls, init_fn, apply_fn = get_model(name)
    common = dict(num_node_features=num_node_features,
                  num_edge_features=num_edge_features, previous_t=previous_t)
    if name == "MGN":
        for key in _SWEGNN_KEYS:
            cfg_dict.pop(key, None)
        if "n_GNN_layers" in cfg_dict:
            common["n_gnn_layers"] = cfg_dict.pop("n_GNN_layers")
    elif name == "MSGNN":
        common["num_scales"] = num_scales
        for key in ("n_GNN_layers", "type_GNN", "dropout"):
            cfg_dict.pop(key, None)
    else:
        # config.with_defaults always adds these MSGNN keys
        cfg_dict.pop("learned_pooling", None)
        cfg_dict.pop("skip_connections", None)
        if "n_GNN_layers" in cfg_dict:
            common["n_gnn_layers"] = cfg_dict.pop("n_GNN_layers")
        if "type_GNN" in cfg_dict:
            common["type_gnn"] = cfg_dict.pop("type_GNN")
    k = cfg_dict.pop("K", None)
    if k is not None:
        common["K"] = tuple(k) if isinstance(k, (list, tuple)) else k
    cfg = cfg_cls(**common, **cfg_dict)
    params = init_fn(torch.Generator().manual_seed(int(seed)), cfg)
    return cfg, tree_to(params, device), apply_fn


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
