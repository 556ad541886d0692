"""YAML experiment configuration (reference-schema compatible); a copy of
mswe_gnn_tpu/config.py, which the port does not import.

Parses the same config groups as the reference (reference config.yaml:1-81,
utils/load.py:5-16): ``dataset_parameters``, ``scalers``,
``selected_node_features``, ``selected_edge_features``,
``temporal_dataset_parameters``, ``models``, ``trainer_options``, ``lr_info``,
optional ``temporal_test_dataset_parameters`` and ``saved_model`` — so a
reference experiment file ports over unchanged. Extra (new) group:
``synthetic_data`` for the built-in data generator.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import yaml


def read_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def fix_dotted_keys(config: Dict[str, Any]) -> Dict[str, Any]:
    """Re-nest sweep-style dotted keys, e.g. 'models.K': 4 -> models: {K: 4}
    (reference utils/miscellaneous.py:230-243)."""
    out = dict(config)
    for k in list(out):
        if "." in k:
            top, inner = k.split(".", 1)
            out.setdefault(top, {})
            out[top][inner] = out.pop(k)
    return out


DEFAULTS: Dict[str, Any] = {
    "dataset_parameters": {
        "temporal_res": 120,
        "train_size": 80,
        "val_prcnt": 0.25,
        "seed": 381,
    },
    "scalers": {
        "DEM_scaler": None, "slope_scaler": None, "area_scaler": "standard",
        "edge_length_scaler": "standard", "edge_slope_scaler": None,
        "WD_scaler": None, "V_scaler": None, "forcing_scaler": "standard",
    },
    "selected_node_features": {
        "slopes": False, "slope": False, "area": True, "DEM": True,
    },
    "selected_edge_features": {
        "edge_length": True, "edge_relative_distance": False, "edge_slope": False,
    },
    "temporal_dataset_parameters": {
        "rollout_steps": 6, "previous_t": 3, "time_start": 0, "time_stop": -1,
    },
    "models": {
        "model_type": "MSGNN", "hid_features": 64, "mlp_layers": 3, "seed": 666,
        "learned_residuals": True, "mlp_activation": "prelu",
        "gnn_activation": "tanh", "edge_mlp": True, "normalize": True,
        "with_filter_matrix": True, "with_gradient": True, "with_WL": True,
        "K": 4, "learned_pooling": False, "skip_connections": True,
    },
    "trainer_options": {
        "type_loss": "RMSE", "only_where_water": True, "batch_size": 4,
        "conservation": 0, "velocity_scaler": 7, "curriculum_epoch": 20,
        "patience": 100, "max_epochs": 200,
    },
    "lr_info": {
        "learning_rate": 0.003, "weight_decay": 0, "gamma": 0.7, "step_size": 20,
    },
    "synthetic_data": {
        "n_sims": 12, "nx": 32, "ny": 32, "dx": 100.0, "num_scales": 3,
        "total_hours": 48.0, "n_bc": 2, "substeps": 20, "seed": 0,
        "pad_multiple": 64, "storm_forcing": False,
    },
}


def with_defaults(config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Deep-merge a user config over the reference defaults."""
    cfg = {k: dict(v) for k, v in DEFAULTS.items()}
    for group, vals in (config or {}).items():
        if isinstance(vals, dict):
            cfg.setdefault(group, {}).update(vals)
        else:
            cfg[group] = vals
    return cfg


def temporal_test_parameters(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Test-time windowing params fall back to the training ones minus
    rollout_steps (reference utils/dataset.py:547-557)."""
    if "temporal_test_dataset_parameters" in cfg:
        return dict(cfg["temporal_test_dataset_parameters"])
    t = dict(cfg["temporal_dataset_parameters"])
    t.pop("rollout_steps", None)
    return t
