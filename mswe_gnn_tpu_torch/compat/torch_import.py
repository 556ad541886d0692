"""Import reference PyTorch-Lightning checkpoints (.h5) into the port's
parameter tree (port of mswe_gnn_tpu/compat/torch_import.py).

The reference ships trained mSWE-GNN checkpoints
(reference results/Pareto_front/models/K{2..5}_F{16..64}.h5); this module maps
their ``state_dict`` onto the JAX package's parameter layout in numpy, and
``compat.jax_params.load_jax_params`` turns that into the port's tree of
tensors on the device the caller names, checked against the port's own tree
for the config, so golden parity tests and fine-tuning (reference
config_finetune.yaml recipe) can start from the published weights.

Key mapping (reference models/gnn.py + models/models.py:121-146):
- ``<mlp>.{2i}.weight/bias``  -> params[mlp]["layers"][i]  (transposed to [in, out])
- ``<mlp>.{2i+1}.weight``     -> params[mlp]["acts"][i]["alpha"]  (PReLU)
- ``gnn_processor.{p}.filter_matrix.{k}.weight`` -> params["gnn_processor"][p]["filters"][k]
- ``residual_weights``        -> params["residual_weights"]
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _mlp_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    """Rebuild one make_mlp params dict (numpy leaves) from
    `prefix.{idx}.weight/bias` keys."""
    idxs = sorted({int(m.group(1)) for k in sd
                   for m in [re.match(re.escape(prefix) + r"\.(\d+)\.", k)] if m})
    layers, acts, norms = [], [], []
    for i in idxs:
        w = sd.get(f"{prefix}.{i}.weight")
        b = sd.get(f"{prefix}.{i}.bias")
        if w is None:
            continue
        if w.ndim == 2:  # Linear [out, in] -> [in, out]
            lin = {"w": np.asarray(w.T)}
            if b is not None:
                lin["b"] = np.asarray(b)
            layers.append(lin)
            acts.append({})  # filled if a PReLU follows
            norms.append({})
        elif w.ndim == 1 and w.shape[0] == 1:  # PReLU alpha
            acts[-1] = {"alpha": np.asarray(w)}
    return {"layers": layers, "acts": acts, "norms": norms}


def infer_msgnn_shape(sd: Dict[str, np.ndarray]) -> dict:
    """Infer (num_scales, hid, K, mlp_layers, feature sizes) from key shapes."""
    hid = sd["model.dynamic_node_encoder.0.weight"].shape[0]
    dyn_in = sd["model.dynamic_node_encoder.0.weight"].shape[1]
    static_in = sd["model.static_node_encoder.0.weight"].shape[1]
    edge_in = sd["model.edge_encoder.0.weight"].shape[1] \
        if "model.edge_encoder.0.weight" in sd else None
    intra_ids = {int(m.group(1)) for k in sd
                 for m in [re.match(r"model\.intra_scale_gnn\.(\d+)\.", k)] if m}
    num_scales = len(intra_ids) + 1
    proc_ids = {int(m.group(1)) for k in sd
                for m in [re.match(r"model\.gnn_processor\.(\d+)\.", k)] if m}
    assert len(proc_ids) == 2 * num_scales - 1, (num_scales, len(proc_ids))
    filt_ids = {int(m.group(1)) for k in sd
                for m in [re.match(r"model\.gnn_processor\.0\.filter_matrix\.(\d+)\.", k)] if m}
    K = (len(filt_ids) - 1) if filt_ids else None
    mlp_ids = {int(m.group(1)) for k in sd
               for m in [re.match(r"model\.dynamic_node_encoder\.(\d+)\.weight$", k)] if m}
    # linears sit at even indices when an activation follows each one
    mlp_layers = len([i for i in mlp_ids
                      if sd[f"model.dynamic_node_encoder.{i}.weight"].ndim == 2])
    previous_t = dyn_in // 2
    rw = sd.get("model.residual_weights")
    return dict(hid_features=hid, num_scales=num_scales, K=K,
                mlp_layers=mlp_layers, previous_t=previous_t,
                dynamic_in=dyn_in, static_in=static_in, edge_in=edge_in,
                learned_residuals=(True if rw is not None and rw.shape[1] == 1
                                   else ("all" if rw is not None else None)))


def msgnn_config_from_checkpoint(path_or_sd, with_WL: bool = True,
                                 gnn_activation: str = "tanh",
                                 **overrides) -> Tuple[MSGNNConfig, Dict[str, np.ndarray]]:
    """Build the MSGNNConfig matching a checkpoint's shapes.

    ``with_WL``/``gnn_activation`` are not inferable from shapes (WL adds one
    static input column; tanh has no params) — pass the training config's
    values (reference config.yaml:49-54 defaults: with_WL=True, tanh).
    """
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    shape = infer_msgnn_shape(sd)
    num_node_features = (shape["static_in"] - int(with_WL)) + shape["dynamic_in"]
    cfg = MSGNNConfig(
        num_node_features=num_node_features,
        num_edge_features=shape["edge_in"] if shape["edge_in"] else 1,
        num_scales=shape["num_scales"],
        hid_features=shape["hid_features"],
        K=shape["K"],
        mlp_layers=shape["mlp_layers"],
        with_WL=with_WL,
        gnn_activation=gnn_activation,
        previous_t=shape["previous_t"],
        learned_residuals=shape["learned_residuals"],
        edge_mlp=shape["edge_in"] is not None,
        **overrides,
    )
    return cfg, sd


def jax_layout_params(sd: Dict[str, np.ndarray], cfg: MSGNNConfig) -> dict:
    """Map a reference MSGNN state dict onto the JAX package's parameter
    layout, with numpy leaves."""
    params: dict = {}
    if cfg.edge_mlp:
        params["edge_encoder"] = _mlp_from_sd(sd, "model.edge_encoder")
    params["dynamic_node_encoder"] = _mlp_from_sd(sd, "model.dynamic_node_encoder")
    params["static_node_encoder"] = _mlp_from_sd(sd, "model.static_node_encoder")

    params["intra_scale_gnn"] = [
        {"edge_mlp": _mlp_from_sd(sd, f"model.intra_scale_gnn.{i}.edge_mlp")}
        for i in range(cfg.num_scales - 1)
    ]
    procs = []
    for p in range(2 * cfg.num_scales - 1):
        entry = {"edge_mlp": _mlp_from_sd(sd, f"model.gnn_processor.{p}.edge_mlp")}
        if cfg.with_filter_matrix:
            ks = sorted({int(m.group(1)) for k in sd for m in [re.match(
                rf"model\.gnn_processor\.{p}\.filter_matrix\.(\d+)\.weight$", k)] if m})
            entry["filters"] = [
                {"w": np.asarray(sd[f"model.gnn_processor.{p}.filter_matrix.{k}.weight"].T)}
                for k in ks]
        procs.append(entry)
    params["gnn_processor"] = procs
    params["gnn_act"] = {}
    if cfg.gnn_activation == "prelu":
        a = sd.get("model.gnn_activation.weight")
        params["gnn_act"] = {"alpha": np.asarray(a)} if a is not None else {}
    params["node_decoder"] = _mlp_from_sd(sd, "model.node_decoder")
    if "model.residual_weights" in sd:
        params["residual_weights"] = np.asarray(sd["model.residual_weights"])
    if cfg.learned_pooling and "model.pooling_mlp.0.weight" in sd:
        params["pooling_mlp"] = _mlp_from_sd(sd, "model.pooling_mlp")
    return params


def import_msgnn_params(sd: Dict[str, np.ndarray], cfg: MSGNNConfig,
                        device=None) -> dict:
    """Map a reference MSGNN state dict onto the port's parameter tree on
    ``device`` (default: the GPU; raises where there is none)."""
    return load_jax_params(jax_layout_params(sd, cfg), cfg, device=device)


def load_msgnn_checkpoint(path: str, device=None,
                          **cfg_kwargs) -> Tuple[MSGNNConfig, dict]:
    """One-call loader: checkpoint path -> (cfg, params on ``device``)."""
    cfg, sd = msgnn_config_from_checkpoint(path, **cfg_kwargs)
    return cfg, import_msgnn_params(sd, cfg, device=device)
