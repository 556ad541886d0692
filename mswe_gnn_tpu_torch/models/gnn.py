"""Single-scale flood GNN: encoder -> K-hop processor -> decoder (port of
mswe_gnn_tpu/models/gnn.py; reference models/gnn.py:13-152).

``type_gnn`` picks the processor layer: ``SWEGNN`` (the SWE-GNN, whose hops
run the hand-written hop kernels: the ELL hop, or the banded hop where the
graph carries a band plan of scale 0) or a baseline, ``GNN_L`` (Cheb),
``GNN_A`` (TAG) and ``GAT`` (models/convs.py, on the segment reductions of
ops/segment.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS
from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models import base as base_model
from mswe_gnn_tpu_torch.models.activations import apply_activation, init_activation
from mswe_gnn_tpu_torch.models.convs import (
    ChebConfig, GATConfig, TAGConfig, apply_cheb, apply_gat, apply_tag, init_cheb, init_gat,
    init_tag,
)
from mswe_gnn_tpu_torch.models.mlp import apply_mlp, init_mlp
from mswe_gnn_tpu_torch.models.prepare import _gnn_cache
from mswe_gnn_tpu_torch.models.swegnn import SWEGNNConfig, apply_swegnn, init_swegnn

TYPES = ("SWEGNN", "GNN_L", "GNN_A", "GAT")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Static hyperparameters (reference models/gnn.py:39-83 plus the
    base-model options of models/models.py:21-48)."""
    num_node_features: int          # static + dynamic input columns of x
    num_edge_features: int
    hid_features: int = 32
    K: int = 2
    n_gnn_layers: int = 2
    type_gnn: str = "SWEGNN"        # 'SWEGNN' | 'GNN_L' | 'GNN_A' | 'GAT'
    mlp_layers: int = 1
    mlp_activation: str = "prelu"
    gnn_activation: Optional[str] = "prelu"
    dropout: float = 0.0            # no effect: JAX's forward is deterministic too
    with_WL: bool = True
    normalize: bool = True
    with_filter_matrix: bool = True
    edge_mlp: bool = True
    with_gradient: bool = True
    previous_t: int = 1
    learned_residuals: object = None   # True | 'all' | False | None
    residuals_base: float = 2.0
    residual_init: str = "exp"
    compute_dtype: str = "float32"
    use_pallas: bool = False         # no effect in the port (models/swegnn.py)

    @property
    def out_dim(self) -> int:
        return NUM_WATER_VARS

    @property
    def dynamic_node_features(self) -> int:
        return self.previous_t * self.out_dim

    @property
    def static_node_features(self) -> int:
        # reference models/gnn.py:53: the water level adds one static column
        return self.num_node_features - self.dynamic_node_features + int(self.with_WL)

    def swegnn_cfg(self) -> SWEGNNConfig:
        fe = self.hid_features if self.edge_mlp else self.num_edge_features
        return SWEGNNConfig(
            static_node_features=self.hid_features,
            dynamic_node_features=self.hid_features,
            edge_features=fe, K=self.K, normalize=self.normalize,
            with_filter_matrix=self.with_filter_matrix,
            with_gradient=self.with_gradient, mlp_layers=self.mlp_layers,
            mlp_activation=self.mlp_activation, mlp_bias=True,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas)


def init_gnn(gen: torch.Generator, cfg: GNNConfig) -> dict:
    """Parameters with the JAX package's tree layout and init distributions
    (not its numbers: torch.Generator is not jax.random)."""
    if cfg.type_gnn not in TYPES:
        raise ValueError(f"unknown type_gnn {cfg.type_gnn!r}; options: {TYPES}")
    h = cfg.hid_features
    params = {}
    if cfg.type_gnn == "SWEGNN":
        if cfg.edge_mlp:
            params["edge_encoder"] = init_mlp(
                gen, cfg.num_edge_features, h, h,
                n_layers=cfg.mlp_layers, bias=True, activation=cfg.mlp_activation)
        params["dynamic_node_encoder"] = init_mlp(
            gen, cfg.dynamic_node_features, h, h,
            n_layers=cfg.mlp_layers, bias=False, activation=cfg.mlp_activation)
        # the static encoder has 2 layers in the reference (models/gnn.py:66-68)
        params["static_node_encoder"] = init_mlp(
            gen, cfg.static_node_features, h, h,
            n_layers=2, bias=True, activation=cfg.mlp_activation)
    else:
        params["node_encoder"] = init_mlp(
            gen, cfg.num_node_features + int(cfg.with_WL), h, h,
            n_layers=cfg.mlp_layers, bias=True, activation=cfg.mlp_activation)
    init_layer = {"SWEGNN": lambda: init_swegnn(gen, cfg.swegnn_cfg()),
                  "GNN_L": lambda: init_cheb(gen, ChebConfig(h, h, cfg.K)),
                  "GNN_A": lambda: init_tag(gen, TAGConfig(h, h, cfg.K)),
                  "GAT": lambda: init_gat(gen, GATConfig(h, h))}[cfg.type_gnn]
    params["gnn_processor"] = [init_layer() for _ in range(cfg.n_gnn_layers)]
    params["gnn_act"] = init_activation(cfg.gnn_activation)
    params["node_decoder"] = init_mlp(
        gen, h, cfg.out_dim, h,
        n_layers=cfg.mlp_layers, bias=False, activation=cfg.mlp_activation)
    rw = base_model.init_residual_weights(
        gen, cfg.learned_residuals, cfg.previous_t, cfg.residuals_base,
        cfg.residual_init, cfg.out_dim)
    if rw is not None:
        params["residual_weights"] = rw
    return params


def apply_gnn(params: dict, cfg: GNNConfig, graph: FloodGraph) -> torch.Tensor:
    """Forward pass on one graph, or on a ``concat_graphs`` union, -> [N, 2]
    predictions of (h, |q|) at the next step.

    The SWEGNN layers read the loop-invariant tables from
    ``graph.ell_cache`` when ``prepare_graph`` attached them, and compute
    them otherwise (the same numbers). A band plan of scale 0
    (``graph.band_plan``) sends their hops through the banded kernel.
    """
    x0 = torch.cat([graph.x_static, graph.x_dynamic], dim=-1)
    src, dst = graph.edge_index[0], graph.edge_index[1]
    emask = graph.edge_mask
    h_feat = cfg.hid_features

    # the static / dynamic split, with the water level as a static column
    # (reference models/gnn.py:112-125)
    n_s = cfg.static_node_features - int(cfg.with_WL)
    x_s, x_d = x0[:, :n_s], x0[:, n_s:]
    if cfg.with_WL:
        wl = x_s[:, -1] + x_d[:, -cfg.out_dim]
        x_s = torch.cat([x_s, wl[:, None]], dim=-1)

    if cfg.type_gnn == "SWEGNN":
        cache = graph.ell_cache if graph.ell_cache is not None else _gnn_cache(params, cfg,
                                                                                graph)
        tab, tmask, srcs, ea_slots, out_table = cache["scales"][0]
        band_plan = graph.band_plan["scales"][0] if graph.band_plan is not None else None
        band_w = graph.band_meta[0] if graph.band_meta is not None else None
        x_s = apply_mlp(params["static_node_encoder"], x_s, activation=cfg.mlp_activation)
        x_d = apply_mlp(params["dynamic_node_encoder"], x_d, activation=cfg.mlp_activation)
        h = x_d
    else:
        h = apply_mlp(params["node_encoder"], torch.cat([x_s, x_d], -1),
                      activation=cfg.mlp_activation)

    for conv in params["gnn_processor"]:
        if cfg.type_gnn == "SWEGNN":
            h = apply_swegnn(conv, cfg.swegnn_cfg(), x_s, x_d, src, dst, edge_mask=emask,
                             agg_table=tab, agg_mask=tmask, ea_slots=ea_slots,
                             src_slot_table=srcs, band_plan=band_plan, band_w=band_w,
                             sub_blocks=graph.num_graphs, out_table=out_table)
        elif cfg.type_gnn == "GNN_L":
            h = apply_cheb(conv, ChebConfig(h_feat, h_feat, cfg.K), h, src, dst, emask)
        elif cfg.type_gnn == "GNN_A":
            h = apply_tag(conv, TAGConfig(h_feat, h_feat, cfg.K), h, src, dst, emask)
        else:
            h = apply_gat(conv, GATConfig(h_feat, h_feat), h, src, dst, emask)
        if cfg.gnn_activation is not None:
            h = apply_activation(cfg.gnn_activation, params["gnn_act"], h)
        x_d = h

    out = apply_mlp(params["node_decoder"], h, activation=cfg.mlp_activation)
    out = out + base_model.add_residual_connection(
        x0, params.get("residual_weights"), cfg.learned_residuals,
        cfg.previous_t, cfg.out_dim)
    out = torch.relu(out)
    out = base_model.mask_small_wd(out, epsilon=0.0001)
    # padded nodes are zero, so losses and metrics never see them
    return out * graph.node_mask[:, None]
