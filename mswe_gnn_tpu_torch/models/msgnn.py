"""MSGNN — multi-scale flood GNN with a U-Net-style V-cycle over mesh scales
(port of mswe_gnn_tpu/models/msgnn.py).

V-cycle (scales ordered finest=0 ... coarsest=L-1):
  downsweep  i = 0..L-2 : SWEGNN on scale-i edges, save scale-i rows,
                          mean-pool to scale i+1 over transfer edges
  upsweep    i = 0..L-1 : SWEGNN on scale (L-1-i) edges, save those rows,
                          un-pool coarse->fine with an edge-feature-less
                          SWEGNN over transfer edges, add skip connections

The state is carried as per-scale blocks; each processor, pooling and
un-pooling call touches only its scale's [N_scale, F] rows. A scale with a
band plan (``graph.band_plan``, ops/band_hop.py:attach_band_plan) runs its
processor hops through the banded kernel. With ``learned_pooling`` an MLP
over [fine row | coarse row] gives every transfer edge its value, and the
coarse node takes the mean over its transfer edges (a segment mean,
ops/segment.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS
from mswe_gnn_tpu_torch.graph import FloodGraph
from mswe_gnn_tpu_torch.models import base as base_model
from mswe_gnn_tpu_torch.models.activations import apply_activation, init_activation
from mswe_gnn_tpu_torch.models.mlp import apply_linear, apply_mlp, init_mlp
from mswe_gnn_tpu_torch.models.prepare import _msgnn_cache
from mswe_gnn_tpu_torch.models.swegnn import SWEGNNConfig, apply_swegnn_block, init_swegnn
from mswe_gnn_tpu_torch.ops.segment import gather, segment_mean


@dataclasses.dataclass(frozen=True)
class MSGNNConfig:
    """Static hyperparameters (reference models/gnn.py:181-240)."""
    num_node_features: int
    num_edge_features: int
    num_scales: int
    hid_features: int = 32
    K: Union[int, Tuple[int, ...]] = 2
    mlp_layers: int = 2
    mlp_activation: str = "prelu"
    gnn_activation: Optional[str] = "tanh"
    learned_pooling: bool = False
    skip_connections: bool = True
    with_WL: bool = False
    normalize: bool = True
    with_filter_matrix: bool = True
    edge_mlp: bool = True
    with_gradient: bool = True
    previous_t: int = 1
    learned_residuals: object = None
    residuals_base: float = 2.0
    residual_init: str = "exp"
    compute_dtype: str = "float32"
    use_pallas: bool = False         # no effect in the port (models/swegnn.py)
    flat_hop_threshold: int = 0      # no effect in the port (models/swegnn.py)

    @property
    def out_dim(self) -> int:
        return NUM_WATER_VARS

    @property
    def dynamic_node_features(self) -> int:
        return self.previous_t * NUM_WATER_VARS

    @property
    def static_node_features(self) -> int:
        return self.num_node_features - self.dynamic_node_features + int(self.with_WL)

    @property
    def k_schedule(self) -> Tuple[int, ...]:
        """Per-processor K hops: per-scale list mirrored for the upsweep
        (reference models/gnn.py:198-200)."""
        ks = [self.K] * self.num_scales if isinstance(self.K, int) else list(self.K)
        full = ks + ks[::-1][1:]
        assert len(full) == self.num_scales * 2 - 1
        return tuple(full)

    def processor_cfg(self, K: int) -> SWEGNNConfig:
        fe = self.hid_features if self.edge_mlp else self.num_edge_features
        return SWEGNNConfig(
            static_node_features=self.hid_features,
            dynamic_node_features=self.hid_features,
            edge_features=fe, K=K, normalize=self.normalize,
            with_filter_matrix=self.with_filter_matrix,
            with_gradient=self.with_gradient, mlp_layers=self.mlp_layers,
            mlp_activation=self.mlp_activation, mlp_bias=True,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            flat_hop_threshold=self.flat_hop_threshold)

    def intra_cfg(self) -> SWEGNNConfig:
        """Un-pooling GNN: no edge features, K=1, no filter, no gradient
        (reference models/gnn.py:216-220)."""
        return SWEGNNConfig(
            static_node_features=self.hid_features,
            dynamic_node_features=self.hid_features,
            edge_features=0, K=1, normalize=True, with_filter_matrix=False,
            with_gradient=False, mlp_layers=self.mlp_layers,
            mlp_activation=self.mlp_activation, mlp_bias=True,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas)


def init_msgnn(gen: torch.Generator, cfg: MSGNNConfig) -> dict:
    """Parameters with the JAX package's tree layout and init distributions
    (not its numbers: torch.Generator is not jax.random)."""
    h = cfg.hid_features
    params = {}
    if cfg.edge_mlp:
        params["edge_encoder"] = init_mlp(
            gen, cfg.num_edge_features, h, h,
            n_layers=cfg.mlp_layers, bias=True, activation=cfg.mlp_activation)
    params["dynamic_node_encoder"] = init_mlp(
        gen, cfg.dynamic_node_features, h, h,
        n_layers=cfg.mlp_layers, bias=False, activation=cfg.mlp_activation)
    params["static_node_encoder"] = init_mlp(
        gen, cfg.static_node_features, h, h,
        n_layers=cfg.mlp_layers, bias=True, activation=cfg.mlp_activation)
    params["intra_scale_gnn"] = [init_swegnn(gen, cfg.intra_cfg())
                                 for _ in range(cfg.num_scales - 1)]
    if cfg.learned_pooling:
        params["pooling_mlp"] = init_mlp(
            gen, h * 2, h, h,
            n_layers=cfg.mlp_layers, bias=False, activation=cfg.mlp_activation)
    params["gnn_processor"] = [init_swegnn(gen, cfg.processor_cfg(K))
                               for K in cfg.k_schedule]
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


def _pool_block(params, cfg: MSGNNConfig, x_fine, pool_src, pool_mask):
    """Mean-pool fine-block rows onto the coarse block through the slot
    sources ``pool_src [Nc, D]`` (reference models/gnn.py:242-257). Coarse
    nodes that receive nothing become zero."""
    sums = torch.zeros(pool_src.shape[0], x_fine.shape[1], dtype=x_fine.dtype,
                       device=x_fine.device)
    for d in range(pool_src.shape[1]):
        sums = sums + x_fine.index_select(0, pool_src[:, d]) * pool_mask[:, d:d + 1]
    cnt = pool_mask.sum(dim=1)[:, None]
    return torch.where(cnt > 0, sums / cnt.clamp_min(1.0), torch.zeros_like(sums))


def _learned_pool_block(params, cfg: MSGNNConfig, x_fine, coarse_feats, fine_local,
                        coarse_local, intra_mask):
    """Learned pooling (msgnn.py:174-178, :198-199 with the prepared cache):
    the pooling MLP over [fine row | coarse row] of every transfer edge, then
    the mean over each coarse node's real transfer edges. A coarse node that
    receives nothing becomes zero."""
    e = torch.cat([gather(x_fine, fine_local), gather(coarse_feats, coarse_local)], -1)
    vals = apply_mlp(params["pooling_mlp"], e, activation=cfg.mlp_activation)
    return segment_mean(vals, coarse_local, coarse_feats.shape[0], weights=intra_mask)


def apply_msgnn(params: dict, cfg: MSGNNConfig, graph: FloodGraph) -> torch.Tensor:
    """Multiscale forward pass on one graph, or on a ``concat_graphs``
    union, -> [N, 2] predictions.

    Reads the loop-invariant tables from ``graph.ell_cache`` when
    ``prepare_graph`` attached them, and computes them otherwise.
    """
    spec = graph.spec
    L = cfg.num_scales
    if spec.num_scales != L:
        raise ValueError(f"graph has {spec.num_scales} scales, model expects {L}")
    cache = graph.ell_cache if graph.ell_cache is not None else _msgnn_cache(params, cfg, graph)

    x0 = torch.cat([graph.x_static, graph.x_dynamic], dim=-1)
    n_s = cfg.static_node_features - int(cfg.with_WL)
    x_s = x0[:, :n_s]
    x_d = x0[:, n_s:]
    if cfg.with_WL:
        wl = x_s[:, -1] + x_d[:, -cfg.out_dim]
        x_s = torch.cat([x_s, wl[:, None]], dim=-1)
    x_s = apply_mlp(params["static_node_encoder"], x_s, activation=cfg.mlp_activation)
    x_d = apply_mlp(params["dynamic_node_encoder"], x_d, activation=cfg.mlp_activation)

    ks = cfg.k_schedule
    xs_b = [x_s[spec.node_slice(i)] for i in range(L)]
    xd_b = [x_d[spec.node_slice(i)] for i in range(L)]
    zeros_b = [torch.zeros_like(b) for b in xd_b]
    x_down_b = [None] * L
    x_up_b = [None] * L

    def scale_band(i: int):
        """Banded-hop plan of scale i and its widths (msgnn.py:278-282), if
        attached."""
        if graph.band_plan is None or graph.band_meta is None:
            return None, None
        return graph.band_plan["scales"][i], graph.band_meta[i]

    def processor(gnn_id: int, scale: int) -> torch.Tensor:
        tab, tmask, srcs, ea_slots, out_table = cache["scales"][scale]
        band_plan, band_w = scale_band(scale)
        return apply_swegnn_block(
            params["gnn_processor"][gnn_id], cfg.processor_cfg(ks[gnn_id]),
            xs_b[scale], xd_b[scale], xs_b[scale], xd_b[scale], None, None,
            same_block=True, agg_table=tab, agg_mask=tmask, ea_slots=ea_slots,
            src_slot_table=srcs, band_plan=band_plan, band_w=band_w,
            sub_blocks=graph.num_graphs, out_table=out_table)

    # --- downsweep: fine -> coarse, skipping the coarsest scale
    for i in range(L - 1):
        xd_b[i] = processor(i, i)
        x_down_b[i] = xd_b[i]
        if cfg.learned_pooling:
            # the pooling MLP reads the coarse rows after the processor
            # applied H_0 to the full array (msgnn.py:309-314)
            coarse_feats = xd_b[i + 1]
            if cfg.with_filter_matrix:
                coarse_feats = apply_linear(params["gnn_processor"][i]["filters"][0],
                                            coarse_feats)
            isl = spec.intra_edge_slice(i)
            pooled = _learned_pool_block(
                params, cfg, xd_b[i], coarse_feats,
                graph.intra_edge_index[1, isl].long() - spec.node_ptr[i],
                graph.intra_edge_index[0, isl].long() - spec.node_ptr[i + 1],
                graph.intra_edge_mask[isl])
        else:
            psrc, pmask = cache["pools"][i]
            pooled = _pool_block(params, cfg, xd_b[i], psrc, pmask)
        # pooling replaces the state: every non-coarse scale becomes zero
        for j in range(L):
            xd_b[j] = zeros_b[j]
        xd_b[i + 1] = pooled
    x_down_b[L - 1] = xd_b[L - 1]

    # --- upsweep: coarse -> fine
    for i in range(L):
        scale = L - 1 - i
        xd_b[scale] = processor(L - 1 + i, scale)
        x_up_b[scale] = xd_b[scale]
        if i < L - 1:
            lvl = scale - 1   # transfer level between scales lvl (fine) and scale
            utab, umask, usrc, out_table = cache["unpools"][lvl]
            # messages flow coarse -> fine (src = coarse, dst = fine)
            xd_b[lvl] = apply_swegnn_block(
                params["intra_scale_gnn"][i], cfg.intra_cfg(),
                xs_b[scale], xd_b[scale], xs_b[lvl], xd_b[lvl], None, None,
                same_block=False, agg_table=utab,
                agg_mask=umask, src_slot_table=usrc, sub_blocks=graph.num_graphs,
                out_table=out_table)
            if cfg.skip_connections:
                xd_b[lvl] = xd_b[lvl] + x_down_b[lvl]

    h = torch.cat(x_up_b, dim=0)
    if cfg.gnn_activation is not None:
        h = apply_activation(cfg.gnn_activation, params["gnn_act"], h)
    out = apply_mlp(params["node_decoder"], h, activation=cfg.mlp_activation)
    out = out + base_model.add_residual_connection(
        x0, params.get("residual_weights"), cfg.learned_residuals,
        cfg.previous_t, cfg.out_dim)
    out = torch.relu(out)
    out = base_model.mask_small_wd(out, epsilon=0.0001)
    return out * graph.node_mask[:, None]
