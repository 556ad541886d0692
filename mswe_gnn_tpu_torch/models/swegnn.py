"""SWEGNN — the shallow-water-equations message-passing layer (port of the
ELL and band paths of mswe_gnn_tpu/models/swegnn.py).

    out_0 = H_0 x_d                         (filter matrix, optional)
    for k in 1..K:
        s_ij  = MLP(x_s_i, x_s_j, x_d_i, x_d_j, e_ij) / ||.||   (once per layer)
        agg_i = sum_j act_ij * (out_i - out_j) * s_ij          (the hop kernel)
        out  += H_k agg

The flux is computed once per layer in ELL slot layout ``[Nd, D, F]``, and
every hop of every layer runs a hand-written kernel: the banded hop of
``ops/band_hop.py`` on a same-block scale that carries a band plan
(swegnn.py:349-369), else the ELL hop of ``ops/hop.py`` (the processor hops
of unplanned scales and the un-pooling hop, ``same_block=False``). Both are
differentiable through their backward kernels.

A concat-batched union (``sub_blocks > 1``) runs its blocks whole through
the same kernels. Not ported yet, and raising if reached: the edge-major
segment-sum path (no ``agg_table``).
``SWEGNNConfig.use_pallas`` and ``flat_hop_threshold`` are accepted so that
the JAX package's config dicts build, and have no effect here: the JAX
package's slot loop, flat path and Pallas hop all compute the same hop,
which the port always runs through its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mswe_gnn_tpu_torch.models.activations import apply_activation
from mswe_gnn_tpu_torch.models.mlp import apply_linear, apply_mlp, init_linear, init_mlp, matmul
from mswe_gnn_tpu_torch.ops.band_hop import band_hop
from mswe_gnn_tpu_torch.ops.hop import hop


@dataclasses.dataclass(frozen=True)
class SWEGNNConfig:
    """Static hyperparameters of one SWEGNN layer
    (mirrors reference models/gnn.py:363-384)."""
    static_node_features: int
    dynamic_node_features: int
    edge_features: int
    K: int = 2
    normalize: bool = True
    with_filter_matrix: bool = True
    with_gradient: bool = True
    upwind_mode: bool = False
    mlp_layers: int = 2
    mlp_activation: str = "prelu"
    mlp_bias: bool = True
    compute_dtype: str = "float32"   # 'bfloat16': bf16 matmul operands, hop state and flux
    use_pallas: bool = False         # no effect in the port (see module docstring)
    flat_hop_threshold: int = 0      # no effect in the port (see module docstring)

    @property
    def edge_input_size(self) -> int:
        return self.edge_features + 2 * self.static_node_features + 2 * self.dynamic_node_features

    @property
    def edge_output_size(self) -> int:
        return self.dynamic_node_features

    @property
    def edge_hidden_size(self) -> int:
        return self.edge_output_size * 2


def init_swegnn(gen: torch.Generator, cfg: SWEGNNConfig) -> dict:
    params = {
        "edge_mlp": init_mlp(gen, cfg.edge_input_size, cfg.edge_output_size,
                             hidden_size=cfg.edge_hidden_size,
                             n_layers=cfg.mlp_layers, bias=cfg.mlp_bias,
                             activation=cfg.mlp_activation)
    }
    if cfg.with_filter_matrix:
        params["filters"] = [
            init_linear(gen, cfg.dynamic_node_features, cfg.dynamic_node_features,
                        bias=False)
            for _ in range(cfg.K + 1)]
    return params


def _compute_dtype(cfg: SWEGNNConfig) -> Optional[str]:
    return None if cfg.compute_dtype == "float32" else cfg.compute_dtype


def _edge_flux_slots(params: dict, cfg: SWEGNNConfig, x_s_src, x_d_src,
                     x_s_dst, x_d_dst, src_tab: torch.Tensor,
                     ea_tab: Optional[torch.Tensor],
                     slot_mask: torch.Tensor) -> torch.Tensor:
    """The flux s_ij in ELL slot layout -> ``[Nd, D, F]`` (float32).

    Slot d of dst node i is the edge (src_tab[i, d] -> i). The first linear
    over [x_s_i | x_s_j | x_d_i | x_d_j | e_ij] is split into per-node src
    and dst projections, so the dst side needs no gather. Masked slots alias
    edge 0 (a real edge, so the value is finite) and are zeroed by
    ``slot_mask [Nd, D]``.
    """
    mlp = params["edge_mlp"]
    lin0 = mlp["layers"][0]
    W = lin0["w"]
    s, d, fe = cfg.static_node_features, cfg.dynamic_node_features, cfg.edge_features
    W_ss, W_sd = W[:s], W[s: 2 * s]
    W_ds, W_dd = W[2 * s: 2 * s + d], W[2 * s + d: 2 * s + 2 * d]
    cd = _compute_dtype(cfg)
    proj_src = matmul(x_s_src, W_ss, cd) + matmul(x_d_src, W_ds, cd)   # [Ns, H]
    proj_dst = matmul(x_s_dst, W_sd, cd) + matmul(x_d_dst, W_dd, cd)   # [Nd, H]
    n_dst, deg = src_tab.shape
    h = (proj_src.index_select(0, src_tab.reshape(-1)).view(n_dst, deg, -1)
         + proj_dst[:, None, :])
    if fe > 0:
        h = h + matmul(ea_tab, W[2 * s + 2 * d:], cd)
    if "b" in lin0:
        h = h + lin0["b"]
    h = apply_activation(cfg.mlp_activation, mlp["acts"][0], h)
    rest = {"layers": mlp["layers"][1:], "acts": mlp["acts"][1:],
            "norms": mlp["norms"][1:]}
    s_tab = apply_mlp(rest, h, activation=cfg.mlp_activation, compute_dtype=cd)
    if cfg.normalize:
        norm = torch.linalg.vector_norm(s_tab, dim=-1, keepdim=True)
        pos = norm > 0
        s_tab = torch.where(pos, s_tab / torch.where(pos, norm, torch.ones_like(norm)),
                            torch.zeros_like(s_tab))
    return s_tab * slot_mask[:, :, None]


def apply_swegnn_block(
    params: dict,
    cfg: SWEGNNConfig,
    x_s_src: torch.Tensor,
    x_d_src: torch.Tensor,
    x_s_dst: torch.Tensor,
    x_d_dst: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_attr: Optional[torch.Tensor] = None,
    edge_mask: Optional[torch.Tensor] = None,
    same_block: bool = True,
    dst_sorted: bool = True,
    agg_table: Optional[torch.Tensor] = None,
    agg_mask: Optional[torch.Tensor] = None,
    ea_slots: Optional[torch.Tensor] = None,
    src_slot_table: Optional[torch.Tensor] = None,
    band_plan: Optional[dict] = None,
    band_w=None,
    sub_blocks: int = 1,
    out_table=None,
) -> torch.Tensor:
    """One SWEGNN layer on block-local tensors -> updated dst block [Nd, F].

    ``src``/``dst`` are edge endpoints local to the src/dst blocks. With
    ``same_block`` the src block IS the dst block (the multiscale processor)
    and neighbour reads see the evolving hop state; otherwise (un-pooling)
    the sources stay constant across hops.

    ``agg_table``/``agg_mask`` [Nd, D] are the ELL slots (edge ids local to
    the edge block). ``src_slot_table [Nd, D]`` int32 (slot source rows),
    ``ea_slots [Nd, D, Fe]`` (slot edge features) and ``out_table`` (the
    out-slot table the hop backward kernels read) are the loop-invariant
    tables of models/prepare.py; they are derived here when not given.
    ``band_plan`` (``{"win", "idx_rel"}``) with ``band_w = (ws, we)`` sends
    the hops of a same-block layer through the banded kernel.

    ``sub_blocks`` > 1 declares the block a concat union of that many
    equal-sized, mutually disconnected graphs (``graph.concat_graphs``);
    the port hops over the union block whole (see the note at the hop loop).
    """
    if agg_table is None:
        raise NotImplementedError("the edge-major segment-sum path is not ported; "
                                  "pass the ELL agg_table")
    cd = _compute_dtype(cfg)

    if cfg.with_filter_matrix:
        out = apply_linear(params["filters"][0], x_d_dst, compute_dtype=cd)
        out_src = out if same_block else apply_linear(
            params["filters"][0], x_d_src, compute_dtype=cd)
    else:
        out = x_d_dst
        out_src = out if same_block else x_d_src

    if src_slot_table is None:
        src_slot_table = src.index_select(0, agg_table.reshape(-1)).view(agg_table.shape)
    src_slot_table = src_slot_table.to(torch.int32).contiguous()
    if ea_slots is None and cfg.edge_features > 0:
        ea_slots = edge_attr.index_select(0, agg_table.reshape(-1)).view(
            *agg_table.shape, -1)
    s_tab = _edge_flux_slots(params, cfg, x_s_src, x_d_src, x_s_dst, x_d_dst,
                             src_slot_table, ea_slots, agg_mask)
    if cd is not None:
        # the hop state and the flux table live in bf16; each filter matmul
        # returns float32, rounded back to bf16 before the update
        s_tab = s_tab.to(getattr(torch, cd))
        out = out.to(getattr(torch, cd))
        out_src = out if same_block else out_src.to(getattr(torch, cd))
    if band_plan is not None and band_w is not None and same_block:
        # banded hop (swegnn.py:349-369): the flux table as [Nd, D*F]
        ws, we = band_w
        s_flat = s_tab.reshape(s_tab.shape[0], -1)

        def one_hop(state):
            return band_hop(state, s_flat, band_plan["idx_rel"], band_plan["win"], ws=ws,
                            we=we, with_gradient=cfg.with_gradient,
                            upwind=cfg.upwind_mode, out_table=out_table)
    else:
        # A concat union (sub_blocks > 1) hops as one block. The JAX package
        # splits a union past HOP_CHUNK_TARGET_ROWS into per-graph chunks
        # (swegnn.py:371-419) to keep the TPU gather unit's VMEM staging of
        # the state table small; the kernel here gathers from HBM and L2 at
        # any table size, so it takes the whole block. The math is the same:
        # a chunk's sources lie in the chunk (the graphs are disjoint), and a
        # masked padding slot aliases edge 0 of the whole block, a row in
        # range that the slot mask (zero flux) kills.
        def one_hop(state):
            return hop(state, state if same_block else out_src, src_slot_table, s_tab,
                       with_gradient=cfg.with_gradient, upwind=cfg.upwind_mode,
                       out_table=out_table)
    for k in range(cfg.K):
        agg = one_hop(out)
        if cfg.with_filter_matrix:
            agg = apply_linear(params["filters"][k + 1], agg, compute_dtype=cd)
        if cd is not None:
            agg = agg.to(out.dtype)
        out = out + agg
    return out.to(x_d_dst.dtype) if cd is not None else out


def apply_swegnn(*args, **kwargs):
    """The whole-graph SWEGNN layer of the single-scale GNN: not ported yet."""
    raise NotImplementedError("apply_swegnn (the single-scale GNN path) is not ported yet")
