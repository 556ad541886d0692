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
the same kernels. Without an ``agg_table`` a layer takes the edge-major
path (swegnn.py:473-503): the flux per edge and each hop's messages summed
onto their destinations by a segment sum (``ops/segment.py``, a library
call: in JAX it is an XLA op, not a Pallas kernel). ``apply_swegnn`` is the
whole-graph layer of the single-scale GNN (models/gnn.py).
``SWEGNNConfig.use_pallas`` and ``flat_hop_threshold`` are accepted so that
the JAX package's config dicts build, and have no effect here: the JAX
package's slot loop, flat path and Pallas hop all compute the same hop,
which the port always runs through its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mswe_gnn_tpu_torch.models.activations import apply_activation
from mswe_gnn_tpu_torch.models.mlp import apply_linear, apply_mlp, init_linear, init_mlp, matmul
from mswe_gnn_tpu_torch.ops.band_hop import band_hop
from mswe_gnn_tpu_torch.ops.hop import hop
from mswe_gnn_tpu_torch.ops.segment import gather, segment_sum


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


def _first_layer_projections(params: dict, cfg: SWEGNNConfig, x_s_src, x_d_src,
                              x_s_dst, x_d_dst):
    """The first linear over [x_s_i | x_s_j | x_d_i | x_d_j | e_ij] split into
    per-node src and dst projections -> ``(proj_src [Ns, H], proj_dst
    [Nd, H])``; the edge term is added per edge by ``_flux_tail``."""
    W = params["edge_mlp"]["layers"][0]["w"]
    s, d = cfg.static_node_features, cfg.dynamic_node_features
    W_ss, W_sd = W[:s], W[s: 2 * s]
    W_ds, W_dd = W[2 * s: 2 * s + d], W[2 * s + d: 2 * s + 2 * d]
    cd = _compute_dtype(cfg)
    proj_src = matmul(x_s_src, W_ss, cd) + matmul(x_d_src, W_ds, cd)
    proj_dst = matmul(x_s_dst, W_sd, cd) + matmul(x_d_dst, W_dd, cd)
    return proj_src, proj_dst


def _flux_tail(params: dict, cfg: SWEGNNConfig, h, ea) -> torch.Tensor:
    """The rest of the edge MLP from the gathered node projections ``h``
    (and the edge features ``ea``), normalised (a zero flux stays zero)."""
    mlp = params["edge_mlp"]
    lin0 = mlp["layers"][0]
    s, d, fe = cfg.static_node_features, cfg.dynamic_node_features, cfg.edge_features
    cd = _compute_dtype(cfg)
    if fe > 0:
        h = h + matmul(ea, lin0["w"][2 * s + 2 * d:], cd)
    if "b" in lin0:
        h = h + lin0["b"]
    h = apply_activation(cfg.mlp_activation, mlp["acts"][0], h)
    rest = {"layers": mlp["layers"][1:], "acts": mlp["acts"][1:],
            "norms": mlp["norms"][1:]}
    flux = apply_mlp(rest, h, activation=cfg.mlp_activation, compute_dtype=cd)
    if cfg.normalize:
        norm = torch.linalg.vector_norm(flux, dim=-1, keepdim=True)
        pos = norm > 0
        flux = torch.where(pos, flux / torch.where(pos, norm, torch.ones_like(norm)),
                           torch.zeros_like(flux))
    return flux


def _edge_flux_slots(params: dict, cfg: SWEGNNConfig, x_s_src, x_d_src,
                     x_s_dst, x_d_dst, src_tab: torch.Tensor,
                     ea_tab: Optional[torch.Tensor],
                     slot_mask: torch.Tensor) -> torch.Tensor:
    """The flux s_ij in ELL slot layout -> ``[Nd, D, F]`` (float32).

    Slot d of dst node i is the edge (src_tab[i, d] -> i), so the dst side
    needs no gather. Masked slots alias edge 0 (a real edge, so the value is
    finite) and are zeroed by ``slot_mask [Nd, D]``.
    """
    proj_src, proj_dst = _first_layer_projections(params, cfg, x_s_src, x_d_src,
                                                  x_s_dst, x_d_dst)
    n_dst, deg = src_tab.shape
    h = (proj_src.index_select(0, src_tab.reshape(-1)).view(n_dst, deg, -1)
         + proj_dst[:, None, :])
    return _flux_tail(params, cfg, h, ea_tab) * slot_mask[:, :, None]


def _edge_flux_block(params: dict, cfg: SWEGNNConfig, x_s_src, x_d_src, x_s_dst,
                     x_d_dst, src, dst, edge_attr) -> torch.Tensor:
    """The flux s_ij of every edge, edge-major -> ``[E, F]`` (swegnn.py:101-151)."""
    proj_src, proj_dst = _first_layer_projections(params, cfg, x_s_src, x_d_src,
                                                  x_s_dst, x_d_dst)
    h = gather(proj_src, src) + gather(proj_dst, dst)
    return _flux_tail(params, cfg, h, edge_attr)


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
    the edge block); without ``agg_table`` the layer takes the edge-major
    path over ``src``/``dst``, ``edge_attr`` and ``edge_mask [E]``. ``src_slot_table [Nd, D]`` int32 (slot source rows),
    ``ea_slots [Nd, D, Fe]`` (slot edge features) and ``out_table`` (the
    out-slot table the hop backward kernels read) are the loop-invariant
    tables of models/prepare.py; they are derived here when not given.
    ``band_plan`` (``{"win", "idx_rel"}``) with ``band_w = (ws, we)`` sends
    the hops of a same-block layer through the banded kernel.

    ``sub_blocks`` > 1 declares the block a concat union of that many
    equal-sized, mutually disconnected graphs (``graph.concat_graphs``);
    the port hops over the union block whole (see the note at the hop loop).
    """
    cd = _compute_dtype(cfg)

    if cfg.with_filter_matrix:
        out = apply_linear(params["filters"][0], x_d_dst, compute_dtype=cd)
        out_src = out if same_block else apply_linear(
            params["filters"][0], x_d_src, compute_dtype=cd)
    else:
        out = x_d_dst
        out_src = out if same_block else x_d_src

    if agg_table is None:
        return _edge_major_hops(params, cfg, x_s_src, x_d_src, x_s_dst, x_d_dst, src, dst,
                                edge_attr, edge_mask, same_block, out, out_src)

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


def _edge_major_hops(params, cfg: SWEGNNConfig, x_s_src, x_d_src, x_s_dst, x_d_dst,
                     src, dst, edge_attr, edge_mask, same_block, out, out_src):
    """The K hops on the edge-major path (swegnn.py:473-503): the flux of
    every edge, each hop's messages scattered onto their destinations by a
    segment sum (a library call, as JAX's is an XLA op). On a same block the
    source activity is the destination activity (the same rows). As in JAX,
    a bf16 policy rounds only the matmul operands here: the hop state is not
    cast back to bf16 (unlike the ELL path)."""
    cd = _compute_dtype(cfg)
    n_dst = x_d_dst.shape[0]
    s_ij = _edge_flux_block(params, cfg, x_s_src, x_d_src, x_s_dst, x_d_dst, src, dst,
                            edge_attr)
    if edge_mask is not None:
        s_ij = s_ij * edge_mask[:, None]
    for k in range(cfg.K):
        src_ref = out if same_block else out_src
        dst_active = (out.sum(dim=1) != 0).to(out.dtype)
        src_active = dst_active if same_block else (src_ref.sum(dim=1) != 0).to(out.dtype)
        e_active = torch.maximum(gather(src_active, src), gather(dst_active, dst))
        if cfg.with_gradient:
            grad = gather(out, dst) - gather(src_ref, src)
            if cfg.upwind_mode:
                grad = grad.clamp_min(0.0)
            msg = grad * s_ij
        else:
            msg = s_ij * gather(src_ref, src)
        agg = segment_sum(msg * e_active[:, None], dst, n_dst)
        if cfg.with_filter_matrix:
            agg = apply_linear(params["filters"][k + 1], agg, compute_dtype=cd)
        out = out + agg
    return out


def apply_swegnn(
    params: dict,
    cfg: SWEGNNConfig,
    x_s: torch.Tensor,
    x_d: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_attr: Optional[torch.Tensor] = None,
    edge_mask: Optional[torch.Tensor] = None,
    src_range: Optional[Tuple[int, int]] = None,
    dst_range: Optional[Tuple[int, int]] = None,
    agg_table: Optional[torch.Tensor] = None,
    agg_mask: Optional[torch.Tensor] = None,
    ea_slots: Optional[torch.Tensor] = None,
    src_slot_table: Optional[torch.Tensor] = None,
    band_plan: Optional[dict] = None,
    band_w=None,
    sub_blocks: int = 1,
    out_table=None,
) -> torch.Tensor:
    """Whole-graph SWEGNN layer (swegnn.py:506-561): K hops of learned-flux
    message passing, run block-locally by ``apply_swegnn_block``.

    ``src_range``/``dst_range`` are static node slices holding every edge
    source / destination; they must be identical or disjoint. Rows outside
    ``dst_range`` are H_0-transformed and otherwise untouched, as in the
    reference, where each processor applies its filter to the full node
    array (reference models/gnn.py:401-404).
    """
    num_nodes = x_d.shape[0]
    lo, hi = (0, num_nodes) if dst_range is None else dst_range
    slo, shi = (0, num_nodes) if src_range is None else src_range
    same = (slo, shi) == (lo, hi)
    if not (same or shi <= lo or hi <= slo):
        raise ValueError("src_range and dst_range must be identical or disjoint")

    block = apply_swegnn_block(
        params, cfg, x_s[slo:shi], x_d[slo:shi], x_s[lo:hi], x_d[lo:hi],
        src if slo == 0 else src - slo, dst if lo == 0 else dst - lo,
        edge_attr=edge_attr, edge_mask=edge_mask, same_block=same,
        agg_table=agg_table, agg_mask=agg_mask,
        ea_slots=ea_slots, src_slot_table=src_slot_table, band_plan=band_plan,
        band_w=band_w, sub_blocks=sub_blocks, out_table=out_table)
    if dst_range is None:
        return block
    cd = _compute_dtype(cfg)
    if cfg.with_filter_matrix:
        out = apply_linear(params["filters"][0], x_d, compute_dtype=cd)
    else:
        out = x_d
    out = out.to(block.dtype)
    return torch.cat([out[:lo], block, out[hi:]], dim=0)
