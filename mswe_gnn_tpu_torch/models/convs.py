"""Baseline graph convolutions: Cheb / TAG / GAT (port of
mswe_gnn_tpu/models/convs.py).

The reference's processor baselines (reference models/gnn.py:85-100):
- ``GNN_L`` -> ChebConv (Chebyshev polynomials of the scaled Laplacian)
- ``GNN_A`` -> TAGConv (powers of the symmetric-normalised adjacency)
- ``GAT``   -> GATConv (single-head additive attention)

All run on padded COO edge arrays with a mask: degrees count only real
edges, and a padded edge (a valid node index, mask 0) changes nothing. The
gathers and segment sums are the library reductions of ``ops/segment.py``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from mswe_gnn_tpu_torch.models.mlp import apply_linear, init_linear
from mswe_gnn_tpu_torch.ops.segment import gather, segment_max_raw, segment_sum


def _sym_norm_coeffs(src, dst, edge_mask, num_nodes, add_self_loops: bool):
    """D^-1/2 A D^-1/2 edge coefficients (a masked edge gets 0)."""
    deg = segment_sum(edge_mask[:, None], dst, num_nodes)[:, 0]
    if add_self_loops:
        deg = deg + 1.0
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), torch.zeros_like(deg))
    coeff = gather(dinv, src) * gather(dinv, dst) * edge_mask
    return coeff, dinv


def _adj_matvec(x, src, dst, coeff, num_nodes):
    """y = A_norm x by gather, scale and scatter."""
    return segment_sum(gather(x, src) * coeff[:, None], dst, num_nodes)


@dataclasses.dataclass(frozen=True)
class ChebConfig:
    in_features: int
    out_features: int
    K: int


def init_cheb(gen: torch.Generator, cfg: ChebConfig) -> dict:
    return {"lins": [init_linear(gen, cfg.in_features, cfg.out_features, bias=False)
                     for _ in range(cfg.K)],
            "bias": torch.zeros(cfg.out_features)}


def apply_cheb(params, cfg: ChebConfig, x, src, dst, edge_mask):
    """Chebyshev conv with the lambda_max=2 normalisation (PyG's default):
    L_hat = L_sym - I = -D^-1/2 A D^-1/2."""
    n = x.shape[0]
    coeff, _ = _sym_norm_coeffs(src, dst, edge_mask, n, add_self_loops=False)
    tx_prev = x
    out = apply_linear(params["lins"][0], tx_prev)
    if cfg.K > 1:
        tx = -_adj_matvec(x, src, dst, coeff, n)
        out = out + apply_linear(params["lins"][1], tx)
        for k in range(2, cfg.K):
            tx_next = -2.0 * _adj_matvec(tx, src, dst, coeff, n) - tx_prev
            tx_prev, tx = tx, tx_next
            out = out + apply_linear(params["lins"][k], tx)
    return out + params["bias"]


@dataclasses.dataclass(frozen=True)
class TAGConfig:
    in_features: int
    out_features: int
    K: int


def init_tag(gen: torch.Generator, cfg: TAGConfig) -> dict:
    return {"lins": [init_linear(gen, cfg.in_features, cfg.out_features, bias=False)
                     for _ in range(cfg.K + 1)],
            "bias": torch.zeros(cfg.out_features)}


def apply_tag(params, cfg: TAGConfig, x, src, dst, edge_mask):
    """TAGConv: sum_k W_k (A_norm^k x), symmetric-normalised adjacency."""
    n = x.shape[0]
    coeff, _ = _sym_norm_coeffs(src, dst, edge_mask, n, add_self_loops=False)
    out = apply_linear(params["lins"][0], x)
    h = x
    for k in range(1, cfg.K + 1):
        h = _adj_matvec(h, src, dst, coeff, n)
        out = out + apply_linear(params["lins"][k], h)
    return out + params["bias"]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    in_features: int
    out_features: int
    negative_slope: float = 0.2


def init_gat(gen: torch.Generator, cfg: GATConfig) -> dict:
    bound = 1.0 / math.sqrt(cfg.in_features)
    return {"lin": init_linear(gen, cfg.in_features, cfg.out_features, bias=False),
            "att_src": torch.empty(cfg.out_features).uniform_(-bound, bound, generator=gen),
            "att_dst": torch.empty(cfg.out_features).uniform_(-bound, bound, generator=gen),
            "bias": torch.zeros(cfg.out_features)}


def apply_gat(params, cfg: GATConfig, x, src, dst, edge_mask):
    """Single-head GAT with a masked softmax over each node's incoming edges.

    A masked edge's logit is the dtype's least finite value, and a node
    without any edge (a segment max of ``-inf``) takes a max of 0, as in JAX
    (convs.py:119-131): its weights, and so its message sum, are 0."""
    n = x.shape[0]
    h = apply_linear(params["lin"], x)
    alpha = gather(h @ params["att_src"], src) + gather(h @ params["att_dst"], dst)
    alpha = F.leaky_relu(alpha, negative_slope=cfg.negative_slope)
    alpha = torch.where(edge_mask > 0, alpha,
                        torch.full_like(alpha, torch.finfo(alpha.dtype).min))
    seg_max = segment_max_raw(alpha, dst, n)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ex = torch.exp(alpha - gather(seg_max, dst)) * edge_mask
    denom = segment_sum(ex[:, None], dst, n)[:, 0]
    w = ex / gather(denom, dst).clamp_min(1e-16)
    out = segment_sum(gather(h, src) * w[:, None], dst, n)
    return out + params["bias"]
