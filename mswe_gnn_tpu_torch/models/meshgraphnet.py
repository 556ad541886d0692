"""MeshGraphNets (Pfaff et al., "Learning Mesh-Based Simulation with Graph
Networks", ICLR 2021; deepmind-research ``meshgraphnets/core_model.py``)
as a flood model: encode -> process -> decode over the flood graph's
directed edges j -> i (sender ``src``, receiver ``dst``).

    MLP(x)    = W3 relu(W2 relu(W1 x + b1) + b2) + b3   (no activation after the last)
    MLP_LN(x) = LayerNorm(MLP(x))
    encode:     v_i = MLP_LN(node features of i),  e_ji = MLP_LN(edge features of j -> i)
    block (``n_gnn_layers`` of them, own weights each):
        e'_ji = MLP_LN_e([v_j | v_i | e_ji])
        a_i   = sum over j -> i of e'_ji
        v'_i  = MLP_LN_v([v_i | a_i])
        v_i <- v_i + v'_i ;  e_ji <- e_ji + e'_ji
    decode:     out_i = MLP(v_i)

The node encoder reads ``[x_static | WL | x_dynamic]``, as the baselines'
joint ``node_encoder`` of models/gnn.py builds it; the edge encoder reads
``graph.edge_attr``. The output goes through the flood head of
models/base.py: the residual on the last input frame (``learned_residuals``
False, MGN's first-order integrator; None leaves it out), ``relu``, the
small-depth mask and the node mask.

The sum over a node's in-edges is a gather of the edge latents through the
in-edge ELL table (``graph.in_edge_table``, ``in_edge_mask``) and a masked
sum over its slots (``graph.ell_aggregate``): no atomics in the forward.
Padded edges sit in no slot, so they contribute nothing, and padded nodes
are zero in the output. A ``concat_graphs`` union runs whole. The forward
reads nothing back to the host.

Spans (``utils/profiling.span``): ``mswe.mgn.encode`` and
``mswe.mgn.decode`` once a call, and in every block
``mswe.mgn.edge_update`` (gather, concat, edge MLP, LayerNorm),
``mswe.mgn.aggregate`` and ``mswe.mgn.node_update`` (node MLP, LayerNorm,
both residuals). Under remat they fire again in the backward's recompute.
"""
from __future__ import annotations

import dataclasses

import torch

from mswe_gnn_tpu_torch import NUM_WATER_VARS
from mswe_gnn_tpu_torch.graph import FloodGraph, ell_aggregate
from mswe_gnn_tpu_torch.models import base as base_model
from mswe_gnn_tpu_torch.models.mlp import apply_mlp, init_mlp
from mswe_gnn_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    """Static hyperparameters; the names are the port's where they fit
    (``n_gnn_layers`` is the config's ``n_GNN_layers``: the blocks)."""
    num_node_features: int          # static + dynamic input columns of x
    num_edge_features: int
    hid_features: int = 128         # the latent size of nodes and edges
    mlp_layers: int = 3             # linears an MLP: 2 hidden layers + output
    n_gnn_layers: int = 15          # message-passing blocks
    mlp_activation: str = "relu"
    with_WL: bool = True
    previous_t: int = 1
    learned_residuals: object = False   # False: the last frame; None: no residual
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.learned_residuals not in (False, None):
            raise ValueError("MGN adds the last input frame (learned_residuals False) or "
                             f"nothing (None), not learned_residuals={self.learned_residuals!r}")

    @property
    def out_dim(self) -> int:
        return NUM_WATER_VARS


def init_mgn(gen: torch.Generator, cfg: MGNConfig) -> dict:
    h = cfg.hid_features

    def mlp(fan_in, fan_out, norm=True):
        return init_mlp(gen, fan_in, fan_out, h, n_layers=cfg.mlp_layers, bias=True,
                        activation=cfg.mlp_activation, activate_final=False, layer_norm=norm)

    return {"node_encoder": mlp(cfg.num_node_features + int(cfg.with_WL), h),
            "edge_encoder": mlp(cfg.num_edge_features, h),
            "processor": [{"edge_mlp": mlp(3 * h, h), "node_mlp": mlp(2 * h, h)}
                          for _ in range(cfg.n_gnn_layers)],
            "node_decoder": mlp(h, cfg.out_dim, norm=False)}


def apply_mgn(params: dict, cfg: MGNConfig, graph: FloodGraph) -> torch.Tensor:
    """Forward pass on one graph, or on a ``concat_graphs`` union, -> [N, 2]
    predictions of (h, |q|) at the next step."""
    def mlp(p, x):
        return apply_mlp(p, x, activation=cfg.mlp_activation, compute_dtype=cfg.compute_dtype)

    x0 = torch.cat([graph.x_static, graph.x_dynamic], dim=-1)
    src, dst = graph.edge_index[0].long(), graph.edge_index[1].long()
    table, mask = graph.in_edge_table.long(), graph.in_edge_mask

    with span("mswe.mgn.encode"):
        x = x0
        if cfg.with_WL:
            # the water level as a static column (models/gnn.py's split)
            n_s = x0.shape[1] - cfg.previous_t * cfg.out_dim
            wl = x0[:, n_s - 1] + x0[:, -cfg.out_dim]
            x = torch.cat([x0[:, :n_s], wl[:, None], x0[:, n_s:]], dim=-1)
        v = mlp(params["node_encoder"], x)
        e = mlp(params["edge_encoder"], graph.edge_attr)

    for block in params["processor"]:
        with span("mswe.mgn.edge_update"):
            e_new = mlp(block["edge_mlp"], torch.cat([v[src], v[dst], e], dim=-1))
        with span("mswe.mgn.aggregate"):
            agg = ell_aggregate(e_new, table, mask)
        with span("mswe.mgn.node_update"):
            v = v + mlp(block["node_mlp"], torch.cat([v, agg], dim=-1))
            e = e + e_new

    with span("mswe.mgn.decode"):
        out = mlp(params["node_decoder"], v)
        out = out + base_model.add_residual_connection(
            x0, None, cfg.learned_residuals, cfg.previous_t, cfg.out_dim)
        out = torch.relu(out)
        out = base_model.mask_small_wd(out, epsilon=0.0001)
        # padded nodes are zero, so losses and metrics never see them
        return out * graph.node_mask[:, None]
