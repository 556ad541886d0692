"""The ``meshgraphnet`` architecture: MeshGraphNets (Pfaff, Fortunato,
Sanchez-Gonzalez and Battaglia, "Learning Mesh-Based Simulation with Graph
Networks", ICLR 2021, arXiv:2010.03409; deepmind-research
``meshgraphnets/core_model.py``, built by ``run_model.py`` as
``EncodeProcessDecode(latent_size=128, num_layers=2,
message_passing_steps=15)``) as a flood model, ``model_type`` MGN. It
raises for any other model dict.

Over directed edges j -> i (sender ``src``, receiver ``dst``)::

    MLP(x)    = W3 relu(W2 relu(W1 x + b1) + b2) + b3   (no activation after the last)
    MLP_LN(x) = LayerNorm(MLP(x))                        (learned scale and offset)
    encode:     v_i = MLP_LN(node features of i),  e_ji = MLP_LN(edge features of j -> i)
    block (x n_GNN_layers, own weights each):
        e'_ji = MLP_LN_e([v_j | v_i | e_ji])
        a_i   = sum over j -> i of e'_ji
        v'_i  = MLP_LN_v([v_i | a_i])
        v_i <- v_i + v'_i ;  e_ji <- e_ji + e'_ji
    decode:     out_i = MLP(v_i)

``Reference`` computes that literally, in float32 on the unpadded graph:
its own MLP and LayerNorm, the sum an ``index_add`` over the edges, both
encoders run every step. It reads the weights from the port's tree (each
MLP ``{"layers", "acts", "norms"}``, a LayerNorm ``{"scale", "bias"}`` in
the last layer's ``norms`` slot).

Departures from the paper, all the flood data's and the port's:

- inputs are scaled by the data layer's scalers (``reference/model.py::
  features``), not MGN's online normalisers;
- training is the 6-step pushforward of the mSWE-GNN family, not one step
  with training noise;
- a node's input is ``previous_t`` frames of (h, |q|) with the terrain
  features ``[area, DEM]`` and the water level, not a velocity and a node
  type;
- an edge's input is the flood graph's own edge feature, the standardised
  length of the edge (the data layer's default), not MGN's relative
  position vector with its norm;
- the output passes the flood head of the mSWE-GNN family after the
  residual on the last input frame: ``relu``, the small-depth mask.

FLOPs are those of the matmuls, in the least form the model allows, as
``swegnn.py`` counts them: the edge MLP's first linear over ``[v_j | v_i |
e_ji]`` is a projection a node (sender and receiver parts) plus an edge
term. Activations, LayerNorm, gathers, sums and residuals are not counted.
This architecture has no hand-written kernel: ``KERNELS`` is empty.
"""
from __future__ import annotations

import torch

from portbench.counts import mlp_flops, mlp_sizes
from portbench.reference import model as base

KERNELS = {}
LN_EPS = 1e-5


def check(model: dict) -> None:
    """Raise for a model dict this module does not describe."""
    if model["model_type"] != "MGN":
        raise ValueError("the meshgraphnet architecture is MeshGraphNets (model_type MGN) "
                         f"only, not {model['model_type']}")
    if model.get("learned_residuals") not in (False, None):
        raise ValueError("the meshgraphnet architecture does not implement "
                         f"learned_residuals={model['learned_residuals']!r}")


class Reference(base.Reference):
    """MeshGraphNets of ``model_cfg`` over every edge of the mesh."""

    def __init__(self, model_cfg: dict, mesh: dict, previous_t: int, device,
                 precision: base.Precision | None = None):
        check(model_cfg)
        super().__init__(model_cfg, mesh, previous_t, device, precision)
        self.all_edges = torch.cat(self.edges, dim=1)

    def encode_edges(self, params, edge_attr):
        """The raw edge features: the edge encoder runs inside every step."""
        return edge_attr

    def layer_norm(self, params, x):
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * params["scale"] + params["bias"]

    def mlp(self, params, x):
        """Linears with the activation between them, none after the last;
        the LayerNorm on the output where the tree holds one."""
        last = len(params["layers"]) - 1
        for i, (lin, a) in enumerate(zip(params["layers"], params["acts"])):
            x = self.mm(x, lin["w"]) + lin["b"]
            if i < last:
                x = self.act(self.cfg["mlp_activation"], a, x)
        if params["norms"][last]:
            x = self.layer_norm(params["norms"][last], x)
        return x

    def forward(self, params, x_static, x_dyn, edge_attr):
        """-> predictions ``[N, 2]`` of (h, |q|) at the next frame."""
        src, dst = self.all_edges[0], self.all_edges[1]
        x_s = x_static
        if self.cfg["with_WL"]:
            wl = x_s[:, -1] + x_dyn[:, -base.NUM_WATER_VARS]
            x_s = torch.cat([x_s, wl[:, None]], dim=1)
        v = self.mlp(params["node_encoder"], torch.cat([x_s, x_dyn], dim=1))
        e = self.mlp(params["edge_encoder"], edge_attr)
        for block in params["processor"]:
            e_new = self.mlp(block["edge_mlp"], torch.cat([v[src], v[dst], e], dim=1))
            agg = torch.zeros_like(v).index_add_(0, dst, e_new)
            v = v + self.mlp(block["node_mlp"], torch.cat([v, agg], dim=1))
            e = e + e_new
        out = self.mlp(params["node_decoder"], v)
        if self.cfg.get("learned_residuals", False) is False:
            out = out + x_dyn[:, -base.NUM_WATER_VARS:]
        out = torch.relu(out)
        wd = out[:, 0] * (out[:, 0].abs() > 1e-4)
        return torch.stack([wd, out[:, 1] * (wd != 0)], dim=1)


def forward_flops(model: dict, shp: dict, static_in: int, dynamic_in: int,
                  edge_in: int) -> int:
    """FLOPs of one forward model step of one graph: the encoders, the
    blocks and the decoder."""
    check(model)
    F, ml = model["hid_features"], model["mlp_layers"]
    n, e = sum(shp["nodes"]), sum(shp["edges"])
    total = (mlp_flops(n, mlp_sizes(static_in + dynamic_in, F, F, ml))
             + mlp_flops(e, mlp_sizes(edge_in, F, F, ml))
             + mlp_flops(n, mlp_sizes(F, base.NUM_WATER_VARS, F, ml)))   # decoder
    edge_first = 2 * n * 2 * F * F + 2 * e * F * F     # [v_j | v_i] a node, e_ji an edge
    edge_rest = mlp_flops(e, mlp_sizes(3 * F, F, F, ml)[1:])
    node = mlp_flops(n, mlp_sizes(2 * F, F, F, ml))
    return total + model["n_GNN_layers"] * (edge_first + edge_rest + node)


def kernel_bytes(model: dict, shp: dict, train: bool) -> dict:
    """No kernel family: MeshGraphNets runs no hand-written kernel."""
    check(model)
    return {}
