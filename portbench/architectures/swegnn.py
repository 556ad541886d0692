"""The ``swegnn`` architecture: mSWE-GNN (``model_type`` MSGNN, the V-cycle
of reference models/gnn.py:267-350 with mean pooling) and the single-scale
SWE-GNN (``model_type`` GNN, ``type_GNN`` SWEGNN, reference
models/gnn.py:13-152). It raises for any other model dict: learned pooling,
``upwind_mode`` and the other ``type_GNN`` baselines are other modules'.

The reference runs every SWE-GNN layer over the whole node array with the
edges of its scale; pooling is a scatter mean that replaces the node array,
un-pooling an edge-feature-less SWE-GNN over the transfer edges, and each
hop sums the messages of the active edges onto their destinations with
``index_add``.

FLOPs are those of the matmuls and of the hops' arithmetic, in the least
form the model allows: the edge MLP's first linear over ``[x_s_j | x_s_i |
x_d_j | x_d_i | e_ji]`` is a projection a node plus an edge term, as any
implementation may compute it. Activations, normalisation, pooling and the
residual are not counted.

Hop bytes follow ``chip_smoke.py``'s bound (``hop_work``, ``hop_bwd_work``):
every input read once and every output written once, over the real edges
and nodes (no padding, no padded ELL slots).
"""
from __future__ import annotations

import torch

from portbench.counts import ELEM_BYTES, mlp_flops, mlp_sizes
from portbench.reference import model as base

# device kernels that implement a hop (forward and backward, ELL and band)
KERNELS = {"hop": ("hop_fwd_kernel", "hop_bwd_kernel")}


def check(model: dict) -> None:
    """Raise for a model dict this module does not describe."""
    unsupported = {k: model.get(k) for k in ("learned_pooling", "upwind_mode")
                   if model.get(k)}
    if unsupported:
        raise ValueError(f"the swegnn architecture does not implement {unsupported}")
    if not (model["model_type"] == "MSGNN"
            or (model["model_type"] == "GNN" and model.get("type_GNN") == "SWEGNN")):
        raise ValueError("the swegnn architecture is the MSGNN and the SWE-GNN only, not "
                         f"{model['model_type']} {model.get('type_GNN')}")


class Reference(base.Reference):
    """The MSGNN or the SWE-GNN of ``model_cfg``; the MSGNN's loss counts
    the finest scale alone."""

    def __init__(self, model_cfg: dict, mesh: dict, previous_t: int, device,
                 precision: base.Precision | None = None):
        check(model_cfg)
        super().__init__(model_cfg, mesh, previous_t, device, precision)
        self.only_finest = model_cfg["model_type"] == "MSGNN"

    def swegnn(self, params, K, x_s, x_d, edges, edge_attr, filters, gradient, normalize):
        """One SWE-GNN layer over the whole node array: ``out = H_0 x_d``,
        then K hops ``out += H_k sum_j act_ij (out_i - out_j) s_ij`` (without
        ``gradient``: ``s_ij out_j``), ``s_ij`` the normalised edge MLP of
        ``[x_s_j | x_s_i | x_d_j | x_d_i | e_ji]`` over edges j -> i."""
        src, dst = edges[0], edges[1]
        feats = [x_s[src], x_s[dst], x_d[src], x_d[dst]]
        if edge_attr is not None:
            feats.append(edge_attr)
        s = self.mlp(params["edge_mlp"], torch.cat(feats, dim=1))
        if normalize:
            norm = torch.linalg.vector_norm(s, dim=1, keepdim=True)
            s = torch.where(norm > 0, s / torch.where(norm > 0, norm, 1.0), 0.0)
        s = self.rnd.hop(s)
        out = self.mm(x_d, params["filters"][0]["w"]) if filters else x_d
        for k in range(K):
            out = self.rnd.hop(out)
            active = out.sum(dim=1) != 0
            live = (active[src] | active[dst]).to(out.dtype)[:, None]
            msg = (out[dst] - out[src]) * s if gradient else s * out[src]
            agg = torch.zeros_like(out).index_add_(0, dst, msg * live)
            if filters:
                agg = self.rnd.hop(self.mm(agg, params["filters"][k + 1]["w"]))
            out = out + agg
        return out

    def processor(self, params, K, x_s, x_d, edges, edge_attr):
        """A processor layer: the configuration's filter, gradient and
        normalisation settings, over the encoded edge features."""
        return self.swegnn(params, K, x_s, x_d, edges, edge_attr,
                           self.cfg["with_filter_matrix"], self.cfg["with_gradient"],
                           self.cfg["normalize"])

    def msgnn(self, params, x_static, x_dyn, edge_attr):
        """The V-cycle of reference models/gnn.py:267-350."""
        cfg = self.cfg
        L = len(self.node_ptr) - 1
        K = cfg["K"] if isinstance(cfg["K"], list) else [cfg["K"]] * L
        ks = K + K[::-1][1:]
        x_s, x_d = self._encode(params, x_static, x_dyn)
        x_down = torch.zeros_like(x_d)
        x_up = torch.zeros_like(x_d)

        def on(scale):
            return (self.scale_of == scale).to(x_d.dtype)[:, None]

        def scale_edges(s):
            return self.edges[s], edge_attr[self.edge_ptr[s]:self.edge_ptr[s + 1]]

        for i in range(L - 1):
            e, ea = scale_edges(i)
            x_d = self.processor(params["gnn_processor"][i], ks[i], x_s, x_d, e, ea)
            x_down = x_down + x_d * on(i)
            coarse, fine = self.intra[i]
            sums = torch.zeros_like(x_d).index_add_(0, coarse, x_d[fine])
            cnt = torch.zeros(self.n, device=x_d.device).index_add_(
                0, coarse, torch.ones_like(coarse, dtype=x_d.dtype))
            x_d = torch.where(cnt[:, None] > 0, sums / cnt.clamp_min(1.0)[:, None], 0.0)
        x_down = x_down + x_d
        for i in range(L):
            scale = L - 1 - i
            e, ea = scale_edges(scale)
            x_d = self.processor(params["gnn_processor"][L - 1 + i], ks[L - 1 + i],
                                 x_s, x_d, e, ea)
            x_up = x_up + x_d * on(scale)
            if i < L - 1:
                x_d = self.swegnn(params["intra_scale_gnn"][i], 1, x_s, x_d,
                                  self.intra[scale - 1], None, filters=False, gradient=False,
                                  normalize=True)
                if cfg["skip_connections"]:
                    x_d = x_d + x_down * on(scale - 1)
        h = self.act(cfg["gnn_activation"], params["gnn_act"], x_up)
        return self._decode(params, h, x_dyn)

    def gnn(self, params, x_static, x_dyn, edge_attr):
        """The single-scale SWE-GNN of reference models/gnn.py:13-152."""
        x_s, x_d = self._encode(params, x_static, x_dyn)
        h = x_d
        for conv in params["gnn_processor"]:
            h = self.processor(conv, self.cfg["K"], x_s, x_d, self.edges[0], edge_attr)
            h = self.act(self.cfg["gnn_activation"], params["gnn_act"], h)
            x_d = h
        return self._decode(params, h, x_dyn)

    def forward(self, params, x_static, x_dyn, edge_attr):
        """-> predictions ``[N, 2]`` of (h, |q|) at the next frame."""
        if self.cfg["model_type"] == "MSGNN":
            return self.msgnn(params, x_static, x_dyn, edge_attr)
        return self.gnn(params, x_static, x_dyn, edge_attr)


def layers(model: dict, shp: dict) -> list:
    """Every SWE-GNN layer of one forward pass as ``(n_dst, n_src, edges,
    K, edge_features, same_block, filters, gradient)``."""
    check(model)
    F = model["hid_features"]
    if model["model_type"] == "GNN":
        n, e = shp["nodes"][0], shp["edges"][0]
        return [(n, n, e, model["K"], F, True, True, True)] * model["n_GNN_layers"]
    L = len(shp["nodes"])
    ks = model["K"] if isinstance(model["K"], list) else [model["K"]] * L
    out = []
    for i in range(L - 1):                                  # downsweep
        out.append((shp["nodes"][i], shp["nodes"][i], shp["edges"][i], ks[i], F,
                    True, True, True))
    for i in range(L):                                      # upsweep and un-pooling
        s = L - 1 - i
        out.append((shp["nodes"][s], shp["nodes"][s], shp["edges"][s], ks[s], F,
                    True, True, True))
        if i < L - 1:
            out.append((shp["nodes"][s - 1], shp["nodes"][s], shp["intra"][s - 1], 1, 0,
                        False, False, False))
    return out


def forward_flops(model: dict, shp: dict, static_in: int, dynamic_in: int,
                  edge_in: int) -> int:
    """FLOPs of one forward model step of one graph."""
    F, ml = model["hid_features"], model["mlp_layers"]
    H = 2 * F                                               # edge MLP hidden width
    n_all = sum(shp["nodes"])
    e_all = sum(shp["edges"])
    static_layers = 2 if model["model_type"] == "GNN" else ml
    total = (mlp_flops(n_all, mlp_sizes(static_in, F, F, static_layers))
             + mlp_flops(n_all, mlp_sizes(dynamic_in, F, F, ml))
             + mlp_flops(n_all, mlp_sizes(F, 2, F, ml)))   # decoder
    if model["edge_mlp"]:
        total += mlp_flops(e_all, mlp_sizes(edge_in, F, F, ml))
    for n_dst, n_src, e, K, fe, same, filters, gradient in layers(model, shp):
        proj = 2 * (n_src + n_dst) * 2 * F * H             # [x_s | x_d] of src and dst
        rest = mlp_flops(e, mlp_sizes(H, F, H, ml)[1:]) if ml > 1 else 0
        total += proj + 2 * e * fe * H + rest
        total += (2 * n_dst * F * F) * (K + 1 if filters else 0)
        total += K * e * F * (3 if gradient else 2)
    return total


def hop_bytes(model: dict, shp: dict, train: bool) -> int:
    """Bytes the hops of one model step of one graph need: forward, and
    with ``train`` also backward."""
    elem = ELEM_BYTES[model["compute_dtype"]]
    F = model["hid_features"]
    total = 0
    for n_dst, n_src, e, K, _, same, _, gradient in layers(model, shp):
        row = F * elem
        states = n_dst * row + (0 if same else n_src * row)
        fwd = states + e * 4 + e * row + n_dst * row
        bwd = (states + n_dst * row + 2 * e * row + e * 4 + n_src * row
               + (n_dst * row if gradient and not same else 0))
        total += K * (fwd + (bwd if train else 0))
    return total


def kernel_bytes(model: dict, shp: dict, train: bool) -> dict:
    """Bytes of each kernel family one model step of one graph needs."""
    return {"hop": hop_bytes(model, shp, train)}
