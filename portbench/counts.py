"""What a model step needs, counted from the shapes of the graph and the
configuration, and the H100's published peaks: the yardstick of the
per-layer metrics ``model_mfu`` and ``hop_roofline``.

FLOPs are those of the matmuls and of the hops' arithmetic, in the least
form the model allows: the edge MLP's first linear over ``[x_s_j | x_s_i |
x_d_j | x_d_i | e_ji]`` is a projection a node plus an edge term, as any
implementation may compute it. Activations, normalisation, pooling and the
residual are not counted. A train step counts three forward passes a model
step (forward and backward); recomputation (remat) is not counted.

Hop bytes follow ``chip_smoke.py``'s bound (``hop_work``, ``hop_bwd_work``):
every input read once and every output written once, over the real edges
and nodes (no padding, no padded ELL slots).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}
# device kernels that implement a hop (forward and backward, ELL and band)
HOP_KERNELS = ("hop_fwd_kernel", "hop_bwd_kernel")


def mlp_flops(rows: int, sizes) -> int:
    return sum(2 * rows * fi * fo for fi, fo in sizes)


def mlp_sizes(fan_in: int, fan_out: int, hidden: int, layers: int):
    if layers == 1:
        return [(fan_in, fan_out)]
    return [(fan_in, hidden)] + [(hidden, hidden)] * (layers - 2) + [(hidden, fan_out)]


def shapes(mesh: dict) -> dict:
    """Real nodes and edges of each scale, and transfer edges of each
    level, of one graph of the raw mesh (``reference/inputs.py``)."""
    return {"nodes": [len(m["area"]) for m in mesh["meshes"]],
            "edges": [m["edge_index"].shape[1] for m in mesh["meshes"]],
            "intra": [t.shape[1] for t in mesh["intra"]]}


def layers(model: dict, shp: dict) -> list:
    """Every SWE-GNN layer of one forward pass as ``(n_dst, n_src, edges,
    K, edge_features, same_block, filters, gradient)``."""
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
