"""The swegnn architecture's counts against counts made by hand on a tiny
graph and against the integers of each configuration's graph; and its
reference and counts refusing the models it does not describe."""
import json
import os

import pytest

from portbench import counts
from portbench.architectures import swegnn
from portbench.reference import inputs

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNN = {"model_type": "GNN", "type_GNN": "SWEGNN", "hid_features": 2, "K": 1, "mlp_layers": 2,
       "n_GNN_layers": 1, "edge_mlp": True, "compute_dtype": "float32"}
ONE_SCALE = {"nodes": [3], "edges": [4], "intra": []}


def test_forward_flops_by_hand():
    # encoders 2*3*(3*2+2*2) + 2*3*(6*2+2*2), decoder 2*3*(2*2+2*2), edge encoder
    # 2*4*(1*2+2*2); the layer: projections of [x_s | x_d] (4 -> 4) of 3 sources
    # and 3 destinations 2*6*4*4, edge term 2*4*2*4, the MLP's last linear 2*4*4*2,
    # filters H_0 and H_1 2*(2*3*2*2), one hop's difference, product and sum 4*2*3
    assert swegnn.forward_flops(GNN, ONE_SCALE, 3, 6, 1) == (
        60 + 96 + 48 + 48 + 192 + 64 + 64 + 48 + 24)


def test_hop_bytes_by_hand():
    # float32 rows of 8 bytes; forward: the state 24, slot sources 16, flux 32,
    # output 24; backward: the state 24, the upstream gradient 24, flux in and
    # its gradient out 64, slot sources 16, the state's gradient 24
    assert swegnn.hop_bytes(GNN, ONE_SCALE, train=False) == 96
    assert swegnn.hop_bytes(GNN, ONE_SCALE, train=True) == 96 + 152
    assert swegnn.kernel_bytes(GNN, ONE_SCALE, train=True) == {"hop": 96 + 152}


def test_msgnn_layers_walk_the_v_cycle():
    model = {"model_type": "MSGNN", "hid_features": 64, "K": 5}
    shp = {"nodes": [100, 25, 7], "edges": [400, 90, 20], "intra": [100, 25]}
    got = swegnn.layers(model, shp)
    # down 0, 1; up 2, un-pool 2->1, up 1, un-pool 1->0, up 0
    assert [(n, e, k, same) for n, _, e, k, _, same, _, _ in got] == [
        (100, 400, 5, True), (25, 90, 5, True), (7, 20, 5, True), (25, 25, 1, False),
        (25, 90, 5, True), (100, 100, 1, False), (100, 400, 5, True)]


def test_bf16_halves_the_state_bytes():
    bf16 = dict(GNN, compute_dtype="bfloat16")
    # the slot sources stay int32: 16 bytes forward, 16 backward
    assert swegnn.hop_bytes(bf16, ONE_SCALE, train=True) == (96 + 152 - 32) // 2 + 32


# a graph step of each configuration's 152x152 grid, whatever the seed: the
# forward FLOPs at the port's input widths ([area, DEM] and the water level,
# 3 frames of (h, |q|), the edge length) and the hop bytes forward, and
# forward and backward
PINNED = {"msgnn-bench": (28_532_538_368, 242_922_192, 678_664_096),
          "gnn-pareto": (22_075_008_000, 714_048_320, 2_016_487_040)}


@pytest.mark.parametrize("config,seed", [(c, s) for c in PINNED for s in (7, 2 ** 31 + 13)])
def test_each_configurations_counts_are_pinned(config, seed):
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    assert cfg["architecture"] == "swegnn"
    model = cfg["model"]
    shp = counts.shapes(inputs.make_mesh(cfg["grid"], seed))
    flops, fwd, both = PINNED[config]
    assert swegnn.forward_flops(model, shp, 2 + int(model["with_WL"]), 6, 1) == flops
    assert swegnn.kernel_bytes(model, shp, train=False) == {"hop": fwd}
    assert swegnn.kernel_bytes(model, shp, train=True) == {"hop": both}


@pytest.mark.parametrize("change", [{"type_GNN": "GAT"}, {"learned_pooling": True}])
def test_swegnn_refuses_what_it_does_not_describe(change):
    base = GNN if "type_GNN" in change else {
        "model_type": "MSGNN", "hid_features": 2, "K": 1, "mlp_layers": 2, "edge_mlp": True,
        "compute_dtype": "float32"}
    model = dict(base, **change)
    shp = {"nodes": [3, 2], "edges": [4, 2], "intra": [3]}
    mesh = inputs.make_mesh({"nx": 6, "ny": 4, "dx": 100.0, "num_scales": 2, "n_bc": 1}, 3)
    with pytest.raises(ValueError, match="swegnn"):
        swegnn.Reference(model, mesh, 3, "cpu")
    for count in (lambda: swegnn.forward_flops(model, shp, 3, 6, 1),
                  lambda: swegnn.kernel_bytes(model, shp, train=True)):
        with pytest.raises(ValueError, match="swegnn"):
            count()
