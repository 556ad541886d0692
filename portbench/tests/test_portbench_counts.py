"""counts.py against counts made by hand on a tiny graph."""
from portbench import counts

GNN = {"model_type": "GNN", "hid_features": 2, "K": 1, "mlp_layers": 2, "n_GNN_layers": 1,
       "edge_mlp": True, "compute_dtype": "float32"}
ONE_SCALE = {"nodes": [3], "edges": [4], "intra": []}


def test_forward_flops_by_hand():
    # encoders 2*3*(3*2+2*2) + 2*3*(6*2+2*2), decoder 2*3*(2*2+2*2), edge encoder
    # 2*4*(1*2+2*2); the layer: projections of [x_s | x_d] (4 -> 4) of 3 sources
    # and 3 destinations 2*6*4*4, edge term 2*4*2*4, the MLP's last linear 2*4*4*2,
    # filters H_0 and H_1 2*(2*3*2*2), one hop's difference, product and sum 4*2*3
    assert counts.forward_flops(GNN, ONE_SCALE, 3, 6, 1) == (
        60 + 96 + 48 + 48 + 192 + 64 + 64 + 48 + 24)


def test_hop_bytes_by_hand():
    # float32 rows of 8 bytes; forward: the state 24, slot sources 16, flux 32,
    # output 24; backward: the state 24, the upstream gradient 24, flux in and
    # its gradient out 64, slot sources 16, the state's gradient 24
    assert counts.hop_bytes(GNN, ONE_SCALE, train=False) == 96
    assert counts.hop_bytes(GNN, ONE_SCALE, train=True) == 96 + 152


def test_msgnn_layers_walk_the_v_cycle():
    model = {"model_type": "MSGNN", "hid_features": 64, "K": 5}
    shp = {"nodes": [100, 25, 7], "edges": [400, 90, 20], "intra": [100, 25]}
    got = counts.layers(model, shp)
    # down 0, 1; up 2, un-pool 2->1, up 1, un-pool 1->0, up 0
    assert [(n, e, k, same) for n, _, e, k, _, same, _, _ in got] == [
        (100, 400, 5, True), (25, 90, 5, True), (7, 20, 5, True), (25, 25, 1, False),
        (25, 90, 5, True), (100, 100, 1, False), (100, 400, 5, True)]


def test_bf16_halves_the_state_bytes():
    bf16 = dict(GNN, compute_dtype="bfloat16")
    # the slot sources stay int32: 16 bytes forward, 16 backward
    assert counts.hop_bytes(bf16, ONE_SCALE, train=True) == (96 + 152 - 32) // 2 + 32
