"""The ``meshgraphnet`` architecture and its cell ``mgn.train.b8``: its
counts by hand and pinned at the configuration's own grid, the modules
refusing what they do not describe, and whole runs of the cell on the CPU
at a tiny size (a 16x12 grid, 10 frames, latent 16, 2 blocks): clean it is
correct, with each fault planted it is not, and its TF32 control reads
further from the reference than the program."""
import json
import os

import pytest

from portbench import calibrate, compare, counts, faults, run
from portbench.architectures import meshgraphnet, swegnn
from portbench.reference import inputs
from portbench.tests.conftest import cell_spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "mgn.train.b8"
SEED = 2 ** 31 + 101
MGN = {"model_type": "MGN", "hid_features": 2, "mlp_layers": 2, "n_GNN_layers": 1,
       "compute_dtype": "float32"}
ONE_SCALE = {"nodes": [3], "edges": [4], "intra": []}


def tiny():
    spec = cell_spec(CELL, cut=False)
    cfg = spec["cfg"]
    cfg["grid"].update(nx=16, ny=12)
    cfg["frames"] = 10
    cfg["pad_multiple"] = 8
    cfg["model"].update(hid_features=16, n_GNN_layers=2)
    return spec


def test_forward_flops_by_hand():
    # node encoder 2*3*((3+6)*2 + 2*2), edge encoder 2*4*(1*2 + 2*2), decoder
    # 2*3*(2*2 + 2*2); the block: the edge MLP's first linear as [v_j | v_i] of
    # 3 nodes 2*3*4*2 and e of 4 edges 2*4*2*2, its last 2*4*2*2, the node MLP
    # 2*3*(4*2 + 2*2)
    assert meshgraphnet.forward_flops(MGN, ONE_SCALE, 3, 6, 1) == (
        132 + 48 + 48 + 48 + 32 + 32 + 72)
    assert meshgraphnet.KERNELS == {}
    assert meshgraphnet.kernel_bytes(MGN, ONE_SCALE, train=True) == {}


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 13])
def test_the_configurations_flops_are_pinned(seed):
    """A graph step of the 152x152 grid at the port's input widths ([area,
    DEM] and the water level, 3 frames of (h, |q|), the edge length)."""
    with open(os.path.join(HERE, "configs", "meshgraphnets-flood.json")) as f:
        cfg = json.load(f)
    assert cfg["architecture"] == "meshgraphnet"
    shp = counts.shapes(inputs.make_mesh(cfg["grid"], seed))
    assert shp["nodes"] == [23108] and shp["edges"] == [91812]
    assert meshgraphnet.forward_flops(cfg["model"], shp, 3, 6, 1) == 212_664_946_688


def test_each_architecture_refuses_the_others_models():
    mesh = inputs.make_mesh({"nx": 6, "ny": 4, "dx": 100.0, "num_scales": 1, "n_bc": 1}, 3)
    gnn = {"model_type": "GNN", "type_GNN": "SWEGNN", "hid_features": 2, "K": 1,
           "mlp_layers": 2, "n_GNN_layers": 1, "edge_mlp": True, "compute_dtype": "float32"}
    for module, model, name in ((meshgraphnet, gnn, "meshgraphnet"), (swegnn, MGN, "swegnn"),
                                (meshgraphnet, dict(MGN, learned_residuals="all"),
                                 "meshgraphnet"),
                                (meshgraphnet, dict(MGN, learned_residuals=True),
                                 "meshgraphnet")):
        with pytest.raises(ValueError, match=name):
            module.Reference(model, mesh, 3, "cpu")
        with pytest.raises(ValueError, match=name):
            module.kernel_bytes(model, ONE_SCALE, train=True)


def test_clean_run_is_correct():
    result, numbers = run.run_cell(tiny(), SEED, 0.2, False, "cpu", 0.0)
    assert result["correct"], numbers
    assert result["attempted"] >= 1


@pytest.mark.parametrize("fault", faults.FAULTS["train"])
def test_fault_is_caught(fault):
    with faults.planted(fault, "train"):
        result, numbers = run.run_cell(tiny(), SEED, 0.2, False, "cpu", 0.0)
    assert not result["correct"], numbers


def test_control_reads_further_out():
    spec = tiny()
    program = calibrate.reading(spec, SEED, "cpu")
    control = calibrate.reading(spec, SEED, "cpu", control=True)
    names = compare.limits(CELL)
    assert any(control[n] > 3 * program[n] for n in names), (program, control)
