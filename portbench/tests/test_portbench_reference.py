"""The frozen input generator against the port's, and the plain reference
against the port, on the CPU at a tiny size: the reference follows the port
to float32 round-off where the port computes in float32."""
import numpy as np
import pytest
import torch

from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.data.simulate import random_dem_fn
from mswe_gnn_tpu_torch.data.synthetic import make_multiscale_grid
from mswe_gnn_tpu_torch.training.rollout import rollout
from mswe_gnn_tpu_torch.training.train import (TrainerOptions, clone_tree, make_optimizer,
                                               train_step)

from portbench import modes, system
from portbench.reference import inputs
from portbench.reference import model as ref_model

F32 = {"compute_dtype": "float32"}


@pytest.mark.parametrize("nx,ny,scales", [(16, 12, 3), (20, 20, 2), (10, 14, 1)])
def test_frozen_mesh_is_the_ports(nx, ny, scales):
    mesh = inputs.make_mesh({"nx": nx, "ny": ny, "dx": 100.0, "num_scales": scales,
                             "n_bc": 2}, seed=9)
    rng = np.random.default_rng(9)
    port = make_multiscale_grid(nx, ny, 100.0, scales,
                                random_dem_fn(rng, extent=nx * 100.0, relief=4.0), n_bc=2)
    for ours, theirs in zip(mesh["meshes"], port.meshes):
        assert np.array_equal(ours["edge_index"], theirs.dual_edge_index)
        assert np.array_equal(ours["face_xy"], theirs.face_xy)
        np.testing.assert_allclose(ours["dem"], theirs.dem, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ours["face_distance"], theirs.face_distance, rtol=1e-15)
    assert np.array_equal(system.port_mesh(mesh).intra_edge_index, port.intra_edge_index)
    assert np.array_equal(mesh["ghosts"]["ghost_nodes"], port.ghosts.ghost_nodes)


def test_inputs_repeat_for_a_seed_and_keep_their_sizes():
    grid = {"nx": 16, "ny": 12, "dx": 100.0, "num_scales": 3, "n_bc": 2}
    a, b, c = (inputs.make_mesh(grid, s) for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    sa, sb, sc = (inputs.make_scenarios(m, 10, 2, s)
                  for m, s in ((a, 2 ** 31 + 5), (b, 2 ** 31 + 5), (c, 7)))
    assert np.array_equal(a["meshes"][0]["dem"], b["meshes"][0]["dem"])
    assert np.array_equal(sa[1]["wd"], sb[1]["wd"])
    assert not np.array_equal(sa[1]["wd"], sc[1]["wd"])
    for m in (a, c):
        assert [x["edge_index"].shape for x in m["meshes"]] == \
            [x["edge_index"].shape for x in a["meshes"]]


@pytest.mark.parametrize("cell", ["msgnn.rollout.b1", "gnn.train.b8"])
def test_reference_rollout_follows_the_port(tiny_cell, cell):
    spec = tiny_cell(cell)
    cfg = spec["cfg"]
    cfg["model"].update(F32)
    mesh = inputs.make_mesh(cfg["grid"], 5)
    scen = inputs.make_scenarios(mesh, cfg["frames"], 2, 5)
    sample = system.port_samples(mesh, scen, cfg)[1][0]
    mcfg, params, apply_fn = system.build(cfg, sample, 7, "cpu")
    steps = sample.y.shape[-1]
    got = rollout(apply_fn, params, mcfg, sample, steps, device="cpu")
    ref = spec["arch"].Reference(cfg["model"], mesh, cfg["previous_t"], "cpu")
    want = ref_model.rollout(ref, params, ref_model.features(mesh, scen[1], 3), steps)
    rows = modes.real_rows(sample.spec, 1, 0, [len(m["area"]) for m in mesh["meshes"]])
    assert float((got[rows] - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("cell", ["msgnn.train.b8", "gnn.train.b8"])
def test_reference_train_steps_follow_the_port(tiny_cell, cell):
    spec = tiny_cell(cell)
    cfg = spec["cfg"]
    cfg["model"].update(F32)
    cfg["train"]["rollout_steps"] = 3
    mesh = inputs.make_mesh(cfg["grid"], 5)
    scen = inputs.make_scenarios(mesh, cfg["frames"], 4, 5)
    starts = [[0, 4], [2, 1], [3, 3], [1, 0]]
    samples = system.port_samples(mesh, scen, cfg, starts)
    mcfg, params, apply_fn = system.build(cfg, samples[0][0], 7, "cpu")
    before = clone_tree(params)
    opts = TrainerOptions(batch_size=4, velocity_scaler=7.0, remat=True)
    optimizer = make_optimizer(opts, 1)
    state = optimizer.init(params)
    losses = []
    for u in range(2):
        union = system.unions([s[u] for s in samples], 4)[0]
        _, _, loss = train_step(params, state, union, apply_fn=apply_fn, cfg=mcfg,
                                rollout_steps=3, opts=opts, multiscale=cell.startswith("msgnn"),
                                optimizer=optimizer, device="cpu")
        losses.append(float(loss))
    ref = spec["arch"].Reference(cfg["model"], mesh, cfg["previous_t"], "cpu")
    feats = [ref_model.features(mesh, s, 3) for s in scen]
    batches = [[(feats[g], starts[g][u]) for g in range(4)] for u in range(2)]
    ref_losses, _, after = ref_model.train_steps(ref, before, batches, cfg["train"])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for p, q in zip(tree_leaves(params), after):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("cell", ["msgnn.rollout.b1", "gnn.train.b8"])
def test_the_benchmark_writes_every_weight(tiny_cell, cell):
    """Every parameter of the port's tree is one the benchmark draws or
    sets, and the draw repeats for a seed."""
    cfg = tiny_cell(cell)["cfg"]
    mesh = inputs.make_mesh(cfg["grid"], 1)
    sample = system.port_samples(mesh, inputs.make_scenarios(mesh, cfg["frames"], 1, 1),
                                 cfg)[0][0]
    _, a, _ = system.build(cfg, sample, 2 ** 31 + 9, "cpu")
    _, b, _ = system.build(cfg, sample, 2 ** 31 + 9, "cpu")
    written = {id(t) for t, _ in system.linear_leaves(a) + system.fixed_leaves(a)}
    assert written == {id(t) for t in tree_leaves(a)}
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
