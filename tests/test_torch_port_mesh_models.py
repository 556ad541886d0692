"""The data x graph mesh for every model: the Cheb / TAG / GAT baselines and
MSGNN's learned pooling on row blocks (parallel/gspmd.py), against the JAX
package's sharded runs and the port's one-device runs on the CPU.

The samples are tests/test_torch_port_mesh.py's (12x12, 3 scales, rollout 2,
four distinct windows of one simulation); every model is at micro width
(``hid_features`` 8, K 2, 2 layers), its weights drawn with the port's init
and handed to JAX as the bridge's numpy tree. JAX runs on the 8 virtual CPU
devices of tests/conftest.py (jitted), the port on a 2 x 4 mesh of ``cpu``
entries, one thread. Float32, tolerances:

- ``rollout_batch`` atol 1e-4 against JAX, 1e-5 against each graph's own
  one-device port rollout;
- one train step (conservation 0.01): the loss rtol 1e-5, the parameters
  after the step rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:66-69),
  against JAX's sharded step for GAT and learned pooling and against the
  port's one-device step for Cheb and TAG;
- a ``Trainer`` epoch on the mesh, and a placed forward on an edge case,
  within 1e-5 of one device.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mswe_gnn_tpu import graph as jax_graph
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_simulation_record as jax_record
from mswe_gnn_tpu.models import gnn as jax_gnn
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.parallel import sharding as jax_sharding
from mswe_gnn_tpu.training import rollout as jax_rollout
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch.compat.jax_params import to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_simulation_record as port_record
from mswe_gnn_tpu_torch.graph import concat_graphs, stack_graphs
from mswe_gnn_tpu_torch.models import gnn as port_gnn
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.parallel import sharding
from mswe_gnn_tpu_torch.parallel.gspmd import RowModel
from mswe_gnn_tpu_torch.training import rollout as port_rollout
from mswe_gnn_tpu_torch.training import train as port_train
from tests.test_torch_port_mesh import CPU8, MULTIHOST, distinct, history, jcopy, make_samples
from tests.torch_port_common import without_subnormal_targets

CASES = ("GNN_L", "GNN_A", "GAT", "learned_pooling")
MICRO = dict(hid_features=8, K=2, mlp_layers=2, learned_residuals=True, with_WL=True)


@pytest.fixture(scope="module")
def samples():
    """(JAX samples, port samples) of tests/test_torch_port_mesh.py."""
    pairs = [without_subnormal_targets(a, b)
             for a, b in zip(make_samples(jax_dataset, jax_record),
                             make_samples(port_dataset, port_record))]
    return [a for a, _ in pairs], [b for _, b in pairs]


def model(case, g):
    """(JAX apply, JAX cfg, JAX params, port apply, port cfg, port params,
    multiscale) of ``case`` at micro width, the port's init on both sides."""
    kw = dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1], previous_t=g.previous_t, **MICRO)
    gen = torch.Generator().manual_seed(CASES.index(case))
    if case == "learned_pooling":
        kw.update(num_scales=3, learned_pooling=True)
        pcfg = port_msgnn.MSGNNConfig(**kw)
        pparams = port_msgnn.init_msgnn(gen, pcfg)
        jcfg, japply, papply = jax_msgnn.MSGNNConfig(**kw), jax_msgnn.apply_msgnn, \
            port_msgnn.apply_msgnn
    else:
        kw.update(type_gnn=case, n_gnn_layers=2)
        pcfg = port_gnn.GNNConfig(**kw)
        pparams = port_gnn.init_gnn(gen, pcfg)
        jcfg, japply, papply = jax_gnn.GNNConfig(**kw), jax_gnn.apply_gnn, port_gnn.apply_gnn
    jparams = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(pparams))
    return japply, jcfg, jparams, papply, pcfg, pparams, case == "learned_pooling"


@pytest.mark.parametrize("case", CASES)
def test_rollout_batch_matches_jax(samples, case):
    """A 2-step ``rollout_batch`` of 4 distinct samples on a 2 x 4 mesh
    against JAX's on its 2 x 4 mesh, and each graph against its own
    one-device rollout."""
    js, ps = samples
    japply, jcfg, jparams, papply, pcfg, pparams, _ = model(case, ps[0])
    steps = 2
    jbatch = jax_sharding.shard_batch(jax_graph.stack_graphs(js[:4]),
                                      jax_sharding.make_mesh(2, 4))
    want = np.asarray(jax.jit(jax_rollout.rollout_batch, static_argnums=(0, 2, 4))(
        japply, jparams, jcfg, jbatch, steps))
    placed = sharding.shard_batch(stack_graphs(distinct(ps)), sharding.make_mesh(2, 4, CPU8))
    assert all(len(r.devices) == 4 for r in placed.rows)
    got = port_rollout.rollout_batch(papply, pparams, pcfg, placed, steps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for i, g in enumerate(ps[:4]):
        own = port_rollout.rollout(papply, pparams, pcfg, g, steps, device="cpu")
        np.testing.assert_allclose(got[i].numpy(), own.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_the_mesh(samples, case):
    """One train step of 4 distinct samples (conservation 0.01) on a 2 x 4
    mesh: GAT and learned pooling against JAX's step on its 2 x 4 mesh,
    Cheb and TAG against the port's one-device step."""
    js, ps = samples
    japply, jcfg, jparams, papply, pcfg, pparams, multiscale = model(case, ps[0])
    opts = port_train.TrainerOptions(batch_size=4, learning_rate=1e-2, conservation=0.01)
    batch = stack_graphs(distinct(ps))

    def port_step(b):
        opt = port_train.make_optimizer(opts, steps_per_epoch=1)
        p = port_train.clone_tree(pparams)
        p, _, loss = port_train.train_step(p, opt.init(p), b, apply_fn=papply, cfg=pcfg,
                                           rollout_steps=2, opts=opts, multiscale=multiscale,
                                           optimizer=opt, device="cpu")
        return float(loss), jax.tree_util.tree_leaves(to_numpy_tree(p))

    if case in ("GAT", "learned_pooling"):
        jopts = jax_train.TrainerOptions(batch_size=4, learning_rate=1e-2, conservation=0.01)
        jopt = jax_train.make_optimizer(jopts, steps_per_epoch=1)
        jmesh = jax_sharding.make_mesh(2, 4)
        jp, _, jloss = jax_train.train_step(
            jax_sharding.replicate(jcopy(jparams), jmesh),
            jax_sharding.replicate(jopt.init(jcopy(jparams)), jmesh),
            jax_sharding.shard_batch(jax_graph.stack_graphs(js[:4]), jmesh),
            apply_fn=japply, cfg=jcfg, rollout_steps=2, opts=jopts, multiscale=multiscale,
            optimizer=jopt)
        want = float(jloss), [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    else:
        want = port_step(batch)
    loss, leaves = port_step(sharding.shard_batch(batch, sharding.make_mesh(2, 4, CPU8)))
    np.testing.assert_allclose(loss, want[0], rtol=1e-5)
    assert len(leaves) == len(want[1])
    for a, w in zip(leaves, want[1]):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["GAT", "learned_pooling"])
def test_trainer_with_mesh_fits(samples, case):
    """``Trainer(mesh=...)`` on a 2 x 4 mesh fits an epoch with a finite
    loss, its history the one-device Trainer's within 1e-5."""
    ps = samples[1]
    _, _, _, papply, pcfg, pparams, multiscale = model(case, ps[0])
    opts = port_train.TrainerOptions(batch_size=2, max_epochs=1, curriculum_epoch=1,
                                     max_rollout_steps=2, learning_rate=1e-3)
    hist = []
    for mesh in (sharding.make_mesh(2, 4, CPU8), None):
        tr = port_train.Trainer(papply, pcfg, pparams, opts, train_graphs=ps[:4],
                                val_graphs=ps[:3], multiscale=multiscale, mesh=mesh,
                                device="cpu")
        hist.append(tr.fit(max_epochs=1)[-1])
    assert np.isfinite(hist[0]["train_loss"])
    for k in ("train_loss", "val_loss", "val_CSI_005"):
        assert abs(hist[0][k] - hist[1][k]) < 1e-5, (k, hist)


def masked_in_edges(g, node):
    """``g`` with every in-edge of ``node`` masked: its only in-edges are
    padding."""
    mask = g.edge_mask.clone()
    mask[g.edge_index[1] == node] = 0.0
    return g.replace(edge_mask=mask)


def coarse_without_transfer(g, coarse):
    """``g`` with every transfer edge into the coarse node ``coarse`` (a
    global row of scale 1) masked."""
    mask = g.intra_edge_mask.clone()
    mask[g.intra_edge_index[0] == coarse] = 0.0
    return g.replace(intra_edge_mask=mask)


@pytest.mark.parametrize("edge_case", ["padded_edge", "masked_in_edges",
                                       "coarse_without_transfer"])
def test_edge_cases_match_one_device(samples, edge_case):
    """Each edge case split over 2 and 3 devices gives the one-device
    forward: a block that owns a padded edge (every baseline), a node whose
    only in-edges are masked (every baseline; GAT gives it the bias), a
    coarse node without a transfer edge (learned pooling: it pools to
    zero)."""
    g = concat_graphs(distinct(samples[1], 2))
    n = g.num_nodes
    if edge_case == "coarse_without_transfer":
        cases = ("learned_pooling",)
        spec = g.spec
        coarse = spec.node_ptr[1] + spec.node_counts[1] * 3 // 4
        g = coarse_without_transfer(g, coarse)
        assert g.intra_edge_mask[g.intra_edge_index[0] == coarse].sum() == 0
    else:
        cases = ("GNN_L", "GNN_A", "GAT")
        if edge_case == "masked_in_edges":
            node = int(g.edge_index[1][n // 2 < g.edge_index[1]][0])
            g = masked_in_edges(g, node)
            assert (g.edge_index[1] == node).any()
            assert g.edge_mask[g.edge_index[1] == node].sum() == 0
    for parts in (2, 3):
        for case in cases:
            _, _, _, papply, pcfg, pparams, _ = model(case, g)
            row = RowModel(pcfg, g, ["cpu"] * parts)
            if edge_case == "padded_edge":
                assert any((m == 0).any() for m in row.plans["mask"])
            got = row(pparams, g, row.encode_edges(pparams))
            torch.testing.assert_close(got, papply(pparams, pcfg, g), atol=1e-5, rtol=0)


def cli_config(case):
    """tests/test_torch_port_mesh.py's micro multichip config (F=8, K=1,
    2 scales, 4 simulations of 8x8), 1 epoch, for ``case``: learned pooling
    on a gspmd 2 x 4 mesh; GAT under ring_halo at 4 parts, which falls back
    to the mesh; learned pooling under ring_halo at 2 parts, which raises as
    JAX's ring path asserts."""
    cfg = yaml.safe_load(yaml.safe_dump(MULTIHOST))
    cfg["trainer_options"]["max_epochs"] = 1
    if case == "learned_pooling":
        cfg["models"]["learned_pooling"] = True
        cfg["parallel"] = {"mode": "gspmd", "data": 2, "graph": 4}
    elif case == "GAT":
        cfg["models"].update(model_type="GNN", type_GNN="GAT")
        cfg["parallel"] = {"mode": "ring_halo", "graph": 4}
    else:
        cfg["models"]["learned_pooling"] = True
        cfg["parallel"] = {"mode": "ring_halo", "graph": 2}
    return cfg


@pytest.mark.parametrize("case", ["learned_pooling", "GAT", "ring_halo_learned_pooling"])
def test_cli_trains_every_model_on_the_mesh(tmp_path, monkeypatch, capsys, case):
    """``main train`` of a micro config whose model did not run on the mesh
    before: learned pooling on a 2 x 4 mesh, GAT under ring_halo (JAX's
    fallback line, then the 1 x 4 mesh) train an epoch to a finite history
    and summary; learned pooling under ring_halo raises."""
    monkeypatch.setenv("MSWE_DATA_CACHE", str(tmp_path / "cache"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cli_config(case)))
    n = 8 if case == "learned_pooling" else 4 if case == "GAT" else 2
    argv = ["train", "--config", str(path), "--out", str(tmp_path / "run"),
            "--device", ",".join(["cpu"] * n)]
    if case == "ring_halo_learned_pooling":
        with pytest.raises(ValueError, match="learned_pooling"):
            port_main.main(argv)
        return
    assert port_main.main(argv) == 0
    text = capsys.readouterr().out
    mesh = "data=2 x graph=4" if case == "learned_pooling" else "data=1 x graph=4"
    assert f"device mesh: {mesh}" in text
    assert (port_main.FALLBACK in text) == (case == "GAT")
    hist = history(tmp_path / "run")
    assert [r["epoch"] for r in hist] == [0] and np.isfinite(hist[0]["train_loss"])
    assert os.path.exists(tmp_path / "run" / "summary.json")
