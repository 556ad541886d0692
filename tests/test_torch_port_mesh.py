"""Data x graph parallelism of the port (parallel/sharding.py, parallel/gspmd.py,
the vmap batch layout of training/, the mesh and the multi-process launch of
main.py, dryrun.py) against the JAX package on the CPU.

Each JAX function runs on the 8 virtual CPU devices of tests/conftest.py,
each port function on a mesh of ``cpu`` entries; the inputs are the
samples of tests/test_models.py::make_samples (12x12, 3 scales, rollout 2)
built by both packages, four distinct time windows of one simulation, the
weights JAX's (``init_msgnn``, K=1, F=8, as tests/test_parallel.py) handed to
the port through compat/jax_params.py; the targets' subnormal entries are 0
for both (XLA on the CPU flushes them). Float32, tolerances:

- forward and rollout atol 1e-4 against JAX; each graph of a batch against
  its own single-graph port rollout atol 1e-5;
- the loss rtol 1e-5, the parameters after one step rtol 1e-4 / atol 1e-5
  (tests/test_parallel.py:66-69);
- the placement specs equal JAX's ``PartitionSpec`` leaf by leaf;
- the two-process CLI's history equals the one-process run of the same
  mesh within 1e-5.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mswe_gnn_tpu import graph as jax_graph
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_simulation_record as jax_record
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.parallel import sharding as jax_sharding
from mswe_gnn_tpu.training import rollout as jax_rollout
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_simulation_record as port_record
from mswe_gnn_tpu_torch.dryrun import dryrun_multichip
from mswe_gnn_tpu_torch.graph import concat_graphs, stack_graphs
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.parallel import sharding
from mswe_gnn_tpu_torch.parallel.gspmd import RowModel, row_model
from mswe_gnn_tpu_torch.training import rollout as port_rollout
from mswe_gnn_tpu_torch.training import train as port_train
from tests.torch_port_common import SCALER_KINDS, numpy_tree, without_subnormal_targets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


def make_samples(ds, record, rollout=2):
    rec = record(0, nx=12, ny=12, num_scales=3, total_hours=6, substeps=4)
    scalers = ds.fit_dataset_scalers([rec], SCALER_KINDS)
    spec = ds.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), pad_multiple=8)
    return ds.to_temporal_samples(ds.process_record(rec, scalers), spec, previous_t=2,
                                  rollout_steps=rollout)


@pytest.fixture(scope="module")
def problem():
    """(JAX samples, port samples, JAX cfg, JAX params, port cfg, port
    params): four distinct windows first, the model of tests/test_parallel.py."""
    pairs = [without_subnormal_targets(a, b)
             for a, b in zip(make_samples(jax_dataset, jax_record),
                             make_samples(port_dataset, port_record))]
    js, ps = [a for a, _ in pairs], [b for _, b in pairs]
    g = js[0]
    kw = dict(num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1], num_scales=3, hid_features=8, K=1,
              previous_t=g.previous_t, learned_residuals=True, with_WL=True)
    jcfg, pcfg = jax_msgnn.MSGNNConfig(**kw), port_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(0), jcfg)
    pparams = load_jax_params(numpy_tree(jparams), pcfg, device="cpu")
    return js, ps, jcfg, jparams, pcfg, pparams


def distinct(graphs, n=4):
    """The first ``n`` graphs, checked to differ pairwise (a batch of copies
    would hide a replica that reads another replica's graph)."""
    out = graphs[:n]
    for i in range(n):
        for j in range(i):
            assert not torch.equal(out[i].x_dynamic, out[j].x_dynamic)
    return out


def jcopy(tree):
    return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), tree)


# ---------------------------------------------------------------- placement

@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (2, 3)])
@pytest.mark.parametrize("b", [4, 3])
def test_placement_specs_match_jax(problem, shape, b):
    """``batch_sharding`` and ``union_sharding`` give every tensor field
    JAX's spec, and ``place`` splits as the node features' spec says: the
    graphs over the data rows where the batch axis (a union: the node axis)
    is split, else all on row 0; each row over its graph devices where the
    node axis is split, else on its first device."""
    js, ps = problem[:2]
    jmesh = jax_sharding.make_mesh(*shape)
    mesh = sharding.make_mesh(*shape, devices=CPU8)
    cases = [("stacked", jax_sharding.batch_sharding(jmesh, jax_graph.stack_graphs(js[:b])),
              sharding.batch_sharding(mesh, stack_graphs(ps[:b]))),
             ("union", jax_sharding.union_sharding(jmesh, jax_graph.concat_graphs(js[:b])),
              sharding.union_sharding(mesh, concat_graphs(ps[:b])))]
    for layout, jspecs, pspecs in cases:
        want = {f.name: tuple(getattr(jspecs, f.name).spec)
                for f in dataclasses.fields(jspecs)
                if hasattr(getattr(jspecs, f.name), "spec")}
        assert pspecs == want
        x = want["x_static"]
        split_rows = x != () and (x[0] == ("data", "graph") if layout == "union"
                                  else x[0] == "data")
        split_graph = x != () and (x[0] == ("data", "graph") if layout == "union"
                                   else x[1] == "graph")
        placed = sharding.place(stack_graphs(ps[:b]), np.arange(b), mesh, layout=layout)
        counts = [len(r.index) for r in placed.rows]
        assert sum(counts) == b and placed.layout == layout
        assert (counts == [len(c) for c in np.array_split(np.arange(b), shape[0])]
                if split_rows else counts[0] == b)
        assert all(r.devices == (mesh[i] if split_graph else mesh[i][:1])
                   for i, r in enumerate(placed.rows))


def test_placement_devices_and_rows(problem):
    """Each row holds its own graphs' union on its first device, each block
    of its row model lies on its plan's device and the blocks cover the
    scale's rows; the row model is kept across placements whose unions
    share their tables, and rebuilt where they do not."""
    ps, pcfg = problem[1], problem[4]
    batch = stack_graphs(distinct(ps))
    mesh = sharding.make_mesh(2, 4, CPU8)
    placed = sharding.shard_batch(batch, mesh)
    assert [r.index.tolist() for r in placed.rows] == [[0, 1], [2, 3]]
    for r, row in zip(range(2), placed.rows):
        assert row.devices == mesh[r] and row.graph.num_graphs == 2
        assert row.graph.x_static.device == mesh[r][0]
        want = concat_graphs([ps[i] for i in row.index])
        assert torch.equal(row.graph.x_dynamic, want.x_dynamic)
        model = row_model(row, pcfg)
        for i, plan in enumerate(model.plans["proc"]):
            assert sum(t.shape[0] for t in plan["groups"][0]["tab"]) == \
                row.graph.spec.node_counts[i]
        for plan in model.plans["proc"] + model.plans["unpool"]:
            for key in ("tab", "mask", "out_table"):
                for block, d in zip(plan["groups"][0][key], mesh[r]):
                    assert (block[0] if key == "out_table" else block).device == d
    again = sharding.shard_batch(stack_graphs(distinct(ps)[::-1]), mesh)
    assert row_model(again.rows[0], pcfg) is row_model(placed.rows[1], pcfg)
    other = again.rows[0]
    other.graph = other.graph.replace(edge_attr=other.graph.edge_attr + 1)
    assert row_model(other, pcfg) is not row_model(placed.rows[0], pcfg)


def test_unstack_union_inverts_concat(problem):
    ps = problem[1]
    union = concat_graphs(distinct(ps))
    stacked = stack_graphs(distinct(ps))
    back = sharding.unstack_union(union)
    for f in dataclasses.fields(stacked):
        a, b = getattr(back, f.name), getattr(stacked, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert back.spec == stacked.spec
    refold = sharding.fold(back)
    assert all(torch.equal(getattr(refold, f.name), getattr(union, f.name))
               for f in dataclasses.fields(union)
               if isinstance(getattr(union, f.name), torch.Tensor))


# ---------------------------------------------------------------- rollout and steps

def test_rollout_batch_matches_jax(problem):
    """``rollout_batch`` of 4 distinct samples, stacked on one device and
    placed on a 2 x 4 mesh, against JAX's ``rollout_batch`` of the batch
    sharded on its 2 x 4 mesh; each graph against its own rollout."""
    js, ps, jcfg, jparams, pcfg, pparams = problem
    steps = 2
    jbatch = jax_sharding.shard_batch(jax_graph.stack_graphs(js[:4]),
                                      jax_sharding.make_mesh(2, 4))
    want = np.asarray(jax.jit(jax_rollout.rollout_batch, static_argnums=(0, 2, 4))(
        jax_msgnn.apply_msgnn, jparams, jcfg, jbatch, steps))
    batch = stack_graphs(distinct(ps))
    placed = sharding.shard_batch(batch, sharding.make_mesh(2, 4, CPU8))
    for got in (port_rollout.rollout_batch(port_msgnn.apply_msgnn, pparams, pcfg, batch,
                                           steps, device="cpu"),
                port_rollout.rollout_batch(port_msgnn.apply_msgnn, pparams, pcfg, placed,
                                           steps)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        for i, g in enumerate(ps[:4]):
            own = port_rollout.rollout(port_msgnn.apply_msgnn, pparams, pcfg, g, steps,
                                       device="cpu")
            np.testing.assert_allclose(got[i].numpy(), own.numpy(), atol=1e-5)


@pytest.mark.parametrize("layout", ["stacked", "union"])
def test_train_step_matches_jax_sharded(problem, layout):
    """One train step of 4 distinct samples (conservation 0.01) on a 2 x 4
    mesh and on one device against JAX's step on its 2 x 4 mesh
    (``shard_batch`` / ``shard_union_batch``, tests/test_parallel.py:41-101)."""
    js, ps, jcfg, jparams, pcfg, pparams = problem
    jopts = jax_train.TrainerOptions(batch_size=4, learning_rate=1e-2, conservation=0.01)
    jopt = jax_train.make_optimizer(jopts, steps_per_epoch=1)
    jmesh = jax_sharding.make_mesh(2, 4)
    if layout == "stacked":
        jb = jax_sharding.shard_batch(jax_graph.stack_graphs(js[:4]), jmesh)
        batch = stack_graphs(distinct(ps))
    else:
        jb = jax_sharding.shard_union_batch(jax_graph.concat_graphs(js[:4]), jmesh)
        batch = concat_graphs(distinct(ps))
    jp, _, jloss = jax_train.train_step(
        jax_sharding.replicate(jcopy(jparams), jmesh),
        jax_sharding.replicate(jopt.init(jcopy(jparams)), jmesh), jb,
        apply_fn=jax_msgnn.apply_msgnn, cfg=jcfg, rollout_steps=2, opts=jopts,
        multiscale=True, optimizer=jopt)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    mesh = sharding.make_mesh(2, 4, CPU8)
    placed = (sharding.shard_batch(batch, mesh) if layout == "stacked"
              else sharding.shard_union_batch(batch, mesh))
    opts = port_train.TrainerOptions(batch_size=4, learning_rate=1e-2, conservation=0.01)
    for b in (placed, batch):
        opt = port_train.make_optimizer(opts, steps_per_epoch=1)
        p = port_train.clone_tree(pparams)
        p, _, loss = port_train.train_step(p, opt.init(p), b, apply_fn=port_msgnn.apply_msgnn,
                                           cfg=pcfg, rollout_steps=2, opts=opts,
                                           multiscale=True, optimizer=opt, device="cpu")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        got = jax.tree_util.tree_leaves(to_numpy_tree(p))
        for a, w in zip(got, want):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)


def test_eval_step_stacked_matches_jax(problem):
    """``eval_step`` of a stacked batch (placed on a 2 x 4 mesh, and on one
    device) against JAX's vmap branch."""
    js, ps, jcfg, jparams, pcfg, pparams = problem
    opts = port_train.TrainerOptions()
    want = jax_train.eval_step(jparams, jax_graph.stack_graphs(js[:4]),
                               apply_fn=jax_msgnn.apply_msgnn, cfg=jcfg, steps=2,
                               opts=jax_train.TrainerOptions(), multiscale=True)
    batch = stack_graphs(distinct(ps))
    for b in (batch, sharding.shard_batch(batch, sharding.make_mesh(2, 4, CPU8))):
        got = port_train.eval_step(pparams, b, apply_fn=port_msgnn.apply_msgnn, cfg=pcfg,
                                   steps=2, opts=opts, multiscale=True, device="cpu")
        for k, v in want.items():
            assert abs(got[k] - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, got[k], v)


@pytest.mark.parametrize("layout", ["vmap", "concat"])
def test_trainer_with_mesh_fits(problem, layout):
    """``Trainer(mesh=...)`` (tests/test_parallel.py:104-116) fits an epoch
    with a finite loss, and its history equals the one-device Trainer's of
    the same layout within 1e-5."""
    ps, pcfg, pparams = problem[1], problem[4], problem[5]
    opts = port_train.TrainerOptions(batch_size=2, max_epochs=1, curriculum_epoch=1,
                                     max_rollout_steps=2, learning_rate=1e-3)
    hist = []
    for mesh in (sharding.make_mesh(2, 4, CPU8), None):
        tr = port_train.Trainer(port_msgnn.apply_msgnn, pcfg, pparams, opts,
                                train_graphs=ps[:4], val_graphs=ps[:3], mesh=mesh,
                                batch_layout=layout, device="cpu")
        hist.append(tr.fit(max_epochs=1)[-1])
    assert np.isfinite(hist[0]["train_loss"])
    for k in ("train_loss", "val_loss", "val_CSI_005"):
        assert abs(hist[0][k] - hist[1][k]) < 1e-5, (k, hist)


def test_row_model_covers_every_model(problem):
    """The single-scale SWE-GNN split over 3 devices, and the Cheb baseline
    and learned pooling split over 2 and 3, equal their one-device forwards;
    a data-parallel step of each of the two (graph = 1) equals its
    one-device step."""
    ps = problem[1]
    g = concat_graphs(distinct(ps, 2))
    kw = dict(num_node_features=g.num_node_features, num_edge_features=g.edge_attr.shape[1],
              num_scales=3, previous_t=2, device="cpu")
    cfg, params, apply_fn = build_model({"model_type": "GNN", "hid_features": 8, "K": 2}, **kw)
    model = RowModel(cfg, g, ["cpu"] * 3)
    got = model(params, g, model.encode_edges(params))
    torch.testing.assert_close(got, apply_fn(params, cfg, g), atol=1e-5, rtol=0)
    opts = port_train.TrainerOptions(batch_size=4)
    batch = stack_graphs(distinct(ps))
    mesh = sharding.make_mesh(4, 1, CPU8)
    for model_cfg in ({"model_type": "GNN", "type_GNN": "GNN_L", "hid_features": 8},
                      {"model_type": "MSGNN", "learned_pooling": True, "hid_features": 8}):
        cfg_b, params_b, apply_b = build_model(model_cfg, **kw)
        want = apply_b(params_b, cfg_b, g)
        for parts in (2, 3):
            model = RowModel(cfg_b, g, ["cpu"] * parts)
            got = model(params_b, g, model.encode_edges(params_b))
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        args = (apply_b, params_b, cfg_b)
        multiscale = model_cfg["model_type"] == "MSGNN"
        loss_m, grads_m = port_train.loss_and_grads(*args, sharding.shard_batch(batch, mesh), 2,
                                                    opts, multiscale)
        loss_1, grads_1 = port_train.loss_and_grads(*args, batch, 2, opts, multiscale)
        assert abs(float(loss_m) - float(loss_1)) <= 1e-5 * abs(float(loss_1))
        for a, b in zip(tree_leaves(grads_m), tree_leaves(grads_1)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_find_max_batch_size(problem, monkeypatch):
    """A power of two at most the graph count; only running out of memory
    ends the probe."""
    ps, pcfg, pparams = problem[1], problem[4], problem[5]
    opts = port_train.TrainerOptions(max_rollout_steps=1)
    args = (port_msgnn.apply_msgnn, pcfg, pparams, ps[:3], opts)
    assert port_train.find_max_batch_size(*args, device="cpu") == 2
    real = port_train.train_step

    def oom_at(n, err):
        def step(p, s, batch, **kw):
            if batch.x_static.shape[0] >= n:
                raise err
            return real(p, s, batch, **kw)
        return step

    monkeypatch.setattr(port_train, "train_step", oom_at(2, torch.cuda.OutOfMemoryError()))
    assert port_train.find_max_batch_size(*args, device="cpu") == 1
    monkeypatch.setattr(port_train, "train_step", oom_at(2, ValueError("not memory")))
    with pytest.raises(ValueError, match="not memory"):
        port_train.find_max_batch_size(*args, device="cpu")


def test_dryrun_multichip():
    """dryrun.py's mesh step (2 x 2) and 4-way ring step give finite losses."""
    out = dryrun_multichip(["cpu"] * 4)
    assert set(out) == {"mesh_loss", "ring_loss"}
    assert all(np.isfinite(v) for v in out.values())


# ---------------------------------------------------------------- the CLI

MULTIHOST = yaml.safe_load("""
dataset_parameters: {temporal_res: 60, val_prcnt: 0.34, seed: 7}
temporal_dataset_parameters: {rollout_steps: 1, previous_t: 2}
models: {model_type: MSGNN, hid_features: 8, K: 1, mlp_layers: 2, seed: 1}
trainer_options: {batch_size: 4, max_epochs: 2, curriculum_epoch: 1, patience: 5,
                  velocity_scaler: 1, conservation: 0}
lr_info: {learning_rate: 0.003, gamma: 0.7, step_size: 20}
synthetic_data: {n_sims: 4, nx: 8, ny: 8, num_scales: 2, total_hours: 6.0, substeps: 2,
                 seed: 0, pad_multiple: 8}
parallel: {mode: gspmd, data: 2, graph: 1}
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def history(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_cli_matches_one_process(tmp_path, monkeypatch):
    """``main train`` as two processes (gloo, one ``cpu`` device each) on
    tests/test_multihost_main.py's config, stopped after one epoch
    (``--epoch-budget``, exit 75) and relaunched, process 1 with an output
    directory of its own (no shared autosave): process 0 resumes and hands
    its state over, both exit 0, process 0 writes the artifacts, and the
    history equals one process's uninterrupted run of the same 2 x 1 mesh
    within 1e-5."""
    cfg_path = tmp_path / "mh.yaml"
    cfg_path.write_text(yaml.safe_dump(MULTIHOST))
    env = dict(os.environ, MSWE_DATA_CACHE=str(tmp_path / "cache"), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("MSWE_DATA_CACHE", env["MSWE_DATA_CACHE"])
    assert port_main.main(["train", "--config", str(cfg_path), "--out", str(tmp_path / "one"),
                           "--device", "cpu,cpu"]) == 0

    def launch(budget):
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mswe_gnn_tpu_torch.main", "train", "--config",
             str(cfg_path), "--out", str(tmp_path / ("two" if pid == 0 else "two_1")),
             "--device", "cpu", "--dist-coordinator", f"localhost:{port}",
             "--dist-num-processes", "2", "--dist-process-id", str(pid)]
            + (["--epoch-budget", str(budget)] if budget else []),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for pid, out in enumerate(outs):
            assert f"rank {pid} of 2 (local {pid} of 2), backend gloo" in out, out[-4000:]
        return [p.returncode for p in procs], outs

    codes, outs = launch(1)
    assert codes == [port_main.EXIT_RELAUNCH] * 2, outs[0][-4000:] + outs[1][-4000:]
    codes, outs = launch(None)
    for pid, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"process {pid} failed:\n{out[-4000:]}"
    assert "resumed from epoch 1" in outs[0] and "resumed" not in outs[1]
    assert not (tmp_path / "two_1" / "autosave").exists()
    assert (tmp_path / "two" / "best" / "meta.json").exists()
    assert (tmp_path / "two" / "summary.json").exists()
    assert '"test_CSI_005"' in outs[0] and '"test_CSI_005"' not in outs[1]
    one, two = history(tmp_path / "one"), history(tmp_path / "two")
    assert [r["epoch"] for r in two] == [0, 1]
    for a, b in zip(one, two):
        for k in ("train_loss", "val_loss", "val_CSI_005"):
            assert abs(a[k] - b[k]) < 1e-5, (k, a, b)
