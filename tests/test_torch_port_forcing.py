"""Storm forcing in the port (data/synthetic.py's storm fields, the records
cache, temporal samples, unions, the forced MSGNN's rollout and its
pushforward gradients) against the JAX package, on the CPU.

The inputs: records of a 12x12 grid in 3 scales with few solver substeps,
their storm drawn by ``generate_simulation_record(storm=True)`` (a storm
that drives the solver) or attached by ``add_storm_forcing``; scalers with
``forcing_scaler: standard``; the weights JAX-initialised and converted
through ``compat/jax_params.py``; the targets' subnormal entries 0 for both
packages (XLA on the CPU flushes them).

Tolerances:
- storm fields, forced records, the npz round trip, temporal samples,
  unions and device-assembled unions: bit-equal (the same numpy);
- the forced rollout: f32 atol 1e-4;
- the forced pushforward loss on a union of 2: rtol 1e-5, its gradients
  within 1e-4 * max|leaf| + 1e-6 of ``jax.grad`` (jitted).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import graph as jax_graph
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data import synthetic as jax_synthetic
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu.training import rollout as jax_rollout
from mswe_gnn_tpu.training import train as jax_train
from mswe_gnn_tpu_torch import graph as port_graph
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data import npz_store
from mswe_gnn_tpu_torch.data import synthetic as port_synthetic
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from mswe_gnn_tpu_torch.training import rollout as port_rollout
from mswe_gnn_tpu_torch.training import train as port_train
from tests.torch_port_common import numpy_tree, without_subnormal_targets
from tests.test_torch_port_batch import assert_graphs_equal

STORM_KW = dict(nx=12, ny=12, num_scales=3, total_hours=8, substeps=4, storm=True)
SCALERS = {"area_scaler": "standard", "edge_length_scaler": "standard",
           "forcing_scaler": "standard"}
RECORD_FIELDS = ("wd", "vx", "vy", "bc_per_length", "forcing")


def assert_records_equal(got, want):
    for name in RECORD_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.forcing_names == want.forcing_names == ("WX", "WY", "P")
    assert got.temporal_res == want.temporal_res
    for s, (m, n) in enumerate(zip(got.mesh.meshes, want.mesh.meshes)):
        for f in dataclasses.fields(m):
            np.testing.assert_array_equal(getattr(m, f.name), getattr(n, f.name),
                                          err_msg=f"scale {s} {f.name}")


@pytest.fixture(scope="module")
def records():
    """(JAX records, port records): two storm-driven simulations."""
    return ([jax_synthetic.generate_simulation_record(s, **STORM_KW) for s in (0, 1)],
            [port_synthetic.generate_simulation_record(s, **STORM_KW) for s in (0, 1)])


def forced_samples(ds, recs, rollout_steps):
    scalers = ds.fit_dataset_scalers(recs, SCALERS)
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 8)
                          for r in recs])
    return [s for r in recs for s in ds.to_temporal_samples(
        ds.process_record(r, scalers), spec, previous_t=2, rollout_steps=rollout_steps)]


@pytest.fixture(scope="module")
def samples(records):
    """(JAX, port) forced temporal samples of both records, with 2 rollout
    steps and with the full rollout."""
    jrecs, precs = records
    out = []
    for steps in (2, -1):
        pairs = [without_subnormal_targets(a, b) for a, b in
                 zip(forced_samples(jax_dataset, jrecs, steps),
                     forced_samples(port_dataset, precs, steps))]
        out += [[a for a, _ in pairs], [b for _, b in pairs]]
    return out


def test_make_storm_fields_matches_jax():
    xy = np.random.default_rng(4).uniform(0, 1200, (90, 2))
    for kw in ({}, {"wind_scale": 2.0, "pressure_scale": 1500.0}):
        want = jax_synthetic.make_storm_fields(xy, 7, np.random.default_rng(5), **kw)
        got = port_synthetic.make_storm_fields(xy, 7, np.random.default_rng(5), **kw)
        assert got.shape == (90, 3, 7) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_storm_records_match_jax(records):
    """A storm that drives the solver: the same record bit for bit, its
    water unlike the calm record's; ``add_storm_forcing`` on a calm record
    too."""
    jrecs, precs = records
    for j, p in zip(jrecs, precs):
        assert_records_equal(p, j)
        assert p.forcing.shape == (p.mesh.num_nodes, 3, p.wd.shape[1])
    calm = port_synthetic.generate_simulation_record(0, **dict(STORM_KW, storm=False))
    assert calm.forcing is None and np.abs(calm.wd - precs[0].wd).max() > 1e-3
    jcalm = jax_synthetic.generate_simulation_record(0, **dict(STORM_KW, storm=False))
    want = jax_synthetic.add_storm_forcing(jcalm, seed=3, wind_scale=1.0)
    got = port_synthetic.add_storm_forcing(calm, seed=3, wind_scale=1.0)
    assert_records_equal(got, want)
    np.testing.assert_array_equal(got.wd, calm.wd)


def test_forced_record_through_npz_store(records, tmp_path):
    _, precs = records
    calm = port_synthetic.generate_simulation_record(2, **dict(STORM_KW, storm=False))
    path = str(tmp_path / "records.npz")
    npz_store.save_records(path, [precs[0], calm, precs[1]])
    back = npz_store.load_records(path)
    assert_records_equal(back[0], precs[0])
    assert_records_equal(back[2], precs[1])
    assert back[1].forcing is None and back[1].forcing_names == ()
    np.testing.assert_array_equal(back[1].wd, calm.wd)
    assert npz_store.record_arrays(back[0])["forcing"].shape == precs[0].forcing.shape


def test_forced_samples_match_jax(samples):
    jg, pg, jfull, pfull = samples
    assert len(pg) == len(jg) > 4
    for a, b in zip(pg + pfull, jg + jfull):
        assert b.forcing is not None and tuple(a.forcing.shape) == b.forcing.shape
        assert_graphs_equal(a, b)


@pytest.mark.parametrize("idx", [[0, 1, 2], [5, 0, 5]])
def test_forced_unions_match_jax(samples, idx):
    """concat_graphs of forced samples against JAX's, and the device plan's
    union of the stacked samples against the host union."""
    jg, pg, _, _ = samples
    union = port_graph.concat_graphs([pg[i] for i in idx])
    assert union.forcing.shape[0] == union.num_nodes
    assert_graphs_equal(union, jax_graph.concat_graphs([jg[i] for i in idx]))
    stacked = port_graph.stack_graphs(pg)
    plan = port_graph.DeviceConcatPlan(pg[0].spec, len(idx))
    assert_graphs_equal(plan(stacked, np.asarray(idx)), union)


def model_pair(g, hid=8, K=2):
    """(JAX cfg, JAX params, port cfg, port params): the node features count
    the forcing columns, as main.build_experiment_model does."""
    kw = dict(num_node_features=(g.x_static.shape[1] + g.forcing.shape[1]
                                 + g.x_dynamic.shape[1]),
              num_edge_features=g.edge_attr.shape[1], num_scales=3,
              previous_t=g.previous_t, hid_features=hid, K=K, learned_residuals=True,
              with_WL=True)
    jcfg, pcfg = jax_msgnn.MSGNNConfig(**kw), port_msgnn.MSGNNConfig(**kw)
    jparams = jax_msgnn.init_msgnn(jax.random.PRNGKey(5), jcfg)
    return jcfg, jparams, pcfg, load_jax_params(numpy_tree(jparams), pcfg, device="cpu")


def test_forced_rollout_matches_jax(samples):
    _, _, jfull, pfull = samples
    jcfg, jparams, pcfg, pparams = model_pair(pfull[0])
    steps = 4
    np.testing.assert_array_equal(
        port_rollout.with_step_forcing(pfull[0], 2).x_static.numpy(),
        np.asarray(jax_rollout.with_step_forcing(jfull[0], 2).x_static))
    want = np.asarray(jax.jit(lambda p, g: jax_rollout.rollout(
        jax_msgnn.apply_msgnn, p, jcfg, g, steps))(jparams, jfull[0]))
    got = port_rollout.rollout(port_msgnn.apply_msgnn, pparams, pcfg, pfull[0], steps,
                               device="cpu").numpy()
    assert got.shape == (pfull[0].num_nodes, 2, steps) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the forcing reaches the prediction
    calm = port_rollout.rollout(port_msgnn.apply_msgnn, pparams, pcfg,
                                pfull[0].replace(forcing=pfull[0].forcing * 0), steps,
                                device="cpu").numpy()
    assert np.abs(calm - got).max() > 1e-4


def test_forced_pushforward_loss_and_grads_match_jax(samples):
    """The pushforward loss of a union of 2 forced samples with the
    conservation term on, and its gradients, against jax.grad (float32, 2
    steps, remat on the port's side)."""
    jg, pg, _, _ = samples
    jcfg, jparams, pcfg, pparams = model_pair(pg[0], hid=8, K=2)
    ju, pu = jax_graph.concat_graphs(jg[1:3]), port_graph.concat_graphs(pg[1:3])
    opt_kw = dict(batch_size=2, velocity_scaler=7.0, conservation=0.5)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jax_train.pushforward_loss(jax_msgnn.apply_msgnn, p, jcfg, ju, 2,
                                             jax_train.TrainerOptions(**opt_kw), True)))(jparams)
    loss, grads = port_train.loss_and_grads(port_msgnn.apply_msgnn, pparams, pcfg, pu, 2,
                                            port_train.TrainerOptions(remat=True, **opt_kw),
                                            True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = to_numpy_tree(grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(numpy_tree(want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6)


def test_trainer_fits_forced_samples(samples):
    """The Trainer takes forced samples at batch 2: its same-layout check
    stacks them and the device plan's unions carry the forcing."""
    _, pg, _, pfull = samples
    _, _, pcfg, pparams = model_pair(pg[0], hid=8, K=1)
    opts = port_train.TrainerOptions(batch_size=2, max_epochs=1, curriculum_epoch=0,
                                     max_rollout_steps=2, seed=3)
    trainer = port_train.Trainer(port_msgnn.apply_msgnn, pcfg, pparams, opts, pg[:4],
                                 pfull[:1], device="cpu")
    history = trainer.fit()
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    stacked, _ = trainer._device_copy(trainer.train_graphs, 2)
    assert isinstance(stacked.forcing, torch.Tensor)
    assert stacked.forcing.shape[:2] == (4, pg[0].num_nodes)
