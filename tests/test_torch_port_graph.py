"""The port's host-side data path against the JAX package's: on the same
synthetic records (generate_dataset(4, seed=0, nx=16, ny=16, num_scales=3,
total_hours=12, substeps=8)), every array is equal, exactly — both are the
same numpy code, and the graph tensors hold the same numbers and dtypes as
the JAX arrays."""
import dataclasses

import numpy as np
import pytest
import torch

from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.meshing import containment_transfer_edges as jax_transfer
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.meshing import grid_mesh, nearest_center
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate
from mswe_gnn_tpu_torch.graph import FloodGraph
from tests.torch_port_common import GEN_KW, temporal_samples

N_RECORDS = 4


@pytest.fixture(scope="module")
def records():
    return jax_generate(N_RECORDS, **GEN_KW), port_generate(N_RECORDS, **GEN_KW)


def test_records_equal(records):
    jax_recs, port_recs = records
    for jr, pr in zip(jax_recs, port_recs):
        for name in ("wd", "vx", "vy", "bc_per_length"):
            np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name))
        jm, pm = jr.mesh, pr.mesh
        for name in ("node_ptr", "edge_ptr", "intra_edge_ptr", "intra_edge_index"):
            np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name))
        for jmesh, pmesh in zip(jm.meshes, pm.meshes):
            for f in dataclasses.fields(pmesh):
                np.testing.assert_array_equal(getattr(pmesh, f.name),
                                              getattr(jmesh, f.name), err_msg=f.name)
        np.testing.assert_array_equal(pm.ghosts.ghost_nodes, jm.ghosts.ghost_nodes)
        np.testing.assert_array_equal(pm.ghosts.edge_bc_length, jm.ghosts.edge_bc_length)


@pytest.mark.parametrize("previous_t,rollout_steps", [(2, 4), (3, -1)])
def test_flood_graphs_equal_field_by_field(records, previous_t, rollout_steps):
    jax_recs, port_recs = records
    jspec, jgraphs = temporal_samples(jax_dataset, jax_recs, previous_t, rollout_steps)
    pspec, pgraphs = temporal_samples(port_dataset, port_recs, previous_t, rollout_steps)
    assert dataclasses.astuple(pspec) == dataclasses.astuple(jspec)
    assert len(pgraphs) == len(jgraphs)
    for jg, pg in zip(jgraphs, pgraphs):
        compared = 0
        for f in dataclasses.fields(FloodGraph):
            got = getattr(pg, f.name)
            if isinstance(got, torch.Tensor):
                want = np.asarray(getattr(jg, f.name))
                assert got.numpy().dtype == want.dtype, f.name
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
                compared += 1
            elif f.name in ("previous_t", "bc_kind", "temporal_res"):
                assert got == getattr(jg, f.name), f.name
        assert compared == 21      # every tensor field incl. y; no forcing here
        assert pg.forcing is None and jg.forcing is None


def test_nearest_center_matches_kdtree(rng):
    """The numpy search that replaces scipy's KD-tree in the port."""
    from scipy.spatial import cKDTree

    pts = rng.uniform(0, 10, (700, 2))
    centers = rng.uniform(0, 10, (90, 2))
    np.testing.assert_array_equal(nearest_center(pts, centers, chunk=64),
                                  cKDTree(centers).query(pts)[1])
    fine = grid_mesh(12, 10, 1.0, lambda x, y: x * 0)
    coarse = grid_mesh(6, 5, 2.0, lambda x, y: x * 0)
    from mswe_gnn_tpu_torch.data.meshing import containment_transfer_edges
    np.testing.assert_array_equal(containment_transfer_edges(fine, coarse),
                                  jax_transfer(fine, coarse))


def test_graph_to_moves_every_tensor(records):
    _, port_recs = records
    _, graphs = temporal_samples(port_dataset, port_recs[:1], 2, 2)
    g = graphs[0].replace(ell_cache={"scales": ((torch.zeros(2),),)})
    moved = g.to("meta")
    for f in dataclasses.fields(FloodGraph):
        val = getattr(moved, f.name)
        if isinstance(val, torch.Tensor):
            assert val.device.type == "meta", f.name
    assert moved.ell_cache["scales"][0][0].device.type == "meta"
    assert moved.spec == g.spec


@pytest.mark.parametrize("kw", [{"storm": True}])
def test_unported_generator_options_raise(kw):
    """Storm forcing, once unported here, no longer raises: the record
    carries the three forcing fields on every node and frame (its parity
    with JAX is in tests/test_torch_port_forcing.py)."""
    (rec,) = port_generate(1, seed=0, nx=8, ny=8, num_scales=2, total_hours=2,
                           substeps=2, **kw)
    assert rec.forcing_names == ("WX", "WY", "P")
    assert rec.forcing.shape == (rec.wd.shape[0], 3, rec.wd.shape[1])
    assert np.isfinite(rec.forcing).all()


def test_lstsq_slopes_raise(records):
    """lstsq slopes, once unported here, no longer raise: the features are
    finite and shaped as the edge method's (their parity with JAX is in
    tests/test_torch_port_data.py)."""
    _, port_recs = records
    lstsq = port_dataset.process_record(port_recs[0], {}, node_features={"slopes": True},
                                        slope_method="lstsq").x_static
    edge = port_dataset.process_record(port_recs[0], {},
                                       node_features={"slopes": True}).x_static
    assert lstsq.shape == edge.shape
    assert np.isfinite(np.asarray(lstsq)).all()


def test_bench_problem_graph_matches_bench_py():
    """mswe_gnn_tpu_torch/bench_problem.py draws the bench state in the same
    order as bench.py:75-120, so a small version of the bench graph is the
    same graph in both packages."""
    import bench

    _, _, _, jg, _ = bench.build_bench_problem(nx=16, ny=16, T=6, hid=8, K=1)
    from mswe_gnn_tpu_torch.bench_problem import build_bench_sample

    pg, _ = build_bench_sample(nx=16, ny=16, T=6)
    assert dataclasses.astuple(pg.spec) == dataclasses.astuple(jg.spec)
    for f in dataclasses.fields(FloodGraph):
        got = getattr(pg, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg, f.name)),
                                          err_msg=f.name)


def test_ell_aggregate_matches_jax(records, rng):
    """``graph.ell_aggregate`` against JAX's (graph.py:424-427) on the
    sample's own in-edge table: random messages [E, 5], float32, summed in
    the same slot order, within 1e-6."""
    import jax.numpy as jnp

    from mswe_gnn_tpu.graph import ell_aggregate as jax_ell_aggregate
    from mswe_gnn_tpu_torch.graph import ell_aggregate

    _, jgraphs = temporal_samples(jax_dataset, records[0], 2, 4)
    _, pgraphs = temporal_samples(port_dataset, records[1], 2, 4)
    jg, pg = jgraphs[0], pgraphs[0]
    msgs = rng.normal(size=(pg.edge_attr.shape[0], 5)).astype(np.float32)
    want = np.asarray(jax_ell_aggregate(jnp.asarray(msgs), jg.in_edge_table,
                                        jg.in_edge_mask))
    got = ell_aggregate(torch.from_numpy(msgs), pg.in_edge_table, pg.in_edge_mask)
    assert got.shape == want.shape == (pg.num_nodes, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("step", [0, 1, 3])
def test_bc_midpoint_matches_jax(records, step):
    """``rollout.bc_midpoint`` against JAX's (rollout.py:31-38), as
    tests/test_rollout.py:55 holds JAX's: the mean of the last two entries
    of window ``step + 1``; float32, within 1e-7 relative."""
    import jax.numpy as jnp

    from mswe_gnn_tpu.training.rollout import bc_midpoint as jax_bc_midpoint
    from mswe_gnn_tpu_torch.training.rollout import bc_midpoint

    _, jgraphs = temporal_samples(jax_dataset, records[0], 3, 4)
    _, pgraphs = temporal_samples(port_dataset, records[1], 3, 4)
    jg, pg = jgraphs[0], pgraphs[0]
    want = np.asarray(jax_bc_midpoint(jg, jnp.asarray(step)))
    got = bc_midpoint(pg, step).numpy()
    bcv = pg.bc_values.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    np.testing.assert_allclose(got, bcv[:, step + 2: step + 4].mean(1), rtol=1e-6)
    assert np.abs(want).sum() > 0
