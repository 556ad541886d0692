"""The port's data layer (data/interp.py, the lstsq slopes, data/augment.py,
the HDF5 store of data/io.py, the map-NetCDF path of data/netcdf.py, the
reference pickles of data/torch_compat.py, main.prepare_data on both data
paths, and compat/torch_import.py) against the JAX package, on the CPU.

The inputs: small synthetic simulations (8x8 grids, few solver substeps,
records of the 12x12 storm corpus for the HDF5 store), made from seeds with
numpy; reference pickles written by ``tests/pyg_fixture.py``; a reference
state dict built from a JAX-initialised MSGNN tree.

Tolerances:
- ``get_slopes`` and the lstsq ``process_record``: rtol 1e-10 (the same
  least-squares rows in the same order);
- interpolation, rotations of records, HDF5 records, map-NetCDF records,
  reference pickles, the validation split and ``prepare_data``'s samples:
  equal (rotations of processed features: atol 1e-12);
- the imported parameter trees: equal; their forwards within 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mswe_gnn_tpu import config as jax_config
from mswe_gnn_tpu import main as jax_main
from mswe_gnn_tpu.compat import torch_import as jax_import
from mswe_gnn_tpu.data import augment as jax_augment
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data import interp as jax_interp
from mswe_gnn_tpu.data import io as jax_io
from mswe_gnn_tpu.data import netcdf as jax_netcdf
from mswe_gnn_tpu.data import synthetic as jax_synthetic
from mswe_gnn_tpu.data import torch_compat as jax_compat
from mswe_gnn_tpu.models import msgnn as jax_msgnn
from mswe_gnn_tpu_torch import config as port_config
from mswe_gnn_tpu_torch import main as port_main
from mswe_gnn_tpu_torch.compat import torch_import as port_import
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params, to_numpy_tree
from mswe_gnn_tpu_torch.data import augment as port_augment
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data import interp as port_interp
from mswe_gnn_tpu_torch.data import io as port_io
from mswe_gnn_tpu_torch.data import netcdf as port_netcdf
from mswe_gnn_tpu_torch.data import synthetic as port_synthetic
from mswe_gnn_tpu_torch.data import torch_compat as port_compat
from mswe_gnn_tpu_torch.data.simulate import (random_dem_fn, random_hydrograph,
                                              run_diffusive_wave)
from mswe_gnn_tpu_torch.data.meshing import grid_mesh
from mswe_gnn_tpu_torch.models import msgnn as port_msgnn
from tests.pyg_fixture import write_reference_dataset
from tests.test_torch_port_batch import assert_graphs_equal
from tests.torch_port_common import numpy_tree, sample_pair

SMALL = dict(nx=8, ny=8, num_scales=2, total_hours=6, substeps=4)
SERIES = ("wd", "vx", "vy", "bc_per_length")


def assert_records_equal(got, want, timed=True):
    """Two records (either package) equal: series, forcing, meshes, the
    multiscale tables, the ghost cells and the scalars (``solver_seconds``
    only where ``timed``: a generated record carries its solver's wall
    time)."""
    for name in SERIES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert (got.forcing is None) == (want.forcing is None)
    if got.forcing is not None:
        np.testing.assert_array_equal(got.forcing, want.forcing)
    assert tuple(got.forcing_names) == tuple(want.forcing_names)
    assert got.temporal_res == want.temporal_res
    assert not timed or got.solver_seconds == want.solver_seconds
    assert len(got.mesh.meshes) == len(want.mesh.meshes)
    for s, (m, n) in enumerate(zip(got.mesh.meshes, want.mesh.meshes)):
        for f in dataclasses.fields(m):
            np.testing.assert_array_equal(getattr(m, f.name), getattr(n, f.name),
                                          err_msg=f"scale {s} {f.name}")
    for name in ("node_ptr", "edge_ptr", "intra_edge_ptr", "intra_edge_index"):
        np.testing.assert_array_equal(getattr(got.mesh, name), getattr(want.mesh, name))
    gg, wg = got.mesh.ghosts, want.mesh.ghosts
    assert (gg is None) == (wg is None)
    if gg is not None:
        assert gg.type_bc == wg.type_bc
        for name in ("ghost_nodes", "bc_faces", "edge_bc_length"):
            np.testing.assert_array_equal(getattr(gg, name), getattr(wg, name))


# ------------------------------------------------------------------ interp
@pytest.mark.parametrize("n,size", [(60, 150.0), (200, 80.0)])
def test_get_slopes_matches_jax(n, size):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 1000, (n, 2))
    dem = 2.0 + 0.003 * xy[:, 0] - 0.001 * xy[:, 1] + rng.normal(0, 0.05, n)
    for got, want in zip(port_interp.get_slopes(xy, dem, neighborhood_size=size),
                         jax_interp.get_slopes(xy, dem, neighborhood_size=size)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_lstsq_process_record_matches_jax():
    jrec = jax_synthetic.generate_simulation_record(1, **dict(SMALL, num_scales=3))
    prec = port_synthetic.generate_simulation_record(1, **dict(SMALL, num_scales=3))
    feats = dict(node_features={"slopes": True, "area": True, "DEM": True},
                 slope_method="lstsq")
    want = jax_dataset.process_record(jrec, jax_dataset.fit_dataset_scalers([jrec], {}),
                                      **feats)
    got = port_dataset.process_record(prec, port_dataset.fit_dataset_scalers([prec], {}),
                                      **feats)
    np.testing.assert_allclose(got.x_static, want.x_static, rtol=1e-10, atol=0)
    edge = port_dataset.process_record(prec, port_dataset.fit_dataset_scalers([prec], {}),
                                       node_features=feats["node_features"])
    assert np.abs(edge.x_static[:, :2] - got.x_static[:, :2]).max() > 0
    with pytest.raises(ValueError, match="slope_method"):
        port_dataset.process_record(prec, {}, node_features=feats["node_features"],
                                    slope_method="plane")


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_interpolation_matches_jax(method):
    """Scattered values onto points inside and outside the hull (NaN
    backfill under linear and cubic), one field and a [M, T] series."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 100, (80, 2))
    target = rng.uniform(-20, 120, (50, 2))
    value = np.sin(pts[:, 0] / 17.0) + pts[:, 1] / 50.0
    series = np.stack([value * (t + 1) for t in range(4)], axis=1)
    got = port_interp.interpolate_variable(target, pts, value, method=method)
    want = jax_interp.interpolate_variable(target, pts, value, method=method)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    got_t = port_interp.interpolate_temporal_variable(target, pts, series, method=method)
    np.testing.assert_array_equal(
        got_t, jax_interp.interpolate_temporal_variable(target, pts, series, method=method))
    assert got_t.shape == (50, 4)


# ----------------------------------------------------------------- augment
def test_rotations_match_jax():
    jrec = jax_synthetic.generate_simulation_record(2, **SMALL)
    prec = port_synthetic.generate_simulation_record(2, **SMALL)
    np.testing.assert_array_equal(port_augment.rotation_matrix(33.0),
                                  jax_augment.rotation_matrix(33.0))
    assert_records_equal(port_augment.rotate_record(prec, 33.0),
                         jax_augment.rotate_record(jrec, 33.0), timed=False)
    node = {"slopes": True, "area": True, "DEM": True}
    edge = {"edge_length": True, "edge_relative_distance": True}
    jproc = jax_dataset.process_record(jrec, jax_dataset.fit_dataset_scalers([jrec], {}),
                                       node_features=node, edge_features=edge)
    pproc = port_dataset.process_record(prec, port_dataset.fit_dataset_scalers([prec], {}),
                                        node_features=node, edge_features=edge)
    got = port_augment.rotate_processed(pproc, -71.0, node, edge)
    want = jax_augment.rotate_processed(jproc, -71.0, node, edge)
    np.testing.assert_allclose(got.x_static, want.x_static, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.edge_attr, want.edge_attr, rtol=0, atol=1e-12)
    assert np.abs(got.edge_attr[:, 1:3] - pproc.edge_attr[:, 1:3]).max() > 0


# ---------------------------------------------------------------- HDF5 store
@pytest.fixture(scope="module")
def store_records():
    """Port records: a storm-driven one (forcing on the record) and a calm one."""
    return [port_synthetic.generate_simulation_record(4, **dict(SMALL, storm=True)),
            port_synthetic.generate_simulation_record(5, **SMALL)]


def test_hdf5_records_cross_packages(store_records, tmp_path):
    """Records written by JAX read by the port and the reverse, shuffled and
    cut as the reference's loader does."""
    jax_path, port_path = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jax_io.save_records(jax_path, store_records)
    port_io.save_records(port_path, store_records)
    for kw in ({"seed": 0}, {"seed": 42, "size": 1}):
        got = port_io.load_records(jax_path, **kw)
        want = jax_io.load_records(port_path, **kw)
        assert len(got) == len(want) == (1 if "size" in kw else 2)
        for a, b in zip(got, want):
            assert_records_equal(a, b)
    for a, b in zip(port_io.load_records(jax_path, seed=0), store_records):
        assert_records_equal(a, b)


def test_lazy_flood_dataset_matches_jax(store_records, tmp_path):
    paths = [str(tmp_path / "a.h5"), str(tmp_path / "b.h5")]
    jax_io.save_records(paths[0], store_records[:1])
    jax_io.save_records(paths[1], store_records[1:])
    (tmp_path / "broken.h5").write_bytes(b"not a file")
    kw = dict(scalers=port_dataset.fit_dataset_scalers(store_records, {}), previous_t=2,
              rollout_steps=2, pad_multiple=8)
    with pytest.warns(UserWarning, match="unreadable"):
        got = port_io.LazyFloodDataset(paths + [str(tmp_path / "broken.h5")], **kw)
    want = jax_io.LazyFloodDataset(paths, **dict(kw, scalers=jax_dataset.fit_dataset_scalers(
        jax_io.load_records(paths[0], seed=0) + jax_io.load_records(paths[1], seed=0), {})))
    try:
        assert len(got) == len(want) > 4 and got.index == want.index
        assert dataclasses.astuple(got.spec) == dataclasses.astuple(want.spec)
        for i in (0, 3, len(got) - 1):
            assert_graphs_equal(got[i], want[i])
    finally:
        got.close()
        want.close()


# ---------------------------------------------------------------- map files
def grid_sim(seed, nx=8, ny=8, dx=100.0, hours=6):
    """A simulation on an nx x ny grid -> (mesh, hydrograph, BC faces, sim)
    (the JAX package's tests/test_netcdf.py, in the port's numpy)."""
    rng = np.random.default_rng(seed)
    dem_fn = random_dem_fn(rng, extent=nx * dx, relief=2.0)
    mesh = grid_mesh(nx, ny, dx, dem_fn)
    hydro = random_hydrograph(rng, total_hours=hours, dt_minutes=60.0)
    bc_faces = np.asarray([ny // 2, ny // 2 + 1], np.int64)
    return mesh, hydro, bc_faces, run_diffusive_wave(mesh, bc_faces, hydro, dt_minutes=60.0,
                                                    substeps=8)


def write_map_folder(folder, n=5, writer=port_netcdf.write_grid_map_netcdf, **kw):
    """``n`` grid map files with an overview.csv, DEM sidecars and
    hydrograph sidecars (.csv for even i, .npy for i = 1, none for the
    others: reconstructed from the depths) -> (dem folder, hydrograph
    folder)."""
    dem_dir, hyd_dir = folder / "dem", folder / "hyd"
    for d in (folder, dem_dir, hyd_dir):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        mesh, hydro, bc_faces, sim = grid_sim(seed=i)
        writer(str(folder / f"output_{i}_map.nc"), 8, 8, 100.0, sim.wd, sim.vx, sim.vy,
               bc_faces, dem=mesh.dem, **kw)
        pts = rng.uniform(-50, 850, (120, 2))
        np.savetxt(dem_dir / f"DEM_{i}.xyz",
                   np.column_stack([pts, 1.0 + 0.002 * pts[:, 0] - 0.001 * pts[:, 1]]))
        if i % 2 == 0:
            np.savetxt(hyd_dir / f"Hydrograph_{i}.csv",
                       np.column_stack([np.arange(len(hydro)), hydro]), delimiter=",")
        elif i == 1:
            np.save(hyd_dir / f"Hydrograph_{i}.npy", hydro)
    (folder / "overview.csv").write_text(
        "seed,mesh_num_faces,simulation_time[h],computation_time[s]\n"
        + "".join(f"{i},64,6.0,{10.0 + 1.5 * i}\n" for i in range(n)))
    return str(dem_dir), str(hyd_dir)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_map_folder_matches_jax(tmp_path, writer):
    """HDF5 map files (written by either package) with DEM and hydrograph
    sidecars: both packages' ``load_map_folder`` give equal records, solver
    seconds from overview.csv."""
    write = {"jax": jax_netcdf.write_grid_map_netcdf,
             "port": port_netcdf.write_grid_map_netcdf}[writer]
    dem_dir, hyd_dir = write_map_folder(tmp_path, n=4, writer=write)
    kw = dict(temporal_res=60.0, dem_folder=dem_dir, hydrograph_folder=hyd_dir)
    got = port_netcdf.load_map_folder(str(tmp_path), **kw)
    want = jax_netcdf.load_map_folder(str(tmp_path), **kw)
    assert [r.solver_seconds for r in got] == [10.0, 11.5, 13.0, 14.5]
    for a, b in zip(got, want):
        assert_records_equal(a, b)
    assert len(port_netcdf.load_map_folder(str(tmp_path), 60.0, limit=2)) == 2


def test_netcdf3_map_file_read_by_both_packages(tmp_path):
    """A classic NetCDF-3 file written by the port (scipy, int32 integers)
    reads as the same record in both packages, and as the record of the
    same data written as HDF5."""
    mesh, hydro, bc_faces, sim = grid_sim(seed=2)
    nc3, h5 = str(tmp_path / "output_0_map.nc"), str(tmp_path / "h5_map.nc")
    port_netcdf.write_grid_map_netcdf(nc3, 8, 8, 100.0, sim.wd, sim.vx, sim.vy, bc_faces,
                                      dem=mesh.dem, classic=True)
    port_netcdf.write_grid_map_netcdf(h5, 8, 8, 100.0, sim.wd, sim.vx, sim.vy, bc_faces,
                                      dem=mesh.dem)
    with open(nc3, "rb") as f:
        assert f.read(3) == b"CDF"
    got = port_netcdf.record_from_map_netcdf(nc3, hydro, 60.0, solver_seconds=3.0)
    assert_records_equal(got, jax_netcdf.record_from_map_netcdf(nc3, hydro, 60.0,
                                                                solver_seconds=3.0))
    assert_records_equal(got, port_netcdf.record_from_map_netcdf(h5, hydro, 60.0,
                                                                 solver_seconds=3.0))
    np.testing.assert_allclose(got.wd[:mesh.num_faces], sim.wd, rtol=1e-12)


def test_numerical_times_match_jax(tmp_path):
    p = tmp_path / "overview.csv"
    p.write_text("seed,mesh_num_faces,simulation_time[h],computation_time[s]\n"
                 "101,22880,96.0,427.638\n102,22880,96.0,608.3828\n7.0,10,12.0,5.5\n")
    for seeds, hours in (([101, 102, 7], None), ([102, 7], 48.0)):
        got = port_netcdf.numerical_times(str(p), seeds, model_hours=hours)
        np.testing.assert_array_equal(got, jax_netcdf.numerical_times(str(p), seeds,
                                                                      model_hours=hours))
    np.testing.assert_allclose(port_netcdf.numerical_times(str(p), [102], 48.0),
                               [608.3828 * 0.5])


# ------------------------------------------------------------ reference pickles
def test_reference_pickle_matches_jax(tmp_path):
    recs = [port_synthetic.generate_simulation_record(s, **SMALL) for s in range(4)]
    path = str(tmp_path / "ds.pkl")
    write_reference_dataset(path, recs)
    for kw in ({"seed": 0}, {"seed": 42, "size": 3}):
        got = port_compat.load_reference_pickle(path, **kw)
        want = jax_compat.load_reference_pickle(path, **kw)
        assert len(got) == len(want) == kw.get("size", 4)
        for a, b in zip(got, want):
            assert_records_equal(a, b)
    np.testing.assert_array_equal(port_compat.load_reference_pickle(path, seed=0)[2].wd,
                                  recs[2].wd.astype(np.float32))


@pytest.mark.parametrize("n", [3, 7, 80])
@pytest.mark.parametrize("val_prcnt", [0.25, 0.34, 0.1])
def test_validation_split_matches_sklearn(n, val_prcnt):
    from sklearn.model_selection import train_test_split

    items = list(range(100, 100 + n))
    for seed in (0, 381):
        want = train_test_split(items, test_size=val_prcnt, random_state=seed)
        got = port_main.train_test_split(items, val_prcnt, seed)
        assert [list(got[0]), list(got[1])] == [list(want[0]), list(want[1])]


def data_config(config_lib, dp, num_scales=2, **node):
    return config_lib.with_defaults({
        "dataset_parameters": dp,
        "temporal_dataset_parameters": {"rollout_steps": 2, "previous_t": 2},
        "synthetic_data": {"num_scales": num_scales, "pad_multiple": 8},
        "selected_node_features": {"area": True, "DEM": True, **node},
    })


def assert_prepared_equal(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert_graphs_equal(x, y)
    for a, b in zip(got[4], want[4]):
        assert_records_equal(a, b)


def test_prepare_data_on_reference_pickles_matches_jax(tmp_path):
    """A ``dataset_folder`` tree (train and test pickles): the same records,
    split and samples in both packages."""
    recs = [port_synthetic.generate_simulation_record(s, **SMALL) for s in range(8)]
    for sub, part in (("train", recs[:6]), ("test", recs[6:])):
        (tmp_path / sub).mkdir()
        write_reference_dataset(str(tmp_path / sub / "ds.pkl"), part)
    dp = {"dataset_folder": str(tmp_path), "train_dataset_name": "ds", "train_size": 6,
          "val_prcnt": 0.34, "seed": 42, "temporal_res": 60.0}
    got = port_main.prepare_data(data_config(port_config, dp))
    want = jax_main.prepare_data(data_config(jax_config, dp))
    assert (len(got[4]), port_main._solver_label({"dataset_parameters": dp})) == (2, "dhydro")
    assert_prepared_equal(got, want)


def test_prepare_data_on_a_map_folder_matches_jax(tmp_path):
    """A ``map_folder`` of HDF5 map files with DEM and hydrograph sidecars,
    2 scales (the coarse one re-meshed by the native mesh core), lstsq
    slopes as node features: the same samples in both packages."""
    dem_dir, hyd_dir = write_map_folder(tmp_path)
    dp = {"map_folder": str(tmp_path), "dem_folder": dem_dir, "hydrograph_folder": hyd_dir,
          "temporal_res": 60.0, "val_prcnt": 0.34, "seed": 0, "slope_method": "lstsq"}
    got = port_main.prepare_data(data_config(port_config, dp, slopes=True))
    want = jax_main.prepare_data(data_config(jax_config, dp, slopes=True))
    assert got[0][0].spec.num_scales == 2
    assert [r.solver_seconds for r in got[4]] == [16.0]
    assert_prepared_equal(got, want)


# ------------------------------------------------------------ torch_import
def reference_state_dict(tree, cfg) -> dict:
    """A JAX MSGNN parameter tree in the reference's state-dict layout
    (reference models/gnn.py, models/models.py:121-146): Linear weights
    ``[out, in]`` at even indices of each Sequential, PReLU after each."""
    sd = {}

    def mlp(prefix, p):
        for i, (lin, act) in enumerate(zip(p["layers"], p["acts"])):
            sd[f"{prefix}.{2 * i}.weight"] = np.asarray(lin["w"]).T
            if "b" in lin:
                sd[f"{prefix}.{2 * i}.bias"] = np.asarray(lin["b"])
            if "alpha" in act:
                sd[f"{prefix}.{2 * i + 1}.weight"] = np.asarray(act["alpha"])

    for name in ("edge_encoder", "dynamic_node_encoder", "static_node_encoder",
                 "node_decoder"):
        mlp(f"model.{name}", tree[name])
    for i, layer in enumerate(tree["intra_scale_gnn"]):
        mlp(f"model.intra_scale_gnn.{i}.edge_mlp", layer["edge_mlp"])
    for p, layer in enumerate(tree["gnn_processor"]):
        mlp(f"model.gnn_processor.{p}.edge_mlp", layer["edge_mlp"])
        for k, f in enumerate(layer["filters"]):
            sd[f"model.gnn_processor.{p}.filter_matrix.{k}.weight"] = np.asarray(f["w"]).T
    if "alpha" in tree["gnn_act"]:
        sd["model.gnn_activation.weight"] = np.asarray(tree["gnn_act"]["alpha"])
    sd["model.residual_weights"] = np.asarray(tree["residual_weights"])
    return sd


@pytest.mark.parametrize("gnn_activation", ["tanh", "prelu"])
def test_torch_import_matches_jax(tmp_path, monkeypatch, gnn_activation):
    """A reference checkpoint (``torch.save`` of a state dict built from a
    JAX-initialised tree) through both packages: the same config, the port's
    tree equal to JAX's and to ``load_jax_params`` of it, the forwards
    within 1e-5."""
    jg, pg = sample_pair(previous_t=2, rollout_steps=2, index=0)
    kw = dict(num_node_features=pg.x_static.shape[1] + pg.x_dynamic.shape[1],
              num_edge_features=pg.edge_attr.shape[1], num_scales=3, hid_features=8, K=2,
              mlp_layers=2, with_WL=True, previous_t=2, learned_residuals=True,
              gnn_activation=gnn_activation)
    jcfg = jax_msgnn.MSGNNConfig(**kw)
    tree = numpy_tree(jax_msgnn.init_msgnn(jax.random.PRNGKey(7), jcfg))
    path = str(tmp_path / "K2_F8.h5")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in reference_state_dict(tree, jcfg).items()}}, path)

    want_cfg, want = jax_import.load_msgnn_checkpoint(path, gnn_activation=gnn_activation)
    got_cfg, got = port_import.load_msgnn_checkpoint(path, device="cpu",
                                                     gnn_activation=gnn_activation)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert port_import.infer_msgnn_shape(port_import.load_state_dict(path)) == \
        jax_import.infer_msgnn_shape(jax_import.load_state_dict(path))
    got_np, want_np = to_numpy_tree(got), numpy_tree(want)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(want_np)
    for a, b, c in zip(jax.tree_util.tree_leaves(got_np), jax.tree_util.tree_leaves(want_np),
                       jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    bridged = to_numpy_tree(load_jax_params(want_np, got_cfg, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(got_np), jax.tree_util.tree_leaves(bridged)):
        np.testing.assert_array_equal(a, b)
    out = port_msgnn.apply_msgnn(got, got_cfg, pg).numpy()
    ref = np.asarray(jax.jit(lambda p, g: jax_msgnn.apply_msgnn(p, want_cfg, g))(want, jg))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_import.load_msgnn_checkpoint(path)
