"""Boundaries of the PyTorch port that every slice keeps:

- ``mswe_gnn_tpu_torch``, ``chip_smoke.py`` and ``kernel_ab.py`` import nothing of JAX, its
  libraries or the JAX package (an AST scan of every import);
- the entry points (the CLI's ``main`` included) run on the GPU unless the
  caller names a device, and raise where there is none, with no silent CPU
  fallback;
- the package, its data layer and its CLI import where h5py and sklearn are
  missing (as on the GPU machine): an HDF5 file then raises an error that
  names h5py, and a classic NetCDF-3 map file still reads;
- the package, its CLI and its figures module import where matplotlib and
  wandb are missing (as on the GPU machine), and import neither on the way;
- the suite runs PyTorch on one thread (tests/torch_port_common.py).
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mswe_gnn_tpu_torch import resolve_device
from mswe_gnn_tpu_torch.models import build_model, msgnn
from mswe_gnn_tpu_torch.training.rollout import rollout
from tests.torch_port_common import sample_pair

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mswe_gnn_tpu")


def port_sources():
    files = sorted((ROOT / "mswe_gnn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = port_sources()
    assert len(files) > 15
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"mswe_gnn_tpu_torch/{m}.py" for m in (
        "native", "config", "main", "data/triangulate", "data/npz_store", "data/synthetic",
        "data/meshing", "utils/metrics", "utils/analysis", "utils/logging", "ops/segment",
        "models/convs", "models/gnn", "data/interp", "data/augment", "data/io",
        "data/netcdf", "data/torch_compat", "compat/torch_import", "parallel/sharding",
        "parallel/gspmd", "dryrun", "utils/visualization")} <= scanned
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in files
           for m in imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from mswe_gnn_tpu.graph import FloodGraph\n"
                     "import jax.numpy as jnp\n")
    assert sorted(imported_modules(probe)) == ["jax.numpy", "mswe_gnn_tpu.graph"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


MODEL_KW = dict(num_node_features=6, num_edge_features=1, num_scales=3, previous_t=2)


def test_resolve_device(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_model_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model({"hid_features": 8}, **MODEL_KW)
    cfg, params, _ = build_model({"hid_features": 8}, device="cpu", **MODEL_KW)
    assert params["node_decoder"]["layers"][0]["w"].device.type == "cpu"


def test_gnn_entry_points_without_device_raise_without_cuda(no_cuda):
    """The single-scale GNN of every type and MSGNN with learned pooling:
    ``build_model`` and ``rollout`` raise without a device and run with
    ``device='cpu'``; ``prepare_graph`` on a GNN config builds its cache."""
    from mswe_gnn_tpu_torch.models import prepare_graph

    _, g = sample_pair(previous_t=2, rollout_steps=2, index=0, num_scales=1)
    kw = dict(MODEL_KW, num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1], num_scales=1)
    for model in [{"model_type": "GNN", "type_GNN": k, "hid_features": 8, "K": 2}
                  for k in ("SWEGNN", "GNN_L", "GNN_A", "GAT")]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(model, **kw)
        cfg, params, apply_fn = build_model(model, device="cpu", **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rollout(apply_fn, params, cfg, g, steps=1)
        assert rollout(apply_fn, params, cfg, g, steps=1, device="cpu").shape == (
            g.num_nodes, 2, 1)
        prepared = prepare_graph(params, cfg, g)
        assert (prepared.ell_cache is not None) == (model["type_GNN"] == "SWEGNN")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model({"hid_features": 8, "learned_pooling": True}, **MODEL_KW)
    _, params, _ = build_model({"hid_features": 8, "learned_pooling": True}, device="cpu",
                               **MODEL_KW)
    assert "pooling_mlp" in params


def test_main_without_device_raises_without_cuda(no_cuda, tmp_path):
    from mswe_gnn_tpu_torch import main as port_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["eval", "--ckpt", str(tmp_path), "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["train", "--out", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()


def test_rollout_without_device_raises_without_cuda(no_cuda):
    _, g = sample_pair(previous_t=2, rollout_steps=2, index=0)
    kw = dict(MODEL_KW, num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
              num_edge_features=g.edge_attr.shape[1])
    cfg, params, apply_fn = build_model({"hid_features": 8}, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout(apply_fn, params, cfg, g, steps=2)
    preds = rollout(apply_fn, params, cfg, g, steps=2, device="cpu")
    assert preds.shape == (g.num_nodes, 2, 2) and apply_fn is msgnn.apply_msgnn


def test_hdf5_without_h5py(monkeypatch, tmp_path):
    """With h5py hidden: a map file with the HDF5 signature and the HDF5
    record store raise an ImportError that names h5py; a classic NetCDF-3
    map file reads as it does with h5py."""
    import numpy as np

    from mswe_gnn_tpu_torch.data import io as port_io
    from mswe_gnn_tpu_torch.data import netcdf as port_netcdf

    nx = ny = 4
    wd = np.random.default_rng(0).uniform(0, 1, (nx * ny, 3))
    kw = dict(nx=nx, ny=ny, dx=100.0, wd=wd, vx=wd * 0.1, vy=wd * 0.2, bc_faces=[1, 2])
    h5, nc3 = str(tmp_path / "h5_map.nc"), str(tmp_path / "nc3_map.nc")
    port_netcdf.write_grid_map_netcdf(h5, **kw)
    port_netcdf.write_grid_map_netcdf(nc3, classic=True, **kw)
    want = port_netcdf.read_map_variables(nc3, ["mesh2d_waterdepth", "mesh2d_face_nodes"])

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        port_netcdf.read_map_variables(h5, ["mesh2d_waterdepth"])
    with pytest.raises(ImportError, match="h5py"):
        port_netcdf.write_grid_map_netcdf(h5, **kw)
    with pytest.raises(ImportError, match="h5py"):
        port_io.save_records(str(tmp_path / "r.h5"), [])
    with pytest.raises(ImportError, match="h5py"):
        port_io.LazyFloodDataset([h5], scalers={})
    got = port_netcdf.read_map_variables(nc3, ["mesh2d_waterdepth", "mesh2d_face_nodes"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    mesh, bc_faces, _ = port_netcdf.mesh_from_map_netcdf(nc3)
    assert mesh.num_faces == nx * ny and sorted(bc_faces.tolist()) == [1, 2]


def test_port_imports_without_h5py_and_sklearn():
    """A fresh interpreter with h5py and sklearn hidden imports the package,
    its data layer, the reference-checkpoint import and the CLI, and none of
    them imports scipy, h5py or sklearn on the way."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "import mswe_gnn_tpu_torch.main\n"
        "import mswe_gnn_tpu_torch.data.io, mswe_gnn_tpu_torch.data.netcdf\n"
        "import mswe_gnn_tpu_torch.data.interp, mswe_gnn_tpu_torch.data.augment\n"
        "import mswe_gnn_tpu_torch.data.torch_compat, mswe_gnn_tpu_torch.compat.torch_import\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('scipy', 'h5py', 'sklearn', 'jax', 'mswe_gnn_tpu') and sys.modules[m] is not None]\n"
        "assert loaded == [], loaded\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize("hidden", [True, False])
def test_port_imports_without_matplotlib_and_wandb(hidden):
    """A fresh interpreter imports the package, the CLI, the figures module
    and the logger with matplotlib and wandb hidden (as on the GPU machine),
    or present where they are installed; neither is imported on the way
    (the figures and the wandb wiring import them inside their functions)."""
    code = (
        "import sys\n"
        + ("sys.modules['matplotlib'] = None\nsys.modules['wandb'] = None\n" if hidden else "")
        + "import mswe_gnn_tpu_torch, mswe_gnn_tpu_torch.main\n"
        "import mswe_gnn_tpu_torch.utils.visualization, mswe_gnn_tpu_torch.utils.logging\n"
        "import mswe_gnn_tpu_torch.utils.analysis, mswe_gnn_tpu_torch.training.train\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'wandb', 'jax', 'mswe_gnn_tpu') and sys.modules[m] is not None]\n"
        "assert loaded == [], loaded\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_suite_runs_torch_on_one_thread():
    """tests/torch_port_common.py pins PyTorch to one thread in every test
    process that collects a port test."""
    assert torch.get_num_threads() == 1
