"""The per-layer readers on a synthetic slice of device intervals, and a
cell, a traffic mix, a limits file and a reader added by files alone."""
import json
import os
import shutil

import pytest

from portbench import run, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEVICE = [("void hop_fwd_kernel<float>(...)", 0.0, 10.0), ("gemm", 5.0, 20.0),
          ("Memcpy HtoD", 30.0, 35.0), ("void hop_bwd_kernel<float>(...)", 40.0, 50.0)]
CTX = {"mode": "rollout", "batch": 1, "units": 1, "model_steps_per_unit": 2,
       "device": DEVICE, "host": [("aten::add", 18.0, 32.0), ("aten::mm", 20.0, 25.0),
                                   ("cudaLaunchKernel", 20.0, 21.0)],
       "unit_s": 100e-6, "flops_per_unit": 1e6, "peak_flops": 1e12,
       "hop_bytes_per_unit": 3.35e12 * 10e-6, "hbm_bytes_per_s": 3.35e12,
       "hop_kernels": ("hop_fwd_kernel", "hop_bwd_kernel"), "graph_build_s": 1.5}


@pytest.mark.parametrize("name,want", [
    ("launches_per_step.latency", 1.5),      # 3 kernels (no copy) over 2 model steps
    ("device_idle.train", 65.0),             # busy [0,20] [30,35] [40,50]: 35 of 100 us
    ("hop_roofline.rollout", 50.0),          # a 10 us bound over 20 us of hop kernels
    ("model_mfu.latency", 1.0),              # 1e6 FLOP in 100 us against 1e12 FLOP/s
    ("graph_build_s", 1.5)])
def test_reader(name, want):
    assert run.reader("layer_metrics", name)(CTX) == pytest.approx(want)


def test_readers_find_nothing_to_read():
    empty = dict(CTX, device=[])
    for name in ("launches_per_step", "device_idle", "hop_roofline"):
        assert run.reader("layer_metrics", name)(empty) is None


def test_breakdown_and_busy():
    assert trace.busy_us(DEVICE) == 35.0
    b = trace.breakdown({"device": DEVICE, "host": CTX["host"]})
    assert b["device_ops"][0] == ["gemm", pytest.approx(15e-6)]
    # the gap (20, 30) began inside aten::mm (inside aten::add), (35, 40) under none
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"aten::mm": 10e-6, "(no host op)": 5e-6})


@pytest.mark.parametrize("name,mode,want", [
    ("scenario_ms_p80", "rollout", 1000 * 0.96),   # exclusive quantile at (n + 1) * 0.8
    ("sims_per_s", "rollout", 2 * 5 / 4.0),
    ("train_sims_per_s", "train", 2 * 5 / 4.0),
    ("setup_s", "train", 12.5)])
def test_end_to_end_readers(name, mode, want):
    w = {"mode": mode, "batch": 2, "durations_s": [0.5, 0.6, 0.7, 0.8, 1.0],
         "window_s": 4.0, "setup_s": 12.5}
    assert run.reader("end_to_end", name)(w) == pytest.approx(want)


def harness_copy(tmp_path):
    """A copy of the harness's data (every directory a cell's files live
    in) and of ``BENCHMARK.json``, its configurations pointed at the copy,
    with one more traffic mix: two scenarios as one union."""
    root = tmp_path / "portbench"
    for d in ("architectures", "traffic", "configs", "limits", "end_to_end", "layer_metrics"):
        shutil.copytree(os.path.join(HERE, d), root / d)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        c["file"] = str(root / "configs" / os.path.basename(c["file"]))
    (root / "traffic" / "rollout.b2.json").write_text(json.dumps(
        {"mode": "rollout", "batch": 2, "unions": 1, "scenarios": 2,
         "why": "two scenarios as one union"}))
    return root, bench


def add_cell(bench, root, name, config):
    """The cell ``name`` of ``config`` under ``rollout.b2``, reporting
    ``sims_per_s``, with a copy of a rollout cell's limits."""
    bench["workloads"].append({"name": name, "config": config, "traffic": "rollout.b2",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "sims_per_s")["workloads"].append(name)
    shutil.copy(root / "limits" / "msgnn.rollout.b8.json", root / "limits" / f"{name}.json")


def write_bench(tmp_path, bench):
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    return str(bench_file)


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path, tiny_cell):
    """A copy of the harness's data with one more traffic mix, cell, limits
    file and per-layer reader: the harness runs the new cell and reports
    the new metric, with no code edited."""
    root, bench = harness_copy(tmp_path)
    add_cell(bench, root, "gnn.rollout.b2", "gnn-pareto")
    bench["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "sims_per_s", "workloads": ["gnn.rollout.b2"]})
    (root / "layer_metrics" / "units_traced.py").write_text(
        "def read(ctx):\n    return ctx['units']\n")
    bench_file = write_bench(tmp_path, bench)

    spec = run.load_cell("gnn.rollout.b2", bench_file, str(root))
    small = tiny_cell("gnn.train.b8")
    spec["cfg"] = small["cfg"]
    assert [m["name"] for m in spec["end_to_end"]] == ["sims_per_s", "setup_s"]
    result, _ = run.run_cell(spec, 2 ** 31 + 3, 0.2, False, "cpu", 0.0, str(root))
    assert result["correct"] and set(result["metrics"]) == {"sims_per_s", "setup_s"}
    result, _ = run.run_cell(spec, 2 ** 31 + 3, 0.2, True, "cpu", 0.0, str(root))
    assert result["metrics"]["units_traced"] == {"value": 2.0, "unit": "units"}


TOY = '''"""A toy architecture: the SWE-GNN's reference, three times its FLOPs,
and a kernel family of its own."""
from portbench.architectures import swegnn

KERNELS = {**swegnn.KERNELS, "toy": ("aten::mm", "aten::addmm")}
TOY_BYTES = 1_000_000


class Reference(swegnn.Reference):
    def forward(self, params, x_static, x_dyn, edge_attr):
        return super().forward(params, x_static, x_dyn, edge_attr)


def forward_flops(model, shapes, static_in, dynamic_in, edge_in):
    return 3 * swegnn.forward_flops(model, shapes, static_in, dynamic_in, edge_in)


def kernel_bytes(model, shapes, train):
    return {**swegnn.kernel_bytes(model, shapes, train), "toy": TOY_BYTES}
'''
TOY_ROOFLINE = '''def read(ctx):
    names = ctx["arch"].KERNELS["toy"]
    # on the CPU the ops run on the host: the trace has no device events
    events = ctx["device"] or ctx["host"]
    us = sum(e - s for name, s, e in events if any(k in name for k in names))
    if not us:
        return None
    bound_s = ctx["kernel_bytes_per_unit"]["toy"] / ctx["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us * 1e-6 / ctx["units"])
'''


def test_a_configuration_of_a_new_architecture_is_added_by_files_alone(
        tmp_path, tiny_cell, monkeypatch):
    """A copy of the harness's data with an architecture module, a
    configuration naming it, a cell with its traffic and limits, and a
    reader of the architecture's own kernel family: the toy cell is
    correct, its ``model_mfu`` follows the toy's FLOPs (three times those
    of the same model as ``swegnn``), and its reader reads the toy's bytes."""
    root, bench = harness_copy(tmp_path)
    (root / "architectures" / "toy.py").write_text(TOY)
    with open(root / "configs" / "gnn-pareto.json") as f:
        cfg = json.load(f)
    (root / "configs" / "toy.json").write_text(json.dumps(dict(cfg, name="toy",
                                                               architecture="toy")))
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": str(root / "configs" / "toy.json"), "reduced": [],
                             "why": "a test"})
    for cell, config in (("gnn.rollout.b2", "gnn-pareto"), ("toy.rollout.b2", "toy")):
        add_cell(bench, root, cell, config)
        next(m for m in bench["per_layer"] if m["name"] == "model_mfu.rollout")[
            "workloads"].append(cell)
    bench["per_layer"].append({"name": "toy_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "toy kernels",
                               "moves": "sims_per_s", "workloads": ["toy.rollout.b2"]})
    (root / "layer_metrics" / "toy_roofline.py").write_text(TOY_ROOFLINE)
    bench_file = write_bench(tmp_path, bench)

    seen = []                             # the per-layer context of each traced run
    metrics = run.metrics
    monkeypatch.setattr(run, "metrics", lambda entries, kind, data, root=run.HERE: (
        seen.append(data), metrics(entries, kind, data, root))[1])
    small = tiny_cell("gnn.train.b8")["cfg"]
    results = {}
    for cell in ("gnn.rollout.b2", "toy.rollout.b2"):
        spec = run.load_cell(cell, bench_file, str(root))
        spec["cfg"] = dict(small, architecture=spec["cfg"]["architecture"])
        results[cell], _ = run.run_cell(spec, 2 ** 31 + 3, 0.2, True, "cpu", 0.0, str(root))
    twin, toy = seen
    result = results["toy.rollout.b2"]
    assert result["correct"] and results["gnn.rollout.b2"]["correct"]
    assert toy["flops_per_unit"] == 3 * twin["flops_per_unit"] > 0
    assert result["metrics"]["model_mfu.rollout"]["value"] == pytest.approx(
        100.0 * toy["flops_per_unit"] / toy["unit_s"] / toy["peak_flops"])
    assert toy["kernel_bytes_per_unit"] == {
        "hop": twin["kernel_bytes_per_unit"]["hop"],
        "toy": toy["model_steps_per_unit"] * 2 * 1_000_000}
    assert result["metrics"]["toy_roofline"]["value"] > 0
    assert "toy_roofline" not in results["gnn.rollout.b2"]["metrics"]


def test_a_configuration_without_its_architecture_fails_to_load(tmp_path):
    root, bench = harness_copy(tmp_path)
    path = root / "configs" / "gnn-pareto.json"
    cfg = json.loads(path.read_text())
    del cfg["architecture"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(run.CellError, match='"architecture"'):
        run.load_cell("gnn.train.b8", write_bench(tmp_path, bench), str(root))
