"""Shared fixtures of the benchmark's CPU tests: a cell of BENCHMARK.json,
or the batch-1 rollout cell kept for a later benchmark (PERF.md §7), at the
cell's own size or cut to one the CPU runs in a second (a 16x12 grid, 10
frames, F=16, K=2), everything else as committed."""
import json
import os
import tempfile

import pytest

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PUT_OFF = {"name": "msgnn.rollout.b1", "config": "msgnn-bench", "traffic": "rollout.b1",
           "chips": 1, "why": "one scenario at a time"}
PUT_OFF_METRIC = {"name": "scenario_ms_p80", "unit": "ms", "better": "lower", "bound": 0.25,
                  "source": "host_clock", "workloads": ["msgnn.rollout.b1"]}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (CUDA); skips without one")


def cell_spec(cell: str, cut: bool = True) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if cell == PUT_OFF["name"]:
        bench["workloads"].append(PUT_OFF)
        bench["end_to_end"].insert(0, PUT_OFF_METRIC)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
            json.dump(bench, f)
            f.flush()
            spec = run.load_cell(cell, f.name)
    finally:
        os.chdir(cwd)
    if cut:
        cfg = spec["cfg"]
        cfg["grid"].update(nx=16, ny=12)
        cfg["frames"] = 10
        cfg["pad_multiple"] = 8
        cfg["model"].update(hid_features=16, K=2)
    return spec


@pytest.fixture
def tiny_cell():
    return cell_spec
