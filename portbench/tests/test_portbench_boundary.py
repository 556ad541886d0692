"""What the benchmark may import, and what a run refuses.

No module under ``portbench/`` imports JAX, jaxlib, flax or the JAX package
(``mswe_gnn_tpu``), names compared whole by their top-level part (the port,
``mswe_gnn_tpu_torch``, is another name). The plain reference
(``portbench/reference/``) imports neither the port, nor ``tests``, nor the
rest of the harness; an architecture's module (``portbench/architectures/``)
imports of the harness only the reference, the counts and other
architectures. Without a card a run exits non-zero and prints no
result."""
import ast
import os
import subprocess
import sys

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "mswe_gnn_tpu"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in imported(path)
           if m.split(".")[0] in FORBIDDEN | {"mswe_gnn_tpu_torch", "tests", "portbench"}]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("architectures")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_architecture_imports_nothing_of_the_program(path):
    """An architecture's module is part of the yardstick: of the harness it
    imports the shared reference, the shared counts and other architectures
    alone."""
    shared = ("portbench.reference", "portbench.counts", "portbench.architectures")
    bad = [m for m in imported(path)
           if m.split(".")[0] in FORBIDDEN | {"mswe_gnn_tpu_torch", "tests"}
           or (m.split(".")[0] == "portbench" and not m.startswith(shared))]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mswe_gnn_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]


@pytest.mark.parametrize("where", ["checkout", "harness only"])
def test_run_refuses_without_a_card(tmp_path, where):
    """A run here (no CUDA), or in a directory that holds only
    BENCHMARK.json and portbench/, exits non-zero and prints nothing on
    standard output."""
    cwd = ROOT
    env = dict(os.environ, PYTHONPATH="")
    if where == "harness only":
        cwd = str(tmp_path)
        subprocess.run(["cp", "-r", HERE, os.path.join(ROOT, "BENCHMARK.json"), cwd], check=True)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "msgnn.rollout.b1", "--seed", str(2 ** 31 + 11), "--seconds", "1",
                          "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
