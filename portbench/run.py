"""Run one cell of the port's benchmark once, on the card this process
sees, and print its result as the last line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``mswe_gnn_tpu_torch``). The cell names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
the metrics it reports are the ``BENCHMARK.json`` entries that list it, or
that list no cells (a per-layer metric without ``workloads``: every cell that
reports the end-to-end metric it moves), each read by its own file
(``end_to_end/<name>.py``, ``layer_metrics/<family>.py``). The configuration
names its architecture (``"architecture"``), whose module
``architectures/<name>.py`` holds the plain reference's forward pass, the
FLOP count and the kernels' byte counts (``architectures/__init__.py``).

So nothing here is edited to add a cell. A configuration of a new
architecture adds, beside its ``BENCHMARK.json`` entries: the architecture's
module (``architectures/``), its configuration file (``configs/``), the
traffic mix of each cell (``traffic/``), each cell's limits
(``limits/<cell>.json``) and the readers of its new metrics
(``layer_metrics/``, such as its kernels' ``<kernel>_roofline``). A
configuration of a known architecture, or a cell of a known configuration,
adds the files of that list it lacks.

A run: inputs and weights from the seed, the inputs through the port's data
path, a warm-up of the cell's own shapes (set-up ends here: ``setup_s``), a
closed loop of units for ``--seconds`` (the window), the peak device memory;
with ``--trace 1`` a few more units under ``torch.profiler`` for the
per-layer metrics; then the port's state freed and what its units produced
compared with the plain reference (``correct``). Without a card, or with
fewer than the cell asks for, or with JAX or the JAX package loaded in this
process once the window has closed, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "mswe_gnn_tpu")


class CellError(RuntimeError):
    pass


def load_cell(workload: str, bench_file: str = "BENCHMARK.json", root: str = HERE) -> dict:
    """The cell ``workload`` of ``bench_file`` with its configuration, its
    architecture's module, its traffic and its metric entries."""
    with open(bench_file) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in {bench_file}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(config["file"]) as f:
        cfg = json.load(f)
    if "architecture" not in cfg:
        raise CellError(f"the configuration {config['file']} has no \"architecture\" key")
    with open(os.path.join(root, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"cell": cell, "cfg": cfg, "arch": architecture(cfg["architecture"], root),
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer}


def _module(kind: str, stem: str, root: str):
    """``<root>/<kind>/<stem>.py`` loaded, or None where there is no such
    file."""
    path = os.path.join(root, kind, f"{stem}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def architecture(name: str, root: str = HERE):
    """The module of the architecture ``name``: ``<root>/architectures/<name>.py``."""
    module = _module("architectures", name, root)
    if module is None:
        raise CellError(f"no architecture {name!r} in architectures/")
    return module


def reader(kind: str, name: str, root: str = HERE):
    """``read`` of ``<root>/<kind>/<name>.py``, else of the file of the
    name's family (the part before the first dot)."""
    for stem in (name, name.split(".")[0]):
        module = _module(kind, stem, root)
        if module is not None:
            return module.read
    raise CellError(f"no reader for {name!r} in {kind}/")


def metrics(entries, kind: str, data: dict, root: str = HERE) -> dict:
    out = {}
    for m in entries:
        value = reader(kind, m["name"], root)(data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, root: str = HERE) -> tuple:
    """One run of a loaded cell on ``device`` -> (result, the numbers
    compared, each with its limit)."""
    import torch

    from portbench import compare, counts, modes
    from portbench import trace as trace_lib
    from portbench.reference import inputs

    cfg, traffic = spec["cfg"], spec["traffic"]
    name = spec["cell"]["name"]
    phases = {"imports": time.perf_counter() - t0}
    mesh = inputs.make_mesh(cfg["grid"], seed)
    scenarios = inputs.make_scenarios(mesh, cfg["frames"], traffic["scenarios"], seed)
    phases["inputs"] = time.perf_counter() - t0 - sum(phases.values())
    mode = modes.MODES[traffic["mode"]](cfg, spec["arch"], traffic, seed, device, mesh,
                                        scenarios)
    phases["graph_and_model"] = time.perf_counter() - t0 - sum(phases.values())
    mode.warm()
    phases["warm_up"] = time.perf_counter() - t0 - sum(phases.values())
    print("setup seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f" (graph build {mode.graph_build_s:.3f})", file=sys.stderr, flush=True)

    def sync():
        modes.sync(device)

    start = time.perf_counter()
    setup_s = start - t0
    durations, i = [], 0
    while True:
        a = time.perf_counter()
        mode.unit(i)
        b = time.perf_counter()
        durations.append(b - a)
        i += 1
        if b - start >= seconds:
            break
    window = {"mode": traffic["mode"], "batch": mode.batch, "durations_s": durations,
              "window_s": b - start, "setup_s": setup_s}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["cell"]["chips"],
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    result = {}
    if trace:
        sl = trace_lib.profile_units(mode.unit, i, mode.traced_units, sync)
        kernel_bytes = mode.kernel_bytes_per_unit()
        ctx = {"mode": traffic["mode"], "batch": mode.batch, "units": mode.traced_units,
               "model_steps_per_unit": mode.model_steps_per_unit,
               "device": sl["device"], "host": sl["host"],
               "unit_s": window["window_s"] / len(durations),
               "cfg": cfg, "shapes": mode.shapes, "arch": spec["arch"],
               "flops_per_unit": mode.flops_per_unit(),
               "peak_flops": counts.PEAK_FLOPS[cfg["model"]["compute_dtype"]],
               "kernel_bytes_per_unit": kernel_bytes,
               "hop_bytes_per_unit": kernel_bytes.get("hop"),
               "hop_kernels": spec["arch"].KERNELS.get("hop", ()),
               "hbm_bytes_per_s": counts.HBM_BYTES_PER_S,
               "graph_build_s": mode.graph_build_s}
        result["metrics"] = metrics(spec["per_layer"], "layer_metrics", ctx, root)
        dev.update(busy_s=trace_lib.busy_us(sl["device"]) * 1e-6, window_s=sl["wall_s"])
        result["breakdown"] = trace_lib.breakdown(sl)
        del sl, ctx
    else:
        result["metrics"] = metrics(spec["end_to_end"], "end_to_end", window, root)
    mode.release()
    ok, numbers = compare.judge(mode.check(), compare.limits(name, root))
    result = {"correct": bool(ok and mode.failed == 0), "attempted": len(durations),
              "failed": mode.failed, **result, "device": dev, "checks": numbers}
    return result, numbers


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        spec = load_cell(args.workload)
    except (OSError, KeyError, ValueError, CellError) as e:
        fail(f"cannot load the cell: {e}")
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); this process sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from mswe_gnn_tpu_torch import cache

    cache.enable_compilation_cache(str(cache.DEFAULT_DIR))
    # any whole number: the generators take it modulo 2**63
    result, numbers = run_cell(spec, args.seed % 2 ** 63, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T0)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}", code=3)
    print(f"card: {card_line()}", flush=True)
    for name, n in numbers.items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
