"""Times this checkout's hop kernels against another checkout's, in turns, on
one NVIDIA GPU.

Run from the root of the repository:

    python3 kernel_ab.py --other NAME=DIR [--other NAME=DIR ...] [--out FILE]

``DIR`` holds another checkout's ``hop.cu``, ``band_hop.cu`` and
``hop_common.cuh`` whose launch symbols (``mswe_hop_launch``,
``mswe_hop_bwd_launch`` and the band ones) take this checkout's C
arguments, for example ``git archive <commit> mswe_gnn_tpu_torch/ops/csrc``
unpacked into a directory that ``.gitignore`` lists (``_ab/``); nothing
else is loaded from it. All versions are compiled at once, one ``nvcc`` a
source, and launched through this checkout's wrappers. Then, on the bench
problem of ``chip_smoke.py`` (152x152 grid, F=64, bf16):

1. every case of ``chip_smoke.timing_cases`` (the rollout's five ELL
   forward shapes on the bench graph's own tables, the ELL backward at the
   train step's ELL shapes, the band kernels on the two bench plans), and
   the five ELL forward shapes again on uniformly random tables: both
   versions' results against the plain version's, bit for bit, then all
   timed in turns (the others, this; then in reverse: NAME, this, this,
   NAME for one other) by CUDA-graph replay, beside the bound and the
   launch floor (read before and after);
2. the 47-step rollout and one train step with every version, in the same
   turns, twice, as host-bound readings; the launches of the first run of
   each, counted by the wrappers by kernel and shape, are held against the
   config's;
3. each kernel's (forwards and backwards) sum of counted launches x time
   on each path, for every version, and the same over the bound.

It prints the card's name and power limit first and last, a line per
reading, and writes every reading as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from mswe_gnn_tpu_torch.ops import band_hop as band_ops  # noqa: E402
from mswe_gnn_tpu_torch.ops import build as kernel_build  # noqa: E402
from mswe_gnn_tpu_torch.ops import hop as hop_ops  # noqa: E402

log = cs.log
SYMBOLS = {"hop": {"fwd": "mswe_hop_launch", "bwd": "mswe_hop_bwd_launch"},
           "band_hop": {"fwd": "mswe_band_hop_launch", "bwd": "mswe_band_hop_bwd_launch"}}
WRAPPERS = {"hop": hop_ops, "band_hop": band_ops}


def parse_pair(item: str):
    name, sep, value = item.partition("=")
    if not sep or not name or not value:
        raise SystemExit(f"--other takes NAME=DIR, got {item!r}")
    return name, value


def build_versions(others) -> list:
    """Compiles the other checkouts' libraries (``[(name, dir)]``) and this
    one's at once -> ``[*others, this]``, each ``{"name", "source", "fns",
    "ptxas"}``: ``fns`` maps a library to the launch functions that replace
    the shipped ones (none for this checkout), typed as the shipped ones."""
    t0 = time.perf_counter()
    sources = [*others, ("this", kernel_build.CSRC_DIR)]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda d: kernel_build.build(csrc_dir=Path(d[1])), sources))
    log(f"[build] {len(sources)} versions x 2 libraries in {time.perf_counter() - t0:.1f} s")
    versions = []
    for (vname, src), libs in zip(sources, built):
        fns, ptxas = {}, {}
        for lib_name, lib in libs.items():
            ptxas.update(cs.ptxas_functions(lib["log"]))
            if vname != "this":
                shipped = WRAPPERS[lib_name]._kernels()
                cdll = ctypes.CDLL(lib["path"])
                fns[lib_name] = {}
                for key, symbol in SYMBOLS[lib_name].items():
                    fn = getattr(cdll, symbol)
                    fn.argtypes, fn.restype = shipped[key].argtypes, shipped[key].restype
                    fns[lib_name][key] = fn
        ptxas = {fn: r for fn, r in ptxas.items() if "<bf16, V=8, CPL=1" in fn}
        for fn, r in ptxas.items():
            log(f"[build] {vname}: {fn}: {r.get('registers')} registers, {r.get('stack')} "
                f"bytes stack frame, {r.get('spill_stores')}/{r.get('spill_loads')} "
                f"bytes spilled")
        versions.append({"name": vname, "source": str(src), "fns": fns, "ptxas": ptxas})
    return versions


@contextlib.contextmanager
def use(version):
    """The wrappers launch ``version``'s kernels inside the block."""
    with contextlib.ExitStack() as stack:
        for lib_name, fns in version["fns"].items():
            stack.enter_context(mock.patch.dict(WRAPPERS[lib_name]._kernels(), fns))
        yield


def in_turns(versions, fn, reps=200) -> dict:
    """Kernel time of ``fn`` under every version, in turns: the versions in
    order, then reversed -> ``{name: [ms, ms]}``."""
    times = {v["name"]: [] for v in versions}
    for v in versions + versions[::-1]:
        with use(v):
            times[v["name"]].append(cs.graph_time_ms(fn, reps))
    return times


def same_bits(versions, case) -> None:
    want = case["plain"]()
    for v in versions:
        with use(v):
            got = case["run"]()
        got, w = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for a, b in zip(got, w):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{v['name']}: {case['kernel']} {case['shape']} "
                                     f"disagrees with its plain version")


def random_table_cases(cache, spec) -> list:
    """The rollout's five ELL forward shapes on uniformly random slot tables
    (no locality), as cases of ``chip_smoke.timing_cases`` without a key:
    no path launches them."""
    out = []
    for name, (dst, src, _, _), grad, same in cs.bench_hop_cases(cache, spec):
        nd, ns = dst.shape[0], src.shape[0]
        args = cs.make_hop_inputs(1000 + nd + ns, nd, ns, cs.DEGREE, cs.FEAT, torch.bfloat16,
                                  same)
        ms, _ = cs.bound(*cs.hop_work(nd, ns, cs.DEGREE, cs.FEAT, 2, same, 4 if grad else 3))
        out.append({"kernel": "hop", "shape": name.replace("bench table", "random table"),
                    "key": None, "run": partial(hop_ops.hop, *args, with_gradient=grad),
                    "plain": partial(hop_ops.hop_reference, *args, with_gradient=grad),
                    "bound_ms": ms})
    return out


def time_kernels(versions, cases) -> list:
    rows = []
    for c in cases:
        same_bits(versions, c)
        times = in_turns(versions, c["run"])
        means = {k: statistics.fmean(t) for k, t in times.items()}
        log(f"[ab] {c['kernel']} {c['shape']}: " + "; ".join(
            f"{k} {means[k] * 1e3:.2f} us ({', '.join(f'{x * 1e3:.2f}' for x in t)})"
            for k, t in times.items())
            + f"; bound {c['bound_ms'] * 1e3:.2f} us"
            + (f"; launch {c['launch']}" if "launch" in c else ""))
        rows.append({"kernel": c["kernel"], "shape": c["shape"], "key": c["key"],
                     "times_ms": times, "mean_ms": means,
                     "spread_ms": {k: max(t) - min(t) for k, t in times.items()},
                     "bound_ms": c["bound_ms"], "launch": c.get("launch")})
    return rows


def time_paths(versions, sample, banded, cfg, params, apply_fn) -> tuple:
    """The rollout and one train step with every version, in turns (the
    versions in order, then reversed, twice): CUDA events and the host
    clock around each. The first run of each path (a warm-up, with the
    first version) has its launches counted by shape and held against the
    config's. -> (readings, ``{path: Counter}``)."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_train_step
    from mswe_gnn_tpu_torch.training.rollout import rollout

    device = torch.device("cuda")
    graph = sample.to(device)
    steps = sample.y.shape[-1]
    step = build_bench_train_step(banded, cfg, params, apply_fn, device=device)
    paths = {"serving": (lambda: rollout(apply_fn, params, cfg, graph, steps, device=device),
                         cs.rollout_launches(cfg, sample.spec, steps)),
             "train_step": (step, cs.train_launches(cfg, banded.spec, banded.band_meta,
                                                    step.rollout_steps, step.opts.remat))}
    out, counts = {}, {}
    for path, (run, expected) in paths.items():
        for i, v in enumerate(versions):          # warm-up
            with use(v):
                cs.reset_all_launches()
                run()
                torch.cuda.synchronize()
            if i == 0:
                counts[path] = cs.read_launches()
                cs.hold_launches("ab", f"the {path} with {v['name']}", counts[path], expected)
        readings = {v["name"]: {"event_ms": [], "host_ms": []} for v in versions}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for v in (versions + versions[::-1]) * 2:
            with use(v):
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                start.record()
                run()
                end.record()
                end.synchronize()
            readings[v["name"]]["event_ms"].append(start.elapsed_time(end))
            readings[v["name"]]["host_ms"].append((time.perf_counter() - h0) * 1e3)
        for name, r in readings.items():
            log(f"[ab] {path} with {name}: CUDA events "
                f"{', '.join(f'{t:.1f}' for t in r['event_ms'])} ms; host clock "
                f"{', '.join(f'{t:.1f}' for t in r['host_ms'])} ms")
        out[path] = readings
    return out, counts


def summarise(rows, counts, versions) -> dict:
    """Sum of counted launches x mean time of each kernel on each path, by
    version, and the same over the bound."""
    out = {}
    for kernel in cs.KERNELS:
        for path, n_by_key in counts.items():
            sel = [r for r in rows if r["kernel"] == kernel and r["key"] in n_by_key]
            if not sel:
                continue
            n = sum(n_by_key[r["key"]] for r in sel)
            total = {v["name"]: sum(n_by_key[r["key"]] * r["mean_ms"][v["name"]] for r in sel)
                     for v in versions}
            least = sum(n_by_key[r["key"]] * r["bound_ms"] for r in sel)
            out[f"{kernel}/{path}"] = {"launches": n, "sum_ms": total,
                                       "over_bound_ms": {k: t - least for k, t in total.items()}}
            log(f"[ab] {kernel} on the {path}: {n} launches counted; sum of launches x time "
                + ", ".join(f"{k} {t:.3f} ms" for k, t in total.items())
                + f"; bound {least:.3f} ms")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, action="append",
                    help="NAME=DIR: the kernel sources of another checkout (repeatable)")
    ap.add_argument("--out", default=None, help="file for the JSON of every reading")
    args = ap.parse_args()
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model, build_bench_sample
    from mswe_gnn_tpu_torch.models import prepare_graph

    smi = cs.phase_device()
    names = [parse_pair(item) for item in args.other]
    if len({n for n, _ in names} | {"this"}) != len(names) + 1:
        raise SystemExit("--other names must differ from each other and from 'this'")
    versions = build_versions(names)
    sample, _ = build_bench_sample()
    banded = band_ops.attach_band_plan(sample)
    cfg, params, apply_fn = build_bench_model(sample, device=torch.device("cuda"))
    with torch.no_grad():
        cache = prepare_graph(params, cfg, sample.to("cuda")).ell_cache
    floors = [cs.launch_floor_ms()]
    rows = time_kernels(versions, cs.timing_cases(banded, cache, cfg)
                        + random_table_cases(cache, sample.spec))
    floors.append(cs.launch_floor_ms())
    log(f"[ab] launch floor before and after: "
        f"{', '.join(f'{f * 1e3:.2f}' for f in floors)} us")
    paths, counts = time_paths(versions, sample, banded, cfg, params, apply_fn)
    summary = summarise(rows, counts, versions)
    result = {"card": smi,
              "versions": [{k: v[k] for k in ("name", "source", "ptxas")} for v in versions],
              "floors_ms": floors, "rows": rows, "summary": summary, "paths": paths,
              "launches": {p: {"/".join(map(str, k)): n for k, n in c.items()}
                           for p, c in counts.items()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
        log(f"[ab] readings written to {args.out}")
    log(smi)


if __name__ == "__main__":
    main()
