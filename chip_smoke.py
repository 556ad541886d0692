"""Smoke test of the PyTorch port (``mswe_gnn_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  -- exits non-zero without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build   -- compiles ``mswe_gnn_tpu_torch/ops/csrc/hop.cu`` and
   ``band_hop.cu`` for sm_90a, one ``nvcc`` each, and the mesh core of
   ``native/`` with ``g++``, all in parallel, into the directory that
   ``cache.enable_compilation_cache`` sets (checked); prints the
   registers, stack frame and spills of every kernel, and fails unless
   each of the 24 forward and 24 backward instantiations is there with no
   stack frame and no spills.
3. kernels -- every kernel against its plain PyTorch version on the card:
   the ELL hop and its backward (every mode, both dtypes, same-block and
   separate-source calls, ragged shapes, a skewed out-slot table and the
   bench shapes), the banded hop and its backward (the bench plans of
   scales 0 and 1, ragged, skewed and ghost-tail plans), and a repeat
   launch of each backward, which must give the same bits.
4. serving -- the bench problem of ``bench.py:75-120`` rebuilt through the
   port (152x152 grid, 3 scales, F=64, K=5, bf16), its 47-step rollout on
   the card with the hop-kernel launches counted by kernel and by shape
   ``(Nd, Ns)`` and held against the config's, the first step held
   against the same step through the plain hop, and the rollout timed.
5. train   -- the train step of ``bench.py:304-341`` on the same graph with
   its band plan: a 6-step pushforward with remat, batch 1. The launches of
   every kernel in one step, counted and held against the counts the
   config gives; the gradients against the same step through the plain
   hops, in bf16 and in float32; a warm-up step (its launches counted by
   shape too) and 3 timed ones, the loss finite and falling; one
   ``eval_step`` over the 47-step graph; peak device memory.
6. timing  -- runs last: every kernel at the bench shapes, on the bench
   graph's own tables and plans, and the ELL hop at the union shapes of
   phases 7 and 8 on the unions' own tables (forward and backward at b=4,
   forward at b=20): each case first held bit-equal to its plain version
   on its own inputs, then kernel, L2 flushed, plain version, bound, the launch
   floor of the harness, each launch (block, grid, registers, warps an
   SM), and the launches of each shape on each path as phases 4, 5, 7 and
   8 counted them, with their sum of launches x time; and the ELL hop and
   its backward at phase 13's ring partition shapes, on part 0's tables,
   and at phase 14's row-block shapes, on the first row's tables.
7. batched serving -- the 47-step rollout on concat unions of 4 and of 20
   bench graphs (``concat_graphs``, no band plan): launches by shape held
   against the tiled spec's, the output checked as in phase 4, every
   graph's step 0 held against the batch-1 rollout's within phase 4's
   limit, the worst per-graph difference over the 47 steps, and the
   seconds a simulation at batch 1, 4 and 20 (median of 3 after a warm-up,
   CUDA events).
8. batched train -- the train step of phase 5 on a union of 4 copies of the
   banded graph (all ELL, as in JAX): launches by shape, gradients against
   the plain hops at phase 5's limits, the union against one copy in
   float32 (the same loss and gradients), what the out-slot tables cost
   ``prepare_graph``, timed steps, and ``tune_batch_size`` over (1, 2, 4)
   with the peak device memory.
9. trainer -- ``Trainer`` at demo_small's width on a small synthetic set, at
   batch 4 with a ragged tail, batches assembled on the card, watch norms
   and checkpoints in a temporary directory: fit 2 epochs, save, resume
   into a new Trainer (parameters and optimizer state bit-equal), fit one
   more epoch.
10. cli -- the experiment CLI (``mswe_gnn_tpu_torch.main``) on
   ``configs/accuracy_tri.yaml`` at full width (F=64, K=5, float32) with only
   the corpus and the epochs cut (each cut printed), the mesh core built
   with g++ at first use: (a) ``train`` for 2 epochs, every file it writes
   there, a finite history, ELL forward and backward launched; (b) ``eval``
   of that run's ``best``, its summary the training one within 1e-5; (c)
   ``eval`` of the committed trained weights
   (``results_repo/checkpoints/accuracy_tri_r5_torch/best``), a finite
   summary. Launches are counted for each of the three runs. Then, with the
   trained weights, each against the plain versions within phase 3's
   float32 limit: the ELL forward and backward in every mode at each
   ``(Nd, Ns)`` the three runs launched, on the tables of a union of the
   run's own samples that gives that shape (a shape held nowhere fails the
   phase); the full rollout of one test graph and of a union of
   ``eval_batch_size`` test graphs; and the loss and gradients of one train
   step on a union of ``batch_size`` training samples (phase 5's float32
   limits).
11. gnn -- the single-scale SWE-GNN of ``configs/pareto_gnn.yaml`` at its
   full width (F=64, K=10, 2 layers, mlp_layers 3, float32, 251,604
   parameters) on the 152x152 grid's single-scale dual graph (23,168 rows):
   (a) its 47-step rollout, all ELL (20 hops a step), launches held, step 0
   against the plain hop and the rollout timed as in phase 4; (b) the train
   step of phase 5 with the graph's band plan (band forward and backward,
   launches held), its float32 gradients against the plain hops at phase
   5's float32 limits, timed; (c) the Cheb / TAG / GAT baselines at the
   same width: step 0 on the card against the CPU (atol 1e-4) and a timed
   47-step rollout each, no hop launched; (d) the CLI's ``train`` on a cut
   pareto_gnn corpus (each cut printed) and ``eval`` of its ``best`` (the
   training summary within 1e-5), every launched shape held as in phase 10;
   (e) the bench MSGNN with ``learned_pooling`` on the 3-scale bench graph,
   one step held against the plain hops within phase 4's limit.
12. data -- the data layer: (a) the bench MSGNN of phase 4 on the bench
   graph with storm forcing (``build_bench_sample(storm=True)``: wind
   stress WX, WY and a pressure low P from ``add_storm_forcing``, three
   columns appended to the static features at every step), its 47-step
   rollout as phase 4 (1,269 ELL launches, step 0 against the plain hop,
   timed); (b) the train step of phase 5 on that graph with its band plan
   (240 band fwd + 84 ELL fwd + 120 band bwd + 42 ELL bwd, gradients at
   phase 5's limits, timed); (c) the CLI's ``train`` and ``eval`` of
   ``configs/accuracy.yaml``'s model at full width (F=64, K=5, float32)
   with ``synthetic_data.storm_forcing`` on, only the corpus and the epochs
   cut (each cut printed), the eval summary the training one within 1e-5,
   every launched shape held as in phase 10; (d) ``train`` and ``eval`` at
   demo_small's width on a ``dataset_parameters.map_folder`` of map files
   that the smoke writes as classic NetCDF-3 (``scipy.io.netcdf_file``:
   the card has no h5py) with an ``overview.csv``, lstsq slopes as node
   features, 3 scales (the coarse ones re-meshed by the mesh core), the
   summary's solver label ``dhydro`` with a finite speed-up, every launched
   shape held; (e) ``train`` on a ``dataset_folder`` of reference pickles
   written by ``tests/pyg_fixture.py``, its split sizes held.
13. ring -- ring-halo graph parallelism: phase 4's bench graph ring-reordered
   (``parallel/dist_swegnn.py``) and split into 8 ring partitions, all on
   ``cuda:0`` (the largest count <= 8 with a ring plan, each count that
   fails printed). (a) the bench MSGNN's 47-step rollout through the ring
   ``apply_fn`` (``parallel/dist_train.py``) in bf16 and float32, launches
   by ``(kernel, Nd, Ns)`` held against the plans', against the
   single-device port on the same reordered graph and weights: step 0
   within 1e-5 max|pred| in float32 and two bf16 ulps of max|pred| in bf16,
   the float32 rollout (cut to ``RING_F32_STEPS`` steps) within a relative
   L2 of 1e-4; the bf16 rollout timed as phase 4's. (b) phase 5's train
   step through the ring: float32 loss and gradients against the
   single-device port (``hold_ring_grads``: the loss within 1e-6, cosine
   and relative L2 over the tree, every leaf at phase 5's limit or, where
   rounding alone moves it further, within its movement under a one-ulp
   change of the inputs), then the bf16 step counted (forward and
   backward) and timed. (c) the overlap and width-2 plans: one float32 step against (a)'s step 0
   within 2e-5 |ref| + 1e-6 max|ref|, launches held. (d)
   ``configs/ring_halo.yaml`` through ``main.run_training`` at its own
   width and corpus at the largest count with a plan (printed as a cut;
   at the config's own 8 parts the plan fails and the run falls back to
   the GSPMD mesh: phase 14 (e)), its batch size cut to 4 and forced back
   to 1, a finite history and summary, ELL forward and backward launched.
   Every partition shape launched on (a)-(d) held bit-equal to the plain
   versions on every part's table.
14. mesh -- data x graph parallelism (``parallel/sharding.py``,
   ``parallel/gspmd.py``), every entry of the mesh ``cuda:0``. (a) the bench
   train step (bf16, remat, 6-step pushforward) on a 4 x 2 mesh, a stacked
   batch of 4 distinct bench samples (``distinct_bench_samples``): each data
   row one sample, its rows split over 2 blocks that hop against the
   gathered state; its float32 loss and gradients against the one-device
   step on the union of the 4 samples (``hold_ring_grads``' limits), then
   the bf16 step counted by ``(kernel, Nd, Ns)`` against the row plans'
   count (8 x 27 hops a model step) and timed as phase 8's; the placement a
   trainer makes every step timed, the row models kept, and built anew. (b)
   ``rollout_batch`` of the same batch over 47 steps on the mesh: launches
   held, each graph against its own one-device rollout within two bf16 ulps
   of its largest prediction, timed. (c) ``configs/multichip.yaml`` through
   ``main train`` and ``main eval`` with ``--device`` 8 x ``cuda:0`` at its
   own width (F=64, K=4, ``batch_layout: vmap``), only the epochs cut 20
   -> 2; the eval summary the training one within 1e-5. (d) the same train
   as two processes (``--dist-*``), each on 4 x ``cuda:0``, the backend
   printed; both exit 0, process 0 writes every file, the history (c)'s
   within 1e-5 ((c) and (d) under deterministic algorithms). (e) ring_halo at data 2 x graph 4 on the bench graph: step
   0 bit-equal to data 1's; ``configs/ring_halo.yaml`` at its own 8 parts:
   JAX's fallback line, then training on a 1 x 8 mesh. (f) the bench MSGNN
   with ``learned_pooling`` on (a)'s batch and mesh: the pooling launches no
   hop, so its row plans give (a)'s counts (checked); the float32 train
   step against one device at (a)'s limits, the bf16 step and the 47-step
   ``rollout_batch`` counted by shape, held and timed as (a) and (b), the
   rollouts of the comparison under deterministic algorithms (the pooling's
   segment mean otherwise adds by float32 atomics); the float32
   ``rollout_batch`` against each graph's own within 1e-4 of its largest
   prediction. (g)
   pareto_gnn's Cheb / TAG / GAT (F=64, K=10, 2 layers, float32) on 4
   distinct samples of phase 11's single-scale graph on the same mesh:
   ``rollout_batch`` against each graph's one-device rollout within 1e-4 at
   step 0 and over all 47 steps, timed; the float32 train step against the
   one-device step on the stacked batch (loss 1e-5 relative, every leaf
   1e-4 max|leaf|); no hop launched. (h) multichip.yaml with
   ``models.learned_pooling`` (a printed override) through ``main train``
   and ``main eval`` as (c). (i) ``utils/profiling.trace`` around one bench
   model step writes a Chrome trace holding CUDA kernels, and
   ``utils/profiling.timed`` of phase 4's rollout is printed beside phase
   4's median. Every shape launched on (a)-(h) held bit-equal to the plain
   versions on every table of it.
15. reports -- the report and sweep layer: (a) ``main sweep`` of
   ``configs/pareto.yaml``'s MSGNN at its full width (F=64, mlp_layers 3,
   float32), only the corpus and the epochs cut (64 -> 12 sims, 140 -> 2
   epochs, each cut printed), under a stand-in ``wandb`` module (the card
   has none) whose agent runs two trials (K 5 with ``watch_every`` 1, and
   K 4): every trial's epoch records (``train_loss``, ``val_loss``,
   ``val_CSI_005``) on its run, its summary set and its run finished, its
   ``summary.json`` and ``best``, trial 0's histograms one a parameter leaf
   and finite, ELL forward and backward launched; (b) ``main eval`` of
   trial 0's ``best`` with ``--out``: without matplotlib (the card) the
   line ``report figures skipped: matplotlib is not installed`` printed
   once and ``summary.json`` alone written, with it the 11 figure files of
   the JAX test set, non-empty; the summary the training one within 1e-5.
   Every shape launched on (a) and (b) held against the plain versions on
   the runs' own unions, as in phase 10.

Then one JSON line describing every kernel. Its ``launches`` is a sum: the
kernel's launches over every path driven (serving and train step at batch 1,
serving at batch 4 and 20, train step at batch 4, the CLI's train, eval and
trained-weights eval, phase 11's rollout, train step, CLI train and eval
and learned-pooling step, phase 12's forced rollout and train step and its
CLI runs, phase 13's ring rollouts, train step, plan variants and CLI
run, and phase 14's mesh train step, rollout, CLI train and eval, ring
steps and fallback run, learned-pooling train step, rollout and CLI train
and eval, and the baselines, and phase 15's sweep and reporting eval), each
path counted from 0 just before it runs;
``launches_by_path`` holds each path's own count, the figure to read for
one path. Then the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without printing a result. It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mswe_gnn_tpu_torch.ops import band_hop as band_ops  # noqa: E402
from mswe_gnn_tpu_torch.ops import build as kernel_build  # noqa: E402
from mswe_gnn_tpu_torch.ops import hop as hop_ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores, same sheet
BENCH_ROWS = (23168, 5888, 1536)   # padded nodes per scale of the bench graph
DEGREE, FEAT = 4, 64
SOURCES = {"hop": "mswe_gnn_tpu_torch/ops/csrc/hop.cu",
           "band_hop": "mswe_gnn_tpu_torch/ops/csrc/band_hop.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return line


# ---------------------------------------------------------------- phase 2
_PTXAS_FN = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_KERNEL = re.compile(r"(hop_(?:fwd|bwd)_kernel)I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ENS_\d+"
                     r"(\w+?Addr)E")


def ptxas_functions(log_text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> ``{function: {"registers", "stack",
    "spill_stores", "spill_loads"}}``, the hop kernels under readable names
    (``hop_fwd_kernel<bf16, V=8, CPL=1, EllAddr>``)."""
    out, fn = {}, None
    for ln in log_text.splitlines():
        m = _PTXAS_FN.search(ln)
        if m:
            k = _KERNEL.search(m.group(1))
            fn = (f"{k[1]}<{'f32' if k[2] == 'f' else 'bf16'}, V={k[3]}, CPL={k[4]}, {k[5]}>"
                  if k else m.group(1))
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = _PTXAS_FRAME.search(ln)
        if m:
            out[fn].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = _PTXAS_REGS.search(ln)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def check_instantiations(functions: dict, expected: int = 24) -> None:
    """Raises unless ``expected`` forward and ``expected`` backward hop
    instantiations are among ``functions`` (``ptxas_functions``), each with
    no stack frame and no spills: a batch's entries and sums are meant to
    live in registers, and the band widths at constant parameter offsets."""
    for kind in ("hop_fwd_kernel", "hop_bwd_kernel"):
        found = {fn: r for fn, r in functions.items() if fn.startswith(kind)}
        bad = [fn for fn, r in found.items()
               if r.get("stack") != 0 or r.get("spill_stores") != 0 or r.get("spill_loads") != 0]
        if len(found) != expected or bad:
            raise AssertionError(f"{kind} instantiations: {len(found)} found ({expected} "
                                 f"expected); with a stack frame or spills: {bad}")


def phase_build() -> dict:
    """Builds both libraries and the mesh core (``g++``, in a thread beside
    the two ``nvcc``) into the directory ``cache.enable_compilation_cache``
    sets; prints registers, stack frame and spills of every kernel, and
    fails unless every library lies in that directory and every forward and
    backward instantiation is there without a stack frame or spills
    (``check_instantiations``)."""
    from concurrent.futures import ThreadPoolExecutor

    from mswe_gnn_tpu_torch import native
    from mswe_gnn_tpu_torch.cache import enable_compilation_cache

    t0 = time.perf_counter()
    cache_dir = enable_compilation_cache()
    with ThreadPoolExecutor(1) as pool:
        core = pool.submit(native.build)
        built = kernel_build.build()
        core = core.result()
    paths = [core] + [info["path"] for info in built.values()]
    if any(os.path.dirname(os.path.abspath(p)) != str(cache_dir) for p in paths):
        raise AssertionError(f"[build] libraries {paths} outside the cache {cache_dir}")
    log(f"[build] the compilation cache (cache.enable_compilation_cache): {cache_dir}; the mesh "
        f"core {core}")
    functions = {}
    for name, info in built.items():
        log(f"[build] {SOURCES[name]} -> {info['path']} in {info['seconds']:.1f} s")
        for fn, r in ptxas_functions(info["log"]).items():
            log(f"[build]   {fn}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
                f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill stores/loads")
            functions[fn] = r
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    check_instantiations(functions)
    return functions


# ---------------------------------------------------------------- phase 3
def make_hop_inputs(seed, n_dst, n_src, degree, feat, dtype, same_block,
                    device="cuda", skew=False):
    """Random hop inputs with dry (all-zero) rows and masked (zero) slots.
    ``skew``: the slots read only the first half of the source rows, and
    slot 0 of the first 80 rows reads source row 1, so that the out-slot
    table has one long list and many empty ones."""
    g = torch.Generator().manual_seed(seed)
    dst = torch.randn(n_dst, feat, generator=g)
    dst[torch.rand(n_dst, generator=g) < 0.3] = 0.0
    if same_block:
        src_rows = n_dst
    else:
        src_rows = n_src
        src = torch.randn(n_src, feat, generator=g)
        src[torch.rand(n_src, generator=g) < 0.3] = 0.0
    tab = torch.randint(0, src_rows, (n_dst, degree), generator=g, dtype=torch.int32)
    if skew:
        tab //= 2
        tab[:80, 0] = 1
    s = torch.randn(n_dst, degree, feat, generator=g)
    s[torch.rand(n_dst, degree, generator=g) < 0.25] = 0.0
    dst = dst.to(device=device, dtype=dtype)
    src = dst if same_block else src.to(device=device, dtype=dtype)
    return dst, src, tab.to(device), s.to(device=device, dtype=dtype)


def upstream(seed, like):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(like.shape, generator=g).to(device=like.device, dtype=like.dtype)


def within_limit(got, want, dtype):
    """(all within the limit, max abs error). Limit: 1e-6 (1 + |ref|) in
    float32, where kernel and plain version add the same terms in the same
    order; one bf16 ulp of the reference value in bfloat16."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if dtype == torch.float32:
        limit = 1e-6 * (1.0 + w.abs())
    else:
        _, exp = torch.frexp(w)           # |w| = m * 2**exp, m in [0.5, 1)
        limit = torch.where(w == 0, torch.zeros_like(w),
                            torch.ldexp(torch.ones_like(w), exp - 8))
    ok = bool(((err <= limit) | (torch.isnan(g) & torch.isnan(w))).all())
    return ok, float(err.nan_to_num(0.0).max()) if err.numel() else 0.0


MODES = {"gradient": (True, False), "upwind": (True, True), "no_gradient": (False, False)}
DTYPES = (torch.float32, torch.bfloat16)


class Checks:
    """Worst error per kernel and dtype over the comparisons of phase 3 and
    of phase 6's bit check."""

    def __init__(self):
        self.worst = {}
        self.count = 0

    def hold(self, kernel, case, dtype, mode, got, want, exact=False) -> float:
        """Holds each output of ``got`` against ``want`` within
        ``within_limit``, or bit for bit (NaN where NaN) with ``exact``;
        -> the largest error."""
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if (a is None) != (b is None):
                raise AssertionError(f"{kernel} {case}: output {i} present on one side only")
            if a is None:
                continue
            ok, err = within_limit(a, b, dtype)
            if exact:
                ok = bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
            key = (kernel, str(dtype).replace("torch.", ""))
            self.worst[key] = max(self.worst.get(key, 0.0), err)
            worst = max(worst, err)
            self.count += 1
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain version: {case} "
                                     f"{dtype} {mode} output {i}, max|err| {err:.3e}"
                                     + (" (bits asked for)" if exact else ""))
        return worst

    def max_err(self, kernel):
        return max(v for (k, _), v in self.worst.items() if k == kernel)


def slot_mask_of(s):
    """Slots whose flux is zero: the out-slot table may leave them out."""
    return (s != 0).any(dim=-1)


def check_ell(checks: Checks) -> None:
    cases = []
    for n in BENCH_ROWS:                                            # processor hops
        cases.append((f"same-block Nd={n}", n, n, DEGREE, FEAT, True))
    for fine, coarse in zip(BENCH_ROWS[:-1], BENCH_ROWS[1:]):       # un-pool hops
        cases.append((f"un-pool Nd={fine} Ns={coarse}", fine, coarse, DEGREE, FEAT, False))
    cases += [("ragged Nd=1000", 1000, 1000, 4, 64, True),
              ("ragged Nd=777 F=20", 777, 777, 3, 20, True),
              ("ragged Nd=333 Ns=91 F=36", 333, 91, 5, 36, False),
              ("wide Nd=515 F=512", 515, 515, 2, 512, True),
              ("wide Nd=129 F=200 Ns=64", 129, 64, 8, 200, False)]
    cases = [c + (False,) for c in cases] + [("skewed Nd=600", 600, 600, 4, 64, True, True),
                                             ("skewed Nd=600 Ns=97", 600, 97, 4, 64, False, True)]
    hop_ops.reset_launches()
    fwd_calls = bwd_calls = 0
    for seed, (name, n_dst, n_src, degree, feat, same, skew) in enumerate(cases):
        for dtype in DTYPES:
            args = make_hop_inputs(seed, n_dst, n_src, degree, feat, dtype, same, skew=skew)
            dst, src, tab, s = args
            # even cases leave the zero-flux slots out of the out-slot table
            table = hop_ops.out_slot_table(tab, src.shape[0],
                                           slot_mask_of(s) if seed % 2 == 0 else None)
            g = upstream(seed + 500, dst)
            for mode, (grad, up) in MODES.items():
                got = hop_ops.hop(*args, with_gradient=grad, upwind=up)
                want = hop_ops.hop_reference(*args, with_gradient=grad, upwind=up)
                fwd_calls += 1
                checks.hold("hop", name, dtype, mode, (got,), (want,))
                got = hop_ops.hop_backward(*args, g, *table, grad, up)
                again = hop_ops.hop_backward(*args, g, *table, grad, up)
                bwd_calls += 2
                want = hop_ops.hop_backward_reference(*args, g, *table, grad, up)
                checks.hold("hop_bwd", name, dtype, mode, got, want)
                if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"hop backward is not deterministic: {name} {mode}")
            log(f"[kernels] hop + hop_bwd {name:28s} {str(dtype)[6:]:8s} 3 modes ok")
    # an index outside the source rows reads NaN (jnp.take's fill mode)
    dst, src, tab, s = make_hop_inputs(99, 64, 64, 4, 64, torch.float32, True)
    tab[5, 2] = 64
    tab[9, 0] = -1
    got = hop_ops.hop(dst, src, tab, s)
    fwd_calls += 1
    torch.cuda.synchronize()
    bad = torch.isnan(got).all(dim=1)
    if not (bool(bad[5]) and bool(bad[9]) and int(bad.sum()) == 2):
        raise AssertionError("out-of-range source index did not give a NaN row")
    if (hop_ops.launches, hop_ops.bwd_launches) != (fwd_calls, bwd_calls):
        raise AssertionError(f"launch counters {hop_ops.launches}/{hop_ops.bwd_launches} "
                             f"!= {fwd_calls}/{bwd_calls} calls")


def banded_problem(seed, n, degree, bw, feat, tail_rows=0, skew=False):
    """Random band-limited slot sources (and, with ``tail_rows``, some that
    read the last rows, as ghost cells do) planned by ``plan_band``.
    ``skew``: the slots read even rows only, and slot 0 of the 80 rows
    around the middle reads the middle row (``bw`` >= 40)."""
    g = torch.Generator().manual_seed(seed)
    src = (torch.arange(n)[:, None]
           + torch.randint(-bw, bw + 1, (n, degree), generator=g)).clamp(0, n - 1)
    if skew:
        src = src // 2 * 2
        src[n // 2 - 40:n // 2 + 40, 0] = n // 2
    if tail_rows:
        rows = torch.randint(0, n - band_ops.TILE, (tail_rows,), generator=g)
        src[rows, 0] = torch.randint(n - 8, n, (tail_rows,), generator=g)
    mask = (torch.rand(n, degree, generator=g) < 0.85).float()
    plan = band_ops.plan_band(src.numpy(), mask.numpy(), n)
    if plan is None or (tail_rows and plan.we == 0):
        raise AssertionError(f"no band plan (tail {tail_rows}) for the test problem")
    return plan, mask


def band_inputs(seed, plan, mask, feat, dtype):
    g = torch.Generator().manual_seed(seed)
    n, degree = plan.idx_rel.shape
    state = torch.randn(n, feat, generator=g)
    state[torch.rand(n, generator=g) < 0.3] = 0.0
    s = torch.randn(n, degree, feat, generator=g) * mask[:, :, None]
    return (state.to("cuda", dtype), s.reshape(n, -1).to("cuda", dtype),
            plan.idx_rel.cuda(), plan.win.cuda())


def check_band(checks: Checks, bench_plans) -> None:
    cases = [(f"bench scale {i} N={p.idx_rel.shape[0]}", p, m, FEAT)
             for i, (p, m) in enumerate(bench_plans)]
    for seed, (n, degree, bw, feat, tail, skew) in enumerate(
            [(512, 4, 40, 64, 0, False), (1024, 4, 6, 32, 40, False), (640, 3, 60, 20, 0, False),
             (1536, 5, 12, 36, 20, False), (256, 2, 20, 200, 0, False),
             (1024, 4, 40, 64, 0, True)]):
        plan, mask = banded_problem(seed, n, degree, bw, feat, tail, skew)
        cases.append((f"N={n} D={degree} F={feat} we={plan.we}{' skewed' if skew else ''}",
                      plan, mask, feat))
    band_ops.reset_launches()
    fwd_calls = bwd_calls = 0
    for seed, (name, plan, mask, feat) in enumerate(cases):
        src = band_ops.band_sources(plan.idx_rel, plan.win, plan.ws, plan.we)
        table = hop_ops.out_slot_table(src.cuda(), src.shape[0],
                                       mask.cuda() if seed % 2 == 0 else None)
        kw_plan = dict(ws=plan.ws, we=plan.we)
        for dtype in DTYPES:
            state, s, idx_rel, win = band_inputs(seed, plan, mask, feat, dtype)
            g = upstream(seed + 700, state)
            for mode, (grad, up) in MODES.items():
                kw = dict(kw_plan, with_gradient=grad, upwind=up)
                got = band_ops.band_hop(state, s, idx_rel, win, **kw)
                want = band_ops.band_hop_reference(state, s, idx_rel, win, **kw)
                fwd_calls += 1
                checks.hold("band_hop", name, dtype, mode, (got,), (want,))
                got = band_ops.band_hop_backward(state, s, idx_rel, win, g, *table, **kw)
                again = band_ops.band_hop_backward(state, s, idx_rel, win, g, *table, **kw)
                bwd_calls += 2
                want = band_ops.band_hop_backward_reference(state, s, idx_rel, win, g,
                                                            *table, **kw)
                checks.hold("band_hop_bwd", name, dtype, mode, got, want)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"band backward is not deterministic: {name} {mode}")
            log(f"[kernels] band_hop + band_hop_bwd {name:26s} {str(dtype)[6:]:8s} "
                f"3 modes ok")
    if (band_ops.launches, band_ops.bwd_launches) != (fwd_calls, bwd_calls):
        raise AssertionError(f"band launch counters {band_ops.launches}/"
                             f"{band_ops.bwd_launches} != {fwd_calls}/{bwd_calls} calls")


def phase_kernels(banded) -> Checks:
    """``banded``: the bench graph with its band plan (scales 0 and 1)."""
    checks = Checks()
    check_ell(checks)
    bench_plans = []
    for i, (plan, meta) in enumerate(zip(banded.band_plan["scales"], banded.band_meta)):
        if plan is None:
            continue
        nsl = banded.spec.node_slice(i)
        bench_plans.append((band_ops.BandPlan(win=plan["win"], idx_rel=plan["idx_rel"],
                                              ws=meta[0], we=meta[1]),
                            banded.in_edge_mask[nsl]))
    check_band(checks, bench_plans)
    torch.cuda.synchronize()
    log(f"[kernels] {checks.count} comparisons within limits (f32: 1e-6*(1+|ref|), "
        f"bf16: one ulp of ref), repeat backward launches bit-identical; worst "
        + ", ".join(f"{k}/{d} {v:.3e}" for (k, d), v in sorted(checks.worst.items())))
    return checks


# ---------------------------------------------------------------- timing harness
def graph_time_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph (so host overhead between launches is not timed), replayed five
    times under CUDA events; the median over replays, divided by ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def bound(nbytes, ops):
    """Least time on an H100: bytes over 3.35 TB/s, float32 operations over
    67 TFLOP/s, the larger -> (ms, bound_by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def hop_work(n_dst, n_src, degree, feat, elem_bytes, same_block, ops_per_term):
    """One forward hop: inputs read once, the output written once (a
    same-block hop reads one state tensor) -> (bytes, ops)."""
    state = n_dst * feat * elem_bytes + (0 if same_block else n_src * feat * elem_bytes)
    nbytes = (state + n_dst * degree * 4 + n_dst * degree * feat * elem_bytes
              + n_dst * feat * elem_bytes)
    ops = n_dst * degree * feat * ops_per_term + n_dst * (degree + 1) * feat  # + row sums
    return nbytes, ops


def hop_bwd_work(n_dst, n_src, degree, feat, elem_bytes, same_block, with_gradient):
    """One backward hop: state(s), flux, upstream gradient and the slot
    table read once; the flux gradient and the state gradient(s) written
    once -> (bytes, ops). The out-slot table is not counted: the gradient
    does not need it, only the kernels' gather design does
    (``table_bytes``). Operations: the flux gradient (2 a term), the gated
    diagonal term (2) and the gathered term (2), and the row sums."""
    row = feat * elem_bytes
    states = n_dst * row + (0 if same_block else n_src * row)
    grads_out = n_src * row + (n_dst * row if with_gradient and not same_block else 0)
    nbytes = (states + n_dst * row                     # g
              + 2 * n_dst * degree * feat * elem_bytes  # s_tab in, gs out
              + n_dst * degree * 4                      # slot sources
              + grads_out)
    ops = n_dst * degree * feat * (6 if with_gradient else 4) + (n_dst + n_src) * feat
    return nbytes, ops


def event_time_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` launched eagerly: CUDA events around
    ``reps`` calls after 3 warm-up calls, divided by ``reps``. For the plain
    versions, which synchronise with the host (a data-dependent loop count)
    and cannot be captured in a CUDA graph; host overhead is included."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_fn(kernel, plain, flush, reps=200) -> dict:
    """Kernel time (CUDA graph), the same with the L2 flushed before every
    launch, and the plain version's time (eager)."""
    def kernel_after_flush():
        flush.zero_()
        kernel()

    return {"ms": graph_time_ms(kernel, reps),
            "cold_l2_ms": graph_time_ms(kernel_after_flush, reps // 2)
            - graph_time_ms(flush.zero_, reps // 2),
            "plain_ms": event_time_ms(plain, 20)}


def table_bytes(table):
    """Bytes of an out-slot table that the backward kernels read: the row
    pointers and the counted entries."""
    out_ptr, _ = table
    return (out_ptr.numel() + int(out_ptr[-1])) * 4


def log_timing(name, row):
    extra = (f"; out-slot table {row['table_bytes'] / 1e6:.2f} MB more, not in the bound"
             if "table_bytes" in row else "")
    if "launch" in row:
        li = row["launch"]
        extra += (f"; launch {li['block']} threads x {li['grid']} blocks, {li['registers']} "
                  f"registers, {li['local_bytes']} B local, {li['smem_bytes']} B shared, "
                  f"{li['warps_per_sm']} warps an SM")
    log(f"[timing] {name} {row['shape']}: kernel {row['ms'] * 1e3:.2f} us "
        f"(L2 flushed {row['cold_l2_ms'] * 1e3:.2f} us), plain {row['plain_ms'] * 1e3:.1f} us, "
        f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bytes'] / 1e6:.2f} MB, "
        f"{row['bound_by']}){extra}")


def launch_floor_ms(reps=200) -> float:
    """The harness's floor: a one-element PyTorch add, captured and replayed
    by ``graph_time_ms`` as the kernels are (a launch of the least work)."""
    one = torch.zeros(1, device="cuda")
    return graph_time_ms(lambda: one.add_(1.0), reps)


def launch_info(fns, dtype, feat, rows, kind="fwd", extra=()) -> dict:
    """The launch a library makes over ``rows`` rows (its ``fwd_info``, or
    with ``kind="bwd"`` its ``bwd_info``, which for the ELL hop takes
    ``extra = (Ns, same_block)``): threads a block, blocks, registers a
    thread, local-memory bytes a thread, blocks one SM holds, lanes a row,
    dynamic shared memory a block; and the warps an SM holds."""
    buf = (ctypes.c_int * 7)()
    hop_ops.check_launch(fns[f"{kind}_info"](hop_ops.DTYPE_CODES[dtype], 1, feat, rows,
                                             *extra, buf), f"{kind} launch info")
    info = dict(zip(("block", "grid", "registers", "local_bytes", "blocks_per_sm", "lanes",
                     "smem_bytes"), buf))
    info["warps_per_sm"] = info["blocks_per_sm"] * info["block"] // 32
    return info


def hops_per_step(cfg, spec, band_meta=None) -> collections.Counter:
    """Hop launches of one model step by ``(kernel, Nd, Ns)``: every
    processor layer runs K hops on its scale (``processor_layers``; the band
    kernel where the scale has a plan), every level of an MSGNN one un-pool
    hop (ELL, K=1). A single-scale SWE-GNN runs ``n_gnn_layers`` x K hops
    over its one block of rows and no un-pool hop; a Cheb / TAG / GAT
    baseline none."""
    planned = {i for i, m in enumerate(band_meta or ()) if m is not None}
    counts = collections.Counter()
    for k, scale in processor_layers(cfg):
        n = spec.node_counts[scale] if is_msgnn(cfg) else spec.num_nodes
        counts[("band_hop" if scale in planned else "hop", n, n)] += k
    for lvl in range(cfg.num_scales - 1 if is_msgnn(cfg) else 0):
        counts[("hop", spec.node_counts[lvl], spec.node_counts[lvl + 1])] += cfg.intra_cfg().K
    return counts


def bench_hop_cases(cache, spec, seed=1000, device="cuda", dtype=torch.bfloat16) -> list:
    """The rollout's ELL hops on a graph's own tables (the ``prepare_graph``
    cache: slot sources and slot masks), by default the bench graph's: the
    processor hop of every scale (gradient mode) and the un-pool hops
    (no-gradient mode), in ``dtype``. States are random with 30% dry rows,
    the flux random with the masked slots zero. -> ``[(shape, (dst, src,
    tab, s), with_gradient, same_block)]``."""
    g = torch.Generator().manual_seed(seed)
    tag = "bf16 bench table" if dtype == torch.bfloat16 else f"{str(dtype)[6:]} table"

    def state(n):
        x = torch.randn(n, FEAT, generator=g)
        x[torch.rand(n, generator=g) < 0.3] = 0.0
        return x.to(device, dtype)

    def flux(mask):
        m = (mask.detach().cpu() > 0).float()
        return (torch.randn(*m.shape, FEAT, generator=g) * m[..., None]).to(device, dtype)

    states = [state(n) for n in spec.node_counts]
    cases = []
    for i, (_, mask, srcs, _, _) in enumerate(cache["scales"]):
        n = spec.node_counts[i]
        cases.append((f"same-block Nd={n} Ns={n} D={srcs.shape[1]} F={FEAT} {tag}",
                      (states[i], states[i], srcs.to(device).contiguous(), flux(mask)),
                      True, True))
    for lvl, (_, umask, usrc, _) in enumerate(cache["unpools"]):
        nd, ns = spec.node_counts[lvl], spec.node_counts[lvl + 1]
        cases.append((f"un-pool Nd={nd} Ns={ns} D={usrc.shape[1]} F={FEAT} {tag}",
                      (states[lvl], states[lvl + 1], usrc.to(device).contiguous(),
                       flux(umask)), False, False))
    return cases


DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "float32"}


def timing_case(kernel, shape, nd, ns, run, plain, work, dtype=torch.bfloat16,
                **extra) -> dict:
    """One row of ``timing_cases``: the kernel, its shape, dtype and launch
    key ``(kernel, Nd, Ns)``, the wrapper and the plain version as calls,
    and the bound of ``work = (bytes, ops)``."""
    ms, by = bound(*work)
    return dict(kernel=kernel, shape=shape, dtype=DTYPE_NAMES[dtype], key=(kernel, nd, ns),
                run=run, plain=plain, bound_ms=ms, bound_by=by, bytes=work[0], ops=work[1],
                **extra)


def ell_timing_cases(cache, spec, backward_shapes, label="", dtype=torch.bfloat16) -> list:
    """The ELL forward on the tables of a graph's cache (``bench_hop_cases``)
    and, at each ``(Nd, Ns)`` of ``backward_shapes``, the ELL backward on
    the same inputs, in ``dtype``; ``label`` prefixes each shape's name."""
    cases, nbytes = [], torch.tensor([], dtype=dtype).element_size()
    for name, args, grad, same in bench_hop_cases(cache, spec, dtype=dtype):
        nd, ns = args[0].shape[0], args[1].shape[0]
        cases.append(timing_case(
            "hop", label + name, nd, ns, partial(hop_ops.hop, *args, with_gradient=grad),
            partial(hop_ops.hop_reference, *args, with_gradient=grad),
            hop_work(nd, ns, DEGREE, FEAT, nbytes, same, 4 if grad else 3), dtype,
            launch=launch_info(hop_ops._kernels(), dtype, FEAT, nd)))
        if (nd, ns) in backward_shapes:
            table = hop_ops.out_slot_table(args[2], ns, slot_mask_of(args[3]))
            g = upstream(3100 + nd, args[0])
            cases.append(timing_case(
                "hop_bwd", label + name, nd, ns,
                partial(hop_ops.hop_backward, *args, g, *table, grad),
                partial(hop_ops.hop_backward_reference, *args, g, *table, grad),
                hop_bwd_work(nd, ns, DEGREE, FEAT, nbytes, same, grad), dtype,
                table_bytes=table_bytes(table),
                launch=launch_info(hop_ops._kernels(), dtype, FEAT, nd, "bwd",
                                   (ns, int(same)))))
    return cases


def band_timing_cases(banded, label="bench plan", dtype=torch.bfloat16) -> list:
    """The band forward and backward on every plan of ``banded``, in
    ``dtype``."""
    spec, cases = banded.spec, []
    nbytes_el = torch.tensor([], dtype=dtype).element_size()
    tag = DTYPE_NAMES[dtype]
    for i, (plan, meta) in enumerate(zip(banded.band_plan["scales"], banded.band_meta)):
        if plan is None:
            continue
        ws, we = meta
        bp = band_ops.BandPlan(win=plan["win"], idx_rel=plan["idx_rel"], ws=ws, we=we)
        mask = banded.in_edge_mask[spec.node_slice(i)]
        state, s, idx_rel, win = band_inputs(2000 + i, bp, mask, FEAT, dtype)
        n = state.shape[0]
        src = band_ops.band_sources(bp.idx_rel, bp.win, ws, we).cuda()
        table = hop_ops.out_slot_table(src, n, mask.cuda())
        g = upstream(2100 + i, state)
        args, kw = (state, s, idx_rel, win), dict(ws=ws, we=we)
        shape = f"scale {i} N={n} D={DEGREE} F={FEAT} ws={ws} we={we} {tag} {label}"
        nbytes, ops = hop_work(n, n, DEGREE, FEAT, nbytes_el, True, 4)
        cases.append(timing_case(
            "band_hop", shape, n, n, partial(band_ops.band_hop, *args, **kw),
            partial(band_ops.band_hop_reference, *args, **kw), (nbytes + win.numel() * 4, ops),
            dtype, launch=launch_info(band_ops._kernels(), dtype, FEAT, n)))
        nbytes, ops = hop_bwd_work(n, n, DEGREE, FEAT, nbytes_el, True, True)
        cases.append(timing_case(
            "band_hop_bwd", shape, n, n,
            partial(band_ops.band_hop_backward, *args, g, *table, **kw),
            partial(band_ops.band_hop_backward_reference, *args, g, *table, **kw),
            (nbytes + win.numel() * 4, ops), dtype, table_bytes=table_bytes(table),
            launch=launch_info(band_ops._kernels(), dtype, FEAT, n, "bwd")))
    return cases


def timing_cases(banded, cache, cfg) -> list:
    """Every kernel at the bench shapes, bf16, as ``phase_timing`` and
    ``kernel_ab.py`` time them: the ELL forward on the rollout's own tables
    (``cache``, ``bench_hop_cases``), the ELL backward at the train step's
    ELL shapes, the band kernels on the bench plans. -> ``[{"kernel",
    "shape", "dtype", "key", "run", "plain", "bound_ms", "bound_by",
    "bytes", "ops", "launch"}]``: ``key`` is ``(kernel, Nd, Ns)`` as the
    wrappers count launches, ``run`` and ``plain`` call the wrapper and the
    plain version on the same inputs, ``launch`` is ``launch_info``; a
    backward also has ``table_bytes``."""
    spec = banded.spec
    train_ell = {(nd, ns) for kernel, nd, ns in hops_per_step(cfg, spec, banded.band_meta)
                 if kernel == "hop"}
    return ell_timing_cases(cache, spec, train_ell) + band_timing_cases(banded)


# ---------------------------------------------------------------- phase 4
@contextlib.contextmanager
def plain_hops():
    """The model with every hop (forward and backward) through the plain
    PyTorch versions under autograd, instead of the kernels."""
    from mswe_gnn_tpu_torch.models import swegnn
    from mswe_gnn_tpu_torch.parallel import dist_swegnn

    def hop_plain(*args, out_table=None, **kw):
        return hop_ops.hop_reference(*args, **kw)

    def band_plain(*args, out_table=None, **kw):
        return band_ops.band_hop_reference(*args, **kw)

    with mock.patch.object(swegnn, "hop", hop_plain), \
            mock.patch.object(dist_swegnn, "hop", hop_plain), \
            mock.patch.object(swegnn, "band_hop", band_plain):
        yield


def timed_rollouts(apply_fn, params, cfg, graph, steps, device, reps=3):
    """-> (median ms, CUDA-event ms, host ms) of ``reps`` rollouts."""
    from mswe_gnn_tpu_torch.training.rollout import rollout

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    event_ms, host_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        rollout(apply_fn, params, cfg, graph, steps, device=device)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
        host_ms.append((time.perf_counter() - h0) * 1e3)
    return statistics.median(event_ms), event_ms, host_ms


def first_step(graph):
    """The graph with step 0's boundary condition injected and step 0's
    forcing columns appended (where the graph has forcing), as the rollout
    feeds its first model step."""
    from mswe_gnn_tpu_torch.training.rollout import bc_window, inject_bc, with_step_forcing

    return with_step_forcing(graph, 0).replace(
        x_dynamic=inject_bc(graph.x_dynamic, graph, bc_window(graph, 0)))


def check_rollout(what, preds, graph, steps) -> None:
    """Raises unless ``preds`` is ``[N, 2, steps]`` for the graph's N rows,
    finite, non-negative and zero on the padded rows."""
    if tuple(preds.shape) != (graph.num_nodes, 2, steps):
        raise AssertionError(f"{what}: shape {tuple(preds.shape)}")
    if not bool(torch.isfinite(preds).all()) or bool((preds < 0).any()):
        raise AssertionError(f"{what}: predictions are not finite and non-negative")
    if bool(preds[graph.node_mask == 0].ne(0).any()):
        raise AssertionError(f"{what}: padded rows are not zero")


def model_label(cfg) -> str:
    if is_msgnn(cfg):
        return f"MSGNN F={cfg.hid_features} K={cfg.K}"
    return (f"GNN/{cfg.type_gnn} F={cfg.hid_features} K={cfg.K} "
            f"layers={cfg.n_gnn_layers}")


def phase_serving(sample, mesh, cfg, params, apply_fn, phase="serving") -> dict:
    """The ``steps``-step rollout of ``sample`` (phase 4; phase 11 (a) on the
    single-scale graph with ``phase="gnn"``)."""
    from mswe_gnn_tpu_torch.models import count_params, prepare_graph
    from mswe_gnn_tpu_torch.training.rollout import rollout

    device = torch.device("cuda")
    spec = sample.spec
    steps = sample.y.shape[-1]
    log(f"[{phase}] nodes {list(spec.node_counts)} padded "
        f"({sum(m.num_faces for m in mesh.meshes)} raw), edges {list(spec.edge_counts)}, "
        f"table widths in/pool/unpool {spec.in_degree}/{spec.pool_degree}/"
        f"{spec.unpool_degree}; {model_label(cfg)} "
        f"mlp_layers={cfg.mlp_layers} {cfg.compute_dtype}, {count_params(params)} "
        f"parameters; {steps} steps")
    graph = sample.to(device)
    # hop launches a step: K of every processor, plus the K=1 un-pool hop of
    # every level: 5 x 5 + 2 x 1 = 27 for the bench model, all ELL; 2 x 10
    # for pareto_gnn's
    expected = rollout_launches(cfg, spec, steps)

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    preds = rollout(apply_fn, params, cfg, graph, steps, device=device)
    torch.cuda.synchronize()
    counts = read_launches()
    hold_launches(phase, f"the {steps}-step rollout", counts, expected)
    check_rollout("the rollout", preds, graph, steps)
    wet = float((preds[:, 0] > 0).float().mean())
    log(f"[{phase}] predictions [{', '.join(map(str, preds.shape))}] finite, >= 0, "
        f"padded rows 0; wet share {wet:.3f}, max {float(preds.max()):.4f}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the first step again, through the kernel and through the plain hop
    with torch.inference_mode():
        g = prepare_graph(params, cfg, graph)
        gt = first_step(g)
        p_kernel = apply_fn(params, cfg, gt)
        with plain_hops():
            p_plain = apply_fn(params, cfg, gt)
    torch.cuda.synchronize()
    # limit: two bf16 ulps of the largest prediction; the kernel and the
    # plain hop agree to the bit on every hop, so any difference is a fault
    limit = 2 * 2.0 ** -8 * float(p_plain.abs().max())
    err = float((p_kernel - p_plain).abs().max())
    err_roll = float((p_kernel - preds[..., 0]).abs().max())
    log(f"[{phase}] step 0 kernel vs plain hop: max|err| {err:.3e} (limit {limit:.3e}); "
        f"vs the rollout's step 0: {err_roll:.3e}")
    if not (err <= limit and err_roll <= limit):
        raise AssertionError("step 0 through the kernel disagrees with the plain hop")

    # three timed rollouts after the counted one
    rollout_ms, event_ms, host_ms = timed_rollouts(apply_fn, params, cfg, graph, steps, device)
    log(f"[{phase}] {steps}-step rollout: {rollout_ms:.1f} ms median of 3 "
        f"(CUDA events {', '.join(f'{t:.1f}' for t in event_ms)} ms; host clock "
        f"{', '.join(f'{t:.1f}' for t in host_ms)} ms)")

    with torch.no_grad():            # the rollout's tables, for the kernel timings
        cache = prepare_graph(params, cfg, graph).ell_cache
    return {"launches": counts, "rollout_ms": rollout_ms, "cache": cache, "preds": preds}


def is_msgnn(cfg) -> bool:
    return type(cfg).__name__ == "MSGNNConfig"


def processor_scales(cfg):
    """The scale of every SWEGNN processor layer, in execution order: the
    V-cycle's for an MSGNN, scale 0 for each layer of a single-scale SWE-GNN
    (whose band plan is that of scale 0), none for a baseline."""
    if not is_msgnn(cfg):
        return [0] * cfg.n_gnn_layers if cfg.type_gnn == "SWEGNN" else []
    L = cfg.num_scales
    return list(range(L - 1)) + list(range(L - 1, -1, -1))


def processor_layers(cfg):
    """``(K, scale)`` of every SWEGNN processor layer (``processor_scales``)."""
    ks = cfg.k_schedule if is_msgnn(cfg) else (cfg.K,) * cfg.n_gnn_layers
    return list(zip(ks, processor_scales(cfg)))


# ---------------------------------------------------------------- phase 5
KERNELS = ("hop", "hop_bwd", "band_hop", "band_hop_bwd")


def rollout_launches(cfg, spec, steps) -> collections.Counter:
    """Launches by ``(kernel, Nd, Ns)`` of a ``steps``-step rollout, from
    the config (``hops_per_step``, no band plan): forwards only."""
    return collections.Counter({key: n * steps for key, n in hops_per_step(cfg, spec).items()})


def train_launches(cfg, spec, band_meta, steps, remat) -> collections.Counter:
    """Launches by ``(kernel, Nd, Ns)`` of one train step, from the config
    (``hops_per_step``): the unroll takes ``steps`` model steps, each hop
    runs one backward, and remat runs every forward twice."""
    out = collections.Counter()
    for (kernel, nd, ns), n in hops_per_step(cfg, spec, band_meta).items():
        out[kernel, nd, ns] += (2 if remat else 1) * n * steps
        out[kernel + "_bwd", nd, ns] += n * steps
    return out


def by_kernel(counts) -> dict:
    """Launches by ``(kernel, Nd, Ns)`` -> by kernel."""
    out = dict.fromkeys(KERNELS, 0)
    for (kernel, _, _), n in counts.items():
        out[kernel] += n
    return out


def read_launches() -> collections.Counter:
    """The launches the wrappers counted by ``(kernel, Nd, Ns)`` since
    ``reset_all_launches``, checked against their totals by kernel."""
    counts = hop_ops.launches_by_shape + band_ops.launches_by_shape
    totals = {"hop": hop_ops.launches, "hop_bwd": hop_ops.bwd_launches,
              "band_hop": band_ops.launches, "band_hop_bwd": band_ops.bwd_launches}
    if by_kernel(counts) != totals:
        raise AssertionError(f"launches by shape {dict(counts)} do not sum to {totals}")
    return counts


def reset_all_launches():
    hop_ops.reset_launches()
    band_ops.reset_launches()


def hold_launches(phase, what, counts, expected) -> None:
    """Logs the counted launches by kernel and by shape; raises unless each
    is the one the config gives."""
    log(f"[{phase}] {what} launched {by_kernel(counts)}; by (kernel, Nd, Ns): "
        + ", ".join(f"{k}: {n}" for k, n in sorted(counts.items())))
    if counts != expected:
        raise AssertionError(f"{what}: launches {dict(counts)}, expected {dict(expected)}")
    log(f"[{phase}] every count as the config gives (hops_per_step)")


def flat(tree):
    from mswe_gnn_tpu_torch import tree_leaves
    return torch.cat([t.double().reshape(-1) for t in tree_leaves(tree)])


def leaf_names(tree, prefix="") -> list:
    """The path of each tensor of a tree, in ``tree_leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}.{k}".lstrip("."))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return []


def compare_grads(loss_k, grads_k, loss_p, grads_p) -> dict:
    """The loss and gradients through the kernels against those through the
    plain hops; ``worst`` names the three leaves of largest max|diff| /
    max|leaf|, each with its max|diff| and max|leaf|."""
    from mswe_gnn_tpu_torch import tree_leaves
    a, b = flat(grads_k), flat(grads_p)
    pairs = list(zip(tree_leaves(grads_k), tree_leaves(grads_p)))
    diffs = [(float((x - y).abs().max()), float(y.abs().max())) for x, y in pairs]
    ratios = [d / max(m, 1e-30) for d, m in diffs]
    order = sorted(range(len(diffs)), key=ratios.__getitem__, reverse=True)[:3]
    names = leaf_names(grads_p)
    return {"loss_rel": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "cos": float(a @ b / (a.norm() * b.norm())),
            "rel": float((a - b).norm() / b.norm()),
            "worst_leaf": ratios[order[0]],
            "worst": [(names[i], ratios[i], *diffs[i]) for i in order],
            "leaves_within": all(d <= 1e-4 * m + 1e-12 for d, m in diffs)}


@contextlib.contextmanager
def deterministic(phase):
    """PyTorch's deterministic algorithms while the block runs, so that a
    gradient comparison reads the same in every run: autograd of the plain
    hops' ``index_select`` then adds its ``index_add_`` terms in a fixed
    order, not by atomics in the compute dtype (the kernels use none). Ops
    without a deterministic version warn; their messages are logged."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                  if "deterministic" in str(w.message)})
    if ops:
        log(f"[{phase}] ops without a deterministic version in the gradient comparison: {ops}")


def hold_grads(phase, args):
    """The loss and gradients of ``loss_and_grads(*args)`` through the
    kernels (in the config's dtype, bf16 as trained) against those through
    the plain hops, in bf16 and in float32, every pass under
    ``deterministic`` -> ``(bf16, f32, (loss, grads) through the kernels,
    the same in float32)``; raises past the limits. A float32 config is
    held once, in float32 (``bf16`` is None)."""
    from mswe_gnn_tpu_torch.training.train import loss_and_grads

    apply_fn, params, cfg, graph, rollout_steps, opts, multiscale = args
    with deterministic(phase):
        kernels = loss_and_grads(*args)
        with plain_hops():
            loss_p, grads_p = loss_and_grads(*args)
        if cfg.compute_dtype == "float32":
            # a float32 model (pareto_gnn's): its pass is the float32 one
            bf16, kernels32, loss_p32, grads_p32 = None, kernels, loss_p, grads_p
        else:
            bf16 = compare_grads(*kernels, loss_p, grads_p)
            args32 = (apply_fn, params, dataclasses.replace(cfg, compute_dtype="float32"),
                      graph, rollout_steps, opts, multiscale)
            kernels32 = loss_and_grads(*args32)
            with plain_hops():
                loss_p32, grads_p32 = loss_and_grads(*args32)
    f32 = compare_grads(*kernels32, loss_p32, grads_p32)
    for name, r, limits in (("bf16", bf16, "loss 1e-5, cosine >= 0.99999, L2 <= 3e-3, "
                                           "worst leaf <= 0.25"),
                            ("float32", f32, "loss 1e-6, every leaf max|diff| <= "
                                             "1e-4 max|leaf| + 1e-12")):
        if r is not None:
            log(f"[{phase}] kernels vs plain hops, {name}: loss rel diff "
                f"{r['loss_rel']:.3e}; gradient cosine {r['cos']:.8f}, relative L2 diff "
                f"{r['rel']:.3e}, worst leaf max|diff|/max|leaf| {r['worst_leaf']:.3e} "
                f"(limits: {limits}); worst leaves "
                + "; ".join(f"{n} {q:.3e} (max|diff| {d:.3e}, max|leaf| {m:.3e})"
                            for n, q, d, m in r["worst"]))
    if bf16 is not None and not (bf16["loss_rel"] <= 1e-5 and bf16["cos"] >= 0.99999
                                 and bf16["rel"] <= 3e-3 and bf16["worst_leaf"] <= 0.25):
        raise AssertionError(f"[{phase}] bf16 train-step gradients through the kernels "
                             "disagree with the plain hops")
    if not (f32["loss_rel"] <= 1e-6 and f32["leaves_within"]):
        raise AssertionError(f"[{phase}] float32 train-step gradients through the kernels "
                             "disagree with the plain hops")
    return bf16, f32, kernels, kernels32


def check_first_grads(phase, loss, grads) -> None:
    from mswe_gnn_tpu_torch import tree_leaves
    leaves = tree_leaves(grads)
    bad = [i for i, g in enumerate(leaves)
           if not bool(torch.isfinite(g).all()) or not bool(g.ne(0).any())]
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f"loss {float(loss)}; gradient leaves not finite or all "
                             f"zero: {bad} of {len(leaves)}")
    log(f"[{phase}] loss {float(loss):.6f}; all {len(leaves)} gradient leaves finite "
        f"and not all zero; global grad norm {float(flat(grads).norm()):.4e}")


def timed_train_steps(phase, step, expected):
    """A warm-up step with its launches counted and held against
    ``expected``, then 3 timed ones (CUDA events and the host clock) ->
    (launches, median ms, losses, peak GiB); raises unless the loss is
    finite and falls over the 4 steps (the loss of a step is taken before
    its update)."""
    torch.cuda.reset_peak_memory_stats()
    losses, event_ms, host_ms = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(4):
        torch.cuda.synchronize()
        if i == 0:
            reset_all_launches()
        h0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if i == 0:
            launches = read_launches()
            hold_launches(phase, f"one train step (remat={step.opts.remat})", launches,
                          expected)
        else:
            event_ms.append(start.elapsed_time(end))
            host_ms.append((time.perf_counter() - h0) * 1e3)
    step_ms = statistics.median(event_ms)
    log(f"[{phase}] 6-step pushforward train step (remat, batch {step.opts.batch_size}, "
        f"{step.cfg.compute_dtype}): {step_ms:.1f} ms median of 3 (CUDA events "
        f"{', '.join(f'{t:.1f}' for t in event_ms)} ms; host clock "
        f"{', '.join(f'{t:.1f}' for t in host_ms)} ms); losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss not finite and falling over 4 steps: {losses}")
    return launches, step_ms, losses, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train(banded, cfg, params, apply_fn, phase="train") -> dict:
    """The bench train step on ``banded`` (phase 5; phase 11 (b) on the
    single-scale graph with ``phase="gnn"``, ``multiscale`` False)."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_train_step
    from mswe_gnn_tpu_torch.training.train import eval_step

    device = torch.device("cuda")
    multiscale = is_msgnn(cfg)
    log(f"[{phase}] band_meta {banded.band_meta}")
    step = build_bench_train_step(banded, cfg, params, apply_fn, device=device,
                                  multiscale=multiscale)
    expected = train_launches(cfg, banded.spec, banded.band_meta, step.rollout_steps,
                              step.opts.remat)

    # the gradients of the first step, through the kernels and through the
    # plain hops (autograd of the plain versions)
    args = (apply_fn, step.params, cfg, step.graph, step.rollout_steps, step.opts, multiscale)

    # bf16, as trained: the kernels sum a state gradient in float32 and round
    # once, autograd of the plain hops rounds at other points, so the limits
    # sit a few times above the readings of earlier runs (L2 4.7e-4, worst
    # leaf 8e-2; the worst leaf is a PReLU slope whose gradient is near 0).
    # float32: every hop agrees with its plain version to the bit and only
    # the order of the gradient sums differs, so every leaf is held to 1e-4
    # of its largest value (the CPU parity tests' limit against JAX); this
    # pass shows that the bf16 gaps are rounding, not a fault in the
    # autograd Functions.
    bf16, f32, (loss_k, grads_k), _ = hold_grads(phase, args)
    check_first_grads(phase, loss_k, grads_k)

    launches, step_ms, losses, peak = timed_train_steps(phase, step, expected)

    steps = step.graph.y.shape[-1]
    t0 = time.perf_counter()
    metrics = eval_step(step.params, step.graph, apply_fn=apply_fn, cfg=cfg, steps=steps,
                        opts=step.opts, multiscale=multiscale, device=device)
    eval_s = time.perf_counter() - t0
    if not (math.isfinite(metrics["val_loss"]) and 0.0 <= metrics["val_CSI_005"] <= 1.0):
        raise AssertionError(f"eval_step metrics {metrics}")
    log(f"[{phase}] eval_step over {steps} steps in {eval_s:.2f} s: "
        + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
        + f"; peak device memory of the 4 train steps {peak:.2f} GiB")
    return {"launches": launches, "step_ms": step_ms, "losses": losses,
            "grads_bf16": bf16, "grads_f32": f32, "peak_gib": peak, "eval": metrics}


# ---------------------------------------------------------------- phase 7
SERVING_BATCHES = (4, 20)
TRAIN_BATCH = 4


def graph_rows(spec, b, g, device):
    """The rows of graph ``g`` in the union of ``b`` graphs of ``spec``, in
    that graph's own row order."""
    tiled = spec.tile(b)
    return torch.cat([torch.arange(tiled.node_ptr[s] + g * n, tiled.node_ptr[s] + (g + 1) * n)
                      for s, n in enumerate(spec.node_counts)]).to(device)


def phase_batched_serving(sample, cfg, params, apply_fn, serving) -> dict:
    """The 47-step rollout on concat unions of ``SERVING_BATCHES`` copies of
    the bench graph: launches by shape against the tiled spec's, the output
    checked, every graph's step 0 against the batch-1 rollout's, and the
    seconds a simulation."""
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.models import prepare_graph
    from mswe_gnn_tpu_torch.training.rollout import rollout

    device = torch.device("cuda")
    spec, steps = sample.spec, sample.y.shape[-1]
    single = serving["preds"]
    # phase 4's limit: two bf16 ulps of the largest prediction
    limit = 2 * 2.0 ** -8 * float(single[..., 0].abs().max())
    out = {"launches": {}, "caches": {}, "s_per_sim": {1: serving["rollout_ms"] / 1e3}}
    for b in SERVING_BATCHES:
        t0 = time.perf_counter()
        union = concat_graphs([sample] * b)
        build_s = time.perf_counter() - t0
        if union.num_graphs != b or union.band_plan is not None:
            raise AssertionError(f"union of {b}: num_graphs {union.num_graphs}")
        graph = union.to(device)
        expected = rollout_launches(cfg, spec.tile(b), steps)
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        preds = rollout(apply_fn, params, cfg, graph, steps, device=device)
        torch.cuda.synchronize()
        counts = read_launches()
        hold_launches("batched serving", f"the {steps}-step rollout of a union of {b}", counts,
                      expected)
        check_rollout(f"the rollout of a union of {b}", preds, graph, steps)
        err0 = err_all = 0.0
        for g in range(b):
            mine = preds.index_select(0, graph_rows(spec, b, g, device))
            err0 = max(err0, float((mine[..., 0] - single[..., 0]).abs().max()))
            err_all = max(err_all, float((mine - single).abs().max()))
        log(f"[batched serving] union of {b} ({build_s:.1f} s to build on the host): "
            f"predictions [{', '.join(map(str, preds.shape))}] finite, >= 0, padded rows 0; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; every "
            f"graph's step 0 vs the batch-1 rollout: max|err| {err0:.3e} (limit {limit:.3e}); "
            f"worst per-graph difference over the {steps} steps {err_all:.3e}")
        if not err0 <= limit:
            raise AssertionError(f"union of {b}: a graph's step 0 disagrees with batch 1")
        del preds
        ms, event_ms, host_ms = timed_rollouts(apply_fn, params, cfg, graph, steps, device)
        out["s_per_sim"][b] = ms / 1e3 / b
        log(f"[batched serving] union of {b}: {steps}-step rollout {ms:.1f} ms median of 3 "
            f"(CUDA events {', '.join(f'{t:.1f}' for t in event_ms)} ms; host clock "
            f"{', '.join(f'{t:.1f}' for t in host_ms)} ms) -> {out['s_per_sim'][b]:.4f} s "
            f"a simulation")
        out["launches"][b] = counts
        with torch.no_grad():       # the union's tables, for the kernel timings
            out["caches"][b] = (prepare_graph(params, cfg, graph).ell_cache, graph.spec)
    log("[batched serving] seconds a simulation by batch: "
        + ", ".join(f"{b}: {v:.4f}" for b, v in out["s_per_sim"].items()))
    return out


# ---------------------------------------------------------------- phase 8
def phase_batched_train(banded, sample, cfg, params, apply_fn) -> dict:
    """The bench train step on a union of ``TRAIN_BATCH`` copies of the
    banded sample (all ELL, as in JAX): launches, gradients against the
    plain hops, the union against one copy in float32, the out-slot tables'
    cost, timed steps, and ``tune_batch_size`` over (1, 2, 4)."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_train_step
    from mswe_gnn_tpu_torch.models import prepare_graph
    from mswe_gnn_tpu_torch.training.train import loss_and_grads, tune_batch_size

    device = torch.device("cuda")
    b = TRAIN_BATCH
    step = build_bench_train_step(banded, cfg, params, apply_fn, device=device, batch=b)
    union = step.graph
    if union.num_graphs != b or union.band_plan is not None:
        raise AssertionError("the batched train step's union must be all ELL")
    expected = train_launches(cfg, union.spec, union.band_meta, step.rollout_steps,
                              step.opts.remat)
    log(f"[batched train] union of {b}: nodes {list(union.spec.node_counts)}; launches the "
        f"config gives a step: {by_kernel(expected)}")

    args = (apply_fn, step.params, cfg, union, step.rollout_steps, step.opts, True)
    bf16, f32, (loss_k, grads_k), (loss32, grads32) = hold_grads("batched train", args)
    check_first_grads("batched train", loss_k, grads_k)

    # in float32 the union of b identical copies has the loss and the
    # gradients of one copy (concat-then-mean)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    one = loss_and_grads(apply_fn, step.params, cfg32, sample.to(device), step.rollout_steps,
                         step.opts, True)
    copy = compare_grads(loss32, grads32, *one)
    log(f"[batched train] float32 union of {b} copies vs one copy: loss rel diff "
        f"{copy['loss_rel']:.3e} (limit 1e-5), worst leaf max|diff|/max|leaf| "
        f"{copy['worst_leaf']:.3e} (limit 1e-4)")
    if not (copy["loss_rel"] <= 1e-5 and copy["leaves_within"]):
        raise AssertionError(f"the union of {b} copies disagrees with one copy")

    # what the out-slot tables (built with gradients on) add to prepare_graph
    def prepare():
        prepare_graph(step.params, cfg, union)

    with torch.enable_grad():
        grad_ms = event_time_ms(prepare, 3)
    with torch.no_grad():
        nograd_ms = event_time_ms(prepare, 3)
    log(f"[batched train] prepare_graph on the union of {b}: {grad_ms:.2f} ms with gradients "
        f"on (out-slot tables built), {nograd_ms:.2f} ms without; the tables cost "
        f"{grad_ms - nograd_ms:.2f} ms a train step (mean of 3 after 3, CUDA events)")

    launches, step_ms, losses, peak = timed_train_steps("batched train", step, expected)
    log(f"[batched train] {b / step_ms * 1e3:.3f} simulations/s; peak device memory of the 4 "
        f"steps {peak:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    best, rates = tune_batch_size(apply_fn, cfg, params, [banded] * b, step.opts,
                                  candidates=(1, 2, 4), device=device)
    tune_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[batched train] tune_batch_size (1, 2, 4), 6-step pushforward: simulations/s "
        + ", ".join(f"{k}: {v:.3f}" for k, v in rates.items())
        + f"; fastest {best}; peak device memory {tune_peak:.2f} GiB")
    if sorted(rates) != [1, 2, 4]:
        raise AssertionError(f"tune_batch_size stopped early: {rates}")
    with torch.no_grad():           # the union's tables, for the kernel timings
        cache = prepare_graph(step.params, cfg, union).ell_cache
    return {"launches": launches, "step_ms": step_ms, "losses": losses, "grads_bf16": bf16,
            "grads_f32": f32, "copy": copy, "peak_gib": peak, "tune": rates,
            "cache": (cache, union.spec)}


# ---------------------------------------------------------------- phase 9
def phase_trainer() -> dict:
    """The Trainer at demo_small's width (configs/demo_small.yaml: MSGNN F=64,
    K=4, mlp_layers=3, previous_t=3, 3 scales) on a small synthetic set, at
    batch 4 with a ragged tail, batches assembled on the card
    (DeviceConcatPlan), watch norms every epoch and checkpoints in a
    temporary directory: fit 2 epochs, save, resume into a new Trainer,
    fit 1 more."""
    import tempfile

    from mswe_gnn_tpu_torch import tree_leaves
    from mswe_gnn_tpu_torch.data.dataset import (fit_dataset_scalers, make_spec,
                                                 process_record, to_temporal_samples,
                                                 union_spec)
    from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
    from mswe_gnn_tpu_torch.models import build_model
    from mswe_gnn_tpu_torch.training.train import Trainer, TrainerOptions

    device = torch.device("cuda")
    t0 = time.perf_counter()
    records = generate_dataset(3, seed=0, nx=16, ny=16, num_scales=3, total_hours=12,
                               substeps=8)
    scalers = fit_dataset_scalers(records[:2], {"area_scaler": "standard",
                                                "edge_length_scaler": "standard"})
    procs = [process_record(r, scalers) for r in records]
    spec = union_spec([make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 64)
                       for r in records])
    train = [s for p in procs[:2]
             for s in to_temporal_samples(p, spec, previous_t=3, rollout_steps=2)][:6]
    val = to_temporal_samples(procs[2], spec, previous_t=3, rollout_steps=4)[:5]
    g = train[0]
    cfg, params, apply_fn = build_model(
        {"model_type": "MSGNN", "hid_features": 64, "K": 4, "mlp_layers": 3,
         "learned_residuals": True, "with_WL": True},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=3, device=device)
    opts = TrainerOptions(batch_size=4, max_epochs=3, curriculum_epoch=1, max_rollout_steps=2,
                          velocity_scaler=7.0, watch_every=1)
    log(f"[trainer] {len(train)} training samples (one union of 4 an epoch, a tail of 2 "
        f"dropped), {len(val)} validation samples (unions of 4 and 1), nodes "
        f"{list(spec.node_counts)}, built in {time.perf_counter() - t0:.1f} s")

    def trainer(ckpt):
        return Trainer(apply_fn, cfg, params, opts, train, val, checkpoint_dir=ckpt,
                       checkpoint_every=2, device=device)

    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_trainer_",
                                     dir=kernel_build.BUILD_DIR) as tmp:
        ckpt = os.path.join(tmp, "autosave")
        first = trainer(ckpt)
        t0 = time.perf_counter()
        first.fit(max_epochs=2)
        fit_s = time.perf_counter() - t0
        if not any(stacked is not None for _, stacked, _ in first._resident.values()):
            raise AssertionError("the Trainer did not assemble its batches on the card")
        missing = [f for f in ("meta.json", "params.npz", "opt_state.npz", "heartbeat")
                   if not os.path.exists(os.path.join(ckpt, f))]
        if missing:
            raise AssertionError(f"autosave files missing: {missing}")
        first.save(ckpt, 2)
        second = trainer(ckpt)
        start = second.resume(ckpt)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(second.params),
                                                    tree_leaves(first.params)))
        saved = first.optimizer.state_tree(first.opt_state, first.params)
        restored = second.optimizer.state_tree(second.opt_state, second.params)
        same_opt = all(torch.equal(a, b) and a.device == b.device
                       for a, b in zip(tree_leaves(saved), tree_leaves(restored)))
        if not (start == 2 and same and same_opt and second.opt_state["count"] == 2):
            raise AssertionError(f"resume: start_epoch {start}, parameters equal {same}, "
                                 f"optimizer state equal {same_opt}")
        history = second.fit(max_epochs=3)
    epochs = [r["epoch"] for r in history]
    if epochs != [0, 1, 2] or not all(math.isfinite(r["train_loss"]) for r in history):
        raise AssertionError(f"resumed history {history}")
    watch = sorted(k for k in history[-1] if k.startswith("watch/"))
    log(f"[trainer] fit 2 epochs in {fit_s:.1f} s; autosave and heartbeat written; resumed "
        f"at epoch {start} with parameters and optimizer state bit-equal to the saved ones; "
        f"history epochs {epochs}, train losses "
        + ", ".join(f"{r['train_loss']:.6f}" for r in history)
        + f", val_CSI_005 {history[-1].get('val_CSI_005', float('nan')):.4f}; "
        f"{len(watch)} watch norms a watched epoch")
    return {"history": history}


# ---------------------------------------------------------------- phase 10
CLI_CONFIG = "configs/accuracy_tri.yaml"
CLI_CUTS = {("synthetic_data", "n_sims"): 12, ("trainer_options", "max_epochs"): 2,
            ("trainer_options", "curriculum_epoch"): 1}
TRAINED_WEIGHTS = "results_repo/checkpoints/accuracy_tri_r5_torch/best"


def is_timing_key(key) -> bool:
    """A summary key that times the run (prediction seconds, speed-ups
    against the solver), which two runs of the same weights do not share."""
    return key == "mean_prediction_time_s" or key.startswith("speed_up")


def cli_run(args) -> collections.Counter:
    """``mswe_gnn_tpu_torch.main.main(args)`` on the card, its launches
    counted from 0 -> the launches by ``(kernel, Nd, Ns)``."""
    from mswe_gnn_tpu_torch import main as cli

    reset_all_launches()
    rc = cli.main(args)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"main({args}) returned {rc}")
    return read_launches()


def read_json(path):
    with open(path) as f:
        return json.load(f)


def hold_path_shapes(checks, path, cfg, params, samples, counts, most, device="cuda") -> dict:
    """Holds the ELL forward (and, where the path ran it, the backward) in
    float32 and in every mode at each ``(Nd, Ns)`` that ``path`` launched
    (``counts``), on the tables of a union of the path's own ``samples``
    whose size gives that shape (each union of 1 to ``most`` graphs whose
    finest-scale hop was launched, its shapes from ``hops_per_step`` of the
    tiled spec), against the plain versions within ``within_limit``
    (into ``checks``). Raises if a launched shape is held nowhere. -> the
    union sizes built, each with the shapes held on it."""
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.models import prepare_graph

    launched = {key for key, n in counts.items() if n}
    spec, held, sizes = samples[0].spec, set(), {}
    worst = {"hop": 0.0, "hop_bwd": 0.0}
    for b in range(1, most + 1):
        # a union of b graphs ran where its finest scale's hop did (a coarser
        # scale's rows may equal another union's finer ones)
        n0 = b * spec.node_counts[0]
        if ("hop", n0, n0) not in launched:
            continue
        fwd = launched & set(hops_per_step(cfg, spec.tile(b)))
        if b > len(samples):
            raise AssertionError(f"[cli] {path}: a union of {b} of {len(samples)} samples")
        graph = (samples[0] if b == 1 else concat_graphs(samples[:b])).to(device)
        with torch.no_grad():
            cache = prepare_graph(params, cfg, graph).ell_cache
        sizes[b] = []
        for name, args, _, _ in bench_hop_cases(cache, graph.spec, seed=4000 + b,
                                                device=device, dtype=torch.float32):
            nd, ns = args[0].shape[0], args[1].shape[0]
            if ("hop", nd, ns) not in fwd:
                continue
            backward = ("hop_bwd", nd, ns) in launched
            table = hop_ops.out_slot_table(args[2], ns, slot_mask_of(args[3]))
            g = upstream(4100 + nd, args[0])
            case = f"{path} union of {b} {name}"
            for mode, (grad, up) in MODES.items():
                worst["hop"] = max(worst["hop"], checks.hold(
                    "hop", case, torch.float32, mode,
                    (hop_ops.hop(*args, with_gradient=grad, upwind=up),),
                    (hop_ops.hop_reference(*args, with_gradient=grad, upwind=up),)))
                if backward:
                    worst["hop_bwd"] = max(worst["hop_bwd"], checks.hold(
                        "hop_bwd", case, torch.float32, mode,
                        hop_ops.hop_backward(*args, g, *table, grad, up),
                        hop_ops.hop_backward_reference(*args, g, *table, grad, up)))
            held |= {("hop", nd, ns)} | ({("hop_bwd", nd, ns)} if backward else set())
            sizes[b].append((nd, ns, backward))
    missing = launched - held
    if missing:
        raise AssertionError(f"[cli] {path}: launched shapes held nowhere: {sorted(missing)}")
    log(f"[cli] {path}: every launched shape held against the plain versions in float32, "
        "3 modes, on the path's own union tables: "
        + "; ".join(f"union of {b}: " + ", ".join(
            f"({nd}, {ns}){' +bwd' if bwd else ''}" for nd, ns, bwd in shapes)
            for b, shapes in sizes.items())
        + f"; max|err| forward {worst['hop']:.3e}, backward {worst['hop_bwd']:.3e}")
    return sizes


def hold_union_rollout(cfg, params, apply_fn, graphs) -> float:
    """The full rollout of the ``concat_graphs`` union of ``graphs`` through
    the kernels against the same rollout through the plain hops, within
    ``within_limit`` in float32 -> the largest difference."""
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.training.rollout import rollout

    union = concat_graphs(graphs)
    steps = int(union.y.shape[-1])
    got = rollout(apply_fn, params, cfg, union, steps, device="cuda")
    with plain_hops():
        want = rollout(apply_fn, params, cfg, union, steps, device="cuda")
    torch.cuda.synchronize()
    check_rollout(f"[cli] rollout of a union of {len(graphs)}", got, union.to("cuda"), steps)
    ok, err = within_limit(got, want, torch.float32)
    if not ok:
        raise AssertionError(f"[cli] the rollout of a union of {len(graphs)} through the "
                             f"kernels differs from the plain hops: max|err| {err:.3e}")
    return err


def hold_train_union_grads(cfg, params, apply_fn, samples, opts, rollout_steps) -> dict:
    """The loss and gradients of one train step on a ``concat_graphs`` union
    of ``opts.batch_size`` training samples, float32, through the kernels
    against autograd of the plain hops, at phase 5's float32 limits."""
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.training.train import loss_and_grads

    union = concat_graphs(samples[:opts.batch_size]).to("cuda")
    if union.num_graphs != opts.batch_size:
        raise AssertionError(f"[cli] a training union of {union.num_graphs}")
    args = (apply_fn, params, cfg, union, rollout_steps, opts, True)
    with deterministic("cli"):
        kernels = loss_and_grads(*args)
        with plain_hops():
            plain = loss_and_grads(*args)
    r = compare_grads(*kernels, *plain)
    log(f"[cli] one train step on a union of {opts.batch_size} ({rollout_steps}-step "
        f"pushforward, remat {opts.remat}, float32), kernels vs plain hops: loss rel diff "
        f"{r['loss_rel']:.3e}, gradient cosine {r['cos']:.8f}, worst leaf "
        f"max|diff|/max|leaf| {r['worst_leaf']:.3e} (limits: loss 1e-6, every leaf "
        f"max|diff| <= 1e-4 max|leaf| + 1e-12)")
    if not (r["loss_rel"] <= 1e-6 and r["leaves_within"]):
        raise AssertionError("[cli] float32 train-step gradients on the training union "
                             "disagree with the plain hops")
    return r


CLI_FILES = ("best/params.npz", "best/meta.json", "last/params.npz", "last/meta.json",
             "autosave/params.npz", "autosave/opt_state.npz", "autosave/meta.json",
             "autosave/heartbeat", "autosave/best_val/params.npz", "metrics.jsonl",
             "metrics.csv", "config.json", "summary.json")


def cut_config(phase, path, cuts) -> dict:
    """The YAML config at ``path`` (from the repository root) with ``cuts``
    applied, each cut printed."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as f:
        cfg = yaml.safe_load(f)
    for (group, key), value in cuts.items():
        log(f"[{phase}] cut: {group}.{key} {cfg[group].get(key)} -> {value}")
        cfg[group][key] = value
    return cfg


@contextlib.contextmanager
def cli_workdir(prefix):
    """A temporary directory under the build directory, with the records
    cache (``MSWE_DATA_CACHE``) inside it while the block runs."""
    import tempfile

    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    old_cache = os.environ.get("MSWE_DATA_CACHE")
    with tempfile.TemporaryDirectory(prefix=prefix, dir=kernel_build.BUILD_DIR) as tmp:
        os.environ["MSWE_DATA_CACHE"] = os.path.join(tmp, "cache")
        try:
            yield tmp
        finally:
            if old_cache is None:
                os.environ.pop("MSWE_DATA_CACHE", None)
            else:
                os.environ["MSWE_DATA_CACHE"] = old_cache


def cli_train_and_eval(phase, cfg, tmp, name) -> dict:
    """``train`` of ``cfg`` (written to ``tmp/name.yaml``) on the card: every
    file written, a finite 2-epoch history, the ELL forward and backward
    launched; then ``eval`` of its ``best``, whose summary must equal the
    training one within 1e-5. -> the config path, the run's directory, the
    launches of each run, the history, the summaries and the train seconds."""
    import yaml

    cfg_path = os.path.join(tmp, f"{name}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    train_dir = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    train_counts = cli_run(["train", "--config", cfg_path, "--out", train_dir])
    train_s = time.perf_counter() - t0
    missing = [p for p in CLI_FILES if not os.path.exists(os.path.join(train_dir, p))]
    if missing:
        raise AssertionError(f"[{phase}] train wrote no {missing}")
    history = read_json(os.path.join(train_dir, "best", "meta.json"))["history"]
    if ([r["epoch"] for r in history] != [0, 1]
            or not all(math.isfinite(r["train_loss"]) for r in history)):
        raise AssertionError(f"[{phase}] history {history}")
    launched = by_kernel(train_counts)
    if not (launched["hop"] and launched["hop_bwd"]):
        raise AssertionError(f"[{phase}] train launched {launched}")
    train_summary = read_json(os.path.join(train_dir, "summary.json"))
    log(f"[{phase}] train: {train_s:.1f} s in all; epochs "
        + ", ".join(f"{r['epoch']} (rollout_steps {r['rollout_steps']}, "
                    f"train_loss {r['train_loss']:.6f}, "
                    f"{r['epoch_time']:.2f} s)" for r in history)
        + f"; launched {launched}; every file written")

    eval_counts = cli_run(["eval", "--config", cfg_path, "--ckpt",
                           os.path.join(train_dir, "best"), "--out", os.path.join(tmp, "eval")])
    eval_summary = read_json(os.path.join(tmp, "eval", "summary.json"))
    worst = max(abs(eval_summary[k] - v) for k, v in eval_summary.items()
                if not is_timing_key(k))
    if worst >= 1e-5:
        raise AssertionError(f"[{phase}] eval {eval_summary} != train {train_summary}")
    log(f"[{phase}] eval of the new best: the training summary within {worst:.2e}; "
        f"mean_prediction_time_s {eval_summary['mean_prediction_time_s']:.4f}; "
        f"launched {by_kernel(eval_counts)}")
    return {"cfg_path": cfg_path, "train_dir": train_dir, "train_counts": train_counts,
            "eval_counts": eval_counts, "history": history, "train_summary": train_summary,
            "eval_summary": eval_summary, "train_s": train_s}


def hold_cli_shapes(checks, cfg, run, paths):
    """Every ``(Nd, Ns)`` that the runs of ``paths`` (``(name, split,
    counts)``, split 0 train, 2 test) launched, held against the plain
    versions on the run's own unions, with the weights of its ``best`` ->
    ``prepare_data(cfg)``."""
    from mswe_gnn_tpu_torch import config as config_lib
    from mswe_gnn_tpu_torch import main as cli

    full = config_lib.with_defaults(cfg)
    data = cli.prepare_data(full)
    mcfg, params, _ = cli.build_experiment_model(full, data[2][0], device="cuda")
    params = cli.restore_weights(os.path.join(run["train_dir"], "best"), params)
    opts = cli.trainer_options(full)
    most = max(opts.batch_size, int(full["trainer_options"].get("eval_batch_size", 1)))
    for name, split, counts in paths:
        hold_path_shapes(checks, name, mcfg, params, data[split], counts, most)
    return data


def phase_cli(smi, checks) -> dict:
    """The experiment CLI at full width on a cut accuracy_tri corpus: train,
    eval of the new checkpoint, eval of the trained weights, each on the
    GPU; then the kernels at every shape these runs launched (into
    ``checks``), a rollout of an eval union and a train step's gradients on
    a training union, each against the plain hops."""
    import importlib.util
    import shutil

    from mswe_gnn_tpu_torch import config as config_lib
    from mswe_gnn_tpu_torch import main as cli
    from mswe_gnn_tpu_torch import native
    from mswe_gnn_tpu_torch.training.rollout import rollout

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = cut_config("cli", CLI_CONFIG, CLI_CUTS)
    log(f"[cli] host tools: g++ {shutil.which('g++')}, scipy "
        f"{'present' if importlib.util.find_spec('scipy') else 'absent'}")
    t0 = time.perf_counter()
    native.load()
    log(f"[cli] mesh core built with g++ {' '.join(native.CXX_FLAGS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    with cli_workdir("smoke_cli_") as tmp:
        # (a) train, (b) eval of the new checkpoint
        run = cli_train_and_eval("cli", cfg, tmp, "accuracy_tri_cut")
        history = run["history"]

        # (c) eval of the committed trained weights
        trained_counts = cli_run(["eval", "--config", run["cfg_path"], "--ckpt",
                                  os.path.join(root, TRAINED_WEIGHTS), "--out",
                                  os.path.join(tmp, "trained")])
        trained = read_json(os.path.join(tmp, "trained", "summary.json"))
        if not all(math.isfinite(v) for v in trained.values()):
            raise AssertionError(f"[cli] trained-weights summary {trained}")

        # the kernels at the shapes of the three runs, on their own unions
        full = config_lib.with_defaults(cfg)
        train, _, test, _, _ = cli.prepare_data(full)
        mcfg, params, apply_fn = cli.build_experiment_model(full, test[0], device=device)
        params = cli.restore_weights(os.path.join(root, TRAINED_WEIGHTS), params)
        opts = cli.trainer_options(full)
        most = max(opts.batch_size, full["trainer_options"]["eval_batch_size"])
        for path, samples, counts in (("cli_train", train, run["train_counts"]),
                                      ("cli_eval", test, run["eval_counts"]),
                                      ("cli_eval_trained", test, trained_counts)):
            hold_path_shapes(checks, path, mcfg, params, samples, counts, most)
        eval_b = full["trainer_options"]["eval_batch_size"]
        union_err = hold_union_rollout(mcfg, params, apply_fn, test[:eval_b])
        grads = hold_train_union_grads(mcfg, params, apply_fn, train, opts,
                                       history[-1]["rollout_steps"])

        # one test graph's full rollout: kernels against the plain hops
        steps = int(test[0].y.shape[-1])
        got = rollout(apply_fn, params, mcfg, test[0], steps, device=device)
        with plain_hops():
            want = rollout(apply_fn, params, mcfg, test[0], steps, device=device)
        torch.cuda.synchronize()
        check_rollout("[cli] trained-weights rollout", got, test[0].to(device), steps)
        ok, err = within_limit(got, want, torch.float32)
        if not ok:
            raise AssertionError(f"[cli] trained-weights rollout through the kernels "
                                 f"differs from the plain hops: max|err| {err:.3e}")
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("[cli] TF32 was turned on on the float32 CLI path")
    log(f"[cli] trained weights ({TRAINED_WEIGHTS}) on the cut corpus: test_CSI_005 "
        f"{trained['test_CSI_005']:.4f}, test_MAE_WD {trained['test_MAE_WD']:.4f}, "
        f"mean_prediction_time_s {trained['mean_prediction_time_s']:.4f} "
        f"(eval_batch_size {full['trainer_options']['eval_batch_size']}); "
        f"launched {by_kernel(trained_counts)}")
    log(f"[cli] one test graph's {steps}-step rollout through the kernels vs the plain "
        f"hops: max|err| {err:.3e}; the same for the union of test[:{eval_b}]: "
        f"{union_err:.3e} (limit 1e-6 (1 + |ref|)); wet share "
        f"{float((got[:, 0] > 0.05).float().mean()):.3f}")
    log(f"[cli] summary: train epoch times "
        + ", ".join(f"{r['epoch_time']:.2f}" for r in history)
        + f" s; eval mean_prediction_time_s {trained['mean_prediction_time_s']:.4f}; "
        f"{smi}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"cli_train": run["train_counts"], "cli_eval": run["eval_counts"],
                         "cli_eval_trained": trained_counts},
            "epoch_s": [r["epoch_time"] for r in history], "trained": trained,
            "union_rollout_err": union_err, "train_union_grads": grads}


# ---------------------------------------------------------------- phase 11
GNN_CLI_CONFIG = "configs/pareto_gnn.yaml"
GNN_CLI_CUTS = {("synthetic_data", "n_sims"): 12, ("trainer_options", "max_epochs"): 2,
                ("trainer_options", "curriculum_epoch"): 1}
BASELINES = ("GNN_L", "GNN_A", "GAT")


def hold_baselines(sample) -> dict:
    """(c) the Cheb / TAG / GAT baselines at pareto_gnn's width on the
    single-scale graph: step 0 on the card against the same forward on the
    CPU (float32, atol 1e-4: ``index_add`` on CUDA adds with atomics, so the
    sums differ in their last bits), then a 47-step rollout, checked and
    timed as in phase 4. They launch no hop kernel: their gathers and
    segment sums are library calls (ops/segment.py)."""
    from mswe_gnn_tpu_torch import tree_to
    from mswe_gnn_tpu_torch.bench_problem import build_pareto_gnn_model
    from mswe_gnn_tpu_torch.models import count_params
    from mswe_gnn_tpu_torch.training.rollout import rollout

    device = torch.device("cuda")
    steps = sample.y.shape[-1]
    graph, gt = sample.to(device), first_step(sample)
    out, counts = {}, collections.Counter()
    for kind in BASELINES:
        cfg, params, apply_fn = build_pareto_gnn_model(sample, device=device, type_GNN=kind)
        reset_all_launches()
        with torch.inference_mode():
            got = apply_fn(params, cfg, gt.to(device)).cpu()
            want = apply_fn(tree_to(params, "cpu"), cfg, gt)
        err = float((got - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"[gnn] {kind} step 0 on the card differs from the CPU: "
                                 f"max|err| {err:.3e}")
        preds = rollout(apply_fn, params, cfg, graph, steps, device=device)
        torch.cuda.synchronize()
        check_rollout(f"[gnn] the {kind} rollout", preds, graph, steps)
        counts += read_launches()
        rollout_ms, event_ms, _ = timed_rollouts(apply_fn, params, cfg, graph, steps, device)
        log(f"[gnn] (c) {kind} ({count_params(params)} parameters): step 0 card vs CPU "
            f"max|err| {err:.3e} (limit 1e-4); {steps}-step rollout {rollout_ms:.1f} ms "
            f"median of 3 (CUDA events {', '.join(f'{t:.1f}' for t in event_ms)} ms); "
            f"max prediction {float(preds.max()):.4f}")
        out[kind] = {"rollout_ms": rollout_ms, "step0_err": err,
                     "parameters": count_params(params)}
    if sum(counts.values()):
        raise AssertionError(f"[gnn] the baselines launched hop kernels: {dict(counts)}")
    return out


def hold_learned_pooling(sample) -> dict:
    """(e) the bench MSGNN with learned pooling on the 3-scale bench graph:
    one step through the kernels, its launches held against the config's,
    against the same step through the plain hops within phase 4's limit."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model
    from mswe_gnn_tpu_torch.models import count_params, prepare_graph

    device = torch.device("cuda")
    cfg, params, apply_fn = build_bench_model(sample, device=device, learned_pooling=True)
    with torch.inference_mode():
        gt = first_step(prepare_graph(params, cfg, sample.to(device)))
        reset_all_launches()
        p_kernel = apply_fn(params, cfg, gt)
        torch.cuda.synchronize()
        counts = read_launches()
        with plain_hops():
            p_plain = apply_fn(params, cfg, gt)
    torch.cuda.synchronize()
    hold_launches("gnn", "(e) one learned-pooling MSGNN step", counts,
                  hops_per_step(cfg, sample.spec))
    limit = 2 * 2.0 ** -8 * float(p_plain.abs().max())
    err = float((p_kernel - p_plain).abs().max())
    log(f"[gnn] (e) MSGNN with learned pooling ({count_params(params)} parameters, "
        f"{cfg.compute_dtype}): step 0 kernel vs plain hop max|err| {err:.3e} "
        f"(limit {limit:.3e}); wet share {float((p_kernel[:, 0] > 0).float().mean()):.3f}")
    if not (err <= limit and bool(torch.isfinite(p_kernel).all())):
        raise AssertionError("[gnn] the learned-pooling step through the kernels "
                             "disagrees with the plain hops")
    return {"launches": counts, "err": err}


def phase_gnn(smi, checks, bench_sample) -> dict:
    """The single-scale SWE-GNN of ``configs/pareto_gnn.yaml`` at its full
    width (F=64, K=10, 2 layers, float32) on the 152x152 grid's single-scale
    graph: (a) the 47-step rollout, all ELL; (b) the train step with the
    band plan; (c) the baselines; (d) the CLI on a cut pareto_gnn corpus,
    every launched shape held (into ``checks``); (e) MSGNN's learned pooling
    on ``bench_sample``."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_sample, build_pareto_gnn_model
    from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    sample, mesh = build_bench_sample(num_scales=1)
    banded = attach_band_plan(sample)
    log(f"[gnn] single-scale bench graph and its band plan built on the host in "
        f"{time.perf_counter() - t0:.1f} s; band_meta {banded.band_meta}")
    cfg, params, apply_fn = build_pareto_gnn_model(sample, device=device)

    # (a) serving, (b) the train step with the band plan
    serving = phase_serving(sample, mesh, cfg, params, apply_fn, phase="gnn")
    train = phase_train(banded, cfg, params, apply_fn, phase="gnn")
    t_c = time.perf_counter()
    baselines = hold_baselines(sample)
    log(f"[gnn] (c) took {time.perf_counter() - t_c:.1f} s")

    # (d) the CLI: train and eval on a cut pareto_gnn corpus
    t_d = time.perf_counter()
    cut = cut_config("gnn", GNN_CLI_CONFIG, GNN_CLI_CUTS)
    with cli_workdir("smoke_gnn_cli_") as tmp:
        run = cli_train_and_eval("gnn", cut, tmp, "pareto_gnn_cut")
        hold_cli_shapes(checks, cut, run, (("gnn_cli_train", 0, run["train_counts"]),
                                           ("gnn_cli_eval", 2, run["eval_counts"])))
    log(f"[gnn] (d) took {time.perf_counter() - t_d:.1f} s")

    pooling = hold_learned_pooling(bench_sample)
    log(f"[gnn] summary: (a) {serving['launches'][('hop', sample.num_nodes, sample.num_nodes)]} "
        f"ELL launches, rollout {serving['rollout_ms']:.1f} ms; (b) train step "
        f"{train['step_ms']:.1f} ms, launched {by_kernel(train['launches'])}; (c) "
        + ", ".join(f"{k} {v['rollout_ms']:.1f} ms" for k, v in baselines.items())
        + f"; (d) epochs " + ", ".join(f"{r['epoch_time']:.2f}" for r in run["history"])
        + f" s, eval mean_prediction_time_s "
        f"{run['eval_summary']['mean_prediction_time_s']:.4f}; (e) max|err| "
        f"{pooling['err']:.3e}; {smi}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"gnn_serving": serving["launches"],
                         "gnn_train_step": train["launches"],
                         "gnn_cli_train": run["train_counts"],
                         "gnn_cli_eval": run["eval_counts"],
                         "msgnn_learned_pooling": pooling["launches"]},
            "rollout_ms": serving["rollout_ms"], "train_step_ms": train["step_ms"],
            "cache": serving["cache"], "spec": sample.spec, "banded": banded,
            "baselines": baselines, "epoch_s": [r["epoch_time"] for r in run["history"]],
            "sample": sample,
            "eval_s_per_sim": run["eval_summary"]["mean_prediction_time_s"]}


# ---------------------------------------------------------------- phase 12
DATA_CLI_CONFIG = "configs/accuracy.yaml"
DATA_CLI_CUTS = {("synthetic_data", "n_sims"): 6, ("trainer_options", "max_epochs"): 2,
                 ("trainer_options", "curriculum_epoch"): 1}
DEMO_CONFIG = "configs/demo_small.yaml"
DEMO_CUTS = {("trainer_options", "max_epochs"): 2, ("trainer_options", "curriculum_epoch"): 1}
MAP_FILES, MAP_GRID, MAP_HOURS = 5, 24, 24        # map files of a 24x24 grid, 24 hourly frames
PICKLE_SPLIT = (6, 2)                              # records in the train and test pickles


def load_pyg_fixture():
    """``tests/pyg_fixture.py`` of this checkout (numpy and torch only),
    loaded from its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "pyg_fixture.py")
    spec = importlib.util.spec_from_file_location("smoke_pyg_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_map_folder(folder) -> None:
    """``MAP_FILES`` D-HYDRO-style map files of simulations on a
    ``MAP_GRID`` x ``MAP_GRID`` grid (the port's solver), written as classic
    NetCDF-3 with ``scipy.io.netcdf_file`` (the card has no h5py), with the
    variables of ``write_grid_map_netcdf`` and an ``overview.csv`` of solver
    seconds."""
    import numpy as np

    from mswe_gnn_tpu_torch.data.meshing import grid_mesh
    from mswe_gnn_tpu_torch.data.netcdf import write_grid_map_netcdf
    from mswe_gnn_tpu_torch.data.simulate import (random_dem_fn, random_hydrograph,
                                                  run_diffusive_wave)

    os.makedirs(folder, exist_ok=True)
    n, dx = MAP_GRID, 100.0
    rows = []
    for i in range(MAP_FILES):
        rng = np.random.default_rng(100 + i)
        mesh = grid_mesh(n, n, dx, random_dem_fn(rng, extent=n * dx, relief=3.0))
        hydro = random_hydrograph(rng, total_hours=MAP_HOURS, dt_minutes=60.0,
                                  peak_discharge=150.0)
        bc_faces = np.asarray([n // 2 - 1, n // 2], np.int64)
        sim = run_diffusive_wave(mesh, bc_faces, hydro, dt_minutes=60.0, substeps=10)
        write_grid_map_netcdf(os.path.join(folder, f"output_{i}_map.nc"), n, n, dx, sim.wd,
                              sim.vx, sim.vy, bc_faces, dem=mesh.dem, classic=True)
        rows.append(f"{i},{n * n},{MAP_HOURS:.1f},{300.0 + 25.0 * i}\n")
    with open(os.path.join(folder, "overview.csv"), "w") as f:
        f.write("seed,mesh_num_faces,simulation_time[h],computation_time[s]\n" + "".join(rows))


def phase_data(smi, checks) -> dict:
    """The data layer on the card: (a) the bench MSGNN's 47-step rollout on
    the storm-forced bench graph; (b) its train step with the band plan;
    (c) the CLI's train and eval of accuracy.yaml's model at full width on a
    cut storm-forced corpus; (d) the CLI's train and eval on a folder of
    NetCDF-3 map files at demo width, lstsq slopes as node features; (e) the
    CLI's train on a folder of reference pickles. Every launched shape of
    the CLI runs held (into ``checks``)."""
    import yaml

    from mswe_gnn_tpu_torch import main as cli
    from mswe_gnn_tpu_torch.bench_problem import (build_bench_model, build_bench_sample,
                                                  build_bench_train_step)
    from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
    from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    sample, mesh = build_bench_sample(storm=True)
    banded = attach_band_plan(sample)
    log(f"[data] storm-forced bench graph and its band plan built on the host in "
        f"{time.perf_counter() - t0:.1f} s: forcing {list(sample.forcing.shape)} "
        f"(WX, WY, P), static features {sample.x_static.shape[1]} + 3 a step")
    cfg, params, apply_fn = build_bench_model(sample, device=device)

    # (a) the forced rollout, (b) the forced train step
    serving = phase_serving(sample, mesh, cfg, params, apply_fn, phase="data")
    train = phase_train(banded, cfg, params, apply_fn, phase="data")
    # control for (b)'s gradient check: the same weights on the graph with
    # its forcing zeroed (the three extra encoder rows shift build_model's
    # draws, so these weights are not phase 5's)
    zeroed = build_bench_train_step(banded.replace(forcing=torch.zeros_like(banded.forcing)),
                                    cfg, params, apply_fn, device=device)
    args = (apply_fn, zeroed.params, cfg, zeroed.graph, zeroed.rollout_steps, zeroed.opts, True)
    hold_grads("data, forcing zeroed", args)
    del sample, banded, zeroed

    # (c) the CLI on a storm-forced corpus at accuracy.yaml's full width
    t_c = time.perf_counter()
    cut = cut_config("data", DATA_CLI_CONFIG, DATA_CLI_CUTS)
    log("[data] setting: synthetic_data.storm_forcing False -> True")
    cut["synthetic_data"]["storm_forcing"] = True
    with cli_workdir("smoke_data_cli_") as tmp:
        storm = cli_train_and_eval("data", cut, tmp, "accuracy_storm_cut")
        data = hold_cli_shapes(checks, cut, storm, (
            ("data_cli_train", 0, storm["train_counts"]),
            ("data_cli_eval", 2, storm["eval_counts"])))
        if data[0][0].forcing is None or data[0][0].forcing.shape[1] != 3:
            raise AssertionError("[data] the storm corpus's samples carry no forcing")
    log(f"[data] (c) took {time.perf_counter() - t_c:.1f} s")

    # (d) the CLI on a folder of NetCDF-3 map files, lstsq slopes
    t_d = time.perf_counter()
    demo = cut_config("data", DEMO_CONFIG, DEMO_CUTS)
    with cli_workdir("smoke_data_map_") as tmp:
        folder = os.path.join(tmp, "maps")
        write_map_folder(folder)
        demo_map = dict(demo, dataset_parameters={
            "map_folder": folder, "temporal_res": 60, "val_prcnt": 0.25, "seed": 0,
            "slope_method": "lstsq"},
            selected_node_features={"slopes": True, "area": True, "DEM": True})
        log(f"[data] (d) {MAP_FILES} NetCDF-3 map files of a {MAP_GRID}x{MAP_GRID} grid, "
            f"{MAP_HOURS + 1} frames; dataset_parameters {demo_map['dataset_parameters']}; "
            f"selected_node_features {demo_map['selected_node_features']}")
        maps = cli_train_and_eval("data", demo_map, tmp, "demo_map")
        hold_cli_shapes(checks, demo_map, maps, (
            ("data_map_train", 0, maps["train_counts"]),
            ("data_map_eval", 2, maps["eval_counts"])))
    summary = maps["eval_summary"]
    speed_up = summary.get("speed_up_vs_dhydro_mean")
    if cli._solver_label(demo_map) != "dhydro" or speed_up is None \
            or not math.isfinite(speed_up) or "speed_up_mean" not in summary:
        raise AssertionError(f"[data] the map-folder summary has no finite speed-up against "
                             f"dhydro: {summary}")
    log(f"[data] (d) solver label dhydro; speed-up against dhydro {speed_up:.1f} "
        f"(std {summary['speed_up_vs_dhydro_std']:.1f}); test_CSI_005 "
        f"{summary['test_CSI_005']:.4f}; took {time.perf_counter() - t_d:.1f} s")

    # (e) the CLI on a tree of reference pickles
    t_e = time.perf_counter()
    fixture = load_pyg_fixture()
    n_train, n_test = PICKLE_SPLIT
    with cli_workdir("smoke_data_pickle_") as tmp:
        folder = os.path.join(tmp, "datasets")
        records = generate_dataset(n_train + n_test, seed=50, nx=24, ny=24, num_scales=3,
                                   total_hours=24, temporal_res=60, substeps=10)
        for sub, part in (("train", records[:n_train]), ("test", records[n_train:])):
            os.makedirs(os.path.join(folder, sub))
            fixture.write_reference_dataset(
                os.path.join(folder, sub, "multiscale_mesh_dataset.pkl"), part)
        dp = {"dataset_folder": folder, "train_dataset_name": "multiscale_mesh_dataset",
              "train_size": n_train, "val_prcnt": 0.25, "seed": 381, "temporal_res": 60}
        split = [len(part) for part in cli._load_reference_split(dp)]
        n_val = math.ceil(0.25 * n_train)
        if split != [n_train - n_val, n_val, n_test]:
            raise AssertionError(f"[data] reference-pickle split {split}")
        pickle_cfg = dict(demo, dataset_parameters=dp)
        cfg_path = os.path.join(tmp, "demo_pickles.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(pickle_cfg, f)
        pickle_counts = cli_run(["train", "--config", cfg_path, "--out",
                                 os.path.join(tmp, "train")])
        history = read_json(os.path.join(tmp, "train", "best", "meta.json"))["history"]
        pickle_summary = read_json(os.path.join(tmp, "train", "summary.json"))
        hold_cli_shapes(checks, pickle_cfg, {"train_dir": os.path.join(tmp, "train")},
                        (("data_pickle_train", 0, pickle_counts),))
    if not (all(math.isfinite(r["train_loss"]) for r in history)
            and all(math.isfinite(v) for v in pickle_summary.values())):
        raise AssertionError(f"[data] reference-pickle run: history {history}, summary "
                             f"{pickle_summary}")
    if not by_kernel(pickle_counts)["hop"] or not by_kernel(pickle_counts)["hop_bwd"]:
        raise AssertionError(f"[data] reference-pickle train launched {dict(pickle_counts)}")
    log(f"[data] (e) reference pickles ({n_train} train, {n_test} test records, written by "
        f"tests/pyg_fixture.py): split {split[0]} train / {split[1]} val / {split[2]} test "
        f"records; epochs " + ", ".join(f"{r['epoch_time']:.2f}" for r in history)
        + f" s; test_CSI_005 {pickle_summary['test_CSI_005']:.4f}; launched "
        f"{by_kernel(pickle_counts)}; took {time.perf_counter() - t_e:.1f} s")

    log(f"[data] summary: (a) {sum(serving['launches'].values())} ELL launches, rollout "
        f"{serving['rollout_ms']:.1f} ms; (b) train step {train['step_ms']:.1f} ms, launched "
        f"{by_kernel(train['launches'])}; (c) epochs "
        + ", ".join(f"{r['epoch_time']:.2f}" for r in storm["history"])
        + f" s, eval {storm['eval_summary']['mean_prediction_time_s']:.4f} s a simulation; "
        f"(d) epochs " + ", ".join(f"{r['epoch_time']:.2f}" for r in maps["history"])
        + f" s, eval {summary['mean_prediction_time_s']:.4f} s a simulation; {smi}; "
        f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"data_serving": serving["launches"],
                         "data_train_step": train["launches"],
                         "data_cli_train": storm["train_counts"],
                         "data_cli_eval": storm["eval_counts"],
                         "data_map_train": maps["train_counts"],
                         "data_map_eval": maps["eval_counts"],
                         "data_pickle_train": pickle_counts},
            "rollout_ms": serving["rollout_ms"], "train_step_ms": train["step_ms"],
            "cli_epoch_s": [r["epoch_time"] for r in storm["history"]],
            "map_epoch_s": [r["epoch_time"] for r in maps["history"]],
            "pickle_epoch_s": [r["epoch_time"] for r in history],
            "map_speed_up": speed_up}


# ---------------------------------------------------------------- phase 13
RING_PARTS = 8
RING_F32_STEPS = 12     # (a)'s float32 rollout, cut from 47 to keep phase 13 short
RING_CONFIG = "configs/ring_halo.yaml"


def ring_tables(plans) -> dict:
    """Every hop table of placed ring plans (``place_dist_inputs``), each
    part's, by ``(Nd, Ns)``: ``[(slot table, slot mask, same_block)]``. A
    group's source rows are its out-slot table's (``out_ptr`` has Ns + 1
    entries); a processor's interior group hops against its own block."""
    tables = collections.defaultdict(list)

    def add(tab, mask, out_table, same_block=False):
        tables[tab.shape[0], out_table[0].numel() - 1].append((tab, mask, same_block))

    for kind, plan_list in (("proc", plans["proc"]), ("unpool", plans["unpool"])):
        for pl in plan_list:
            if "groups" in pl:
                for g in pl["groups"]:
                    for tab, mask, out_table in zip(g["tab"], g["mask"], g["out_table"]):
                        add(tab, mask, out_table, kind == "proc" and not g["buffered"])
                continue
            for p, (tab, mask) in enumerate(zip(pl["src_tab"], pl["smask"])):
                add(tab, mask, pl["out_table"][p])
                for (base, pfx), out_table in pl["ext_out_table"][p].items():
                    add(pl["ext_tab"][p][base:base + pfx], pl["ext_mask"][p][base:base + pfx],
                        out_table)
    return tables


def ring_hops_per_step(cfg, plans) -> collections.Counter:
    """Hop launches of one ring MSGNN step by ``(kernel, Nd, Ns)``, from the
    config and the plans: a processor layer of K hops launches each slot
    group's hop on every part K times (a width-W plan: the block's hop every
    hop, and both sides' halo rows between a window's exchanges), every
    un-pool layer its groups once a part."""
    parts = len(plans["devices"])
    counts = collections.Counter()

    def group_keys(pl):
        return [("hop", g["tab"][0].shape[0], g["out_table"][0][0].numel() - 1)
                for g in pl["groups"]]

    for k, scale in processor_layers(cfg):
        pl = plans["proc"][scale]
        if "groups" in pl:
            for key in group_keys(pl):
                counts[key] += k * parts
            continue
        width, ring_ptr, halo = pl["width"], pl["ring_ptr"], pl["halo"]
        block = pl["src_tab"][0].shape[0]
        n_buf = block + 2 * halo
        done = 0
        while done < k:
            w = min(width, k - done)
            for j in range(w):
                counts["hop", block, n_buf] += parts
                if j < w - 1 and ring_ptr[width - 1] > 0 and ring_ptr[w - 1 - j] > 0:
                    counts["hop", ring_ptr[w - 1 - j], n_buf] += 2 * parts
            done += w
    for pl in plans["unpool"]:
        for key in group_keys(pl):
            counts[key] += cfg.intra_cfg().K * parts
    return counts


def hold_ring_shapes(checks, path, plans, counts) -> dict:
    """``hold_tables`` on the tables of placed ring plans (``ring_tables``)."""
    return hold_tables(checks, "ring", path, ring_tables(plans), counts)


def hold_tables(checks, phase, path, tables, counts) -> dict:
    """Each ``(kernel, Nd, Ns)`` that ``path`` launched (``counts``) held bit
    for bit against the plain versions, as phase 6 holds its cases: the ELL
    forward, and where the path ran it the backward, in float32 and bf16 and
    every mode, on every table of that shape in ``tables`` (``(Nd, Ns) ->
    [(slot table, slot mask, same_block)]``; random states with dry rows,
    random flux zero on masked slots). Raises if a launched shape has no
    table. -> the worst error by kernel."""
    launched = {key for key, n in counts.items() if n}
    worst = {"hop": 0.0, "hop_bwd": 0.0}
    held = set()
    for nd, ns in sorted({(nd, ns) for _, nd, ns in launched}):
        if (nd, ns) not in tables:
            raise AssertionError(f"[{phase}] {path}: launched ({nd}, {ns}) has no plan table")
        backward = ("hop_bwd", nd, ns) in launched
        for i, (tab, mask, same) in enumerate(tables[nd, ns]):
            for dtype in DTYPES:
                g = torch.Generator().manual_seed(5000 + 7 * i + nd)
                dst = torch.randn(nd, FEAT, generator=g)
                dst[torch.rand(nd, generator=g) < 0.3] = 0.0
                src = torch.randn(ns, FEAT, generator=g)
                src[torch.rand(ns, generator=g) < 0.3] = 0.0
                s = torch.randn(nd, tab.shape[1], FEAT, generator=g) * (mask.cpu() > 0)[..., None]
                dst, src, s = (x.to("cuda", dtype) for x in (dst, src, s))
                src = dst if same else src
                args = (dst, src, tab.contiguous(), s.contiguous())
                case = f"{path} ({nd}, {ns}) table {i}"
                out_table = hop_ops.out_slot_table(args[2], ns, mask)
                up = upstream(5100 + nd, dst)
                for mode, (grad, upw) in MODES.items():
                    worst["hop"] = max(worst["hop"], checks.hold(
                        "hop", case, dtype, mode,
                        (hop_ops.hop(*args, with_gradient=grad, upwind=upw),),
                        (hop_ops.hop_reference(*args, with_gradient=grad, upwind=upw),),
                        exact=True))
                    if backward:
                        worst["hop_bwd"] = max(worst["hop_bwd"], checks.hold(
                            "hop_bwd", case, dtype, mode,
                            hop_ops.hop_backward(*args, up, *out_table, grad, upw),
                            hop_ops.hop_backward_reference(*args, up, *out_table, grad, upw),
                            exact=True))
        held |= {("hop", nd, ns)} | ({("hop_bwd", nd, ns)} if backward else set())
    missing = launched - held
    if missing:
        raise AssertionError(f"[{phase}] {path}: launched shapes held nowhere: {sorted(missing)}")
    log(f"[{phase}] {path}: every launched shape held bit-equal to the plain versions (float32 "
        f"and bf16, 3 modes, every table of the shape): "
        + ", ".join(f"({nd}, {ns}) x{len(tables[nd, ns])}"
                    + (" +bwd" if ("hop_bwd", nd, ns) in launched else "")
                    for nd, ns in sorted({(nd, ns) for _, nd, ns in launched})))
    return worst


def ring_timing_cases(plans, cfg) -> list:
    """The ring path's ELL shapes for phase 6, bf16, on part 0's tables: each
    processor scale's hop and each level's un-pool hop, the backward at each
    (the ring train step runs both)."""
    return partition_timing_cases(ring_hops_per_step(cfg, plans), ring_tables(plans),
                                  ring_processor_keys(plans), "ring part", "ring table", 6000)


def partition_timing_cases(per_step, tables, processor_keys, name, label, seed) -> list:
    """Phase 6's cases at each ``(Nd, Ns)`` of ``per_step``, bf16, on the
    first table of the shape: the forward (gradient mode for
    ``processor_keys``, else the un-pool's no-gradient mode) and the
    backward."""
    cases, nbytes = [], torch.tensor([], dtype=torch.bfloat16).element_size()
    g = torch.Generator().manual_seed(seed)
    for key in sorted(per_step):
        _, nd, ns = key
        tab, mask, same = tables[nd, ns][0]
        dst = torch.randn(nd, FEAT, generator=g)
        dst[torch.rand(nd, generator=g) < 0.3] = 0.0
        src = torch.randn(ns, FEAT, generator=g)
        src[torch.rand(ns, generator=g) < 0.3] = 0.0
        s = torch.randn(nd, tab.shape[1], FEAT, generator=g) * (mask.cpu() > 0)[..., None]
        dst, src, s = (x.to("cuda", torch.bfloat16) for x in (dst, src, s))
        args = (dst, dst if same else src, tab.contiguous(), s.contiguous())
        grad = key in processor_keys
        shape = f"{name} Nd={nd} Ns={ns} D={tab.shape[1]} F={FEAT} bf16 {label}"
        cases.append(timing_case(
            "hop", shape, nd, ns, partial(hop_ops.hop, *args, with_gradient=grad),
            partial(hop_ops.hop_reference, *args, with_gradient=grad),
            hop_work(nd, ns, tab.shape[1], FEAT, nbytes, same, 4 if grad else 3),
            launch=launch_info(hop_ops._kernels(), torch.bfloat16, FEAT, nd)))
        table = hop_ops.out_slot_table(args[2], ns, mask)
        up = upstream(seed + 100 + nd, dst)
        cases.append(timing_case(
            "hop_bwd", shape, nd, ns, partial(hop_ops.hop_backward, *args, up, *table, grad),
            partial(hop_ops.hop_backward_reference, *args, up, *table, grad),
            hop_bwd_work(nd, ns, tab.shape[1], FEAT, nbytes, same, grad),
            table_bytes=table_bytes(table),
            launch=launch_info(hop_ops._kernels(), torch.bfloat16, FEAT, nd, "bwd",
                               (ns, int(same)))))
    return cases


def ring_processor_keys(plans) -> set:
    """The launch keys of the processor hops (gradient mode); the others are
    the un-pool hops (no-gradient mode)."""
    keys = set()
    for pl in plans["proc"]:
        for g in pl.get("groups", ()):
            keys.add(("hop", g["tab"][0].shape[0], g["out_table"][0][0].numel() - 1))
        if "groups" not in pl:
            keys.add(("hop", pl["src_tab"][0].shape[0], pl["out_table"][0][0].numel() - 1))
    return keys


def ring_layout(plans) -> str:
    def desc(pl):
        if "groups" not in pl:
            return (f"B={pl['src_tab'][0].shape[0]} H={pl['halo']} W={pl['width']} "
                    f"rings {pl['ring_ptr']}")
        return (f"B={pl['groups'][0]['tab'][0].shape[0]} H={pl['halo']} slots "
                + "+".join(f"{g['hi'] - g['lo']}{'b' if g['buffered'] else 'l'}"
                           for g in pl["groups"]))
    return ("processors " + "; ".join(desc(pl) for pl in plans["proc"])
            + " | pools " + "; ".join(desc(pl) for pl in plans["pool"])
            + " | un-pools " + "; ".join(desc(pl) for pl in plans["unpool"]))


def ring_parts(graph, most, **kw) -> int:
    """The largest part count <= ``most`` whose ring plans exist for
    ``graph``; each count that fails is printed with its reason."""
    from mswe_gnn_tpu_torch.parallel.dist_swegnn import ring_plan_failure

    for parts in range(most, 1, -1):
        why = ring_plan_failure(graph, parts, **kw)
        if why is None:
            return parts
        log(f"[ring] no ring plan at {parts} parts: {why}")
    raise AssertionError(f"[ring] no ring plan at any part count from {most} down to 2")


def hold_ring_grads(ring, single, nudged, parts, rollout_steps, phase="ring",
                    through=None) -> dict:
    """The ring's float32 loss and gradients against the single-device
    port's. Limits: the loss within 1e-6 relative, cosine >= 0.9999999 and
    relative L2 <= 1e-6 over the whole tree, and every leaf within phase
    5's 1e-4 max|leaf| + 1e-12 or, for a leaf that rounding alone moves
    further, within its own movement under a one-ulp change of the inputs
    (``nudged``: the single-device gradient with ``x_dynamic`` one float32
    ulp up). Phase 5 compares two computations that round at the same
    points; the ring's backward adds a state's gradient in other partial
    sums (its block's and its neighbours' halo terms), and a PReLU slope
    whose gradient cancels to ~1e-9 moves by 1e-3 of itself under a
    one-ulp input change on an H100 (``tests/torch_port_ring_grads.py``). (``x_dynamic * (1 + 2**-23)`` moves each entry by
    one or two float32 ulps.)"""
    from mswe_gnn_tpu_torch import tree_leaves

    r = compare_grads(*ring, *single)
    names = leaf_names(single[1])
    loose = []
    for n, a, b, c in zip(names, tree_leaves(ring[1]), tree_leaves(single[1]),
                          tree_leaves(nudged[1])):
        d, m, dn = (float((a - b).abs().max()), float(b.abs().max()),
                    float((c - b).abs().max()))
        if d > 1e-4 * m + 1e-12:
            loose.append((n, d, m, dn))
    log(f"[{phase}] float32 train step ({rollout_steps}-step pushforward, remat) through "
        f"{through or f'{parts} parts'} vs one device: loss rel diff {r['loss_rel']:.3e}, "
        f"gradient cosine "
        f"{r['cos']:.9f}, relative L2 {r['rel']:.3e}, worst leaf max|diff|/max|leaf| "
        f"{r['worst_leaf']:.3e}; worst leaves "
        + "; ".join(f"{n} {q:.3e} (max|diff| {d:.3e}, max|leaf| {m:.3e})"
                    for n, q, d, m in r["worst"])
        + "; leaves past 1e-4 max|leaf| + 1e-12, with their one-ulp movement: "
        + ("; ".join(f"{n} {d:.3e} (one ulp {dn:.3e}, max|leaf| {m:.3e})"
                     for n, d, m, dn in loose) or "none")
        + " (limits: loss 1e-6, cosine 0.9999999, L2 1e-6, each leaf as the docstring)")
    if not (r["loss_rel"] <= 1e-6 and r["cos"] >= 0.9999999 and r["rel"] <= 1e-6
            and all(d <= dn for _, d, _, dn in loose)):
        raise AssertionError(f"[{phase}] float32 train-step gradients through "
                             f"{through or f'{parts} parts'} disagree with the single-device "
                             "port")
    r["past_phase5_limit"] = loose
    return r


def ring_step0(apply_fn, params, cfg, graph):
    with torch.inference_mode():
        return apply_fn(params, cfg, first_step(graph))


def phase_ring(smi, checks, sample, cfg, params) -> dict:
    """Ring-halo graph parallelism on the card: the bench MSGNN split into
    ``RING_PARTS`` ring partitions, all on ``cuda:0``. (a) its 47-step
    rollout through the ring ``apply_fn`` in bf16 and float32 against the
    single-device port on the same reordered graph and weights; (b) phase
    5's train step through the ring, its float32 gradients against the
    single-device port's; (c) the overlap and width-2 plans, step 0 against
    (a); (d) ``configs/ring_halo.yaml`` through ``run_training``. Every
    launched partition shape held against the plain hop (into ``checks``)."""
    from mswe_gnn_tpu_torch import config as config_lib
    from mswe_gnn_tpu_torch import main as cli
    from mswe_gnn_tpu_torch.bench_problem import build_bench_train_step
    from mswe_gnn_tpu_torch.models.msgnn import apply_msgnn
    from mswe_gnn_tpu_torch.parallel.dist_swegnn import (build_dist_msgnn_inputs,
                                                         place_dist_inputs,
                                                         reorder_graph_for_ring)
    from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn, prepare_ring_graphs
    from mswe_gnn_tpu_torch.training.rollout import rollout
    from mswe_gnn_tpu_torch.training.train import loss_and_grads

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    ring_graph, _ = reorder_graph_for_ring(sample, RING_PARTS)
    parts = ring_parts(ring_graph, RING_PARTS)
    devices = [torch.device("cuda", 0)] * parts
    plans = place_dist_inputs(build_dist_msgnn_inputs(ring_graph, parts), devices)
    graph = ring_graph.to(device)
    log(f"[ring] bench graph ring-reordered and planned on the host in "
        f"{time.perf_counter() - t0:.1f} s: {parts} parts on {devices[0]}; "
        + ring_layout(plans))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    steps = graph.y.shape[-1]
    paths, out = {}, {"parts": parts}

    # (a) the rollout through the ring, bf16 and float32, against one device
    ring_apply = {c.compute_dtype: make_dist_apply_fn(devices, c, graph) for c in (cfg, cfg32)}
    per_step = ring_hops_per_step(cfg, plans)
    log(f"[ring] cut: the float32 ring rollout {steps} -> {RING_F32_STEPS} steps")
    for c, path in ((cfg, "ring_serving"), (cfg32, "ring_serving_f32")):
        apply_fn = ring_apply[c.compute_dtype]
        n = steps if c is cfg else RING_F32_STEPS
        reset_all_launches()
        preds = rollout(apply_fn, params, c, graph, n, device=device)
        torch.cuda.synchronize()
        paths[path] = read_launches()
        hold_launches("ring", f"the {n}-step {c.compute_dtype} ring rollout", paths[path],
                      collections.Counter({k: v * n for k, v in per_step.items()}))
        check_rollout(f"[ring] {c.compute_dtype} rollout", preds, graph, n)
        single = rollout(apply_msgnn, params, c, graph, n, device=device)
        err0 = float((preds[..., 0] - single[..., 0]).abs().max())
        top = float(single[..., 0].abs().max())
        limit = 1e-5 * top if c is cfg32 else 2 * 2.0 ** -8 * top
        rel_l2 = float((preds - single).norm() / single.norm())
        log(f"[ring] {c.compute_dtype} rollout through {parts} parts vs one device: step 0 "
            f"max|err| {err0:.3e} (limit {limit:.3e}), the {n} steps' relative L2 "
            f"{rel_l2:.3e}" + (" (limit 1e-4)" if c is cfg32 else "")
            + f"; max|pred| {top:.4f}")
        if err0 > limit or (c is cfg32 and not rel_l2 <= 1e-4):
            raise AssertionError(f"[ring] the {c.compute_dtype} ring rollout disagrees with "
                                 "the single-device port")
        out[f"{path}_step0_err"], out[f"{path}_rel_l2"] = err0, rel_l2
        if c is cfg32:
            out["step0_f32"] = preds[..., 0]
    rollout_ms, event_ms, host_ms = timed_rollouts(ring_apply["bfloat16"], params, cfg, graph,
                                                   steps, device)
    out["rollout_ms"] = rollout_ms
    log(f"[ring] {steps}-step bf16 ring rollout ({parts} parts, one card): {rollout_ms:.1f} "
        f"ms median of 3 (CUDA events {', '.join(f'{x:.1f}' for x in event_ms)} ms; host "
        f"clock {', '.join(f'{x:.1f}' for x in host_ms)} ms); "
        f"{sum(per_step.values())} hop launches a step; (a) took "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # (b) the train step through the ring: float32 gradients against one
    # device, then the bf16 step counted and timed as phase 5's
    step = build_bench_train_step(graph, cfg, params, ring_apply["bfloat16"], device=device)
    with deterministic("ring"):
        args = (step.params, cfg32, step.graph, step.rollout_steps, step.opts, True)
        ring_grads = loss_and_grads(ring_apply["float32"], *args)
        single_grads = loss_and_grads(apply_msgnn, *args)
        # each leaf's rounding sensitivity: the single-device gradient with
        # the inputs one float32 ulp up
        nudged = graph.replace(x_dynamic=graph.x_dynamic * (1 + 2.0 ** -23))
        nudged_grads = loss_and_grads(apply_msgnn, step.params, cfg32, nudged,
                                      step.rollout_steps, step.opts, True)
    r = hold_ring_grads(ring_grads, single_grads, nudged_grads, parts, step.rollout_steps)
    check_first_grads("ring", *ring_grads)
    expected = collections.Counter()
    for (kernel, nd, ns), n in per_step.items():
        expected[kernel, nd, ns] += 2 * n * step.rollout_steps
        expected[kernel + "_bwd", nd, ns] += n * step.rollout_steps
    paths["ring_train_step"], out["train_step_ms"], _, out["train_peak_gib"] = \
        timed_train_steps("ring", step, expected)
    out["train_grads_f32"] = r
    log(f"[ring] (b) done {time.perf_counter() - t_phase:.1f} s into the phase")

    # (c) the overlap and width-2 plans: step 0 against (a)'s float32 step 0
    for path, kw in (("ring_overlap_step", {"overlap": True}),
                     ("ring_wide_step", {"halo_width": 2})):
        dist = build_dist_msgnn_inputs(ring_graph, parts, **kw)
        vplans = place_dist_inputs(dist, devices)
        apply_fn = make_dist_apply_fn(devices, cfg32, graph, **kw)
        reset_all_launches()
        got = ring_step0(apply_fn, params, cfg32, graph)
        torch.cuda.synchronize()
        paths[path] = read_launches()
        hold_launches("ring", f"one float32 step with {kw}", paths[path],
                      ring_hops_per_step(cfg, vplans))
        ref = out["step0_f32"]
        err = (got - ref).abs()
        bound_ = 2e-5 * ref.abs() + 1e-6 * float(ref.abs().max())
        meta = {k: dist[k] for k in ("overlap", "overlap_pool", "overlap_unpool", "wide_meta")
                if k in dist}
        log(f"[ring] {kw}: {ring_layout(vplans)}; {meta}; step 0 vs (a): max|err| "
            f"{float(err.max()):.3e} (limit 2e-5 |ref| + 1e-6 max|ref|)")
        if not bool((err <= bound_).all()):
            raise AssertionError(f"[ring] step 0 with {kw} disagrees with the per-hop plan")
        out[f"{path}_err"] = float(err.max())
        hold_ring_shapes(checks, path, vplans, paths[path])
    for path in ("ring_serving", "ring_serving_f32", "ring_train_step"):
        hold_ring_shapes(checks, path, plans, paths[path])
    log(f"[ring] (c) and the holds done {time.perf_counter() - t_phase:.1f} s into the phase")

    # (d) configs/ring_halo.yaml through run_training, at its own width and
    # corpus, at the largest part count with a ring plan (at the config's 8
    # parts its coarse levels have none, and the run falls back to the GSPMD
    # mesh as JAX does: phase 14 (e))
    with cli_workdir("smoke_ring_") as tmp:
        cfg_yaml = cut_config("ring", RING_CONFIG, {("trainer_options", "batch_size"): 4})
        full = config_lib.with_defaults(cfg_yaml)
        n_graph = full["parallel"]["graph"]
        train = cli.prepare_data(full)[0]
        template = prepare_ring_graphs(train[:1], n_graph)[0][0]
        cli_parts = ring_parts(template, n_graph, overlap=bool(full["parallel"]["overlap"]))
        cfg_yaml["parallel"]["graph"] = cli_parts
        log(f"[ring] cut: parallel.graph {n_graph} -> {cli_parts} (the largest count with a "
            "ring plan on the config's own corpus)")
        buf = io.StringIO()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summary = cli.run_training(cfg_yaml, os.path.join(tmp, "train"),
                                       device=[torch.device("cuda", 0)] * cli_parts)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        paths["ring_cli_train"] = read_launches()
        text = buf.getvalue()
        history = read_json(os.path.join(tmp, "train", "best", "meta.json"))["history"]
        launched = by_kernel(paths["ring_cli_train"])
        if ("ring_halo: forcing batch_size=1" not in text
                or f"{cli_parts}-way" not in text
                or [h["epoch"] for h in history] != [0, 1]
                or not all(math.isfinite(h["train_loss"]) for h in history)
                or not all(math.isfinite(v) for v in summary.values())
                or not (launched["hop"] and launched["hop_bwd"])):
            raise AssertionError(f"[ring] run_training of {RING_CONFIG}: {text[-3000:]}")
        cli_plans = place_dist_inputs(build_dist_msgnn_inputs(
            prepare_ring_graphs(train[:1], cli_parts)[0][0].to(device), cli_parts,
            overlap=bool(full["parallel"]["overlap"])), [torch.device("cuda", 0)] * cli_parts)
        hold_ring_shapes(checks, "ring_cli_train", cli_plans, paths["ring_cli_train"])
    log(f"[ring] {RING_CONFIG} (F={full['models']['hid_features']}, K={full['models']['K']}, "
        f"overlap) over {cli_parts} parts: batch_size forced to 1, {cli_s:.1f} s in all; "
        "epochs " + ", ".join(f"{h['epoch']} (train_loss {h['train_loss']:.6f}, "
                              f"{h['epoch_time']:.2f} s)" for h in history)
        + f"; test_CSI_005 {summary['test_CSI_005']:.4f}, test_MAE_WD "
        f"{summary['test_MAE_WD']:.4f}; launched {launched}")
    out.update(launches=paths, cli_parts=cli_parts, cli_epoch_s=[h["epoch_time"]
                                                                   for h in history],
               plans=plans, cfg=cfg, graph=graph)
    log(f"[ring] summary: {parts} parts, bf16 rollout {out['rollout_ms']:.1f} ms, bf16 train "
        f"step {out['train_step_ms']:.1f} ms; {smi}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14
MESH_SHAPE = (4, 2)
MESH_CONFIG = "configs/multichip.yaml"
MESH_CLI_CUTS = {("trainer_options", "max_epochs"): 2}
MESH_BATCH = 4


def distinct_bench_samples(sample, n):
    """``n`` distinct graphs of the bench sample: graph i's dynamic features
    scaled by ``1 + i / 8``, so that a replica reading another's graph
    shows."""
    return [sample.replace(x_dynamic=sample.x_dynamic * (1 + i / 8)) for i in range(n)]


def mesh_plans(placed, cfg) -> list:
    """The placed row plans (``gspmd.RowModel.plans``) of every row of a
    ``MeshBatch`` with graphs, built at their first use."""
    from mswe_gnn_tpu_torch.parallel.gspmd import row_model

    return [row_model(r, cfg).plans for r in placed.rows if r.graph is not None]


def mesh_tables(plans_list) -> dict:
    """Every hop table of row plans, each part's, by ``(Nd, Ns)`` (the
    layout of ``ring_tables``: every group reads the gathered state)."""
    return ring_tables({"proc": [p for plans in plans_list for p in plans["proc"]],
                        "unpool": [p for plans in plans_list for p in plans["unpool"]]})


def mesh_hops_per_step(cfg, plans_list) -> collections.Counter:
    """Hop launches of one model step over row plans by ``(kernel, Nd,
    Ns)``: a processor layer of K hops launches its scale's hop on every
    part of every row K times, an un-pool layer its level's hop once a
    part."""
    counts = collections.Counter()

    def add(pl, n):
        g = pl["groups"][0]
        for tab, out_table in zip(g["tab"], g["out_table"]):
            counts["hop", tab.shape[0], out_table[0].numel() - 1] += n

    for plans in plans_list:
        for k, scale in processor_layers(cfg):
            add(plans["proc"][scale], k)
        for pl in plans["unpool"]:
            add(pl, cfg.intra_cfg().K)
    return counts


def mesh_processor_keys(plans_list) -> set:
    return {("hop", t.shape[0], o[0].numel() - 1) for plans in plans_list
            for pl in plans["proc"] for t, o in zip(pl["groups"][0]["tab"],
                                                    pl["groups"][0]["out_table"])}


def single_tables(cfg, params, graph) -> dict:
    """The one-device hop tables of ``graph`` (its ``prepare_graph`` cache),
    by ``(Nd, Ns)``: each scale's processor table (same block) and each
    level's un-pool table."""
    from mswe_gnn_tpu_torch.models import prepare_graph

    with torch.no_grad():
        cache = prepare_graph(params, cfg, graph).ell_cache
    tables = collections.defaultdict(list)
    for _, mask, srcs, _, _ in cache["scales"]:
        tables[srcs.shape[0], srcs.shape[0]].append((srcs, mask, True))
    for lvl, (_, mask, usrc, _) in enumerate(cache["unpools"]):
        tables[usrc.shape[0], cache["scales"][lvl + 1][2].shape[0]].append((usrc, mask, False))
    return tables


def merge_tables(*tables) -> dict:
    out = collections.defaultdict(list)
    for t in tables:
        for key, v in t.items():
            out[key] += v
    return out


def mesh_cli_tables(cfg_yaml, ckpt, devices_per_row, most) -> dict:
    """The hop tables a CLI run on a mesh launches: the row plans of unions
    of 1 to ``most`` training samples split over ``devices_per_row``
    devices (training and validation), and the one-device tables of a test
    graph (the evaluation), with the weights of ``ckpt``."""
    from mswe_gnn_tpu_torch import config as config_lib
    from mswe_gnn_tpu_torch import main as cli
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.parallel.gspmd import RowModel

    full = config_lib.with_defaults(cfg_yaml)
    train, _, test, _, _ = cli.prepare_data(full)
    mcfg, params, _ = cli.build_experiment_model(full, test[0], device="cuda")
    params = cli.restore_weights(ckpt, params)
    devices = [torch.device("cuda", 0)] * devices_per_row
    plans = [RowModel(mcfg, concat_graphs(train[:b]).to("cuda"), devices).plans
             for b in range(1, most + 1)]
    return merge_tables(mesh_tables(plans), single_tables(mcfg, params, test[0].to("cuda")))


def time_mesh_placement(cfg, samples, mesh, placed) -> tuple:
    """Host-clock ms (medians of 3, the card synchronized) of the placement a
    ``Trainer`` makes every step on a mesh: ``place`` of the batch from its
    resident stacked copy and ``row_model`` of every row, which finds the
    model kept from ``placed`` (checked); and of the same with every row's
    ``RowModel`` built anew -> ``(place_ms, plan_build_ms)``."""
    import numpy as np

    from mswe_gnn_tpu_torch.graph import stack_graphs
    from mswe_gnn_tpu_torch.parallel.gspmd import RowModel, row_model
    from mswe_gnn_tpu_torch.parallel.sharding import place

    resident = stack_graphs(samples).to(mesh[0][0])
    kept = [row_model(r, cfg) for r in placed.rows]

    def once(build):
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = place(resident, np.arange(len(samples)), mesh)
        models = [RowModel(cfg, r.graph, r.devices) if build else row_model(r, cfg)
                  for r in again.rows]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, models

    hits = [once(False) for _ in range(3)]
    if not all(m is k for _, models in hits for m, k in zip(models, kept)):
        raise AssertionError("[mesh] a new placement of the same batch rebuilt a row model")
    builds = [once(True) for _ in range(3)]
    return (statistics.median(t for t, _ in hits), statistics.median(t for t, _ in builds))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def read_history(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def bf16_ulps(own) -> float:
    """Two bf16 ulps of a rollout's largest prediction: the limit of a mesh
    rollout against the graph's one-device rollout (phase 4's)."""
    return 2 * 2.0 ** -8 * float(own.abs().max())


def mesh_train_step(cfg, params, apply_fn, samples, placed, per_step, through) -> dict:
    """(a), (f): the bench train step (6-step pushforward, remat) on a
    ``MeshBatch``: its float32 loss and gradients against the one-device
    step on the union of ``samples`` (``hold_ring_grads``' limits), then the
    bf16 step counted by ``(kernel, Nd, Ns)`` against ``per_step`` (a model
    step's hop launches) and timed as phase 8's."""
    from mswe_gnn_tpu_torch.bench_problem import BenchTrainStep
    from mswe_gnn_tpu_torch.graph import concat_graphs
    from mswe_gnn_tpu_torch.training.train import (TrainerOptions, clone_tree, loss_and_grads,
                                                   make_optimizer)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    opts = TrainerOptions(batch_size=len(samples), velocity_scaler=7.0, remat=True)
    union = concat_graphs(samples).to(torch.device("cuda", 0))
    with deterministic("mesh"):
        args = (clone_tree(params), cfg32)
        mesh_grads = loss_and_grads(apply_fn, *args, placed, 6, opts, True)
        single_grads = loss_and_grads(apply_fn, *args, union, 6, opts, True)
        nudged = union.replace(x_dynamic=union.x_dynamic * (1 + 2.0 ** -23))
        nudged_grads = loss_and_grads(apply_fn, *args, nudged, 6, opts, True)
    grads = hold_ring_grads(mesh_grads, single_grads, nudged_grads, None, 6, phase="mesh",
                            through=through)
    check_first_grads("mesh", *mesh_grads)
    expected = collections.Counter()
    for (kernel, nd, ns), n in per_step.items():
        expected[kernel, nd, ns] += 2 * n * 6
        expected[kernel + "_bwd", nd, ns] += n * 6
    p = clone_tree(params)
    optimizer = make_optimizer(opts, steps_per_epoch=1)
    step = BenchTrainStep(apply_fn, cfg, p, placed, opts, optimizer, optimizer.init(p))
    launches, step_ms, _, peak = timed_train_steps("mesh", step, expected)
    return {"grads": grads, "launches": launches, "step_ms": step_ms, "peak_gib": peak}


def mesh_rollout(what, cfg, params, apply_fn, samples, placed, per_step, limit,
                 fixed_sums=False, reps=3) -> dict:
    """(b), (f), (g): the full ``rollout_batch`` of a ``MeshBatch`` of
    ``samples``: its launches held against ``per_step`` (a model step's hop
    launches) x steps, every graph checked as in phase 4 and held against
    its own one-device rollout at step 0 and over all steps within
    ``limit(own rollout)``, then timed (median of ``reps``, CUDA events;
    none without ``reps``). ``fixed_sums``: both rollouts of the comparison run under deterministic
    algorithms, so that ``index_add`` sums each segment in edge order on
    both sides instead of by float32 atomics (learned pooling's segment
    mean: with atomics the bf16 rollouts drift apart by chance); the timed
    ones do not."""
    from mswe_gnn_tpu_torch.training.rollout import rollout, rollout_batch

    dev = torch.device("cuda", 0)
    steps = samples[0].y.shape[-1]
    reset_all_launches()
    with deterministic("mesh") if fixed_sums else contextlib.nullcontext():
        preds = rollout_batch(apply_fn, params, cfg, placed, steps)
        torch.cuda.synchronize()
        launches = read_launches()
        own = [rollout(apply_fn, params, cfg, g, steps, device=dev) for g in samples]
    hold_launches("mesh", f"the {steps}-step rollout_batch{what}", launches,
                  collections.Counter({k: v * steps for k, v in per_step.items()}))
    errs = []
    for i, g in enumerate(samples):
        check_rollout(f"[mesh] graph {i} of the rollout_batch{what}", preds[i], g.to(dev), steps)
        errs.append((float((preds[i][..., 0] - own[i][..., 0]).abs().max()),
                     float((preds[i] - own[i]).abs().max()), limit(own[i])))
    log(f"[mesh] rollout_batch{what} of {len(samples)} on the mesh vs each graph's one-device "
        "rollout (step 0, all steps, limit): "
        + "; ".join(f"graph {i} {a:.3e}, {b:.3e} (limit {lim:.3e})"
                    for i, (a, b, lim) in enumerate(errs)))
    if not all(a <= lim and b <= lim for a, b, lim in errs):
        raise AssertionError(f"[mesh] a graph's rollout{what} on the mesh disagrees with its own")
    if not reps:
        return {"launches": launches, "errs": errs}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    event_ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        rollout_batch(apply_fn, params, cfg, placed, steps)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    rollout_ms = statistics.median(event_ms)
    log(f"[mesh] {steps}-step rollout_batch{what} of {len(samples)} on the mesh: "
        f"{rollout_ms:.1f} ms median of {reps} (CUDA events "
        f"{', '.join(f'{t:.1f}' for t in event_ms)} ms) -> "
        f"{rollout_ms / 1e3 / len(samples):.4f} s a simulation")
    return {"launches": launches, "rollout_ms": rollout_ms, "errs": errs}


def mesh_cli(what, cfg_yaml, tmp, checks) -> dict:
    """(c), (h): ``cfg_yaml`` (a multichip.yaml) through ``main train`` and
    ``main eval`` with ``--device`` 8 x ``cuda:0`` in ``tmp``, under
    deterministic algorithms (autograd's ``index_add`` otherwise adds by
    atomics, and Adam turns a last-bit difference in a near-zero gradient
    into a full step): every file written, a finite 2-epoch history, ELL
    forward and backward launched, the eval summary the training one within
    1e-5, and every launched row-block shape held bit-equal (into
    ``checks``)."""
    import yaml

    n_data, n_graph = MESH_SHAPE
    devices = ",".join(["cuda:0"] * (n_data * n_graph))
    key = "mesh" + what.replace(" ", "_")
    cfg_path = os.path.join(tmp, "multichip.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_yaml, f)
    train_dir = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), deterministic("mesh"):
        train = cli_run(["train", "--config", cfg_path, "--out", train_dir, "--device", devices])
    cli_s = time.perf_counter() - t0
    missing = [f for f in CLI_FILES if not os.path.exists(os.path.join(train_dir, f))]
    history = read_history(train_dir)
    launched = by_kernel(train)
    if (missing or "device mesh: data=4 x graph=2" not in buf.getvalue()
            or [r["epoch"] for r in history] != [0, 1]
            or not all(math.isfinite(r["train_loss"]) for r in history)
            or not (launched["hop"] and launched["hop_bwd"])):
        raise AssertionError(f"[mesh] train of {MESH_CONFIG}{what}: missing {missing}, history "
                             f"{history}, launched {launched}: {buf.getvalue()[-3000:]}")
    evaluated = cli_run(["eval", "--config", cfg_path, "--ckpt", os.path.join(train_dir, "best"),
                         "--out", os.path.join(tmp, "eval"), "--device", devices])
    train_summary = read_json(os.path.join(train_dir, "summary.json"))
    eval_summary = read_json(os.path.join(tmp, "eval", "summary.json"))
    worst = max(abs(eval_summary[k] - v) for k, v in eval_summary.items()
                if not is_timing_key(k))
    if worst >= 1e-5:
        raise AssertionError(f"[mesh] eval{what} {eval_summary} != train {train_summary}")
    log(f"[mesh] {MESH_CONFIG}{what} (F={cfg_yaml['models']['hid_features']}, "
        f"K={cfg_yaml['models']['K']}, batch_layout vmap) on a 4 x 2 mesh of cuda:0: train "
        f"{cli_s:.1f} s in all; epochs "
        + ", ".join(f"{r['epoch']} (train_loss {r['train_loss']:.6f}, "
                    f"{r['epoch_time']:.2f} s)" for r in history)
        + f"; every file written; eval of the new best: the training summary within "
        f"{worst:.2e}; launched train {launched}, eval {by_kernel(evaluated)}")
    tables = mesh_cli_tables(cfg_yaml, os.path.join(train_dir, "best"), n_graph,
                             cfg_yaml["trainer_options"]["batch_size"])
    hold_tables(checks, "mesh", f"{key}_cli_train", tables, train)
    hold_tables(checks, "mesh", f"{key}_cli_eval", tables, evaluated)
    return {"cfg_path": cfg_path, "history": history, "train": train, "eval": evaluated,
            "seconds": cli_s}


def phase_mesh(smi, checks, sample, cfg, params, apply_fn, ring_graph) -> dict:
    """Data x graph parallelism on the card, every mesh entry ``cuda:0``:
    (a) the bench train step on a 4 x 2 mesh, a stacked batch of 4 distinct
    bench samples, its float32 loss and gradients against the one-device
    step on their union, then counted and timed in bf16; (b) the 47-step
    ``rollout_batch`` of the same batch on the mesh against each graph's
    one-device rollout; (c) ``configs/multichip.yaml`` through ``main
    train`` and ``eval``; (d) the same run as two processes; (e) ring_halo
    at data 2 against data 1 on the bench graph, and
    ``configs/ring_halo.yaml`` at its 8 parts falling back to the mesh.
    Every launched shape held against the plain hop (into ``checks``)."""
    from mswe_gnn_tpu_torch import main as cli
    from mswe_gnn_tpu_torch.graph import stack_graphs
    from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn
    from mswe_gnn_tpu_torch.parallel.sharding import make_mesh, shard_batch

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    n_data, n_graph = MESH_SHAPE
    mesh = make_mesh(n_data, n_graph, [dev] * (n_data * n_graph))
    samples = distinct_bench_samples(sample, MESH_BATCH)
    placed = shard_batch(stack_graphs(samples).to(dev), mesh)
    plans = mesh_plans(placed, cfg)
    per_step = mesh_hops_per_step(cfg, plans)
    log(f"[mesh] {n_data} x {n_graph} mesh on {dev}: a stacked batch of {MESH_BATCH} distinct "
        f"bench samples, rows {[r.index.tolist() for r in placed.rows]}, row blocks by scale "
        + "; ".join("/".join(str(t.shape[0]) for t in pl["groups"][0]["tab"])
                    for pl in plans[0]["proc"])
        + f"; hop launches a model step {sum(per_step.values())} by (Nd, Ns) "
        + ", ".join(f"({nd}, {ns}) x{n}" for (_, nd, ns), n in sorted(per_step.items())))
    paths, out = {}, {}

    # (a) the train step: float32 loss and gradients against one device,
    # then the bf16 step counted and timed as phase 8's
    step = mesh_train_step(cfg, params, apply_fn, samples, placed, per_step,
                           f"a {n_data} x {n_graph} mesh")
    paths["mesh_train_step"], out["train_step_ms"] = step["launches"], step["step_ms"]
    out["train_peak_gib"] = step["peak_gib"]
    out["place_ms"], out["plan_build_ms"] = time_mesh_placement(cfg, samples, mesh, placed)
    log(f"[mesh] the placement a trainer makes a step (place the batch, look up each row's "
        f"model, kept across batches): {out['place_ms']:.2f} ms; with each row's model built "
        f"anew: {out['plan_build_ms']:.2f} ms (host clock, medians of 3); "
        f"(a) done {time.perf_counter() - t_phase:.1f} s into the phase")

    # (b) the batched rollout on the mesh against each graph's own rollout
    served = mesh_rollout("", cfg, params, apply_fn, samples, placed, per_step, bf16_ulps)
    paths["mesh_serving"], out["rollout_ms"] = served["launches"], served["rollout_ms"]
    log(f"[mesh] (b) done {time.perf_counter() - t_phase:.1f} s into the phase")
    hold_tables(checks, "mesh", "mesh_train_step", mesh_tables(plans), paths["mesh_train_step"])
    hold_tables(checks, "mesh", "mesh_serving", mesh_tables(plans), paths["mesh_serving"])

    # (c) configs/multichip.yaml through the CLI on the 4 x 2 mesh of cuda:0
    root = os.path.dirname(os.path.abspath(__file__))
    with cli_workdir("smoke_mesh_") as tmp:
        cfg_yaml = cut_config("mesh", MESH_CONFIG, MESH_CLI_CUTS)
        run = mesh_cli("", cfg_yaml, tmp, checks)
        cfg_path, history = run["cfg_path"], run["history"]
        paths["mesh_cli_train"], paths["mesh_cli_eval"] = run["train"], run["eval"]
        out["cli_epoch_s"] = [r["epoch_time"] for r in history]

        # (d) the same run as two processes, each on cuda:0 (2 rows x 2)
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        port = free_port()
        local = ",".join(["cuda:0"] * (n_data // 2 * n_graph))
        t0 = time.perf_counter()
        code = ("import sys, torch; torch.use_deterministic_algorithms(True, warn_only=True); "
                "from mswe_gnn_tpu_torch.main import main; sys.exit(main(sys.argv[1:]))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, "train", "--config", cfg_path,
             "--out", os.path.join(tmp, "two"), "--device", local,
             "--dist-coordinator", f"localhost:{port}", "--dist-num-processes", "2",
             "--dist-process-id", str(pid)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        two_s = time.perf_counter() - t0
        backends = [re.search(r"backend (\w+)", o) for o in outs]
        if any(proc.returncode != 0 for proc in procs) or not all(backends):
            raise AssertionError("[mesh] two-process train failed: "
                                 + " | ".join(o[-2000:] for o in outs))
        missing = [f for f in CLI_FILES if not os.path.exists(os.path.join(tmp, "two", f))]
        two = read_history(os.path.join(tmp, "two"))
        diff = max(abs(a[k] - b[k]) for a, b in zip(history, two)
                   for k in ("train_loss", "val_loss", "val_CSI_005"))
        if missing or len(two) != len(history) or not diff < 1e-5:
            raise AssertionError(f"[mesh] two processes: missing {missing}, history {two} vs "
                                 f"{history}")
        out["two_process"] = {"backend": backends[0].group(1), "seconds": two_s,
                              "epoch_s": [r["epoch_time"] for r in two]}
        log(f"[mesh] (d) two processes of main train, each on {local} (2 rows x 2): backend "
            f"{backends[0].group(1)} (rank 1: {backends[1].group(1)}; the rule gives gloo "
            f"with more ranks than cards), both exit 0 in {two_s:.1f} s, process 0 wrote every "
            f"file; history vs (c) max|diff| {diff:.3e} (limit 1e-5); epochs "
            + ", ".join(f"{r['epoch_time']:.2f} s" for r in two))

    # (e) ring_halo at data 2 against data 1 on the bench graph, then
    # ring_halo.yaml at its own 8 parts, which falls back to the mesh
    ring_parts_ = ring_parts(ring_graph, 4)
    step0 = {}
    paths["mesh_ring_data2"] = collections.Counter()
    for nd_ in (1, 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            layout = cli.parallel_layout({"models": {"model_type": "MSGNN"}, "parallel": {
                "mode": "ring_halo", "data": nd_, "graph": ring_parts_}}, [dev] * ring_parts_)
        ring_apply = make_dist_apply_fn(layout.ring, cfg, ring_graph)
        reset_all_launches()
        step0[nd_] = ring_step0(ring_apply, params, cfg, ring_graph)
        torch.cuda.synchronize()
        paths["mesh_ring_data2"] += read_launches()
        log(f"[mesh] ring_halo data={nd_} x graph={ring_parts_}: ring over "
            f"{len(layout.ring)} devices, mesh {layout.mesh}; {buf.getvalue().strip() or '-'}")
    if not torch.equal(step0[1], step0[2]):
        raise AssertionError("[mesh] ring_halo at data 2 differs from data 1")
    from mswe_gnn_tpu_torch.parallel.dist_swegnn import (build_dist_msgnn_inputs,
                                                         place_dist_inputs)
    hold_ring_shapes(checks, "mesh_ring_data2", place_dist_inputs(
        build_dist_msgnn_inputs(ring_graph, ring_parts_), [dev] * ring_parts_),
        paths["mesh_ring_data2"])
    log(f"[mesh] ring_halo at data 2 x graph {ring_parts_}: step 0 bit-equal to data 1's")
    with cli_workdir("smoke_mesh_ring_") as tmp:
        cfg_yaml = cut_config("mesh", RING_CONFIG, {})
        n_parts = cfg_yaml["parallel"]["graph"]
        buf = io.StringIO()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summary = cli.run_training(copy.deepcopy(cfg_yaml), os.path.join(tmp, "train"),
                                       device=[dev] * n_parts)
        torch.cuda.synchronize()
        fallback_s = time.perf_counter() - t0
        paths["mesh_ring_fallback"] = read_launches()
        text = buf.getvalue()
        history = read_history(os.path.join(tmp, "train"))
        launched = by_kernel(paths["mesh_ring_fallback"])
        if (cli.FALLBACK not in text or f"device mesh: data=1 x graph={n_parts}" not in text
                or [r["epoch"] for r in history] != [0, 1]
                or not all(math.isfinite(v) for v in summary.values())
                or not (launched["hop"] and launched["hop_bwd"])):
            raise AssertionError(f"[mesh] {RING_CONFIG} at {n_parts} parts: {text[-3000:]}")
        tables = mesh_cli_tables(cfg_yaml, os.path.join(tmp, "train", "best"), n_parts,
                                 cfg_yaml["trainer_options"]["batch_size"])
        hold_tables(checks, "mesh", "mesh_ring_fallback", tables, paths["mesh_ring_fallback"])
    out["ring_fallback_epoch_s"] = [r["epoch_time"] for r in history]
    log(f"[mesh] {RING_CONFIG} at its {n_parts} parts: "
        + next(line for line in text.splitlines() if "ring_halo at" in line)
        + f"; printed JAX's line ({cli.FALLBACK!r}) and trained on a 1 x {n_parts} mesh in "
        f"{fallback_s:.1f} s: epochs "
        + ", ".join(f"{r['epoch']} (train_loss {r['train_loss']:.6f}, {r['epoch_time']:.2f} s)"
                    for r in history)
        + f"; launched {launched}")
    out.update(launches=paths, plans=plans, per_step=per_step, mesh=mesh, samples=samples,
               placed=placed)
    log(f"[mesh] summary: bf16 train step {out['train_step_ms']:.1f} ms, rollout_batch "
        f"{out['rollout_ms']:.1f} ms on the 4 x 2 mesh; {smi}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def mesh_baselines(gnn_sample, mesh) -> dict:
    """(g) pareto_gnn's Cheb / TAG / GAT at its width (F=64, K=10, 2 layers,
    float32) on a stacked batch of 4 distinct samples of the single-scale
    bench graph, on the mesh: ``rollout_batch`` held against each graph's
    one-device rollout within 1e-4 at step 0 and over all steps
    (``index_add`` adds with atomics on the card, as phase 11 (c)) and
    timed; the float32 train step (6-step pushforward, remat, ``multiscale``
    False) against the one-device step on the stacked batch: the loss within
    1e-5 relative, every leaf within 1e-4 max|leaf|. No hop is launched."""
    from mswe_gnn_tpu_torch.bench_problem import build_pareto_gnn_model
    from mswe_gnn_tpu_torch.graph import stack_graphs
    from mswe_gnn_tpu_torch.parallel.sharding import shard_batch
    from mswe_gnn_tpu_torch.training.train import TrainerOptions, loss_and_grads

    dev = torch.device("cuda", 0)
    samples = distinct_bench_samples(gnn_sample, MESH_BATCH)
    stacked = stack_graphs(samples).to(dev)
    placed = shard_batch(stacked, mesh)
    opts = TrainerOptions(batch_size=MESH_BATCH, velocity_scaler=7.0, remat=True)
    out, launches = {}, collections.Counter()
    for kind in BASELINES:
        cfg, params, apply_fn = build_pareto_gnn_model(gnn_sample, device=dev, type_GNN=kind)
        served = mesh_rollout(f" of {kind}", cfg, params, apply_fn, samples, placed,
                              collections.Counter(), lambda own: 1e-4)
        reset_all_launches()
        with deterministic("mesh"):
            got = loss_and_grads(apply_fn, params, cfg, placed, 6, opts, False)
            want = loss_and_grads(apply_fn, params, cfg, stacked, 6, opts, False)
        torch.cuda.synchronize()
        launches += served["launches"] + read_launches()
        r = compare_grads(*got, *want)
        log(f"[mesh] (g) {kind} float32 train step on the mesh vs one device: loss rel diff "
            f"{r['loss_rel']:.3e} (limit 1e-5), worst leaf max|diff|/max|leaf| "
            f"{r['worst_leaf']:.3e} (limit 1e-4); worst leaves "
            + "; ".join(f"{n} {q:.3e}" for n, q, _, _ in r["worst"]))
        check_first_grads("mesh", *got)
        if not (r["loss_rel"] <= 1e-5 and r["leaves_within"]):
            raise AssertionError(f"[mesh] (g) the {kind} train step on the mesh disagrees with "
                                 "one device")
        out[kind] = {"rollout_ms": served["rollout_ms"], "errs": served["errs"],
                     "loss_rel": r["loss_rel"], "worst_leaf": r["worst_leaf"]}
    if sum(launches.values()):
        raise AssertionError(f"[mesh] (g) the baselines launched hop kernels: {dict(launches)}")
    log("[mesh] (g) the baselines launched no hop kernel")
    return {"baselines": out, "launches": launches}


def profiling_and_cache(sample, cfg, params, apply_fn, serving) -> dict:
    """(i) ``utils/profiling.trace`` around one bench model step writes a
    Chrome trace holding CUDA kernels; ``utils/profiling.timed`` of phase
    4's rollout beside phase 4's own median."""
    from mswe_gnn_tpu_torch.models import prepare_graph
    from mswe_gnn_tpu_torch.training.rollout import rollout
    from mswe_gnn_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    graph = sample.to(dev)
    with torch.inference_mode():
        gt = first_step(prepare_graph(params, cfg, graph))
        apply_fn(params, cfg, gt)
        with cli_workdir("smoke_trace_") as tmp:
            with profiling.trace(os.path.join(tmp, "trace")) as path:
                apply_fn(params, cfg, gt)
            size = os.path.getsize(path)
            events = read_json(path)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    hops = [e for e in kernels if "hop_fwd_kernel" in e.get("name", "")]
    log(f"[mesh] (i) profiling.trace of one bench model step: {size} bytes, {len(events)} "
        f"events, {len(kernels)} CUDA kernels ({len(hops)} ELL hop forwards)")
    if not (size and kernels and hops):
        raise AssertionError("[mesh] (i) the trace holds no CUDA kernel of the model step")
    steps = sample.y.shape[-1]
    t = profiling.timed(rollout, apply_fn, params, cfg, graph, steps, dev, reps=3, warmup=1)
    log(f"[mesh] (i) profiling.timed of phase 4's {steps}-step rollout: median "
        f"{t['median_s'] * 1e3:.1f} ms (min {t['min_s'] * 1e3:.1f}, mean "
        f"{t['mean_s'] * 1e3:.1f}; host clock, synchronized); phase 4's own median "
        f"{serving['rollout_ms']:.1f} ms (CUDA events)")
    return {"trace_bytes": size, "trace_kernels": len(kernels), "timed": t}


def phase_mesh_models(smi, checks, sample, gnn_sample, serving, mesh_, bench_model) -> dict:
    """Phase 14 (f)-(i), every model on the mesh: (f) the bench MSGNN with
    learned pooling on (a)'s batch and mesh, its float32 train step against
    one device, its bf16 step and 47-step ``rollout_batch`` counted by
    shape (the pooling launches no hop: (a)'s and (b)'s counts) and timed;
    (g) the baselines (``mesh_baselines``); (h) multichip.yaml with
    ``learned_pooling`` through the CLI (``mesh_cli``); (i) the profiling
    helpers on ``bench_model`` (``profiling_and_cache``)."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    paths, out = {}, {}
    cfg, params, apply_fn = build_bench_model(sample, device=dev, learned_pooling=True)
    plans = mesh_plans(mesh_["placed"], cfg)
    per_step = mesh_hops_per_step(cfg, plans)
    if per_step != mesh_["per_step"]:
        raise AssertionError(f"[mesh] (f) learned pooling's row plans launch {dict(per_step)}, "
                             f"(a)'s {dict(mesh_['per_step'])}")
    log(f"[mesh] (f) the bench MSGNN with learned pooling on (a)'s {MESH_SHAPE[0]} x "
        f"{MESH_SHAPE[1]} mesh: {sum(per_step.values())} hop launches a model step, (a)'s")
    step = mesh_train_step(cfg, params, apply_fn, mesh_["samples"], mesh_["placed"], per_step,
                           "the 4 x 2 mesh with learned pooling")
    paths["mesh_lp_train_step"], out["lp_train_step_ms"] = step["launches"], step["step_ms"]
    served = mesh_rollout(" with learned pooling", cfg, params, apply_fn, mesh_["samples"],
                          mesh_["placed"], per_step, bf16_ulps, fixed_sums=True)
    paths["mesh_lp_serving"], out["lp_rollout_ms"] = served["launches"], served["rollout_ms"]
    # the same in float32, where rounding alone moves a rollout far less
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    paths["mesh_lp_serving_f32"] = mesh_rollout(
        " with learned pooling in float32", cfg32, params, apply_fn, mesh_["samples"],
        mesh_["placed"], per_step, lambda own: 1e-4 * float(own.abs().max()), fixed_sums=True,
        reps=0)["launches"]
    for path in ("mesh_lp_train_step", "mesh_lp_serving", "mesh_lp_serving_f32"):
        hold_tables(checks, "mesh", path, mesh_tables(plans), paths[path])
    log(f"[mesh] (f) done in {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    base = mesh_baselines(gnn_sample, mesh_["mesh"])
    paths["mesh_baselines"], out["baselines"] = base["launches"], base["baselines"]
    log(f"[mesh] (g) done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with cli_workdir("smoke_mesh_lp_") as tmp:
        cfg_yaml = cut_config("mesh", MESH_CONFIG, MESH_CLI_CUTS)
        log("[mesh] (h) override: models.learned_pooling -> True")
        cfg_yaml["models"]["learned_pooling"] = True
        run = mesh_cli(" lp", cfg_yaml, tmp, checks)
    paths["mesh_lp_cli_train"], paths["mesh_lp_cli_eval"] = run["train"], run["eval"]
    out["lp_cli_epoch_s"] = [r["epoch_time"] for r in run["history"]]
    log(f"[mesh] (h) done in {time.perf_counter() - t0:.1f} s")

    out["profiling"] = profiling_and_cache(sample, *bench_model, serving)
    out["launches"] = paths
    log(f"[mesh] (f)-(i) summary: learned pooling bf16 train step {out['lp_train_step_ms']:.1f} "
        f"ms, rollout_batch {out['lp_rollout_ms']:.1f} ms; baselines rollout_batch "
        + ", ".join(f"{k} {v['rollout_ms']:.1f} ms" for k, v in out["baselines"].items())
        + f"; {smi}; (f)-(i) took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------- phase 15
SWEEP_CONFIG = "configs/pareto.yaml"
SWEEP_CUTS = {("synthetic_data", "n_sims"): 12, ("trainer_options", "max_epochs"): 2}
SWEEP_ID = "smoke/pareto/stand-in"
SWEEP_TRIALS = ({"models.K": 5, "models.hid_features": 64, "trainer_options.watch_every": 1},
                {"models.K": 4, "models.hid_features": 64})
REPORT_FILES = ("csi_curves.png", "f1_curves.png", "execution_times_box.png",
                "rollout_best.png", "rollout_worst.png", "fat_best.png", "csi_f1_best.png",
                "froude_best.png", "conservation_best.png", "rollout_best.gif",
                "rollout_best_multiscale.gif")


class StandInRun:
    """A sweep trial's run of the stand-in wandb: what the logger sends it."""

    def __init__(self, module, run_id, config):
        self.module, self.id, self.config = module, run_id, dict(config)
        self.sweep_id = module.sweep_id
        self.logged, self.summary, self.finished = [], {}, False

    def log(self, metrics, **kw):
        if kw:
            raise AssertionError(f"[reports] a record logged with {kw}: wandb drops a step "
                                 "behind its own")
        self.logged.append(dict(metrics))

    def finish(self):
        self.finished = True
        if self.module.run is self:
            self.module.run = None


class StandInHistogram:
    def __init__(self, values):
        self.values = values


def stand_in_wandb(trials):
    """A ``wandb`` module for a machine without one: ``agent`` runs one trial
    a config of ``trials``, counting each trial's launches from 0 (in
    ``launches``); ``init()`` opens the trial's run, a sweep run whose
    config holds the trial's dotted-key overrides."""
    import types

    mod = types.ModuleType("wandb")
    mod.run, mod.sweep_id, mod.Histogram = None, None, StandInHistogram
    mod.runs, mod.launches = [], []

    def init(**kw):
        if kw or mod.sweep_id is None:
            raise AssertionError(f"[reports] wandb.init({kw}) outside a sweep trial")
        mod.run = StandInRun(mod, f"smoke{len(mod.runs)}", trials[len(mod.runs)])
        mod.runs.append(mod.run)
        return mod.run

    def agent(sweep_id, function, count):
        mod.sweep_id = sweep_id
        for _ in range(count):
            reset_all_launches()
            function()
            torch.cuda.synchronize()
            mod.launches.append(read_launches())

    mod.init, mod.agent = init, agent
    return mod


@contextlib.contextmanager
def module_in_place(name, module):
    """``sys.modules[name]`` is ``module`` while the block runs."""
    missing = object()
    saved = sys.modules.get(name, missing)
    sys.modules[name] = module
    try:
        yield module
    finally:
        if saved is missing:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved


class Tee(io.TextIOBase):
    """Writes through to ``stream`` and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.seen = stream, io.StringIO()

    def write(self, s):
        self.seen.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def hold_trial(i, run, counts, trial_dir) -> dict:
    """Sweep trial ``i``: its records, summary and finished run on the
    stand-in, its files, its ELL launches; trial 0's histograms, one a
    parameter leaf, finite. -> its config, history, summary and launches."""
    import numpy as np

    missing = [p for p in ("summary.json", "config.json", "metrics.jsonl", "best/params.npz",
                           "best/meta.json") if not os.path.exists(os.path.join(trial_dir, p))]
    if missing:
        raise AssertionError(f"[reports] trial {i} wrote no {missing}")
    cfg = read_json(os.path.join(trial_dir, "config.json"))
    want = SWEEP_TRIALS[i]
    got = {k: cfg[k.split(".")[0]][k.split(".")[1]] for k in want}
    if got != want:
        raise AssertionError(f"[reports] trial {i} trained {got}, its overrides {want}")
    records = [r for r in run.logged if "train_loss" in r]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r[k]) for r in records
            for k in ("train_loss", "val_loss", "val_CSI_005")):
        raise AssertionError(f"[reports] trial {i}'s records on its run: {records}")
    summary = read_json(os.path.join(trial_dir, "summary.json"))
    same = set(run.summary) == set(summary) and all(
        run.summary[k] == v or (math.isnan(run.summary[k]) and math.isnan(v))
        for k, v in summary.items())
    if not (run.finished and same):
        raise AssertionError(f"[reports] trial {i}: run finished {run.finished}, summary "
                             f"{run.summary} against {summary}")
    with np.load(os.path.join(trial_dir, "best", "params.npz")) as saved:
        n_leaves = len(saved.files)
    hists = [r for r in run.logged if any(isinstance(v, StandInHistogram) for v in r.values())]
    if i == 0:
        sizes = [sum(k.startswith("watch/") for k in h) for h in hists]
        if [h["epoch"] for h in hists] != [0, 1] or sizes != [n_leaves] * 2 or not all(
                np.isfinite(v.values).all() for h in hists for v in h.values()
                if isinstance(v, StandInHistogram)):
            raise AssertionError(f"[reports] trial 0's histograms: epochs "
                                 f"{[h.get('epoch') for h in hists]}, {sizes} leaves of "
                                 f"{n_leaves}")
    elif hists:
        raise AssertionError(f"[reports] trial {i} watched no epoch, yet logged histograms")
    launched = by_kernel(counts)
    if not (launched["hop"] and launched["hop_bwd"]):
        raise AssertionError(f"[reports] trial {i} launched {launched}")
    log(f"[reports] (a) trial {i} ({run.id}: " + ", ".join(f"{k} {v}" for k, v in got.items())
        + "): epochs " + ", ".join(f"{r['epoch']} (train_loss {r['train_loss']:.6f}, val_CSI_005 "
                                   f"{r['val_CSI_005']:.4f}, epoch_time {r['epoch_time']:.2f} s)"
                                   for r in records)
        + f"; {len(run.logged)} records and {len(run.summary)} summary keys on its run, "
        f"finished; {len(hists)} histogram records of {n_leaves} leaves; launched {launched}")
    return {"cfg": cfg, "history": records, "summary": summary, "launches": counts}


def phase_reports(smi, checks) -> dict:
    """(a) ``main sweep`` of the pareto.yaml model at full width under a
    stand-in wandb agent, two trials; (b) ``main eval`` of trial 0's
    ``best`` with ``--out``: the report figures, or the skip line where
    matplotlib is missing. Every launched shape held (into ``checks``)."""
    import importlib.util

    import yaml

    from mswe_gnn_tpu_torch import main as cli

    t_phase = time.perf_counter()
    cut = cut_config("reports", SWEEP_CONFIG, SWEEP_CUTS)
    with cli_workdir("smoke_reports_") as tmp:
        cfg_path = os.path.join(tmp, "pareto_cut.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cut, f)
        out = os.path.join(tmp, "sweep")
        with module_in_place("wandb", stand_in_wandb(SWEEP_TRIALS)) as wandb:
            t0 = time.perf_counter()
            rc = cli.main(["sweep", "--config", cfg_path, "--sweep-id", SWEEP_ID, "--count",
                           str(len(SWEEP_TRIALS)), "--out", out])
            sweep_s = time.perf_counter() - t0
        if rc != 0 or len(wandb.runs) != len(SWEEP_TRIALS):
            raise AssertionError(f"[reports] sweep returned {rc} after {len(wandb.runs)} trials")
        trials, dirs = [], []
        for i, (run, counts) in enumerate(zip(wandb.runs, wandb.launches)):
            dirs.append(os.path.join(out, f"trial_{run.id}"))
            trials.append(hold_trial(i, run, counts, dirs[-1]))
        sweep_counts = sum((t["launches"] for t in trials), collections.Counter())
        log(f"[reports] (a) {len(trials)} trials at full width in {sweep_s:.1f} s; launched "
            f"{by_kernel(sweep_counts)}")

        # (b) the reporting eval of trial 0's best
        eval_dir = os.path.join(tmp, "eval")
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            eval_counts = cli_run(["eval", "--config", os.path.join(dirs[0], "config.json"),
                                   "--ckpt", os.path.join(dirs[0], "best"), "--out", eval_dir])
        eval_s = time.perf_counter() - t0
        skipped = tee.seen.getvalue().count(cli.FIGURES_SKIPPED)
        written = sorted(os.listdir(eval_dir))
        has_matplotlib = importlib.util.find_spec("matplotlib") is not None
        if has_matplotlib:
            empty = [f for f in REPORT_FILES if not os.path.exists(os.path.join(eval_dir, f))
                     or os.path.getsize(os.path.join(eval_dir, f)) == 0]
            if skipped or empty:
                raise AssertionError(f"[reports] (b) with matplotlib: skip line {skipped}x, "
                                     f"missing or empty {empty}")
        elif skipped != 1 or written != ["summary.json"]:
            raise AssertionError(f"[reports] (b) without matplotlib: the skip line printed "
                                 f"{skipped} times, files {written}")
        summary = read_json(os.path.join(eval_dir, "summary.json"))
        worst = max(abs(summary[k] - v) for k, v in summary.items() if not is_timing_key(k))
        if worst >= 1e-5 or set(summary) != set(trials[0]["summary"]) - {"n_params"}:
            raise AssertionError(f"[reports] (b) eval {summary} != trial 0's training summary "
                                 f"{trials[0]['summary']}")
        log(f"[reports] (b) eval of trial 0's best in {eval_s:.1f} s: matplotlib "
            f"{'present' if has_matplotlib else 'absent'}, the skip line printed {skipped} "
            f"time(s), files {written}; the training summary within {worst:.2e}; "
            f"mean_prediction_time_s {summary['mean_prediction_time_s']:.4f}; launched "
            f"{by_kernel(eval_counts)}")

        # the kernels at every shape the sweep and the eval launched, with
        # each trial's model and weights
        for i, trial in enumerate(trials):
            paths = [(f"reports_sweep trial {i}", 0, trial["launches"])]
            if i == 0:
                paths.append(("reports_eval", 2, eval_counts))
            hold_cli_shapes(checks, trial["cfg"], {"train_dir": dirs[i]}, paths)
    log(f"[reports] summary: epoch times " + "; ".join(
        f"trial {i} " + ", ".join(f"{r['epoch_time']:.2f}" for r in t["history"]) + " s"
        for i, t in enumerate(trials))
        + f"; eval mean_prediction_time_s {summary['mean_prediction_time_s']:.4f}; {smi}; "
        f"(a) and (b) took {sweep_s + eval_s:.1f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"reports_sweep": sweep_counts, "reports_eval": eval_counts},
            "epoch_s": [[r["epoch_time"] for r in t["history"]] for t in trials],
            "eval_s_per_sim": summary["mean_prediction_time_s"], "sweep_s": sweep_s,
            "eval_s": eval_s}


# ---------------------------------------------------------------- phase 6
def phase_timing(cases, flush, paths, checks, path_dtypes=None) -> dict:
    """Holds every case of ``timing_cases`` bit-equal to its plain version on
    the case's own inputs (into ``checks``; the union shapes are held here
    and nowhere else), then times it (kernel, L2 flushed, plain version),
    with the launch floor before and after. ``paths`` maps each
    path driven (``serving``, ``train_step``, the batched ones) to the
    launches the wrappers counted there by ``(kernel, Nd, Ns)``; each row
    carries the launches of its shape on every path whose dtype
    (``path_dtypes``, bf16 where not named) is the row's, and each kernel
    gets its sum of launches x time on each path."""
    path_dtypes = path_dtypes or {}
    floors = [launch_floor_ms()]
    rows = {kernel: [] for kernel in KERNELS}
    for c in cases:
        got, want = c["run"](), c["plain"]()
        dtype = {v: k for k, v in DTYPE_NAMES.items()}[c["dtype"]]
        err = checks.hold(c["kernel"], c["shape"], dtype, "timing",
                          got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,), exact=True)
        del got, want
        row = time_fn(c["run"], c["plain"], flush)
        row["max_abs_err"] = err
        row.update({k: v for k, v in c.items() if k not in ("run", "plain", "key")},
                   n_dst=c["key"][1], n_src=c["key"][2],
                   launches={path: (counts[c["key"]]
                                    if path_dtypes.get(path, "bf16") == c["dtype"] else 0)
                             for path, counts in paths.items()})
        rows[c["kernel"]].append(row)
    log(f"[timing] {len(cases)} cases held bit-equal to their plain versions on their own "
        f"inputs")
    floors.append(launch_floor_ms())
    floor_ms = statistics.median(floors)
    log(f"[timing] launch floor (a one-element add, replayed in a CUDA graph as the kernels "
        f"are): {', '.join(f'{f * 1e3:.2f}' for f in floors)} us")
    for kernel, krows in rows.items():
        for row in krows:
            row["floor_ms"] = floor_ms
            log_timing(kernel, row)
    for kernel, krows in rows.items():
        for path in paths:
            n = sum(r["launches"][path] for r in krows)
            if n == 0:
                continue
            busy = sum(r["launches"][path] * r["ms"] for r in krows)
            gap = sum(r["launches"][path] * (r["ms"] - r["bound_ms"]) for r in krows)
            log(f"[timing] {kernel} on the {path}: {n} launches counted at these shapes, "
                f"{busy:.3f} ms of kernel time (sum of launches x time), {gap:.3f} ms over "
                f"the bound")
    return rows


def kernel_entry(name, source, replaces, max_err, rows, by_path):
    """A kernel's entry of the ``kernels`` line: ``launches`` is the sum of
    its launches over every path driven (``by_path``: launches by kernel,
    each path counted from 0), kept per path in ``launches_by_path``; the
    times and the bound are those of its first row."""
    head = rows[0]
    launches_by_path = {path: n[name] for path, n in by_path.items()}
    if not sum(launches_by_path.values()):
        raise AssertionError(f"{name} was launched on no path")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches_by_path.values()), "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "shape": head["shape"],
            "launches_by_path": launches_by_path, "shapes": rows}


def main() -> None:
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model, build_bench_sample
    from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    sample, mesh = build_bench_sample()
    banded = attach_band_plan(sample)
    log(f"[setup] bench graph and band plan built on the host in "
        f"{time.perf_counter() - t0:.1f} s; band_meta {banded.band_meta}")
    checks = phase_kernels(banded)
    cfg, params, apply_fn = build_bench_model(sample, device=torch.device("cuda"))
    flush = torch.empty(24 * 2 ** 20, dtype=torch.int32, device="cuda")   # 96 MB > L2
    serving = phase_serving(sample, mesh, cfg, params, apply_fn)
    train = phase_train(banded, cfg, params, apply_fn)
    batched = phase_batched_serving(sample, cfg, params, apply_fn, serving)
    batched_train = phase_batched_train(banded, sample, cfg, params, apply_fn)
    phase_trainer()
    cli = phase_cli(smi, checks)
    gnn = phase_gnn(smi, checks, sample)
    data = phase_data(smi, checks)
    ring = phase_ring(smi, checks, sample, cfg, params)
    mesh_ = phase_mesh(smi, checks, sample, cfg, params, apply_fn, ring["graph"])
    models = phase_mesh_models(smi, checks, sample, gnn["sample"], serving, mesh_,
                               (cfg, params, apply_fn))
    reports = phase_reports(smi, checks)
    # phase 6 runs last: it also times the union shapes of phases 7 and 8
    cases = timing_cases(banded, serving["cache"], cfg)
    cache4, spec4 = batched_train["cache"]
    cases += ell_timing_cases(cache4, spec4, {(nd, ns) for _, nd, ns in hops_per_step(cfg, spec4)},
                              f"union b={TRAIN_BATCH} ")
    cache20, spec20 = batched["caches"][20]
    cases += ell_timing_cases(cache20, spec20, set(), "union b=20 ")
    paths = {"serving": serving["launches"], "train_step": train["launches"]}
    paths.update({f"serving_b{b}": counts for b, counts in batched["launches"].items()})
    paths[f"train_step_b{TRAIN_BATCH}"] = batched_train["launches"]
    paths.update(cli["launches"])
    paths.update(gnn["launches"])
    paths.update(data["launches"])
    # pareto_gnn's float32 hops on its own table and plan (the same shape as
    # the bench's scale 0, another dtype)
    cases += ell_timing_cases(gnn["cache"], gnn["spec"], set(), "gnn ", torch.float32)
    cases += band_timing_cases(gnn["banded"], "gnn plan", torch.float32)
    # the ring path's partition shapes (phase 13), bf16 as its rollout
    cases += ring_timing_cases(ring["plans"], cfg)
    paths.update(ring["launches"])
    # the mesh path's row-block shapes (phase 14), bf16 as its train step
    cases += partition_timing_cases(mesh_["per_step"], mesh_tables(mesh_["plans"]),
                                    mesh_processor_keys(mesh_["plans"]), "mesh block",
                                    "row table", 7000)
    paths.update(mesh_["launches"])
    paths.update(models["launches"])
    paths.update(reports["launches"])
    path_dtypes = dict.fromkeys(("cli_train", "cli_eval", "cli_eval_trained", "gnn_serving",
                                 "gnn_train_step", "gnn_cli_train", "gnn_cli_eval",
                                 "data_cli_train", "data_cli_eval", "data_map_train",
                                 "data_map_eval", "data_pickle_train", "ring_serving_f32",
                                 "ring_overlap_step", "ring_wide_step", "ring_cli_train",
                                 "mesh_cli_train", "mesh_cli_eval", "mesh_ring_fallback",
                                 "mesh_baselines", "mesh_lp_cli_train", "mesh_lp_cli_eval",
                                 "mesh_lp_serving_f32", "reports_sweep", "reports_eval"),
                                "float32")
    timing = phase_timing(cases, flush, paths, checks, path_dtypes)
    by_path = {path: by_kernel(counts) for path, counts in paths.items()}
    kernels = [
        kernel_entry("hop", SOURCES["hop"], "mswe_gnn_tpu/ops/pallas_hop.py:54",
                     checks.max_err("hop"), timing["hop"], by_path),
        kernel_entry("hop_bwd", SOURCES["hop"],
                     "none: the port's own backward of the ELL hop (XLA autodiff of "
                     "mswe_gnn_tpu/models/swegnn.py:447-471 in the JAX package)",
                     checks.max_err("hop_bwd"), timing["hop_bwd"], by_path),
        kernel_entry("band_hop", SOURCES["band_hop"], "mswe_gnn_tpu/ops/band_hop.py:178",
                     checks.max_err("band_hop"), timing["band_hop"], by_path),
        kernel_entry("band_hop_bwd", SOURCES["band_hop"], "mswe_gnn_tpu/ops/band_hop.py:255",
                     checks.max_err("band_hop_bwd"), timing["band_hop_bwd"], by_path),
    ]
    kernels[0]["rollout_ms"] = serving["rollout_ms"]
    kernels[0]["s_per_sim_by_batch"] = batched["s_per_sim"]
    for k in kernels[1:]:
        k["train_step_ms"] = train["step_ms"]
    for k in kernels[:2]:
        k[f"train_step_b{TRAIN_BATCH}_ms"] = batched_train["step_ms"]
        k["cli_epoch_s"] = cli["epoch_s"]
    kernels[0]["cli_trained_eval"] = {key: cli["trained"][key] for key in (
        "test_CSI_005", "test_MAE_WD", "mean_prediction_time_s")}
    kernels[0]["gnn_rollout_ms"] = gnn["rollout_ms"]
    kernels[0]["gnn_baseline_rollout_ms"] = {k: v["rollout_ms"]
                                             for k, v in gnn["baselines"].items()}
    for k in kernels[:2]:
        k["gnn_cli_epoch_s"] = gnn["epoch_s"]
    for k in kernels[2:]:
        k["gnn_train_step_ms"] = gnn["train_step_ms"]
    kernels[0]["data_rollout_ms"] = data["rollout_ms"]
    for k in kernels[1:]:
        k["data_train_step_ms"] = data["train_step_ms"]
    for k in kernels[:2]:
        k["data_cli_epoch_s"] = {key: data[f"{key}_epoch_s"] for key in ("cli", "map", "pickle")}
    kernels[0]["ring_rollout_ms"] = ring["rollout_ms"]
    for k in kernels[:2]:
        k["ring_parts"] = ring["parts"]
        k["ring_train_step_ms"] = ring["train_step_ms"]
        k["ring_cli_epoch_s"] = ring["cli_epoch_s"]
    kernels[0]["mesh_rollout_batch_ms"] = mesh_["rollout_ms"]
    for k in kernels[:2]:
        k["mesh_train_step_ms"] = mesh_["train_step_ms"]
        k["mesh_place_ms"] = mesh_["place_ms"]
        k["mesh_cli_epoch_s"] = mesh_["cli_epoch_s"]
        k["mesh_two_process"] = mesh_["two_process"]
        k["mesh_lp_train_step_ms"] = models["lp_train_step_ms"]
        k["mesh_lp_cli_epoch_s"] = models["lp_cli_epoch_s"]
    kernels[0]["mesh_lp_rollout_batch_ms"] = models["lp_rollout_ms"]
    kernels[0]["mesh_baseline_rollout_batch_ms"] = {
        k: v["rollout_ms"] for k, v in models["baselines"].items()}
    kernels[0]["rollout_timed_s"] = models["profiling"]["timed"]
    for k in kernels[:2]:
        k["reports_sweep_epoch_s"] = reports["epoch_s"]
    kernels[0]["reports_eval_s_per_sim"] = reports["eval_s_per_sim"]
    log(f"[done] whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
