"""Smoke test of the PyTorch port (``mswe_gnn_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  -- exits non-zero without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build   -- compiles ``mswe_gnn_tpu_torch/ops/csrc/hop.cu`` for sm_90a.
3. kernels -- the hop kernel against its plain PyTorch version on the card:
   every mode, both dtypes, same-block and separate-source calls, ragged
   shapes and the bench shapes.
4. slice   -- the bench problem of ``bench.py:75-120`` rebuilt through the
   port (152x152 grid, 3 scales, F=64, K=5, bf16), its 47-step rollout on
   the card with the hop-kernel launches counted, the first step held
   against the same step through the plain hop, and the rollout and the hop
   timed.

Then one JSON line describing every kernel, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without printing a result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mswe_gnn_tpu_torch.ops import hop as hop_ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores, same sheet
BENCH_ROWS = (23168, 5888, 1536)   # padded nodes per scale of the bench graph
DEGREE, FEAT = 4, 64


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
def phase_build() -> None:
    info = hop_ops.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[build] {hop_ops.CSRC.name} -> {info['path']} in {info['seconds']:.1f} s")
    for ln in ptxas:
        log(f"[build]   {ln}")


# ---------------------------------------------------------------- phase 3
def make_hop_inputs(seed, n_dst, n_src, degree, feat, dtype, same_block,
                    device="cuda"):
    """Random hop inputs with dry (all-zero) rows and masked (zero) slots."""
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
    s = torch.randn(n_dst, degree, feat, generator=g)
    s[torch.rand(n_dst, degree, generator=g) < 0.25] = 0.0
    dst = dst.to(device=device, dtype=dtype)
    src = dst if same_block else src.to(device=device, dtype=dtype)
    return dst, src, tab.to(device), s.to(device=device, dtype=dtype)


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


def phase_kernels() -> dict:
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
    hop_ops.reset_launches()
    calls, worst = 0, {}
    for seed, (name, n_dst, n_src, degree, feat, same) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            args = make_hop_inputs(seed, n_dst, n_src, degree, feat, dtype, same)
            for mode, (grad, up) in MODES.items():
                got = hop_ops.hop(*args, with_gradient=grad, upwind=up)
                calls += 1
                want = hop_ops.hop_reference(*args, with_gradient=grad, upwind=up)
                torch.cuda.synchronize()
                ok, err = within_limit(got, want, dtype)
                key = str(dtype).replace("torch.", "")
                worst[key] = max(worst.get(key, 0.0), err)
                log(f"[kernels] {name:28s} {key:8s} {mode:11s} max|err| {err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"hop kernel disagrees with hop_reference: "
                                         f"{name} {dtype} {mode}")
    # an index outside the source rows reads NaN (jnp.take's fill mode)
    dst, src, tab, s = make_hop_inputs(99, 64, 64, 4, 64, torch.float32, True)
    tab[5, 2] = 64
    tab[9, 0] = -1
    got = hop_ops.hop(dst, src, tab, s)
    calls += 1
    torch.cuda.synchronize()
    bad = torch.isnan(got).all(dim=1)
    if not (bool(bad[5]) and bool(bad[9]) and int(bad.sum()) == 2):
        raise AssertionError("out-of-range source index did not give a NaN row")
    if hop_ops.launches != calls:
        raise AssertionError(f"launch counter {hop_ops.launches} != {calls} calls")
    log(f"[kernels] {calls} launches, all within limits "
        f"(f32: 1e-6*(1+|ref|), bf16: one ulp of ref); worst {worst}")
    return worst


# ---------------------------------------------------------------- phase 4
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


def hop_bound(n_dst, n_src, degree, feat, elem_bytes, same_block, ops_per_term):
    """Least time of one hop on an H100: inputs read once, the output written
    once (a same-block hop reads one state tensor), over 3.35 TB/s; the
    float32 operations over 67 TFLOP/s. -> (ms, bytes, ops, bound_by)."""
    state = n_dst * feat * elem_bytes + (0 if same_block else n_src * feat * elem_bytes)
    nbytes = (state + n_dst * degree * 4 + n_dst * degree * feat * elem_bytes
              + n_dst * feat * elem_bytes)
    ops = n_dst * degree * feat * ops_per_term + n_dst * (degree + 1) * feat  # + row sums
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, nbytes, ops, ("bytes" if t_bytes >= t_ops else "operations")


def time_hop_shapes() -> list:
    """Kernel, kernel with a cold L2, plain version and bound at the shapes
    the rollout gives the hop (bf16; processor hops in gradient mode, un-pool
    hops in no-gradient mode)."""
    flush = torch.empty(24 * 2 ** 20, dtype=torch.int32, device="cuda")   # 96 MB > L2
    shapes = [(n, n, True, True) for n in BENCH_ROWS]
    shapes += [(f, c, False, False) for f, c in zip(BENCH_ROWS[:-1], BENCH_ROWS[1:])]
    rows = []
    for seed, (n_dst, n_src, same, grad) in enumerate(shapes):
        args = make_hop_inputs(1000 + seed, n_dst, n_src, DEGREE, FEAT, torch.bfloat16, same)

        def kernel():
            hop_ops.hop(*args, with_gradient=grad)

        def plain():
            hop_ops.hop_reference(*args, with_gradient=grad)

        def kernel_after_flush():
            flush.zero_()
            kernel()

        ms = graph_time_ms(kernel, 200)
        cold_ms = graph_time_ms(kernel_after_flush, 100) - graph_time_ms(flush.zero_, 100)
        plain_ms = graph_time_ms(plain, 50)
        bound_ms, nbytes, ops, bound_by = hop_bound(n_dst, n_src, DEGREE, FEAT, 2, same,
                                                    4 if grad else 3)
        kind = "same-block" if same else "un-pool"
        rows.append({"shape": f"{kind} Nd={n_dst} Ns={n_src} D={DEGREE} F={FEAT} bf16",
                     "n_dst": n_dst, "same_block": same, "ms": ms, "cold_l2_ms": cold_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": ops})
        log(f"[timing] hop {rows[-1]['shape']}: kernel {ms * 1e3:.2f} us "
            f"(L2 flushed {cold_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.1f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {bound_by})")
    return rows


def phase_slice() -> dict:
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model, build_bench_sample
    from mswe_gnn_tpu_torch.models import count_params, prepare_graph, swegnn
    from mswe_gnn_tpu_torch.training.rollout import bc_window, inject_bc, rollout

    device = torch.device("cuda")
    t0 = time.perf_counter()
    sample, mesh = build_bench_sample()
    cfg, params, apply_fn = build_bench_model(sample, device=device)
    spec = sample.spec
    steps = sample.y.shape[-1]
    log(f"[slice] bench graph built on the host in {time.perf_counter() - t0:.1f} s: "
        f"nodes {list(spec.node_counts)} padded ({sum(m.num_faces for m in mesh.meshes)} raw), "
        f"edges {list(spec.edge_counts)}, table widths in/pool/unpool "
        f"{spec.in_degree}/{spec.pool_degree}/{spec.unpool_degree}; "
        f"MSGNN F={cfg.hid_features} K={cfg.K} mlp_layers={cfg.mlp_layers} "
        f"{cfg.compute_dtype}, {count_params(params)} parameters; {steps} steps")
    graph = sample.to(device)
    # hop launches a step: K of every processor, plus the K=1 un-pool hop of
    # every level: 5 x 5 + 2 x 1 = 27 for the bench model
    per_step = sum(cfg.k_schedule) + (cfg.num_scales - 1) * cfg.intra_cfg().K
    expected = per_step * steps

    torch.cuda.reset_peak_memory_stats()
    hop_ops.reset_launches()
    preds = rollout(apply_fn, params, cfg, graph, steps, device=device)
    torch.cuda.synchronize()
    launches = hop_ops.launches
    log(f"[slice] rollout launched the hop kernel {launches} times "
        f"({per_step} a step x {steps} steps = {expected} expected)")
    if launches != expected:
        raise AssertionError(f"hop launches {launches} != {expected}")
    if tuple(preds.shape) != (spec.num_nodes, 2, steps):
        raise AssertionError(f"rollout shape {tuple(preds.shape)}")
    if not bool(torch.isfinite(preds).all()) or bool((preds < 0).any()):
        raise AssertionError("rollout predictions are not finite and non-negative")
    padded = graph.node_mask == 0
    if bool(preds[padded].ne(0).any()):
        raise AssertionError("padded rows of the rollout are not zero")
    wet = float((preds[:, 0] > 0).float().mean())
    log(f"[slice] predictions [{', '.join(map(str, preds.shape))}] finite, >= 0, "
        f"padded rows 0; wet share {wet:.3f}, max {float(preds.max()):.4f}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the first step again, through the kernel and through the plain hop
    with torch.inference_mode():
        g = prepare_graph(params, cfg, graph)
        gt = g.replace(x_dynamic=inject_bc(g.x_dynamic, g, bc_window(g, 0)))
        p_kernel = apply_fn(params, cfg, gt)
        with mock.patch.object(swegnn, "hop", hop_ops.hop_reference):
            p_plain = apply_fn(params, cfg, gt)
    torch.cuda.synchronize()
    # limit: two bf16 ulps of the largest prediction; the kernel and the
    # plain hop agree to the bit on every hop, so any difference is a fault
    limit = 2 * 2.0 ** -8 * float(p_plain.abs().max())
    err = float((p_kernel - p_plain).abs().max())
    err_roll = float((p_kernel - preds[..., 0]).abs().max())
    log(f"[slice] step 0 kernel vs plain hop: max|err| {err:.3e} (limit {limit:.3e}); "
        f"vs the rollout's step 0: {err_roll:.3e}")
    if not (err <= limit and err_roll <= limit):
        raise AssertionError("step 0 through the kernel disagrees with the plain hop")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    event_ms, host_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        rollout(apply_fn, params, cfg, graph, steps, device=device)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    rollout_ms = statistics.median(event_ms)
    log(f"[slice] {steps}-step rollout: {rollout_ms:.1f} ms median of 3 "
        f"(CUDA events {', '.join(f'{t:.1f}' for t in event_ms)} ms; host clock "
        f"{', '.join(f'{t:.1f}' for t in host_ms)} ms)")

    shapes = time_hop_shapes()
    by_rows = {r["n_dst"]: r for r in shapes if r["same_block"]}
    unpool = [r for r in shapes if not r["same_block"]]
    # hop device time of one step from the per-shape kernel times: each
    # processor on scale s runs K hops, each level one un-pool hop
    scales = list(range(cfg.num_scales - 1)) + list(range(cfg.num_scales - 1, -1, -1))
    hop_step_ms = (sum(k * by_rows[spec.node_counts[s]]["ms"]
                       for k, s in zip(cfg.k_schedule, scales))
                   + sum(r["ms"] for r in unpool))
    log(f"[slice] hop kernel time in one step (from the shape timings): "
        f"{hop_step_ms * 1e3:.1f} us; in the rollout {hop_step_ms * steps:.2f} ms "
        f"= {100 * hop_step_ms * steps / rollout_ms:.1f}% of its {rollout_ms:.1f} ms")
    return {"launches": launches, "rollout_ms": rollout_ms, "shapes": shapes}


def main() -> None:
    smi = phase_device()
    phase_build()
    worst = phase_kernels()
    result = phase_slice()
    finest = result["shapes"][0]
    kernels = [{
        "name": "hop", "route": "cuda",
        "source": "mswe_gnn_tpu_torch/ops/csrc/hop.cu",
        "replaces": "mswe_gnn_tpu/ops/pallas_hop.py:54",
        "launches": result["launches"], "max_abs_err": max(worst.values()),
        "ms": finest["ms"], "plain_ms": finest["plain_ms"],
        "bound_ms": finest["bound_ms"], "bound_by": finest["bound_by"],
        "library_ms": None,       # no single PyTorch op computes the hop
        "shape": finest["shape"], "rollout_ms": result["rollout_ms"],
        "shapes": result["shapes"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
