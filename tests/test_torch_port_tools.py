"""The host side of the port's chip tooling, on the CPU: what ``chip_smoke.py``
and ``kernel_ab.py`` read from the compiler, the launches they expect of
each hop shape and how they read the counted ones, the bench tables they
time the kernels on, and the build paths of other versions of the kernel
sources. No kernel runs here.
"""
import re
import shutil
from collections import Counter

import pytest
import torch

import chip_smoke as cs
import kernel_ab
from mswe_gnn_tpu_torch.bench_problem import build_bench_model, build_bench_sample
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models import prepare_graph
from mswe_gnn_tpu_torch.ops import band_hop as band_ops
from mswe_gnn_tpu_torch.ops import build as kernel_build
from mswe_gnn_tpu_torch.ops import hop as hop_ops
from mswe_gnn_tpu_torch.ops.band_hop import attach_band_plan
import tests.torch_port_common  # noqa: F401  (PyTorch on one thread)

FWD = "_ZN4mswe14hop_fwd_kernelI13__nv_bfloat16Li8ELi1ENS_7EllAddrEEEvPKT_S5_T2_S5_PS3_iiiiiii"
BWD = "_ZN4mswe14hop_bwd_kernelIfLi4ELi2ENS_8BandAddrEEEvPKT_S4_T2_S4_S4_PKiS8_PS2_S9_S9_iiiiiiii"
PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 0 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '{BWD}' for 'sm_90a'
ptxas info    : Function properties for {BWD}
    96 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 60 registers, used 0 barriers, 480 bytes cmem[0]
"""


def test_build_check_rejects_a_backward_with_a_stack_frame():
    """The smoke's build check holds the backward instantiations, as the
    forward ones, to no stack frame and no spills, and to their count."""
    functions = cs.ptxas_functions(PTXAS_LOG)
    with pytest.raises(AssertionError, match=r"hop_bwd_kernel instantiations: 1 found.*"
                                             r"hop_bwd_kernel<f32, V=4, CPL=2, BandAddr>"):
        cs.check_instantiations(functions, expected=1)
    clean = cs.ptxas_functions(PTXAS_LOG.replace("96 bytes stack frame, 8 bytes spill stores, "
                                                 "4 bytes spill loads",
                                                 "0 bytes stack frame, 0 bytes spill stores, "
                                                 "0 bytes spill loads"))
    cs.check_instantiations(clean, expected=1)
    with pytest.raises(AssertionError, match="hop_bwd_kernel instantiations: 0 found"):
        cs.check_instantiations({k: v for k, v in clean.items() if "fwd" in k}, expected=1)
    with pytest.raises(AssertionError, match="hop_fwd_kernel instantiations: 1 found"):
        cs.check_instantiations(clean)                                # 24 of each expected


def test_skewed_problems_have_long_and_empty_reading_lists():
    """The skewed inputs of the smoke and the GPU tests give the backward's
    reading-slot batches a list of at least 40 slots (ten batches and more)
    and rows that no slot reads."""
    for same, n_src in ((True, 600), (False, 97)):
        dst, src, tab, s = cs.make_hop_inputs(5, 600, n_src, 4, 64, torch.float32, same,
                                              device="cpu", skew=True)
        ptr, _ = hop_ops.out_slot_table(tab, src.shape[0], cs.slot_mask_of(s))
        counts = ptr[1:] - ptr[:-1]
        assert int(counts.max()) >= 40 and int((counts == 0).sum()) >= n_src // 3
    plan, mask = cs.banded_problem(5, 1024, 4, 40, 64, skew=True)
    src = band_ops.band_sources(plan.idx_rel, plan.win, plan.ws, plan.we)
    ptr, _ = hop_ops.out_slot_table(src, len(src), mask)
    counts = ptr[1:] - ptr[:-1]
    assert int(counts.max()) >= 40 and int((counts == 0).sum()) >= 1024 // 3


def test_ptxas_functions_reads_every_kernel():
    got = cs.ptxas_functions(PTXAS_LOG)
    assert got == {
        "hop_fwd_kernel<bf16, V=8, CPL=1, EllAddr>":
            {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 118},
        "hop_bwd_kernel<f32, V=4, CPL=2, BandAddr>":
            {"stack": 96, "spill_stores": 8, "spill_loads": 4, "registers": 60}}


@pytest.fixture(scope="module")
def bench32():
    """The bench problem on a 32x32 grid, with the band plan on its two
    finer scales, and the bench model (F=64, K=5) on the CPU."""
    sample, _ = build_bench_sample(32, 32, 4)
    banded = attach_band_plan(sample, min_nodes=sample.spec.node_counts[1])
    cfg, params, _ = build_bench_model(sample, device="cpu")
    return sample, banded, cfg, params


def test_launch_counts_by_shape(bench32):
    sample, banded, cfg, _ = bench32
    spec = banded.spec
    planned = [i for i, m in enumerate(banded.band_meta) if m is not None]
    assert planned == [0, 1]
    serving = cs.hops_per_step(cfg, spec)
    assert sum(serving.values()) == 27 and {k[0] for k in serving} == {"hop"}
    n0, n1, n2 = spec.node_counts
    assert serving[("hop", n0, n0)] == serving[("hop", n1, n1)] == 10
    assert serving[("hop", n2, n2)] == 5
    assert serving[("hop", n0, n1)] == serving[("hop", n1, n2)] == 1
    train = cs.hops_per_step(cfg, spec, banded.band_meta)
    assert train[("band_hop", n0, n0)] == train[("band_hop", n1, n1)] == 10
    step = cs.train_launches(cfg, spec, banded.band_meta, 6, True)
    assert cs.by_kernel(step) == {"band_hop": 240, "band_hop_bwd": 120, "hop": 84, "hop_bwd": 42}
    assert step[("hop", n2, n2)] == 60 and step[("hop_bwd", n2, n2)] == 30
    assert step[("band_hop", n0, n0)] == 120 and step[("hop_bwd", n0, n1)] == 6
    rollout = cs.rollout_launches(cfg, spec, 47)
    assert cs.by_kernel(rollout) == {"hop": 27 * 47, "hop_bwd": 0, "band_hop": 0,
                                     "band_hop_bwd": 0}
    assert rollout[("hop", n2, n2)] == 235 and rollout[("hop", n0, n1)] == 47


def test_gnn_launch_counts_by_shape():
    """The single-scale SWE-GNN (pareto_gnn's model: 2 layers of K=10) runs
    n_gnn_layers x K hops a step over its one block of rows and no un-pool
    hop: 940 ELL launches a 47-step rollout, 240 band forwards and 120 band
    backwards a 6-step train step with remat where the scale has a band
    plan; a baseline runs none."""
    from mswe_gnn_tpu_torch.bench_problem import build_pareto_gnn_model

    sample, _ = build_bench_sample(16, 16, 4, num_scales=1)
    banded = attach_band_plan(sample, min_nodes=128)
    n = sample.spec.num_nodes
    cfg, _, _ = build_pareto_gnn_model(sample, device="cpu")
    assert cs.processor_layers(cfg) == [(10, 0), (10, 0)]
    assert cs.hops_per_step(cfg, sample.spec) == Counter({("hop", n, n): 20})
    assert cs.hops_per_step(cfg, banded.spec, banded.band_meta) == Counter(
        {("band_hop", n, n): 20})
    assert cs.rollout_launches(cfg, sample.spec, 47) == Counter({("hop", n, n): 940})
    step = cs.train_launches(cfg, banded.spec, banded.band_meta, 6, True)
    assert cs.by_kernel(step) == {"band_hop": 240, "band_hop_bwd": 120, "hop": 0, "hop_bwd": 0}
    union = cs.train_launches(cfg, sample.spec.tile(8), None, 3, False)
    assert union == Counter({("hop", 8 * n, 8 * n): 60, ("hop_bwd", 8 * n, 8 * n): 60})
    gat, _, _ = build_pareto_gnn_model(sample, device="cpu", type_GNN="GAT")
    assert cs.processor_layers(gat) == [] and cs.hops_per_step(gat, sample.spec) == Counter()


def test_read_launches_holds_shapes_against_totals(monkeypatch):
    """The smoke reads the wrappers' counts by shape, checks that they sum to
    the totals by kernel, and fails on any count the config does not give."""
    cs.reset_all_launches()
    monkeypatch.setattr(hop_ops, "launches", 3)
    monkeypatch.setattr(hop_ops, "bwd_launches", 1)
    hop_ops.launches_by_shape.update({("hop", 8, 8): 2, ("hop", 8, 4): 1, ("hop_bwd", 8, 4): 1})
    try:
        counts = cs.read_launches()
        assert counts == {("hop", 8, 8): 2, ("hop", 8, 4): 1, ("hop_bwd", 8, 4): 1}
        cs.hold_launches("test", "a pass", counts, counts.copy())
        with pytest.raises(AssertionError, match="expected"):
            cs.hold_launches("test", "a pass", counts, counts + Counter({("hop", 8, 8): 1}))
        monkeypatch.setattr(hop_ops, "launches", 4)
        with pytest.raises(AssertionError, match="do not sum"):
            cs.read_launches()
    finally:
        cs.reset_all_launches()


def test_bench_hop_cases_are_the_rollout_tables(bench32):
    sample, _, cfg, params = bench32
    spec = sample.spec
    with torch.no_grad():
        cache = prepare_graph(params, cfg, sample).ell_cache
    cases = cs.bench_hop_cases(cache, spec, device="cpu")
    assert [(same, grad) for _, _, grad, same in cases] == [(True, True)] * 3 + [(False, False)] * 2
    tables = [c[2] for c in cache["scales"]] + [u[2] for u in cache["unpools"]]
    masks = [c[1] for c in cache["scales"]] + [u[1] for u in cache["unpools"]]
    for (name, (dst, src, tab, s), grad, same), want, mask in zip(cases, tables, masks):
        assert torch.equal(tab, want) and tab.dtype == torch.int32
        assert (dst is src) == same and dst.dtype == s.dtype == torch.bfloat16
        assert s.shape == (*tab.shape, cs.FEAT)
        assert torch.equal(cs.slot_mask_of(s), mask > 0)       # masked slots carry no flux
        assert f"Nd={dst.shape[0]} Ns={src.shape[0]}" in name
        out = hop_ops.hop(dst, src, tab, s, with_gradient=grad)
        assert out.shape == dst.shape and bool(torch.isfinite(out).all())


def test_library_path_tracks_sources_and_flags(tmp_path, monkeypatch):
    other = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC_DIR, other)
    base = kernel_build.library_path("hop")
    assert kernel_build.library_path("hop", other) == base        # same bytes, same flags
    with monkeypatch.context() as m:
        m.setattr(kernel_build, "NVCC_FLAGS", (*kernel_build.NVCC_FLAGS, "-lineinfo"))
        assert kernel_build.library_path("hop", other) != base
    (other / "hop_common.cuh").write_text("// another header\n")
    assert kernel_build.library_path("hop", other) != base
    with pytest.raises(ValueError, match="unknown kernel library"):
        kernel_build.source("nope")


def test_kernel_ab_parses_versions():
    assert kernel_ab.parse_pair("parent=../csrc") == ("parent", "../csrc")
    assert kernel_ab.parse_pair("pr2=_ab/a=b") == ("pr2", "_ab/a=b")
    for bad in ("../csrc", "=../csrc", "parent="):
        with pytest.raises(SystemExit, match="NAME=DIR"):
            kernel_ab.parse_pair(bad)


def test_build_keeps_the_compiler_log_for_a_later_call(tmp_path, monkeypatch):
    """A library built earlier in the process (or by another script) still
    reports its ptxas lines, which chip_smoke's build check reads."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo 'ptxas info    : Used 7 registers'\n: > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: str(nvcc))
    first = kernel_build.build("hop")["hop"]
    again = kernel_build.build("hop")["hop"]
    assert "Used 7 registers" in first["log"] and again["log"] == first["log"]
    assert again["path"] == first["path"] and again["seconds"] == 0.0


def test_cli_shapes_are_held_where_launched(bench32):
    """Phase 10 holds the kernels at every shape a CLI run launched: each
    union size whose finest-scale hop ran is rebuilt and checked at its
    launched shapes (the backward only where it ran), and a launched shape
    that no union gives fails the phase."""
    sample, _, cfg, params = bench32
    n = sample.spec.node_counts
    counts = Counter()
    for b, backward in ((1, False), (2, True)):
        for (kernel, nd, ns), k in cs.hops_per_step(cfg, sample.spec.tile(b)).items():
            counts[kernel, nd, ns] += k
            if backward:
                counts["hop_bwd", nd, ns] += k
    checks = cs.Checks()
    sizes = cs.hold_path_shapes(checks, "test", cfg, params, [sample, sample], counts, 8,
                                device="cpu")
    assert sorted(sizes) == [1, 2]         # not 4: its finest hop never ran
    for b in (1, 2):
        m = [b * c for c in n]
        assert [(nd, ns) for nd, ns, _ in sizes[b]] == [
            (m[0], m[0]), (m[1], m[1]), (m[2], m[2]), (m[0], m[1]), (m[1], m[2])]
        # a shape of both unions (a coarse scale of 2 is a finer one of 1)
        # is held with its backward on each
        assert [bwd for nd, ns, bwd in sizes[b]] == [
            ("hop_bwd", nd, ns) in counts for nd, ns, _ in sizes[b]]
    n_bwd = sum(bwd for b in sizes for _, _, bwd in sizes[b])
    assert all(bwd for _, _, bwd in sizes[2]) and n_bwd > 5
    assert checks.count > 3 * (10 + n_bwd)          # 3 modes, every output held
    assert checks.worst == {("hop", "float32"): 0.0, ("hop_bwd", "float32"): 0.0}
    odd = ("hop", n[0] + 1, n[0] + 1)              # a shape no union gives
    with pytest.raises(AssertionError, match=re.escape(f"held nowhere: [{odd}]")):
        cs.hold_path_shapes(cs.Checks(), "test", cfg, params, [sample, sample],
                            counts + Counter({odd: 1}), 8, device="cpu")


def test_union_launch_counts_and_graph_rows(bench32):
    """The batched phases' expectations: a union of 4 (no band plan) trains
    on 324 ELL forwards and 162 ELL backwards at the tiled shapes, and
    ``graph_rows`` picks every graph's rows of the union in its own order."""
    sample, banded, cfg, _ = bench32
    union = concat_graphs([banded] * 4)
    assert union.band_meta is None and union.spec == sample.spec.tile(4)
    step = cs.train_launches(cfg, union.spec, union.band_meta, 6, True)
    assert cs.by_kernel(step) == {"hop": 324, "hop_bwd": 162, "band_hop": 0, "band_hop_bwd": 0}
    n0 = union.spec.node_counts[0]
    assert step[("hop", n0, n0)] == 120 and step[("hop_bwd", n0, n0)] == 60
    n2 = 20 * sample.spec.node_counts[2]
    assert cs.rollout_launches(cfg, sample.spec.tile(20), 47)[("hop", n2, n2)] == 235
    for g in range(4):
        rows = cs.graph_rows(sample.spec, 4, g, "cpu")
        assert torch.equal(union.x_static[rows], sample.x_static)
        assert torch.equal(union.node_mask[rows], sample.node_mask)


@pytest.mark.parametrize("kw", [{}, {"overlap": True}, {"halo_width": 2}],
                         ids=["per_hop", "overlap", "wide"])
def test_ring_launch_counts_are_the_ring_layers(bench32, monkeypatch, kw):
    """Phase 13's launch expectation (``ring_hops_per_step``) is what one ring
    step of the bench model calls the hop with, by ``(Nd, Ns)``, on the
    32x32 bench graph in 2 parts; every called shape has a plan table
    (``ring_tables``), whose same-block flag says whether the call hopped
    a block against itself."""
    from mswe_gnn_tpu_torch.parallel import dist_swegnn
    from mswe_gnn_tpu_torch.parallel.dist_train import make_dist_apply_fn

    sample, _, cfg, params = bench32
    graph, _ = dist_swegnn.reorder_graph_for_ring(sample, 2)
    devices = ["cpu"] * 2
    plans = dist_swegnn.place_dist_inputs(
        dist_swegnn.build_dist_msgnn_inputs(graph, 2, **kw), [torch.device("cpu")] * 2)
    calls, same = Counter(), set()
    real = dist_swegnn.hop

    def counting(dst, src, tab, s, **k):
        calls["hop", dst.shape[0], src.shape[0]] += 1
        if src is dst:
            same.add((dst.shape[0], src.shape[0]))
        return real(dst, src, tab, s, **k)

    monkeypatch.setattr(dist_swegnn, "hop", counting)
    with torch.no_grad():
        make_dist_apply_fn(devices, cfg, graph, **kw)(params, cfg, cs.first_step(graph))
    assert calls == cs.ring_hops_per_step(cfg, plans)
    tables = cs.ring_tables(plans)
    for _, nd, ns in calls:
        assert all(flag == ((nd, ns) in same) for _, _, flag in tables[nd, ns])
    assert bool(same) == ("overlap" in kw)
