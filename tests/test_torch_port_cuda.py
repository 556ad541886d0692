"""The port on an NVIDIA GPU: every kernel (the ELL hop, the banded hop and
their backwards) against its plain version, and the model, the rollout and
a train step on the card against the port on the CPU.

Marked ``gpu``; each test skips without CUDA (decided inside the fixture).
Run on a machine with one NVIDIA GPU, from the repository root:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: the kernels add the same float32 terms in the same order as
their plain versions and round once, so they agree to the bit (NaN where
the plain version has NaN). Forward and backward are held so at every
slot count of their batches (D = 1..16, tails that are not a multiple of
the batch), in the vector (F = 64) and scalar (F = 20) layouts, on grids
smaller than the SM count; the forward with out-of-range indices, the
backward also on skewed out-slot tables (a source row read by 40 slots and
more, many read by none: reading-slot batches and their tails). The model on the card against the
CPU: rtol 1e-5, atol 1e-4 in float32 —
cuBLAS sums the matmuls in another order. A train step (loss and
gradients) on the card against the CPU: the loss within rtol 1e-5, every
gradient leaf within 1e-4 * max|leaf| + 1e-6. Concat unions: the ELL kernels
bit-equal on a union of 4's own tables, ``DeviceConcatPlan`` on the card
equal to the host ``concat_graphs``, and each graph of a union's rollout on
the card against that graph's rollout on the CPU (the model's limits).
"""
import dataclasses

import pytest
import torch

import chip_smoke as cs
from chip_smoke import band_inputs, banded_problem, make_hop_inputs, slot_mask_of, upstream
from mswe_gnn_tpu_torch import tree_leaves, tree_to
from mswe_gnn_tpu_torch.bench_problem import build_bench_sample
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
from mswe_gnn_tpu_torch.graph import DeviceConcatPlan, concat_graphs, stack_graphs
from mswe_gnn_tpu_torch.models import build_model, prepare_graph
from mswe_gnn_tpu_torch.ops import band_hop as band_ops
from mswe_gnn_tpu_torch.ops import hop as hop_ops
from mswe_gnn_tpu_torch.training import train as port_train
from mswe_gnn_tpu_torch.training.rollout import rollout

pytestmark = pytest.mark.gpu

MODES = [(True, False), (True, True), (False, False)]
DEGREES = [1, 2, 3, 4, 5, 7, 8, 16]      # slot batches of 4 (F=64) and their tails


def assert_bit_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan]), float((got.float() - want.float()).abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("n_dst,n_src,feat,same_block", [
    (1000, 1000, 64, True), (517, 130, 64, False), (333, 333, 20, True),
    (100, 100, 64, True), (200, 37, 20, False)])      # the last two: fewer blocks than SMs
def test_kernel_matches_plain_version(cuda, dtype, with_gradient, upwind, degree,
                                      n_dst, n_src, feat, same_block):
    args = make_hop_inputs(degree, n_dst, n_src, degree, feat, dtype, same_block, cuda)
    key = ("hop", n_dst, args[1].shape[0])
    before = hop_ops.launches, hop_ops.launches_by_shape[key]
    got = hop_ops.hop(*args, with_gradient=with_gradient, upwind=upwind)
    assert (hop_ops.launches, hop_ops.launches_by_shape[key]) == (before[0] + 1, before[1] + 1)
    want = hop_ops.hop_reference(*args, with_gradient=with_gradient, upwind=upwind)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("degree", [1, 4, 5, 16])
@pytest.mark.parametrize("feat", [64, 20])
def test_out_of_range_index_reads_a_nan_row(cuda, dtype, with_gradient, upwind, degree, feat):
    """A slot outside the source reads NaN (jnp.take's fill): its row of the
    output is NaN, every other row is the plain version's."""
    dst, src, tab, s = make_hop_inputs(11, 300, 120, degree, feat, dtype, False, cuda)
    bad = torch.tensor([3, 77, 250], device=cuda)
    tab[bad, degree - 1] = torch.tensor([120, -1, 5000], dtype=torch.int32, device=cuda)
    got = hop_ops.hop(dst, src, tab, s, with_gradient=with_gradient, upwind=upwind)
    want = hop_ops.hop_reference(dst, src, tab.clamp(0, 119), s, with_gradient=with_gradient,
                                 upwind=upwind)
    rows = torch.zeros(300, dtype=torch.bool, device=cuda)
    rows[bad] = True
    assert bool(torch.isnan(got[rows]).all())
    assert_bit_equal(got[~rows], want[~rows])


@pytest.fixture
def small_problem():
    records = generate_dataset(1, seed=0, nx=16, ny=16, num_scales=3, total_hours=12,
                               substeps=8)
    rec = records[0]
    scalers = port_dataset.fit_dataset_scalers(records, {"area_scaler": "standard"})
    spec = port_dataset.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), 8)
    g = port_dataset.to_temporal_samples(port_dataset.process_record(rec, scalers), spec,
                                         previous_t=2, rollout_steps=3)[1]
    cfg, params, apply_fn = build_model(
        {"hid_features": 32, "K": 3, "mlp_layers": 3, "learned_residuals": True,
         "with_WL": True}, num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=2,
        device="cpu")
    return g, cfg, params, apply_fn


def test_rollout_on_the_card_matches_the_cpu(cuda, small_problem):
    g, cfg, params, apply_fn = small_problem
    want = rollout(apply_fn, params, cfg, g, steps=3, device="cpu")
    hop_ops.reset_launches()
    got = rollout(apply_fn, tree_to(params, cuda), cfg, g, steps=3)   # default device
    assert got.device.type == "cuda"
    assert hop_ops.launches == 3 * (sum(cfg.k_schedule) + cfg.num_scales - 1)
    assert cs.read_launches() == cs.rollout_launches(cfg, g.spec, 3)      # by shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def check_backward(args, with_gradient, upwind, masked_table=True):
    """The ELL backward kernel against its plain version, bit for bit, with
    one launch counted."""
    table = hop_ops.out_slot_table(args[2], args[1].shape[0],
                                   slot_mask_of(args[3]) if masked_table else None)
    g = upstream(2, args[0])
    before = hop_ops.bwd_launches
    got = hop_ops.hop_backward(*args, g, *table, with_gradient, upwind)
    assert hop_ops.bwd_launches == before + 1
    want = hop_ops.hop_backward_reference(*args, g, *table, with_gradient, upwind)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert_bit_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("n_dst,n_src,feat,same_block", [
    (1000, 1000, 64, True), (517, 130, 64, False), (333, 333, 20, True),
    (100, 100, 64, True), (200, 37, 20, False)])      # the last two: fewer blocks than SMs
def test_backward_kernel_matches_plain_version(cuda, dtype, with_gradient, upwind, degree,
                                               n_dst, n_src, feat, same_block):
    args = make_hop_inputs(degree, n_dst, n_src, degree, feat, dtype, same_block, cuda)
    check_backward(args, with_gradient, upwind, masked_table=degree % 2 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("feat", [64, 20])
@pytest.mark.parametrize("n_dst,n_src,same_block", [(600, 600, True), (600, 97, False),
                                                    (700, 1500, False)])
def test_backward_kernel_on_a_skewed_out_slot_table(cuda, dtype, with_gradient, upwind, feat,
                                                    n_dst, n_src, same_block):
    """Source row 1 is read by 60 slots and more (15 reading batches and a
    tail), half the source rows by none; the last shape has more source
    rows than destination rows, which only read."""
    args = make_hop_inputs(3, n_dst, n_src, 4, feat, dtype, same_block, cuda, skew=True)
    check_backward(args, with_gradient, upwind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("tail", [0, 40])
@pytest.mark.parametrize("degree,feat", [(4, 64), (3, 20), (7, 64), (16, 64), (16, 20)])
def test_band_kernels_match_plain_versions(cuda, dtype, with_gradient, upwind, tail, degree,
                                           feat):
    # with a tail, 2048 rows: a window over the whole block would pass max_w,
    # so the planner has to take the ghost tail at every degree
    plan, mask = banded_problem(3, 2048 if tail else 1024, degree, 6 if tail else 40, feat,
                                tail)
    state, s, idx_rel, win = band_inputs(4, plan, mask, feat, dtype)
    kw = dict(ws=plan.ws, we=plan.we, with_gradient=with_gradient, upwind=upwind)
    before = (band_ops.launches, band_ops.bwd_launches)
    assert_bit_equal(band_ops.band_hop(state, s, idx_rel, win, **kw),
                     band_ops.band_hop_reference(state, s, idx_rel, win, **kw))
    src = band_ops.band_sources(idx_rel, win, plan.ws, plan.we)
    table = hop_ops.out_slot_table(src, len(src), mask.to(cuda))
    g = upstream(5, state)
    got = band_ops.band_hop_backward(state, s, idx_rel, win, g, *table, **kw)
    want = band_ops.band_hop_backward_reference(state, s, idx_rel, win, g, *table, **kw)
    assert (band_ops.launches, band_ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        assert_bit_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("degree,feat", [(4, 64), (3, 20), (16, 64)])
def test_band_backward_on_a_skewed_out_slot_table(cuda, dtype, with_gradient, upwind, degree,
                                                  feat):
    """Slots read even rows only, and slot 0 of 80 rows reads the middle row."""
    plan, mask = banded_problem(6, 1024, degree, 40, feat, skew=True)
    state, s, idx_rel, win = band_inputs(7, plan, mask, feat, dtype)
    kw = dict(ws=plan.ws, we=plan.we, with_gradient=with_gradient, upwind=upwind)
    src = band_ops.band_sources(idx_rel, win, plan.ws, plan.we)
    table = hop_ops.out_slot_table(src, len(src), mask.to(cuda))
    g = upstream(8, state)
    before = band_ops.bwd_launches
    got = band_ops.band_hop_backward(state, s, idx_rel, win, g, *table, **kw)
    want = band_ops.band_hop_backward_reference(state, s, idx_rel, win, g, *table, **kw)
    assert band_ops.bwd_launches == before + 1
    for a, b in zip(got, want):
        assert_bit_equal(a, b)


def test_hop_on_the_card_carries_its_gradient(cuda):
    dst, src, tab, s = make_hop_inputs(7, 300, 300, 4, 64, torch.float32, True, cuda)
    dst.requires_grad_(True)
    s.requires_grad_(True)
    out = hop_ops.hop(dst, dst, tab, s)
    assert out.grad_fn is not None
    before = hop_ops.bwd_launches
    g_dst, g_s = torch.autograd.grad(out.square().sum(), (dst, s))
    assert hop_ops.bwd_launches == before + 1
    ref = hop_ops.hop_reference(dst, dst, tab, s)
    w_dst, w_s = torch.autograd.grad(ref.square().sum(), (dst, s))
    torch.testing.assert_close(g_dst, w_dst, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_s, w_s, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():       # the rollout: no graph, one forward launch
        before = hop_ops.launches
        assert hop_ops.hop(dst, dst, tab, s).grad_fn is None
        assert hop_ops.launches == before + 1


def test_train_step_on_the_card_matches_the_cpu(cuda):
    sample, _ = build_bench_sample(16, 16, 4, band=False)
    graph = band_ops.attach_band_plan(sample, min_nodes=128)
    cfg, params, apply_fn = build_model(
        {"hid_features": 16, "K": 2, "learned_residuals": True, "with_WL": True},
        num_node_features=graph.x_static.shape[1] + graph.x_dynamic.shape[1],
        num_edge_features=graph.edge_attr.shape[1], num_scales=3, previous_t=3,
        device="cpu")
    opts = port_train.TrainerOptions(batch_size=1, velocity_scaler=7.0, remat=True)
    want_loss, want = port_train.loss_and_grads(apply_fn, params, cfg, graph, 2, opts, True)
    hop_ops.reset_launches()
    band_ops.reset_launches()
    loss, grads = port_train.loss_and_grads(apply_fn, tree_to(params, cuda), cfg,
                                            graph.to(cuda), 2, opts, True)
    assert band_ops.launches == 2 * band_ops.bwd_launches > 0     # remat: forward twice
    assert hop_ops.launches == 2 * hop_ops.bwd_launches > 0
    assert cs.read_launches() == cs.train_launches(cfg, graph.spec, graph.band_meta, 2, True)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-6)


# ---------------------------------------------------------------- concat unions

@pytest.fixture(scope="module")
def union_tables():
    """The hop tables of a concat union of 4 copies of the small bench
    graph (16x16, 3 scales): ``[(name, src_tab [Nd, D] int32, slot mask,
    Ns, same_block)]`` for every processor scale and un-pool level."""
    sample, _ = build_bench_sample(16, 16, 4)
    union = concat_graphs([sample] * 4)
    cfg, params, _ = build_model(
        {"hid_features": 8, "K": 1}, num_node_features=union.x_static.shape[1]
        + union.x_dynamic.shape[1], num_edge_features=union.edge_attr.shape[1], num_scales=3,
        previous_t=3, device="cpu")
    with torch.no_grad():
        cache = prepare_graph(params, cfg, union).ell_cache
    n = union.spec.node_counts
    out = [(f"scale {i} Nd={n[i]}", srcs, mask, n[i], True)
           for i, (_, mask, srcs, _, _) in enumerate(cache["scales"])]
    out += [(f"un-pool Nd={n[lvl]} Ns={n[lvl + 1]}", usrc, umask, n[lvl + 1], False)
            for lvl, (_, umask, usrc, _) in enumerate(cache["unpools"])]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("case", range(5))
def test_kernels_on_a_union_s_own_tables(cuda, union_tables, dtype, with_gradient, upwind,
                                         case):
    """The ELL forward and backward bit-equal to their plain versions on the
    tables of a union of 4 (F=64), at every slot count up to the tables'
    width."""
    _, srcs, mask, n_src, same = union_tables[case]
    g = torch.Generator().manual_seed(case)
    n_dst, width = srcs.shape
    dst = torch.randn(n_dst, 64, generator=g)
    dst[torch.rand(n_dst, generator=g) < 0.3] = 0.0
    src = None
    if not same:
        src = torch.randn(n_src, 64, generator=g)
        src[torch.rand(n_src, generator=g) < 0.3] = 0.0
    flux = torch.randn(n_dst, width, 64, generator=g) * mask[..., None]
    dst = dst.to(cuda, dtype)
    src = dst if same else src.to(cuda, dtype)
    for degree in range(1, width + 1):
        tab = srcs[:, :degree].contiguous().to(cuda)
        s = flux[:, :degree].contiguous().to(cuda, dtype)
        args = (dst, src, tab, s)
        got = hop_ops.hop(*args, with_gradient=with_gradient, upwind=upwind)
        assert_bit_equal(got, hop_ops.hop_reference(*args, with_gradient=with_gradient,
                                                    upwind=upwind))
        check_backward(args, with_gradient, upwind)


def test_device_concat_plan_on_the_card(cuda):
    records = generate_dataset(1, seed=0, nx=16, ny=16, num_scales=3, total_hours=12,
                               substeps=8)
    rec = records[0]
    scalers = port_dataset.fit_dataset_scalers(records, {"area_scaler": "standard"})
    spec = port_dataset.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), 8)
    graphs = port_dataset.to_temporal_samples(port_dataset.process_record(rec, scalers), spec,
                                              previous_t=2, rollout_steps=2)[:5]
    stacked = stack_graphs([g.to(cuda) for g in graphs])
    plan = DeviceConcatPlan(spec, 3)
    for idx in ([0, 1, 2], [4, 4, 1]):
        got = plan(stacked, idx)
        want = concat_graphs([graphs[i] for i in idx]).to(cuda)
        assert got.num_graphs == want.num_graphs == 3 and got.spec == want.spec
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if isinstance(w, torch.Tensor):
                a = getattr(got, f.name)
                assert a.device.type == "cuda" and a.dtype == w.dtype and torch.equal(a, w), \
                    f.name


def test_union_rollout_on_the_card(cuda, small_problem):
    g, cfg, params, apply_fn = small_problem
    union = concat_graphs([g] * 4)
    cs.reset_all_launches()
    got = rollout(apply_fn, tree_to(params, cuda), cfg, union, steps=3)
    assert got.shape == (union.num_nodes, 2, 3) and got.device.type == "cuda"
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())
    assert cs.read_launches() == cs.rollout_launches(cfg, g.spec.tile(4), 3)
    want = rollout(apply_fn, params, cfg, g, steps=3, device="cpu")
    for i in range(4):
        rows = cs.graph_rows(g.spec, 4, i, "cpu")
        torch.testing.assert_close(got.cpu()[rows], want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- the single-scale GNN

@pytest.fixture
def single_scale():
    """A 16x16 single-scale sample (previous_t 2)."""
    records = generate_dataset(1, seed=0, nx=16, ny=16, num_scales=1, total_hours=12,
                               substeps=8)
    rec = records[0]
    scalers = port_dataset.fit_dataset_scalers(records, {"area_scaler": "standard"})
    spec = port_dataset.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), 8)
    return port_dataset.to_temporal_samples(port_dataset.process_record(rec, scalers), spec,
                                            previous_t=2, rollout_steps=3)[1]


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_ops_on_the_card(cuda, op):
    """The segment reductions on the card against the CPU: exact for max,
    1e-6 for the sums (``index_add`` on CUDA adds with atomics)."""
    from mswe_gnn_tpu_torch.ops import segment

    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 300, (4000,), generator=g)
    ids[ids == 7] = 8                                     # an empty segment
    data = torch.randn(4000, 64, generator=g)
    weights = (torch.rand(4000, generator=g) < 0.8).float()
    fn = {"sum": lambda d, i, w: segment.segment_sum(d, i, 300),
          "mean": lambda d, i, w: segment.segment_mean(d, i, 300, weights=w),
          "max": lambda d, i, w: segment.segment_max(d, i, 300)}[op]
    got = fn(data.to(cuda), ids.to(cuda), weights.to(cuda)).cpu()
    want = fn(data, ids, weights)
    assert torch.all(got[7] == 0)
    torch.testing.assert_close(got, want, rtol=0 if op == "max" else 1e-6,
                               atol=0 if op == "max" else 1e-6)


@pytest.mark.parametrize("type_gnn", ["SWEGNN", "GNN_L", "GNN_A", "GAT"])
def test_gnn_rollout_on_the_card_matches_the_cpu(cuda, single_scale, type_gnn):
    """A 3-step rollout of the single-scale GNN of each type on the card
    against the CPU (the model's limits); the SWE-GNN's hops go through the
    ELL kernel (n_gnn_layers x K a step), the convs launch none."""
    g = single_scale
    cfg, params, apply_fn = build_model(
        {"model_type": "GNN", "type_GNN": type_gnn, "hid_features": 64, "K": 3,
         "n_GNN_layers": 2, "mlp_layers": 3, "learned_residuals": True, "with_WL": True,
         "gnn_activation": "tanh"},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=1, previous_t=2, device="cpu")
    want = rollout(apply_fn, params, cfg, g, steps=3, device="cpu")
    cs.reset_all_launches()
    got = rollout(apply_fn, tree_to(params, cuda), cfg, g, steps=3)
    assert got.device.type == "cuda"
    assert cs.read_launches() == cs.rollout_launches(cfg, g.spec, 3)
    assert (sum(cs.read_launches().values()) == 18) == (type_gnn == "SWEGNN")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def test_learned_pooling_on_the_card_matches_the_cpu(cuda, small_problem):
    """MSGNN with learned pooling: a 3-step rollout on the card against the
    CPU (the model's limits), and a train step's loss and gradients with
    the pooling MLP's gradient non-zero."""
    g, _, _, _ = small_problem
    cfg, params, apply_fn = build_model(
        {"hid_features": 32, "K": 3, "mlp_layers": 3, "learned_residuals": True,
         "with_WL": True, "learned_pooling": True},
        num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=2, device="cpu")
    want = rollout(apply_fn, params, cfg, g, steps=3, device="cpu")
    got = rollout(apply_fn, tree_to(params, cuda), cfg, g, steps=3)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    opts = port_train.TrainerOptions(batch_size=1, velocity_scaler=7.0)
    loss_c, grads_c = port_train.loss_and_grads(apply_fn, params, cfg, g, 2, opts, True)
    loss_g, grads_g = port_train.loss_and_grads(apply_fn, tree_to(params, cuda), cfg,
                                                g.to(cuda), 2, opts, True)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-6)
    assert all(bool(leaf.ne(0).any()) for leaf in tree_leaves(grads_c["pooling_mlp"]["layers"]))


def test_forced_rollout_step_0_through_the_kernel(cuda):
    """The bench MSGNN (bf16) on a storm-forced bench graph at a 24x24 grid:
    step 0 with the forcing columns appended, through the ELL kernel and
    through the plain hop (chip_smoke phase 12's limit: two bf16 ulps of the
    largest prediction), its launches by shape those of ``hops_per_step``;
    the forcing reaches the prediction."""
    from mswe_gnn_tpu_torch.bench_problem import build_bench_model

    sample, _ = build_bench_sample(24, 24, 6, storm=True)
    assert sample.forcing.shape[1] == 3
    cfg, params, apply_fn = build_bench_model(sample, device=cuda)
    with torch.inference_mode():
        gt = cs.first_step(prepare_graph(params, cfg, sample.to(cuda)))
        assert gt.x_static.shape[1] == sample.x_static.shape[1] + 3
        cs.reset_all_launches()
        got = apply_fn(params, cfg, gt)
        torch.cuda.synchronize()
        assert cs.read_launches() == cs.hops_per_step(cfg, sample.spec)
        with cs.plain_hops():
            want = apply_fn(params, cfg, gt)
        calm = apply_fn(params, cfg, gt.replace(x_static=torch.cat(
            [gt.x_static[:, :-3], torch.zeros_like(gt.x_static[:, -3:])], dim=1)))
    limit = 2 * 2.0 ** -8 * float(want.abs().max())
    assert float((got - want).abs().max()) <= limit
    assert float((calm - got).abs().max()) > 0


# ------------------------------------------------------------ the bf16 GEMM

def widened_chain(x, w):
    """``models/mlp.py::matmul``'s bf16 branch as it was before its CUDA path."""
    return torch.matmul(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())


@pytest.mark.parametrize("lead,k,n", [((100_000,), 64, 128), ((100_000,), 128, 128),
                                      ((12_500, 8), 128, 64)])
def test_bf16_matmul_on_tensor_cores_sums_in_float32(cuda, lead, k, n):
    """``matmul(x, w, 'bfloat16')`` at the slot tables' shapes: a float32
    result within float32 summation error of the float64 product of the
    same bf16-rounded operands (K * 2^-23 * |xb| @ |wb| elementwise: every
    partial sum rounded once, toward zero at worst). A bf16 result
    (``torch.mm`` of the bf16 operands) breaks that bound: it is the control
    that shows the bound catches a product summed or returned below float32.
    A TF32 product of the unrounded operands breaks it too, but only because
    its operands are not the bf16-rounded ones (TF32 of the rounded operands
    would not: bf16 fits in TF32's mantissa), so that case checks the
    operands' rounding, not how the GEMM sums. The gradients equal the
    widened chain's to the bit under one upstream gradient, and the call
    counts as a CUDA call."""
    from mswe_gnn_tpu_torch.models import mlp

    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(*lead, k, generator=gen, device=cuda)
    w = torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5
    dy = torch.randn(*lead, n, generator=gen, device=cuda)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)

    mlp.reset_matmul_calls()
    y = mlp.matmul(x, w, "bfloat16")
    assert mlp.matmul_calls == {("cuda", k, n): 1}
    assert y.dtype == torch.float32 and y.shape == (*lead, n)
    exact = xb.double() @ wb.double()
    bound = k * 2.0 ** -23 * (xb.double().abs() @ wb.double().abs())

    def worst(got):
        return float(((got.double() - exact).abs() / bound).max())

    assert worst(y) <= 1.0
    assert worst(torch.matmul(xb, wb)) > 1.0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert worst(x @ w) > 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    grads = []
    for fn in (widened_chain, lambda a, b: mlp.matmul(a, b, "bfloat16")):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xg, wg).backward(dy)
        grads.append((xg.grad, wg.grad))
    for want, got in zip(*grads):
        assert_bit_equal(got, want)
