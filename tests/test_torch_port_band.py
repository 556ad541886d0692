"""The port's banded hop (mswe_gnn_tpu_torch/ops/band_hop.py) and the hop
backward (ops/hop.py) against the JAX package, on the CPU.

- The planners give the JAX package's plans bit for bit.
- The banded forward against JAX ``band_hop`` (its Pallas kernel in
  interpret mode): float32 within atol 1e-6 (both add the same float32
  products slot by slot); bfloat16 within atol 2e-2 on outputs of order 1
  (unit-norm flux slots, as the model normalises them), because the JAX
  kernel rounds the difference and every slot's message to bf16
  (band_hop.py:212-219) where the port keeps float32 and rounds once.
- The banded backward against ``jax.grad`` through the custom VJP (its
  Pallas backward in interpret mode), and the ELL backward against
  ``jax.vjp`` of the JAX slot loop (mswe_gnn_tpu/models/swegnn.py:447-465),
  on random tables and on a skewed one (a source row read by 60 slots,
  half the rows by none, as the backward kernel's reading-slot batches and
  their tails need): float32, rtol 1e-5 / atol 1e-5 for the band (the TPU
  kernel scatters tile by tile into its accumulator, the port gathers row
  by row), atol 1e-6 for the ELL hop.
- The hop's autograd repair: on the CPU, autograd through ``hop`` (the
  plain version under PyTorch's autograd) and through ``HopFunction``'s
  plain forward and backward give the same gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mswe_gnn_tpu.ops import band_hop as jax_band
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.ops import band_hop as port_band
from mswe_gnn_tpu_torch.ops import hop as hop_ops
from tests.torch_port_common import bench_sample_pair

MODES = [(True, False), (True, True), (False, False)]   # gradient, upwind, no gradient


def banded_problem(seed, n=512, d=4, bw=40, feat=32, tail_rows=0):
    """Band-limited slot sources (with ``tail_rows``, some reading the last
    rows, as ghost cells do), a slot mask, a state with dry rows and a
    masked flux table ``[N, D*F]`` whose slots have unit norm, as the
    model's normalised flux does."""
    rng = np.random.default_rng(seed)
    src = np.clip(np.arange(n)[:, None] + rng.integers(-bw, bw + 1, (n, d)), 0, n - 1)
    if tail_rows:
        rows = rng.integers(0, n - port_band.TILE, tail_rows)
        src[rows, 0] = rng.integers(n - 8, n, tail_rows)
    mask = (rng.random((n, d)) < 0.85).astype(np.float32)
    state = rng.normal(size=(n, feat)).astype(np.float32)
    state[rng.random(n) < 0.3] = 0.0
    s = rng.normal(size=(n, d, feat)).astype(np.float32)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    s_tab = (s * mask[:, :, None]).reshape(n, d * feat)
    return src, mask, state, s_tab


PROBLEMS = {"band": dict(seed=0), "tail": dict(seed=1, n=1024, bw=6, feat=16, tail_rows=40)}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def planned(request):
    src, mask, state, s_tab = banded_problem(**PROBLEMS[request.param])
    n = len(src)
    return (src, mask, state, s_tab, jax_band.plan_band(src, mask, n),
            port_band.plan_band(src, mask, n))


def test_plan_band_matches_jax(planned):
    src, mask, _, _, jplan, pplan = planned
    assert pplan.ws == jplan.ws and pplan.we == jplan.we
    np.testing.assert_array_equal(pplan.win.numpy(), np.asarray(jplan.win))
    np.testing.assert_array_equal(pplan.idx_rel.numpy(), np.asarray(jplan.idx_rel))
    assert pplan.win.dtype == pplan.idx_rel.dtype == torch.int32
    own = np.arange(len(src))[:, None]
    decoded = port_band.band_sources(pplan.idx_rel, pplan.win, pplan.ws, pplan.we)
    np.testing.assert_array_equal(decoded.numpy(), np.where(mask > 0, src, own))


def test_plan_band_tail_and_rejection():
    src, mask, *_ = banded_problem(**PROBLEMS["tail"])
    assert port_band.plan_band(src, mask, len(src)).we == port_band.TILE
    n = 2048                                     # unbanded: random sources
    rng = np.random.default_rng(4)
    src = rng.integers(0, n, (n, 4))
    mask = np.ones((n, 4), np.float32)
    assert port_band.plan_band(src, mask, n) is None
    assert jax_band.plan_band(src, mask, n) is None
    assert port_band.plan_band(src[:500], mask[:500], 500) is None   # not a tile multiple


@pytest.mark.parametrize("nx", [16, 24])
def test_attach_band_plan_matches_jax(nx):
    jg, pg = bench_sample_pair(nx, nx, 4)
    jb = jax_band.attach_band_plan(jg, min_nodes=128)
    pb = port_band.attach_band_plan(pg, min_nodes=128)
    assert pb.band_meta == jb.band_meta and pb.band_meta[0] is not None
    for jp, pp in zip(jb.band_plan["scales"], pb.band_plan["scales"]):
        assert (jp is None) == (pp is None)
        if pp is not None:
            for key in ("win", "idx_rel"):
                np.testing.assert_array_equal(pp[key].numpy(), np.asarray(jp[key]))
    assert port_band.attach_band_plan(pg, min_nodes=10 ** 6) is pg     # nothing planned
    moved = pb.to("cpu")
    assert moved.band_meta == pb.band_meta and moved.band_plan["scales"][0]["win"].dtype \
        == torch.int32


def port_args(state, s_tab, plan, dtype=torch.float32):
    return (torch.from_numpy(state).to(dtype), torch.from_numpy(s_tab).to(dtype),
            plan.idx_rel, plan.win)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-6),
                                             (torch.bfloat16, 0.0, 2e-2)])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
def test_band_hop_matches_jax(planned, dtype, rtol, atol, with_gradient, upwind):
    _, _, state, s_tab, jplan, pplan = planned
    kw = dict(ws=pplan.ws, we=pplan.we, with_gradient=with_gradient, upwind=upwind)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_band.band_hop(jnp.asarray(state, jdt), jnp.asarray(s_tab, jdt),
                                        jplan.idx_rel, jplan.win, interpret=True, **kw)
                      .astype(jnp.float32))
    got = port_band.band_hop(*port_args(state, s_tab, pplan, dtype), **kw)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
    assert (want != 0).any()


@pytest.mark.parametrize("with_gradient,upwind", MODES)
def test_band_backward_matches_jax_grad(planned, with_gradient, upwind):
    _, mask, state, s_tab, jplan, pplan = planned
    kw = dict(ws=pplan.ws, we=pplan.we, with_gradient=with_gradient, upwind=upwind)
    w = np.random.default_rng(9).normal(size=state.shape).astype(np.float32)

    def jloss(st, s):
        return (jax_band.band_hop(st, s, jplan.idx_rel, jplan.win, interpret=True, **kw)
                * w).sum()

    want_st, want_s = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(state), jnp.asarray(s_tab))
    st, s, idx_rel, win = port_args(state, s_tab, pplan)
    st.requires_grad_(True)
    s.requires_grad_(True)
    # the autograd Function's plain path, with the out-slot table the model
    # uses (zero-flux slots left out) and with the one built on demand
    mask_t = torch.from_numpy(mask)
    src = port_band.band_sources(idx_rel, win, pplan.ws, pplan.we)
    for table in (hop_ops.out_slot_table(src, len(state), mask_t), None):
        out = port_band.BandHopFunction.apply(st, s, idx_rel, win, pplan.ws, pplan.we,
                                              with_gradient, upwind, table)
        got_st, got_s = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (st, s))
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    # and autograd of the plain forward, the path band_hop takes on the CPU
    ref = port_band.band_hop(st, s, idx_rel, win, **kw)
    ref_st, ref_s = torch.autograd.grad((ref * torch.from_numpy(w)).sum(), (st, s))
    torch.testing.assert_close(got_st, ref_st, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_s, ref_s, rtol=1e-6, atol=1e-6)


def test_band_backward_reference_shapes_and_dtypes(planned):
    _, _, state, s_tab, _, pplan = planned
    st, s, idx_rel, win = port_args(state, s_tab, pplan, torch.bfloat16)
    g = torch.ones_like(st)
    table = hop_ops.out_slot_table(port_band.band_sources(idx_rel, win, pplan.ws, pplan.we),
                                   len(state))
    port_band.reset_launches()
    gstate, gs = port_band.band_hop_backward(st, s, idx_rel, win, g, *table, ws=pplan.ws,
                                             we=pplan.we)
    assert gstate.shape == st.shape and gs.shape == s.shape
    assert gstate.dtype == gs.dtype == torch.bfloat16
    assert port_band.launches == port_band.bwd_launches == 0     # the CPU launches nothing
    with pytest.raises(ValueError):
        port_band.band_hop(st[:-1], s[:-1], idx_rel[:-1], win, ws=pplan.ws, we=pplan.we)
    with pytest.raises(ValueError):
        port_band.band_hop(st, s, idx_rel, win, ws=pplan.ws[:-1], we=pplan.we)


# ---------------------------------------------------------------- ELL backward

def jax_slot_hop(dst, src, src_tab, s_tab, with_gradient, upwind):
    """One hop of the JAX slot loop (mswe_gnn_tpu/models/swegnn.py:447-465)."""
    dst_act = (dst.sum(axis=1, keepdims=True) != 0).astype(dst.dtype)
    agg = jnp.zeros_like(dst)
    for d in range(src_tab.shape[1]):
        nb = jnp.take(src, src_tab[:, d], axis=0)
        act = jnp.maximum((nb.sum(axis=-1, keepdims=True) != 0).astype(dst.dtype), dst_act)
        if with_gradient:
            diff = dst - nb
            if upwind:
                diff = jnp.maximum(diff, 0.0)
            agg = agg + diff * s_tab[:, d] * act
        else:
            agg = agg + s_tab[:, d] * nb * act
    return agg


def ell_problem(seed, n_dst, n_src, d, feat, same_block, skew=False):
    """``skew``: the slots read the first half of the source rows only, and
    slot 0 of the first 80 rows reads source row 1."""
    rng = np.random.default_rng(seed)
    dst = rng.normal(size=(n_dst, feat)).astype(np.float32)
    dst[rng.random(n_dst) < 0.4] = 0.0
    src = dst if same_block else rng.normal(size=(n_src, feat)).astype(np.float32)
    if not same_block:
        src[rng.random(n_src) < 0.3] = 0.0
    tab = rng.integers(0, n_src, (n_dst, d)).astype(np.int32)
    if skew:
        tab //= 2
        tab[:80, 0] = 1
    mask = (rng.random((n_dst, d)) < 0.75).astype(np.float32)
    s_tab = rng.normal(size=(n_dst, d, feat)).astype(np.float32) * mask[:, :, None]
    g = rng.normal(size=(n_dst, feat)).astype(np.float32)
    return dst, src, tab, s_tab, mask, g


@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("same_block", [True, False], ids=["same-block", "un-pool"])
def test_ell_backward_matches_jax_vjp(same_block, with_gradient, upwind):
    check_ell_backward_against_vjp(
        ell_problem(3, 200, 200 if same_block else 57, 4, 16, same_block), same_block,
        with_gradient, upwind)


@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("same_block", [True, False], ids=["same-block", "un-pool"])
def test_ell_backward_on_a_skewed_table_matches_jax_vjp(same_block, with_gradient, upwind):
    problem = ell_problem(4, 240, 240 if same_block else 61, 4, 16, same_block, skew=True)
    tab, mask = problem[2], problem[4]
    counts = np.bincount(tab[mask > 0], minlength=len(problem[1]))
    assert counts.max() >= 40 and (counts == 0).sum() >= len(problem[1]) // 3
    check_ell_backward_against_vjp(problem, same_block, with_gradient, upwind)


def check_ell_backward_against_vjp(problem, same_block, with_gradient, upwind):
    """``hop_backward`` on the CPU (its plain version), with the out-slot
    table with and without the masked slots, against ``jax.vjp`` of the
    JAX slot loop."""
    dst, src, tab, s_tab, mask, g = problem
    if same_block:
        _, pull = jax.vjp(lambda st, s: jax_slot_hop(st, st, tab, s, with_gradient, upwind),
                          jnp.asarray(dst), jnp.asarray(s_tab))
        want_dst, want_s = pull(jnp.asarray(g))
        want_src = None
    else:
        _, pull = jax.vjp(lambda a, b, s: jax_slot_hop(a, b, tab, s, with_gradient, upwind),
                          jnp.asarray(dst), jnp.asarray(src), jnp.asarray(s_tab))
        want_dst, want_src, want_s = pull(jnp.asarray(g))
    t_dst = torch.from_numpy(dst)
    t_src = t_dst if same_block else torch.from_numpy(src)
    args = (t_dst, t_src, torch.from_numpy(tab), torch.from_numpy(s_tab))
    for table_mask in (torch.from_numpy(mask), None):
        table = hop_ops.out_slot_table(args[2], len(src), table_mask)
        g_dst, g_src, gs = hop_ops.hop_backward(*args, torch.from_numpy(g), *table,
                                                with_gradient, upwind)
        np.testing.assert_allclose(gs.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
        if same_block:
            assert g_src is None
            np.testing.assert_allclose(g_dst.numpy(), np.asarray(want_dst), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(g_src.numpy(), np.asarray(want_src), rtol=1e-5,
                                       atol=1e-6)
            if with_gradient:
                np.testing.assert_allclose(g_dst.numpy(), np.asarray(want_dst), rtol=1e-5,
                                           atol=1e-6)
            else:             # the destination state only enters the wet-front mask
                assert g_dst is None and not np.asarray(want_dst).any()


@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("same_block", [True, False], ids=["same-block", "un-pool"])
def test_hop_function_repairs_the_gradient(same_block, with_gradient, upwind):
    """Autograd through ``hop`` on the CPU (the plain version) and through
    ``HopFunction`` (the path CUDA tensors take, here on its plain forward
    and backward) give the same gradients."""
    dst, src, tab, s_tab, mask, g = ell_problem(5, 150, 150 if same_block else 40, 4, 8,
                                                same_block)

    def grads(fn):
        d = torch.from_numpy(dst).requires_grad_(True)
        s_src = d if same_block else torch.from_numpy(src).requires_grad_(True)
        s = torch.from_numpy(s_tab).requires_grad_(True)
        out = fn(d, s_src, torch.from_numpy(tab), s)
        assert out.grad_fn is not None
        wrt = (d, s) if same_block else (d, s_src, s)
        return out, torch.autograd.grad(out, wrt, torch.from_numpy(g), allow_unused=True)

    want_out, want = grads(lambda *a: hop_ops.hop(*a, with_gradient=with_gradient,
                                                  upwind=upwind))
    table = hop_ops.out_slot_table(torch.from_numpy(tab), len(src), torch.from_numpy(mask))
    got_out, got = grads(lambda *a: hop_ops.HopFunction.apply(*a, with_gradient, upwind,
                                                              table))
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    for a, b in zip(got, want):
        if a is None or b is None:   # un-pool, no gradient: dst enters the mask only
            assert not with_gradient and not same_block
            continue
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_out_slot_table():
    tab = torch.tensor([[2, 0], [2, 2], [1, 0]], dtype=torch.int32)
    ptr, slots = hop_ops.out_slot_table(tab, 4)
    assert ptr.tolist() == [0, 2, 3, 6, 6] and slots.tolist() == [1, 5, 4, 0, 2, 3]
    ptr, slots = hop_ops.out_slot_table(tab, 4, torch.tensor([[1, 0], [0, 1], [1, 1.0]]))
    assert ptr.tolist() == [0, 1, 2, 4, 4] and slots[:4].tolist() == [5, 4, 0, 3]
    assert ptr.dtype == slots.dtype == torch.int32
    with pytest.raises(ValueError, match="outside"):
        hop_ops.out_slot_table(tab, 2)
    # a masked slot may hold any index; a counted one may not
    hop_ops.out_slot_table(torch.tensor([[7]], dtype=torch.int32), 2, torch.zeros(1, 1))


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def small_banded():
    _, pg = bench_sample_pair(16, 16, 4)
    banded = port_band.attach_band_plan(pg, min_nodes=128)
    cfg, params, apply_fn = build_model(
        {"hid_features": 16, "K": 2, "mlp_layers": 2, "learned_residuals": True,
         "with_WL": True}, num_node_features=pg.x_static.shape[1] + pg.x_dynamic.shape[1],
        num_edge_features=pg.edge_attr.shape[1], num_scales=3, previous_t=3, device="cpu")
    return pg, banded, cfg, params, apply_fn


def test_msgnn_band_plan_matches_ell_path(small_banded):
    """apply_msgnn with the band plan equals the ELL path (JAX
    tests/test_band_hop.py::test_msgnn_band_plan_end_to_end)."""
    pg, banded, cfg, params, apply_fn = small_banded
    want = apply_fn(params, cfg, pg)
    got = apply_fn(params, cfg, banded)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert got.abs().max() > 0


def test_prepare_attaches_out_slot_tables(small_banded):
    pg, _, cfg, params, _ = small_banded
    cache = prepare_graph(params, cfg, pg).ell_cache
    spec = pg.spec
    for i, (_, mask, srcs, _, (ptr, slots)) in enumerate(cache["scales"]):
        assert ptr.shape == (spec.node_counts[i] + 1,) and int(ptr[-1]) == int(mask.sum())
        flat = slots[:int(ptr[-1])].long()
        counts = ptr[1:] - ptr[:-1]
        rows = torch.repeat_interleave(torch.arange(spec.node_counts[i]), counts.long())
        assert torch.equal(srcs.reshape(-1)[flat].long(), rows)   # each slot reads its row
    for lvl, (_, umask, usrc, (ptr, _)) in enumerate(cache["unpools"]):
        assert ptr.shape == (spec.node_counts[lvl + 1] + 1,)
        assert int(ptr[-1]) == int(umask.sum())


def test_prepare_without_gradients_skips_out_slot_tables(small_banded):
    """The rollout prepares in inference mode, where no backward runs: the
    out-slot tables are left out and the model's output is unchanged."""
    pg, banded, cfg, params, apply_fn = small_banded
    with torch.inference_mode():
        cache = prepare_graph(params, cfg, banded).ell_cache
        assert all(entry[-1] is None for entry in cache["scales"] + cache["unpools"])
        got = apply_fn(params, cfg, banded.replace(ell_cache=cache))
        want = apply_fn(params, cfg, banded)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
