"""The port's hop (mswe_gnn_tpu_torch/ops/hop.py) against the JAX package's
Pallas hop kernel in interpret mode and the XLA slot-loop formula.

On the CPU the wrapper runs ``hop_reference``, the plain version the CUDA
kernel is held against on the card. Tolerance in float32: rtol 1e-5,
atol 1e-6 — the same products, summed over D slots in another order by the
JAX versions (the Pallas kernel adds slot by slot, XLA reduces a stacked
axis)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mswe_gnn_tpu.ops.pallas_hop import fused_hop
from mswe_gnn_tpu_torch.ops import hop as hop_ops

MODES = [(True, False), (True, True), (False, False)]   # gradient, upwind, no gradient
RTOL, ATOL = 1e-5, 1e-6


def xla_slot_loop(out, src_tab, s_tab, lo, with_gradient, upwind):
    """mswe_gnn_tpu/models/swegnn.py:447-465 for one hop, in numpy."""
    n_dst, d_max, _ = s_tab.shape
    dst = out[lo:lo + n_dst]
    dst_act = (dst.sum(1, keepdims=True) != 0).astype(out.dtype)
    agg = np.zeros_like(dst)
    for d in range(d_max):
        nb = out[src_tab[:, d]]
        act = np.maximum((nb.sum(-1, keepdims=True) != 0).astype(out.dtype), dst_act)
        if with_gradient:
            diff = dst - nb
            if upwind:
                diff = np.maximum(diff, 0.0)
            agg = agg + diff * s_tab[:, d] * act
        else:
            agg = agg + s_tab[:, d] * nb * act
    return agg


def make_inputs(rng, n, n_dst, lo, f, d, dry=0.4, masked=0.3):
    out = rng.normal(size=(n, f)).astype(np.float32)
    out[rng.random(n) < dry] = 0.0                       # dry rows: the wet front bites
    src_tab = rng.integers(0, n, (n_dst, d)).astype(np.int32)
    s_tab = rng.normal(size=(n_dst, d, f)).astype(np.float32)
    s_tab[rng.random((n_dst, d)) < masked] = 0.0         # masked slots
    return out, src_tab, s_tab


def port_hop(out, src_tab, s_tab, lo, with_gradient, upwind):
    """Same-block when the dst rows are all of ``out``, else a separate
    source tensor (the un-pooling form)."""
    n_dst = s_tab.shape[0]
    t_out = torch.from_numpy(out)
    dst = t_out if (lo == 0 and n_dst == len(out)) else t_out[lo:lo + n_dst].contiguous()
    return hop_ops.hop(dst, t_out, torch.from_numpy(src_tab), torch.from_numpy(s_tab),
                       with_gradient=with_gradient, upwind=upwind).numpy()


@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("n,n_dst,lo", [
    (384, 384, 0),      # same block
    (600, 512, 64),     # dst rows inside a larger source block
    (300, 200, 50),     # ragged: Nd not a multiple of the Pallas tile
])
def test_hop_matches_pallas_interpret_and_slot_loop(rng, n, n_dst, lo,
                                                    with_gradient, upwind):
    out, src_tab, s_tab = make_inputs(rng, n, n_dst, lo, f=32, d=4)
    got = port_hop(out, src_tab, s_tab, lo, with_gradient, upwind)
    pallas = np.asarray(fused_hop(jnp.asarray(out), jnp.asarray(src_tab),
                                  jnp.asarray(s_tab), lo, with_gradient, upwind,
                                  tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, xla_slot_loop(out, src_tab, s_tab, lo, with_gradient, upwind),
        rtol=RTOL, atol=ATOL)
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("with_gradient,upwind", MODES)
def test_unpool_disjoint_blocks_match_pallas(rng, with_gradient, upwind):
    """Un-pooling: dst (fine) and src (coarse) are disjoint blocks. The
    Pallas kernel sees them stacked as one array, the port as two tensors."""
    n_fine, n_coarse, f, d = 260, 70, 16, 4
    fine = rng.normal(size=(n_fine, f)).astype(np.float32)
    fine[rng.random(n_fine) < 0.5] = 0.0
    coarse = rng.normal(size=(n_coarse, f)).astype(np.float32)
    coarse[rng.random(n_coarse) < 0.3] = 0.0
    src_tab = rng.integers(0, n_coarse, (n_fine, d)).astype(np.int32)
    s_tab = rng.normal(size=(n_fine, d, f)).astype(np.float32)
    got = hop_ops.hop(torch.from_numpy(fine), torch.from_numpy(coarse),
                      torch.from_numpy(src_tab), torch.from_numpy(s_tab),
                      with_gradient=with_gradient, upwind=upwind).numpy()
    stacked = np.concatenate([fine, coarse])
    want = np.asarray(fused_hop(jnp.asarray(stacked), jnp.asarray(src_tab + n_fine),
                                jnp.asarray(s_tab), 0, with_gradient, upwind,
                                tile=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wet_front_is_row_sum_not_any(rng):
    """A row whose entries cancel to a zero sum counts as dry, as in
    mswe_gnn_tpu/models/swegnn.py:451-457."""
    out = np.zeros((4, 4), np.float32)
    out[1] = [1.0, -1.0, 2.0, -2.0]          # nonzero entries, row sum 0
    src_tab = np.array([[1], [0], [1], [1]], np.int32)
    s_tab = np.ones((4, 1, 4), np.float32)
    got = port_hop(out, src_tab, s_tab, 0, True, False)
    np.testing.assert_array_equal(got, np.zeros_like(got))


def test_bfloat16_accumulates_in_float32_and_rounds_once(rng):
    """bf16 state and flux: the products and the D-term sum are float32, the
    result is rounded to bf16 once (the kernel's contract)."""
    out, src_tab, s_tab = make_inputs(rng, 200, 200, 0, f=16, d=4)
    t_out = torch.from_numpy(out).bfloat16()
    t_s = torch.from_numpy(s_tab).bfloat16()
    got = hop_ops.hop(t_out, t_out, torch.from_numpy(src_tab), t_s)
    assert got.dtype == torch.bfloat16
    want = xla_slot_loop(t_out.float().numpy(), src_tab, t_s.float().numpy(), 0, True, False)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(want).bfloat16().float().numpy())


def test_cpu_path_counts_no_launch(rng):
    out, src_tab, s_tab = make_inputs(rng, 50, 50, 0, f=8, d=2)
    hop_ops.reset_launches()
    port_hop(out, src_tab, s_tab, 0, True, False)
    assert hop_ops.launches == 0


@pytest.mark.parametrize("bad", ["int64_tab", "dtype_mix", "shape", "strided", "float16", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    dst = torch.zeros(6, 8)
    tab = torch.zeros(6, 2, dtype=torch.int32)
    s = torch.zeros(6, 2, 8)
    src = dst
    if bad == "int64_tab":
        tab = tab.long()
    elif bad == "dtype_mix":
        s = s.bfloat16()
    elif bad == "shape":
        s = torch.zeros(6, 3, 8)
    elif bad == "strided":
        dst = torch.zeros(8, 6).t()
        src = dst
    elif bad == "float16":
        dst = src = dst.half()
        s = s.half()
    elif bad == "meta":
        dst, src, tab, s = (t.to("meta") for t in (dst, src, tab, s))
    with pytest.raises(ValueError):
        hop_ops.hop(dst, src, tab, s)
