"""The SWE-GNN hop and its backward: CUDA kernels for Hopper and their plain
PyTorch versions.

One hop of the SWEGNN node update on ELL (padded neighbour-table) slots:

    agg[n] = sum_d act(n,d) * (dst[n] - src[src_tab[n,d]]) * s_tab[n,d]
    act(n,d) = rowsum(src[src_tab[n,d]]) != 0  OR  rowsum(dst[n]) != 0

with an upwind mode (the difference clamped at 0) and a no-gradient mode
(``s_tab[n,d] * src[src_tab[n,d]]``). ``src`` is ``dst`` itself for a
same-block hop and the constant coarse block for an un-pooling hop.

The forward kernel (``csrc/hop.cu``) replaces the TPU kernel
``mswe_gnn_tpu/ops/pallas_hop.py::_hop_kernel``. The backward kernel (same
source) is the port's own: the JAX package gets that gradient from XLA
autodiff of its slot loop. ``csrc/hop_common.cuh`` says what bounds them
and how they are laid out. The backward turns the scatter to the source
rows into a gather over an out-slot table (``out_slot_table``: for every
source row, the slots that read it), built once per graph.

``hop`` is differentiable. For CUDA tensors it runs ``HopFunction``, whose
forward and backward launch the kernels; for CPU tensors it runs
``hop_reference`` under PyTorch's autograd. ``hop_backward`` launches the
backward kernel for CUDA tensors and runs ``hop_backward_reference`` for
CPU tensors; there is no fallback from one to the other. The wet-front mask
gets no gradient, as in ``mswe_gnn_tpu/ops/band_hop.py:376-379``; under
upwind the difference passes its gradient where it is > 0.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from mswe_gnn_tpu_torch.ops import build as kernel_build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNKS = 128       # 32 lanes x 4 chunks a lane (the kernels' CPL <= 4)

launches = 0            # forward kernel launches; reset with reset_launches()
bwd_launches = 0        # backward kernel launches
# the same launches by ("hop" or "hop_bwd", Nd, Ns)
launches_by_shape: collections.Counter = collections.Counter()

_lock = threading.Lock()
_fns: dict = {}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0
    launches_by_shape.clear()


def _kernels() -> dict:
    """The library's launch functions, typed for ctypes: ``fwd``, ``bwd``,
    ``fwd_info`` and ``bwd_info`` (a launch's block size, grid, registers,
    local memory, blocks an SM, lanes a row and shared memory, for a row
    count; the backward's for ``(Nd, Ns, same_block)``)."""
    with _lock:
        if not _fns:
            lib = kernel_build.load("hop")
            fwd = lib.mswe_hop_launch
            fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.mswe_hop_bwd_launch
            bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            info = lib.mswe_hop_fwd_info
            info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            info.restype = ctypes.c_int
            bwd_info = lib.mswe_hop_bwd_info
            bwd_info.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
            bwd_info.restype = ctypes.c_int
            _fns.update(fwd=fwd, bwd=bwd, fwd_info=info, bwd_info=bwd_info)
        return _fns


def vector_layout(feat: int, tensors) -> int:
    """1 when the kernels may use 16-byte loads (F a multiple of 16 bytes and
    every pointer 16-byte aligned), else 0; raises for F wider than the
    kernels take."""
    elem = tensors[0].element_size()
    per_16_bytes = 16 // elem
    vectorized = feat % per_16_bytes == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    chunks = feat // per_16_bytes if vectorized else feat
    if chunks > _MAX_CHUNKS:
        raise ValueError(f"feature width {feat} is wider than the kernels take")
    return int(vectorized)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def _check(dst_state, src_state, src_tab, s_tab) -> None:
    if dst_state.dim() != 2 or src_state.dim() != 2:
        raise ValueError("dst_state and src_state must be [rows, F]")
    n_dst, feat = dst_state.shape
    if src_state.shape[1] != feat:
        raise ValueError(f"src_state width {src_state.shape[1]} != dst_state width {feat}")
    if src_tab.dim() != 2 or src_tab.shape[0] != n_dst:
        raise ValueError(f"src_tab must be [{n_dst}, D], got {tuple(src_tab.shape)}")
    if src_tab.dtype != torch.int32:
        raise ValueError(f"src_tab must be int32, got {src_tab.dtype}")
    if tuple(s_tab.shape) != (n_dst, src_tab.shape[1], feat):
        raise ValueError(f"s_tab must be [{n_dst}, {src_tab.shape[1]}, {feat}], "
                         f"got {tuple(s_tab.shape)}")
    if dst_state.dtype not in DTYPE_CODES:
        raise ValueError(f"state dtype must be float32 or bfloat16, got {dst_state.dtype}")
    if src_state.dtype != dst_state.dtype or s_tab.dtype != dst_state.dtype:
        raise ValueError("dst_state, src_state and s_tab must share one dtype")
    tensors = (dst_state, src_state, src_tab, s_tab)
    if any(t.device != dst_state.device for t in tensors):
        raise ValueError("all hop inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hop inputs must be contiguous")
    if dst_state.device.type not in ("cuda", "cpu"):
        raise ValueError(f"hop runs on cuda or cpu tensors, got {dst_state.device}")


def out_slot_table(src_tab: torch.Tensor, n_src: int,
                   slot_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed slot table of a hop, as CSR: ``(out_ptr [n_src + 1],
    out_slots [Nd * D])`` int32, where ``out_slots[out_ptr[r]:out_ptr[r+1]]``
    are the flat slot ids ``n * D + d`` that read source row ``r``, in
    increasing order. With ``slot_mask [Nd, D]`` the masked slots are left
    out (they sort past ``out_ptr[-1]``); such slots must carry zero flux,
    so that their share of the source gradient is zero. Raises if a counted
    slot reads a row outside ``[0, n_src)``."""
    n_dst, degree = src_tab.shape
    key = src_tab.reshape(-1).long()
    counted = (torch.ones_like(key, dtype=torch.bool) if slot_mask is None
               else slot_mask.reshape(-1) > 0)
    key = torch.where(counted, key, torch.full_like(key, n_src))
    if key.numel() and bool(((key < 0) | (key > n_src) | (counted & (key == n_src))).any()):
        raise ValueError(f"a slot reads a source row outside [0, {n_src})")
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_src + 1)[:n_src]
    out_ptr = torch.zeros(n_src + 1, dtype=torch.int64, device=src_tab.device)
    out_ptr[1:] = torch.cumsum(counts, 0)
    return out_ptr.to(torch.int32), order.to(torch.int32)


class HopFunction(torch.autograd.Function):
    """The hop with its backward: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors. A same-block hop (``src_state is
    dst_state``) returns its whole state gradient through ``dst_state``."""

    @staticmethod
    def forward(ctx, dst_state, src_state, src_tab, s_tab, with_gradient, upwind,
                out_table):
        ctx.same_block = src_state is dst_state
        ctx.modes = (with_gradient, upwind)
        ctx.out_table = out_table
        ctx.save_for_backward(dst_state, None if ctx.same_block else src_state,
                              src_tab, s_tab)
        return _hop_forward(dst_state, src_state, src_tab, s_tab, with_gradient, upwind)

    @staticmethod
    def backward(ctx, g):
        dst_state, src_state, src_tab, s_tab = ctx.saved_tensors
        if ctx.same_block:
            src_state = dst_state
        out_table = ctx.out_table
        if out_table is None:
            out_table = out_slot_table(src_tab, src_state.shape[0])
        g_dst, g_src, gs = hop_backward(dst_state, src_state, src_tab, s_tab,
                                        g.contiguous(), *out_table, *ctx.modes)
        return g_dst, g_src, None, gs, None, None, None


def hop(dst_state: torch.Tensor, src_state: torch.Tensor, src_tab: torch.Tensor,
        s_tab: torch.Tensor, with_gradient: bool = True, upwind: bool = False,
        out_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One hop -> ``agg [Nd, F]`` in the state dtype, differentiable in the
    states and the flux.

    ``dst_state [Nd, F]``, ``src_state [Ns, F]`` (the same tensor for a
    same-block hop), ``src_tab [Nd, D]`` int32 rows of ``src_state``,
    ``s_tab [Nd, D, F]`` flux with the slot mask folded in. ``out_table``:
    ``out_slot_table(src_tab, Ns, ...)`` for the backward kernel, built on
    demand when not given. CUDA tensors go through the kernels, CPU tensors
    through ``hop_reference``.
    """
    _check(dst_state, src_state, src_tab, s_tab)
    if dst_state.device.type == "cpu":
        return hop_reference(dst_state, src_state, src_tab, s_tab, with_gradient, upwind)
    return HopFunction.apply(dst_state, src_state, src_tab, s_tab, with_gradient, upwind,
                             out_table)


def _hop_forward(dst_state, src_state, src_tab, s_tab, with_gradient, upwind):
    global launches
    if dst_state.device.type == "cpu":
        return hop_reference(dst_state, src_state, src_tab, s_tab, with_gradient, upwind)
    n_dst, feat = dst_state.shape
    agg = torch.empty_like(dst_state)
    if n_dst == 0:
        return agg
    vectorized = vector_layout(feat, (dst_state, src_state, s_tab, agg))
    with torch.cuda.device(dst_state.device):
        stream = torch.cuda.current_stream(dst_state.device).cuda_stream
        rc = _kernels()["fwd"](
            dst_state.data_ptr(), src_state.data_ptr(), src_tab.data_ptr(),
            s_tab.data_ptr(), agg.data_ptr(), n_dst, src_state.shape[0], feat,
            src_tab.shape[1], DTYPE_CODES[dst_state.dtype], vectorized,
            int(with_gradient), int(upwind), stream)
    check_launch(rc, "hop")
    launches += 1
    launches_by_shape["hop", n_dst, src_state.shape[0]] += 1
    return agg


def hop_reference(dst_state: torch.Tensor, src_state: torch.Tensor,
                  src_tab: torch.Tensor, s_tab: torch.Tensor,
                  with_gradient: bool = True, upwind: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same wet-front
    predicate (a float32 row sum != 0), the D terms added in float32 in slot
    order, one rounding to the state dtype at the end."""
    out = dst_state.float()
    dst_act = out.sum(dim=1) != 0
    acc = torch.zeros_like(out)
    for d in range(src_tab.shape[1]):
        nb = src_state.index_select(0, src_tab[:, d]).float()
        act = ((nb.sum(dim=1) != 0) | dst_act).to(out.dtype)[:, None]
        s = s_tab[:, d].float()
        if with_gradient:
            diff = out - nb
            if upwind:
                diff = diff.clamp_min(0.0)
            term = diff * s
        else:
            term = s * nb
        acc = acc + term * act
    return acc.to(dst_state.dtype)


def _check_backward(dst_state, src_state, src_tab, s_tab, g, out_ptr, out_slots):
    _check(dst_state, src_state, src_tab, s_tab)
    if g.shape != dst_state.shape or g.dtype != dst_state.dtype:
        raise ValueError(f"g must be {tuple(dst_state.shape)} {dst_state.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    n_src = src_state.shape[0]
    if out_ptr.shape != (n_src + 1,) or out_slots.dim() != 1:
        raise ValueError(f"out_ptr must be [{n_src + 1}] and out_slots 1-D")
    if out_ptr.dtype != torch.int32 or out_slots.dtype != torch.int32:
        raise ValueError("out_ptr and out_slots must be int32")
    tensors = (g, out_ptr, out_slots)
    if any(t.device != dst_state.device for t in tensors):
        raise ValueError("all hop inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hop inputs must be contiguous")


def hop_backward(dst_state: torch.Tensor, src_state: torch.Tensor, src_tab: torch.Tensor,
                 s_tab: torch.Tensor, g: torch.Tensor, out_ptr: torch.Tensor,
                 out_slots: torch.Tensor, with_gradient: bool = True, upwind: bool = False):
    """Gradients of one hop for the upstream gradient ``g [Nd, F]`` ->
    ``(g_dst, g_src, gs)``.

    ``gs [Nd, D, F]`` is the flux gradient in the flux dtype. A same-block
    hop (``src_state is dst_state``) has one state gradient, the diagonal
    terms plus the gathered scatter, returned as ``g_dst`` with ``g_src``
    None. A separate-source hop returns ``g_dst`` (None in no-gradient mode,
    where the destination state only enters the mask) and ``g_src``. State
    gradients are summed in float32 and rounded once to the state dtype.
    CUDA tensors go through the kernel, CPU tensors through
    ``hop_backward_reference``."""
    global bwd_launches
    _check_backward(dst_state, src_state, src_tab, s_tab, g, out_ptr, out_slots)
    if dst_state.device.type == "cpu":
        return hop_backward_reference(dst_state, src_state, src_tab, s_tab, g, out_ptr,
                                      out_slots, with_gradient, upwind)
    same_block = src_state is dst_state
    n_dst, feat = dst_state.shape
    n_src = src_state.shape[0]
    gs = torch.empty_like(s_tab)
    # a same-block hop's state gradient goes to the kernel's g_src output
    g_dst = torch.empty_like(dst_state) if with_gradient and not same_block else None
    g_src = torch.empty_like(src_state)
    vectorized = vector_layout(feat, (dst_state, src_state, s_tab, g, gs, g_dst, g_src))
    with torch.cuda.device(dst_state.device):
        stream = torch.cuda.current_stream(dst_state.device).cuda_stream
        rc = _kernels()["bwd"](
            dst_state.data_ptr(), src_state.data_ptr(), src_tab.data_ptr(),
            s_tab.data_ptr(), g.data_ptr(), out_ptr.data_ptr(), out_slots.data_ptr(),
            gs.data_ptr(), None if g_dst is None else g_dst.data_ptr(), g_src.data_ptr(),
            n_dst, n_src, feat, src_tab.shape[1], DTYPE_CODES[dst_state.dtype],
            vectorized, int(with_gradient), int(upwind), int(same_block), stream)
    check_launch(rc, "hop backward")
    bwd_launches += 1
    launches_by_shape["hop_bwd", n_dst, n_src] += 1
    if same_block:
        return g_src, None, gs
    return g_dst, g_src, gs


def hop_backward_reference(dst_state: torch.Tensor, src_state: torch.Tensor,
                           src_tab: torch.Tensor, s_tab: torch.Tensor, g: torch.Tensor,
                           out_ptr: torch.Tensor, out_slots: torch.Tensor,
                           with_gradient: bool = True, upwind: bool = False):
    """Plain PyTorch version of the backward kernel, operation for
    operation: float32 products, a row's own slot terms added in slot order,
    then the terms of the slots that read it, in out-slot-table order, one
    rounding at the end."""
    same_block = src_state is dst_state
    o = dst_state.float()
    gr = g.float()
    dst_act = o.sum(dim=1) != 0
    n_dst, degree = src_tab.shape
    gs = torch.empty(n_dst, degree, o.shape[1], dtype=torch.float32, device=o.device)
    passed = torch.empty_like(gs)            # each slot's term for the source row
    diag = torch.zeros_like(o)
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    for d in range(degree):
        nb = src_state.index_select(0, src_tab[:, d]).float()
        act = ((nb.sum(dim=1) != 0) | dst_act)[:, None]
        s = s_tab[:, d].float()
        if with_gradient:
            diff = o - nb
            kept = diff.clamp_min(0.0) if upwind else diff
            gs[:, d] = torch.where(act, kept * gr, zero)
            gate = act & (diff > 0) if upwind else act
            passed[:, d] = torch.where(gate, s * gr, zero)
            diag = diag + passed[:, d]
        else:
            gs[:, d] = torch.where(act, nb * gr, zero)
            passed[:, d] = torch.where(act, s * gr, zero)
    acc = diag if same_block else torch.zeros(src_state.shape, dtype=torch.float32,
                                              device=o.device)
    begin = out_ptr[:-1].long()
    count = out_ptr[1:].long() - begin
    flat = passed.reshape(n_dst * degree, -1)
    for j in range(int(count.max()) if count.numel() else 0):
        valid = (j < count)[:, None]
        slot = out_slots.long()[(begin + j).clamp_max(max(out_slots.numel() - 1, 0))]
        term = torch.where(valid, flat.index_select(0, slot), zero)
        acc = acc - term if with_gradient else acc + term
    gs = gs.to(s_tab.dtype)
    if same_block:
        return acc.to(dst_state.dtype), None, gs
    g_dst = diag.to(dst_state.dtype) if with_gradient else None
    return g_dst, acc.to(src_state.dtype), gs
