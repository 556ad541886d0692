"""The banded SWE-GNN hop (port of mswe_gnn_tpu/ops/band_hop.py): the host
planner, CUDA kernels for Hopper, and their plain PyTorch versions.

The hop is the one of ``ops/hop.py`` on a same-block state; only the
addressing of a slot's source row differs. A ``BandPlan`` splits the
block into tiles of 128 destination rows and gives every (tile, slot) a
window of the state; slot d of row n reads

    win[n // 128, d] + idx_rel[n, d]          if idx_rel[n, d] < ws[d]
    N - we + (idx_rel[n, d] - ws[d])          otherwise (the ghost tail)

On the TPU the plan lets a one-hot matrix product on the MXU stand in for a
row gather. Hopper gathers rows directly, so the kernels
(``csrc/band_hop.cu``, device code shared with the ELL hop in
``csrc/hop_common.cuh``) decode the plan per slot and read the row. They
replace the TPU kernels ``band_hop.py::_hop_kernel`` (forward) and
``::_bwd_kernel`` (backward); the backward's scatter is a gather over the
out-slot table of ``ops/hop.py::out_slot_table``, built once per graph.

``plan_band`` and ``attach_band_plan`` are host numpy code and give the JAX
package's plans bit for bit. The TPU's VMEM gates (``supported``,
``supported_bwd``) are not carried over: they only chose among paths of
equal value, and the kernels here take any planned scale.

``band_hop`` is differentiable. For CUDA tensors it runs ``BandHopFunction``
(the two kernels), for CPU tensors ``band_hop_reference`` under PyTorch's
autograd. Arithmetic is float32 with one rounding at the store, as in the
ELL hop: the JAX kernel forms the difference and the message in the state
dtype (``band_hop.py:212-219``), so in bf16 the two differ by rounding.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from mswe_gnn_tpu_torch.ops import build as kernel_build
from mswe_gnn_tpu_torch.ops.hop import (DTYPE_CODES, check_launch, hop_backward_reference,
                                        hop_reference, out_slot_table, vector_layout)

TILE = 128
_W_GRAIN = 64            # per-slot window widths are multiples of this
_W_MAX = 1024
_MAX_DEGREE = 16         # slot widths the kernels take by value

launches = 0             # forward kernel launches; reset with reset_launches()
bwd_launches = 0         # backward kernel launches
# the same launches by ("band_hop" or "band_hop_bwd", N, N)
launches_by_shape: collections.Counter = collections.Counter()

_lock = threading.Lock()
_fns: dict = {}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0
    launches_by_shape.clear()


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Host-computed banded-gather plan for one scale block (see the JAX
    package's ``BandPlan``, band_hop.py:75-100).

    ``win``      [T, D] int32     band-window start row per (tile, slot)
    ``idx_rel``  [T*128, D] int32 slot sources relative to the concatenated
                                  [band_d | tail] window (masked slots -> self)
    ``ws``       per-slot band widths (multiples of 64)
    ``we``       tail width in rows, 0, 128, 256 or 512
    """
    win: torch.Tensor
    idx_rel: torch.Tensor
    ws: Tuple[int, ...]
    we: int = 0

    @property
    def num_tiles(self) -> int:
        return self.win.shape[0]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plan_band(src_ids, slot_mask, n_nodes: int,
              max_w: int = _W_MAX) -> Optional[BandPlan]:
    """A :class:`BandPlan` for a scale block, or None if it is not
    band-limited (band_hop.py:103-168, the same choices in the same order).

    ``src_ids [N, D]`` block-local slot source ids, ``slot_mask [N, D]`` 1 for
    real slots (masked slots are rewritten to the row itself), ``n_nodes``
    the padded block size, a multiple of 128.
    """
    src = _numpy(src_ids).astype(np.int64)
    mask = _numpy(slot_mask) > 0
    n, d_max = src.shape
    if n != n_nodes or n_nodes % TILE != 0 or n_nodes < TILE:
        return None
    own = np.arange(n, dtype=np.int64)[:, None]
    idx = np.where(mask, src, own)                      # masked slots -> self
    t = n // TILE
    tiles = idx.reshape(t, TILE, d_max)
    own_lo = (np.arange(t, dtype=np.int64) * TILE)[:, None]        # [T, 1]

    def round_w(span):
        w = min(-(-span // _W_GRAIN) * _W_GRAIN, n)
        return w if w <= max_w else None

    best = None                             # (total, ws, we, win, rel)
    for we in (0, TILE, 2 * TILE, 4 * TILE):
        if we >= n:
            break
        far = tiles >= n - we                           # tail-window sources
        near = np.where(far, own_lo[:, :, None], tiles)
        lo = np.minimum(near.min(axis=1), own_lo)                   # [T, D]
        hi = np.maximum(near.max(axis=1), own_lo + TILE - 1)        # [T, D]
        ws = []
        for d in range(d_max):
            w = round_w(int((hi[:, d] - lo[:, d]).max()) + 1 + 15)
            if w is None or w > n:
                ws = None
                break
            ws.append(w)
        if ws is None:
            continue
        total = sum(w + we for w in ws)
        if best is not None and total >= best[0]:
            continue
        win = np.minimum(lo, n - np.asarray(ws)[None, :])
        win = np.maximum((win // 16) * 16, 0)
        rel = np.where(far, np.asarray(ws)[None, None, :] + (tiles - (n - we)),
                       tiles - win[:, None, :])
        wpe = np.asarray([w + we for w in ws])
        if rel.min() < 0 or (rel >= wpe[None, None, :]).any():
            continue
        best = (total, tuple(ws), we, win, rel)
    if best is None:
        return None
    _, ws, we, win, rel = best
    return BandPlan(win=torch.from_numpy(win.astype(np.int32)),
                    idx_rel=torch.from_numpy(rel.reshape(n, d_max).astype(np.int32)),
                    ws=ws, we=we)


def attach_band_plan(graph, min_nodes: int = 2048, max_w: int = _W_MAX):
    """Plan the banded hop for every scale of a graph (band_hop.py:424-463).

    Host-side numpy. Scales below ``min_nodes`` or not band-limited keep no
    plan and their hops stay on the ELL kernel. Returns the graph unchanged
    when nothing is plannable; the plan tensors are on the CPU (``.to``
    moves them with the graph)."""
    if graph.in_edge_table is None or graph.band_plan is not None:
        return graph
    spec = graph.spec
    tab_all = _numpy(graph.in_edge_table)
    mask_all = _numpy(graph.in_edge_mask)
    src_all = _numpy(graph.edge_index)[0]
    plans, meta = [], []
    node_ptr, edge_ptr = spec.node_ptr, spec.edge_ptr
    for i in range(spec.num_scales):
        nsl = slice(node_ptr[i], node_ptr[i + 1])
        esl = slice(edge_ptr[i], edge_ptr[i + 1])
        n_s = node_ptr[i + 1] - node_ptr[i]
        plan = None
        if n_s >= min_nodes:
            tab = np.maximum(tab_all[nsl] - edge_ptr[i], 0)
            src_local = src_all[esl] - node_ptr[i]
            plan = plan_band(src_local[tab], mask_all[nsl], n_s, max_w=max_w)
        plans.append(None if plan is None else {"win": plan.win, "idx_rel": plan.idx_rel})
        meta.append(None if plan is None else (plan.ws, plan.we))
    if all(m is None for m in meta):
        return graph
    return graph.replace(band_plan={"scales": tuple(plans)}, band_meta=tuple(meta))


def band_sources(idx_rel: torch.Tensor, win: torch.Tensor, ws, we: int) -> torch.Tensor:
    """The plan decoded -> ``[N, D]`` int32 absolute source rows."""
    n, degree = idx_rel.shape
    rel = idx_rel.long()
    band = rel + win.long().repeat_interleave(TILE, dim=0)[:n]
    cols = [torch.where(rel[:, d] < ws[d], band[:, d], rel[:, d] - ws[d] + (n - we))
            for d in range(degree)]
    return torch.stack(cols, dim=1).to(torch.int32)


def _kernels() -> dict:
    """The library's launch functions, typed for ctypes (as in
    ``ops/hop.py``)."""
    with _lock:
        if not _fns:
            lib = kernel_build.load("band_hop")
            head = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            fwd = lib.mswe_band_hop_launch
            fwd.argtypes = head + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.mswe_band_hop_bwd_launch
            bwd.argtypes = head + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            info = lib.mswe_band_hop_fwd_info
            info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            info.restype = ctypes.c_int
            bwd_info = lib.mswe_band_hop_bwd_info
            bwd_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            bwd_info.restype = ctypes.c_int
            _fns.update(fwd=fwd, bwd=bwd, fwd_info=info, bwd_info=bwd_info)
        return _fns


def _check(state, s_tab, idx_rel, win, ws, we) -> None:
    if state.dim() != 2:
        raise ValueError("state must be [N, F]")
    n, feat = state.shape
    if n % TILE != 0:
        raise ValueError(f"band state rows {n} are not a multiple of {TILE}")
    if idx_rel.dim() != 2 or idx_rel.shape[0] != n:
        raise ValueError(f"idx_rel must be [{n}, D], got {tuple(idx_rel.shape)}")
    degree = idx_rel.shape[1]
    if not 0 < degree <= _MAX_DEGREE or len(ws) != degree:
        raise ValueError(f"need 1..{_MAX_DEGREE} slots and one width each, got "
                         f"D={degree}, ws={ws}")
    if tuple(win.shape) != (n // TILE, degree):
        raise ValueError(f"win must be [{n // TILE}, {degree}], got {tuple(win.shape)}")
    if tuple(s_tab.shape) != (n, degree * feat):
        raise ValueError(f"s_tab must be [{n}, {degree * feat}], got {tuple(s_tab.shape)}")
    if idx_rel.dtype != torch.int32 or win.dtype != torch.int32:
        raise ValueError("idx_rel and win must be int32")
    if state.dtype not in DTYPE_CODES or s_tab.dtype != state.dtype:
        raise ValueError("state and s_tab must share one dtype, float32 or bfloat16")
    tensors = (state, s_tab, idx_rel, win)
    if any(t.device != state.device for t in tensors):
        raise ValueError("all band hop inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band hop inputs must be contiguous")
    if state.device.type not in ("cuda", "cpu"):
        raise ValueError(f"band_hop runs on cuda or cpu tensors, got {state.device}")
    if not 0 <= we < n:
        raise ValueError(f"tail width {we} outside [0, {n})")


def _widths(ws):
    return (ctypes.c_int * len(ws))(*ws)


class BandHopFunction(torch.autograd.Function):
    """The banded hop with its backward: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, state, s_tab, idx_rel, win, ws, we, with_gradient, upwind, out_table):
        ctx.static = (tuple(ws), we, with_gradient, upwind)
        ctx.out_table = out_table
        ctx.save_for_backward(state, s_tab, idx_rel, win)
        return _band_forward(state, s_tab, idx_rel, win, tuple(ws), we, with_gradient, upwind)

    @staticmethod
    def backward(ctx, g):
        state, s_tab, idx_rel, win = ctx.saved_tensors
        ws, we, with_gradient, upwind = ctx.static
        out_table = ctx.out_table
        if out_table is None:
            out_table = out_slot_table(band_sources(idx_rel, win, ws, we), state.shape[0])
        gstate, gs = band_hop_backward(state, s_tab, idx_rel, win, g.contiguous(), *out_table,
                                       ws=ws, we=we, with_gradient=with_gradient,
                                       upwind=upwind)
        return gstate, gs, None, None, None, None, None, None, None


def band_hop(state: torch.Tensor, s_tab: torch.Tensor, idx_rel: torch.Tensor,
             win: torch.Tensor, *, ws, we: int = 0, with_gradient: bool = True,
             upwind: bool = False,
             out_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One hop on a band-planned block -> ``agg [N, F]`` (band_hop.py:364-384),
    differentiable in ``state`` and ``s_tab``.

    ``state [N, F]``, ``s_tab [N, D*F]`` flux (slot-major, masked),
    ``idx_rel [N, D]`` and ``win [N/128, D]`` the plan, ``ws``/``we`` its
    widths. ``out_table``: ``out_slot_table`` of the decoded sources for the
    backward kernel (slots with zero flux may be left out), built on demand
    when not given. CUDA tensors go through the kernels, CPU tensors through
    ``band_hop_reference``."""
    _check(state, s_tab, idx_rel, win, ws, we)
    if state.device.type == "cpu":
        return band_hop_reference(state, s_tab, idx_rel, win, ws=ws, we=we,
                                  with_gradient=with_gradient, upwind=upwind)
    return BandHopFunction.apply(state, s_tab, idx_rel, win, tuple(ws), we, with_gradient,
                                 upwind, out_table)


def _band_forward(state, s_tab, idx_rel, win, ws, we, with_gradient, upwind):
    global launches
    if state.device.type == "cpu":
        return band_hop_reference(state, s_tab, idx_rel, win, ws=ws, we=we,
                                  with_gradient=with_gradient, upwind=upwind)
    n, feat = state.shape
    agg = torch.empty_like(state)
    vectorized = vector_layout(feat, (state, s_tab, agg))
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _kernels()["fwd"](
            state.data_ptr(), idx_rel.data_ptr(), win.data_ptr(), _widths(ws), we,
            s_tab.data_ptr(), agg.data_ptr(), n, feat, idx_rel.shape[1],
            DTYPE_CODES[state.dtype], vectorized, int(with_gradient), int(upwind), stream)
    check_launch(rc, "band hop")
    launches += 1
    launches_by_shape["band_hop", n, n] += 1
    return agg


def band_hop_reference(state: torch.Tensor, s_tab: torch.Tensor, idx_rel: torch.Tensor,
                       win: torch.Tensor, *, ws, we: int = 0, with_gradient: bool = True,
                       upwind: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (band_hop.py:466-489 with
    the ELL hop's arithmetic): the plan decoded to source rows, then
    ``ops.hop.hop_reference``."""
    n, feat = state.shape
    src = band_sources(idx_rel, win, ws, we)
    return hop_reference(state, state, src, s_tab.view(n, src.shape[1], feat),
                         with_gradient, upwind)


def band_hop_backward(state: torch.Tensor, s_tab: torch.Tensor, idx_rel: torch.Tensor,
                      win: torch.Tensor, g: torch.Tensor, out_ptr: torch.Tensor,
                      out_slots: torch.Tensor, *, ws, we: int = 0,
                      with_gradient: bool = True, upwind: bool = False):
    """Gradients of one banded hop for the upstream gradient ``g [N, F]`` ->
    ``(gstate [N, F]`` in the state dtype, summed in float32, ``gs [N, D*F]``
    in the flux dtype). CUDA tensors go through the kernel, CPU tensors
    through ``band_hop_backward_reference``."""
    global bwd_launches
    _check(state, s_tab, idx_rel, win, ws, we)
    n, feat = state.shape
    if g.shape != state.shape or g.dtype != state.dtype or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {tuple(state.shape)} {state.dtype} tensor")
    if out_ptr.shape != (n + 1,) or out_ptr.dtype != torch.int32 \
            or out_slots.dtype != torch.int32:
        raise ValueError(f"out_ptr must be [{n + 1}] int32 and out_slots int32")
    if any(t.device != state.device for t in (g, out_ptr, out_slots)):
        raise ValueError("all band hop inputs must be on one device")
    if state.device.type == "cpu":
        return band_hop_backward_reference(state, s_tab, idx_rel, win, g, out_ptr, out_slots,
                                           ws=ws, we=we, with_gradient=with_gradient,
                                           upwind=upwind)
    gs = torch.empty_like(s_tab)
    gstate = torch.empty_like(state)
    vectorized = vector_layout(feat, (state, s_tab, g, gs, gstate))
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _kernels()["bwd"](
            state.data_ptr(), idx_rel.data_ptr(), win.data_ptr(), _widths(ws), we,
            s_tab.data_ptr(), g.data_ptr(), out_ptr.data_ptr(), out_slots.data_ptr(),
            gs.data_ptr(), gstate.data_ptr(), n, feat, idx_rel.shape[1],
            DTYPE_CODES[state.dtype], vectorized, int(with_gradient), int(upwind), stream)
    check_launch(rc, "band hop backward")
    bwd_launches += 1
    launches_by_shape["band_hop_bwd", n, n] += 1
    return gstate, gs


def band_hop_backward_reference(state: torch.Tensor, s_tab: torch.Tensor,
                                idx_rel: torch.Tensor, win: torch.Tensor, g: torch.Tensor,
                                out_ptr: torch.Tensor, out_slots: torch.Tensor, *, ws,
                                we: int = 0, with_gradient: bool = True,
                                upwind: bool = False):
    """Plain PyTorch version of the backward kernel: the plan decoded to
    source rows, then ``ops.hop.hop_backward_reference`` of the same-block
    hop."""
    n, feat = state.shape
    src = band_sources(idx_rel, win, ws, we)
    gstate, _, gs = hop_backward_reference(state, state, src,
                                           s_tab.view(n, src.shape[1], feat), g, out_ptr,
                                           out_slots, with_gradient, upwind)
    return gstate, gs.reshape(n, -1)
