"""The SWE-GNN hop: a CUDA kernel for Hopper and its plain PyTorch version.

One hop of the SWEGNN node update on ELL (padded neighbour-table) slots:

    agg[n] = sum_d act(n,d) * (dst[n] - src[src_tab[n,d]]) * s_tab[n,d]
    act(n,d) = rowsum(src[src_tab[n,d]]) != 0  OR  rowsum(dst[n]) != 0

with an upwind mode (the difference clamped at 0) and a no-gradient mode
(``s_tab[n,d] * src[src_tab[n,d]]``). ``src`` is ``dst`` itself for a
same-block hop and the constant coarse block for an un-pooling hop.

The kernel (``csrc/hop.cu``) replaces the TPU kernel
``mswe_gnn_tpu/ops/pallas_hop.py::_hop_kernel``; the source says what bounds
it and how it is laid out. It is built with ``nvcc`` on first use into
``BUILD_DIR`` (listed in ``.gitignore``) as a plain-C shared library and
called through ``ctypes`` on PyTorch's current stream.

``hop`` runs the kernel for CUDA tensors and ``hop_reference`` for CPU
tensors; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc" / "hop.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNKS = 128       # 32 lanes x 4 chunks a lane (hop_kernel's CPL <= 4)

launches = 0            # kernel launches; reset with reset_launches()

_lock = threading.Lock()
_launch_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the hop kernel is compiled from "
                       f"{CSRC.name} on the machine that has the GPU")


def build() -> dict:
    """Compile ``csrc/hop.cu`` for sm_90a, once per source and flag set.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds the compiler's
    output (``-Xptxas -v``: registers and spills of every instantiation)."""
    tag = hashlib.sha256(CSRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhop_{tag}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": "already built"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)      # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def _kernel():
    global _launch_fn
    with _lock:
        if _launch_fn is None:
            fn = ctypes.CDLL(build()["path"]).mswe_hop_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _launch_fn = fn
        return _launch_fn


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
    if dst_state.dtype not in _DTYPE_CODES:
        raise ValueError(f"state dtype must be float32 or bfloat16, got {dst_state.dtype}")
    if src_state.dtype != dst_state.dtype or s_tab.dtype != dst_state.dtype:
        raise ValueError("dst_state, src_state and s_tab must share one dtype")
    tensors = (dst_state, src_state, src_tab, s_tab)
    if any(t.device != dst_state.device for t in tensors):
        raise ValueError("all hop inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hop inputs must be contiguous")


def hop(dst_state: torch.Tensor, src_state: torch.Tensor, src_tab: torch.Tensor,
        s_tab: torch.Tensor, with_gradient: bool = True,
        upwind: bool = False) -> torch.Tensor:
    """One hop -> ``agg [Nd, F]`` in the state dtype.

    ``dst_state [Nd, F]``, ``src_state [Ns, F]`` (the same tensor for a
    same-block hop), ``src_tab [Nd, D]`` int32 rows of ``src_state``,
    ``s_tab [Nd, D, F]`` flux with the slot mask folded in. CUDA tensors go
    through the kernel, CPU tensors through ``hop_reference``.
    """
    global launches
    _check(dst_state, src_state, src_tab, s_tab)
    device = dst_state.device
    if device.type == "cpu":
        return hop_reference(dst_state, src_state, src_tab, s_tab,
                             with_gradient, upwind)
    if device.type != "cuda":
        raise ValueError(f"hop runs on cuda or cpu tensors, got {device}")
    n_dst, feat = dst_state.shape
    agg = torch.empty_like(dst_state)
    if n_dst == 0:
        return agg
    per_16_bytes = 16 // dst_state.element_size()
    vectorized = feat % per_16_bytes == 0 and all(
        t.data_ptr() % 16 == 0 for t in (dst_state, src_state, s_tab, agg))
    chunks = feat // per_16_bytes if vectorized else feat
    if chunks > _MAX_CHUNKS:
        raise ValueError(f"feature width {feat} is wider than the kernel takes")
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(dst_state.data_ptr(), src_state.data_ptr(), src_tab.data_ptr(),
                s_tab.data_ptr(), agg.data_ptr(), n_dst, src_state.shape[0], feat,
                src_tab.shape[1], _DTYPE_CODES[dst_state.dtype], int(vectorized),
                int(with_gradient), int(upwind), stream)
    if rc != 0:
        raise RuntimeError(f"hop kernel launch failed with CUDA error {rc}")
    launches += 1
    return agg


def hop_reference(dst_state: torch.Tensor, src_state: torch.Tensor,
                  src_tab: torch.Tensor, s_tab: torch.Tensor,
                  with_gradient: bool = True, upwind: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same wet-front predicate (a
    float32 row sum != 0), the D terms added in float32 in slot order, one
    rounding to the state dtype at the end."""
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
