"""Where the port keeps its compiled code (counterpart of
mswe_gnn_tpu/cache.py, the JAX package's persistent XLA compilation cache).

JAX compiles every jitted function, and its cache keeps the compiles on disk
so that a later process reuses them. The port has no JIT: its only compiles
are the CUDA kernels (``nvcc``, ``ops/build.py``) and the mesh core (``g++``,
``native.py``), each a shared library whose file name carries a hash of its
sources and flags (``ops/build.py::keyed_path``). A library found there is
loaded, not built again, so that directory is the port's compilation cache,
and ``enable_compilation_cache`` chooses where it lives, as JAX's chooses
its cache's directory. Call it at program start (``main.py`` does); a
library already loaded in this process stays loaded.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV = "MSWE_TORCH_CACHE"
DEFAULT_DIR = Path(__file__).resolve().parent / "_build"


def enable_compilation_cache(cache_dir: Optional[str] = None) -> Path:
    """Build and load the kernels and the mesh core in ``cache_dir``, else
    in ``$MSWE_TORCH_CACHE``, else in ``mswe_gnn_tpu_torch/_build/`` ->
    the directory (created at the first build)."""
    from mswe_gnn_tpu_torch import native
    from mswe_gnn_tpu_torch.ops import build

    path = Path(cache_dir or os.environ.get(ENV) or DEFAULT_DIR).resolve()
    build.BUILD_DIR = path
    native.BUILD_DIR = path
    return path
