"""Build and load the port's CUDA kernels.

Each library is one ``csrc/<name>.cu`` source (plus the shared header
``csrc/hop_common.cuh``) with a plain C interface, compiled by ``nvcc`` for
sm_90a into ``BUILD_DIR`` (listed in ``.gitignore``) and loaded with
``ctypes``. A library is rebuilt when its source, the header or the flags
change (the file name carries their hash). ``build`` starts one ``nvcc`` a
source, all at once, and waits for them together. Given another source
directory (another checkout's ``csrc/``), it builds that version beside the
shipped one, for comparisons on the card (``kernel_ab.py``).

Nothing is built or loaded at import: the machine without a GPU has no
``nvcc``, and the tests import every module.
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

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIBRARIES = ("hop", "band_hop")          # csrc/<name>.cu
HEADERS = ("hop_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def source(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r}; options: {LIBRARIES}")
    return Path(csrc_dir) / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the kernels are compiled from "
                       f"{CSRC_DIR.name}/ on the machine that has the GPU")


def library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    digest = hashlib.sha256(source(name, csrc_dir).read_bytes())
    for header in HEADERS:
        digest.update((Path(csrc_dir) / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str, csrc_dir: Path = CSRC_DIR) -> dict:
    """Compile the named libraries (default: all), one ``nvcc`` each, in
    parallel, from ``csrc_dir``. Returns ``{name:
    {"path", "seconds", "log"}}``; ``log`` holds the compiler's output
    (``-Xptxas -v``: registers, stack frame and spills of every
    instantiation), kept beside the library for a later call. Raises if
    any build fails."""
    names = names or LIBRARIES
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running, out = {}, {}
    try:
        for name in names:
            lib = library_path(name, csrc_dir)
            if lib.exists():
                log_file = lib.with_suffix(".log")
                out[name] = {"path": str(lib), "seconds": 0.0,
                             "log": log_file.read_text() if log_file.exists() else ""}
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                     str(source(name, csrc_dir))],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running[name] = (proc, tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit code {proc.returncode}\n{log}")
                continue
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)      # atomic: a concurrent build never sees half a file
            out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if it is not (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name)[name]["path"])
        return _loaded[name]
