"""Build and load the port's CUDA kernels.

Each library is one ``csrc/<name>.cu`` source (plus the shared header
``csrc/hop_common.cuh``) with a plain C interface, compiled by ``nvcc`` for
sm_90a into ``BUILD_DIR`` (listed in ``.gitignore``) and loaded with
``ctypes``. A library is rebuilt when its source, the header or the flags
change (the file name carries their hash). ``build`` starts one ``nvcc`` a
source, all at once, and waits for them together. ``keyed_path`` and
``compile_libraries`` serve any compiler: ``native.py`` builds the mesh core
with them. Given another source
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


def keyed_path(stem: str, files, flags, build_dir: Path) -> Path:
    """``build_dir/lib<stem>_<hash>.so``: the hash covers the bytes of
    ``files`` and the ``flags``, so a changed source, header or flag names
    another file and is rebuilt."""
    digest = hashlib.sha256()
    for f in files:
        digest.update(Path(f).read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def compile_libraries(jobs: dict, build_dir: Path, what: str) -> dict:
    """Builds every job ``{name: (compiler, flags, sources, path)}`` whose
    ``path`` does not exist yet: one compiler process a job, all started
    together, each writing a temporary file in ``build_dir`` that replaces
    ``path`` atomically once it built (a concurrent build never sees half a
    file). ``compiler`` is a callable that gives the compiler's path, called
    only when the job is built. Returns ``{name: {"path", "seconds",
    "log"}}``; ``log`` is the compiler's output, kept beside the library for
    a later call. Raises ``"<what> build failed"`` with the output of every
    failed build."""
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    running, out = {}, {}
    try:
        for name, (compiler, flags, sources, lib) in jobs.items():
            if lib.exists():
                log_file = lib.with_suffix(".log")
                out[name] = {"path": str(lib), "seconds": 0.0,
                             "log": log_file.read_text() if log_file.exists() else ""}
                continue
            argv = [compiler(), *flags]
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            proc = subprocess.Popen([*argv, "-o", tmp, *map(str, sources)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running[name] = (proc, tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: {Path(proc.args[0]).name} exit code "
                              f"{proc.returncode}\n{log}")
                continue
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
            out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    return keyed_path(name, [source(name, csrc_dir),
                             *(Path(csrc_dir) / header for header in HEADERS)],
                      NVCC_FLAGS, BUILD_DIR)


def build(*names: str, csrc_dir: Path = CSRC_DIR) -> dict:
    """Compile the named libraries (default: all), one ``nvcc`` each, in
    parallel, from ``csrc_dir`` (``compile_libraries``). ``log`` holds
    ``-Xptxas -v``'s registers, stack frame and spills of every
    instantiation. Raises if any build fails."""
    return compile_libraries(
        {name: (_nvcc, NVCC_FLAGS, [source(name, csrc_dir)], library_path(name, csrc_dir))
         for name in names or LIBRARIES}, BUILD_DIR, "kernel")


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if it is not (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name)[name]["path"])
        return _loaded[name]
