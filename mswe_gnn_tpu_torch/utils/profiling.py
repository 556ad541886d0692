"""Timing and tracing helpers (port of mswe_gnn_tpu/utils/profiling.py).

``timed`` gives the wall time of a call with the device finished: the JAX
package forces a one-element readback of a jitted reduction, since
``block_until_ready`` may not synchronize on its remote backends; the port
synchronizes the CUDA device of the result after each call
(``torch.cuda.synchronize``), and a result on the CPU is timed by the host
clock alone. ``edge_message_throughput`` is the north-star unit
(edge messages a second a device). ``trace`` records a ``torch.profiler``
trace (CPU activity, and CUDA activity where a GPU is visible) and writes it
as a Chrome trace, where JAX writes a ``jax.profiler`` trace.

A deliberate difference: JAX's ``trace`` swallows every failure of its
tracer and runs the body untraced; here a failure to trace or to write the
trace raises, so that a missing trace is never mistaken for a traced run.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Set

import torch

from mswe_gnn_tpu_torch import tree_leaves


def _cuda_devices(result) -> Set[torch.device]:
    """The CUDA devices of the tensors of ``result`` (a tensor or a tree)."""
    return {t.device for t in tree_leaves(result) if t.is_cuda}


def _finish(result) -> None:
    """Waits for the CUDA devices of ``result``; a result that holds no
    tensor (a training epoch) waits for the current device where CUDA is in
    use."""
    if not tree_leaves(result):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for device in _cuda_devices(result):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> Dict[str, float]:
    """Wall time of ``fn(*args)`` (JAX profiling.py:21-38): ``warmup`` calls,
    then ``reps`` timed ones, each ending when the devices of its result
    have finished -> ``median_s``, ``min_s`` and ``mean_s``. ``fn`` returns
    a tensor, a tree of tensors or nothing."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
        _finish(result)
    times = []
    for _ in range(reps):
        _finish(result)
        t0 = time.perf_counter()
        result = fn(*args)
        _finish(result)
        times.append(time.perf_counter() - t0)
    return {"median_s": float(statistics.median(times)), "min_s": float(min(times)),
            "mean_s": float(statistics.fmean(times))}


def edge_message_throughput(messages_per_call: int, seconds: float) -> float:
    """North-star metric: processed edge messages per second per device."""
    return messages_per_call / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the body, written on exit to
    ``<log_dir>/trace_<pid>_<ms>.json`` (Chrome trace format; open it in
    Perfetto or ``chrome://tracing``). Yields the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
