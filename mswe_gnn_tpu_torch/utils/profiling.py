"""Timing and tracing helpers (port of mswe_gnn_tpu/utils/profiling.py).

``timed`` gives the wall time of a call with the device finished: the JAX
package forces a one-element readback of a jitted reduction, since
``block_until_ready`` may not synchronize on its remote backends; the port
synchronizes the CUDA device of the result after each call
(``torch.cuda.synchronize``), and a result on the CPU is timed by the host
clock alone. ``trace`` records a ``torch.profiler`` trace (CPU activity,
and CUDA activity where a GPU is visible) and writes it as a Chrome trace,
where JAX writes a ``jax.profiler`` trace.

``span(name)`` marks a layer boundary of the port (the JAX package has no
spans). Every span adds its count and host seconds (``perf_counter_ns``)
to this process's table, with no list of events and no exporter. Only
while a ``torch.profiler`` session records in this process does a span do
more: it opens a host event of its name on the profiler's clock, so that a
trace of the body carries it, and on a CUDA device (not while the current
stream is being captured into a CUDA graph) it records a pair of timing
events on the current stream, whose elapsed time becomes the span's device
seconds when the table is read, never inside the traced work.
``span_table()`` reads the table and ``reset_spans()`` clears it. Each
thread keeps its own stack of open spans: a span's self device seconds are
its device seconds less those of the spans opened inside it on its thread.

Names start with ``mswe.``. A span ``mswe.sync.<site>`` closes around a
blocking read of the device (or a blocking copy); ``count`` is the number
of times the site blocks, and its host event is named ``<name>*<count>``
where that is more than one.

The host event is a function-scope record (``_RecordFunctionFast``), not
``torch.profiler.record_function``: the latter's user scope also puts a
``gpu_user_annotation`` interval of the same name on the device timeline,
which a reader of device intervals would take for a kernel.

A deliberate difference: JAX's ``trace`` swallows every failure of its
tracer and runs the body untraced; here a failure to trace or to write the
trace raises, so that a missing trace is never mistaken for a traced run.
"""
from __future__ import annotations

import collections
import contextlib
import os
import statistics
import threading
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


SYNC = "mswe.sync."

_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Thread:
    """One thread's open spans and its rows: per name ``[count, host_ns]``."""

    __slots__ = ("stack", "rows")

    def __init__(self):
        self.stack: list = []
        self.rows: Dict[str, list] = {}


class _Spans:
    """The process's span table: each thread's rows, the device seconds
    read so far (per name ``[device_s, self_device_s]``) and the traced
    spans not read yet, ``(name, traced parent's name or None, start event,
    end event)``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.threads: list = []
        self.device: Dict[str, list] = {}
        self.pending: collections.deque = collections.deque()

    def mine(self) -> _Thread:
        try:
            return self.local.state
        except AttributeError:
            state = self.local.state = _Thread()
            with self.lock:
                self.threads.append(state)
            return state


_spans = _Spans()


class span:
    """``with span(name[, count]):`` the body as one span of ``name`` (see
    the module's docstring); ``count`` is what it adds to the name's count."""

    __slots__ = ("name", "count", "_t0", "_state", "_parent", "_record", "_events")

    def __init__(self, name: str, count: int = 1):
        self.name = name
        self.count = count

    def __enter__(self):
        try:
            state = _spans.local.state
        except AttributeError:
            state = _spans.mine()
        self._state = state
        stack = state.stack
        self._parent = stack[-1] if stack else None
        stack.append(self)
        self._record = self._events = None
        if _profiling():
            self._trace()
        self._t0 = _clock()
        return self

    def _trace(self) -> None:
        label = self.name if self.count == 1 else f"{self.name}*{self.count}"
        self._record = torch._C._profiler._RecordFunctionFast(label)
        self._record.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, torch.cuda.Event(enable_timing=True))

    def __exit__(self, exc_type, exc, tb) -> None:
        host_ns = _clock() - self._t0
        state = self._state
        state.stack.pop()
        row = state.rows.get(self.name)
        if row is None:
            row = state.rows[self.name] = [0, 0]
        row[0] += self.count
        row[1] += host_ns
        if self._record is not None:
            self._untrace()

    def _untrace(self) -> None:
        if self._events is not None:
            self._events[1].record()
            parent = self._parent
            _spans.pending.append((self.name, parent.name if parent is not None
                                   and parent._events is not None else None, *self._events))
        self._record.__exit__(None, None, None)


def open_spans() -> list:
    """The names of the spans open on this thread, outermost first."""
    return [s.name for s in _spans.mine().stack]


def span_table() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``host_s``, ``device_s`` and
    ``self_device_s`` (device seconds exist only for spans closed while a
    profiler recorded; reading them waits for the device)."""
    with _spans.lock:
        device = _spans.device
        while _spans.pending:
            name, parent, start, end = _spans.pending.popleft()
            end.synchronize()
            seconds = start.elapsed_time(end) * 1e-3
            row = device.setdefault(name, [0.0, 0.0])
            row[0] += seconds
            row[1] += seconds
            if parent is not None:
                device.setdefault(parent, [0.0, 0.0])[1] -= seconds
        table: Dict[str, Dict[str, float]] = {}
        for state in _spans.threads:
            for name, (count, host_ns) in list(state.rows.items()):
                row = table.setdefault(name, {"count": 0, "host_s": 0.0})
                row["count"] += count
                row["host_s"] += host_ns * 1e-9
        for name, row in table.items():
            row["device_s"], row["self_device_s"] = device.get(name, (0.0, 0.0))
        return table


def reset_spans() -> None:
    """Clears the span table (a span open now still counts when it closes)."""
    with _spans.lock:
        for state in _spans.threads:
            state.rows.clear()
        _spans.device.clear()
        _spans.pending.clear()
