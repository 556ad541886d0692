"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activities) around a few more units after the untraced window, reduced
to device intervals and host operations, their union (the device's busy
time), and the breakdown the result line carries.
"""
from __future__ import annotations

import bisect
import collections
import time


def profile_units(run_unit, first: int, n: int, sync) -> dict:
    """Units ``first .. first+n-1`` under the profiler -> ``{"device":
    [(name, start_us, end_us)], "host": [...], "wall_s"}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            run_unit(i)
        sync()
        wall = time.perf_counter() - t0
    device, host = [], []
    for evt in prof.events():
        item = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    return {"device": device, "host": host, "wall_s": wall}


def merged(intervals) -> list:
    """Sorted, overlapping ``(start, end)`` intervals merged."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_us(device) -> float:
    return sum(e - s for s, e in merged((s, e) for _, s, e in device))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def breakdown(sl: dict, top: int = 10) -> dict:
    """The device operations with the most time, and the idle gaps between
    device work summed by the innermost host operation (not a CUDA runtime
    call) running when each gap began, in seconds."""
    per_op = collections.Counter()
    for name, s, e in sl["device"]:
        per_op[name] += (e - s) * 1e-6
    busy = merged((s, e) for _, s, e in sl["device"])
    host = sorted((s, e, n) for n, s, e in sl["host"] if not n.startswith("cuda"))
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        label, best = "(no host op)", None
        i = bisect.bisect_right(starts, end)
        # the innermost host op open at the gap's start: scan back a bounded way
        for s, e, n in reversed(host[max(0, i - 64):i]):
            if e >= end and (best is None or e - s < best):
                label, best = n, e - s
        gaps[label] += (nxt - end) * 1e-6
    return {"device_ops": [[n, v] for n, v in per_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}
