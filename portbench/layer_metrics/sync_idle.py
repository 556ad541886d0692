"""The share of the traced slice's device-idle time, in %, spent in gaps
that begin while the host is inside one of the port's ``mswe.sync.*``
spans: a gap is the time between two merged device intervals, and it is
put down to a sync when its start lies in a sync span's interval (found by
a search over every sync span, not a bounded scan back). None where the
port has no spans or the device was never idle."""
import bisect

from portbench.layer_metrics._spans import SYNC, has_spans
from portbench.trace import merged


def read(ctx):
    if not has_spans(ctx["host"]):
        return None
    syncs = merged((s, e) for name, s, e in ctx["host"] if name.startswith(SYNC))
    starts = [s for s, _ in syncs]
    busy = merged((s, e) for _, s, e in ctx["device"])
    idle = in_sync = 0.0
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        idle += nxt - end
        i = bisect.bisect_right(starts, end) - 1
        if i >= 0 and end <= syncs[i][1]:
            in_sync += nxt - end
    return 100.0 * in_sync / idle if idle else None
