"""The device's idle share of a unit, in %: one minus the union of the
device intervals of the traced slice, a unit, over the untraced window's
seconds a unit."""
from portbench.trace import busy_us


def read(ctx):
    busy = busy_us(ctx["device"])
    if not busy:
        return None
    return 100.0 * (1.0 - busy * 1e-6 / ctx["units"] / ctx["unit_s"])
