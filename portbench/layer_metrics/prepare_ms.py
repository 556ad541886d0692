"""Device ms a unit in the port's graph preparation (``mswe.prepare_graph``:
the ELL cache, with the out-slot tables when training), from the port's
span table over the traced slice. None where the port has no such span."""
from portbench.layer_metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "mswe.prepare_graph")
