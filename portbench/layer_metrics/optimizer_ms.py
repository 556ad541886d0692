"""Device ms a train step in the optimizer (``mswe.train.optimizer``: the
gradient clip and AdamW), from the port's span table over the traced
slice. None where the port has no such span."""
from portbench.layer_metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "mswe.train.optimizer")
