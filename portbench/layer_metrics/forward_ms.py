"""Device ms a train step in the pushforward loss (``mswe.train.forward``),
its self time: less the graph preparation inside it, which ``prepare_ms``
reads. From the port's span table over the traced slice; None where the
port has no such span."""
from portbench.layer_metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "mswe.train.forward", "self_device_s")
