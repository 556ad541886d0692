"""Blocking reads of the device a model step: the port's ``mswe.sync.*``
spans in the traced slice's host events, each weighted by the times its
site blocks, over the slice's model steps. None where the port has no
spans."""
from portbench.layer_metrics._spans import SYNC, has_spans, sync_weight


def read(ctx):
    if not has_spans(ctx["host"]):
        return None
    syncs = sum(sync_weight(name) for name, _, _ in ctx["host"] if name.startswith(SYNC))
    return syncs / (ctx["units"] * ctx["model_steps_per_unit"])
