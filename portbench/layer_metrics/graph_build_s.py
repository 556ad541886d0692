"""Seconds the port's data and graph layers took to build the cell's
inputs in set-up (``process_record``, ``to_temporal_samples``,
``concat_graphs``, the copy to the card), by the harness's clock around its
calls into them."""


def read(ctx):
    return ctx["graph_build_s"]
