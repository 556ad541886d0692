"""Device ms a train step in the MeshGraphNets blocks' sums of the edge updates
into their receivers (``mswe.mgn.aggregate``: the in-edge ELL gather and the
masked slot sum), in the forward and again in the remat recompute inside the
backward, summed over the blocks, from the port's span table over the traced
slice. None where the port has no such span."""
from portbench.layer_metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "mswe.mgn.aggregate")
