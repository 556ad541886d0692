"""Device ms a train step in the MeshGraphNets blocks' node updates
(``mswe.mgn.node_update``: the node MLP and its LayerNorm, and both residual
adds), in the forward and again in the remat recompute inside the backward,
summed over the blocks, from the port's span table over the traced slice.
None where the port has no such span."""
from portbench.layer_metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "mswe.mgn.node_update")
