"""The whole step's share of the card's dense peak for the configuration's
compute dtype, in %: the FLOPs a unit needs (the architecture's
``forward_flops``, three forward passes a train step) over the untraced
window's seconds a unit."""


def read(ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
