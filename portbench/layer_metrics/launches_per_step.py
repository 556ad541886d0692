"""GPU kernels launched a model step: kernels (not copies or fills) in the
traced slice over its model steps."""
from portbench.trace import is_kernel


def read(ctx):
    kernels = sum(1 for name, _, _ in ctx["device"] if is_kernel(name))
    steps = ctx["units"] * ctx["model_steps_per_unit"]
    return kernels / steps if kernels and steps else None
