"""The hop kernels' share of their byte bound, in %: the least time the
hops of a unit need (the architecture's ``kernel_bytes``, family ``"hop"``,
at the card's HBM bandwidth) over the device time of the kernels its
``KERNELS["hop"]`` names in the traced slice, a unit. None when no such
kernel ran."""


def read(ctx):
    hop_us = sum(e - s for name, s, e in ctx["device"]
                 if any(k in name for k in ctx["hop_kernels"]))
    if not hop_us:
        return None
    bound_s = ctx["hop_bytes_per_unit"] / ctx["hbm_bytes_per_s"]
    return 100.0 * bound_s / (hop_us * 1e-6 / ctx["units"])
