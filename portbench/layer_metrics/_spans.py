"""What the span readers share: the port's spans (``mswe.*``, from
``mswe_gnn_tpu_torch.utils.profiling``) in the traced slice's host events,
and the port's span table. A program without spans gives neither: the
readers then return None."""
SYNC = "mswe.sync."


def sync_weight(name: str) -> int:
    """A sync span's host event is ``mswe.sync.<site>`` or, for a site that
    blocks k > 1 times, ``mswe.sync.<site>*k``."""
    return int(name.rpartition("*")[2]) if "*" in name else 1


def has_spans(host) -> bool:
    return any(name.startswith("mswe.") for name, _, _ in host)


def span_row(name: str):
    """The span table's row of ``name`` (count, host_s, device_s,
    self_device_s), or None where the port keeps no table or no such span."""
    from mswe_gnn_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", None)
    return table().get(name) if table is not None else None


def device_ms_per_unit(ctx, name: str, key: str = "device_s"):
    """Device ms a unit in span ``name`` over the traced slice (the only
    spans timed on the device), or None where none was timed."""
    row = span_row(name)
    if row is None or not row[key] > 0:
        return None
    return 1e3 * row[key] / ctx["units"]
