"""Host seconds the port spent building ELL slot tables
(``mswe.graph.slot_tables``: the three ``build_edge_slot_table`` calls of
each ``build_flood_graph``), all of it in set-up, from the port's span
table. None where the port has no such span."""
from portbench.layer_metrics._spans import span_row


def read(ctx):
    row = span_row("mswe.graph.slot_tables")
    return row["host_s"] if row is not None else None
