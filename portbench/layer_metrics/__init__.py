"""Per-layer metric readers, one file a metric family. The harness reads
the metric ``<family>.<variant>`` (or ``<family>``) with
``layer_metrics/<family>.py``'s ``read(ctx)``, which returns a number or
None where the run has nothing for it to read (the metric is then left out
of the result line).

``ctx`` holds: ``mode`` and ``batch`` of the cell; ``units`` (rollouts or
train steps) traced and ``model_steps_per_unit``; ``device`` and ``host``,
the traced slice's ``(name, start_us, end_us)`` events; ``unit_s``, the
untraced window's seconds a unit; ``flops_per_unit``, ``peak_flops``,
``hop_bytes_per_unit``, ``hbm_bytes_per_s``, ``hop_kernels`` (from
``counts.py``); ``graph_build_s``.
"""
