"""Per-layer metric readers, one file a metric family. The harness reads
the metric ``<family>.<variant>`` (or ``<family>``) with
``layer_metrics/<family>.py``'s ``read(ctx)``, which returns a number or
None where the run has nothing for it to read (the metric is then left out
of the result line).

``ctx`` holds: ``mode`` and ``batch`` of the cell; ``units`` (rollouts or
train steps) traced and ``model_steps_per_unit``; ``device`` and ``host``,
the traced slice's ``(name, start_us, end_us)`` events; ``unit_s``, the
untraced window's seconds a unit; ``cfg``, the configuration; ``shapes``,
``counts.shapes`` of its mesh; ``arch``, its architecture's module (whose
``KERNELS`` name each kernel family's kernels); ``flops_per_unit`` (the
module's ``forward_flops``) and ``peak_flops``; ``kernel_bytes_per_unit``,
the bytes a unit of each kernel family (the module's ``kernel_bytes``), and
``hbm_bytes_per_s``; ``hop_kernels`` and ``hop_bytes_per_unit``, the
``"hop"`` family's (empty and None without one); ``graph_build_s``.

So the roofline share of a new architecture's kernels is a new file here
that reads ``kernel_bytes_per_unit`` and ``arch.KERNELS`` of its family.
"""
