"""One module an architecture, named by the configuration's
``"architecture"`` key and found as ``<root>/architectures/<name>.py``
(``run.architecture``). A module gives:

- ``Reference``: a subclass of ``reference.model.Reference`` whose
  ``forward`` is the architecture's plain float32 forward pass (and whose
  ``only_finest`` says whether the loss counts the finest scale alone);
- ``forward_flops(model, shapes, static_in, dynamic_in, edge_in)``: the
  FLOPs of one forward model step of one graph (``counts.shapes`` of its
  mesh, the widths of its inputs);
- ``KERNELS``: for each family of hand-written kernels the architecture
  launches, the kernel-name substrings a trace matches;
- ``kernel_bytes(model, shapes, train)``: for each such family the bytes one
  model step of one graph needs, forward (and backward with ``train``), each
  input read once and each output written once (the byte bound).

Each raises for a model dict it does not describe.
"""
