"""Data and graph parallelism of the port (port of mswe_gnn_tpu/parallel/),
driven by one controller a process over a grid of devices.

- ``sharding``: the ``[n_data, n_graph]`` grid of devices (``make_mesh``),
  the JAX package's partition specs of a batch, and the placement of a
  batch on the grid (``shard_batch``, ``shard_union_batch``).
- ``gspmd``: a model over one mesh row, its node rows in row blocks that
  hop against the gathered state on the ELL hop kernel.
- ``dist_swegnn``: host-side ring plans and the per-partition SWEGNN / MSGNN
  forwards, whose hops run the ELL hop kernel on each partition's block.
- ``dist_train``: the ring MSGNN packaged as an ``apply_fn`` for the trainer,
  the rollout and the evaluation.
- ``halo``: edge-partitioned aggregation (all-gather and ring variants).
"""
