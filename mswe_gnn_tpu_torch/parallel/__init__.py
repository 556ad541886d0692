"""Graph parallelism of the port (port of mswe_gnn_tpu/parallel/): the ring-halo
path over a list of partition devices, driven from one process.

- ``sharding.make_mesh``: the ``[n_data, n_graph]`` grid of devices.
- ``dist_swegnn``: host-side ring plans and the per-partition SWEGNN / MSGNN
  forwards, whose hops run the ELL hop kernel on each partition's block.
- ``dist_train``: the ring MSGNN packaged as an ``apply_fn`` for the trainer,
  the rollout and the evaluation.
- ``halo``: edge-partitioned aggregation (all-gather and ring variants).
"""
