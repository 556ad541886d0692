"""The device mesh of the port's graph-parallel path (port of
``make_mesh`` in mswe_gnn_tpu/parallel/sharding.py:27-32).

The JAX package lays its devices out as a ``Mesh`` with axes ``("data",
"graph")``. The port runs the ring-halo path from one process over a plain
list of devices, so its mesh is an ``[n_data, n_graph]`` grid of
``torch.device``s: row ``d`` is the ring of data replica ``d``. A list given
by the caller may repeat a device, the counterpart of the JAX package's
virtual CPU mesh: eight partitions on one card, or on the CPU.

The rest of the JAX module (``batch_sharding``, ``global_put``,
``shard_batch``, ``union_sharding``: the GSPMD data x graph sharding) is not
ported; the port raises where a config asks for it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def make_mesh(n_data: int, n_graph: int = 1,
              devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """``[n_data][n_graph]`` devices, filled row by row from ``devices``
    (default: every visible CUDA device). Raises when there are fewer than
    ``n_data * n_graph``, as the JAX package asserts."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_data * n_graph
    if n < 1:
        raise ValueError(f"a mesh of {n_data} x {n_graph} devices")
    if len(devices) < n:
        raise ValueError(f"need {n} devices for a {n_data} x {n_graph} mesh, "
                         f"have {len(devices)}")
    return [devices[r * n_graph:(r + 1) * n_graph] for r in range(n_data)]
