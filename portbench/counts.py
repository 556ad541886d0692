"""What every architecture's counts share: the H100's published peaks,
the bytes of an element, the FLOPs of an MLP and the real shapes of a graph.
Each architecture's module (``architectures/<name>.py``) counts the FLOPs
of one forward model step (``forward_flops``) and the bytes each of its
kernel families needs (``kernel_bytes``): the yardstick of the per-layer
metrics ``model_mfu`` and ``<kernel>_roofline``. A train step counts three
forward passes a model step (forward and backward); recomputation (remat)
is not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def mlp_flops(rows: int, sizes) -> int:
    return sum(2 * rows * fi * fo for fi, fo in sizes)


def mlp_sizes(fan_in: int, fan_out: int, hidden: int, layers: int):
    if layers == 1:
        return [(fan_in, fan_out)]
    return [(fan_in, hidden)] + [(hidden, hidden)] * (layers - 2) + [(hidden, fan_out)]


def shapes(mesh: dict) -> dict:
    """Real nodes and edges of each scale, and transfer edges of each
    level, of one graph of the raw mesh (``reference/inputs.py``)."""
    return {"nodes": [len(m["area"]) for m in mesh["meshes"]],
            "edges": [m["edge_index"].shape[1] for m in mesh["meshes"]],
            "intra": [t.shape[1] for t in mesh["intra"]]}
