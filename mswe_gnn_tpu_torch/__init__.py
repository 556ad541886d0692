"""mswe_gnn_tpu_torch — the mSWE-GNN flood surrogate in PyTorch, for an
NVIDIA H100.

A port of the JAX package ``mswe_gnn_tpu`` beside it, which stays the
reference the port is tested against. Host-side graph building is numpy, the
models are plain functions on tensors, and the SWE-GNN hop runs in a CUDA
kernel written for Hopper (``ops/csrc/hop.cu``). This package imports torch,
numpy and the standard library only.

Entry points (``models.build_model``, ``training.rollout.rollout``) run on
the GPU unless the caller passes ``device="cpu"``; without a GPU and without
a device they raise.
"""
import torch

NUM_WATER_VARS = 2  # water depth h and unit-discharge magnitude |q|


def tree_to(tree, device):
    """A tree of tensors (nested dicts, lists and tuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the GPU.

    There is no silent CPU fallback: with no GPU and no ``device`` this
    raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")
