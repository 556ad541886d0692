"""mswe_gnn_tpu_torch — the mSWE-GNN flood surrogate in PyTorch, for an
NVIDIA H100.

A port of the JAX package ``mswe_gnn_tpu`` beside it, which stays the
reference the port is tested against. Host-side graph building is numpy, the
models are plain functions on tensors, and the SWE-GNN hop and its gradient
run in CUDA kernels written for Hopper (``ops/csrc/``: the ELL hop and the
banded hop, forward and backward); triangulated meshes come from the C++
mesh core of ``native/``, built at first use (``native.py``). This package
imports torch, numpy, ``yaml`` (the experiment configs) and the standard
library only.

Batches are disconnected unions of graphs (``graph.concat_graphs``), or
stacked batches folded into one (the vmap layout); a ``(data, graph)``
device mesh spreads a batch's graphs over data rows and each row's node
rows over its devices (``parallel/``), across processes too (``main``).

Entry points (``main`` -- the ``train``/``eval`` CLI --,
``models.build_model``, ``training.rollout.rollout``,
``training.train.Trainer``, ``train_step``, ``eval_step``,
``tune_batch_size``) run on the GPU
unless the caller passes ``device="cpu"`` (or a graph on the CPU); without a
GPU and without a device they raise.
"""
import torch

NUM_WATER_VARS = 2  # water depth h and unit-discharge magnitude |q|


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree (nested dicts, lists and
    tuples); other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, depth first in key order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_to(tree, device):
    """A tree of tensors on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


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
