"""Converts an orbax checkpoint of the JAX package into the port's npz
checkpoint (``mswe_gnn_tpu_torch/training/checkpoint.py``).

The JAX side reads it through ``mswe_gnn_tpu.training.checkpoint``, with the
parameter template of the experiment config's model
(``mswe_gnn_tpu.main.build_experiment_model`` on one small record of the
config's mesh type); ``mswe_gnn_tpu_torch/compat/jax_params.py`` turns the
tree into the port's, checking every key and shape. The port's ``meta.json``
keeps the JAX checkpoint's epoch and history and names its source.

    python3 -m tests.torch_port_convert --config configs/accuracy_tri.yaml \\
        results_repo/checkpoints/accuracy_tri_r5/best \\
        results_repo/checkpoints/accuracy_tri_r5_torch/best

It imports JAX, so it lives with the tests: the port never reads orbax.
"""
from __future__ import annotations

import argparse
import json
import os

import jax

from mswe_gnn_tpu import config as jax_config
from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu.main import build_experiment_model
from mswe_gnn_tpu.training.checkpoint import restore_params_only
from mswe_gnn_tpu_torch.compat.jax_params import load_jax_params
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.training.checkpoint import save_checkpoint
from tests.torch_port_common import numpy_tree

ACCURACY_TRI = "configs/accuracy_tri.yaml"
JAX_BEST = "results_repo/checkpoints/accuracy_tri_r5/best"
PORT_BEST = "results_repo/checkpoints/accuracy_tri_r5_torch/best"


def config_sample(cfg: dict):
    """One full-rollout JAX sample of a small record of ``cfg``'s corpus
    (its mesh type, scales, features and previous_t): what the model's
    input widths depend on."""
    sd, tdp = cfg["synthetic_data"], cfg["temporal_dataset_parameters"]
    rec = jax_generate(1, seed=0, nx=16, ny=16, num_scales=sd["num_scales"],
                       total_hours=4, substeps=2,
                       mesh_type=sd.get("mesh_type", "grid"))[0]
    scalers = jax_dataset.fit_dataset_scalers([rec], cfg["scalers"])
    proc = jax_dataset.process_record(rec, scalers,
                                      node_features=cfg["selected_node_features"],
                                      edge_features=cfg["selected_edge_features"])
    spec = jax_dataset.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), 8)
    return jax_dataset.to_temporal_samples(proc, spec, previous_t=tdp["previous_t"],
                                           rollout_steps=-1)[0]


def convert(config_path: str, src: str, dst=None):
    """-> (the JAX model config, the JAX parameter tree as numpy, the
    port's model config, the port's parameter tree on the CPU, the JAX
    checkpoint's meta); with ``dst``, also writes the port's checkpoint
    there."""
    cfg = jax_config.with_defaults(jax_config.read_config(config_path))
    g = config_sample(cfg)
    jax_cfg, template, _ = build_experiment_model(cfg, g)
    jax_tree = numpy_tree(restore_params_only(src, template))
    port_cfg, _, _ = build_model(
        cfg["models"], num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=g.spec.num_scales,
        previous_t=cfg["temporal_dataset_parameters"]["previous_t"], device="cpu")
    params = load_jax_params(jax_tree, port_cfg, device="cpu")
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    if dst is not None:
        save_checkpoint(dst, params, epoch=meta.get("epoch", 0),
                        history=meta.get("history", []),
                        extra={"converted_from": os.path.relpath(src)})
    return jax_cfg, jax_tree, port_cfg, params, meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=ACCURACY_TRI)
    ap.add_argument("src", nargs="?", default=JAX_BEST)
    ap.add_argument("dst", nargs="?", default=PORT_BEST)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    convert(args.config, args.src, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
