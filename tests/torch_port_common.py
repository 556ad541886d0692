"""Shared inputs for the tests of the PyTorch port (tests/test_torch_port_*.py):
the same records, samples and weights for the JAX package and the port."""
import jax
import numpy as np

from mswe_gnn_tpu.data import dataset as jax_dataset
from mswe_gnn_tpu.data.synthetic import generate_dataset as jax_generate
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset as port_generate

SCALER_KINDS = {"area_scaler": "standard", "edge_length_scaler": "standard"}
# small but fast: the verify recipe's 16x16, 3-scale corpus
GEN_KW = dict(seed=0, nx=16, ny=16, num_scales=3, total_hours=12, substeps=8)


def temporal_samples(ds, records, previous_t=2, rollout_steps=4):
    """Scalers fitted on all records, one union spec, samples of record 0."""
    scalers = ds.fit_dataset_scalers(records, SCALER_KINDS)
    procs = [ds.process_record(r, scalers) for r in records]
    spec = ds.union_spec([ds.make_spec(r.mesh, len(r.mesh.ghosts.ghost_nodes), 8)
                          for r in records])
    return spec, ds.to_temporal_samples(procs[0], spec, previous_t=previous_t,
                                        rollout_steps=rollout_steps)


def sample_pair(n_records=2, previous_t=2, rollout_steps=4, index=1):
    """(JAX FloodGraph, port FloodGraph) of the same temporal sample."""
    _, jg = temporal_samples(jax_dataset, jax_generate(n_records, **GEN_KW),
                             previous_t, rollout_steps)
    _, tg = temporal_samples(port_dataset, port_generate(n_records, **GEN_KW),
                             previous_t, rollout_steps)
    return jg[index], tg[index]


def numpy_tree(params):
    """A JAX parameter pytree as nested dicts/lists of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)
