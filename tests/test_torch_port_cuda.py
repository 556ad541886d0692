"""The port on an NVIDIA GPU: the hop kernel against its plain version, and
the model and rollout on the card against the port on the CPU.

Marked ``gpu``; each test skips without CUDA (decided inside the fixture).
Run on a machine with one NVIDIA GPU, from the repository root:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: the kernel adds the same float32 terms in the same order as
``hop_reference``, so float32 agrees to 1e-6 (1 + |ref|) and bfloat16 within
one bf16 ulp (``chip_smoke.within_limit``, the smoke test's limit). The
model on the card against the CPU: rtol 1e-5, atol 1e-4 in float32 —
cuBLAS sums the matmuls in another order.
"""
import pytest
import torch

from chip_smoke import make_hop_inputs, within_limit
from mswe_gnn_tpu_torch import tree_to
from mswe_gnn_tpu_torch.data import dataset as port_dataset
from mswe_gnn_tpu_torch.data.synthetic import generate_dataset
from mswe_gnn_tpu_torch.models import build_model
from mswe_gnn_tpu_torch.ops import hop as hop_ops
from mswe_gnn_tpu_torch.training.rollout import rollout

pytestmark = pytest.mark.gpu

MODES = [(True, False), (True, True), (False, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gradient,upwind", MODES)
@pytest.mark.parametrize("n_dst,n_src,feat,same_block", [
    (1000, 1000, 64, True), (517, 130, 64, False), (333, 333, 20, True)])
def test_kernel_matches_plain_version(cuda, dtype, with_gradient, upwind,
                                      n_dst, n_src, feat, same_block):
    args = make_hop_inputs(0, n_dst, n_src, 4, feat, dtype, same_block, cuda)
    before = hop_ops.launches
    got = hop_ops.hop(*args, with_gradient=with_gradient, upwind=upwind)
    assert hop_ops.launches == before + 1
    want = hop_ops.hop_reference(*args, with_gradient=with_gradient, upwind=upwind)
    ok, err = within_limit(got, want, dtype)
    assert ok, err


@pytest.fixture
def small_problem():
    records = generate_dataset(1, seed=0, nx=16, ny=16, num_scales=3, total_hours=12,
                               substeps=8)
    rec = records[0]
    scalers = port_dataset.fit_dataset_scalers(records, {"area_scaler": "standard"})
    spec = port_dataset.make_spec(rec.mesh, len(rec.mesh.ghosts.ghost_nodes), 8)
    g = port_dataset.to_temporal_samples(port_dataset.process_record(rec, scalers), spec,
                                         previous_t=2, rollout_steps=3)[1]
    cfg, params, apply_fn = build_model(
        {"hid_features": 32, "K": 3, "mlp_layers": 3, "learned_residuals": True,
         "with_WL": True}, num_node_features=g.x_static.shape[1] + g.x_dynamic.shape[1],
        num_edge_features=g.edge_attr.shape[1], num_scales=3, previous_t=2,
        device="cpu")
    return g, cfg, params, apply_fn


def test_rollout_on_the_card_matches_the_cpu(cuda, small_problem):
    g, cfg, params, apply_fn = small_problem
    want = rollout(apply_fn, params, cfg, g, steps=3, device="cpu")
    hop_ops.reset_launches()
    got = rollout(apply_fn, tree_to(params, cuda), cfg, g, steps=3)   # default device
    assert got.device.type == "cuda"
    assert hop_ops.launches == 3 * (sum(cfg.k_schedule) + cfg.num_scales - 1)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
