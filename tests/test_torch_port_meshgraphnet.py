"""MeshGraphNets in the port (``models/meshgraphnet.py``, ``model_type``
MGN) against the benchmark's plain float32 reference of the same equations
(``portbench/architectures/meshgraphnet.py``), and the MLP options it
brought (``activate_final``, ``layer_norm``) against the MLP as it was.

The JAX package has no MGN, so the reference is what the port is held to.
Both sides run the benchmark's configuration ``meshgraphnets-flood`` on a
12x10 grid of its input generator with weights drawn from a seed, at latent
16 with 2 blocks and at the published latent 128 with 15 blocks.

Tolerances (float32): the port and the reference do the same float32
operations in another order (the port sums a node's in-edges over its ELL
slots, the reference with ``index_add`` over the edges; the port's
LayerNorm is ``torch.nn.functional.layer_norm``, the reference's written
out), so they differ by round-off that the blocks carry forward. A forward
step within 1e-5 of the largest output; a 3-step rollout within 1e-5 of
its largest output, since each step feeds the next; the loss within 1e-5
relative and each gradient leaf within 1e-4 of its own norm (a backward
sums the round-off of every step and block over the edges).
"""
import copy
import json
import os

import pytest
import torch

from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.graph import concat_graphs
from mswe_gnn_tpu_torch.models import gnn, msgnn, prepare, registry, swegnn
from mswe_gnn_tpu_torch.models.activations import apply_activation, init_activation
from mswe_gnn_tpu_torch.models.meshgraphnet import MGNConfig
from mswe_gnn_tpu_torch.models.mlp import _torch_linear_init, apply_mlp, init_mlp, matmul
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.training.rollout import rollout
from mswe_gnn_tpu_torch.training.train import TrainerOptions, loss_and_grads
import tests.torch_port_common  # noqa: F401  (PyTorch on one thread)

from portbench import modes, system
from portbench.architectures import meshgraphnet as arch
from portbench.reference import inputs
from portbench.reference import model as ref_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 77
SIZES = {"small": {"hid_features": 16, "n_GNN_layers": 2},
         "published": {"hid_features": 128, "n_GNN_layers": 15}}


def config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def problem():
    """The mesh, two scenarios, their port samples (full rollouts and 2-step
    windows) and, per size, the port's model and the reference."""
    cfg = config("meshgraphnets-flood")
    cfg["grid"].update(nx=12, ny=10, n_bc=2)
    cfg["frames"] = 8
    cfg["pad_multiple"] = 8
    cfg["train"]["rollout_steps"] = 2
    mesh = inputs.make_mesh(cfg["grid"], SEED)
    scen = inputs.make_scenarios(mesh, cfg["frames"], 2, SEED)
    full = [s[0] for s in system.port_samples(mesh, scen, cfg)]
    windows = [s[0] for s in system.port_samples(mesh, scen, cfg, [[1], [3]])]
    models = {}
    for size, widths in SIZES.items():
        c = copy.deepcopy(cfg)
        c["model"].update(widths)
        models[size] = (c, *system.build(c, full[0], SEED, "cpu"),
                        arch.Reference(c["model"], mesh, c["previous_t"], "cpu"))
    feats = [ref_model.features(mesh, s, cfg["previous_t"]) for s in scen]
    raw = [len(m["area"]) for m in mesh["meshes"]]
    return {"full": full, "windows": windows, "models": models, "feats": feats, "raw": raw}


def rows(graph, g, raw):
    return modes.real_rows(graph.spec, graph.num_graphs, g, raw)


def worst(got, want):
    """The largest gap over the reference's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", ["forward", "rollout", "loss_and_grads", "union"])
def test_port_follows_the_reference(problem, size, case):
    cfg, mcfg, params, apply_fn, ref = problem["models"][size]
    assert isinstance(mcfg, MGNConfig)
    assert mcfg.hid_features == SIZES[size]["hid_features"]
    assert len(params["processor"]) == SIZES[size]["n_GNN_layers"]
    graph, raw = problem["full"][0], problem["raw"]
    if case in ("forward", "rollout"):
        steps = 1 if case == "forward" else 3
        # the model keeps no cache: prepare_graph hands the graph back
        assert prepare_graph(params, mcfg, graph) is graph
        got = rollout(apply_fn, params, mcfg, graph, steps, device="cpu")
        want = ref_model.rollout(ref, params, problem["feats"][0], steps)
        assert worst(got[rows(graph, 0, raw)], want) <= 1e-5
        # padded rows are zero
        pad = torch.ones(graph.num_nodes, dtype=torch.bool)
        pad[rows(graph, 0, raw)] = False
        assert not got[pad].any()
    elif case == "loss_and_grads":
        union = concat_graphs(problem["windows"])
        opts = TrainerOptions(batch_size=2, velocity_scaler=cfg["train"]["velocity_scaler"],
                              remat=True)
        loss, grads = loss_and_grads(apply_fn, params, mcfg, union, 2, opts, multiscale=False)
        want_loss, want_grads = ref_model.loss_and_grads(
            ref, params, [(problem["feats"][0], 1), (problem["feats"][1], 3)], cfg["train"])
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        got_leaves = tree_leaves(grads)
        assert len(got_leaves) == len(want_grads)
        for g, w in zip(got_leaves, want_grads):
            assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-12
        assert any(float(w.norm()) > 0 for w in want_grads)
    else:
        union = concat_graphs(problem["full"])
        together = rollout(apply_fn, params, mcfg, union, 1, device="cpu")
        for g, alone in enumerate(problem["full"]):
            own = rollout(apply_fn, params, mcfg, alone, 1, device="cpu")
            torch.testing.assert_close(together[rows(union, g, raw)], own[rows(alone, 0, raw)],
                                       rtol=1e-6, atol=1e-6 * float(own.abs().max()))
            want = ref_model.rollout(ref, params, problem["feats"][g], 1)
            assert worst(together[rows(union, g, raw)], want) <= 1e-5


@pytest.mark.parametrize("residuals", [True, "all"])
def test_mgn_refuses_learned_residual_weights(residuals):
    """MGN adds the last input frame or nothing: it carries no residual
    weights, and the reference implements no learned residual either."""
    with pytest.raises(ValueError, match="learned_residuals"):
        registry.build_model({"model_type": "MGN", "hid_features": 4,
                              "learned_residuals": residuals},
                             num_node_features=8, num_edge_features=1, num_scales=1,
                             previous_t=3, device="cpu")


# ------------------------------------------------------------------- MLP

def frozen_init_mlp(gen, input_size, output_size, hidden_size=32, n_layers=2, bias=False,
                    activation="relu"):
    """``models/mlp.py::init_mlp`` as it was before its options."""
    layers, acts, norms = [], [], []
    for fi, fo in ([(input_size, output_size)] if n_layers == 1 else
                   [(input_size, hidden_size)] + [(hidden_size, hidden_size)] * (n_layers - 2)
                   + [(hidden_size, output_size)]):
        layers.append(_torch_linear_init(gen, fi, fo, bias))
        acts.append(init_activation(activation))
        norms.append({})
    return {"layers": layers, "acts": acts, "norms": norms}


def frozen_apply_mlp(params, x, activation="relu", compute_dtype=None):
    """``models/mlp.py::apply_mlp`` as it was before its options."""
    for lin, act in zip(params["layers"], params["acts"]):
        x = matmul(x, lin["w"], compute_dtype)
        if "b" in lin:
            x = x + lin["b"]
        x = apply_activation(activation, act, x)
    return x


@pytest.mark.parametrize("name", ["msgnn-bench", "gnn-pareto"])
def test_mlp_defaults_are_bit_equal_to_the_mlp_before_its_options(name, monkeypatch):
    """Each benchmarked configuration at its own widths, built and rolled
    out on a small grid with today's MLP and with a frozen copy of the MLP
    before ``activate_final`` and ``layer_norm``: the same parameters and
    the same outputs, to the bit."""
    cfg = config(name)
    cfg["grid"].update(nx=16, ny=12, n_bc=2)
    cfg["frames"] = 4
    cfg["pad_multiple"] = 8
    mesh = inputs.make_mesh(cfg["grid"], SEED)
    sample = system.port_samples(mesh, inputs.make_scenarios(mesh, 4, 1, SEED), cfg)[0][0]

    def built():
        mcfg, params, apply_fn = registry.build_model(
            cfg["model"], num_node_features=sample.num_node_features,
            num_edge_features=sample.edge_attr.shape[1], num_scales=sample.spec.num_scales,
            previous_t=cfg["previous_t"], seed=5, device="cpu")
        return params, rollout(apply_fn, params, mcfg, sample, 2, device="cpu")

    params, out = built()
    for module in (gnn, msgnn, swegnn, prepare):
        for fn, frozen in (("init_mlp", frozen_init_mlp), ("apply_mlp", frozen_apply_mlp)):
            if hasattr(module, fn):
                monkeypatch.setattr(module, fn, frozen)
    old_params, old_out = built()
    assert [p.shape for p in tree_leaves(params)] == [p.shape for p in tree_leaves(old_params)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(old_params)))
    assert torch.equal(out, old_out) and out.abs().max() > 0


def test_mlp_options_last_linear_bare_and_layer_norm():
    """``activate_final=False`` leaves the last linear bare (``None`` in its
    activation slot); a LayerNorm in the last ``norms`` slot (``layer_norm``)
    then equals ``torch.nn.LayerNorm`` over the output with the same scale
    and offset, in float32 under a bf16 ``compute_dtype`` too. ``apply_mlp``
    takes both from the tree alone."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(50, 7, generator=gen)
    p = init_mlp(gen, 7, 5, 9, n_layers=3, bias=True, activation="prelu",
                 activate_final=False, layer_norm=True)
    assert [a is None for a in p["acts"]] == [False, False, True]
    assert [sorted(n) for n in p["norms"]] == [[], [], ["bias", "scale"]]
    plain = {**p, "norms": [{}, {}, {}]}
    bare = apply_mlp(plain, x, "prelu")
    h = x
    for i, lin in enumerate(p["layers"]):
        h = h @ lin["w"] + lin["b"]
        if i < 2:
            h = torch.where(h >= 0, h, 0.25 * h)
    torch.testing.assert_close(bare, h, rtol=0, atol=0)
    assert (bare < 0).any()                      # the last linear is not activated
    norm = p["norms"][-1]
    norm["scale"].uniform_(0.5, 1.5, generator=gen)
    norm["bias"].uniform_(-0.5, 0.5, generator=gen)
    ln = torch.nn.LayerNorm(5, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(norm["scale"])
        ln.bias.copy_(norm["bias"])
    for dtype in ("float32", "bfloat16"):
        got = apply_mlp(p, x, "prelu", compute_dtype=dtype)
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, ln(apply_mlp(plain, x, "prelu", compute_dtype=dtype)), rtol=0, atol=0)
