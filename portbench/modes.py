"""The two kinds of work a cell drives, each a closed loop of units: a
``rollout`` (one 47-step rollout of a graph or union through
``training.rollout.rollout``) or a ``train`` step (``training.train.train_step``
on a union). Each mode builds its inputs through the port's data path,
warms up, runs a unit on call, and afterwards checks what its units produced
against the plain reference: the ``Reference`` of the configuration's
architecture module (``architectures/<name>.py``), which also counts a
unit's FLOPs and kernel bytes.

A mode keeps from its window only what the check needs: for a rollout the
predictions of one of each union's rollouts, drawn from the seed; for
training the losses, the first step's gradient (read back from AdamW's first
moment) and the parameters after the third step, all taken in set-up, where
the first three steps run through the same call and feed as the window's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from mswe_gnn_tpu_torch import tree_leaves
from mswe_gnn_tpu_torch.training.rollout import rollout
from mswe_gnn_tpu_torch.training.train import TrainerOptions, make_optimizer, train_step

from portbench import compare, counts, system
from portbench.reference import model as ref_model

ADAM_BETA1 = 0.9
CHECKED_TRAIN_STEPS = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def real_rows(spec, num_graphs: int, g: int, raw_counts) -> torch.Tensor:
    """The rows of graph ``g`` of a union (or of a graph, ``num_graphs``
    1) that hold real nodes, scale by scale."""
    per = [c // num_graphs for c in spec.node_counts]
    rows = [np.arange(spec.node_ptr[s] + g * per[s], spec.node_ptr[s] + g * per[s] + n)
            for s, n in enumerate(raw_counts)]
    return torch.as_tensor(np.concatenate(rows))


class Mode:
    """What both modes share: the mesh and scenarios from the seed, the
    model with its weights, the shapes for the counts; ``arch``, the
    architecture's module, for the reference and the counts."""

    train = False

    def __init__(self, cfg: dict, arch, traffic: dict, seed: int, device, mesh, scenarios):
        self.cfg, self.arch, self.traffic, self.seed = cfg, arch, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.mesh, self.scenarios = mesh, scenarios
        self.rng = np.random.default_rng([seed, 2])
        self.raw_counts = [len(m["area"]) for m in mesh["meshes"]]
        self.shapes = counts.shapes(mesh)
        self.failed = 0

    def model(self, sample) -> None:
        self.mcfg, self.params, self.apply_fn = system.build(
            self.cfg, sample, self.seed, self.device)
        # the benchmark's own copy of the weights it drew, for the reference
        self.weights = ref_model.map_tree(lambda p: p.detach().clone(), self.params)
        self.sample_shape = (sample.x_static.shape[1], sample.x_dynamic.shape[1],
                             sample.edge_attr.shape[1])

    def _reference(self, precision=None):
        return self.arch.Reference(self.cfg["model"], self.mesh, self.cfg["previous_t"],
                                   self.device, precision)

    def flops_per_model_step(self) -> int:
        s, d, e = self.sample_shape
        return self.arch.forward_flops(self.cfg["model"], self.shapes,
                                       s + int(self.cfg["model"]["with_WL"]), d, e)

    def kernel_bytes_per_unit(self) -> dict:
        """Bytes of each of the architecture's kernel families a unit needs."""
        per_step = self.arch.kernel_bytes(self.cfg["model"], self.shapes, train=self.train)
        return {k: self.model_steps_per_unit * self.batch * v for k, v in per_step.items()}


class RolloutMode(Mode):
    traced_units = 2

    def __init__(self, *args):
        super().__init__(*args)
        t0 = time.perf_counter()
        samples = system.port_samples(self.mesh, self.scenarios, self.cfg)
        self.graphs = [u.to(self.device) for u in
                       system.unions([s[0] for s in samples], self.batch)]
        sync(self.device)
        self.graph_build_s = time.perf_counter() - t0
        self.layout = [(g.spec, g.num_graphs) for g in self.graphs]
        self.steps = samples[0][0].y.shape[-1]
        self.pick = self.rng.integers(0, 4, len(self.graphs))
        self.kept = [None] * len(self.graphs)
        self.runs = [0] * len(self.graphs)
        self.model(samples[0][0])

    @property
    def model_steps_per_unit(self) -> int:
        return self.steps

    def warm(self) -> None:
        rollout(self.apply_fn, self.params, self.mcfg, self.graphs[0], self.steps,
                device=self.device)
        sync(self.device)

    def unit(self, i: int) -> None:
        u = i % len(self.graphs)
        out = rollout(self.apply_fn, self.params, self.mcfg, self.graphs[u], self.steps,
                      device=self.device)
        ok = torch.isfinite(out).all()
        sync(self.device)
        self.failed += int(not ok)
        if self.runs[u] <= self.pick[u]:
            self.kept[u] = out
        self.runs[u] += 1

    def flops_per_unit(self) -> int:
        return self.steps * self.batch * self.flops_per_model_step()

    def release(self) -> None:
        del self.graphs, self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _scenarios_kept(self):
        """(graph ``g``'s rows of a kept output, its scenario's features) for
        every graph of every union with a kept rollout."""
        for u, out in enumerate(self.kept):
            if out is None:
                continue
            spec, n_graphs = self.layout[u]
            for g in range(self.batch):
                rows = real_rows(spec, n_graphs, g, self.raw_counts).to(out.device)
                yield out.index_select(0, rows).float(), ref_model.features(
                    self.mesh, self.scenarios[u * self.batch + g], self.cfg["previous_t"])

    def check(self) -> dict:
        """Every kept rollout, graph by graph, against the reference's
        rollout of the same scenario -> the worst gaps."""
        ref = self._reference()
        return compare.worst([
            compare.rollout_gaps(got, ref_model.rollout(ref, self.weights, feats, self.steps))
            for got, feats in self._scenarios_kept()])

    def control(self, precision) -> dict:
        """The reference in ``precision`` in the program's place: the kept
        unions' scenarios rolled out by it, against the float32 reference."""
        low, ref = self._reference(precision), self._reference()
        return compare.worst([
            compare.rollout_gaps(ref_model.rollout(low, self.weights, feats, self.steps),
                                 ref_model.rollout(ref, self.weights, feats, self.steps))
            for _, feats in self._scenarios_kept()])


class TrainMode(Mode):
    traced_units = 3
    train = True

    def __init__(self, *args):
        super().__init__(*args)
        n_unions = self.traffic["unions"]
        steps = self.cfg["train"]["rollout_steps"]
        last = self.cfg["frames"] - steps - 1     # a window's last first frame
        self.starts = [self.rng.choice(last + 1, n_unions, replace=False).tolist()
                       for _ in self.scenarios]
        t0 = time.perf_counter()
        samples = system.port_samples(self.mesh, self.scenarios, self.cfg, self.starts)
        self.unions = [system.unions([s[u] for s in samples], self.batch)[0].to(self.device)
                       for u in range(n_unions)]
        sync(self.device)
        self.graph_build_s = time.perf_counter() - t0
        self.model(samples[0][0])
        t = self.cfg["train"]
        self.opts = TrainerOptions(
            batch_size=self.batch, velocity_scaler=t["velocity_scaler"], remat=t["remat"],
            learning_rate=t["learning_rate"], gamma=t["gamma"], step_size=t["step_size"],
            grad_clip=t["grad_clip"], weight_decay=t["weight_decay"])
        self.optimizer = make_optimizer(self.opts, steps_per_epoch=t["steps_per_epoch"])
        self.opt_state = self.optimizer.init(self.params)
        self.losses = []

    @property
    def model_steps_per_unit(self) -> int:
        return self.cfg["train"]["rollout_steps"]

    def step(self, u: int) -> float:
        _, _, loss = train_step(
            self.params, self.opt_state, self.unions[u], apply_fn=self.apply_fn,
            cfg=self.mcfg, rollout_steps=self.cfg["train"]["rollout_steps"], opts=self.opts,
            multiscale=self.mcfg.__class__.__name__ == "MSGNNConfig",
            optimizer=self.optimizer, device=self.device)
        value = float(loss)
        self.failed += int(not np.isfinite(value))
        return value

    def warm(self) -> None:
        """The first three steps, on the three unions: what the check
        follows."""
        for u in range(CHECKED_TRAIN_STEPS):
            self.losses.append(self.step(u % len(self.unions)))
            if u == 0:
                adamw = self.opt_state["adamw"]
                self.first_grad = [adamw.state[p]["exp_avg"] / (1 - ADAM_BETA1)
                                   for p in tree_leaves(self.params)]
        self.after = [p.detach().clone() for p in tree_leaves(self.params)]
        sync(self.device)

    def unit(self, i: int) -> None:
        self.step((CHECKED_TRAIN_STEPS + i) % len(self.unions))

    def flops_per_unit(self) -> int:
        return 3 * self.model_steps_per_unit * self.batch * self.flops_per_model_step()

    def release(self) -> None:
        del self.unions, self.params, self.opt_state, self.optimizer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, precision=None):
        ref = self._reference(precision)
        feats = [ref_model.features(self.mesh, s, self.cfg["previous_t"])
                 for s in self.scenarios]
        batches = [[(feats[g], self.starts[g][u % len(self.starts[g])])
                    for g in range(self.batch)]
                   for u in range(CHECKED_TRAIN_STEPS)]
        return ref_model.train_steps(ref, self.weights, batches, self.cfg["train"])

    def control(self, precision) -> dict:
        """The reference's three steps in ``precision`` in the program's
        place, against its float32 steps."""
        before = ref_model.leaves_of(self.weights)
        losses, grads, after = self.reference_steps(precision)
        ref_losses, ref_grads, ref_after = self.reference_steps()
        return compare.train_gaps(losses, ref_losses, grads, ref_grads,
                                  [a - b for a, b in zip(after, before)],
                                  [a - b for a, b in zip(ref_after, before)])

    def check(self) -> dict:
        """The reference's first three steps from the same weights on the
        same windows -> the gaps of the losses, of the first gradient and of
        the parameters' change."""
        losses, grads, after = self.reference_steps()
        before = ref_model.leaves_of(self.weights)
        return compare.train_gaps(self.losses, losses, self.first_grad, grads,
                                  [a - b for a, b in zip(self.after, before)],
                                  [a - b for a, b in zip(after, before)])


MODES = {"rollout": RolloutMode, "train": TrainMode}
