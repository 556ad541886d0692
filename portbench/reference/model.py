"""The plain reference's shared part: float32 PyTorch on unpadded arrays,
the encoders, MLPs and decoder of the mSWE-GNN family, the rollout loop,
and the 6-step pushforward loss with the optimizer's update. Each
architecture's forward pass is a subclass of ``Reference`` in its own module,
``architectures/<name>.py``, which the configuration names.

It follows the published model (Bentivoglio et al., "Multi-scale hydraulic
graph neural networks for flood modelling"; reference code models/gnn.py
and models/models.py of sdat2/mSWE-GNN) literally. Nothing here pads,
tables, fuses or batches; it imports torch and numpy only and takes from the
caller the raw inputs (``reference/inputs.py``) and the weights the
benchmark drew.

``Precision`` rounds what the configuration's compute dtype rounds: every
matmul operand and, for a bf16 configuration, the flux and the hop state.
Its default rounds nothing (the reference); ``Precision("tf32")`` and
``Precision("fp8")`` are the lower precisions of the control.
"""
from __future__ import annotations

import numpy as np
import torch

NUM_WATER_VARS = 2
FP8_MAX = 448.0          # largest finite float8_e4m3fn


class Precision:
    """Rounding of matmul operands (and, with ``state``, of the flux and
    the hop state): ``None`` (float32), ``"tf32"`` (10 mantissa bits, round
    to nearest) or ``"fp8"`` (float8_e4m3fn with one scale a tensor)."""

    def __init__(self, kind=None, state: bool = False):
        if kind not in (None, "tf32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind, self.state = kind, state

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded; the gradient passes through the rounding
        unchanged, as it does through a low-precision GEMM's operand cast."""
        if self.kind is None:
            return x
        with torch.no_grad():
            if self.kind == "tf32":
                bits = x.contiguous().view(torch.int32)
                rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
            else:
                scale = FP8_MAX / x.abs().max().clamp_min(1e-30)
                rounded = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return x + (rounded - x).detach()

    def hop(self, x: torch.Tensor) -> torch.Tensor:
        return self(x) if self.state else x


def _fp64(x):
    return np.asarray(x, dtype=np.float64)


def _standard(values):
    """The standard scaler's transform, fitted on ``values``."""
    v = _fp64(values)
    return (v - v.mean()) / max(float(v.std()), 1e-12)


def features(mesh: dict, scenario: dict, previous_t: int) -> dict:
    """The model's inputs worked out from the raw arrays: static node
    features ``[area, DEM]`` (area standardised per scale, the DEM shifted
    to its minimum), the edge length standardised per scale, the water
    depth ``h`` and unit discharge ``|q| = h |v|`` series, and the boundary
    inflow series, each with ``previous_t - 1`` dry frames in front (the
    inflow also with its last frame repeated)."""
    meshes = mesh["meshes"]
    area = np.concatenate([_standard(m["area"]) for m in meshes])
    dem = np.concatenate([_fp64(m["dem"]) for m in meshes])
    x_static = np.stack([area, dem - dem.min()], axis=1)
    edge_attr = np.concatenate([_standard(m["face_distance"]) for m in meshes])[:, None]
    wd = _fp64(scenario["wd"])
    q = np.sqrt((_fp64(scenario["vx"]) * wd) ** 2 + (_fp64(scenario["vy"]) * wd) ** 2)
    p = previous_t
    pad = np.zeros((wd.shape[0], p - 1))
    bc = _fp64(scenario["bc_per_length"])
    f32 = np.float32
    return {"x_static": x_static.astype(f32), "edge_attr": edge_attr.astype(f32),
            "wd": np.concatenate([pad, wd.astype(f32)], 1).astype(f32),
            "q": np.concatenate([pad, q.astype(f32)], 1).astype(f32),
            "bc": np.concatenate([np.zeros((bc.shape[0], p - 1)), bc.astype(f32),
                                  bc[:, -1:].astype(f32)], 1).astype(f32)}


def topology(mesh: dict) -> dict:
    """Global node numbering (scale-major), each scale's edges and each
    level's transfer edges ``(coarse, fine)`` in global ids."""
    counts = [len(m["area"]) for m in mesh["meshes"]]
    node_ptr = np.cumsum([0, *counts])
    return {"node_ptr": node_ptr,
            "edges": [m["edge_index"] + node_ptr[s] for s, m in enumerate(mesh["meshes"])],
            "intra": [np.stack([te[0] + node_ptr[s + 1], te[1] + node_ptr[s]])
                      for s, te in enumerate(mesh["intra"])],
            "ghosts": np.asarray(mesh["ghosts"]["ghost_nodes"])}


class Reference:
    """One graph: the model of ``model_cfg`` (the configuration's model
    dict) on ``mesh``'s topology, ``previous_t`` input frames, on
    ``device``. What every architecture shares: the topology, the MLP,
    activations, encoders and decoder, and the loops. An architecture's
    module subclasses it and gives ``forward``; ``only_finest`` says
    whether the loss counts the finest scale's rows alone."""

    only_finest = False

    def __init__(self, model_cfg: dict, mesh: dict, previous_t: int, device,
                 precision: Precision | None = None):
        self.cfg = model_cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = previous_t
        self.device = torch.device(device)
        self.rnd = precision or Precision()
        topo = topology(mesh)
        self.node_ptr = topo["node_ptr"]
        self.n = int(self.node_ptr[-1])
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)  # noqa: E731
        self.edges = [t(e) for e in topo["edges"]]
        self.edge_ptr = np.cumsum([0, *[e.shape[1] for e in topo["edges"]]])
        self.intra = [t(e) for e in topo["intra"]]
        self.ghosts = t(topo["ghosts"])
        self.scale_of = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        for s in range(len(self.node_ptr) - 1):
            self.scale_of[self.node_ptr[s]:self.node_ptr[s + 1]] = s
        self.finest = slice(0, int(self.node_ptr[1]))

    # ------------------------------------------------------------ layers
    def mm(self, x, w):
        return self.rnd(x) @ self.rnd(w)

    def act(self, name, params, x):
        if name is None:
            return x
        if name == "prelu":
            return torch.where(x >= 0, x, params["alpha"] * x)
        if name == "tanh":
            return torch.tanh(x)
        if name == "relu":
            return torch.relu(x)
        raise ValueError(f"the reference does not implement activation {name!r}")

    def mlp(self, params, x):
        for lin, a in zip(params["layers"], params["acts"]):
            x = self.mm(x, lin["w"])
            if "b" in lin:
                x = x + lin["b"]
            x = self.act(self.cfg["mlp_activation"], a, x)
        return x

    def _encode(self, params, x_static, x_dyn):
        x_s, x_d = x_static, x_dyn
        if self.cfg["with_WL"]:
            wl = x_s[:, -1] + x_d[:, -NUM_WATER_VARS]
            x_s = torch.cat([x_s, wl[:, None]], dim=1)
        return (self.mlp(params["static_node_encoder"], x_s),
                self.mlp(params["dynamic_node_encoder"], x_d))

    def _decode(self, params, h, x_dyn):
        out = self.mlp(params["node_decoder"], h)
        res = self.cfg["learned_residuals"]
        if res is True:
            hist = x_dyn.reshape(-1, self.p, NUM_WATER_VARS)
            out = out + torch.einsum("npv,p->nv", hist, params["residual_weights"][:, 0])
        elif res is False:
            out = out + x_dyn[:, -NUM_WATER_VARS:]
        elif res is not None:
            raise ValueError(f"the reference does not implement learned_residuals={res!r}")
        out = torch.relu(out)
        wd = out[:, 0] * (out[:, 0].abs() > 1e-4)
        return torch.stack([wd, out[:, 1] * (wd != 0)], dim=1)

    def forward(self, params, x_static, x_dyn, edge_attr):
        """-> predictions ``[N, 2]`` of (h, |q|) at the next frame: the
        architecture's own (``architectures/<name>.py``)."""
        raise NotImplementedError("an architecture's Reference gives forward")

    def encode_edges(self, params, edge_attr):
        return self.mlp(params["edge_encoder"], edge_attr) if self.cfg["edge_mlp"] else edge_attr

    # ------------------------------------------------------------ loops
    def inputs(self, feats: dict, start: int):
        """(x_static, interleaved history of frames start..start+p-1,
        boundary series) as tensors on the device."""
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        hist = np.empty((self.n, 2 * self.p), np.float32)
        hist[:, 0::2] = feats["wd"][:, start:start + self.p]
        hist[:, 1::2] = feats["q"][:, start:start + self.p]
        return t(feats["x_static"]), t(hist), t(feats["bc"]), t(feats["edge_attr"])

    def inject(self, x_dyn, bc, step, start=0):
        """The inflow of frames ``start+step .. +p-1`` written into the
        ghost rows' |q| columns."""
        x = x_dyn.reshape(self.n, self.p, NUM_WATER_VARS).clone()
        x[self.ghosts, :, 1] = bc[:, start + step:start + step + self.p]
        return x.reshape(self.n, self.p * NUM_WATER_VARS)

    def unroll(self, params, feats, steps, start=0):
        """The autoregressive loop from frame ``start`` -> predictions
        ``[N, 2, steps]``."""
        x_static, x_dyn, bc, ea = self.inputs(feats, start)
        ea = self.encode_edges(params, ea)
        preds = []
        for t in range(steps):
            x_dyn = self.inject(x_dyn, bc, t, start)
            pred = self.forward(params, x_static, x_dyn, ea)
            x_dyn = torch.cat([x_dyn[:, NUM_WATER_VARS:], pred], dim=1)
            preds.append(pred)
        return torch.stack(preds, dim=-1)


@torch.no_grad()
def rollout(ref: Reference, params, feats, steps: int) -> torch.Tensor:
    return ref.unroll(params, feats, steps)


def target(feats, start, p, steps, device):
    """Frames ``start+p .. start+p+steps-1`` -> ``[N, 2, steps]``."""
    y = np.stack([feats["wd"][:, start + p:start + p + steps],
                  feats["q"][:, start + p:start + p + steps]], axis=1)
    return torch.as_tensor(y, device=device)


def error_sums(ref: Reference, params, feats, start: int, steps: int, only_finest: bool):
    """The pushforward unroll's loss pieces of one graph: per step the sums
    of squared errors ``[T, 2]`` and the counts ``[T]`` over the rows where
    prediction or target is nonzero (the finest scale's alone with
    ``only_finest``)."""
    preds = ref.unroll(params, feats, steps, start)
    diff = preds - target(feats, start, ref.p, steps, ref.device)
    if only_finest:
        diff = diff[ref.finest]
    valid = (diff != 0).any(dim=1).to(diff.dtype)            # [N, T]
    return (diff * diff * valid[:, None, :]).sum(dim=0).T, valid.sum(dim=0)


def rmse_loss(sums, counts, velocity_scaler: float):
    """Mean over steps of the velocity-weighted RMSE over the pooled rows."""
    err = torch.sqrt(sums / counts.clamp_min(1.0)[:, None])
    w = torch.tensor([1.0, velocity_scaler], device=sums.device)
    return (err @ w / w.sum()).mean()


def loss_and_grads(ref: Reference, params, graphs, train: dict):
    """The pushforward loss of a batch of ``graphs`` ((feats, start) each)
    and its gradient, a graph at a time: the pooled sums and counts first
    without gradients, then each graph's sums again with gradients, weighted
    by the loss's derivative in them."""
    steps = train["rollout_steps"]
    with torch.no_grad():
        pieces = [error_sums(ref, params, f, s, steps, ref.only_finest) for f, s in graphs]
    sums = torch.stack([p[0] for p in pieces]).sum(0).requires_grad_(True)
    counts = torch.stack([p[1] for p in pieces]).sum(0)
    loss = rmse_loss(sums, counts, train["velocity_scaler"])
    (d_sums,) = torch.autograd.grad(loss, sums)
    leaves = leaves_of(params)
    grads = [torch.zeros_like(p) for p in leaves]
    work = map_tree(lambda p: p.detach().requires_grad_(True), params)
    work_leaves = leaves_of(work)
    for f, s in graphs:
        with torch.enable_grad():
            g_sums, _ = error_sums(ref, work, f, s, steps, ref.only_finest)
            part = torch.autograd.grad((g_sums * d_sums).sum(), work_leaves, allow_unused=True)
        grads = [a if b is None else a + b for a, b in zip(grads, part)]
    return loss.detach(), grads


class AdamW:
    """``clip_by_global_norm`` (no epsilon) then AdamW (torch's update, the
    learning rate a staircase ``gamma ** (count // (step_size *
    steps_per_epoch))``), written out."""

    def __init__(self, train: dict, leaves):
        self.t = train
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    def clip(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm < self.t["grad_clip"]:
            return grads
        return [g / norm * self.t["grad_clip"] for g in grads]

    @torch.no_grad()
    def update(self, leaves, grads):
        t = self.t
        lr = t["learning_rate"] * t["gamma"] ** (
            self.count // max(1, t["step_size"] * t["steps_per_epoch"]))
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            p.mul_(1 - lr * t["weight_decay"])
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.count)).sqrt() + eps
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.count))


def map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return tree


def leaves_of(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


def train_steps(ref: Reference, params, batches, train: dict):
    """``len(batches)`` optimizer steps from ``params`` (copied), each batch
    a list of (feats, start) -> (losses, the clipped gradient of the first
    step, the parameters after the last step), leaves in ``leaves_of``
    order."""
    work = map_tree(lambda p: p.detach().clone(), params)
    leaves = leaves_of(work)
    opt = AdamW(train, leaves)
    losses, first = [], None
    for graphs in batches:
        loss, grads = loss_and_grads(ref, work, graphs, train)
        grads = opt.clip(grads)
        if first is None:
            first = [g.clone() for g in grads]
        opt.update(leaves, grads)
        losses.append(float(loss))
    return losses, first, leaves
