"""Pieces every plain reference model shares: batches of graphs, dense and
BatchNorm layers, the Gaussian edge basis, means at nodes and graphs, the
L1 loss, AdamW and the precision contexts.

A batch is a dict of tensors with no padding: x (N, F), src and dst (E,)
batch-global node ids, dist (E,) normalised distances, graph (N,) the graph
of each node, y (B,), and the count B. Weights are a dict of tensors named
as the program names its state (Linear `weight` (out, in) and `bias`,
BatchNorm `weight`, `bias`, `running_mean`, `running_var`)."""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F

BUFFERS = ("running_mean", "running_var")
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01  # torch.optim.AdamW's

# whether every product rounds its operands to TF32 (the control)
_TF32 = contextvars.ContextVar("tf32", default=False)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 with TF32 off (the reference), or, for the
    control, the next precision below what the configurations state: TF32,
    emulated so that it reaches every product (a batched product that
    cuBLAS runs without tensor cores too), forward and backward: each
    operand rounded to TF32's 10-bit mantissa, the sums in float32, as a
    tensor core does."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    token = _TF32.set(tf32)
    try:
        yield
    finally:
        _TF32.reset(token)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(t):
    """float32 rounded to the nearest TF32 value (ties away from zero, as
    cvt.rna.tf32.f32 rounds)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """einsum(spec, a, b) with TF32 operands, its gradients too."""

    @staticmethod
    def forward(ctx, spec, a, b):
        ctx.spec = spec
        ctx.save_for_backward(a, b)
        return torch.einsum(spec, round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.spec.split("->")
        sa, sb = ins.split(",")
        g = round_tf32(g)
        return (None, torch.einsum(f"{out},{sb}->{sa}", g, round_tf32(b)),
                torch.einsum(f"{sa},{out}->{sb}", round_tf32(a), g))


def product(spec: str, a, b):
    """The two-operand einsum every product of the reference goes through
    (no index is summed that only one operand has)."""
    if _TF32.get():
        return _TF32Product.apply(spec, a, b)
    return torch.einsum(spec, a, b)


def batch_of(corpus: dict, ids, device) -> dict:
    """The graphs `ids` of the corpus (node_x, node_ptr, edge_ptr, edge_src,
    edge_dst, edge_dist_norm, y) as one batch on `device`."""
    ids = np.asarray(ids, np.int64)
    nptr, eptr = corpus["node_ptr"], corpus["edge_ptr"]
    nodes = np.concatenate([np.arange(nptr[i], nptr[i + 1]) for i in ids])
    edges = np.concatenate([np.arange(eptr[i], eptr[i + 1]) for i in ids])
    ncount = nptr[ids + 1] - nptr[ids]
    ecount = eptr[ids + 1] - eptr[ids]
    offset = np.repeat(np.cumsum(ncount) - ncount, ecount)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(
        x=t(corpus["node_x"][nodes], torch.float32),
        src=t(corpus["edge_src"][edges].astype(np.int64) + offset, torch.int64),
        dst=t(corpus["edge_dst"][edges].astype(np.int64) + offset, torch.int64),
        dist=t(corpus["edge_dist_norm"][edges], torch.float32),
        graph=t(np.repeat(np.arange(len(ids)), ncount), torch.int64),
        y=t(corpus["y"][ids, 0], torch.float32),
        num_graphs=len(ids))


def linear(w: dict, name: str, x):
    return product("nd,od->no", x, w[f"{name}.weight"]) + w[f"{name}.bias"]


def linear_table(name: str, fan_in: int, fan_out: int) -> list:
    """torch.nn.Linear's parameters, drawn from U(-1/sqrt(fan_in), ...)."""
    bound = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.weight", (fan_out, fan_in), "uniform", bound),
            (f"{name}.bias", (fan_out,), "uniform", bound)]


def batch_norm_table(name: str, dim: int) -> list:
    return [(f"{name}.{k}", (dim,), f"bn_{k}", 0.0)
            for k in ("weight", "bias", "running_mean", "running_var")]


def batch_norm(w: dict, name: str, x, train: bool, new_stats: dict,
               momentum: float = 0.1, eps: float = 1e-5):
    """torch's BatchNorm1d: in training the biased batch statistics, and
    the running ones updated with the unbiased variance; in eval the
    running ones."""
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        n = x.shape[0]
        with torch.no_grad():
            new_stats[f"{name}.running_mean"] = (
                (1 - momentum) * w[f"{name}.running_mean"] + momentum * mean)
            new_stats[f"{name}.running_var"] = (
                (1 - momentum) * w[f"{name}.running_var"]
                + momentum * var * n / max(n - 1, 1))
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    return ((x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"]
            + w[f"{name}.bias"])


def gaussian(dist, resolution: int, width: float = 0.2):
    """MatDeepLearn's GaussianSmearing over [0, 1]."""
    offsets = torch.linspace(0.0, 1.0, resolution, dtype=dist.dtype,
                             device=dist.device)
    return torch.exp(-0.5 / width ** 2 * (dist[:, None] - offsets) ** 2)


def mean_at(values, index, count: int):
    """Mean of the rows of `values` grouped by `index` (0 where none)."""
    total = torch.zeros((count, values.shape[1]), dtype=values.dtype,
                        device=values.device).index_add_(0, index, values)
    n = torch.zeros(count, dtype=values.dtype,
                    device=values.device).index_add_(
        0, index, torch.ones_like(index, dtype=values.dtype))
    return total / torch.clamp(n, min=1.0)[:, None]


def head(w: dict, cfg: dict, h, g: dict):
    """Global mean pool, post_fc_count ReLU layers and lin_out."""
    out = mean_at(h, g["graph"], g["num_graphs"])
    for i in range(int(cfg["post_fc_count"])):
        out = F.relu(linear(w, f"post_lin{i}", out))
    return linear(w, "lin_out", out)[:, 0]


def head_table(cfg: dict, width: int) -> list:
    table = []
    for i in range(int(cfg["post_fc_count"])):
        table += linear_table(f"post_lin{i}", width, int(cfg["dim2"]))
        width = int(cfg["dim2"])
    return table + linear_table("lin_out", width, 1)


def l1_loss(pred, y, keep=None):
    """Mean |pred - y| over the graphs (over those `keep` marks)."""
    err = torch.abs(pred - y)
    if keep is None:
        return err.mean()
    return (err * keep).sum() / keep.sum()


def adamw_step(w: dict, grads: dict, state: dict, step: int, lr: float):
    """torch.optim.AdamW's update (decoupled weight decay, bias-corrected
    moments), written out."""
    b1, b2 = BETAS
    with torch.no_grad():
        for k, g in grads.items():
            m, v = state.setdefault(k, (torch.zeros_like(g),
                                        torch.zeros_like(g)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[k] = (m, v)
            denom = torch.sqrt(v / (1 - b2 ** step)) + EPS
            w[k] = w[k] * (1 - lr * WEIGHT_DECAY) - lr / (1 - b1 ** step) * m / denom


def train_steps(model, cfg: dict, w0: dict, batches: list, lr: float,
                half_batch: bool = False) -> dict:
    """len(batches) training steps from the weights w0: {"losses": each
    step's loss, "pred1": step 1's prediction of each graph of its batch,
    "grad1": each parameter's gradient at step 1, "state": every weight
    and running statistic after the last step}. half_batch
    (a fault, for the checks' tests): each loss is the mean over the first
    half of the batch's graphs alone."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    state, losses, grad1, pred1 = {}, [], None, None
    for step, g in enumerate(batches, start=1):
        params = {k: v.requires_grad_(True) for k, v in w.items()
                  if k.rsplit(".", 1)[-1] not in BUFFERS}
        stats = {}
        pred = model.forward({**w, **params}, g, cfg, True, stats)
        keep = None
        if half_batch:
            keep = (torch.arange(g["num_graphs"], device=pred.device)
                    < g["num_graphs"] // 2).to(pred.dtype)
        loss = l1_loss(pred, g["y"], keep)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: v.detach().clone() for k, v in grads.items()}
            pred1 = pred.detach().double().cpu().numpy()
        w = {k: v.detach() for k, v in w.items()}
        adamw_step(w, grads, state, step, lr)
        w.update(stats)
    return {"losses": losses, "pred1": pred1, "grad1": grad1, "state": w}


@torch.no_grad()
def predict(model, cfg: dict, w: dict, corpus: dict, ids, device,
            block: int = 64) -> np.ndarray:
    """Eval-mode predictions of the graphs `ids`, `block` graphs at a
    time (eval BatchNorm is per node, so the blocks change nothing)."""
    out = []
    for s in range(0, len(ids), block):
        g = batch_of(corpus, ids[s:s + block], device)
        out.append(model.forward(w, g, cfg, False, {}).cpu().numpy())
    return np.concatenate(out)
