"""Losses, the train and eval steps, and evaluation in id order.

Reference counterparts: train() (training/training.py:34-54) and evaluate()
(:58-92); the reference package's training/train.py:_train_step_body.
Losses are pad-mask-aware, and the error over a split is the
sample-weighted mean the reference computes (loss × batch count). A step
returns its loss and graph count as device tensors and never waits for the
device; the sums stay on the device, and `evaluate` waits once, at the end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from matdeeplearn_torch.data.batching import BatchSpec, DeviceDataset, assemble
from matdeeplearn_torch.parallel import spmd

# --------------------------------------------------------------------- losses
# Name-compatible with the reference's getattr(torch.nn.functional, loss)
# (training/training.py:43). All reduce as a mean over valid elements.


def _masked_mean(err, gmask):
    if err.ndim == 1:
        total = torch.sum(err * gmask)
        denom = torch.sum(gmask)
    else:
        total = torch.sum(err * gmask[:, None])
        denom = torch.sum(gmask) * err.shape[-1]
    return total / torch.clamp(denom, min=1.0)


def l1_loss(pred, y, gmask):
    return _masked_mean(torch.abs(pred - y), gmask)


def mse_loss(pred, y, gmask):
    return _masked_mean((pred - y) ** 2, gmask)


def smooth_l1_loss(pred, y, gmask, beta: float = 1.0):
    d = torch.abs(pred - y)
    err = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _masked_mean(err, gmask)


def huber_loss(pred, y, gmask, delta: float = 1.0):
    d = torch.abs(pred - y)
    err = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _masked_mean(err, gmask)


def binary_cross_entropy(pred, y, gmask):
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    return _masked_mean(-(y * torch.log(p) + (1 - y) * torch.log1p(-p)), gmask)


def binary_cross_entropy_with_logits(pred, y, gmask):
    err = torch.clamp(pred, min=0) - pred * y + torch.log1p(torch.exp(-torch.abs(pred)))
    return _masked_mean(err, gmask)


LOSSES: dict[str, Callable] = {
    "l1_loss": l1_loss,
    "mse_loss": mse_loss,
    "smooth_l1_loss": smooth_l1_loss,
    "huber_loss": huber_loss,
    "binary_cross_entropy": binary_cross_entropy,
    "binary_cross_entropy_with_logits": binary_cross_entropy_with_logits,
}


def get_loss(name: str) -> Callable:
    if name not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'; have {sorted(LOSSES)}")
    return LOSSES[name]


# ------------------------------------------------------------------ eval


def epoch_id_matrix(indices, batch_size: int, shuffle: bool, seed) -> np.ndarray:
    """(S, B) int32 dataset-id matrix for one epoch; -1 pads the tail."""
    indices = np.asarray(indices)
    n = len(indices)
    order = indices.copy()
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    steps = max(1, -(-n // batch_size))
    padded = np.full(steps * batch_size, -1, dtype=np.int64)
    padded[:n] = order
    return padded.reshape(steps, batch_size).astype(np.int32)


def train_step(model, optimizer, loss_fn, spec: BatchSpec, data: DeviceDataset,
               ids):
    """One optimizer step on the batch of dataset ids `ids` (a (B,) array or
    device tensor, -1 for pad slots): BatchNorm in training mode (batch
    statistics, running update), masked loss, backward, optimizer.step().
    Returns (loss, graph count) as device tensors. The batch is windowed
    when the dataset carries the windowed layout (batching.assemble)."""
    return train_batch(model, optimizer, loss_fn, assemble(data, ids, spec))


def train_batch(model, optimizer, loss_fn, batch):
    """train_step on an assembled batch (a streamed one: training/stream.py)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(batch)
    y = batch.y if out.ndim > 1 else batch.y[:, 0]
    loss = loss_fn(out, y, batch.graph_mask)
    loss.backward()
    optimizer.step()
    return loss.detach(), torch.sum(batch.graph_mask)


@torch.no_grad()
def eval_step(model, loss_fn, spec: BatchSpec, data: DeviceDataset, ids):
    """One batch in eval mode: (loss, graph count, per-slot outputs)."""
    return eval_batch(model, loss_fn, assemble(data, ids, spec))


@torch.no_grad()
def eval_batch(model, loss_fn, batch):
    """eval_step on an assembled batch."""
    out = model(batch)
    y = batch.y if out.ndim > 1 else batch.y[:, 0]
    return loss_fn(out, y, batch.graph_mask), torch.sum(batch.graph_mask), out


def evaluate(model, loss_name: str, spec: BatchSpec, data: DeviceDataset,
             indices, batch_size: int, out: bool = False, id_matrix_fn=None,
             mesh=None):
    """Mean loss over `indices`, and with `out` the per-graph predictions
    and targets in `indices` order. id_matrix_fn(indices, shuffle, seed)
    makes the eval id matrix (packed bins, which need not be sequential);
    by default epoch_id_matrix with batch_size. With a mesh
    (parallel/mesh.py) each row holds dp replicas' ids and the dp/ep eval
    step (parallel/spmd.py) returns the row's outputs in its id order."""
    model.eval()
    loss_fn = get_loss(loss_name)
    ids = (id_matrix_fn(indices, False, None) if id_matrix_fn is not None
           else epoch_id_matrix(indices, batch_size, shuffle=False, seed=None))
    loss_sum = torch.zeros((), device=data.device)
    count_sum = torch.zeros((), device=data.device)
    outs = []
    for row in ids:
        if mesh is None:
            loss, count, pred = eval_step(model, loss_fn, spec, data, row)
        else:
            loss, count, pred = spmd.eval_batch(
                model, loss_fn, spmd.local_batch(data, row, spec, mesh), mesh,
                out=out)
        loss_sum += loss * count
        count_sum += count
        outs.append(pred)
    loss = float(loss_sum / torch.clamp(count_sum, min=1.0))
    if not out:
        return loss
    outs = torch.cat(outs).cpu().numpy()
    # Map flat batch-slot outputs back to `indices` order (the -1 slots
    # dropped; a packed matrix is not sequential).
    flat_ids = ids.reshape(-1)
    sel = flat_ids >= 0
    fids, fouts = flat_ids[sel], outs[sel]
    order = np.argsort(fids)
    take = order[np.searchsorted(fids[order], np.asarray(indices))]
    outs = fouts[take]
    targs = data.y.cpu().numpy()[np.asarray(indices)]
    if outs.ndim == 1 and targs.ndim == 2 and targs.shape[1] == 1:
        targs = targs[:, 0]
    return loss, outs, targs
