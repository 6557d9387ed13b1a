"""The epoch loop: training with best-val tracking and a plateau scheduler
on the train error, with one host sync per chunk of `verbosity` epochs.

The reference package's training/fused.py runs a chunk of epochs as one
on-device program (`make_fused_epochs_fn`, `fused_trainer`). PyTorch runs
eagerly, so here the same state machine runs as device tensors that the
host never reads inside a chunk:

  * epoch e (counted from 1) trains on id_matrix_fn(train_idx,
    shuffle=True, seed=seed + e) (padded: train.epoch_id_matrix; packed:
    the run's bins, the same number of steps every epoch); the train error
    is the sample-weighted mean of the step losses, summed on the device,
    so it is the epoch objective whatever the bins hold;
  * the val error is computed the same way; a NaN never improves;
  * on improvement a copy of the parameters and BatchNorm statistics
    becomes the best state (torch.where per tensor, no branch on the host);
  * after the best-val decision, `plateau_step` (ReduceLROnPlateau,
    mode min, branchless) steps on the train error and sets the optimizer's
    rate (in place on the device for a tensor rate, see optimizers.py);
  * once per chunk the host syncs, prints the reference's epoch line for
    the chunk's last epoch and calls `checkpoint_fn`.

The reference package's MDL_MAX_DISPATCH_S segmenting (`_segmented_trainer`)
works around a TPU runtime that kills long dispatches; eager CUDA launches
have no such limit, and it is not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training.optimizers import set_learning_rate
from matdeeplearn_torch.utils.profiling import op_cost


class PlateauState(NamedTuple):
    lr: torch.Tensor        # current learning rate
    best: torch.Tensor      # best metric seen
    num_bad: torch.Tensor   # epochs without sufficient improvement
    cooldown: torch.Tensor  # cooldown counter


def plateau_init(lr: float, device="cpu") -> PlateauState:
    return PlateauState(
        lr=torch.tensor(lr, dtype=torch.float32, device=device),
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        num_bad=torch.zeros((), dtype=torch.int32, device=device),
        cooldown=torch.zeros((), dtype=torch.int32, device=device),
    )


def plateau_step(state: PlateauState, metric: torch.Tensor, *, factor: float,
                 patience: int, threshold: float, min_lr: float,
                 cooldown: int = 0, threshold_mode: str = "rel",
                 enabled: bool = True) -> PlateauState:
    """One scheduler step (torch ReduceLROnPlateau, mode='min'), branchless
    on the device (the reference package's training/fused.py:plateau_step)."""
    if not enabled:
        return state
    if threshold_mode == "rel":
        is_better = metric < state.best * (1.0 - threshold)
    else:
        is_better = metric < state.best - threshold
    zero = torch.zeros_like(state.num_bad)
    best = torch.where(is_better, metric, state.best)
    num_bad = torch.where(is_better, zero, state.num_bad + 1)
    in_cooldown = state.cooldown > 0
    cd = torch.where(in_cooldown, state.cooldown - 1, zero)
    num_bad = torch.where(in_cooldown, zero, num_bad)
    reduce_now = num_bad > patience
    lr = torch.where(reduce_now, torch.clamp(state.lr * factor, min=min_lr),
                     state.lr)
    cd = torch.where(reduce_now, torch.full_like(cd, cooldown), cd)
    num_bad = torch.where(reduce_now, zero, num_bad)
    return PlateauState(lr=lr, best=best, num_bad=num_bad, cooldown=cd)


def _snapshot(model) -> dict:
    """Detached copies of the parameters and buffers (the best state)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _forward_flops(model, loss_fn, spec, data, row) -> float | None:
    """FLOPs of one eval-mode forward of the batch `row` (op_cost; the
    hand kernels are opaque to it), for a meter with no analytic count."""
    model.eval()
    with torch.no_grad():
        return op_cost(T.eval_step, model, loss_fn, spec, data, row)


def fused_trainer(*, model, optimizer, loss_fn, spec, data, train_idx, val_idx,
                  id_matrix_fn, epochs: int, verbosity: int, lr: float,
                  scheduler_kwargs: dict, scheduler_enabled: bool = True,
                  checkpoint_fn=None, shuffle_seed_base: int = 0,
                  meter=None):
    """Run `epochs` epochs in chunks of `verbosity`. Returns (best_state,
    final PlateauState, history): best_state a state_dict copy (the model
    itself holds the last state), history one (train, val, lr) row of floats
    per epoch, read at the chunk syncs.

    checkpoint_fn(best_state, best_val, sched), if given, is called after
    every chunk with best_val as a float. meter (utils/profiling.py's
    ThroughputMeter), if given, takes each chunk's epochs, steps and seconds
    from its start to after its sync; a chunk shape's first chunk counts as
    warmup (the kernels' build at first use), as the reference package
    counts compile.

    id_matrix_fn(indices, shuffle, seed) makes the id matrices of the
    train epochs and of the val split (train.epoch_id_matrix's padded rows,
    or packed bins)."""
    dev = data.device
    has_val = len(val_idx) > 0
    val_ids = (torch.as_tensor(id_matrix_fn(val_idx, False, None), device=dev)
               if has_val else None)
    sched = plateau_init(lr, dev)
    best_val = torch.tensor(float("inf"), device=dev)
    best = _snapshot(model)
    history = []
    chunk = max(1, int(verbosity) or 5)
    epoch = 0
    t0 = time.time()
    while epoch < epochs:
        k = min(chunk, epochs - epoch)
        ids = torch.as_tensor(np.stack([
            id_matrix_fn(train_idx, True, shuffle_seed_base + epoch + e + 1)
            for e in range(k)
        ]), device=dev)
        metrics = []
        for e in range(k):
            lr_before = sched.lr
            lsum = torch.zeros((), device=dev)
            csum = torch.zeros((), device=dev)
            for row in ids[e]:
                loss, count = T.train_step(model, optimizer, loss_fn, spec,
                                           data, row)
                lsum += loss * count
                csum += count
            train_error = lsum / torch.clamp(csum, min=1.0)
            if has_val:
                vl, vc = T.eval_sums(model, loss_fn, spec, data, val_ids)
                val_error = vl / torch.clamp(vc, min=1.0)
                improved = val_error < best_val
            else:  # fills on the device: no host-to-device copy, no sync
                val_error = torch.full((), float("nan"), device=dev)
                improved = torch.ones((), dtype=torch.bool, device=dev)
            best_val = torch.where(improved & ~torch.isnan(val_error),
                                   val_error, best_val)
            for name, v in model.state_dict().items():
                best[name] = torch.where(improved, v.detach(), best[name])
            # the scheduler steps on the *train* error, after the best-val
            # decision (reference training.py:193)
            sched = plateau_step(sched, train_error, enabled=scheduler_enabled,
                                 **scheduler_kwargs)
            set_learning_rate(optimizer, sched.lr)
            metrics.append(torch.stack([train_error, val_error, lr_before]))
        epoch += k
        rows = torch.stack(metrics).cpu().numpy().astype(float)  # the sync
        history += [tuple(r) for r in rows]
        dt_chunk = time.time() - t0
        dt = dt_chunk / k
        if meter is not None:
            meter.add_chunk(k, k * ids.shape[1], dt_chunk,
                            key=("fused", k, ids.shape[1]))
            if meter.flops_per_epoch == 0.0:
                fwd = _forward_flops(model, loss_fn, spec, data, ids[0, 0])
                if fwd:
                    meter.flops_per_epoch = fwd * (
                        3 * ids.shape[1] + (len(val_ids) if has_val else 0))
        if verbosity:
            train_err, val_err, lr_now = rows[-1]
            print(
                "Epoch: {:04d}, Learning Rate: {:.6f}, Training Error: {:.5f},"
                " Val Error: {:.5f}, Time per epoch (s): {:.5f}".format(
                    epoch, lr_now, train_err, val_err, dt
                )
            )
        if checkpoint_fn is not None:
            checkpoint_fn(best, float(best_val), sched)
        t0 = time.time()
    return best, sched, history
