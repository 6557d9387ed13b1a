"""The epoch loop: training with best-val tracking and a plateau scheduler
on the train error, with one host sync per chunk of `verbosity` epochs.

The reference package's training/fused.py runs a chunk of epochs as one
on-device program (`make_fused_epochs_fn`, `fused_trainer`). Here the same
state machine runs as static device tensors (`EpochState`) that the host
never reads inside a chunk, and on a CUDA device its three parts run as
CUDA graphs (training/graphs.py): the train step, the eval step and the
epoch tail, each captured once and replayed. The CPU, and the runs that
`graphs.capture_plan` keeps eager, call the same three functions eagerly,
so a captured epoch does the eager epoch's arithmetic:

  * epoch e (counted from 1) trains on id_matrix_fn(train_idx,
    shuffle=True, seed=seed + e) (padded: train.epoch_id_matrix; packed:
    the run's bins, the same number of steps every epoch); each step adds
    its loss·count and count to the static sums, so the train error is the
    sample-weighted mean of the step losses, the epoch objective whatever
    the bins hold;
  * the val error is computed the same way; a NaN never improves;
  * `epoch_tail`: on improvement the parameters and BatchNorm statistics
    are copied into the best state (torch.where per tensor, in place, no
    branch on the host); after the best-val decision `plateau_step`
    (ReduceLROnPlateau, mode min, branchless) steps on the train error and
    sets the optimizer's rate (in place on the device for a tensor rate,
    see optimizers.py); the epoch's (train, val, lr before) row goes to a
    static buffer and the sums are zeroed;
  * once per chunk the host syncs, prints the reference's epoch line for
    the chunk's last epoch and calls `checkpoint_fn`; it makes the next
    chunk's id matrices before that sync, while the device trains.

The reference package's MDL_MAX_DISPATCH_S segmenting (`_segmented_trainer`)
works around a TPU runtime that kills long dispatches; CUDA launches and
graph replays have no such limit, and it is not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from matdeeplearn_torch.parallel import spmd
from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training.graphs import (CudaGraphs, GraphedStep,
                                                capture_plan, launch_counters)
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


class EpochState:
    """The epoch loop's device tensors, each allocated once and updated in
    place (a graph holds their addresses): the step sums, the best val
    error, the best state (a copy of every state_dict entry), the plateau
    state and the epoch's (train, val, lr before) row."""

    def __init__(self, model, lr: float, device):
        z = lambda: torch.zeros((), device=device)
        self.lsum, self.csum, self.vsum, self.vcnt = z(), z(), z(), z()
        self.best_val = z()
        self.best = {k: torch.empty_like(v)
                     for k, v in model.state_dict().items()}
        self.sched = plateau_init(lr, device)
        self.row = torch.zeros(3, device=device)
        self.reset(model, lr)

    def reset(self, model, lr: float):
        """A trainer call's start: zero sums, best val inf, the model's
        state as the best, the plateau state at `lr`."""
        for t in (self.lsum, self.csum, self.vsum, self.vcnt):
            t.zero_()
        self.best_val.fill_(float("inf"))
        for k, v in model.state_dict().items():
            self.best[k].copy_(v)
        self.sched.lr.fill_(lr)
        self.sched.best.fill_(float("inf"))
        self.sched.num_bad.zero_()
        self.sched.cooldown.zero_()


def _add_sums(loss, count, loss_sum, count_sum):
    loss_sum += loss * count
    count_sum += count


def epoch_tail(state: EpochState, model, optimizer, *, has_val: bool,
               scheduler_kwargs: dict, scheduler_enabled: bool):
    """The end of an epoch, in place on the state: the train and val
    errors, the best-val decision and the best state's copy, the plateau
    step on the train error, the optimizer's rate, the row; then the sums
    are zeroed."""
    state.row[2].copy_(state.sched.lr)
    train_error = state.lsum / torch.clamp(state.csum, min=1.0)
    if has_val:
        val_error = state.vsum / torch.clamp(state.vcnt, min=1.0)
        improved = val_error < state.best_val
    else:  # fills on the device: no host-to-device copy, no sync
        val_error = torch.full((), float("nan"), device=state.row.device)
        improved = torch.ones((), dtype=torch.bool, device=state.row.device)
    state.best_val.copy_(torch.where(improved & ~torch.isnan(val_error),
                                     val_error, state.best_val))
    for name, v in model.state_dict().items():
        best = state.best[name]
        best.copy_(torch.where(improved, v.detach(), best))
    # the scheduler steps on the *train* error, after the best-val decision
    # (reference training.py:193)
    new = plateau_step(state.sched, train_error, enabled=scheduler_enabled,
                       **scheduler_kwargs)
    if new is not state.sched:
        for old, value in zip(state.sched, new):
            old.copy_(value)
    set_learning_rate(optimizer, state.sched.lr)
    state.row[0].copy_(train_error)
    state.row[1].copy_(val_error)
    for t in (state.lsum, state.csum, state.vsum, state.vcnt):
        t.zero_()


class EpochFns:
    """The epoch's three functions, eager or as CUDA graphs: train(x),
    evaluate(x) and tail(), x what batch_of turns into a batch (a row of
    ids, or a streamed batch's device tensors). Captured, each reads its
    input from a static one: train_input and val_input, which the host
    fills by a device-to-device copy of x, unless x is that static input
    (the stream's feed copies into it itself, training/stream.py). With a
    mesh the steps are the dp/ep ones (parallel/spmd.py), whose losses and
    counts are the replicas' sums, the same on every rank, so every rank's
    tail takes the same decisions."""

    def __init__(self, *, model, optimizer, loss_fn, batch_of,
                 state: EpochState, tail_kwargs: dict, graphs: bool,
                 train_input=None, val_input=None, mesh=None):
        self.state = state
        reducer = None if mesh is None else spmd.StepReducer(model, mesh)

        def train(x):
            if mesh is None:
                loss, count = T.train_batch(model, optimizer, loss_fn,
                                            batch_of(x))
            else:
                loss, count = spmd.train_batch(model, optimizer, loss_fn,
                                               batch_of(x), reducer)
            _add_sums(loss, count, state.lsum, state.csum)

        def evaluate(x):
            model.eval()
            if mesh is None:
                loss, count, _ = T.eval_batch(model, loss_fn, batch_of(x))
            else:
                loss, count, _ = spmd.eval_batch(model, loss_fn, batch_of(x),
                                                 mesh)
            _add_sums(loss, count, state.vsum, state.vcnt)

        def tail():
            epoch_tail(state, model, optimizer, **tail_kwargs)

        if not graphs:
            self.train, self.evaluate, self.tail = train, evaluate, tail
            return
        gens = getattr(model, "dropout_generators", list)
        backend, counters = CudaGraphs(gens), launch_counters()
        graphed_train = GraphedStep(lambda: train(train_input), backend,
                                    counters)
        graphed_eval = GraphedStep(lambda: evaluate(val_input), backend,
                                   counters)

        # closures over the inputs and graphs, never over self: no
        # reference cycle keeps a dropped run's graph pool alive until a
        # garbage collection
        def replay_train(x):
            if x is not train_input:
                train_input.copy_(x)
            graphed_train()

        def replay_eval(x):
            if x is not val_input:
                val_input.copy_(x)
            graphed_eval()

        self.train, self.evaluate = replay_train, replay_eval
        self.tail = GraphedStep(tail, backend, counters)


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
                  meter=None, capture: bool | None = None,
                  graph_cache: dict | None = None, start_epoch: int = 0,
                  plateau_start: tuple | None = None, chunk_fn=None,
                  stream=None, mesh=None):
    """Run `epochs` epochs in chunks of `verbosity`. Returns (best_state,
    final PlateauState, history): best_state a state_dict copy (the model
    itself holds the last state), history one (train, val, lr) row of floats
    per epoch, read at the chunk syncs.

    capture: None runs CUDA graphs where graphs.capture_plan allows it
    (a CUDA device, a capturable optimizer) and eagerly elsewhere; True
    captures or raises; False runs eagerly. graph_cache, a dict the caller
    keeps (jobs.Run.graphs), holds the graphs and their static state
    across calls, keyed by the shapes and constants a graph bakes in: a
    later call with the same key replays without capturing again. The
    caller clears it when it replaces the parameters or the optimizer's
    state.

    checkpoint_fn(best_state, best_val, sched), if given, is called after
    every chunk with best_val as a float. meter (utils/profiling.py's
    ThroughputMeter), if given, takes each chunk's epochs, steps and seconds
    from its start to after its sync; a chunk shape's first chunk counts as
    warmup (the kernels' build at first use, a capture), as the reference
    package counts compile. model.training is left as an eager run leaves
    it: eval mode after a run with a val split, training mode without.

    id_matrix_fn(indices, shuffle, seed) makes the id matrices of the
    train epochs and of the val split (train.epoch_id_matrix's padded rows,
    or packed bins).

    A run resumed mid-training (training/hyper.py) passes start_epoch, the
    epochs already trained (this call's epochs are numbered and shuffled
    from start_epoch + 1), and plateau_start, the scheduler's (lr, best,
    num_bad, cooldown) to continue from. chunk_fn(epoch, rows, sched), if
    given, is called after every chunk (and its checkpoint_fn) with the
    last epoch's number, the chunk's (train, val, lr) rows and the plateau
    state; a true return ends the training there.

    stream (training/stream.py's StreamFeed), if given, feeds the epochs
    from a disk-streaming dataset: each row of id_matrix_fn's matrices is
    assembled on the host, through the feed's prefetch ring, and copied
    into the feed's static batch on the device, which the steps read
    (captured or eager); data is not read. A meter then takes each
    streamed epoch, synced at its end, the call's first as warmup (the
    reference package's stream_trainer).

    mesh (parallel/mesh.py), if given, trains this process's part of a
    (dp, ep) mesh: id_matrix_fn's rows hold dp replicas' ids (dp·B
    slots), this replica assembles its slots and this ep member keeps its
    edge shard (spmd.local_batch, or the feed's batch_of), and the steps
    are the dp/ep ones; the errors, the best-val decision and the plateau
    are the whole mesh's, the same on every rank."""
    dev = data.device if stream is None else stream.device
    plan = capture_plan(dev, optimizer, model, capture, mesh=mesh)
    has_val = len(val_idx) > 0
    val_ids = id_matrix_fn(val_idx, False, None) if has_val else None
    if stream is None and has_val:
        val_ids = torch.as_tensor(val_ids, device=dev)
    chunk = max(1, int(verbosity) or 5)
    graph_cache = {} if graph_cache is None else graph_cache

    def epoch_fns(train_shape) -> EpochFns:
        """The run's epoch functions: eager ones on a fresh state, or the
        cached graphs of these shapes (their state reset), or new ones."""
        key = ("stream" if stream is not None else train_shape,
               None if val_ids is None else tuple(val_ids.shape),
               spec, loss_fn, tuple(sorted(scheduler_kwargs.items())),
               scheduler_enabled)
        if plan.graphs and key in graph_cache:
            graph_cache[key].state.reset(model, lr)
            return graph_cache[key]
        if stream is not None:  # the feed fills one static batch
            batch_of = stream.batch_of
            train_input = val_input = stream.static
        else:
            batch_of = lambda ids: spmd.local_batch(data, ids, spec, mesh)  # noqa: E731
            train_input = val_input = None
            if plan.graphs:
                train_input = torch.full((train_shape[1],), -1,
                                         dtype=torch.int32, device=dev)
                val_input = torch.full(
                    (0 if val_ids is None else val_ids.shape[1],), -1,
                    dtype=torch.int32, device=dev)
        fns = EpochFns(
            model=model, optimizer=optimizer, loss_fn=loss_fn,
            batch_of=batch_of, state=EpochState(model, lr, dev),
            graphs=plan.graphs,
            tail_kwargs=dict(has_val=has_val, scheduler_kwargs=scheduler_kwargs,
                             scheduler_enabled=scheduler_enabled),
            train_input=train_input, val_input=val_input, mesh=mesh)
        if plan.graphs:
            graph_cache[key] = fns
        return fns

    def chunk_ids(start: int) -> list:
        """The (S, B) id matrices of the chunk of epochs after `start`."""
        return [id_matrix_fn(train_idx, True,
                             shuffle_seed_base + start_epoch + start + e + 1)
                for e in range(min(chunk, epochs - start))]

    fns = None
    history = []
    epoch = 0
    t0 = time.time()
    next_ids = chunk_ids(0) if epochs > 0 else None
    while epoch < epochs:
        ids = (next_ids if stream is not None
               else torch.as_tensor(np.stack(next_ids), device=dev))
        k = len(ids)
        if fns is None:
            fns = epoch_fns(tuple(ids[0].shape))
            if plateau_start is not None:
                for t, v in zip(fns.state.sched, plateau_start):
                    t.fill_(v)
        state = fns.state
        hist = torch.empty((k, 3), device=dev)
        for e in range(k):
            t_epoch = time.time()
            if stream is None:
                for row in ids[e]:
                    fns.train(row)
                if has_val:
                    for row in val_ids:
                        fns.evaluate(row)
            else:
                stream.run((ids[e], fns.train),
                           *([(val_ids, fns.evaluate)] if has_val else []))
            fns.tail()
            hist[e].copy_(state.row)
            if stream is not None and meter is not None:
                # a streamed epoch is the meter's unit (the reference
                # package's stream_trainer): this call's first is warmup
                hist[e].cpu()  # the epoch's sync
                first = epoch + e == 0
                meter.add_chunk(1, len(ids[e]), time.time() - t_epoch,
                                key=("stream", len(ids[e])) if first else None,
                                warmup=None if first else False)
        # the next chunk's batches (packed bins: host numpy) while the
        # device runs this one
        next_ids = chunk_ids(epoch + k) if epoch + k < epochs else None
        if plan.graphs:  # the mode an eager epoch leaves (a replay sets none)
            model.train(not has_val)
        epoch += k
        rows = hist.cpu().numpy().astype(float)  # the sync
        history += [tuple(r) for r in rows]
        dt_chunk = time.time() - t0
        dt = dt_chunk / k
        if meter is not None and stream is None:
            n_steps = ids.shape[1]
            meter.add_chunk(k, k * n_steps, dt_chunk,
                            key=("graphs" if plan.graphs else "eager", k,
                                 n_steps))
            if meter.flops_per_epoch == 0.0:
                fwd = _forward_flops(model, loss_fn, spec, data,
                                     spmd.local_ids(ids[0, 0], mesh))
                if fwd:
                    meter.flops_per_epoch = fwd * (
                        3 * n_steps + (len(val_ids) if has_val else 0))
        if verbosity:
            train_err, val_err, lr_now = rows[-1]
            print(
                "Epoch: {:04d}, Learning Rate: {:.6f}, Training Error: {:.5f},"
                " Val Error: {:.5f}, Time per epoch (s): {:.5f}".format(
                    start_epoch + epoch, lr_now, train_err, val_err, dt
                )
            )
        if checkpoint_fn is not None:
            checkpoint_fn(state.best, float(state.best_val), state.sched)
        if chunk_fn is not None and chunk_fn(start_epoch + epoch, rows,
                                             state.sched):
            break
        t0 = time.time()
    state = EpochState(model, lr, dev) if fns is None else fns.state
    best = {k: v.clone() for k, v in state.best.items()}
    sched = PlateauState(*(t.clone() for t in state.sched))
    return best, sched, history
