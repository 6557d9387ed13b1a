"""Host-fed training and evaluation for disk-streaming datasets.

The port of the reference package's training/stream.py, the companion of
data/streaming.py: the dataset never enters device memory, and each step
reads one batch assembled on the host. Its functions keep their names
and semantics: `_epoch_ids`, `_ordered_batches`, `_packed_rows` and
`_train_id_batches` give the reference's id rows (the shard-local
shuffle, seed shuffle_seed_base + epoch; evaluation in sorted id order,
the outputs mapped back to request order), `_assembler` picks the wire or
the full batch, `_prefetch_batches` assembles ahead in a worker thread,
`stream_evaluate` evaluates, and `stream_trainer` trains with the
sample-weighted epoch error, best-val tracking, the plateau stepped on
the train error and checkpoints on improvement, epoch 1 the meter's
warmup. The epoch loop is the in-memory one (training/trainer.py's
fused_trainer: its EpochState, its captured tail, its checkpoints); only
the batch source differs, a `StreamFeed`:

  * a ring of depth + 1 buffer sets (`PinnedRing`), allocated once a Run
    and page-locked on a card, so no batch pins memory anew;
  * the worker thread only fills a free set (`fill` or `fill_wire`); it
    makes no CUDA call;
  * the main thread copies each filled set into the feed's static batch
    on the device (`non_blocking`, on the stream that runs the steps, so
    the copy lands after the step before it has read the last batch), then
    records an event; the set goes back to the worker only once that event
    has completed;
  * the steps read the static batch (a WireBatch expands inside them,
    data/streaming.py:expand_wire): as CUDA graphs where
    graphs.capture_plan allows, as the in-memory steps do;
  * the losses stay on the device, one host sync an epoch at most.

Under a dp mesh (parallel/mesh.py; the reference's ShardedStream) every
rank makes the same (dp·B)-wide id rows from the same seed, and fills only
its own replica's slots of each row through its ring; under ep each
member takes its edge shard of the batch (parallel/spmd.py).

On the CPU the same code runs eagerly, without pinning. depth 0 assembles
in the main thread, a set at a time (one set: each batch waits for the
copy of the one before). The worker is stopped and joined on every exit
from an epoch, an exception or an early end included, so no second
worker ever reads the dataset's shard cache beside it.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from matdeeplearn_torch.data.batching import (GraphBatch,
                                              packed_id_matrix_sharded)
from matdeeplearn_torch.data.streaming import WireBatch, expand_wire
from matdeeplearn_torch.parallel import spmd
from matdeeplearn_torch.training import train as T

_DONE = object()
# seconds a waiting worker sleeps between looks at the stop flag
_POLL_S = 0.05


def _epoch_ids(indices, batch_size: int, shuffle: bool, seed):
    """The reference package's batch_iterator rows over `indices`, -1 on
    the last row's pad slots."""
    indices = np.asarray(indices)
    n = len(indices)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        local = order[start:start + batch_size]
        local = np.concatenate([local, np.full(batch_size - len(local), -1)])
        yield np.where(local >= 0, indices[np.clip(local, 0, n - 1)], -1)


def _ordered_batches(order, batch_size: int):
    """Rows of `batch_size` ids in the given order, -1 on the last row's
    pad slots (one all-pad row for an empty order)."""
    n = len(order)
    steps = max(1, -(-n // batch_size))
    padded = np.full(steps * batch_size, -1, dtype=np.int64)
    padded[:n] = order
    for s in range(steps):
        yield padded[s * batch_size:(s + 1) * batch_size]


def _packed_rows(sds, order, spec, nominal_batch: int, dp: int = 1):
    """Packed (dp·B)-wide rows over a host order by sequential fill, which
    keeps the order, so shard-local shuffling keeps its locality inside
    each bin (the reference's packed_id_matrix_sharded)."""
    yield from packed_id_matrix_sharded(
        np.asarray(order), sds.node_counts(), sds.edge_counts(), spec,
        nominal_batch, dp, shuffle=False, seed=None)


def _train_id_batches(sds, indices, batch_size: int, seed, spec=None,
                      packed: bool = False, dp: int = 1):
    """One training epoch's id rows, dp·batch_size wide: the shard-local
    order where the dataset has one (a global shuffle decompresses about
    every shard a batch), else a seeded shuffle; packed bins with
    packed."""
    order_fn = getattr(sds, "shard_local_order", None)
    if order_fn is not None:
        order = order_fn(indices, seed)
    else:
        order = np.asarray(indices).copy()
        np.random.default_rng(seed).shuffle(order)
    if packed:
        return _packed_rows(sds, order, spec, batch_size, dp)
    return _ordered_batches(order, batch_size * dp)


def _eval_id_batches(sds, indices, batch_size: int, spec=None,
                     packed: bool = False, dp: int = 1):
    """An evaluation's id rows, in sorted id order: shards are contiguous
    id ranges, so a split in its own order would fault most of the shard
    cache every batch (the reference package measured about 118 s of
    decompression an eval pass at its 46k corpus)."""
    order = np.sort(np.asarray(indices))
    if packed:
        return _packed_rows(sds, order, spec, batch_size, dp)
    return _epoch_ids(order, batch_size * dp, shuffle=False, seed=None)


def _assembler(sds, spec, wire: bool):
    """fill(ids, buffers): the wire batch (fill_wire) or the full one."""
    if wire and hasattr(sds, "fill_wire"):
        return lambda ids, out: sds.fill_wire(ids, spec, out)
    return lambda ids, out: sds.fill(ids, spec, out)


class PinnedRing:
    """The host buffer sets of a feed and which of them the worker may
    fill. A set is free, filled (waiting in the prefetch queue) or in
    flight: its copy to the device issued, its event not yet seen
    complete. Only the main thread touches the in-flight list and the
    events; the free queue is the one thing the worker reads."""

    def __init__(self, sets: list):
        self.sets = sets
        self.free: queue.Queue = queue.Queue()
        for i in range(len(sets)):
            self.free.put(i)
        self.in_flight: collections.deque = collections.deque()

    def release(self, i: int, event):
        """Set i's copy is issued; event (None: already done) marks its
        end on the device."""
        if event is None:
            self.free.put(i)
        else:
            self.in_flight.append((i, event))

    def reclaim(self, wait: bool = False):
        """Free the sets whose copies have completed, oldest first; with
        wait, block on the oldest one's event first."""
        if wait and self.in_flight:
            self.in_flight[0][1].synchronize()
        while self.in_flight and self.in_flight[0][1].query():
            self.free.put(self.in_flight.popleft()[0])


def _prefetch_batches(id_rows, fill, ring: PinnedRing, depth: int = 2):
    """Yield (ids, set) with set's buffers holding the batch of ids, filled
    by fill(ids, buffers) in a worker thread up to `depth` batches ahead
    (depth 0: in this thread). The caller hands each set back through
    ring.release once its copy is issued. An exception in the worker
    re-raises here; every exit stops and joins the worker."""
    if depth <= 0:
        for ids in id_rows:
            ring.reclaim()
            while ring.free.empty():
                ring.reclaim(wait=True)
            i = ring.free.get_nowait()
            fill(ids, ring.sets[i])
            yield ids, i
        return
    ready: queue.Queue = queue.Queue()
    stop = threading.Event()

    def take_free():
        while not stop.is_set():
            try:
                return ring.free.get(timeout=_POLL_S)
            except queue.Empty:
                pass
        return None

    def worker():
        try:
            for ids in id_rows:
                i = take_free()
                if i is None:
                    return
                try:
                    fill(ids, ring.sets[i])
                except BaseException:
                    ring.free.put(i)
                    raise
                ready.put((ids, i))
        except BaseException as e:  # re-raised in the consuming thread
            ready.put(e)
            return
        ready.put(_DONE)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            ring.reclaim()
            if ready.empty() and ring.free.empty():
                # every set is in flight or being filled: the worker may
                # wait for one, so free the oldest copy's set
                ring.reclaim(wait=True)
            item = ready.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
        while not ready.empty():  # filled, never consumed: free again
            item = ready.get_nowait()
            if isinstance(item, tuple):
                ring.free.put(item[1])


class StreamFeed:
    """The batch source of a streamed Run: a dataset, its spec, the ring of
    host buffer sets and the one static batch on the device that every
    step reads (see the module docstring). bilinear marks its batches for
    MPNN's bilinear kernel (GraphBatch.kernel_bilinear). With a mesh the
    rows hold dp replicas' ids, this replica's slots are the ones filled,
    and batch_of gives this ep member's edge shard."""

    def __init__(self, sds, spec, device, wire: bool = True,
                 packed: bool = False, batch_size: int | None = None,
                 depth: int = 2, bilinear: bool = False, mesh=None):
        self.sds, self.spec, self.wire, self.packed = sds, spec, wire, packed
        self.mesh, self.dp = mesh, 1 if mesh is None else mesh.dp
        self.device = torch.device(device)
        self.batch_size = int(batch_size or spec.num_graphs)
        self.depth, self.bilinear = int(depth), bilinear
        pin = self.device.type == "cuda"
        self.ring = PinnedRing([sds.buffers(spec, wire, pin)
                                for _ in range(max(self.depth, 0) + 1)])
        self.static = {k: torch.zeros_like(t, device=self.device)
                       for k, t in self.ring.sets[0].items()}
        self.fill = _assembler(sds, spec, wire)

    def batch_of(self, static: dict) -> GraphBatch:
        """The GraphBatch of the static tensors (a wire batch expanded)."""
        batch = (expand_wire(WireBatch(**static)) if self.wire
                 else GraphBatch(**static))
        batch.kernel_bilinear = self.bilinear
        return spmd.slice_edge_shard(batch, self.mesh)

    def id_matrix(self, indices, shuffle: bool, seed) -> np.ndarray:
        """The rows of a training epoch (shuffle: the shard-local order of
        `seed`) or of an evaluation (sorted ids), as one matrix."""
        rows = (_train_id_batches(self.sds, indices, self.batch_size, seed,
                                  self.spec, self.packed, self.dp) if shuffle
                else _eval_id_batches(self.sds, indices, self.batch_size,
                                      self.spec, self.packed, self.dp))
        return np.stack([np.asarray(r, np.int64) for r in rows])

    def batches(self, rows):
        """Yield each row's ids once its batch (this replica's slots) is in
        self.static (its copy issued on the current stream, before anything
        queued after)."""
        fill = self.fill
        if self.dp > 1:
            def fill(ids, out):
                self.fill(spmd.local_ids(ids, self.mesh), out)
        source = _prefetch_batches(rows, fill, self.ring, self.depth)
        try:
            for ids, i in source:
                self.load(i)
                yield ids
        finally:  # stops and joins the worker on every exit
            source.close()

    def load(self, i: int):
        """Copy set i into the static batch (non_blocking, on the current
        stream) and hand the set back to the ring with the event that marks
        the copy's end."""
        host = self.ring.sets[i]
        for k, t in self.static.items():
            t.copy_(host[k], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.ring.release(i, event)

    def run(self, *parts):
        """For each (rows, step) of parts in turn, step(self.static) after
        each row's batch lands, all in one prefetch pass: a streamed epoch
        of the train step, then the eval step's, the first val batch
        assembled while the last train steps run (the reference's
        stream_train_epoch loop)."""
        steps = [step for rows, step in parts for _ in rows]
        batches = self.batches([row for rows, _ in parts for row in rows])
        try:
            for step, _ in zip(steps, batches):
                step(self.static)
        finally:
            batches.close()


def stream_evaluate(model, loss_name: str, feed: StreamFeed, indices,
                    out: bool = False):
    """The mean loss over `indices`, assembled in sorted id order; with
    `out` also the predictions and targets in `indices` order. Eager, in
    eval mode; one host sync at the end. A feed with a mesh runs the dp/ep
    eval step, whose outputs cover every replica's slots of a row."""
    model.eval()
    loss_fn = T.get_loss(loss_name)
    dev = feed.device
    loss_sum = torch.zeros((), device=dev)
    count_sum = torch.zeros((), device=dev)
    preds, fids = [], []
    rows = _eval_id_batches(feed.sds, indices, feed.batch_size, feed.spec,
                            feed.packed, feed.dp)
    for ids in feed.batches(rows):
        batch = feed.batch_of(feed.static)
        if feed.mesh is None:
            loss, count, pred = T.eval_batch(model, loss_fn, batch)
        else:
            loss, count, pred = spmd.eval_batch(model, loss_fn, batch,
                                                feed.mesh, out=out)
        loss_sum += loss * count
        count_sum += count
        if out:  # every slot's output; the pads go on the host
            preds.append(pred)
            fids.append(np.asarray(ids))
    err = float(loss_sum / torch.clamp(count_sum, min=1.0))
    if not out:
        return err
    fids = np.concatenate(fids)
    valid = fids >= 0
    preds = torch.cat(preds).float().cpu().numpy()[valid]
    fids = fids[valid]
    order = np.argsort(fids)
    take = order[np.searchsorted(fids[order], np.asarray(indices))]
    preds = preds[take]
    targs = feed.sds.targets[np.asarray(indices)]
    return err, preds, targs


def stream_trainer(*, model, optimizer, loss_fn, feed: StreamFeed, train_idx,
                   val_idx, epochs: int, verbosity: int, lr: float,
                   scheduler_kwargs: dict, **kwargs):
    """trainer.fused_trainer over the feed (its keywords pass through):
    returns (best state, final PlateauState, per-epoch history)."""
    from matdeeplearn_torch.training.trainer import fused_trainer

    return fused_trainer(
        model=model, optimizer=optimizer, loss_fn=loss_fn, spec=feed.spec,
        data=None, train_idx=train_idx, val_idx=val_idx,
        id_matrix_fn=feed.id_matrix, epochs=epochs, verbosity=verbosity,
        lr=lr, scheduler_kwargs=scheduler_kwargs, stream=feed, **kwargs)
