"""CUDA graphs of the epoch loop's steps: the port's counterpart of the
reference package's one device program per chunk of epochs
(training/fused.py:make_fused_epochs_fn).

The trainer (training/trainer.py) captures three functions on a CUDA
device: the train step, the eval step and the epoch tail. Each is one
small graph replayed as often as the epoch needs it, so an epoch of S
steps costs the host about 2·S launches (a copy of the step's ids into
the graph's static buffer, then the replay) instead of thousands.

  * `capture_plan` decides, as a pure function of the device, the
    optimizer and the model, whether a run captures; where it does not, it
    says why (the `resolved:` line prints it);
  * `GraphedStep` runs a function eagerly at its first call (the lazy
    initialisations: the optimizer's state, the kernels' build at first
    use, AccumulateGrad) and captures it right after, which runs nothing;
    every later call replays it, so every call does its work exactly once
    and every capture falls in a run's first epoch;
  * the hand kernels' wrappers bump their `LAUNCHES` counters when Python
    calls them, which under a graph is once, at capture. `GraphedStep`
    takes the capture's counter deltas back out and adds them again at
    every replay (host arithmetic, no sync), so the counts are those of
    an eager run.

Graphs bake in the addresses of every tensor they touch (parameters,
gradients, optimizer state, the static buffers) and the Python values of
their capture (model.train()/eval(), the scheduler's constants). A graph
is only valid while those tensors live: replacing the optimizer's state or
the parameters means capturing anew (jobs.Run.graphs).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# torch.cuda.CUDAGraph.register_generator_state: a graph then draws from
# a generator other than the default one (the model's dropout generator)
# at a fresh offset every replay, as the eager run would
GENERATOR_API = hasattr(torch._C._CUDAGraph, "register_generator_state")

# graphs captured so far in this process (GraphedStep): a run that reuses
# its graphs (a later CV fold or Repeat trial, jobs.reset_run) adds none
CAPTURES = {"graphs": 0}


class CapturePlan(NamedTuple):
    """Whether the trainer runs CUDA graphs, and if not, why."""

    graphs: bool
    reason: str = ""

    def __str__(self) -> str:
        return "graphs" if self.graphs else f"eager ({self.reason})"


def capture_plan(device, optimizer, model, request: bool | None = None, *,
                 generator_api: bool = GENERATOR_API,
                 mesh=None) -> CapturePlan:
    """The capture plan of a training run.

    request None: graphs where they give the eager run's arithmetic, eager
    otherwise; True: graphs or a ValueError naming the reason; False:
    eager. Eager where:
      * the device is not CUDA;
      * an optimizer group's rate is a float (SGD, RMSprop, Adagrad; Adam
        and AdamW on the CPU): the plateau scheduler sets it from the host
        (optimizers.set_learning_rate), and a graph would keep the rate
        of its capture;
      * the model draws dropout masks under remat: the recomputation
        rewinds the model's generator to where the forward started
        (models/base.py), which a replayed graph cannot do;
      * the model draws dropout masks and this torch has no
        CUDAGraph.register_generator_state;
      * the steps' collectives run on gloo (a mesh whose ranks share a
        card, parallel/mesh.py), which a graph cannot capture; NCCL's can.
    """
    reason = ""
    dropout = float(getattr(model, "dropout_rate", 0.0) or 0.0)
    if request is False:
        reason = "capture=False"
    elif torch.device(device).type != "cuda":
        reason = "not on a CUDA device"
    elif not all(g.get("capturable", False) and torch.is_tensor(g["lr"])
                 for g in optimizer.param_groups):
        reason = (f"{type(optimizer).__name__} takes a float learning rate, "
                  "which a graph would keep at its capture's value")
    elif dropout > 0 and getattr(model, "remat", False):
        reason = ("dropout under remat: the recomputation rewinds the "
                  "model's generator, which a graph cannot replay")
    elif dropout > 0 and not generator_api:
        reason = ("dropout needs CUDAGraph.register_generator_state, which "
                  "this torch lacks")
    elif mesh is not None and not mesh.captures:
        reason = "the mesh's gloo collectives cannot be captured"
    if reason and request:
        raise ValueError(f"capture=True, but the run cannot capture: {reason}")
    return CapturePlan(not reason, reason)


def launch_counters() -> list[dict]:
    """The hand kernels' launch counters (the ops modules' LAUNCHES, the
    bilinear kernels' bf16 arm's LAUNCHES_BF16 and the single-pass arms'
    LAUNCHES_SP)."""
    from matdeeplearn_torch.ops import (csr, fused_bilinear, fused_cfconv,
                                        fused_cgconv, windowed)

    return [csr.LAUNCHES, fused_cgconv.LAUNCHES, fused_cfconv.LAUNCHES,
            fused_bilinear.LAUNCHES, fused_bilinear.LAUNCHES_BF16,
            windowed.LAUNCHES, csr.LAUNCHES_SP, fused_cgconv.LAUNCHES_SP,
            fused_cfconv.LAUNCHES_SP, windowed.LAUNCHES_SP]


# one warm-up side stream a device for every run: cuBLAS keeps a workspace
# (32 MiB on an H100) for every stream it has run on, for the life of the
# process, so a new stream a warm-up grew device memory by about 98 MiB a
# run (three GraphedSteps), trial after trial of a sweep
_SIDE_STREAMS: dict = {}


def _side_stream() -> torch.cuda.Stream:
    dev = torch.cuda.current_device()
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream()
    return _SIDE_STREAMS[dev]


class CudaGraphs:
    """How GraphedStep runs on a card: the eager call on a side stream (the
    PyTorch recipe for a warm-up before capture; one stream a device for
    the process, _side_stream), captures into one memory
    pool shared by every graph of the epoch (they replay one after another
    on one stream, and what must outlive a replay lives outside the pool),
    with the model's dropout generators registered."""

    def __init__(self, generators: Callable[[], list] = list):
        self.pool = torch.cuda.graph_pool_handle()
        self.generators = generators

    def eager(self, fn):
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators():
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        return graph


class GraphedStep:
    """fn() as a graph: the first call runs it eagerly and then captures it
    (a capture runs nothing), so every capture of an epoch's functions
    falls in the first epoch; every later call replays. Each replay adds
    the capture's launch-counter deltas to `counters`."""

    def __init__(self, fn: Callable[[], None], backend, counters: list[dict]):
        self.fn, self.backend, self.counters = fn, backend, counters
        self.graph = None
        self.delta: list[dict] = []

    def __call__(self):
        if self.graph is None:
            self.backend.eager(self.fn)
            self._capture()
            return
        self.graph.replay()
        for c, d in zip(self.counters, self.delta):
            for k, v in d.items():
                c[k] += v

    def _capture(self):
        before = [dict(c) for c in self.counters]
        try:
            self.graph = self.backend.capture(self.fn)
            CAPTURES["graphs"] += 1
        finally:  # the capture launched nothing
            self.delta = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                          for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.update(b)
