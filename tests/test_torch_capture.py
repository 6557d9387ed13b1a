"""The trainer's CUDA-graph machinery on the CPU (training/graphs.py,
training/trainer.py), against the JAX package where it has a counterpart.

* The capture plan: eager on the CPU, graphs for CUDA with AdamW or Adam
  (a tensor rate, capturable), eager with the reason for SGD, RMSprop and
  Adagrad (a float rate), for dropout under remat and for dropout without
  CUDAGraph.register_generator_state; capture=True raises where the plan
  says eager, on the CPU too; the `resolved:` line prints the plan.
* The in-place `epoch_tail` against the JAX package's
  training/fused.py:plateau_step and its best-val select (make_fused_
  epochs_fn), over a scripted sequence of train and val errors with a NaN
  val, a cooldown, both threshold modes, a min_lr floor, the scheduler
  disabled and no val split: the same rows, best val, best state, plateau
  state and optimizer rate (exact: the same f32 operations), and every
  static tensor keeps its storage across epochs.
* The launch-count accounting of replays, with a fake graph: a capture's
  counter bumps are taken back out and added again at every replay.
* The graphs' control flow with a fake graph whose replay runs the
  captured function: every step runs exactly once (the first call eager
  and then captured, the later ones replayed), so the history, the
  parameters and
  the AdamW step count equal the eager trainer's exactly; a second
  run_fused_training on the same Run captures nothing new, and
  Run.load_optimizer_state drops the cached graphs, which no reference
  cycle keeps alive.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.training import fused as JF
from matdeeplearn_torch.nn.layers import Linear, MaskedBatchNorm
from matdeeplearn_torch.training import graphs as G
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import trainer as TR
from matdeeplearn_torch.training.optimizers import (build_optimizer,
                                                    get_learning_rate)

MODEL = {"model": "CGCNN", "dim1": 16, "dim2": 12, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "True", "dropout_rate": 0.0, "print_model": False}
CUDA = torch.device("cuda")


class _Model(torch.nn.Module):
    """A parameter tree with a BatchNorm's buffers, and the GNNs' dropout
    and remat attributes."""

    def __init__(self, dropout_rate=0.0, remat=False):
        super().__init__()
        self.lin = Linear(3, 2, generator=torch.Generator().manual_seed(0))
        self.bn = MaskedBatchNorm(2)
        self.dropout_rate, self.remat = dropout_rate, remat


def _capturable(name):
    """The optimizer build_optimizer makes on a card: a tensor rate,
    capturable (built here on CPU parameters)."""
    cls = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam}[name]
    return cls(_Model().parameters(), lr=torch.tensor(1e-3), capturable=True)


# -------------------------------------------------------------------- plan


@pytest.mark.parametrize("name", ["AdamW", "Adam"])
def test_plan_captures_capturable_optimizers_on_cuda(name):
    plan = G.capture_plan(CUDA, _capturable(name), _Model())
    assert plan.graphs and str(plan) == "graphs"
    assert G.capture_plan(CUDA, _capturable(name), _Model(), True).graphs


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD", "RMSprop",
                                  "Adagrad"])
def test_plan_is_eager_on_the_cpu(name):
    opt = build_optimizer(name, _Model().parameters(), 1e-3, {}, "cpu")
    plan = G.capture_plan("cpu", opt, _Model())
    assert not plan.graphs
    assert str(plan) == "eager (not on a CUDA device)"
    with pytest.raises(ValueError, match="not on a CUDA device"):
        G.capture_plan("cpu", opt, _Model(), True)
    assert str(G.capture_plan("cpu", opt, _Model(), False)) == \
        "eager (capture=False)"


@pytest.mark.parametrize("name", ["SGD", "RMSprop", "Adagrad"])
def test_plan_keeps_float_rate_optimizers_eager(name):
    opt = build_optimizer(name, _Model().parameters(), 1e-3, {}, "cpu")
    plan = G.capture_plan(CUDA, opt, _Model())
    assert not plan.graphs
    assert plan.reason.startswith(f"{name} takes a float learning rate")
    with pytest.raises(ValueError, match=f"{name} takes a float"):
        G.capture_plan(CUDA, opt, _Model(), True)
    assert str(G.capture_plan(CUDA, _capturable("AdamW"), _Model(),
                              False)) == "eager (capture=False)"


def test_plan_for_dropout():
    opt = _capturable("AdamW")
    assert G.capture_plan(CUDA, opt, _Model(0.1), generator_api=True).graphs
    plan = G.capture_plan(CUDA, opt, _Model(0.1), generator_api=False)
    assert not plan.graphs and "register_generator_state" in plan.reason
    plan = G.capture_plan(CUDA, opt, _Model(0.1, remat=True),
                          generator_api=True)
    assert not plan.graphs and plan.reason.startswith("dropout under remat")
    with pytest.raises(ValueError, match="dropout under remat"):
        G.capture_plan(CUDA, opt, _Model(0.1, remat=True), True,
                       generator_api=True)
    # remat alone draws nothing: it captures
    assert G.capture_plan(CUDA, opt, _Model(0.0, remat=True),
                          generator_api=False).graphs


def test_capture_true_on_the_cpu_raises(toy_dataset, capsys):
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": "xla"}, "l1_loss",
                       seed=3, device="cpu")
    assert "capture=eager (not on a CUDA device)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not on a CUDA device"):
        TJ.run_fused_training(run, train_idx=np.arange(12),
                              val_idx=np.arange(12, 16), epochs=1,
                              verbosity=1, seed=3, capture=True)


# ------------------------------------------------------- epoch tail vs JAX

SCHED = {
    "rel_cooldown": dict(factor=0.5, patience=1, threshold=1e-2, min_lr=3e-3,
                         cooldown=2, threshold_mode="rel"),
    "abs": dict(factor=0.3, patience=0, threshold=0.05, min_lr=1e-3,
                cooldown=0, threshold_mode="abs"),
}
# (train error, val error) per epoch: a NaN val, plateaus, improvements,
# then a rise long enough for three reductions under a cooldown of 2
ERRORS = [(1.0, 0.9), (0.99, 0.95), (0.985, float("nan")), (0.7, 0.5),
          (0.72, 0.52), (0.71, 0.51), (0.705, 0.45), (0.704, float("nan")),
          (0.9, 0.6), (0.5, 0.44)] + [(0.6 + 0.01 * i, 0.5) for i in range(8)]


@pytest.mark.parametrize("case", ["rel_cooldown", "abs", "disabled",
                                  "no_val"])
def test_epoch_tail_matches_jax(case):
    sk = SCHED["abs" if case == "abs" else "rel_cooldown"]
    enabled, has_val = case != "disabled", case != "no_val"
    lr = 0.02
    model = _Model()
    opt = build_optimizer("AdamW", model.parameters(), lr, {}, "cpu")
    state = TR.EpochState(model, lr, "cpu")
    statics = ([state.lsum, state.csum, state.vsum, state.vcnt,
                state.best_val, state.row, *state.sched]
               + list(state.best.values()))
    ptrs = [t.data_ptr() for t in statics]
    jsched = JF.plateau_init(lr)
    jbest_val = jnp.asarray(jnp.inf, jnp.float32)
    jbest = {k: jnp.asarray(v.numpy()) for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    count = 4.0  # err·4 is exact in f32, so lsum/csum gives err back
    for train_err, val_err in ERRORS:
        with torch.no_grad():
            for v in model.state_dict().values():
                v.copy_(torch.as_tensor(rng.standard_normal(v.shape),
                                        dtype=v.dtype))
        state.lsum += np.float32(train_err) * count
        state.csum += count
        if has_val:
            state.vsum += np.float32(val_err) * count
            state.vcnt += count
        TR.epoch_tail(state, model, opt, has_val=has_val, scheduler_kwargs=sk,
                      scheduler_enabled=enabled)

        # the reference: make_fused_epochs_fn's epoch body
        lr_before = jsched.lr
        train = jnp.float32(train_err)
        if has_val:
            val = jnp.float32(val_err)
            improved = val < jbest_val
        else:
            val, improved = jnp.asarray(jnp.nan), jnp.asarray(True)
        jbest_val = jnp.where(improved & ~jnp.isnan(val), val, jbest_val)
        params = {k: jnp.asarray(v.numpy())
                  for k, v in model.state_dict().items()}
        jbest = {k: jnp.where(improved, params[k], jbest[k]) for k in jbest}
        jsched = JF.plateau_step(jsched, train, enabled=enabled, **sk)

        np.testing.assert_array_equal(
            state.row.numpy(),
            np.array([train, val, lr_before], np.float32))
        np.testing.assert_array_equal(state.best_val.numpy(),
                                      np.asarray(jbest_val))
        for k, v in state.best.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jbest[k]), k)
        for name, t in zip(TR.PlateauState._fields, state.sched):
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(jsched, name)),
                                          name)
        assert get_learning_rate(opt) == pytest.approx(float(jsched.lr),
                                                       rel=1e-7)
        for t in (state.lsum, state.csum, state.vsum, state.vcnt):
            assert float(t) == 0.0
        assert [t.data_ptr() for t in statics] == ptrs
    if enabled:  # the sequence reached a reduction and the min_lr floor
        assert float(jsched.lr) == pytest.approx(sk["min_lr"])


# ---------------------------------------------------------- launch counts


class _CountingBackend:
    """Eager and capture both run fn's Python (the wrappers bump their
    counters); a replay runs no Python, as a CUDA graph's does not."""

    def __init__(self):
        self.captures = self.replays = 0

    def eager(self, fn):
        fn()

    def capture(self, fn):
        self.captures += 1
        fn()
        backend = self

        class Graph:
            def replay(self):
                backend.replays += 1

        return Graph()


def test_replays_add_the_capture_launch_counts():
    counters = [{"a": 0, "b": 5}, {"c": 0}]

    def step():  # as a step's wrappers would: 2 of a, 1 of c, none of b
        counters[0]["a"] += 2
        counters[1]["c"] += 1

    backend = _CountingBackend()
    graphed = G.GraphedStep(step, backend, counters)
    graphed()  # eager, then the capture (counted back out)
    assert backend.captures == 1 and backend.replays == 0
    assert counters == [{"a": 2, "b": 5}, {"c": 1}]
    graphed()  # a replay
    assert backend.captures == 1 and backend.replays == 1
    assert counters == [{"a": 4, "b": 5}, {"c": 2}]
    for _ in range(5):
        graphed()
    assert backend.captures == 1 and backend.replays == 6
    assert counters == [{"a": 14, "b": 5}, {"c": 7}]
    assert graphed.delta == [{"a": 2}, {"c": 1}]


def test_a_failed_capture_leaves_the_counts():
    counters = [{"a": 3}]

    class Failing(_CountingBackend):
        def capture(self, fn):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    def step():
        counters[0]["a"] += 1

    graphed = G.GraphedStep(step, Failing(), counters)
    with pytest.raises(RuntimeError, match="capturing"):
        graphed()  # eager, then the capture fails
    assert counters == [{"a": 4}] and graphed.graph is None


# ------------------------------------------- the graphs' flow, fake graphs


class _ReplayingBackend:
    """A fake CUDA graph: capture runs nothing, replay runs the function
    (what a real replay does on the device)."""

    captures = 0

    def __init__(self, generators=list):
        pass

    def eager(self, fn):
        fn()

    def capture(self, fn):
        _ReplayingBackend.captures += 1

        class Graph:
            def replay(self):
                fn()

        return Graph()


def _train(ds, run, seed, epochs=3, verbosity=2):
    return TJ.run_fused_training(run, train_idx=np.arange(12),
                                 val_idx=np.arange(12, 16), epochs=epochs,
                                 verbosity=verbosity, seed=seed)


@pytest.mark.parametrize("batching", ["padded", "packed"])
def test_graph_flow_runs_every_step_once(toy_dataset, monkeypatch, batching):
    mp = {**MODEL, "kernel": "xla", "batching": batching}
    runs, hist = {}, {}
    for mode in ("eager", "graphs"):
        if mode == "graphs":
            monkeypatch.setattr(TR, "capture_plan",
                                lambda *a, **k: G.CapturePlan(True))
            monkeypatch.setattr(TR, "CudaGraphs", _ReplayingBackend)
            _ReplayingBackend.captures = 0
        runs[mode] = TJ.setup_run(toy_dataset, mp, "l1_loss", seed=5,
                                  device="cpu")
        best, sched, hist[mode] = _train(toy_dataset, runs[mode], 5)
        assert len(hist[mode]) == 3
    assert _ReplayingBackend.captures == 3  # train step, eval step, tail
    assert len(runs["graphs"].graphs) == 1
    assert hist["graphs"] == hist["eager"]
    steps = {m: [s["step"] for s in r.optimizer.state.values()]
             for m, r in runs.items()}
    assert steps["graphs"] == steps["eager"]
    n_steps = runs["eager"].id_matrix(np.arange(12), True, 6).shape[0]
    assert float(steps["eager"][0]) == 3 * n_steps
    for k, v in runs["eager"].model.state_dict().items():
        assert torch.equal(runs["graphs"].model.state_dict()[k], v), k
    assert runs["graphs"].model.training == runs["eager"].model.training
    # a second call replays the cached graphs and gives the eager history
    _, _, again_g = _train(toy_dataset, runs["graphs"], 9, epochs=2)
    assert _ReplayingBackend.captures == 3
    monkeypatch.undo()
    _, _, again_e = _train(toy_dataset, runs["eager"], 9, epochs=2)
    assert again_g == again_e
    # a new optimizer state drops them, and nothing else holds them: no
    # reference cycle keeps a graph (and its memory pool) alive
    fns = weakref.ref(next(iter(runs["graphs"].graphs.values())))
    gc.disable()
    try:
        runs["graphs"].load_optimizer_state(
            runs["graphs"].optimizer.state_dict())
        assert runs["graphs"].graphs == {}
        assert fns() is None
    finally:
        gc.enable()
