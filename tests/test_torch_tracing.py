"""The port's program spans (utils/profiling.py:span), on the CPU.

* span is one shared null context while no profiler records, and a
  record_function range (a user annotation) while one does;
* the epoch loop (training/trainer.py) gives mdl.trainer.pack, .launch,
  .sync and .report once per chunk of `verbosity` epochs, none inside
  another;
* evaluate (training/train.py) gives one mdl.evaluate per call around
  one .ids, k .assemble and k .forward (k batches) and one .readback;
* a run's history and state are bitwise the same under a profiler;
* a `profile: "True"` job's trace.json holds the trainer's spans.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import matdeeplearn_torch.utils.profiling as P
from matdeeplearn_torch.data.dataset import get_dataset
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import train as T

from conftest import TOY_PROCESSING_ARGS

TRAINER = ("mdl.trainer.pack", "mdl.trainer.launch", "mdl.trainer.sync",
           "mdl.trainer.report")
EVALUATE = ("mdl.evaluate", "mdl.evaluate.ids", "mdl.evaluate.assemble",
            "mdl.evaluate.forward", "mdl.evaluate.readback")
MODEL = {"model": "CGCNN", "dim1": 8, "dim2": 8, "gc_count": 1,
         "post_fc_count": 1, "batch_size": 4}


@pytest.fixture(scope="module")
def toy_port_dataset(toy_data_dir):
    return get_dataset(toy_data_dir, 0, "False", dict(TOY_PROCESSING_ARGS))


def _run(ds):
    return TJ.setup_run(ds, dict(MODEL), "l1_loss", seed=1, device="cpu")


def _train(run, epochs: int, verbosity: int):
    idx = np.arange(16)
    return TJ.run_fused_training(run, train_idx=idx[:12], val_idx=idx[12:],
                                 epochs=epochs, verbosity=verbosity, seed=1)


def _spans(fn):
    """(fn's result, [(name, parent name or None)] of every mdl.* span fn
    opened under torch.profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.cpu_parent.name if e.cpu_parent else None)
             for e in prof.events() if e.name.startswith("mdl.")]
    return out, spans


def _count(spans, name):
    return sum(n == name for n, _ in spans)


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = P.span("mdl.trainer.pack"), P.span("mdl.evaluate")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_under_a_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("mdl.test.outer"):
            torch.ones(3).sum()
    found = [e for e in prof.events() if e.name == "mdl.test.outer"]
    assert len(found) == 1 and found[0].is_user_annotation
    assert any(e.cpu_parent is found[0] for e in prof.events())
    assert isinstance(P.span("mdl.test.outer"), contextlib.nullcontext)


def test_every_program_span_appears(toy_port_dataset):
    run = _run(toy_port_dataset)
    idx = np.arange(16)

    def both():
        _train(run, epochs=2, verbosity=1)
        T.evaluate(run.model, run.loss, run.spec, run.data, idx[12:],
                   run.batch_size, id_matrix_fn=run.id_matrix)

    _, spans = _spans(both)
    assert {n for n, _ in spans} == set(TRAINER + EVALUATE)


@pytest.mark.parametrize("verbosity, chunks", [(1, 3), (2, 2)])
def test_trainer_spans_once_a_chunk(toy_port_dataset, verbosity, chunks):
    """3 epochs: chunks of 1 give 3 of each span (the first pack before the
    loop, none after the last chunk), chunks of 2 give 2."""
    run = _run(toy_port_dataset)
    (_, _, hist), spans = _spans(lambda: _train(run, 3, verbosity))
    assert len(hist) == 3
    for name in TRAINER:
        assert _count(spans, name) == chunks, name
    # the four phases follow one another: none opens inside another
    assert all(parent not in TRAINER for _, parent in spans)


@pytest.mark.parametrize("out", [True, False])
def test_evaluate_spans_share_the_call_as_parent(toy_port_dataset, out):
    run = _run(toy_port_dataset)
    idx = np.arange(16)
    k = run.id_matrix(idx, False, None).shape[0]
    assert k > 1
    _, spans = _spans(lambda: T.evaluate(
        run.model, run.loss, run.spec, run.data, idx, run.batch_size,
        out=out, id_matrix_fn=run.id_matrix))
    assert _count(spans, "mdl.evaluate") == 1
    for name, n in (("mdl.evaluate.ids", 1), ("mdl.evaluate.assemble", k),
                    ("mdl.evaluate.forward", k),
                    ("mdl.evaluate.readback", 1)):
        assert _count(spans, name) == n, name
    assert all(parent == "mdl.evaluate"
               for name, parent in spans if name != "mdl.evaluate")


def test_history_is_bitwise_the_same_under_a_profiler(toy_port_dataset):
    off = _run(toy_port_dataset)
    best_off, _, hist_off = _train(off, 3, 1)
    on = _run(toy_port_dataset)
    (best_on, _, hist_on), spans = _spans(lambda: _train(on, 3, 1))
    assert spans and hist_on == hist_off
    for name, v in best_off.items():
        assert torch.equal(best_on[name], v), name
    for name, v in off.model.state_dict().items():
        assert torch.equal(on.model.state_dict()[name], v), name


def test_profile_job_trace_holds_the_trainer_spans(toy_port_dataset,
                                                   tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "prof")
    TJ.train_regular(
        toy_port_dataset,
        {"seed": 1, "save_model": "False", "write_output": "False",
         "profile": "True", "profile_dir": d},
        {"loss": "l1_loss", "verbosity": 1},
        {**MODEL, "epochs": 2, "lr": 0.01, "optimizer": "AdamW",
         "scheduler": "ReduceLROnPlateau", "print_model": False},
        device="cpu")
    with open(os.path.join(d, "trace.json")) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    for name in TRAINER:
        assert names.count(name) == 2, name
