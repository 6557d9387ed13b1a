"""The port's Hyperparameter mode (training/hyper.py) against the JAX
package's on the CPU.

* The space DSL, sample_space, suggest_tpe, default_search_space and the
  rungs give exactly the JAX package's values for the same generator and
  history (no tolerance: the same numpy draws).
* The JAX package's sweep tests, on the port's trainer with CPU trials: a
  trial resumed from its checkpoint continues at its recorded epoch with
  its best val carried over; an interrupted sweep resumes the trial with
  its original config; concurrent spawned workers survive crashing trials
  (each in-flight trial with its own slot, CPU workers unpinned); a sweep
  aborts past max_failures; failed trials retry on resume.
* With one CUDA card a concurrency above 1 runs serially (unless
  MDL_HYPER_FORCE_CONCURRENCY), several cards pin one trial each.
"""

import json
import os
from dataclasses import asdict

import numpy as np
import pytest

from matdeeplearn_tpu.training import hyper as JH
from matdeeplearn_torch.training import hyper as H

from conftest import TOY_PROCESSING_ARGS

TRAIN_PARAMS = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
                "test_ratio": 0.15, "target_index": 0}
MODEL_PARAMS = {"model": "CGCNN", "epochs": 2, "optimizer": "AdamW",
                "scheduler": "ReduceLROnPlateau", "print_model": False}
CPU = {"device": "cpu"}
# Choice((-7, 12)): dim1=-7 makes model construction raise inside the
# trial. With seed=5 and 4 trials the draw is [12, -7, -7, 12].
CRASHY_SPACE = {"dim1": H.Choice((-7, 12)), "dim2": 8, "gc_count": 1,
                "post_fc_count": 1, "lr": 0.01, "batch_size": 8, "epochs": 2}
SAFE_SPACE = {**CRASHY_SPACE, "dim1": H.Choice((12,))}
ALL_CRASH_SPACE = {**CRASHY_SPACE, "dim1": H.Choice((-7,))}


def _jax_space(space):
    """The same space in the JAX package's DSL."""
    conv = {H.Choice: JH.Choice, H.Uniform: JH.Uniform,
            H.LogUniform: JH.LogUniform}
    return {k: conv[type(v)](**asdict(v)) if type(v) in conv else v
            for k, v in space.items()}


SPACE = {"lr": H.LogUniform(1e-4, 0.05), "dim1": H.Choice((8, 16, 32)),
         "x": H.Uniform(2.0, 3.0), "fixed": 7}


def _history(rng, n):
    return [{"trial": t, "config": H.sample_space(SPACE, rng),
             "best_val": float(rng.random()) if t % 7 else float("inf")}
            for t in range(n)]


@pytest.mark.parametrize("n_history,seed", [(0, 1), (3, 2), (12, 3), (30, 4)])
def test_suggest_tpe_equals_jax(n_history, seed):
    history = _history(np.random.default_rng(seed + 100), n_history)
    got = H.suggest_tpe(SPACE, history, np.random.default_rng(seed))
    want = JH.suggest_tpe(_jax_space(SPACE), history,
                          np.random.default_rng(seed))
    assert got == want
    assert H.sample_space(SPACE, np.random.default_rng(seed)) == \
        JH.sample_space(_jax_space(SPACE), np.random.default_rng(seed))


@pytest.mark.parametrize("name", ["CGCNN_demo", "SchNet_demo", "MPNN_demo",
                                  "MEGNet_demo", "GCN_demo", "SM_demo",
                                  "SOAP_demo"])
def test_default_search_space_equals_jax(name):
    got = H.default_search_space(name, {"graph_max_radius": 6.5})
    want = JH.default_search_space(name, {"graph_max_radius": 6.5})
    assert got.keys() == want.keys()
    for k, v in want.items():
        if hasattr(v, "sample"):
            assert type(got[k]).__name__ == type(v).__name__, k
            assert asdict(got[k]) == asdict(v), k
        else:
            assert got[k] == v, k
    assert H._PROCESSING_KEYS == JH._PROCESSING_KEYS


def test_rungs_equal_jax():
    rng = np.random.default_rng(0)
    results = [{"history": [{"epoch": e, "val": float(rng.random())}
                            for e in range(1, 9)] + [{"epoch": 4,
                                                      "stopped": "x"}]}
               for _ in range(5)]
    assert H._rung_checks([2, 4, 9], results) == JH._rung_checks([2, 4, 9],
                                                                  results)


def test_run_trial_resumes_mid_training(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = {"dim1": 12, "dim2": 8, "gc_count": 1, "post_fc_count": 1,
           "lr": 0.01, "batch_size": 8}
    ckpt = str(tmp_path / "trial_0.ckpt")
    bv1, h1 = H.run_trial(toy_dataset, cfg, CPU, TRAIN_PARAMS,
                          {**MODEL_PARAMS, "epochs": 4}, report_every=2,
                          checkpoint_path=ckpt, seed=3)
    assert [h["epoch"] for h in h1 if "val" in h] == [2, 4]
    bv2, h2 = H.run_trial(toy_dataset, cfg, CPU, TRAIN_PARAMS,
                          {**MODEL_PARAMS, "epochs": 8}, report_every=2,
                          checkpoint_path=ckpt, seed=3,
                          resume_from_checkpoint=True)
    assert [h["epoch"] for h in h2 if "val" in h] == [6, 8]
    assert bv2 <= bv1 + 1e-9  # best_val carries over
    # an uninterrupted run of 8 epochs reports what the resumed one did
    bv3, h3 = H.run_trial(toy_dataset, cfg, CPU, TRAIN_PARAMS,
                          {**MODEL_PARAMS, "epochs": 8}, report_every=2,
                          seed=3)
    np.testing.assert_allclose([h["val"] for h in h3 if "val" in h],
                               [h["val"] for h in h1 + h2 if "val" in h],
                               rtol=1e-5)


def test_run_trial_stops_at_a_rung(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = {"dim1": 12, "dim2": 8, "gc_count": 1, "post_fc_count": 1,
           "lr": 0.01, "batch_size": 8}
    _, hist = H.run_trial(toy_dataset, cfg, CPU, TRAIN_PARAMS,
                          {**MODEL_PARAMS, "epochs": 4}, seed=3,
                          rung_checks=[(2, -1.0)])
    assert hist[-1] == {"epoch": 2, "stopped": "median_rule"}


def test_sweep_resumes_interrupted_trial_with_original_config(
        toy_dataset, tmp_path, monkeypatch):
    """A sweep killed mid-trial (after the trial checkpointed) resumes the
    trial from its recorded epoch with its first config."""
    monkeypatch.chdir(tmp_path)
    space = {"dim1": H.Choice((12,)), "dim2": 8, "gc_count": 1,
             "post_fc_count": 1, "lr": 0.01, "batch_size": 8}
    job = {"job_name": "midresume", "hyper_trials": 1, "hyper_iter": 2,
           "hyper_resume": "True", "seed": 9, "max_failures": 0, **CPU}
    real = H.run_trial

    def dying(*a, **kw):
        real(a[0], a[1], a[2], a[3], {**a[4], "epochs": 3}, **kw)
        raise RuntimeError("simulated preemption")

    monkeypatch.setattr(H, "run_trial", dying)
    with pytest.raises(RuntimeError):
        H.tune_setup(space, job, dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS,
                     dict(MODEL_PARAMS, epochs=6), dataset=toy_dataset)
    assert os.path.exists("results/midresume/trial_0.ckpt")
    seen = {}

    def spying(*a, **kw):
        bv, hist = real(*a, **kw)
        seen.update(epochs=[h["epoch"] for h in hist if "val" in h],
                    resume=kw.get("resume_from_checkpoint"), config=a[1])
        return bv, hist

    monkeypatch.setattr(H, "run_trial", spying)
    best = H.tune_setup(space, job, dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS,
                        dict(MODEL_PARAMS, epochs=6), dataset=toy_dataset)
    assert seen["resume"] is True and seen["config"]["dim1"] == 12
    assert min(seen["epochs"]) > 2  # past the checkpointed epoch
    assert np.isfinite(best["best_val"])


def _job(name, **kw):
    return {"job_name": name, "hyper_trials": 4, "hyper_iter": 1,
            "hyper_resume": "True", "hyper_delete_processed": "True",
            "seed": 5, "max_failures": 4, **CPU, **kw}


def _records(job_name):
    with open(os.path.join("results", job_name, "trials.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("event") != "started"]


def test_concurrent_sweep_survives_worker_crashes(toy_data_dir, toy_dataset,
                                                  tmp_path, monkeypatch):
    """Two spawned CPU workers, one trial each at a time: the crashing
    trials are recorded, the others finish, each in-flight trial has its
    own slot, and no CPU worker is pinned to a card."""
    monkeypatch.chdir(tmp_path)
    best = H.tune_setup(CRASHY_SPACE, _job("conc", hyper_concurrency=2),
                        dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS, MODEL_PARAMS,
                        data_path=toy_data_dir)
    assert np.isfinite(best["best_val"])
    recs = _records("conc")
    failed = [r for r in recs if "error" in r]
    ok = [r for r in recs if "best_val" in r]
    assert len(recs) == 4 and len(failed) == 2 and len(ok) == 2
    assert all(r["config"]["dim1"] == -7 for r in failed)
    assert {r["device_env"]["MDL_TRIAL_SLOT"] for r in ok} <= {"0", "1"}
    assert not any("CUDA_VISIBLE_DEVICES" in r["device_env"] for r in ok)


def test_sweep_aborts_past_max_failures(toy_data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="max_failures"):
        H.tune_setup(ALL_CRASH_SPACE, _job("abort", max_failures=1),
                     dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS, MODEL_PARAMS,
                     data_path=toy_data_dir)
    assert sum("error" in r for r in _records("abort")) == 2


def test_failed_trials_retry_on_resume(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError):
        H.tune_setup(ALL_CRASH_SPACE, _job("resume"),
                     dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS, MODEL_PARAMS,
                     dataset=toy_dataset)
    assert sum("error" in r for r in _records("resume")) == 4
    best = H.tune_setup(SAFE_SPACE, _job("resume"), dict(TOY_PROCESSING_ARGS),
                        TRAIN_PARAMS, MODEL_PARAMS, dataset=toy_dataset)
    assert np.isfinite(best["best_val"])
    assert sum("best_val" in r for r in _records("resume")) == 4


def test_processing_keys_reprocess_each_trial(toy_data_dir, tmp_path,
                                              monkeypatch):
    """A sampled processing key reprocesses into a per-trial directory,
    removed after the trial."""
    monkeypatch.chdir(tmp_path)
    space = {**SAFE_SPACE, "graph_max_neighbors": H.Choice((4, 5))}
    best = H.tune_setup(space, _job("proc", hyper_trials=2),
                        dict(TOY_PROCESSING_ARGS), TRAIN_PARAMS, MODEL_PARAMS,
                        data_path=toy_data_dir)
    assert best["config"]["graph_max_neighbors"] in (4, 5)
    assert not [d for d in os.listdir(toy_data_dir)
                if d.startswith("processed_hyper_")]


@pytest.mark.parametrize("cards,force,want", [
    (1, False, (1, None)), (1, True, (3, None)),
    (4, False, (3, ["0", "1", "2", "3"])), (2, False, (2, ["0", "1"]))])
def test_card_slots(monkeypatch, capsys, cards, force, want):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    if force:
        monkeypatch.setenv("MDL_HYPER_FORCE_CONCURRENCY", "1")
    else:
        monkeypatch.delenv("MDL_HYPER_FORCE_CONCURRENCY", raising=False)
    assert H._card_slots(3, "cuda") == want
    if cards == 1 and not force:
        assert "running trials serially" in capsys.readouterr().out
    assert H._card_slots(3, "cpu") == (3, None)
