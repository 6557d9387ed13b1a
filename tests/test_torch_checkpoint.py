"""The port reads the JAX package's checkpoints on the CPU.

* The port's msgpack decoder (training/checkpoint.py:msgpack_restore)
  returns bitwise the tree flax.serialization.msgpack_restore returns: on
  a checkpoint written by the JAX package's save_checkpoint (a TrainState
  with its optax state) and on a tree of every type flax writes (nil,
  booleans, integers of every width, floats, str, bin, lists, maps,
  ndarrays of several dtypes, numpy scalars, chunked arrays). An unknown
  extension type raises.
* load_checkpoint tells the formats apart and turns a JAX state into the
  state_dict convert.params_from_jax gives; Predict from the JAX file
  matches the JAX package's Predict to rtol 1e-5; Analysis's embeddings
  and load_model take it too (parameters and statistics only).
"""

import csv
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import save_checkpoint as j_save
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import (load_checkpoint,
                                                    msgpack_restore,
                                                    save_checkpoint)

MODEL = {"model": "CGCNN", "dim1": 16, "dim2": 12, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "epochs": 1, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0},
         "batch_norm": "True", "print_model": False, "kernel": "xla"}


def _assert_same_tree(got, want, path="root"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, np.generic):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def jax_checkpoint(toy_dataset, tmp_path_factory):
    """A JAX TrainState (parameters, random BatchNorm statistics, AdamW
    state after one epoch) saved by the JAX package's save_checkpoint."""
    import contextlib
    import io

    run = JJ.setup_run(toy_dataset, MODEL, "l1_loss", seed=3)
    with contextlib.redirect_stdout(io.StringIO()):
        _, last, _ = JJ.run_fused_training(
            run, train_idx=np.arange(12), val_idx=np.arange(12, 16), epochs=1,
            verbosity=1, seed=3)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(np.asarray, last.batch_stats)
    for bn in stats.values():
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    state = last.replace(batch_stats=stats)
    path = str(tmp_path_factory.mktemp("jaxckpt") / "jax.ckpt")
    j_save(path, state, run.scheduler, run.model_name, run.model_config)
    return path, state


def test_decoder_matches_flax_on_a_jax_checkpoint(jax_checkpoint):
    path, _ = jax_checkpoint
    with open(path, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    got = msgpack_restore(blob)
    _assert_same_tree(got, want)
    assert {"params", "batch_stats", "opt_state"} <= set(got["state"])


def test_decoder_matches_flax_on_every_type(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "nil": None, "t": True, "f": False, "small": 7, "neg": -5,
        "i8": -100, "i16": -3000, "i32": -70000, "i64": -2 ** 40,
        "u8": 200, "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 63,
        "float": 1.25, "str": "héllo" * 10, "long": "x" * 70000,
        "bin": bytes(range(256)) * 3, "list": [1, [2.5, "a"], {"k": None}],
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal(5).astype(np.float16),
        "i64a": np.arange(7, dtype=np.int64), "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float64), "scalar": np.float32(2.5),
        "big": {str(i): np.full(3, i, np.int32) for i in range(20)},
        "chunked": rng.standard_normal((6, 5)),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_same_tree(msgpack_restore(blob),
                      serialization.msgpack_restore(blob))


def test_unknown_extension_type_raises():
    blob = msgpack.packb({"x": msgpack.ExtType(7, b"abc")})
    with pytest.raises(ValueError, match="extension type 7"):
        msgpack_restore(blob)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(serialization.msgpack_serialize(
            {"a": np.ones(4)})[:-3])


def test_load_checkpoint_reads_a_jax_state(jax_checkpoint, tmp_path):
    path, state = jax_checkpoint
    meta, sd, opt = load_checkpoint(path, with_optimizer=True)
    assert meta["model_name"] == "CGCNN" and opt is None
    want = params_from_jax(jax.tree.map(np.asarray, state.params),
                           jax.tree.map(np.asarray, state.batch_stats))
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    # the port's own format still loads, by its first bytes
    tpath = str(tmp_path / "port.ckpt")
    save_checkpoint(tpath, sd, meta["model_name"], meta["model_config"])
    with open(tpath, "rb") as f:
        assert f.read(2) == b"PK"
    _, sd2 = load_checkpoint(tpath)
    assert all(torch.equal(sd2[k], v) for k, v in sd.items())


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return [r[0] for r in rows], np.array([float(r[-1]) for r in rows])


def test_predict_from_a_jax_checkpoint_matches_jax(toy_dataset, jax_checkpoint,
                                                  tmp_path, monkeypatch):
    path, _ = jax_checkpoint
    monkeypatch.chdir(tmp_path)
    jerr = JJ.predict(toy_dataset, "l1_loss",
                      {"model_path": path, "job_name": "jax"})
    terr = TJ.predict(toy_dataset, "l1_loss",
                      {"model_path": path, "job_name": "port"}, device="cpu")
    jids, jp = _read("jax_predicted_outputs.csv")
    tids, tp = _read("port_predicted_outputs.csv")
    assert tids == jids
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(terr, jerr, rtol=1e-5)


def test_load_model_from_a_jax_checkpoint(toy_dataset, jax_checkpoint,
                                          tmp_path, monkeypatch, capsys):
    """load_model: "True" with a JAX checkpoint resumes its parameters and
    statistics, and says the optimizer starts afresh."""
    path, state = jax_checkpoint
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = TJ.run_fused_training

    def spy(run, **kw):
        seen.update({k: v.clone() for k, v in run.model.state_dict().items()})
        return real(run, **kw)

    monkeypatch.setattr(TJ, "run_fused_training", spy)
    errs = TJ.train_regular(
        toy_dataset, {"seed": 3, "load_model": "True", "model_path": path,
                      "save_model": "False", "write_output": "False"},
        {"loss": "l1_loss", "verbosity": 1}, MODEL, device="cpu")
    assert np.isfinite(errs["train"])
    assert "resuming the parameters and statistics only" in (
        capsys.readouterr().out)
    want = params_from_jax(jax.tree.map(np.asarray, state.params),
                           jax.tree.map(np.asarray, state.batch_stats))
    for k, v in want.items():
        assert torch.equal(seen[k], v), k
