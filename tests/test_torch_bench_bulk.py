"""The port's bulk bench (matdeeplearn_torch/bench_bulk.py) against the
reference package's bench_bulk.py and its training, on the CPU.

* build_corpus(24) equals bench_bulk.build_corpus(24) (each cached in a
  directory of its own): indices exact, floats to 1e-6; the cached copy
  reads back the same.
* The configuration table: every name that bench_bulk.py's main handles
  (its `name == "..."` branches, read from its source) runs the same model
  extras at the same batch under the same label, with the streamed ones on
  shards, as main itself passes them to run_config (run with run_config
  and build_corpus replaced); `all` is the same five; an unknown name raises
  in the port where the reference runs it as the default CGCNN.
* Packed training of the bench's other models and plans against the JAX
  package's packed training (kernel xla, which packs the same flat counts
  into the same bins), from its initial parameters converted, 3 epochs on
  the bench's corpus at n 48 and small widths (dropout 0, and without
  BatchNorm, behind which the conv biases' gradients are rounding noise
  that AdamW turns into steps of lr/2: the trainer parities of
  tests/test_torch_{schnet,gcn,mpnn,megnet}.py run without it too): the
  id matrices equal JAX's, per-epoch train and val errors to rtol 2e-3 and
  atol 2e-3, the learning rate to 1e-6 (tests/test_torch_packed.py's
  limits). Cases SchNet csr and fused, GCN csr and xla, MPNN fused and xla,
  MEGNet xla and csr on the dst order.
* Streamed packed training (the corpus in shards of 16) against the JAX
  package's, 2 epochs, the wire on and off, to the same limits.
* main on the CPU over all 27 names at tiny widths prints one JSON line
  with one record a name, the reference's fields and s/epoch > 0; a
  configuration that fails is recorded while the others run, and the exit
  code is 1; a CUDA request without CUDA fails.

The JAX references train in threads of one module fixture (XLA releases
the interpreter lock while it compiles and runs); each thread's epoch
lines are read from its own buffer.
"""

import contextlib
import io
import json
import os
import re
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from matdeeplearn_tpu.data import streaming as JS
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_torch import bench_bulk as B
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import streaming as TS
from matdeeplearn_torch.training import jobs as TJ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_bulk as RB  # noqa: E402  (the reference package's bench)

N_TRAIN_CORPUS = 48
SHARD_GRAPHS = 16
FIELDS = ("node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
          "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u")
RECORD_FIELDS = {"config", "s_per_epoch", "epochs_per_hr",
                 "edges_per_s_per_chip", "graphs_per_s", "step_ms",
                 "model_flops_per_s", "setup_s", "warmup_s", "kernel_mode"}
SMALL = {"dim1": 12, "dim2": 10, "dim3": 8, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 10, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "False", "dropout_rate": 0.0, "print_model": False,
         "batching": "packed"}
MODELS = {"SchNet": {"model": "SchNet", "cutoff": 8.0},
          "GCN": {"model": "GCN"},
          "MPNN": {"model": "MPNN", "dim2": 8},
          "MEGNet": {"model": "MEGNet", "gc_fc_count": 1}}
# (model, the port's kernel, csr_order); JAX trains each model under xla
CASES = [("SchNet", "csr", None), ("SchNet", "fused", None),
         ("GCN", "csr", None), ("GCN", "xla", None),
         ("MPNN", "fused", None), ("MPNN", "xla", None),
         ("MEGNet", "xla", None), ("MEGNet", "csr", "dst")]
STREAM = {**SMALL, "model": "CGCNN", "epochs": 2,
          "kernel": "xla"}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tiny widths gain nothing
    from more, and a pool of a thread a core in each of the test run's
    workers (and beside the JAX threads) multiplies the file's time."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _names_in_reference() -> list[str]:
    with open(os.path.join(REPO, "bench_bulk.py")) as f:
        return re.findall(r'name == "([^"]+)"', f.read())


# ------------------------------------------------------------------ corpus


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(the reference's corpus, the port's) at N_TRAIN_CORPUS, each built
    in a cache directory of its own."""
    root = tmp_path_factory.mktemp("corpora")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RB, "CACHE", str(root / "jax"))
        mp.setattr(B, "CACHE", str(root / "port"))
        with contextlib.redirect_stderr(io.StringIO()):
            return (RB.build_corpus(N_TRAIN_CORPUS),
                    B.build_corpus(N_TRAIN_CORPUS))


def _assert_same_corpus(port, ref):
    for k in FIELDS:
        a, b = getattr(port, k), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.structure_ids == list(ref.structure_ids)


def test_corpus_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(RB, "CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(B, "CACHE", str(tmp_path / "port"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ref = RB.build_corpus(24)
        port = B.build_corpus(24)
        cached = B.build_corpus(24)
    assert "corpus cache hit" in err.getvalue()
    assert os.listdir(tmp_path / "port") == ["bulk_24_0.npz"]
    assert len(port) == 24 and port.num_features == 100 + 14
    assert 8 <= port.node_counts().min() and port.node_counts().max() <= 250
    _assert_same_corpus(port, ref)
    _assert_same_corpus(cached, ref)


# ---------------------------------------------------------- configurations


def _reference_calls(monkeypatch, argv) -> list[tuple]:
    """(label, extra, batch, streamed) of each configuration that
    bench_bulk.py's main passes to run_config for `argv`."""
    calls = []

    class Corpus:
        def __len__(self):
            return 40

        def edge_counts(self):
            return np.full(40, 7)

    def run_config(label, ds, extra, tr, va, batch, epochs, stream_dir=None):
        calls.append((label, extra, batch, stream_dir is not None))
        return {"config": label}

    monkeypatch.setattr(RB, "build_corpus", lambda n: Corpus())
    monkeypatch.setattr(RB, "run_config", run_config)
    monkeypatch.setattr(sys, "argv", ["bench_bulk.py", "--n", "40", *argv])
    # main points JAX's persistent compilation cache into the repository:
    # put the settings back before anything compiles
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            RB.main()
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return calls


@pytest.mark.parametrize("batch", [256, 32])
def test_config_table_matches_the_reference(monkeypatch, batch):
    names = _names_in_reference()
    assert len(names) == len(set(names)) == 27
    assert list(B.CONFIGS) == names
    calls = _reference_calls(monkeypatch, ["--configs", ",".join(names),
                                           "--batch", str(batch)])
    assert len(calls) == len(names)
    for name, (label, extra, b, streamed) in zip(names, calls):
        assert B.config(name, batch) == (extra, streamed, b, label), name


def test_all_and_unknown_names(monkeypatch):
    calls = _reference_calls(monkeypatch, [])
    assert len(calls) == len(B.ALL) == 5
    for name, (label, extra, b, streamed) in zip(B.ALL, calls):
        assert B.config(name, 256) == (extra, streamed, b, label), name
    # the reference runs an unknown name as the default CGCNN; the port
    # refuses it
    calls = _reference_calls(monkeypatch, ["--configs", "no-such-config"])
    assert calls == [("in-memory/CGCNN/padded/b64", {}, 64, False)]
    with pytest.raises(ValueError, match="unknown configuration"):
        B.config("no-such-config", 256)
    with pytest.raises(ValueError, match="unknown configuration"):
        B.run_bulk(["fused", "no-such-config"], n=8, device="cpu")


# ------------------------------------------------------------------ training


class _ThreadStdout(io.TextIOBase):
    """sys.stdout for threads that each read back only their own lines."""

    def __init__(self):
        self.bufs = {}

    def begin(self):
        self.bufs[threading.get_ident()] = io.StringIO()

    def text(self) -> str:
        return self.bufs.pop(threading.get_ident()).getvalue()

    def write(self, s):
        self.bufs.setdefault(threading.get_ident(), io.StringIO()).write(s)
        return len(s)


def _epochs(text: str) -> list[tuple]:
    return [tuple(float(v) for v in m.groups()[1:])
            for m in EPOCH_LINE.finditer(text)]


def _jax_packed(out, ds, mp, train_idx, val_idx):
    """JAX packed training (kernel xla): (initial parameters converted,
    epoch rows (lr, train, val), the id-matrix function)."""
    out.begin()
    run = JJ.setup_run(ds, {**mp, "kernel": "xla"}, "l1_loss", seed=9)
    init = params_from_jax(jax.tree.map(np.asarray, run.state.params),
                           jax.tree.map(np.asarray, run.state.batch_stats))
    JJ.run_fused_training(run, train_idx=train_idx, val_idx=val_idx,
                          epochs=mp["epochs"], verbosity=1, seed=9)
    text = out.text()
    assert "batching=packed" in text
    return init, _epochs(text), run.id_matrix_fn


def _jax_stream(out, sds, wire, train_idx, val_idx):
    """JAX streamed packed training: (initial parameters, epoch rows)."""
    out.begin()
    run = JJ.setup_run(sds, {**STREAM, "stream_wire": str(wire)}, "l1_loss",
                       seed=5)
    init = params_from_jax(jax.tree.map(np.asarray, run.state.params),
                           jax.tree.map(np.asarray, run.state.batch_stats))
    JJ.run_fused_training(run, train_idx=train_idx, val_idx=val_idx,
                          epochs=STREAM["epochs"], verbosity=1, seed=9)
    return init, _epochs(out.text())


@pytest.fixture(scope="module")
def reference(corpora, tmp_path_factory):
    """Every JAX reference of this file, trained in threads: packed training
    of each model, and streamed packed training with the wire on and off
    (shards of SHARD_GRAPHS, JAX's own)."""
    jds, _ = corpora
    idx = np.random.default_rng(3).permutation(N_TRAIN_CORPUS)
    split = (idx[:34], idx[34:])
    jdir = str(tmp_path_factory.mktemp("shards") / "jax")
    JS.save_sharded(jds, jdir, graphs_per_shard=SHARD_GRAPHS)
    jsds = JS.StreamingGraphDataset(jdir)
    out = _ThreadStdout()
    with contextlib.redirect_stdout(out), ThreadPoolExecutor(6) as pool:
        packed = {m: pool.submit(_jax_packed, out, jds, {**SMALL, **extra},
                                 *split)
                  for m, extra in MODELS.items()}
        stream = {w: pool.submit(_jax_stream, out, jsds, w, *split)
                  for w in (True, False)}
        return (split, {m: f.result() for m, f in packed.items()},
                {w: f.result() for w, f in stream.items()})


def _assert_epochs(history, jepochs, n):
    assert len(jepochs) == len(history) == n
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs,
                                                            history)):
        assert np.isfinite([ptr, pva]).all()
        np.testing.assert_allclose(ptr, tr, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} train")
        np.testing.assert_allclose(pva, va, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} val")
        np.testing.assert_allclose(plr, lr, rtol=1e-6, atol=1e-6,
                                   err_msg=f"epoch {e + 1} lr")


@pytest.mark.parametrize("model,kernel,order", CASES,
                         ids=[f"{m}-{k}{'-' + o if o else ''}"
                              for m, k, o in CASES])
def test_packed_training_matches_jax(corpora, reference, model, kernel,
                                     order):
    _, ds = corpora
    (train_idx, val_idx), packed, _ = reference
    init, jepochs, jidm = packed[model]
    mp = {**SMALL, **MODELS[model], "kernel": kernel}
    if order:
        mp["csr_order"] = order
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TJ.setup_run(ds, mp, "l1_loss", seed=9, device="cpu")
    want = (f"kernel=csr({order or 'dst'})" if kernel == "csr"
            else f"kernel={kernel}")
    assert want in buf.getvalue() and "batching=packed" in buf.getvalue()
    if order:
        assert run.data.dst_sorted and not run.data.src_sorted
    for shuffle, seed in ((True, 10), (False, None)):
        np.testing.assert_array_equal(run.id_matrix(train_idx, shuffle, seed),
                                      jidm(train_idx, shuffle, seed))
    run.model.load_state_dict(init)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, history = TJ.run_fused_training(
            run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
            seed=9)
    _assert_epochs(history, jepochs, 3)


@pytest.mark.parametrize("wire", [True, False], ids=["wire", "nowire"])
def test_streamed_packed_training_matches_jax(corpora, reference, tmp_path,
                                              wire):
    _, ds = corpora
    (train_idx, val_idx), _, stream = reference
    init, jepochs = stream[wire]
    sds = TS.load_or_create_sharded(ds, str(tmp_path / "port"),
                                    graphs_per_shard=SHARD_GRAPHS)
    with contextlib.redirect_stdout(io.StringIO()):
        run = TJ.setup_run(sds, {**STREAM, "stream_wire": str(wire)},
                           "l1_loss", seed=5, device="cpu")
        assert run.stream_packed and run.stream_wire == wire
        run.model.load_state_dict(init)
        _, _, history = TJ.run_fused_training(
            run, train_idx=train_idx, val_idx=val_idx, epochs=2, verbosity=1,
            seed=9)
    _assert_epochs(history, jepochs, 2)


# -------------------------------------------------------------------- main


def _tiny(monkeypatch, tmp_path):
    """The module at tiny widths, its cache under tmp_path."""
    monkeypatch.setattr(B, "CACHE", str(tmp_path))
    monkeypatch.setattr(B, "MODEL", {**B.MODEL, "dim1": 8, "dim2": 8,
                                     "gc_count": 1, "post_fc_count": 1})
    monkeypatch.setattr(B, "CONFIGS", {
        name: ({**extra, **{d: 6 for d in ("dim1", "dim2", "dim3")
                            if d in extra}}, stream)
        for name, (extra, stream) in B.CONFIGS.items()})


def test_main_runs_every_configuration_on_the_cpu(monkeypatch, tmp_path,
                                                  capsys):
    _tiny(monkeypatch, tmp_path)
    names = list(B.CONFIGS)
    rc = B.main(["--device", "cpu", "--n", "30", "--epochs", "1", "--batch",
                 "8", "--configs", ",".join(names)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert {k: out[k] for k in ("n_structures", "batch", "epochs_timed",
                                "device")} == {
        "n_structures": 30, "batch": 8, "epochs_timed": 1, "device": "cpu"}
    assert out["total_edges"] > 0
    recs = out["records"]
    assert [r["config"] for r in recs] == [B.config(n, 8)[3] for n in names]
    for name, r in zip(names, recs):
        assert RECORD_FIELDS <= set(r), name
        assert r["s_per_epoch"] > 0 and np.isfinite(list(
            v for v in r.values() if not isinstance(v, str))).all(), name
        assert ("stream_assembly_ms_per_batch" in r) == B.CONFIGS[name][1]
        assert "mfu_pct" not in r  # no peaks off the card
    # the CPU runs the kernels' plain versions under each plan's name
    kernels = {n: r["kernel_mode"] for n, r in zip(names, recs)}
    assert kernels["fused"] == "xla"  # auto: xla off the card
    assert kernels["schnet-packed-fused"] == "fused"
    assert kernels["megnet-packed-csr-dst"] == "csr"
    assert sorted(os.listdir(tmp_path)) == ["bulk_30_0.npz", "shards_30"]


def test_a_failed_configuration_is_recorded_and_exits_1(monkeypatch,
                                                        tmp_path, capsys):
    _tiny(monkeypatch, tmp_path)
    run_config = B.run_config

    def failing(label, *a, **k):
        if "/GCN/" in label:
            raise RuntimeError("configuration failed")
        return run_config(label, *a, **k)

    monkeypatch.setattr(B, "run_config", failing)
    rc = B.main(["--device", "cpu", "--n", "20", "--epochs", "1", "--batch",
                 "8", "--configs", "gcn-packed,packed"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["records"][0] == {
        "config": "gcn-packed", "error": "RuntimeError('configuration failed')"}
    assert out["records"][1]["config"] == "in-memory/CGCNN/packed/xla/b8"
    assert out["records"][1]["s_per_epoch"] > 0


def test_cuda_request_without_cuda_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--n", "8"])
