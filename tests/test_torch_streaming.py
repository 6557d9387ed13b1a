"""The port's disk streaming (`dataset_type: "large"`) against the JAX
package's on the CPU, on toy_dataset in shards of 5 graphs with an LRU of
2 shards (as tests/test_streaming.py).

Tolerances, each test's own:
* the shard directories: either package reads the other's, metadata and
  graph arrays exact;
* the id rows (shard-local order, ordered, packed and eval rows): exact;
* `assemble`: JAX's host assembler and the port's device assembler
  (batching.assemble_batch), array for array, atol 0;
* `assemble_wire`: JAX's f16 and uint16 arrays byte for byte;
  `expand_wire`: JAX's expand_wire exactly (the same casts);
* `stream_evaluate` from the JAX parameters carried across by convert.py:
  the loss and every prediction to rtol 1e-5, atol 1e-5·max|JAX| (the
  forward in f32 in another summation order), targets exact, for CGCNN
  and MPNN (the port's MPNN on the bilinear kernel's plain version), padded
  and packed, wire on and off;
* two epochs of `stream_trainer` against the JAX package's: train and val
  errors to rtol 2e-3, atol 2e-3, the tolerance of the in-memory trainer
  parity (tests/test_torch_training.py);
* get_dataset in large mode writes, then reuses, the shard directory;
* the prefetch worker: an exception re-raises in the consumer, and an
  early exit joins the worker;
* resolve_kernel on a stream (exact plans and notes);
* cli.run Training, Predict and CV on a streamed toy dataset on the CPU;
* the Analysis embeddings on a stream against in memory: rtol 1e-5, atol
  1e-5·max|in memory|.
"""

import contextlib
import io
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import streaming as JS
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training import stream as JT
from matdeeplearn_torch import cli
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import streaming as TS
from matdeeplearn_torch.data.dataset import get_dataset
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import stream as TST

from conftest import TOY_PROCESSING_ARGS

GPS, CACHE = 5, 2
FULL_FIELDS = ("x", "edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
               "node_graph", "node_mask", "edge_mask", "graph_mask", "y", "u",
               "n_node")
WIRE_FIELDS = ("x", "edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
               "n_node", "e_total", "y", "u")
CGCNN = {"model": "CGCNN", "dim1": 12, "dim2": 10, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "False", "dropout_rate": 0.0, "print_model": False}
MPNN = {**CGCNN, "model": "MPNN", "dim1": 6, "dim2": 8, "dim3": 5,
        "gc_count": 1, "kernel": "fused"}
IDS = ([3, 9, 0, 11, 6, 1], [2, 5, -1, -1, -1, -1], [15, 14, 4, 8, 7, -1])


@pytest.fixture(scope="module")
def shards(toy_dataset, tmp_path_factory):
    """(JAX's shard directory, the port's), each written from toy_dataset."""
    root = tmp_path_factory.mktemp("shards")
    jdir, tdir = str(root / "jax"), str(root / "port")
    JS.save_sharded(toy_dataset, jdir, graphs_per_shard=GPS)
    TS.save_sharded(toy_dataset, tdir, graphs_per_shard=GPS)
    return jdir, tdir


@pytest.fixture(scope="module")
def pair(shards):
    """(JAX's StreamingGraphDataset, the port's) over JAX's shards."""
    return (JS.StreamingGraphDataset(shards[0], 0, CACHE),
            TS.StreamingGraphDataset(shards[0], 0, CACHE))


def _spec(ds, b=6):
    return TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), b)


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)])
def test_shard_directories_are_interchangeable(toy_dataset, shards, writer,
                                               reader):
    """Either package reads the other's shards: the same npz keys, equal
    metadata and graph arrays (exact)."""
    path = shards[writer]
    ds = (JS.StreamingGraphDataset, TS.StreamingGraphDataset)[reader](
        path, 0, CACHE)
    other = (JS.StreamingGraphDataset, TS.StreamingGraphDataset)[writer](
        path, 0, CACHE)
    for name in sorted(os.listdir(shards[0])):
        if name.endswith(".npz"):
            with np.load(os.path.join(shards[0], name)) as a, \
                    np.load(os.path.join(shards[1], name)) as b:
                assert a.files == b.files, name
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(ds) == len(other) == len(toy_dataset)
    for attr in ("num_features", "num_edge_features", "output_dim",
                 "structure_ids", "species", "graphs_per_shard", "edge_width"):
        assert getattr(ds, attr) == getattr(other, attr), attr
    for fn in ("node_counts", "edge_counts"):
        np.testing.assert_array_equal(getattr(ds, fn)(), getattr(other, fn)())
    np.testing.assert_array_equal(ds.targets, toy_dataset.targets)
    np.testing.assert_array_equal(ds.u, other.u)
    for gid in (0, 4, 5, 7, len(toy_dataset) - 1):
        for a, b in zip(ds.graph_arrays(gid), other.graph_arrays(gid)):
            np.testing.assert_array_equal(a, b)
    assert len(ds._lru) <= CACHE


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_id_rows_match_jax(pair, seed):
    """shard_local_order, _ordered_batches, _packed_rows, _epoch_ids and
    the training rows (padded and packed): JAX's rows exactly."""
    jsds, tsds = pair
    idx = np.random.default_rng(seed).permutation(len(tsds))[:13]
    np.testing.assert_array_equal(tsds.shard_local_order(idx, seed),
                                  jsds.shard_local_order(idx, seed))
    spec = TB.BatchSpec.packed_for_dataset(tsds.node_counts(),
                                           tsds.edge_counts(), 4, align=8,
                                           align_edges=8)
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    for got, want in (
            (TST._ordered_batches(idx, 4), JT._ordered_batches(idx, 4)),
            (TST._epoch_ids(idx, 4, True, seed),
             JT._epoch_ids(idx, 4, True, seed)),
            (TST._epoch_ids(np.sort(idx), 4, False, None),
             JT._epoch_ids(np.sort(idx), 4, False, None)),
            (TST._packed_rows(tsds, idx, spec, 4),
             JT._packed_rows(jsds, idx, jspec, 4, 1)),
            (TST._train_id_batches(tsds, idx, 4, seed),
             JT._train_id_batches(jsds, idx, 4, seed)),
            (TST._train_id_batches(tsds, idx, 4, seed, spec, packed=True),
             JT._train_id_batches(jsds, idx, 4, seed, jspec, packed=True))):
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ids", IDS)
def test_assemble_matches_jax_and_the_device_assembler(toy_dataset, pair, ids):
    """The port's host batch equals JAX's host batch and the port's device
    assembler's, array for array (atol 0)."""
    jsds, tsds = pair
    spec = _spec(tsds)
    ids = np.asarray(ids, np.int32)
    got = tsds.assemble(ids, spec)
    want = jsds.assemble(ids, JB.BatchSpec(spec.num_graphs, spec.num_nodes,
                                           spec.num_edges))
    dev = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(toy_dataset,
                                                                "cpu"),
                            ids, spec)
    for name in FULL_FIELDS:
        a = getattr(got, name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(a, getattr(dev, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("ids", IDS)
def test_wire_batch_matches_jax_bytes(pair, ids):
    """assemble_wire: JAX's f16 and uint16 arrays byte for byte (the port
    carries the uint16 bytes as int16); expand_wire: JAX's expand_wire
    exactly."""
    jsds, tsds = pair
    spec = _spec(tsds)
    ids = np.asarray(ids, np.int32)
    got = tsds.assemble_wire(ids, spec)
    want = jsds.assemble_wire(ids, JB.BatchSpec(spec.num_graphs,
                                                spec.num_nodes,
                                                spec.num_edges))
    for name in WIRE_FIELDS:
        a = TS._view(getattr(got, name))
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    full, jfull = TS.expand_wire(got), JS.expand_wire(want)
    for name in FULL_FIELDS:
        np.testing.assert_array_equal(getattr(full, name).numpy(),
                                      np.asarray(getattr(jfull, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's Runs by (model, batch size, packed, seed), shared by the wire
    cases: a JAX setup_run and its compiles take seconds, and its
    stream_evaluate takes the wire as an argument."""
    return {}


def _runs(jsds, tsds, model, packed=False, wire=True, seed=5, cache=None):
    """JAX's setup_run on its stream (from `cache` when it holds one), and
    the port's from JAX's initial parameters."""
    mp = {**model, "batching": "packed" if packed else "padded",
          "stream_wire": str(wire)}
    cache = {} if cache is None else cache
    key = (model["model"], model["batch_size"], packed, seed)
    with contextlib.redirect_stdout(io.StringIO()):
        if key not in cache:
            cache[key] = JJ.setup_run(jsds, mp, "l1_loss", seed=seed)
        jrun = cache[key]
        trun = TJ.setup_run(tsds, mp, "l1_loss", seed=seed, device="cpu")
    assert trun.stream_wire == wire
    trun.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jrun.state.params),
        jax.tree.map(np.asarray, jrun.state.batch_stats)))
    assert (trun.spec.num_graphs, trun.spec.num_nodes, trun.spec.num_edges) \
        == (jrun.spec.num_graphs, jrun.spec.num_nodes, jrun.spec.num_edges)
    return jrun, trun


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("model", [CGCNN, MPNN], ids=["CGCNN", "MPNN"])
def test_stream_evaluate_matches_jax(pair, jax_runs, model, packed, wire):
    """The loss and the predictions in request order to rtol 1e-5 and atol
    1e-5·max|JAX|; targets exact. The port's streamed MPNN runs its message
    on the bilinear kernel's plain version, JAX's (off its accelerator)
    on the einsum."""
    jsds, tsds = pair
    jrun, trun = _runs(jsds, tsds, model, packed, wire, cache=jax_runs)
    assert trun.feed.bilinear == (model is MPNN)
    idx = np.array([12, 3, 7, 0, 15, 9, 4])
    jerr, jp, jt = JT.stream_evaluate(jrun.eval_step, jsds, jrun.spec,
                                      jrun.state, idx, 4, out=True,
                                      packed=packed, wire=wire)
    terr, tp, tt = TST.stream_evaluate(trun.model, "l1_loss", trun.feed, idx,
                                       out=True)
    np.testing.assert_array_equal(tt, jt)
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp, jp, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jp).max()))
    np.testing.assert_allclose(terr, jerr, rtol=1e-5, atol=1e-6)


def test_stream_trainer_matches_jax_two_epochs(pair, tmp_path):
    """Two epochs from JAX's initial parameters (dropout 0, no BatchNorm):
    each epoch's train and val error to rtol 2e-3, atol 2e-3; the
    checkpoint of the best state is written."""
    import re

    jsds, tsds = pair
    jrun, trun = _runs(jsds, tsds, {**CGCNN, "batch_size": 3})
    idx = np.random.default_rng(2).permutation(len(tsds))
    train_idx, val_idx = idx[:11], idx[11:]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(jrun, train_idx=train_idx, val_idx=val_idx,
                              epochs=2, verbosity=1, seed=9)
    jepochs = [tuple(float(v) for v in m.groups()) for m in re.finditer(
        r"Training Error: ([0-9.]+), Val Error: ([0-9.]+)", buf.getvalue())]
    ckpt = str(tmp_path / "best.ckpt")
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, history = TJ.run_fused_training(
            trun, train_idx=train_idx, val_idx=val_idx, epochs=2,
            verbosity=1, seed=9, checkpoint_path=ckpt)
    assert len(jepochs) == len(history) == 2
    for (tr, va), (ptr, pva, _) in zip(jepochs, history):
        np.testing.assert_allclose([ptr, pva], [tr, va], rtol=2e-3, atol=2e-3)
    assert os.path.exists(ckpt)


def test_get_dataset_large_builds_then_reuses_the_shards(toy_data_dir,
                                                         tmp_path):
    """The first call processes and shards (large_shard_graphs 5), a
    second reads the same shard files; the graph arrays equal the
    in-memory dataset's."""
    data = tmp_path / "data"
    shutil.copytree(toy_data_dir, data,
                    ignore=shutil.ignore_patterns("processed*"))
    args = {**TOY_PROCESSING_ARGS, "dataset_type": "large",
            "large_shard_graphs": GPS}
    with contextlib.redirect_stdout(io.StringIO()):
        first = get_dataset(str(data), 0, "False", args)
    shard_dir = data / "processed_tpu" / "shards"
    assert isinstance(first, TS.StreamingGraphDataset)
    assert first.path == str(shard_dir)
    stamp = {p: os.path.getmtime(shard_dir / p) for p in os.listdir(shard_dir)}
    assert len(stamp) == 2 + -(-len(first) // GPS)
    second = get_dataset(str(data), 0, "False", args)
    assert isinstance(second, TS.StreamingGraphDataset)
    assert stamp == {p: os.path.getmtime(shard_dir / p)
                     for p in os.listdir(shard_dir)}
    mem = get_dataset(str(data), 0, "False", TOY_PROCESSING_ARGS)
    for gid in (0, len(mem) - 1):
        n0, n1 = mem.node_ptr[gid], mem.node_ptr[gid + 1]
        np.testing.assert_array_equal(second.graph_arrays(gid)[0],
                                      mem.node_x[n0:n1])


def _workers():
    return [t for t in threading.enumerate() if t is not threading.current_thread()
            and t.name != "MainThread"]


def test_prefetch_reraises_and_joins_its_worker(pair):
    """A fill that raises re-raises in the consumer; an early exit (a
    closed generator) stops and joins the worker; the ring's sets all come
    back free."""
    _, tsds = pair
    spec = _spec(tsds)
    ring = TST.PinnedRing([tsds.buffers(spec, True) for _ in range(3)])
    fill = TST._assembler(tsds, spec, True)
    before = set(_workers())

    def failing(ids, out):
        if ids[0] == 6:
            raise RuntimeError("shard unreadable")
        fill(ids, out)

    rows = [np.arange(i, i + 6) for i in range(0, 10, 2)]
    seen = []
    with pytest.raises(RuntimeError, match="shard unreadable"):
        for ids, i in TST._prefetch_batches(rows, failing, ring, depth=2):
            seen.append(int(ids[0]))
            ring.release(i, None)
    assert seen == [0, 2, 4]
    assert set(_workers()) == before
    gen = TST._prefetch_batches(rows, fill, ring, depth=2)
    ids, i = next(gen)
    ring.release(i, None)
    gen.close()
    assert set(_workers()) == before
    assert ring.free.qsize() == 3 and not ring.in_flight


def test_resolve_kernel_on_a_stream(capsys):
    """pallas, fused and csr are unavailable on a stream (the reference's
    notes) and run xla; MPNN's message runs on the bilinear kernel under
    auto on a CUDA device and under fused or csr anywhere."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    def plan(model, kernel, dev=cuda):
        p = TJ.resolve_kernel(model, kernel, "padded", dev, stream=True)
        return (p.name, p.edge_order, p.fused, p.windowed), capsys.readouterr().out

    xla = ("xla", None, False, False)
    fused = ("fused", None, True, False)
    for model in ("CGCNN", "SchNet", "GCN", "MEGNet"):
        assert plan(model, "auto") == (xla, "")
        assert plan(model, "xla") == (xla, "")
        for kernel in ("pallas", "fused"):
            p, note = plan(model, kernel)
            assert p == xla
            assert note.startswith(f"kernel={kernel} requested but unavailable "
                                   "(streaming datasets have no windowed "
                                   "layout cache)")
        p, note = plan(model, "csr")
        assert p == xla and "assemble from the reference edge order" in note
    assert plan("MPNN", "auto") == (fused, "")
    assert plan("MPNN", "auto", cpu) == (xla, "")
    assert plan("MPNN", "fused", cpu) == (fused, "")
    p, note = plan("MPNN", "csr")
    assert p == fused and "bilinear kernel for MPNN's message" in note
    p, note = plan("MPNN", "pallas")
    assert p == xla and "unavailable" in note


def test_cli_streams_training_predict_and_cv(toy_data_dir, tmp_path,
                                             monkeypatch):
    """cli.run on a streamed toy dataset on the CPU: Training (stream=y on
    the resolved line, the checkpoint and the split CSVs), Predict from its
    checkpoint (every id), and CV (2 folds)."""
    import yaml

    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    shutil.copytree(toy_data_dir, data,
                    ignore=shutil.ignore_patterns("processed*"))
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=str(data),
                             dataset_type="large", large_shard_graphs=GPS)
    cfg["Models"]["CGCNN_demo"].update(epochs=2, batch_size=4, dim1=8, dim2=8,
                                       gc_count=1, post_fc_count=1,
                                       print_model=False)
    cfg["Job"]["CV"]["cv_folds"] = 2
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp_path / "stream.ckpt")

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main([f"--config_path={path}", "--device=cpu", "--seed=4",
                      *argv])
        return buf.getvalue()

    out = run("--run_mode=Training", f"--model_path={ckpt}",
              "--job_name=st")
    assert "stream=y" in out and "Test Error:" in out
    assert os.path.exists(ckpt) and os.path.exists("st_test_outputs.csv")
    out = run("--run_mode=Predict", f"--model_path={ckpt}", "--job_name=stp")
    with open("stp_predicted_outputs.csv") as f:
        assert len(f.read().splitlines()) == 1 + 16
    out = run("--run_mode=CV")
    assert "CV Error" in out and os.path.exists("my_CV_job_CV_outputs.csv")


def test_analysis_embeddings_on_a_stream(toy_dataset, pair):
    """graph_embeddings on the stream (full batches, reference order)
    equal the in-memory ones (Predict's dst-sorted batches) to rtol 1e-5,
    atol 1e-5·max|in memory|: the same model, sums in another order."""
    from matdeeplearn_torch.models import build_model

    _, tsds = pair
    model = build_model("CGCNN", tsds, CGCNN,
                        generator=torch.Generator().manual_seed(1)).eval()
    got = TJ.graph_embeddings(model, "CGCNN", tsds, "cpu", batch_size=6)
    want = TJ.graph_embeddings(model, "CGCNN", toy_dataset, "cpu",
                               batch_size=6)
    assert got.shape == want.shape and got.shape[0] == len(tsds)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
