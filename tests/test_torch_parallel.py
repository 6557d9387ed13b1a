"""The port's data and edge parallelism (matdeeplearn_torch/parallel)
against the JAX package's on the CPU: meshes (2, 1) and (2, 2).

The port runs one process a mesh member: each layout is one gloo world of
dp·ep processes (tests/torch_parallel_worker.py, started by
`start_world`; a FileStore under tmp_path, so no port is opened), which
runs every case of that layout and writes npz files. The children import
no JAX; the JAX side runs here, on conftest's 8 virtual devices, while
they work. Tolerances, each test's own:

* one SGD step (lr 0.1, BatchNorm off, 2 graphs a replica, one conv
  block after a pre-FC layer, so a gradient crosses the exchange into the
  layers before it) of CGCNN, MPNN, SchNet, MEGNet and GCN against make_spmd_train_step on the same mesh
  from the same parameters: loss to rtol 1e-6 and the count exactly;
  every parameter to atol 1e-6·max(1, max|JAX layer|), the level
  test_ring_ep.py holds JAX's ring step to against its own single device
  (the port's single-card step parity with JAX, test_torch_training.py,
  allows 1e-5 of a layer's largest gradient, which lr 0.1 makes 1e-6 of
  a parameter); every rank's parameters equal rank 0's exactly (the same
  all_reduce result, the same optimizer step);
* the eval step on a permuted id row at (2, 2): loss to rtol 1e-5, every
  output to rtol 1e-5, atol 1e-5·max|JAX| in the row's id order, and
  train.evaluate with the mesh equal to the mesh-less evaluate's
  outputs in `indices` order to the same tolerance;
* three epochs of jobs.train_regular at dp 2 (CGCNN with BatchNorm, AdamW
  at lr × 2) from one JAX checkpoint against the JAX package's
  train_regular on a dp-2 mesh: per-epoch train and val errors to rtol
  2e-3 and atol 2e-3 and the learning rate to 1e-6 (the in-memory trainer
  parity's, test_torch_training.py), the split errors to the same;
* packed_id_matrix_sharded: JAX's bit for bit;
* train_regular at dp 2 on a disk-streaming dataset: both ranks' epochs
  equal, finite and falling;
* the streamed dp rows: the feed's (dp·B)-wide rows equal JAX's
  (_train_id_batches and _eval_id_batches at dp 2, padded and packed),
  and each replica's static batch equals that replica's of JAX's
  ShardedStream (assemble and assemble_wire), exactly;
* a rendezvous that cannot complete raises (no fallback);
* the meter's replicas and devices: JAX's numbers exactly;
* the CLI under torchrun on the CPU with --parallel=True --ep=2.

The (1, 4) layout's cases are in tests/test_torch_parallel_ep.py.
"""

import contextlib
import io
import os
import re
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import BatchSpec as JBatchSpec
from matdeeplearn_tpu.data import DeviceDataset as JDeviceDataset
from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import streaming as JS
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.parallel import (make_mesh as j_make_mesh,
                                       make_spmd_eval_step,
                                       make_spmd_train_step)
from matdeeplearn_tpu.parallel.spmd import ShardedStream
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training import stream as JT
from matdeeplearn_tpu.training import train as JTR
from matdeeplearn_tpu.training.checkpoint import save_checkpoint as j_save
from matdeeplearn_tpu.training.optimizers import build_optimizer as j_opt
from matdeeplearn_tpu.utils import profiling as JP
from matdeeplearn_torch.convert import params_from_jax, params_to_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import streaming as TS
from matdeeplearn_torch.data.dataset import GraphDataset
from matdeeplearn_torch.models import build_model as t_build_model
from matdeeplearn_torch.parallel import mesh as TM
from matdeeplearn_torch.training import stream as TST
from matdeeplearn_torch.utils import profiling as TP

import torch_parallel_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("CGCNN", "MPNN", "SchNet", "MEGNet", "GCN")
HP = {"dim1": 16, "dim2": 16, "dim3": 16, "gc_count": 1, "post_fc_count": 1,
      "batch_norm": False}
BATCH, ALIGN, LR = 2, 16, 0.1
LAYOUTS = ((2, 1), (2, 2))
EVAL_IDS = np.array([5, 0, 12, 9], np.int32)
TRAIN_MODEL = {"model": "CGCNN", "dim1": 8, "dim2": 8, "gc_count": 1,
               "post_fc_count": 1, "batch_size": 2, "epochs": 3, "lr": 0.01,
               "optimizer": "AdamW", "optimizer_args": {},
               "scheduler": "ReduceLROnPlateau",
               "scheduler_args": {"mode": "min", "factor": 0.5,
                                  "patience": 0, "min_lr": 1e-5,
                                  "threshold": 2e-4},
               "batch_norm": "True", "dropout_rate": 0.0,
               "print_model": False, "kernel": "xla"}
TRAINING = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
            "test_ratio": 0.15, "verbosity": 1}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_dataset_dir(ds, root) -> str:
    """The JAX toy dataset saved as the port's GraphDataset (the workers
    load it)."""
    path = os.path.join(root, "dataset")
    GraphDataset(**{f: getattr(ds, f) for f in (
        "node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
        "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u", "structure_ids",
        "edge_resolution", "edge_width", "target_index", "extra_features",
        "species")}).save(path)
    return path


def jax_state(ds, name, hp=None, batch=BATCH):
    """(data, spec, JAX model, tx, state, the port's state_dict) of a small
    model whose parameters are the port's draw (torch.Generator(0)), carried
    across by convert.py (no JAX init to compile)."""
    hp = {**HP, **(hp or {})}
    data = JDeviceDataset.from_graph_dataset(ds)
    spec = JBatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), batch,
                                  align=ALIGN)
    sd = t_build_model(name, ds, hp, device="cpu",
                       generator=torch.Generator().manual_seed(0)).state_dict()
    params, stats = jax.tree.map(jnp.asarray, params_to_jax(sd))
    tx = j_opt("SGD", LR, {})
    state = JTR.TrainState(params=params, batch_stats=stats,
                           opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32))
    return data, spec, j_build_model(name, ds, hp), tx, state, sd


def torch_state(params, stats) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, stats))


def jax_step(jstate, dp, ep, ep_mode="ring", model=None, ids=None):
    """JAX make_spmd_train_step on a (dp, ep) mesh of the virtual devices:
    (state after, loss, count)."""
    data, spec, jmodel, tx, state, _ = jstate
    mesh = j_make_mesh(dp=dp, ep=ep, devices=jax.devices()[:dp * ep])
    step, _, _ = make_spmd_train_step(model or jmodel, tx, "l1_loss", spec,
                                      mesh, ep_mode=ep_mode)
    ids = jnp.arange(BATCH * dp, dtype=jnp.int32) if ids is None else ids
    new, loss, count = step(state, data, ids, jax.random.PRNGKey(0))
    return torch_state(new.params, new.batch_stats), float(loss), float(count)


def jax_eval(jstate):
    """JAX make_spmd_eval_step at (2, 2) on EVAL_IDS: (loss, count, outputs
    in the row's id order)."""
    data, spec, model, _, state, _ = jstate
    mesh = j_make_mesh(dp=2, ep=2, devices=jax.devices()[:4])
    estep = make_spmd_eval_step(model, "l1_loss", spec, mesh)
    loss, count, outs = estep(state, data, jnp.asarray(EVAL_IDS))
    return float(loss), float(count), np.asarray(outs)


def step_case(name, model, state, dp, hp=None, batch=BATCH, **extra):
    return {"name": name, "kind": "step", "model": model,
            "hp": {**HP, **(hp or {})}, "state": state, "lr": LR,
            "batch": batch, "align": ALIGN,
            "ids": np.arange(batch * dp, dtype=np.int32), **extra}


def start_world(root, dp, ep, cases, dataset_dir):
    """Start a gloo world of dp·ep workers on `cases`; returns what
    wait_world needs."""
    out = os.path.join(root, f"world_{dp}x{ep}")
    os.makedirs(out, exist_ok=True)
    job = os.path.join(out, "job.pt")
    torch.save({"world": dp * ep, "ep": ep, "store": os.path.join(out, "store"),
                "dataset": dataset_dir, "out": out, "cases": cases}, job)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, job, str(r)], env=env,
                              cwd=out, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(dp * ep)]
    return out, procs


def wait_world(world, timeout=240) -> list:
    """Each rank's results ({case|key: array}), once every worker ended
    well (their output shown otherwise)."""
    out, procs = world
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = []
    for r in range(len(procs)):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def case_results(ranks, case) -> list:
    """Every rank's results of one case, keyed by result."""
    pre = case + "|"
    return [{k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}
            for r in ranks]


def assert_state(port, ref, what, scale=1e-6):
    """Every parameter and statistic to atol scale·max(1, max|ref layer|)."""
    layer_max = {}
    for k, v in ref.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0),
                               float(v.abs().max()))
    for k, v in ref.items():
        tol = scale * max(1.0, layer_max[k.rsplit(".", 1)[0]])
        np.testing.assert_allclose(port[k], v.numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what}: {k}")


def assert_ranks_agree(results, what):
    """Every rank holds rank 0's parameters, bit for bit."""
    for r, res in enumerate(results[1:], 1):
        for k, v in results[0].items():
            np.testing.assert_array_equal(res[k], v, err_msg=f"{what} rank {r}: {k}")


@pytest.fixture(scope="module")
def runs(toy_dataset, toy_data_dir, tmp_path_factory):
    """Both worlds' results and the JAX side's, by case, and the CLI run's
    (directory, output)."""
    ds = toy_dataset
    root = str(tmp_path_factory.mktemp("parallel"))
    cli = start_cli(toy_data_dir, os.path.join(root, "cli"))
    dataset_dir = port_dataset_dir(ds, root)
    states = {name: jax_state(ds, name) for name in MODELS}
    init = {name: s[5] for name, s in states.items()}
    cases = {layout: [step_case(f"{name}", name, init[name], layout[0])
                      for name in MODELS] for layout in LAYOUTS}
    cases[(2, 2)].append({**step_case("eval", "CGCNN", init["CGCNN"], 2),
                          "kind": "eval", "ids": EVAL_IDS,
                          "indices": np.random.default_rng(3).permutation(
                              len(ds))})
    # three epochs of train_regular at dp 2 from one JAX checkpoint
    jrun = JJ.setup_run(ds, TRAIN_MODEL, "l1_loss", seed=9)
    ckpt = os.path.join(root, "init.ckpt")
    j_save(ckpt, jrun.state, jrun.scheduler, jrun.model_name,
           jrun.model_config)
    job = {"job_name": "par", "seed": 9, "load_model": "True",
           "model_path": ckpt, "save_model": "False", "write_output": "False"}
    cases[(2, 1)].append({"name": "train_regular", "kind": "train_regular",
                          "job": job, "training": TRAINING, "hp": TRAIN_MODEL,
                          "cwd": root})
    # the same at dp 2 on a disk-streaming dataset (shards of 5 graphs)
    shards = os.path.join(root, "shards")
    TS.save_sharded(ds, shards, graphs_per_shard=5)
    cases[(2, 1)].append({"name": "stream", "kind": "train_regular",
                          "shards": shards, "training": TRAINING,
                          "job": {**job, "job_name": "st", "load_model": "False"},
                          "hp": {**TRAIN_MODEL, "epochs": 2}, "cwd": root})
    worlds = {layout: start_world(root, *layout, cases[layout], dataset_dir)
              for layout in LAYOUTS}

    # the JAX steps compile in threads (XLA releases the interpreter lock
    # while it compiles) while this thread runs JAX's train_regular
    with ThreadPoolExecutor(4) as pool:
        steps = {(dp, ep, name): pool.submit(jax_step, states[name], dp, ep)
                 for dp, ep in LAYOUTS for name in MODELS}
        steps["eval"] = pool.submit(jax_eval, states["CGCNN"])
        buf = io.StringIO()
        cwd = os.getcwd()
        os.chdir(root)
        try:
            with contextlib.redirect_stdout(buf):
                # from its own seed-9 draw, the checkpoint's parameters (the
                # JAX package's load_model path trains another trajectory
                # from the same parameters, so it is not the reference here)
                errs = JJ.train_regular(
                    ds, {**job, "load_model": "False"}, TRAINING, TRAIN_MODEL,
                    mesh=j_make_mesh(dp=2, ep=1, devices=jax.devices()[:2]))
        finally:
            os.chdir(cwd)
        ref = {k: f.result() for k, f in steps.items()}
    ref["train_regular"] = (
        np.asarray([[float(v) for v in m.groups()[1:]]
                    for m in W.EPOCH_LINE.finditer(buf.getvalue())]),
        np.asarray([errs["train"], errs["val"], errs["test"]]))
    return ({layout: wait_world(w) for layout, w in worlds.items()}, ref,
            wait_cli(cli))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"dp{l[0]}xep{l[1]}")
@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax_spmd_step(runs, layout, name):
    port, ref, _ = runs
    results = case_results(port[layout], name)
    state, loss, count = ref[(*layout, name)]
    assert float(results[0]["count"]) == count == BATCH * layout[0]
    np.testing.assert_allclose(float(results[0]["loss"]), loss, rtol=1e-6)
    assert_state(results[0], state, f"{name} {layout}")
    assert_ranks_agree(results, f"{name} {layout}")


def test_eval_outputs_in_id_order(runs):
    port, ref, _ = runs
    results = case_results(port[(2, 2)], "eval")
    loss, count, outs = ref["eval"]
    for res in results:
        assert float(res["count"]) == count == len(EVAL_IDS)
        np.testing.assert_allclose(float(res["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(res["outs"], outs.reshape(-1), rtol=1e-5,
                                   atol=1e-5 * np.abs(outs).max())
        np.testing.assert_allclose(res["preds"], res["preds_single"],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(res["preds_single"]).max())
        np.testing.assert_allclose(res["evaluate"][0], res["evaluate"][1],
                                   rtol=1e-5)


def test_train_regular_at_dp2_follows_jax(runs):
    port, ref, _ = runs
    jepochs, jerrs = ref["train_regular"]
    for res in case_results(port[(2, 1)], "train_regular"):
        assert "mesh=dp2xep1" in str(res["resolved"])
        assert res["epochs"].shape == jepochs.shape == (3, 3)
        lr, train, val = res["epochs"].T
        np.testing.assert_allclose(lr, jepochs[:, 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(train, jepochs[:, 1], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(val, jepochs[:, 2], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(res["errors"], jerrs, rtol=2e-3, atol=2e-3)
    # lr × dp: the reference's 0.01 at dp 2
    assert jepochs[0, 0] == pytest.approx(0.02)


def test_train_regular_streams_at_dp2(runs):
    """train_regular at dp 2 on a disk-streaming dataset: each rank fills its
    replica's slots of the same rows, and both ranks train the same
    finite, falling epochs."""
    port, _, _ = runs
    ranks = case_results(port[(2, 1)], "stream")
    assert "mesh=dp2xep1 stream=y" in str(ranks[0]["resolved"])
    epochs = ranks[0]["epochs"]
    assert epochs.shape == (2, 3) and np.isfinite(epochs).all()
    assert epochs[1, 1] < epochs[0, 1]
    np.testing.assert_array_equal(ranks[1]["epochs"], epochs)
    np.testing.assert_array_equal(ranks[1]["errors"], ranks[0]["errors"])


@pytest.mark.parametrize("dp", [1, 2, 3])
@pytest.mark.parametrize("shuffle,seed", [(True, 7), (False, None)])
def test_packed_id_matrix_sharded_is_jax_bit_for_bit(toy_dataset, dp, shuffle,
                                                     seed):
    ds = toy_dataset
    idx = np.random.default_rng(1).permutation(len(ds))[:14]
    spec = TB.BatchSpec.packed_for_dataset(ds.node_counts(), ds.edge_counts(),
                                           3)
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    got = TB.packed_id_matrix_sharded(idx, ds.node_counts(), ds.edge_counts(),
                                      spec, 3, dp, shuffle, seed)
    want = JB.packed_id_matrix_sharded(idx, ds.node_counts(), ds.edge_counts(),
                                       jspec, 3, dp, shuffle, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stream_pair(toy_dataset, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp_shards"))
    JS.save_sharded(toy_dataset, path, graphs_per_shard=5)
    return (JS.StreamingGraphDataset(path, 0, 2),
            TS.StreamingGraphDataset(path, 0, 2))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wire", [False, True])
def test_streamed_dp_rows_match_sharded_stream(stream_pair, packed, wire):
    """Every rank makes JAX's (dp·B)-wide rows from the same seed, and
    replica r's batch of a row is replica r's of ShardedStream's."""
    jsds, tsds = stream_pair
    dp, b = 2, 3
    if packed:
        spec = TB.BatchSpec.packed_for_dataset(tsds.node_counts(),
                                               tsds.edge_counts(), b)
    else:
        spec = TB.BatchSpec.for_dataset(tsds.node_counts(),
                                        tsds.edge_counts(), b)
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    idx = np.random.default_rng(4).permutation(len(tsds))[:13]
    jrows = [np.asarray(r) for r in JT._train_id_batches(
        jsds, idx, b * dp, 5, jspec, packed=packed, dp=dp)]
    jeval = [np.asarray(r) for r in (
        JT._packed_rows(jsds, np.sort(idx), jspec, b, dp) if packed
        else JT._epoch_ids(np.sort(idx), b * dp, False, None))]
    jmesh = j_make_mesh(dp=dp, ep=1, devices=jax.devices()[:dp])
    sharded = ShardedStream(jsds, jmesh)
    fields = W_FIELDS if wire else FULL_FIELDS
    for r in range(dp):
        mesh = TM.Mesh(dp, 1, r, torch.device("cpu"))
        feed = TST.StreamFeed(tsds, spec, "cpu", wire=wire, packed=packed,
                              batch_size=b, depth=1, mesh=mesh)
        np.testing.assert_array_equal(feed.id_matrix(idx, True, 5),
                                      np.stack(jrows))
        np.testing.assert_array_equal(feed.id_matrix(idx, False, None),
                                      np.stack(jeval))
        rows = feed.id_matrix(idx, True, 5)
        for row, _ in zip(rows, feed.batches(rows)):
            want = (sharded.assemble_wire(row, jspec) if wire
                    else sharded.assemble(row, jspec))
            for name in fields:
                got = TS._view(feed.static[name])
                exp = np.asarray(getattr(want, name))[r]
                assert got.dtype == exp.dtype or not wire, name
                np.testing.assert_array_equal(got, exp, err_msg=name)


FULL_FIELDS = ("x", "edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
               "node_graph", "node_mask", "edge_mask", "graph_mask", "y", "u",
               "n_node")
W_FIELDS = ("x", "edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
            "n_node", "e_total", "y", "u")


def test_failed_rendezvous_raises(monkeypatch):
    """A rank that cannot reach its world raises, and without torchrun's
    environment nothing is attempted."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert TM.maybe_initialize_distributed("cpu", verbose=False) is False
    port = free_port()  # nothing listens on it
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    with pytest.raises(RuntimeError, match="rendezvous"):
        TM.maybe_initialize_distributed("cpu", timeout_s=1, verbose=False)
    assert not torch.distributed.is_initialized()


def test_make_mesh_without_a_world_and_bad_ep():
    mesh = TM.make_mesh(device="cpu")
    assert (mesh.dp, mesh.ep, mesh.rank, mesh.world_group) == (1, 1, 0, None)
    with pytest.raises(ValueError, match="does not divide"):
        TM.make_mesh(ep=2, device="cpu")
    with pytest.raises(ValueError, match="ep_impl"):
        mesh.with_impl("allgather")


@pytest.mark.parametrize("name", ["CGCNN", "MEGNet"])
def test_meter_counts_replicas_as_jax(toy_dataset, name):
    ds = toy_dataset
    cfg = {**HP, "dim3": 16, "gc_fc_count": 2, "num_features": ds.num_features,
           "edge_resolution": ds.num_edge_features, "output_dim": 1}
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 2)
    idx = np.arange(10)
    jmesh = j_make_mesh(dp=2, ep=2, devices=jax.devices()[:4])
    jm = JP.meter_for_training(ds, idx, jmesh)
    JP.attach_analytic_flops(jm, name, cfg, spec, 10, 4, 4, replicas=2)
    mesh = TM.Mesh(2, 2, 0, torch.device("cpu"))
    tm = TP.meter_for_training(ds, idx, mesh=mesh)
    TP.attach_analytic_flops(tm, name, cfg, spec, 10, 4, 4, replicas=2)
    assert tm.num_devices == jm.num_devices == 4
    assert tm.flops_per_epoch == jm.flops_per_epoch > 0
    assert tm.bytes_per_epoch == jm.bytes_per_epoch > 0
    one = TP.meter_for_training(ds, idx)
    TP.attach_analytic_flops(one, name, cfg, spec, 10, 4, 4)
    assert one.num_devices == 1
    assert tm.flops_per_epoch == pytest.approx(2 * one.flops_per_epoch)


def start_cli(data_dir, cwd):
    """`python -m torch.distributed.run --nproc_per_node=2 -m
    matdeeplearn_torch ... --device=cpu --parallel=True --ep=2`, started."""
    import yaml

    os.makedirs(cwd)
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(data_path=data_dir, verbose="False",
                             graph_max_radius=5.0, graph_max_neighbors=6)
    cfg["Models"]["CGCNN_demo"].update(epochs=2, batch_size=4, dim1=8, dim2=8)
    path = os.path.join(cwd, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return cwd, subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "matdeeplearn_torch",
         f"--config_path={path}", "--run_mode=Training", "--model=CGCNN_demo",
         "--device=cpu", "--parallel=True", "--ep=2", "--seed=0",
         "--job_name=tr", "--verbosity=1", "--save_model=False"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def wait_cli(cli, timeout=240):
    cwd, proc = cli
    out = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, out[-4000:]
    return cwd, out


def test_cli_under_torchrun_on_the_cpu(runs):
    """Both ranks train on a dp1xep2 mesh and agree on every error; rank 0
    alone writes the settings and CSVs (toy data: no val split)."""
    cwd, out = runs[2]
    assert out.count("mesh=dp1xep2") == 2
    for split in ("Train", "Test"):
        errs = re.findall(split + r" Error: ([0-9.]+)", out)
        assert len(errs) == 2 and errs[0] == errs[1], split
    assert sorted(p for p in os.listdir(cwd) if p.startswith("tr_")) == [
        "tr_settings.txt", "tr_test_outputs.csv", "tr_train_outputs.csv"]
