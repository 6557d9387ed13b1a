"""The port's packed batching against the JAX package on the CPU, on a
size-skewed dataset (many small graphs, a few large ones, as in
tests/test_packed.py).

* BatchSpec.packed_for_dataset, packed_steps and packed_id_matrix equal the
  JAX package's, flat and over windowed counts, for (shuffle, seed) in
  (True, 0), (True, 7), (False, None): the same numpy RNG call gives the
  same bins.
* Every field of a packed batch equals JAX's for the same ids, on the
  masked rows (the reference order, dst- and src-sorted, windowed).
* Packed eval outputs come back in `indices` order: equal to the padded
  eval's, id by id, with the same parameters.
* Three epochs of the port's trainer under packed batching against JAX
  setup_run + run_fused_training with packed batching (the same seed, the
  JAX initial parameters converted): kernels xla, csr and fused (the
  port's fused plan packs flat counts) against JAX kernel xla, which packs
  the same flat counts into the same bins; kernel pallas (windowed counts)
  against JAX kernel pallas (its windowed kernels in interpret mode). Per-
  epoch train and val errors to rtol 2e-3 and atol 2e-3, the learning rate
  to 1e-6; MEGNet under packed csr (src order, an all-pad eval bin) the
  same way.
* The Training CLI trains with --batching=packed on the CPU.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.data.dataset import GraphDataset
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import windowed as TW
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import train as TT

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 10
TW_, TE_ = 8, 16  # the windowed layout's window and tile
MODEL = {"model": "CGCNN", "dim1": 12, "dim2": 10, "gc_count": 2,
         "post_fc_count": 1, "batch_size": BS, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "True", "dropout_rate": 0.0, "print_model": False,
         "batching": "packed", "kernel_tw": TW_, "kernel_te": TE_}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


@pytest.fixture(scope="module")
def skewed():
    """60 graphs: 50 of 4-8 atoms, 10 of 25-40 (numpy seed 11)."""
    from matdeeplearn_tpu.data import graphs as G
    from matdeeplearn_tpu.data.structures import Structure

    rng = np.random.default_rng(11)
    atom_dict = G.default_atom_dictionary()
    structs, srcs, dsts, dists, xs = [], [], [], [], []
    sizes = np.concatenate([rng.integers(4, 9, 50), rng.integers(25, 41, 10)])
    rng.shuffle(sizes)
    for i, na in enumerate(sizes):
        na = int(na)
        cell = np.eye(3) * (6.0 + na ** (1 / 3))
        s = Structure(rng.integers(1, 30, na), rng.random((na, 3)) @ cell,
                      cell, np.ones(3, bool), str(i))
        src, dst, dist = G.build_graph(s, radius=5.0, max_neighbors=8)
        structs.append(s)
        srcs.append(src)
        dsts.append(dst)
        dists.append(dist)
        xs.append(np.concatenate([G.node_features(s.numbers, atom_dict),
                                  G.one_hot_degree(src, na, 9)], axis=1))
    normed, _, _ = G.normalize_edges(dists)
    return GraphDataset(
        node_x=np.concatenate(xs).astype(np.float32),
        node_z=np.concatenate([s.numbers for s in structs]).astype(np.int32),
        edge_src=np.concatenate(srcs).astype(np.int32),
        edge_dst=np.concatenate(dsts).astype(np.int32),
        edge_weight=np.concatenate(dists).astype(np.float32),
        edge_dist_norm=np.concatenate(normed).astype(np.float32),
        node_ptr=np.concatenate([[0], np.cumsum([len(s) for s in structs])]
                                ).astype(np.int64),
        edge_ptr=np.concatenate([[0], np.cumsum([len(e) for e in srcs])]
                                ).astype(np.int64),
        y=rng.standard_normal((len(structs), 1)).astype(np.float32),
        u=np.zeros((len(structs), 3), np.float32),
        structure_ids=[s.structure_id for s in structs],
    )


def _counts(ds, windowed):
    if windowed:
        layout = TW.build_windowed_layout(ds, TW_, TE_)
        return (layout.node_counts_w, layout.wedge_counts,
                dict(align=TW_, align_edges=TE_))
    return ds.node_counts(), ds.edge_counts(), {}


def _spec(mod, counts):
    nc, ec, align = counts
    return mod.BatchSpec.packed_for_dataset(nc, ec, BS, **align)


def _as_tuple(spec):
    return spec.num_graphs, spec.num_nodes, spec.num_edges


# ------------------------------------------------------- spec and id matrix


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 7), (False, None)])
def test_packer_matches_jax(skewed, windowed, shuffle, seed):
    counts = _counts(skewed, windowed)
    nc, ec, _ = counts
    jspec, tspec = _spec(JB, counts), _spec(TB, counts)
    assert _as_tuple(tspec) == _as_tuple(jspec)
    # ceil(1.5·B) + 1 graph slots, nodes and edges below the padded spec's
    assert tspec.num_graphs == 16
    padded = TB.BatchSpec.for_dataset(nc, ec, BS, **counts[2])
    assert tspec.num_nodes < padded.num_nodes
    for idx in (np.arange(len(skewed)), np.arange(len(skewed))[::3],
                np.array([], np.int64)):
        assert TB.packed_steps(idx, nc, ec, tspec, BS) == JB.packed_steps(
            idx, nc, ec, jspec, BS)
        want = JB.packed_id_matrix(idx, nc, ec, jspec, BS, shuffle, seed)
        got = TB.packed_id_matrix(idx, nc, ec, tspec, BS, shuffle, seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if len(idx):
            real = got.reshape(-1)
            assert sorted(real[real >= 0].tolist()) == sorted(idx.tolist())
            for row in got:
                sel = row[row >= 0]
                assert nc[sel].sum() <= tspec.num_nodes
                assert ec[sel].sum() <= tspec.num_edges


def test_packer_refuses_a_spec_too_tight(skewed):
    nc, ec = skewed.node_counts(), skewed.edge_counts()
    tight = TB.BatchSpec(16, int(nc.max()) - 1, int(ec.sum()))
    with pytest.raises(ValueError, match="no bin fits graph"):
        TB.packed_id_matrix(np.arange(len(skewed)), nc, ec, tight, BS, True, 0)


# ------------------------------------------------------------------ batches


@pytest.mark.parametrize("layout", [None, "dst", "src", "windowed"])
def test_packed_batch_matches_jax(skewed, layout):
    """Every field of a packed batch, the JAX one and the port's, for the
    ids of one packed bin: masked rows where pad contents may differ."""
    ds = skewed
    windowed = layout == "windowed"
    counts = _counts(ds, windowed)
    spec, jspec = _spec(TB, counts), _spec(JB, counts)
    mat = TB.packed_id_matrix(np.arange(len(ds)), counts[0], counts[1], spec,
                              BS, True, 3)
    ids = mat[np.argmax((mat >= 0).sum(1))]  # the fullest bin
    # flat bins of small graphs hold more graphs than the padded batch
    assert (ids >= 0).sum() > (1 if windowed else BS)
    if windowed:
        from matdeeplearn_tpu.data import windowed as JW

        jdd = JB.DeviceDataset.from_graph_dataset(ds)
        jb = JB.assemble_batch_windowed(
            jdd, JB.WindowedDeviceData.from_layout(
                JW.build_windowed_layout(ds, TW_, TE_)),
            jnp.asarray(ids), jspec, TW_, TE_)
        tdd = TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", windowed=TB.WindowedDeviceData.from_layout(
                TW.build_windowed_layout(ds, TW_, TE_), "cpu"))
    else:
        jb = JB.assemble_batch(
            JB.DeviceDataset.from_graph_dataset(ds, edge_order=layout),
            jnp.asarray(ids), jspec)
        tdd = TB.DeviceDataset.from_graph_dataset(ds, "cpu", edge_order=layout)
    tb = TB.assemble(tdd, ids, spec)
    assert tb.num_graphs == 16
    nm = np.asarray(jb.node_mask) > 0
    em = np.asarray(jb.edge_mask) > 0
    for k in ("node_mask", "edge_mask", "graph_mask", "node_graph", "y", "u",
              "n_node"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    np.testing.assert_array_equal(tb.x.numpy()[nm], np.asarray(jb.x)[nm])
    for k in ("edge_src", "edge_dst", "edge_weight", "edge_dist_norm"):
        np.testing.assert_array_equal(getattr(tb, k).numpy()[em],
                                      np.asarray(getattr(jb, k))[em], err_msg=k)
    if windowed:
        for k in ("tile_window", "tile_first", "in_degree"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)), err_msg=k)
    elif layout is not None:
        np.testing.assert_array_equal(tb.in_degree.numpy(),
                                      np.asarray(jb.in_degree))
        side = tb.edge_dst if layout == "dst" else tb.edge_src
        assert np.all(np.diff(side.numpy()[em]) >= 0)
        assert (tb.dst_sorted, tb.src_sorted) == (jb.dst_sorted, jb.src_sorted)


# -------------------------------------------------------------------- eval


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_packed_eval_comes_back_in_indices_order(skewed, kernel):
    """The same parameters through a padded and a packed run: per-graph
    predictions and targets equal, id by id, though the packed eval
    matrix is not the padded one."""
    ds = skewed
    mp = {**MODEL, "kernel": kernel}
    pad = TJ.setup_run(ds, {**mp, "batching": "padded"}, "l1_loss", seed=3,
                       device="cpu")
    pack = TJ.setup_run(ds, mp, "l1_loss", seed=3, device="cpu")
    pack.model.load_state_dict(pad.model.state_dict())
    idx = np.random.default_rng(0).permutation(len(ds))[:41]
    ids = pack.id_matrix(idx, False, None)
    assert ids.shape[1] == 16 and not np.array_equal(
        ids.reshape(-1)[:len(idx)], TT.epoch_id_matrix(idx, BS, False,
                                                       None).reshape(-1)[:41])
    lp, pp, tp = TT.evaluate(pad.model, "l1_loss", pad.spec, pad.data, idx, BS,
                             out=True)
    lk, pk, tk = TT.evaluate(pack.model, "l1_loss", pack.spec, pack.data, idx,
                             BS, out=True, id_matrix_fn=pack.id_matrix)
    np.testing.assert_array_equal(tk, tp)
    np.testing.assert_allclose(pk, pp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lk, lp, rtol=1e-5)


# ------------------------------------------------------------------ trainer


def _jax_training(ds, kernel):
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = JJ.setup_run(ds, {**MODEL, "kernel": kernel}, "l1_loss", seed=9)
        init = params_from_jax(jax.tree.map(np.asarray, run.state.params),
                               jax.tree.map(np.asarray, run.state.batch_stats))
        JJ.run_fused_training(run, train_idx=idx[0], val_idx=idx[1], epochs=3,
                              verbosity=1, seed=9)
    assert "batching=packed" in buf.getvalue()
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    return idx, init, epochs, run.id_matrix_fn


@pytest.fixture(scope="module")
def jax_flat(skewed):
    """JAX packed training over flat counts (kernel xla)."""
    return _jax_training(skewed, "xla")


@pytest.fixture(scope="module")
def jax_windowed(skewed):
    """JAX packed training over windowed counts (kernel pallas)."""
    return _jax_training(skewed, "pallas")


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused", "pallas"])
def test_packed_trainer_matches_jax_three_epochs(skewed, request, kernel):
    ref = "jax_windowed" if kernel == "pallas" else "jax_flat"
    (train_idx, val_idx, _), init, jepochs, jidm = request.getfixturevalue(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TJ.setup_run(skewed, {**MODEL, "kernel": kernel}, "l1_loss",
                           seed=9, device="cpu")
    assert "batching=packed" in buf.getvalue()
    for shuffle, seed in ((True, 10), (False, None)):
        np.testing.assert_array_equal(run.id_matrix(train_idx, shuffle, seed),
                                      jidm(train_idx, shuffle, seed))
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
        seed=9)
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        assert np.isfinite([ptr, pva]).all()
        np.testing.assert_allclose(ptr, tr, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} train")
        np.testing.assert_allclose(pva, va, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} val")
        np.testing.assert_allclose(plr, lr, rtol=1e-6, atol=1e-6,
                                   err_msg=f"epoch {e + 1} lr")


MEGNET = {**MODEL, "model": "MEGNet", "dim3": 8, "gc_fc_count": 1,
          "batch_norm": "False"}


def test_packed_megnet_trainer_matches_jax_three_epochs(skewed):
    """MEGNet under packed csr (the src order; without BatchNorm, whose bias
    gradients cancel: tests/test_torch_megnet.py) against JAX packed
    training (kernel xla, the same flat bins). The val split's packed
    matrix ends in an all-pad bin, whose pad edges point at the dummy
    graph segment: the u broadcast clamps it."""
    idx = JD.split_data(skewed, 0.7, 0.15, 0.15, seed=9)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrun = JJ.setup_run(skewed, {**MEGNET, "kernel": "xla"}, "l1_loss",
                            seed=9)
        init = params_from_jax(jax.tree.map(np.asarray, jrun.state.params),
                               jax.tree.map(np.asarray,
                                            jrun.state.batch_stats))
        JJ.run_fused_training(jrun, train_idx=idx[0], val_idx=idx[1],
                              epochs=3, verbosity=1, seed=9)
    jepochs = [tuple(float(v) for v in m.groups()[1:])
               for m in EPOCH_LINE.finditer(buf.getvalue())]
    run = TJ.setup_run(skewed, {**MEGNET, "kernel": "csr"}, "l1_loss", seed=9,
                       device="cpu")
    assert run.data.src_sorted
    val_ids = run.id_matrix(idx[1], False, None)
    assert (val_ids < 0).all(1).any()  # an all-pad bin
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(run, train_idx=idx[0],
                                          val_idx=idx[1], epochs=3,
                                          verbosity=1, seed=9)
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        np.testing.assert_allclose(ptr, tr, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} train")
        np.testing.assert_allclose(pva, va, rtol=2e-3, atol=2e-3,
                                   err_msg=f"epoch {e + 1} val")
        np.testing.assert_allclose(plr, lr, rtol=1e-6, atol=1e-6,
                                   err_msg=f"epoch {e + 1} lr")


def test_packed_steps_feed_the_meter(skewed):
    """The analytic FLOPs count the packed steps of an epoch."""
    from matdeeplearn_torch.utils.profiling import (ThroughputMeter,
                                                    attach_analytic_flops)

    run = TJ.setup_run(skewed, {**MODEL, "kernel": "xla"}, "l1_loss", seed=1,
                       device="cpu")
    train_idx = np.arange(40)
    steps = run.id_matrix(train_idx, True, 1).shape[0]
    assert steps == TB.packed_steps(train_idx, skewed.node_counts(),
                                    skewed.edge_counts(), run.spec, BS)
    meters = [ThroughputMeter(1, 1.0, 1.0) for _ in range(2)]
    for m, s in zip(meters, (steps, 1)):
        attach_analytic_flops(m, "CGCNN", run.model_config, run.spec, 40, 0,
                              BS, steps_per_epoch=s)
    assert meters[0].flops_per_epoch == pytest.approx(
        steps * meters[1].flops_per_epoch)


# ---------------------------------------------------------------------- CLI


def test_cli_trains_packed(toy_data_dir, tmp_path):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg["Models"]["CGCNN_demo"].update(
        {"dim1": 12, "dim2": 10, "batch_size": 4, "epochs": 2})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
         str(path), "--device=cpu", "--run_mode=Training",
         "--model=CGCNN_demo", "--seed=3", "--verbosity=1",
         "--batching=packed"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"resolved: model=CGCNN kernel=xla batching=packed .*"
                     r"spec=\(B=7,", proc.stdout), proc.stdout
    assert len(EPOCH_LINE.findall(proc.stdout)) == 2
    with open(tmp_path / "my_train_job_test_outputs.csv") as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("ids") and len(rows) > 1
