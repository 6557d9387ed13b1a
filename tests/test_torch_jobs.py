"""The port's run modes CV, Repeat, Ensemble and Analysis against the JAX
package on the CPU.

* split_data_CV: the JAX package's folds (both cut one seeded
  torch.randperm).
* reset_run: fold k on a reused Run gives fold k on a fresh Run bit for
  bit (per-epoch errors and final state; AdamW, whose state reset_run
  zeroes in place, with and without dropout, whose generator it reseeds,
  and SGD, which it rebuilds), and on the trainer's
  graphs (a fake CUDA graph backend, as tests/test_torch_capture.py's)
  no capture happens after fold 0.
* CV: <job>_CV_outputs.csv lists the JAX folds' ids in fold order.
* Repeat: <job>_all_errorvalues.csv equals the JAX package's byte for byte
  for the same trial errors; Ensemble: <job>_test_ensemble_outputs.csv
  equals the JAX package's for the same member outputs (single and
  multi-target) and the ensemble's error to rtol 1e-6.
* Analysis: the graph embeddings of CGCNN and MEGNet (early pool) match
  the JAX package's sown graph_embedding to rtol 1e-5, on Predict's
  batches; the run mode writes the t-SNE CSV and raises naming
  scikit-learn without it.
* The CLI runs every new run mode on the toy config with --device=cpu.
"""

import contextlib
import csv
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_torch import cli
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.training import graphs as G
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import trainer as TR

from conftest import TOY_PROCESSING_ARGS
from test_torch_capture import _ReplayingBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"model": "CGCNN", "dim1": 12, "dim2": 10, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "epochs": 2, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "True", "dropout_rate": 0.0, "print_model": False,
         "kernel": "xla"}


@pytest.mark.parametrize("folds,seed", [(3, 1), (5, 7), (4, 42)])
def test_split_data_cv_matches_jax(toy_dataset, folds, seed):
    got = TD.split_data_CV(toy_dataset, folds, seed)
    want = JD.split_data_CV(toy_dataset, folds, seed)
    assert len(got) == len(want) == folds
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _fold(run, ds, k, seed, epochs=2):
    folds = TD.split_data_CV(ds, 4, seed)
    train = np.concatenate([folds[j] for j in range(4) if j != k])
    _, _, hist = TJ.run_fused_training(run, train_idx=train,
                                       val_idx=np.array([], np.int64),
                                       epochs=epochs, verbosity=1,
                                       seed=seed + k)
    return hist


@pytest.mark.parametrize("optimizer,dropout", [("AdamW", 0.0), ("SGD", 0.0),
                                               ("AdamW", 0.3)])
def test_reset_run_equals_a_fresh_run(toy_dataset, optimizer, dropout):
    mp = {**MODEL, "optimizer": optimizer, "dropout_rate": dropout,
          "optimizer_args": {"momentum": 0.9} if optimizer == "SGD" else {}}
    run = TJ.setup_run(toy_dataset, mp, "l1_loss", seed=5, device="cpu")
    for k in range(2):
        TJ.reset_run(run, 5 + k)
        reused = _fold(run, toy_dataset, k, 5)
    fresh = TJ.setup_run(toy_dataset, mp, "l1_loss", seed=6, device="cpu")
    # bit for bit (the val column is NaN: no val split)
    np.testing.assert_array_equal(_fold(fresh, toy_dataset, 1, 5), reused)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(run.model.state_dict()[k], v), k
    fresh_state = fresh.optimizer.state_dict()["state"]
    for i, st in run.optimizer.state_dict()["state"].items():
        for name, t in st.items():
            assert torch.equal(torch.as_tensor(t),
                               torch.as_tensor(fresh_state[i][name])), name


def test_reset_run_captures_nothing_after_fold_0(toy_dataset, monkeypatch):
    """On the trainer's graphs (a fake backend: capture records, replay
    runs the function) folds 1 and 2 replay fold 0's graphs and give the
    eager folds' errors."""
    hist = {}
    for mode in ("eager", "graphs"):
        if mode == "graphs":
            monkeypatch.setattr(TR, "capture_plan",
                                lambda *a, **k: G.CapturePlan(True))
            monkeypatch.setattr(TR, "CudaGraphs", _ReplayingBackend)
        run = TJ.setup_run(toy_dataset, MODEL, "l1_loss", seed=5, device="cpu")
        hist[mode] = []
        for k in range(3):
            TJ.reset_run(run, 5 + k)
            before = G.CAPTURES["graphs"]
            hist[mode].append(_fold(run, toy_dataset, k, 5))
            captured = G.CAPTURES["graphs"] - before
            if mode == "graphs":
                # fold 0: the train step and the epoch tail (no val split)
                assert captured == (2 if k == 0 else 0), (k, captured)
                assert len(run.graphs) == 1
    np.testing.assert_array_equal(hist["graphs"], hist["eager"])


def test_cv_outputs_list_the_jax_folds(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    err = TJ.train_CV(toy_dataset, {"job_name": "cv", "seed": 3,
                                    "cv_folds": 3},
                      {"loss": "l1_loss", "verbosity": 2}, MODEL,
                      device="cpu")
    assert np.isfinite(err)
    with open("cv_CV_outputs.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ids", "target", "prediction"]
    folds = JD.split_data_CV(toy_dataset, 3, 3)
    assert [r[0] for r in rows[1:]] == [toy_dataset.structure_ids[i]
                                       for f in folds for i in f]
    assert np.isfinite([float(r[2]) for r in rows[1:]]).all()


def _errors(t):
    return {"train": 0.5 + t, "val": 0.25 * t + 1e-3, "test": 1.0 / (t + 3)}


def test_repeat_csv_matches_jax(tmp_path, monkeypatch):
    """Both packages' train_repeat over the same trial errors (their
    train_regular replaced, numpy's global seed the same)."""
    monkeypatch.chdir(tmp_path)
    for name, mod in (("jax", JJ), ("port", TJ)):
        calls = []

        def fake(ds, jp, tp, mp, calls=calls, **kw):
            calls.append(jp["seed"])
            return _errors(len(calls) - 1)

        monkeypatch.setattr(mod, "train_regular", fake)
        monkeypatch.setattr(mod, "setup_run", lambda *a, **k: None)
        np.random.seed(11)
        kw = {"device": "cpu"} if mod is TJ else {}
        errs = mod.train_repeat(None, {"job_name": name, "repeat_trials": 3},
                                {}, {}, **kw)
        np.testing.assert_array_equal(
            errs, [[_errors(t)[s] for s in ("train", "val", "test")]
                   for t in range(3)])
    with open("jax_all_errorvalues.csv") as a, open(
            "port_all_errorvalues.csv") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("n_out", [1, 2])
def test_ensemble_matches_jax(tmp_path, monkeypatch, n_out):
    """Both packages' train_ensemble over the same members' test outputs."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(n_out)
    ids = [f"s{i}" for i in range(7)]
    targets = rng.standard_normal((7, n_out)).astype(np.float32)
    members = ["CGCNN_demo", "SchNet_demo", "CGCNN_demo"]
    preds = rng.standard_normal((3, 7, n_out)).astype(np.float32)
    errs = {}
    for name, mod in (("jax", JJ), ("port", TJ)):
        def fake(ds, jp, tp, mp, **kw):
            i = int(jp["job_name"].split("_")[1])
            with open(f"{jp['job_name']}_test_outputs.csv", "w",
                      newline="") as f:
                w = csv.writer(f)
                w.writerow(["ids"] + ["target"] * n_out + ["prediction"] * n_out)
                for j, sid in enumerate(ids):
                    w.writerow([sid, *targets[j], *preds[i, j]])
            return {"train": 0.0, "val": 0.0, "test": float(i)}

        monkeypatch.setattr(mod, "train_regular", fake)
        kw = {"device": "cpu"} if mod is TJ else {}
        errs[name] = mod.train_ensemble(
            None, {"job_name": name, "ensemble_list": ",".join(members),
                   "seed": 1}, {"loss": "l1_loss"},
            {m: {} for m in members}, **kw)
    with open("jax_test_ensemble_outputs.csv") as a, open(
            "port_test_ensemble_outputs.csv") as b:
        assert a.read() == b.read()
    np.testing.assert_allclose(errs["port"], errs["jax"], rtol=1e-6)
    want = np.abs(preds.astype(np.float64).mean(0) - targets).mean()
    np.testing.assert_allclose(errs["port"], want, rtol=1e-6)


EMBED_HP = {
    "CGCNN": {"dim1": 12, "dim2": 10, "gc_count": 2, "post_fc_count": 2},
    "MEGNet": {"dim1": 12, "dim2": 10, "dim3": 8, "gc_count": 2,
               "gc_fc_count": 1, "post_fc_count": 1},
}


@pytest.mark.parametrize("name", sorted(EMBED_HP))
def test_graph_embeddings_match_jax(toy_dataset, name):
    ds, hp = toy_dataset, EMBED_HP[name]
    ids = np.array([*range(16), -1, -1, -1, -1], np.int32)
    spec = JB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                    len(ids))
    jb = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(ds),
                           jnp.asarray(ids), spec)
    jmodel = j_build_model(name, ds, hp)
    variables = jmodel.init(jax.random.PRNGKey(2), jb, training=False)
    _, mods = jmodel.apply(variables, jb, training=False,
                           mutable=["intermediates"])
    want = np.asarray(jax.tree_util.tree_leaves(mods["intermediates"])[0])[:16]
    model = build_model(name, ds, hp, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables.get("batch_stats", {}))))
    got = TJ.graph_embeddings(model.eval(), name, ds, torch.device("cpu"),
                              batch_size=len(ids))
    assert got.shape == want.shape == (16, want.shape[1])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def trained(toy_dataset, tmp_path_factory):
    """A port checkpoint of MODEL after one epoch."""
    root = tmp_path_factory.mktemp("trained")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            TJ.train_regular(toy_dataset, {"seed": 2, "model_path": "m.ckpt",
                                           "write_output": "False"},
                             {"loss": "l1_loss"}, {**MODEL, "epochs": 1},
                             device="cpu")
    finally:
        os.chdir(cwd)
    return str(root / "m.ckpt")


def test_analysis_writes_the_tsne_csv(toy_dataset, trained, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the exact method: Barnes-Hut's OpenMP threads gain nothing on 16
    # samples and crowd the other test workers
    out = TJ.analysis(toy_dataset, trained,
                      {"perplexity": 5, "max_iter": 250, "random_state": 0,
                       "method": "exact"}, device="cpu")
    assert out.shape == (16, 2) and np.isfinite(out).all()
    with open("tsne_output.csv") as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == toy_dataset.structure_ids
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        TJ.analysis(toy_dataset, trained, {}, device="cpu")


def _config(tmp_path, data_dir):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=data_dir)
    for m in cfg["Models"].values():
        m.update(epochs=1, batch_size=4, dim1=8, dim2=8, dim3=8, gc_count=1,
                 post_fc_count=1, print_model=False)
    cfg["Job"]["CV"]["cv_folds"] = 2
    cfg["Job"]["Repeat"]["repeat_trials"] = 2
    cfg["Job"]["Ensemble"]["ensemble_list"] = "CGCNN_demo,SchNet_demo"
    cfg["Job"]["Hyperparameter"].update(hyper_trials=2)
    cfg["Models"]["CGCNN_demo"]["epochs"] = 2
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("mode,output", [
    ("CV", "my_CV_job_CV_outputs.csv"),
    ("Repeat", "my_repeat_job_all_errorvalues.csv"),
    ("Ensemble", "my_ensemble_job_test_ensemble_outputs.csv"),
    ("Analysis", "tsne_output.csv"),
    ("Hyperparameter", "my_hyperparameter_job_optimized_hyperparameters.json"),
])
def test_cli_runs_every_mode_on_the_cpu(toy_dataset, toy_data_dir, trained,
                                        tmp_path, monkeypatch, mode, output):
    from matdeeplearn_torch.training import hyper

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "TSNE_ARGS", {**cli.TSNE_ARGS, "n_iter": 250,
                                           "method": "exact"})
    # a small space: the default spaces are held to the JAX package's in
    # tests/test_torch_hyper.py, and their widest draws take minutes here
    monkeypatch.setattr(hyper, "default_search_space", lambda *a: {
        "dim1": hyper.Choice((8, 12)), "lr": hyper.LogUniform(1e-3, 1e-2),
        "batch_size": hyper.Choice((4, 8))})
    argv = [f"--config_path={_config(tmp_path, toy_data_dir)}",
            f"--run_mode={mode}", "--device=cpu", "--seed=4"]
    if mode == "Analysis":
        argv.append(f"--model_path={trained}")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    assert os.path.exists(output)
    if mode == "Hyperparameter":  # a second call resumes: no trial to train
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        assert "Trial " not in buf.getvalue()


def test_run_mode_help_names_all_seven():
    text = cli.build_parser().format_help()
    for mode in cli.RUN_MODES:
        assert mode in text
    assert len(cli.RUN_MODES) == 7


def test_chip_smoke_run_mode_jobs_match_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        jobs = yaml.safe_load(f)["Job"]
    for mode, section in chip_smoke.RUN_MODE_JOBS.items():
        assert section == jobs[mode], mode
    cfg = chip_smoke.run_mode_config("CV", "d", "j", "cpu", {"cv_folds": 3},
                                     {})
    assert cfg["Job"]["parallel"] == "False" and cfg["Job"]["cv_folds"] == 3
