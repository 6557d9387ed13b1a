"""The port's Training slice against the JAX package on the CPU.

* split_data / split_data_CV: the same indices (both draw torch.randperm
  from a seeded Generator).
* Optimizers: torch.optim against the JAX package's optax optimizers, two
  steps from the same parameters and gradients, to 1e-6 (AdamW, Adam, SGD
  with and without momentum; Adagrad and RMSprop follow torch's defaults,
  which optax's differ from, ROADMAP §3).
* ReduceLROnPlateau (host) and plateau_step (device tensors) against the
  JAX package's ReduceLROnPlateau and plateau_step on one metric sequence:
  the same learning rates.
* One train step against the JAX `_train_step_body` under kernel xla, from
  the same (converted) parameters and batch: the loss, every parameter
  gradient before the optimizer and the new BatchNorm statistics, to rtol
  1e-5 and atol 1e-5·max|ref|, max|ref| taken over each layer's gradients
  (weight and bias together: behind a training-mode BatchNorm a bias
  gradient is a sum that nearly cancels, so its own max understates the
  scale of its f32 rounding). The port runs each of its kernel paths on
  the CPU (plain versions).
* Three epochs of the port's trainer against JAX setup_run +
  run_fused_training (kernel xla, dropout 0, the same seed, the JAX
  initial parameters converted): per-epoch train and val errors and the
  best model's test error to rtol 2e-3 and atol 2e-3, the tolerance of the
  JAX package's own fused-vs-xla training test.
* The Training CLI on the CPU writes the JAX package's file names and CSV
  headers, its checkpoint resumes and feeds Predict; a CUDA request
  without CUDA raises; requests the port cannot honour raise.
"""

import copy
import csv
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.training import fused as JF
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training import train as JT
from matdeeplearn_tpu.training.optimizers import build_optimizer as j_build_optimizer
from matdeeplearn_tpu.training.scheduler import ReduceLROnPlateau as JPlateau
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training import train as TT
from matdeeplearn_torch.training import trainer as TR
from matdeeplearn_torch.training.checkpoint import load_checkpoint
from matdeeplearn_torch.training.optimizers import build_optimizer
from matdeeplearn_torch.training.scheduler import ReduceLROnPlateau

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"model": "CGCNN", "dim1": 16, "dim2": 12, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "True", "dropout_rate": 0.0, "print_model": False}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _state_dict(params, stats):
    return params_from_jax(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, stats))


def _close(a, b, rtol, name, atol_scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = rtol * max(float(np.abs(b).max()), 1e-30) if atol_scale is None \
        else atol_scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# -------------------------------------------------------------------- splits


@pytest.mark.parametrize("seed", [1, 42, 977])
def test_split_data_matches_jax(toy_dataset, seed):
    ratios = (0.7, 0.15, 0.1)
    for a, b in zip(TD.split_data(toy_dataset, *ratios, seed=seed),
                    JD.split_data(toy_dataset, *ratios, seed=seed)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TD.split_data_CV(toy_dataset, 3, seed),
                    JD.split_data_CV(toy_dataset, 3, seed)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name,args", [
    ("AdamW", {}),
    ("AdamW", {"weight_decay": 0.1, "betas": [0.8, 0.99]}),
    ("Adam", {}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.9, "weight_decay": 0.01}),
])
def test_optimizer_steps_match_optax(name, args):
    rng = np.random.default_rng(0)
    shapes = {"w": (7, 5), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]

    tx = j_build_optimizer(name, 0.01, args)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = build_optimizer(name, list(tp.values()), 0.01, args)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------- scheduler

METRICS = [1.0, 0.9, 0.9, 0.9, 0.95, 0.5, 0.5, 0.5001, 0.4, float("nan"),
           0.4, 0.4, 0.4, 0.39, 0.39, 0.39, 0.39]


@pytest.mark.parametrize("kw", [
    {"factor": 0.5, "patience": 1, "threshold": 1e-3, "min_lr": 1e-3},
    {"factor": 0.8, "patience": 0, "threshold": 2e-4, "min_lr": 0.0,
     "cooldown": 2},
    {"factor": 0.5, "patience": 2, "threshold": 0.05, "min_lr": 0.0,
     "threshold_mode": "abs"},
])
def test_scheduler_matches_jax(kw):
    lr = 0.01
    port, ref = ReduceLROnPlateau(lr=lr, **kw), JPlateau(lr=lr, **kw)
    dev_state, jstate = TR.plateau_init(lr), JF.plateau_init(lr)
    for m in METRICS:
        assert port.step(m) == ref.step(m)
        dev_state = TR.plateau_step(dev_state, torch.tensor(m), **kw)
        jstate = JF.plateau_step(jstate, jnp.float32(m), **kw)
        assert float(dev_state.lr) == pytest.approx(float(jstate.lr), rel=1e-6)
        assert int(dev_state.num_bad) == int(jstate.num_bad)
        assert int(dev_state.cooldown) == int(jstate.cooldown)
    assert port.state_dict() == ref.state_dict()


# ---------------------------------------------------------------- train step


def _capture_grads():
    """An optax transformation whose state after update is the gradient."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_step(toy_dataset):
    run = JJ.setup_run(toy_dataset, {**MODEL, "kernel": "xla"}, "l1_loss",
                       seed=5)
    ids = JT.epoch_id_matrix(np.arange(len(toy_dataset)), 4, True, 11)[0]
    cap = _capture_grads()
    state = run.state.replace(opt_state=cap.init(run.state.params))
    new, loss, count = JT._train_step_body(
        run.model, cap, JT.get_loss("l1_loss"), run.spec, state, run.data,
        jnp.asarray(ids), jax.random.PRNGKey(0))
    return run, ids, float(loss), float(count), new


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_train_step_matches_jax(toy_dataset, jax_step, kernel):
    jrun, ids, jloss, jcount, jnew = jax_step
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": kernel}, "l1_loss",
                       seed=5, device="cpu")
    run.model.load_state_dict(_state_dict(jrun.state.params,
                                          jrun.state.batch_stats))
    loss, count = TT.train_step(run.model, run.optimizer,
                                TT.get_loss("l1_loss"), run.spec, run.data, ids)
    assert float(count) == jcount
    _close(float(loss), jloss, 1e-5, "loss")
    grads = {k: p.grad for k, p in run.model.named_parameters()}
    ref_grads = _state_dict(jnew.opt_state, {})
    assert set(grads) == set(ref_grads)
    layer_max = {}
    for k, g in ref_grads.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), float(g.abs().max()))
    for k, g in ref_grads.items():
        _close(grads[k].numpy(), g.numpy(), 1e-5, f"grad {k}",
               1e-5 * layer_max[k.rsplit(".", 1)[0]])
    stats = {k: v for k, v in run.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    ref_stats = _state_dict({}, jnew.batch_stats)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        _close(stats[k].numpy(), v.numpy(), 1e-5, k)


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def jax_training(toy_dataset):
    """JAX setup_run + run_fused_training, three epochs, kernel xla."""
    import contextlib
    import io

    ds = toy_dataset
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    run = JJ.setup_run(ds, {**MODEL, "kernel": "xla"}, "l1_loss", seed=9)
    init = _state_dict(run.state.params, run.state.batch_stats)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best, _, _ = JJ.run_fused_training(run, train_idx=idx[0],
                                           val_idx=idx[1], epochs=3,
                                           verbosity=1, seed=9)
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    test_err = JT.evaluate_scan(run.eval_epoch_fn, best, run.data, idx[2], 4)
    return idx, init, epochs, test_err


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_trainer_matches_jax_three_epochs(toy_dataset, jax_training, kernel):
    (train_idx, val_idx, test_idx), init, jepochs, jtest = jax_training
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": kernel}, "l1_loss",
                       seed=9, device="cpu")
    run.model.load_state_dict(init)
    best, _, history = TJ.run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
        seed=9)
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        assert np.isfinite([ptr, pva]).all()
        _close(ptr, tr, 2e-3, f"epoch {e + 1} train", 2e-3)
        _close(pva, va, 2e-3, f"epoch {e + 1} val", 2e-3)
        _close(plr, lr, 1e-6, f"epoch {e + 1} lr", 1e-6)
    run.model.load_state_dict(best)
    test_err = TT.evaluate(run.model, "l1_loss", run.spec, run.data, test_idx, 4)
    _close(test_err, jtest, 2e-3, "best model's test error", 2e-3)



def test_trainer_without_val_keeps_the_last_state(toy_dataset):
    """No val split (as in CV folds): every epoch improves, so the best
    state is the last one, and the val error is NaN."""
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": "fused"}, "l1_loss",
                       seed=3, device="cpu")
    best, _, history = TJ.run_fused_training(
        run, train_idx=np.arange(12), val_idx=np.array([], np.int64),
        epochs=2, verbosity=2, seed=3)
    assert len(history) == 2 and np.isnan([h[1] for h in history]).all()
    assert np.isfinite([h[0] for h in history]).all()
    for k, v in run.model.state_dict().items():
        assert torch.equal(best[k], v), k

def test_dropout_masks_come_from_the_seeded_generator(toy_dataset):
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    spec = BatchSpec.for_dataset(toy_dataset.node_counts(),
                                 toy_dataset.edge_counts(), 4)
    batch = assemble_batch(DeviceDataset.from_graph_dataset(toy_dataset, "cpu"),
                           np.arange(4, dtype=np.int32), spec)
    hp = {**MODEL, "dropout_rate": 0.5}

    def outputs(dropout_seed):
        torch.manual_seed(dropout_seed + 100)  # the global RNG must not matter
        m = build_model("CGCNN", toy_dataset, hp, dropout_seed=dropout_seed,
                        generator=torch.Generator().manual_seed(0)).train()
        return torch.stack([m(batch) for _ in range(2)]).detach()

    a, b, c = outputs(3), outputs(3), outputs(4)
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])  # a fresh mask every call
    assert not torch.equal(a, c)


# ---------------------------------------------------------------- jobs, CLI


def test_resolve_kernel():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert TJ.resolve_kernel("CGCNN", "auto", "padded", cpu).name == "xla"
    plan = TJ.resolve_kernel("CGCNN", "auto", "padded", cuda)
    assert (plan.name, plan.edge_order, plan.fused) == ("fused", "dst", True)
    plan = TJ.resolve_kernel("CGCNN", "csr", "padded", cpu)
    assert (plan.name, plan.edge_order, plan.fused) == ("csr", "dst", False)
    assert TJ.resolve_kernel("CGCNN", "xla", "padded", cuda).edge_order is None
    with pytest.raises(ValueError, match="unknown kernel"):
        TJ.resolve_kernel("CGCNN", "triton", "padded", cpu)
    plan = TJ.resolve_kernel("CGCNN", "pallas", "padded", cpu)
    assert (plan.name, plan.edge_order, plan.fused, plan.windowed) == (
        "pallas", None, False, True)
    for args, item in ((("CGCNN", "fused", "packed"), "item 3"),
                       (("MEGNet", "fused", "padded"), "items 10 and 12")):
        with pytest.raises(NotImplementedError, match=item):
            TJ.resolve_kernel(*args, cpu)


def _config(tmp_path, data_dir, **models):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=data_dir)
    cfg["Models"]["CGCNN_demo"].update(
        {"dim1": 16, "dim2": 12, "batch_size": 4, "epochs": 2, **models})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cli(tmp_path, *args):
    proc = subprocess.run(
        [sys.executable, "-m", "matdeeplearn_torch", *args],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    return proc


def _headers(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".csv"):
            with open(os.path.join(directory, name)) as f:
                out[name] = next(csv.reader(f))
    return out


def test_training_cli_writes_the_jax_outputs(toy_dataset, toy_data_dir,
                                             tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    monkeypatch.chdir(jdir)
    job = {"job_name": "my_train_job", "seed": 3, "write_error": "True",
           "model_path": "my_model.ckpt"}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    JJ.train_regular(toy_dataset, job, tp, {**MODEL, "epochs": 1,
                                            "kernel": "xla"})

    cfg = _config(tdir, toy_data_dir, epochs=1)
    proc = _cli(tdir, "--config_path", cfg, "--run_mode=Training",
                "--device=cpu", "--seed=3", "--verbosity=1",
                "--train_ratio=0.7", "--val_ratio=0.15", "--test_ratio=0.15")
    assert proc.returncode == 0, proc.stderr
    assert "resolved: model=CGCNN kernel=xla" in proc.stdout
    assert len(EPOCH_LINE.findall(proc.stdout)) == 1
    for split in ("Train", "Val", "Test"):
        assert f"{split} Error:" in proc.stdout
    jh = _headers(jdir)
    jh.pop("my_train_job_errorvalues.csv")  # write_error is not a CLI flag
    assert _headers(tdir) == jh
    assert os.path.exists(tdir / "my_model.ckpt")
    assert os.path.exists(tdir / "my_model_temp.ckpt")
    assert os.path.exists(tdir / "my_train_job_settings.txt")

    meta, _, opt = load_checkpoint(str(tdir / "my_model.ckpt"),
                                   with_optimizer=True)
    assert meta["model_name"] == "CGCNN" and opt["state"]
    assert set(meta["scheduler"]) >= {"lr", "best", "num_bad_epochs"}
    proc = _cli(tdir, "--config_path", cfg, "--run_mode=Predict",
                "--device=cpu", "--model_path=my_model.ckpt")
    assert proc.returncode == 0, proc.stderr
    with open(tdir / "my_predict_job_predicted_outputs.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ids", "target", "prediction"] and len(rows) == 17


def test_load_model_resumes_the_optimizer(toy_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    mp = {**MODEL, "epochs": 1, "kernel": "fused"}
    TJ.train_regular(toy_dataset, {"job_name": "a", "seed": 2,
                                   "write_output": "False"}, tp, mp,
                     device="cpu")
    _, saved, opt = load_checkpoint("my_model.ckpt", with_optimizer=True)
    run = TJ.setup_run(toy_dataset, mp, "l1_loss", seed=2, device="cpu")
    from matdeeplearn_torch.training.optimizers import load_optimizer_state

    load_optimizer_state(run.optimizer, opt)
    first = next(iter(run.optimizer.state.values()))
    assert float(first["step"]) == 3  # 11 train graphs, batch 4
    errors = TJ.train_regular(
        toy_dataset, {"job_name": "b", "seed": 2, "write_output": "False",
                      "load_model": "True", "model_path": "my_model.ckpt",
                      "write_error": "True"},
        tp, mp, device="cpu")
    assert np.isfinite(list(errors.values())).all()
    np.testing.assert_allclose(np.loadtxt("b_errorvalues.csv", delimiter=","),
                               [errors["train"], errors["val"], errors["test"]],
                               rtol=1e-6)
    assert saved.keys() == run.model.state_dict().keys()



def test_optimizer_state_resumes_under_another_capturable_setting():
    """A state saved by a capturable optimizer (the card's AdamW) resumes
    in a non-capturable one (the CPU's), with the same next step."""
    from matdeeplearn_torch.training.optimizers import (load_optimizer_state,
                                                        optimizer_state)

    p0 = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    opt = build_optimizer("AdamW", [p0], 0.01, {})
    p0.grad = torch.ones_like(p0)
    opt.step()
    sd = copy.deepcopy(optimizer_state(opt))  # a checkpoint holds copies
    saved = {**sd, "param_groups": [{**g, "capturable": True}
                                    for g in sd["param_groups"]]}
    p1 = torch.nn.Parameter(p0.detach().clone())
    resumed = build_optimizer("AdamW", [p1], 0.5, {})
    load_optimizer_state(resumed, saved)
    assert resumed.param_groups[0]["capturable"] is False
    assert resumed.param_groups[0]["lr"] == 0.01
    p0.grad = p1.grad = torch.full_like(p0, 0.5)
    opt.step()
    resumed.step()
    torch.testing.assert_close(p1, p0, rtol=0, atol=0)

def test_cuda_request_without_cuda_raises(toy_dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TJ.train_regular(toy_dataset, {"seed": 1, "save_model": "False",
                                       "write_output": "False"},
                         {"loss": "l1_loss"}, MODEL)


@pytest.mark.parametrize("flag,item", [("--parallel=True", "item 16"),
                                       ("--ep=2", "item 16"),
                                       ("--profile=True", "item 17"),
                                       ("--batching=packed", "item 3")])
def test_cli_refuses_unported_flags(flag, item):
    from matdeeplearn_torch import cli

    args = cli.build_parser().parse_args(["--run_mode=Training", flag])
    with pytest.raises(NotImplementedError, match=item):
        cli.load_config(args)


def test_chip_smoke_training_job_matches_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.TRAIN_JOB == cfg["Job"]["Training"]
    assert cfg["Job"]["Training"]["model"] == "CGCNN_demo"
    tcfg = chip_smoke.training_config("d", "m.ckpt", "j", "cpu", 2)
    assert tcfg["Models"]["batch_size"] == 100
    assert tcfg["Training"]["verbosity"] == 1
