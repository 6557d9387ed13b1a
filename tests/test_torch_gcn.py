"""The port's GCN slice against the JAX package on the CPU.

* One GCNConv on a plain, a dst-sorted and a windowed batch (the JAX side
  on the same kind of batch: XLA, its CSR kernels and its windowed kernels
  in interpret mode): output, d/dx and d/dparams to rtol 1e-5 and atol
  1e-5·max|ref| of each.
* The converter carries a GCN tree both ways, exactly.
* GCN in eval mode (random BatchNorm statistics) at a small width and at
  GCN_demo's, under each of the port's kernels (xla: reference order, csr:
  dst-sorted, pallas: windowed), and in training mode with every parameter
  gradient, against the JAX GCN on the same graphs: rtol 2e-4 and atol
  2e-4·max|ref| (gradients: of each layer).
* CGCNN, SchNet and MPNN on a windowed batch against the JAX models on the
  same windowed batch (interpret mode), at small widths: 2e-4.
* conv{i}.bias feeds a training-mode BatchNorm, so its gradient is zero but
  for f32 rounding in both packages (pinned below). So three epochs of the
  port's trainer under kernels xla, csr and pallas are held to JAX
  setup_run + run_fused_training (kernel xla, the same seed and converted
  initial parameters) without BatchNorm: per-epoch train and val errors to
  rtol 2e-3 and atol 2e-3.
* resolve_kernel's pallas plans for the four models and GCN's plans; the
  CLI trains GCN_demo (narrowed) under kernel pallas and predicts on the
  CPU; Predict on a JAX-trained GCN checkpoint matches JAX Predict (ids
  equal, predictions to 1e-4); chip_smoke.py's GCN_demo is config.yml's.
"""

import contextlib
import csv
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
from matdeeplearn_tpu.data import windowed as JW
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.nn.conv import GCNConv as JGCNConv
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import load_checkpoint as j_load
from matdeeplearn_tpu.training.checkpoint import params_from_raw
from matdeeplearn_torch.convert import params_from_jax, params_to_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.data import windowed as TW
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn.conv import GCNConv
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import save_checkpoint

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
TW_, TE_ = 8, 16  # the windowed batches' window and tile
WIDTHS = {
    "small": {"dim1": 16, "dim2": 12, "gc_count": 2, "post_fc_count": 1},
    # GCN_demo (config.yml)
    "demo": {"dim1": 100, "dim2": 150, "pre_fc_count": 1, "gc_count": 4,
             "post_fc_count": 3, "pool": "global_mean_pool",
             "pool_order": "early", "batch_norm": "True",
             "batch_track_stats": "True", "act": "relu", "dropout_rate": 0.0},
}
MODEL = {"model": "GCN", **WIDTHS["small"], "batch_size": 4, "epochs": 3,
         "lr": 0.01, "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "False", "dropout_rate": 0.0, "print_model": False}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _close(a, b, tol, name, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


def _close_grads(got: dict, ref: dict, tol):
    """Each gradient to rtol `tol`, atol `tol`·(the largest gradient of its
    layer, conv{i} taken with its lin)."""
    assert set(got) == set(ref)
    layer_max = {}
    for k, g in ref.items():
        layer = k.split(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-30),
                               float(np.abs(np.asarray(g)).max()))
    for k, g in ref.items():
        _close(got[k], g, tol, k, layer_max[k.split(".", 1)[0]])


def _batches(ds, kernel, ids=IDS):
    """The JAX batch and the port's batch of the same graphs: the reference
    order (xla), dst-sorted (csr) or windowed (pallas), in both packages."""
    if kernel == "pallas":
        layout = TW.build_windowed_layout(ds, TW_, TE_)
        spec = TB.BatchSpec.for_dataset(layout.node_counts_w,
                                        layout.wedge_counts, len(ids),
                                        align=TW_, align_edges=TE_)
        jdata = JB.DeviceDataset.from_graph_dataset(ds)
        jb = JB.assemble_batch_windowed(
            jdata, JB.WindowedDeviceData.from_layout(
                JW.build_windowed_layout(ds, TW_, TE_)),
            jnp.asarray(ids), JB.BatchSpec(spec.num_graphs, spec.num_nodes,
                                           spec.num_edges), TW_, TE_)
        tdata = TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", windowed=TB.WindowedDeviceData.from_layout(layout, "cpu"))
        return jb, TB.assemble(tdata, ids, spec)
    order = "dst" if kernel == "csr" else None
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(ids))
    jb = JB.assemble_batch(
        JB.DeviceDataset.from_graph_dataset(ds, edge_order=order),
        jnp.asarray(ids),
        JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges))
    tb = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", edge_order=order), ids, spec)
    return jb, tb


def _randomize(variables, seed):
    """Random BatchNorm scale/bias and running statistics, and non-zero conv
    biases (numpy trees)."""
    rng = np.random.default_rng(seed)
    params = _tree(variables["params"])
    stats = _tree(variables.get("batch_stats", {}))
    for name, bn in stats.items():
        d = bn["mean"].shape[0]
        bn["mean"] = rng.normal(0.0, 0.5, d).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        params[name]["bias"] = rng.normal(0.0, 0.2, d).astype(np.float32)
    for name, p in params.items():
        if name.startswith("conv") and "bias" in p and "lin" in p:
            p["bias"] = rng.normal(0.0, 0.1, p["bias"].shape).astype(np.float32)
    return params, stats


def _jax_model(ds, name, hp, seed=0):
    model = j_build_model(name, ds, hp)
    jb, _ = _batches(ds, "xla")
    variables = model.init(jax.random.PRNGKey(seed), jb, training=False)
    return model, _randomize(variables, seed)


def _port_model(ds, name, hp, params, stats):
    model = build_model(name, ds, hp, device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model


# ----------------------------------------------------------------- the conv


@pytest.mark.parametrize("kernel", ["xla", "csr", "pallas"])
def test_gcnconv_matches_jax(toy_dataset, kernel):
    """One GCNConv: output, d/dx and d/dparams, each package on its own
    batch of that kind."""
    jb, tb = _batches(toy_dataset, kernel)
    assert tb.is_windowed == (kernel == "pallas")
    rng = np.random.default_rng(5)
    dim = 12
    x = rng.standard_normal((jb.num_nodes, dim)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    conv = JGCNConv(dim)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb)["params"]
    assert set(params) == {"lin", "bias"} and set(params["lin"]) == {"kernel"}
    params = jax.tree.map(lambda p: p + 0.05 * jnp.ones_like(p), params)
    nm = np.asarray(jb.node_mask) > 0

    def jloss(p, xv):
        return jnp.sum(conv.apply({"params": p}, xv, jb) * cot * nm[:, None])

    jout = conv.apply({"params": params}, jnp.asarray(x), jb)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    tconv = GCNConv(dim)
    tconv.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           params_from_jax({"conv": _tree(params)}).items()})
    xt = torch.tensor(x, requires_grad=True)
    out = tconv(xt, tb)
    (out * torch.as_tensor(cot) * torch.as_tensor(nm)[:, None]).sum().backward()
    _close(out.detach().numpy()[nm], np.asarray(jout)[nm], 1e-5, "output")
    _close(xt.grad.numpy(), gx, 1e-5, "d_x")
    got = {f"conv.{k}": p.grad.numpy() for k, p in tconv.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in
                       params_from_jax({"conv": _tree(gp)}).items()}, 1e-5)


def test_converter_carries_a_gcn_tree_both_ways(toy_dataset):
    _, (params, stats) = _jax_model(toy_dataset, "GCN", WIDTHS["demo"])
    assert set(params["conv0"]) == {"lin", "bias"}
    assert set(params["conv0"]["lin"]) == {"kernel"}  # no bias
    sd = params_from_jax(params, stats)
    assert sd["conv3.lin.weight"].shape == (100, 100)
    assert "conv0.lin.bias" not in sd and sd["conv0.bias"].shape == (100,)
    model = _port_model(toy_dataset, "GCN", WIDTHS["demo"], params, stats)
    assert model.conv0.lin.bias is None
    np.testing.assert_array_equal(model.conv1.lin.weight.detach().numpy(),
                                  params["conv1"]["lin"]["kernel"].T)
    p2, s2 = params_to_jax(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for (ka, a), (kb, b) in zip(flat(params), flat(p2)):
        assert ka == kb
        np.testing.assert_array_equal(b, a)
    for (_, a), (_, b) in zip(flat(stats), flat(s2)):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("kernel", ["xla", "csr", "pallas"])
@pytest.mark.parametrize("width", ["small", "demo"])
def test_gcn_eval_matches_jax(toy_dataset, width, kernel):
    """Per-graph outputs do not depend on the batch layout: the JAX GCN on
    its plain batch against the port on each of its kernels' batches."""
    ds = toy_dataset
    model, (params, stats) = _jax_model(ds, "GCN", WIDTHS[width])
    jb, _ = _batches(ds, "xla")
    _, tb = _batches(ds, kernel)
    ref = model.apply({"params": params, "batch_stats": stats}, jb,
                      training=False)
    tmodel = _port_model(ds, "GCN", WIDTHS[width], params, stats).eval()
    with torch.no_grad():
        out = tmodel(tb)
    gm = np.asarray(jb.graph_mask) > 0
    assert out.shape == ref.shape and np.isfinite(out.numpy()).all()
    _close(out.numpy()[gm], np.asarray(ref)[gm], 2e-4, "outputs")


def _jax_training_grads(model, params, stats, jbatch, cot):
    def jloss(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, jbatch,
                             training=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    return np.asarray(jout), {k: v.numpy() for k, v in
                              params_from_jax(_tree(jgrads)).items()}


def _port_training_grads(ds, params, stats, tbatch, cot):
    model = _port_model(ds, "GCN", WIDTHS["small"], params, stats).train()
    out = model(tbatch)
    (out * torch.as_tensor(cot)).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy()
                                  for k, p in model.named_parameters()}


def _cotangent(jb, seed):
    gmask = np.asarray(jb.graph_mask)
    return np.random.default_rng(seed).standard_normal(gmask.shape).astype(
        np.float32) * gmask


@pytest.mark.parametrize("kernel", ["xla", "csr", "pallas"])
def test_gcn_training_mode_matches_jax(toy_dataset, kernel):
    """Training-mode outputs (BatchNorm batch statistics over the real
    nodes) and parameter gradients against the JAX GCN on its plain
    batch."""
    ds = toy_dataset
    model, (params, stats) = _jax_model(ds, "GCN", WIDTHS["small"])
    jb, _ = _batches(ds, "xla")
    _, tb = _batches(ds, kernel)
    cot = _cotangent(jb, 4)
    jout, jgrads = _jax_training_grads(model, params, stats, jb, cot)
    out, grads = _port_training_grads(ds, params, stats, tb, cot)
    g = np.asarray(jb.graph_mask) > 0
    _close(out[g], jout[g], 2e-4, "outputs")
    _close_grads(grads, jgrads, 2e-4)


def test_conv_bias_gradient_cancels_behind_batchnorm(toy_dataset):
    """GCNConv's bias adds a constant to every real node just before a
    training-mode BatchNorm, which subtracts the batch mean: its gradient is
    zero but for rounding, in JAX and in the port (why the trainer parity
    below runs without BatchNorm)."""
    ds = toy_dataset
    model, (params, stats) = _jax_model(ds, "GCN", WIDTHS["small"])
    jb, _ = _batches(ds, "xla")
    _, tb = _batches(ds, "pallas")
    cot = _cotangent(jb, 8)
    for _, grads in (_jax_training_grads(model, params, stats, jb, cot),
                     _port_training_grads(ds, params, stats, tb, cot)):
        for i in range(2):
            scale = float(np.abs(grads[f"conv{i}.lin.weight"]).max())
            assert scale > 1e-3
            assert float(np.abs(grads[f"conv{i}.bias"]).max()) < 1e-5 * scale


@pytest.mark.parametrize("name", ["CGCNN", "SchNet", "MPNN"])
def test_windowed_forward_matches_jax(toy_dataset, name):
    """The other ported GNNs on a windowed batch (kernel pallas), against
    the JAX models on the same windowed batch: per-graph outputs in eval
    mode."""
    ds = toy_dataset
    hp = {"dim1": 12, "dim2": 10, "dim3": 8, "cutoff": 5, "gc_count": 2,
          "post_fc_count": 1}
    model, (params, stats) = _jax_model(ds, name, hp)
    jb, tb = _batches(ds, "pallas")
    ref = model.apply({"params": params, "batch_stats": stats}, jb,
                      training=False)
    tmodel = _port_model(ds, name, hp, params, stats).eval()
    with torch.no_grad():
        out = tmodel(tb)
    gm = np.asarray(jb.graph_mask) > 0
    assert np.isfinite(out.numpy()).all()
    _close(out.numpy()[gm], np.asarray(ref)[gm], 2e-4, f"{name} outputs")


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def jax_training(toy_dataset):
    """JAX setup_run + run_fused_training, three epochs, kernel xla."""
    ds = toy_dataset
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    run = JJ.setup_run(ds, {**MODEL, "kernel": "xla"}, "l1_loss", seed=9)
    init = params_from_jax(_tree(run.state.params),
                           _tree(run.state.batch_stats or {}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(run, train_idx=idx[0], val_idx=idx[1], epochs=3,
                              verbosity=1, seed=9)
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    return idx, init, epochs


@pytest.mark.parametrize("kernel", ["xla", "csr", "pallas"])
def test_gcn_trainer_matches_jax_three_epochs(toy_dataset, jax_training,
                                              kernel):
    (train_idx, val_idx, _), init, jepochs = jax_training
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": kernel}, "l1_loss",
                       seed=9, device="cpu")
    assert (run.data.windowed is not None) == (kernel == "pallas")
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
        seed=9)
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        assert np.isfinite([ptr, pva]).all()
        _close(ptr, tr, 2e-3, f"epoch {e + 1} train", 1.0)
        _close(pva, va, 2e-3, f"epoch {e + 1} val", 1.0)
        _close(plr, lr, 1e-6, f"epoch {e + 1} lr", 1.0)


# ------------------------------------------------------ jobs, CLI, Predict


def test_resolve_kernel_pallas_and_gcn(capsys):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    plan = lambda p: (p.name, p.edge_order, p.fused, p.windowed)
    for model in ("CGCNN", "SchNet", "MPNN", "GCN"):
        for dev in (cpu, cuda):
            assert plan(TJ.resolve_kernel(model, "pallas", "padded", dev)) == (
                "pallas", None, False, True), (model, dev)
    want = {("auto", cpu): ("xla", None, False, False),
            ("auto", cuda): ("csr", "dst", False, False),
            ("csr", cpu): ("csr", "dst", False, False),
            ("xla", cuda): ("xla", None, False, False)}
    for (kernel, dev), p in want.items():
        assert plan(TJ.resolve_kernel("GCN", kernel, "padded", dev)) == p
    capsys.readouterr()
    assert plan(TJ.resolve_kernel("GCN", "fused", "padded", cuda)) == (
        "pallas", None, False, True)
    assert "other models run the windowed aggregation kernel" in \
        capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        TJ.resolve_kernel("GCN", "pallas", "padded", cpu, "bf16")
    with pytest.raises(NotImplementedError, match="item 3"):
        TJ.resolve_kernel("GCN", "pallas", "packed", cuda)


@pytest.mark.parametrize("tw,te", [(None, None), (16, 32)])
def test_setup_run_windowed_layout(toy_dataset, tw, te, capsys):
    """kernel pallas: the layout's window and tile come from kernel_tw and
    kernel_te (by default the dataset's rule and 128), the spec is aligned
    to them, and the batches are windowed."""
    mp = {**MODEL, "kernel": "pallas", "kernel_tw": tw, "kernel_te": te}
    run = TJ.setup_run(toy_dataset, mp, "l1_loss", seed=1, device="cpu")
    wd = run.data.windowed
    want_tw = tw or TD.default_window(toy_dataset.node_counts())
    assert (wd.tw, wd.te) == (want_tw, te or 128)
    assert run.spec.num_nodes % wd.tw == 0 and run.spec.num_edges % wd.te == 0
    assert "kernel=pallas" in capsys.readouterr().out
    batch = TB.assemble(run.data, np.arange(4, dtype=np.int32), run.spec)
    assert batch.is_windowed and batch.window_size == wd.tw
    assert batch.tile_window.shape[0] == run.spec.num_edges // wd.te


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return (rows[0], [r[0] for r in rows[1:]],
            np.array([float(r[2]) for r in rows[1:]]))


def test_gcn_cli_trains_and_predicts(toy_data_dir, tmp_path):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg["Models"]["GCN_demo"].update(
        {"dim1": 12, "dim2": 10, "batch_size": 4, "epochs": 2})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    common = [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
              str(path), "--device=cpu"]
    proc = subprocess.run(
        common + ["--run_mode=Training", "--model=GCN_demo", "--seed=3",
                  "--verbosity=1", "--kernel=pallas"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "resolved: model=GCN kernel=pallas" in proc.stdout
    for name in ("conv0.lin.weight", "conv3.bias", "bn2.weight",
                 "post_lin2.weight"):
        assert re.search(rf"^{re.escape(name)} ", proc.stdout, re.M), name
    assert len(EPOCH_LINE.findall(proc.stdout)) == 2
    proc = subprocess.run(common + ["--run_mode=Predict",
                                    "--model_path=my_model.ckpt"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    head, ids, preds = _read_csv(tmp_path / "my_predict_job_predicted_outputs.csv")
    assert head == ["ids", "target", "prediction"] and len(ids) == 16
    assert np.isfinite(preds).all()


def test_predict_matches_jax_on_a_jax_trained_gcn(toy_dataset, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    JJ.train_regular(toy_dataset, {"job_name": "jt", "seed": 3,
                                   "model_path": "jax.ckpt",
                                   "write_output": "False"},
                     tp, {**MODEL, "epochs": 2, "kernel": "xla",
                          "batch_norm": "True"})
    meta, raw = j_load("jax.ckpt")
    assert meta["model_name"] == "GCN"
    params, batch_stats = params_from_raw(raw)
    save_checkpoint("port.ckpt", params_from_jax(_tree(params),
                                                 _tree(batch_stats)),
                    meta["model_name"], meta["model_config"])
    jerr = JJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "jax.ckpt", "job_name": "jax"})
    terr = TJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "port.ckpt", "job_name": "port"},
                      device="cpu")
    jh, jids, jp = _read_csv("jax_predicted_outputs.csv")
    th, tids, tpred = _read_csv("port_predicted_outputs.csv")
    assert th == jh and tids == jids == toy_dataset.structure_ids
    np.testing.assert_allclose(tpred, jp, rtol=1e-4, atol=1e-4)
    assert abs(terr - jerr) <= 1e-4


def test_chip_smoke_gcn_demo_matches_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.GCN_DEMO == cfg["Models"]["GCN_demo"]
    tcfg = chip_smoke.training_config("d", "m.ckpt", "j", "cpu", 2, "pallas",
                                      model=chip_smoke.GCN_DEMO)
    assert tcfg["Models"]["model"] == "GCN"
    assert tcfg["Models"]["kernel"] == "pallas"
    assert tcfg["Models"]["dim2"] == 150 and tcfg["Models"]["batch_size"] == 100
