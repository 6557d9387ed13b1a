"""The port's MPNN slice against the JAX package on the CPU.

* GRUCell against the JAX GRUCell: values, d/dx, d/dh and d/dparams to
  rtol 1e-5, atol 1e-5·max|ref|.
* One edge network and NNConv (the einsum branch on the reference order;
  the bilinear op's plain version on the dst order, kernels csr and fused)
  against the JAX pair on its einsum path, the one the JAX package runs off
  its TPU: output, d/dx and d/dparams, rtol 1e-5 and atol 1e-5·max|ref| of
  each layer.
* The converter carries an MPNN tree both ways, exactly.
* MPNN in eval mode (random BatchNorm statistics) at a small width and at
  MPNN_demo's, and in training mode with every parameter gradient, under
  each of the port's kernels, against the JAX MPNN: rtol 2e-4 and atol
  2e-4·max|ref| (gradients: of each layer).
* conv{i}.bias feeds a training-mode BatchNorm, so its gradient is zero but
  for f32 rounding in both packages (pinned below). So three epochs of the
  port's trainer under kernels xla, csr and fused are held to JAX setup_run
  + run_fused_training (kernel xla, the same seed and converted initial
  parameters) without BatchNorm: per-epoch train and val errors to rtol
  2e-3 and atol 2e-3.
* The CLI trains and predicts MPNN_demo (narrowed) on the CPU; Predict on
  a JAX-trained MPNN checkpoint matches JAX Predict (ids equal,
  predictions to 1e-4); resolve_kernel's MPNN plans; chip_smoke.py's
  MPNN_demo is config.yml's.
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
from flax import linen as fnn

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.nn.conv import NNConv as JNNConv
from matdeeplearn_tpu.nn.conv import _EdgeNetFactored
from matdeeplearn_tpu.nn.layers import GRUCell as JGRUCell
from matdeeplearn_tpu.ops.edge_basis import gaussian_basis as j_gaussian_basis
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import load_checkpoint as j_load
from matdeeplearn_tpu.training.checkpoint import params_from_raw
from matdeeplearn_torch.convert import params_from_jax, params_to_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn.conv import EdgeNetFactored, NNConv
from matdeeplearn_torch.nn.layers import GRUCell
from matdeeplearn_torch.ops.edge_basis import gaussian_basis
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import save_checkpoint

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
WIDTHS = {
    "small": {"dim1": 12, "dim2": 10, "dim3": 16, "gc_count": 2,
              "post_fc_count": 1},
    # MPNN_demo (config.yml)
    "demo": {"dim1": 100, "dim2": 100, "dim3": 100, "pre_fc_count": 1,
             "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
             "pool_order": "early", "batch_norm": "True",
             "batch_track_stats": "True", "act": "relu", "dropout_rate": 0.0},
}
# kernel → (edge order, fused) of the port's batches
KERNEL_BATCHES = {"xla": (None, False), "csr": ("dst", False),
                  "fused": ("dst", True)}
MODEL = {"model": "MPNN", **WIDTHS["small"], "batch_size": 4, "epochs": 3,
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
    """Each gradient to rtol `tol`, atol `tol`·(its layer's largest)."""
    assert set(got) == set(ref)
    layer_max = {}
    for k, g in ref.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-30),
                               float(np.abs(np.asarray(g)).max()))
    for k, g in ref.items():
        _close(got[k], g, tol, k, layer_max[k.rsplit(".", 1)[0]])


def _batches(ds, kernel):
    """The JAX flat batch and the port's batch of the same graphs."""
    order, fused = KERNEL_BATCHES[kernel]
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(IDS))
    jb = JB.assemble_batch(
        JB.DeviceDataset.from_graph_dataset(ds, edge_order=order),
        jnp.asarray(IDS),
        JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges))
    tb = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", edge_order=order, kernel_fused=fused), IDS, spec)
    return jb, tb


# ---------------------------------------------------------------- the layers


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(0)
    n, din, hid = 9, 7, 5
    x, h, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((n, din), (n, hid), (n, hid)))
    cell = JGRUCell(hid)
    params = cell.init(jax.random.PRNGKey(2), jnp.asarray(x),
                       jnp.asarray(h))["params"]

    def jloss(p, xv, hv):
        return jnp.sum(cell.apply({"params": p}, xv, hv) * cot)

    jout = cell.apply({"params": params}, jnp.asarray(x), jnp.asarray(h))
    gp, gx, gh = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x),
                                                    jnp.asarray(h))
    tcell = GRUCell(din, hid)
    tcell.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           params_from_jax({"gru": _tree(params)}).items()})
    xt, ht = torch.tensor(x, requires_grad=True), torch.tensor(h, requires_grad=True)
    out = tcell(xt, ht)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), jout, 1e-5, "output")
    _close(xt.grad.numpy(), gx, 1e-5, "d_x")
    _close(ht.grad.numpy(), gh, 1e-5, "d_h")
    got = {f"gru.{k}": p.grad.numpy() for k, p in tcell.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in
                       params_from_jax({"gru": _tree(gp)}).items()}, 1e-5)


class _JEdgeConv(fnn.Module):
    """One JAX edge network and NNConv, scoped as in the JAX MPNN."""

    dim: int
    hidden: int

    @fnn.compact
    def __call__(self, x, batch, edge_attr):
        edge_net = _EdgeNetFactored(self.hidden, self.dim * self.dim,
                                    name="edge_nn0")
        return JNNConv(self.dim, edge_net, name="conv0")(x, batch, edge_attr)


class _EdgeConv(torch.nn.Module):
    def __init__(self, dim, hidden, edge_dim):
        super().__init__()
        self.edge_nn0 = EdgeNetFactored(edge_dim, hidden, dim * dim)
        self.conv0 = NNConv(dim, dim)

    def forward(self, x, batch, edge_attr):
        return self.conv0(x, batch, *self.edge_nn0(edge_attr))


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_nnconv_matches_jax(toy_dataset, kernel):
    """One edge network + NNConv: output, d/dx and d/dparams."""
    jb, tb = _batches(toy_dataset, kernel)
    rng = np.random.default_rng(5)
    dim, hidden = 6, 9
    x = rng.standard_normal((jb.num_nodes, dim)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    conv = _JEdgeConv(dim, hidden)
    ea = j_gaussian_basis(jb.edge_dist_norm, 0.0, 1.0, 50, 0.2)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb, ea)["params"]
    params = jax.tree.map(lambda p: p + 0.05 * jnp.ones_like(p), params)
    assert set(params) == {"edge_nn0", "conv0"}

    def jloss(p, xv):
        return jnp.sum(conv.apply({"params": p}, xv, jb, ea) * cot)

    jout = conv.apply({"params": params}, jnp.asarray(x), jb, ea)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    tconv = _EdgeConv(dim, hidden, 50)
    tconv.load_state_dict(params_from_jax(_tree(params)))
    xt = torch.tensor(x, requires_grad=True)
    out = tconv(xt, tb, gaussian_basis(tb.edge_dist_norm, 0.0, 1.0, 50, 0.2))
    (out * torch.as_tensor(cot)).sum().backward()
    nm = np.asarray(jb.node_mask) > 0
    _close(out.detach().numpy()[nm], np.asarray(jout)[nm], 1e-5, "output")
    _close(xt.grad.numpy(), gx, 1e-5, "d_x")
    got = {k: p.grad.numpy() for k, p in tconv.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in
                       params_from_jax(_tree(gp)).items()}, 1e-5)


# ---------------------------------------------------------------- the model


def _randomize(variables, seed):
    """Random BatchNorm scale/bias and running statistics (numpy trees)."""
    rng = np.random.default_rng(seed)
    params, stats = _tree(variables["params"]), _tree(variables["batch_stats"])
    for name, bn in stats.items():
        d = bn["mean"].shape[0]
        bn["mean"] = rng.normal(0.0, 0.5, d).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        params[name]["bias"] = rng.normal(0.0, 0.2, d).astype(np.float32)
    return params, stats


def _jax_mpnn(ds, width, seed=0):
    model = j_build_model("MPNN", ds, WIDTHS[width])
    jb, _ = _batches(ds, "xla")
    variables = model.init(jax.random.PRNGKey(seed), jb, training=False)
    return model, _randomize(variables, seed)


def _port_mpnn(ds, width, params, stats):
    model = build_model("MPNN", ds, WIDTHS[width], device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model


def test_converter_carries_an_mpnn_tree_both_ways(toy_dataset):
    _, (params, stats) = _jax_mpnn(toy_dataset, "small")
    assert set(params["gru0"]) == {"w_ih", "w_hh", "b_ih", "b_hh"}
    assert set(params["conv0"]) == {"root", "bias"}
    assert set(params["edge_nn0"]) == {"lin0", "lin1"}
    sd = params_from_jax(params, stats)
    assert sd["gru0.weight_ih"].shape == (36, 12)
    assert sd["conv0.root"].shape == (12, 12)
    assert sd["edge_nn0.lin1.weight"].shape == (144, 16)
    model = _port_mpnn(toy_dataset, "small", params, stats)
    np.testing.assert_array_equal(model.gru1.weight_hh.detach().numpy(),
                                  params["gru1"]["w_hh"].T)
    p2, s2 = params_to_jax(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for (ka, a), (kb, b) in zip(flat(params), flat(p2)):
        assert ka == kb
        np.testing.assert_array_equal(b, a)
    for (_, a), (_, b) in zip(flat(stats), flat(s2)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
@pytest.mark.parametrize("width", ["small", "demo"])
def test_mpnn_eval_matches_jax(toy_dataset, width, kernel):
    ds = toy_dataset
    model, (params, stats) = _jax_mpnn(ds, width)
    jb, tb = _batches(ds, kernel)
    ref = model.apply({"params": params, "batch_stats": stats}, jb,
                      training=False)
    tmodel = _port_mpnn(ds, width, params, stats).eval()
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
    model = _port_mpnn(ds, "small", params, stats).train()
    out = model(tbatch)
    (out * torch.as_tensor(cot)).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy()
                                  for k, p in model.named_parameters()}


def _cotangent(jb, seed):
    gmask = np.asarray(jb.graph_mask)
    return np.random.default_rng(seed).standard_normal(gmask.shape).astype(
        np.float32) * gmask


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_mpnn_training_mode_matches_jax(toy_dataset, kernel):
    """Training-mode outputs (BatchNorm batch statistics) and parameter
    gradients against the JAX MPNN."""
    ds = toy_dataset
    model, (params, stats) = _jax_mpnn(ds, "small")
    jb, tb = _batches(ds, kernel)
    cot = _cotangent(jb, 4)
    jout, jgrads = _jax_training_grads(model, params, stats, jb, cot)
    out, grads = _port_training_grads(ds, params, stats, tb, cot)
    g = np.asarray(jb.graph_mask) > 0
    _close(out[g], jout[g], 2e-4, "outputs")
    _close_grads(grads, jgrads, 2e-4)


def test_conv_bias_gradient_cancels_behind_batchnorm(toy_dataset):
    """NNConv's bias adds a constant to every real node's message just
    before a training-mode BatchNorm, which subtracts the batch mean: its
    gradient is zero but for rounding, in JAX and in the port (why the
    trainer parity below runs without BatchNorm)."""
    ds = toy_dataset
    model, (params, stats) = _jax_mpnn(ds, "small")
    jb, tb = _batches(ds, "fused")
    cot = _cotangent(jb, 8)
    for _, grads in (_jax_training_grads(model, params, stats, jb, cot),
                     _port_training_grads(ds, params, stats, tb, cot)):
        for i in range(2):
            scale = float(np.abs(grads[f"conv{i}.root"]).max())
            assert scale > 1e-3
            assert float(np.abs(grads[f"conv{i}.bias"]).max()) < 1e-5 * scale


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def jax_training(toy_dataset):
    """JAX setup_run + run_fused_training, three epochs, kernel xla."""
    ds = toy_dataset
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    run = JJ.setup_run(ds, {**MODEL, "kernel": "xla"}, "l1_loss", seed=9)
    init = params_from_jax(_tree(run.state.params), _tree(run.state.batch_stats))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(run, train_idx=idx[0], val_idx=idx[1], epochs=3,
                              verbosity=1, seed=9)
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    return idx, init, epochs


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_mpnn_trainer_matches_jax_three_epochs(toy_dataset, jax_training,
                                               kernel):
    (train_idx, val_idx, _), init, jepochs = jax_training
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": kernel}, "l1_loss",
                       seed=9, device="cpu")
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


def test_resolve_kernel_for_mpnn():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    want = {("auto", cpu): ("xla", None, False),
            ("auto", cuda): ("fused", "dst", True),
            ("fused", cpu): ("fused", "dst", True),
            ("csr", cuda): ("csr", "dst", False),
            ("xla", cuda): ("xla", None, False)}
    for (kernel, dev), plan in want.items():
        got = TJ.resolve_kernel("MPNN", kernel, "padded", dev)
        assert (got.name, got.edge_order, got.fused) == plan, (kernel, dev)
    with pytest.raises(NotImplementedError, match="queue 2, item 6"):
        TJ.resolve_kernel("MPNN", "pallas", "padded", cpu)
    with pytest.raises(NotImplementedError, match="item 3"):
        TJ.resolve_kernel("MPNN", "fused", "packed", cuda)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return (rows[0], [r[0] for r in rows[1:]],
            np.array([float(r[2]) for r in rows[1:]]))


def test_mpnn_cli_trains_and_predicts(toy_data_dir, tmp_path):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg["Models"]["MPNN_demo"].update(
        {"dim1": 12, "dim2": 10, "dim3": 16, "batch_size": 4, "epochs": 2})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    common = [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
              str(path), "--device=cpu"]
    proc = subprocess.run(
        common + ["--run_mode=Training", "--model=MPNN_demo", "--seed=3",
                  "--verbosity=1", "--kernel=fused"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "resolved: model=MPNN kernel=fused" in proc.stdout
    for name in ("edge_nn3.lin0.weight", "edge_nn0.lin1.bias", "conv2.root",
                 "conv0.bias", "gru1.weight_ih", "gru3.bias_hh"):
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


def test_predict_matches_jax_on_a_jax_trained_mpnn(toy_dataset, tmp_path,
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
    assert meta["model_name"] == "MPNN"
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


def test_chip_smoke_mpnn_demo_matches_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.MPNN_DEMO == cfg["Models"]["MPNN_demo"]
    tcfg = chip_smoke.training_config("d", "m.ckpt", "j", "cpu", 2,
                                      model=chip_smoke.MPNN_DEMO)
    assert tcfg["Models"]["model"] == "MPNN"
    assert tcfg["Models"]["dim3"] == 100 and tcfg["Models"]["batch_size"] == 100
