"""`precision: bf16` in the port against the JAX package on the CPU.

The contract (the JAX package's models/base.py:34-48, tests/test_bf16.py):
f32 master parameters and optimizer state, bf16 activations, products with
f32 accumulation rounded to bf16 once, BatchNorm and the segment sums and
means in f32, the edge basis computed in f32 and then cast, f32
predictions, loss and gradients.

* (a) Rounding points, exactly: Linear, MaskedBatchNorm, GRUCell and
  LSTMCell under bf16 equal the JAX layers bit for bit on dyadic inputs
  (multiples of 1/8 times multiples of 1/16, sums exact in f32), so that
  a missing or an extra rounding shows as a nonzero difference; Linear's
  two roundings (product, then bias) are told apart from F.linear's one.
  The activations that the JAX package lowers to chains of bf16 operations
  (sigmoid, softplus, silu, shifted softplus) equal them bit for bit on
  100,000 values, where torch's fused bf16 kernels part from them in about
  a third of the values.
* (b) The seven models under bf16, eval mode (random BatchNorm statistics)
  and training mode, against the JAX model under `precision: bf16` with
  the same converted parameters, each plan against the JAX path that has
  its rounding points: xla and csr against JAX on the same batch order;
  fused CGCNN and SchNet against JAX's fused kernels on its windowed
  batch; MPNN's csr and fused (the bilinear kernels' bf16 arm) against the
  JAX NNConv on its chunked bf16 kernel, the schedule the JAX package
  compiles on its TPU. Tolerance 0: the forward is the same operations at
  the same rounding points, and it agrees bit for bit on these inputs (a
  1-unit bf16 difference anywhere would show as ~1e-3 of the output).
  Dtype contracts: f32 parameters, bf16 embedding (the activations), f32
  outputs, f32 and finite gradients for every parameter.
* (d) Three epochs of the port's trainer under bf16 (MPNN and CGCNN, each
  under xla, csr and fused) against the JAX trainer (kernel xla) under
  bf16 from the same converted parameters, without BatchNorm: per-epoch
  train and val errors to atol 4e-3 (errors 0.19-0.63). The forward is
  exact, but the gradients are not: torch's autograd and JAX's VJPs take
  their bf16 backward through other chains of roundings (a bias gradient
  summed in f32 here, in the JAX package's own order there; the
  derivative of 1/(1 + exp(-x)) as -g·out·out here, -g·u⁻² there), a few
  per cent of a layer's gradient apart, and AdamW carries that into the
  errors: up to 1.5e-3 apart on these runs, where the bf16 and the f32
  trajectories of the same runs part by up to 6.7e-3. The f32 runs of the
  same procedure agree to 1e-5.
* (e) kernel_precision bf16 with precision bf16 under pallas and under
  fused for CGCNN and SchNet: the run's batches carry the single-pass mark
  and train (the arm's numerics: tests/test_torch_single_pass.py and
  tests/test_torch_kernel_precision.py); precision values other than f32
  and bf16 stay refused.
* (f) A JAX checkpoint trained under bf16, Predict through the port:
  the same ids and predictions to 1e-6 (the same forward; its input and
  output are f32).
* The jobs: the `resolved:` line and the Throughput line name the
  precision; the CLI trains and predicts a bf16 config, and runs CV,
  Repeat, Ensemble and Analysis on one; a Hyperparameter sweep samples
  `precision` from a Choice; resolve_device turns off cuBLAS's
  reduced-precision bf16 reductions.
"""

import contextlib
import csv
import io
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.nn import layers as JL
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import load_checkpoint as j_load
from matdeeplearn_tpu.training.checkpoint import params_from_raw
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn import layers as L
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import save_checkpoint

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = jnp.bfloat16
IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 values are exact)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dyadic(rng, shape, denom):
    """Small dyadic values k/denom, |k| <= 8: products and sums of a few
    hundred of them are exact in f32, and most need more than bf16's 8
    bits once summed."""
    return (rng.integers(-8, 9, shape) / denom).astype(np.float32)


# ------------------------------------------------------ (a) the layers


def test_linear_rounds_the_product_then_the_bias():
    rng = np.random.default_rng(0)
    x, w, b = (_dyadic(rng, (64, 40), 8), _dyadic(rng, (40, 24), 16),
               _dyadic(rng, (24,), 64))
    jl = JL.Linear(24)
    ref = jl.apply({"params": {"kernel": w, "bias": b}},
                   jnp.asarray(x, BF16))
    lin = L.Linear(40, 24)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        lin.bias.copy_(torch.tensor(b))
    xt = torch.tensor(x).bfloat16()
    out = lin(xt)
    assert ref.dtype == BF16 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), _f32(ref))
    # the inputs reach the rounding: one rounding (F.linear) differs
    once = F.linear(xt.float(), lin.weight, lin.bias).bfloat16()
    assert (_f32(once) != _f32(ref)).any()
    # and f32 inputs keep F.linear
    x32 = torch.tensor(x)
    assert torch.equal(lin(x32), F.linear(x32, lin.weight, lin.bias))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_batchnorm_works_in_f32_and_casts_back(mode):
    rng = np.random.default_rng(1)
    x = _dyadic(rng, (40, 6), 8) * 3
    # 32 real rows: the batch mean and variance are exact in f32 too
    mask = rng.permutation(np.arange(40) < 32).astype(np.float32)
    scale, bias = _dyadic(rng, (6,), 16) + 1.0, _dyadic(rng, (6,), 32)
    mean, var = _dyadic(rng, (6,), 8), np.abs(_dyadic(rng, (6,), 8)) + 0.5
    jbn = JL.MaskedBatchNorm()
    train = mode == "train"
    ref, upd = jbn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, BF16), mask=jnp.asarray(mask),
        use_running_average=not train, mutable=["batch_stats"])
    bn = L.MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
        bn.running_mean.copy_(torch.tensor(mean))
        bn.running_var.copy_(torch.tensor(var))
    out = bn(torch.tensor(x).bfloat16(), mask=torch.tensor(mask),
             use_running_average=not train)
    assert out.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    np.testing.assert_array_equal(_f32(out), _f32(ref))
    np.testing.assert_array_equal(bn.running_mean.numpy(),
                                  np.asarray(upd["batch_stats"]["mean"]))
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  np.asarray(upd["batch_stats"]["var"]))


def _cell_params(rng, din, hid, gates):
    return {"w_ih": _dyadic(rng, (din, gates * hid), 16),
            "w_hh": _dyadic(rng, (hid, gates * hid), 16),
            "b_ih": _dyadic(rng, (gates * hid,), 64),
            "b_hh": _dyadic(rng, (gates * hid,), 64)}


def _load_cell(cell, p):
    with torch.no_grad():
        cell.weight_ih.copy_(torch.tensor(p["w_ih"].T))
        cell.weight_hh.copy_(torch.tensor(p["w_hh"].T))
        cell.bias_ih.copy_(torch.tensor(p["b_ih"]))
        cell.bias_hh.copy_(torch.tensor(p["b_hh"]))
    return cell


def test_gru_cell_under_bf16_matches_jax_exactly():
    rng = np.random.default_rng(2)
    n, din, hid = 50, 12, 10
    p = _cell_params(rng, din, hid, 3)
    x, h = _dyadic(rng, (n, din), 8), _dyadic(rng, (n, hid), 8)
    ref = JL.GRUCell(hid).apply({"params": p}, jnp.asarray(x, BF16),
                                jnp.asarray(h, BF16))
    cell = _load_cell(L.GRUCell(din, hid), p)
    out = cell(torch.tensor(x).bfloat16(), torch.tensor(h).bfloat16())
    assert ref.dtype == BF16 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), _f32(ref))


def test_lstm_cell_under_bf16_matches_jax_exactly():
    rng = np.random.default_rng(3)
    n, din, hid = 50, 16, 8
    p = _cell_params(rng, din, hid, 4)
    x, h, c = (_dyadic(rng, (n, din), 8), _dyadic(rng, (n, hid), 8),
               _dyadic(rng, (n, hid), 8))
    rh, rc = JL.LSTMCell(hid).apply({"params": p}, jnp.asarray(x, BF16),
                                    jnp.asarray(h, BF16), jnp.asarray(c, BF16))
    cell = _load_cell(L.LSTMCell(din, hid), p)
    oh, oc = cell(torch.tensor(x).bfloat16(), torch.tensor(h).bfloat16(),
                  torch.tensor(c).bfloat16())
    assert oh.dtype == oc.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(oh), _f32(rh))
    np.testing.assert_array_equal(_f32(oc), _f32(rc))


@pytest.mark.parametrize("name", ["sigmoid", "softplus", "silu",
                                  "shifted_softplus"])
def test_bf16_activations_follow_the_jax_chains(name):
    x = (3 * np.random.default_rng(4).standard_normal(100_000)).astype(
        np.float32)
    jfn = {"sigmoid": jax.nn.sigmoid, "softplus": jax.nn.softplus,
           "silu": jax.nn.silu, "shifted_softplus": JL.shifted_softplus}[name]
    ref = _f32(jfn(jnp.asarray(x, BF16)))
    np.testing.assert_array_equal(
        _f32(L.ACTIVATIONS[name](torch.tensor(x).bfloat16())), ref)
    fused = {"sigmoid": torch.sigmoid, "softplus": F.softplus,
             "silu": F.silu,
             "shifted_softplus": lambda t: F.softplus(t) - L.LN2}[name]
    assert (_f32(fused(torch.tensor(x).bfloat16())) != ref).mean() > 0.05
    x32 = torch.tensor(x)
    assert torch.equal(L.ACTIVATIONS[name](x32), fused(x32))


def test_bf16_segment_sum_accumulates_f32():
    """4096 bf16 addends of 1.0: a bf16 accumulator saturates at 256 (the
    JAX package's test_bf16_segment_sum_accumulates_f32)."""
    from matdeeplearn_torch.ops import segment

    v = torch.ones((4096, 4), dtype=torch.bfloat16)
    out = segment.segment_sum(v, torch.zeros(4096, dtype=torch.int64), 1)
    assert out.dtype == torch.bfloat16
    assert (out.float() == 4096.0).all()
    mean = segment.segment_mean(v * 3, torch.zeros(4096, dtype=torch.int64), 1)
    assert mean.dtype == torch.bfloat16 and (mean.float() == 3.0).all()


# --------------------------------------------------------- (b) the models

GNNS = ["CGCNN", "SchNet", "MPNN", "GCN", "MEGNet"]
WIDTH = {"dim1": 16, "dim2": 12, "dim3": 16, "gc_count": 2,
         "post_fc_count": 1}
# plan → the port's batch order and fused flag (MEGNet's csr: "src"); the
# JAX batch has the same order, or, for fused CGCNN and SchNet, the
# windowed layout of JAX's fused kernels
PLANS = {"xla": (None, False), "csr": ("dst", False), "fused": ("dst", True)}
CASES = ([(m, "xla") for m in GNNS] + [(m, "csr") for m in GNNS]
         + [(m, "fused") for m in ("CGCNN", "SchNet", "MPNN")])


@contextlib.contextmanager
def _jax_bilinear_chunked():
    """The JAX MPNN with its NNConv on the bilinear kernel's chunked
    schedule in interpret mode, `fused_bilinear_msg((te, True, mxu_bf16,
    True), ...)`: the schedule the JAX package compiles on its TPU and
    the one whose rounding points the port's bf16 arm keeps. (Off its TPU
    the JAX MPNN runs the einsum; on it, the kernel.)"""
    import matdeeplearn_tpu.models.mpnn as JMPNN
    import matdeeplearn_tpu.ops.pallas_bilinear as PB

    orig_jax, orig_msg = JMPNN.jax, PB.fused_bilinear_msg
    JMPNN.jax = types.SimpleNamespace(default_backend=lambda: "tpu")
    PB.fused_bilinear_msg = lambda cfg, *a: orig_msg(
        (cfg[0], True, cfg[2], True), *a)
    try:
        yield
    finally:
        JMPNN.jax, PB.fused_bilinear_msg = orig_jax, orig_msg


def _jax_windowed_batch(ds, ids):
    layout = ds.windowed_layout()
    spec = JB.BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                    len(ids), align=layout.tw,
                                    align_edges=layout.te)
    data = JB.DeviceDataset.from_graph_dataset(ds).replace(
        windowed=JB.WindowedDeviceData.from_layout(layout))
    return JB.assemble_batch_windowed(data, data.windowed, jnp.asarray(ids),
                                      spec, layout.tw, layout.te, fused=True)


def _batches(ds, model, plan):
    order, fused = PLANS[plan]
    if model == "MEGNet" and plan == "csr":
        order = "src"
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                    len(IDS))
    tb = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", edge_order=order, kernel_fused=fused), IDS, spec)
    if plan == "fused" and model in ("CGCNN", "SchNet"):
        return _jax_windowed_batch(ds, IDS), tb
    jb = JB.assemble_batch(
        JB.DeviceDataset.from_graph_dataset(ds, edge_order=order),
        jnp.asarray(IDS),
        JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges))
    return jb, tb


def _randomize(variables, seed):
    """Random BatchNorm scale/bias and running statistics."""
    rng = np.random.default_rng(seed)
    params, stats = _tree(variables["params"]), _tree(
        variables.get("batch_stats", {}))

    def walk(p, s):
        for name, sub in s.items():
            if "mean" in sub:
                d = sub["mean"].shape[0]
                sub["mean"] = rng.normal(0.0, 0.5, d).astype(np.float32)
                sub["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
                p[name]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
                p[name]["bias"] = rng.normal(0.0, 0.2, d).astype(np.float32)
            else:
                walk(p[name], sub)

    walk(params, stats)
    return params, stats


@pytest.mark.parametrize("model,plan", CASES)
def test_gnn_bf16_forward_matches_jax(toy_dataset, model, plan):
    ds = toy_dataset
    hp = {**WIDTH, "precision": "bf16"}
    jb, tb = _batches(ds, model, plan)
    jmodel = j_build_model(model, ds, hp)
    variables = jmodel.init(jax.random.PRNGKey(0), jb, training=False)
    params, stats = _randomize(variables, 3)
    tmodel = build_model(model, ds, hp, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, stats))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    gm = np.asarray(jb.graph_mask) > 0
    for training in (False, True):
        with (_jax_bilinear_chunked() if model == "MPNN" and plan != "xla"
              else contextlib.nullcontext()):
            ref, _ = jmodel.apply({"params": params, "batch_stats": stats},
                                  jb, training=training,
                                  mutable=["batch_stats"])
        tmodel.train(training)
        with torch.no_grad():
            out = tmodel(tb)
        assert ref.dtype == jnp.float32 and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy()[gm], np.asarray(ref)[gm],
                                      err_msg=f"training={training}")


@pytest.mark.parametrize("model", GNNS)
def test_gnn_bf16_dtype_contract(toy_dataset, model):
    """f32 masters; the embedding (an activation) in bf16; f32 outputs;
    every parameter's gradient f32 and finite, and not all zero."""
    ds = toy_dataset
    tmodel = build_model(model, ds, {**WIDTH, "precision": "bf16"},
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert tmodel.compute_dtype == torch.bfloat16
    _, tb = _batches(ds, model, "xla")
    tmodel.train()
    emb = tmodel(tb, embed=True)
    assert emb.dtype == torch.bfloat16
    out = tmodel(tb)
    assert out.dtype == torch.float32 and out.shape == (len(IDS),)
    (out * tb.graph_mask).abs().sum().backward()
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    for k, g in grads.items():
        assert g is not None and g.dtype == torch.float32, k
        assert torch.isfinite(g).all(), k
    assert sum(float(g.abs().sum()) for g in grads.values()) > 0


@pytest.fixture(scope="module", params=["SM", "SOAP"])
def descriptor_datasets(request, toy_data_dir):
    kind = request.param
    args = {**TOY_PROCESSING_ARGS, f"{kind}_descriptor": "True",
            "SOAP_rcut": 4.0, "SOAP_nmax": 3, "SOAP_lmax": 2,
            "SOAP_sigma": 0.5}
    jds = JD.get_dataset(toy_data_dir, 0, "True",
                         {**args, "processed_path": f"jax_bf16_{kind}"})
    tds = TD.get_dataset(toy_data_dir, 0, "True",
                         {**args, "processed_path": f"port_bf16_{kind}"})
    return kind, jds, tds


def test_descriptor_models_bf16_match_jax(descriptor_datasets):
    kind, jds, tds = descriptor_datasets
    hp = {"dim1": 16, "fc_count": 2, "precision": "bf16"}
    jmodel = j_build_model(kind, jds, hp)
    spec = JB.BatchSpec.for_dataset(jds.node_counts(), jds.edge_counts(),
                                    len(IDS))
    jb = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(jds),
                           jnp.asarray(IDS), spec)
    params = _tree(jmodel.init(jax.random.PRNGKey(0), jb)["params"])
    ref = jmodel.apply({"params": params}, jb)
    model = build_model(kind, tds, hp, device="cpu")
    model.load_state_dict(params_from_jax(params))
    batch = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(tds, "cpu"),
                              IDS, TB.BatchSpec(spec.num_graphs, spec.num_nodes,
                                                spec.num_edges))
    out = model(batch)
    real = IDS >= 0
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().numpy()[real],
                                  np.asarray(ref)[real])
    out[torch.as_tensor(real)].sum().backward()
    for k, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


# ------------------------------------------------------ (d) the trainer

TRAIN = {"dim1": 12, "dim2": 10, "dim3": 16, "gc_count": 2,
         "post_fc_count": 1, "batch_size": 4, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "False", "dropout_rate": 0.0, "print_model": False,
         "precision": "bf16"}


@pytest.fixture(scope="module", params=["MPNN", "CGCNN"])
def jax_bf16_training(request, toy_dataset):
    """JAX setup_run + run_fused_training under bf16, three epochs, kernel
    xla: (model, split, converted initial parameters, epochs)."""
    ds = toy_dataset
    model = request.param
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    run = JJ.setup_run(ds, {**TRAIN, "model": model, "kernel": "xla"},
                       "l1_loss", seed=9)
    init = params_from_jax(_tree(run.state.params),
                           _tree(run.state.batch_stats))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(run, train_idx=idx[0], val_idx=idx[1],
                              epochs=3, verbosity=1, seed=9)
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    return model, idx, init, epochs


@pytest.mark.parametrize("kernel", ["xla", "csr", "fused"])
def test_bf16_trainer_matches_jax_three_epochs(toy_dataset, jax_bf16_training,
                                               kernel):
    model, (train_idx, val_idx, _), init, jepochs = jax_bf16_training
    run = TJ.setup_run(toy_dataset, {**TRAIN, "model": model,
                                     "kernel": kernel}, "l1_loss", seed=9,
                       device="cpu")
    assert run.model.compute_dtype == torch.bfloat16
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
        seed=9)
    assert all(p.dtype == torch.float32 for p in run.model.parameters())
    for state in run.optimizer.state.values():
        for t in state.values():
            assert not torch.is_tensor(t) or t.dtype == torch.float32
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        assert np.isfinite([ptr, pva]).all()
        np.testing.assert_allclose(ptr, tr, rtol=0, atol=4e-3,
                                   err_msg=f"epoch {e + 1} train")
        np.testing.assert_allclose(pva, va, rtol=0, atol=4e-3,
                                   err_msg=f"epoch {e + 1} val")
        np.testing.assert_allclose(plr, lr, rtol=1e-6,
                                   err_msg=f"epoch {e + 1} lr")


# ---------------------- (e) kernel_precision bf16 runs; what stays refused


@pytest.mark.parametrize("model,kernel", [("CGCNN", "pallas"),
                                          ("GCN", "pallas"),
                                          ("MPNN", "pallas"),
                                          ("CGCNN", "fused"),
                                          ("SchNet", "fused")])
def test_kernel_precision_bf16_stays_refused(toy_dataset, model, kernel):
    """Once refused, now run: kernel_precision bf16 with bf16 activations
    under pallas (every GNN) and fused (CGCNN, SchNet) marks the run's
    batches for the single-pass arm, and a training step's loss and
    gradients are finite."""
    hp = {**WIDTH, "model": model, "kernel": kernel, "precision": "bf16",
          "kernel_precision": "bf16", "batch_size": 4}
    run = TJ.setup_run(toy_dataset, hp, "l1_loss", seed=0, device="cpu")
    assert run.model.precision == "bf16"
    batch = TB.assemble(run.data, np.arange(4), run.spec)
    assert batch.kernel_bf16 and batch.is_windowed == (kernel == "pallas")
    loss = F.l1_loss(run.model(batch).float().reshape(batch.y.shape), batch.y)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in run.model.parameters()
               if p.grad is not None)


def test_precision_validation(toy_dataset):
    """The JAX package's test_precision_validation."""
    with pytest.raises(ValueError, match="precision"):
        build_model("CGCNN", toy_dataset, {**WIDTH, "precision": "fp8"})
    assert build_model("CGCNN", toy_dataset,
                       {**WIDTH, "precision": "BF16"}).precision == "bf16"


# ------------------------------------- (f) a JAX bf16 checkpoint, Predict


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return (rows[0], [r[0] for r in rows[1:]],
            np.array([float(r[2]) for r in rows[1:]]))


def test_predict_on_a_jax_bf16_checkpoint(toy_dataset, tmp_path, monkeypatch):
    """The JAX package trains CGCNN under bf16 and predicts; the port
    predicts from the same checkpoint (its own msgpack reader). Both run
    the bf16 forward, JAX on its XLA scatter (the segment mean rounds the
    sum to bf16, then the mean) and the port on Predict's CSR plan (it
    rounds once, after the mean), so predictions agree to the bf16
    tolerance 2e-2·max|prediction| rather than exactly; test (b) holds
    each plan to its JAX counterpart exactly."""
    monkeypatch.chdir(tmp_path)
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    JJ.train_regular(toy_dataset, {"job_name": "jt", "seed": 3,
                                   "model_path": "jax.ckpt",
                                   "write_output": "False"},
                     tp, {**TRAIN, "model": "CGCNN", "epochs": 2,
                          "kernel": "xla", "batch_norm": "True"})
    meta, _ = j_load("jax.ckpt")
    assert meta["model_config"]["precision"] == "bf16"
    jerr = JJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "jax.ckpt", "job_name": "jax"})
    terr = TJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "jax.ckpt", "job_name": "port"},
                      device="cpu")
    jh, jids, jp = _read_csv("jax_predicted_outputs.csv")
    th, tids, tpred = _read_csv("port_predicted_outputs.csv")
    assert th == jh and tids == jids == toy_dataset.structure_ids
    scale = float(np.abs(jp).max())
    np.testing.assert_allclose(tpred, jp, rtol=0, atol=2e-2 * scale)
    assert abs(terr - jerr) <= 2e-2 * scale


# ------------------------------------------------------------- the jobs


def test_resolve_device_keeps_bf16_reductions_in_f32():
    from matdeeplearn_torch.utils.device import resolve_device

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_throughput_line_names_the_precision():
    from matdeeplearn_torch.utils.profiling import ThroughputMeter

    lines = []
    for precision in ("f32", "bf16"):
        m = ThroughputMeter(edges_per_epoch=10.0, graphs_per_epoch=2.0,
                            precision=precision)
        for k in range(3):
            m.add_chunk(5, 40, 0.5, key=("s", k > 0))
        lines.append(m.report())
    assert "precision" not in lines[0]
    assert lines[1] == lines[0] + ", precision bf16"


def _bf16_config(toy_data_dir, tmp_path, model):
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg["Models"][model].update({"dim1": 12, "dim2": 10, "dim3": 16,
                                 "batch_size": 4, "epochs": 2,
                                 "precision": "bf16"})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_trains_and_predicts_a_bf16_config(toy_data_dir, tmp_path):
    path = _bf16_config(toy_data_dir, tmp_path, "MPNN_demo")
    env = {**os.environ, "PYTHONPATH": REPO}
    common = [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
              str(path), "--device=cpu"]
    proc = subprocess.run(
        common + ["--run_mode=Training", "--model=MPNN_demo", "--seed=3",
                  "--verbosity=1", "--kernel=fused"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"resolved: model=MPNN kernel=fused batching=padded "
                     r"precision=bf16 ", proc.stdout)
    assert len(EPOCH_LINE.findall(proc.stdout)) == 2
    proc = subprocess.run(common + ["--run_mode=Predict",
                                    "--model_path=my_model.ckpt"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    _, ids, preds = _read_csv(
        tmp_path / "my_predict_job_predicted_outputs.csv")
    assert len(ids) == 16 and np.isfinite(preds).all()


def test_hyperparameter_sweep_samples_the_precision(toy_dataset, tmp_path,
                                                    monkeypatch):
    """A space that names `precision` (a Choice) gives each trial its
    draw; the trials build models of that precision."""
    from matdeeplearn_torch.training import hyper as H

    monkeypatch.chdir(tmp_path)
    built = []
    real = TJ.build_model

    def spy(name, dataset, hp, **kw):
        model = real(name, dataset, hp, **kw)
        built.append(model.precision)
        return model

    monkeypatch.setattr(TJ, "build_model", spy)
    space = {"dim1": 8, "lr": 0.01, "batch_size": 4,
             "precision": H.Choice(("f32", "bf16"))}
    best = H.tune_setup(
        space, {"job_name": "sweep", "hyper_trials": 4, "seed": 1,
                "hyper_concurrency": 1, "device": "cpu"},
        TOY_PROCESSING_ARGS,
        {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
         "test_ratio": 0.15, "verbosity": 1},
        {**TRAIN, "model": "CGCNN", "epochs": 1}, dataset=toy_dataset)
    assert best["config"]["precision"] in ("f32", "bf16")
    assert set(built) == {"f32", "bf16"}


@pytest.mark.parametrize("mode,output", [
    ("CV", "my_CV_job_CV_outputs.csv"),
    ("Repeat", "my_repeat_job_all_errorvalues.csv"),
    ("Ensemble", "my_ensemble_job_test_ensemble_outputs.csv"),
    ("Analysis", "tsne_output.csv"),
])
def test_cli_runs_the_other_modes_under_bf16(toy_data_dir, tmp_path,
                                             monkeypatch, mode, output):
    """CV, Repeat, Ensemble and Analysis (from a bf16 Training's
    checkpoint) on a config whose models all say precision bf16."""
    from matdeeplearn_torch import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "TSNE_ARGS", {**cli.TSNE_ARGS, "n_iter": 250,
                                           "method": "exact"})
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    for m in cfg["Models"].values():
        m.update(epochs=1, batch_size=4, dim1=8, dim2=8, dim3=8, gc_count=1,
                 post_fc_count=1, print_model=False, precision="bf16")
    cfg["Job"]["CV"]["cv_folds"] = 2
    cfg["Job"]["Repeat"]["repeat_trials"] = 2
    cfg["Job"]["Ensemble"]["ensemble_list"] = "CGCNN_demo,MPNN_demo"
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    common = [f"--config_path={path}", "--device=cpu", "--seed=4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mode == "Analysis":
            cli.main(common + ["--run_mode=Training",
                               "--model_path=bf16.ckpt"])
            cli.main(common + ["--run_mode=Analysis",
                               "--model_path=bf16.ckpt"])
        else:
            cli.main(common + [f"--run_mode={mode}"])
    assert os.path.exists(output)
    assert "precision=bf16" in buf.getvalue()
