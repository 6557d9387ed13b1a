"""`kernel_precision: bf16` end to end on the CPU: small models on the
single-pass arms against the JAX models on theirs.

The JAX side runs its Pallas kernels in interpret mode with hilo=False
under single_pass_oracle's emulation of the TPU MXU's single pass (the
data operand of every one-hot product rounded to bf16); the port runs its
plain twins with single_pass=True. Parameters come from the JAX model
through convert.py.

* A small CGCNN (2 convs, dim 16, no BatchNorm, dropout 0) under fused, a
  GCN under pallas and a SchNet under fused: per-graph outputs and every
  parameter gradient in training mode. Limits: the median gap at most
  1e-5 and the largest at most 2⁻⁷ of the tensor's max|ref|. Both sides
  round the same values at the same points, but the f32 arithmetic
  upstream of a rounding point (XLA's GEMMs and activations against
  torch's) can move a value by an ulp, and where that value lies within an
  ulp of a bf16 midpoint the two sides round it to neighbouring bf16
  values, 2⁻⁸ of it apart; such a tipped rounding passes through the
  layers above it. So the median holds the sides to f32 order, and the
  largest gap allows a few tipped roundings but not the arm's absence.
* Three epochs of the port's trainer on CGCNN under fused with
  kernel_precision bf16 against the JAX trainer under the same plan: the
  per-epoch train errors within 1e-3 relative.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.data import windowed as JW
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import windowed as TW
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.training import jobs as TJ
from single_pass_oracle import emulate_single_pass

IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
TW_, TE_ = 8, 32
MEDIAN, LARGEST = 1e-5, 2.0 ** -7
HP = {"CGCNN": {"dim1": 16, "dim2": 12, "gc_count": 2, "post_fc_count": 1,
                "batch_norm": "False", "dropout_rate": 0.0},
      "GCN": {"dim1": 16, "dim2": 12, "gc_count": 2, "post_fc_count": 1,
              "batch_norm": "False", "dropout_rate": 0.0},
      "SchNet": {"dim1": 16, "dim2": 12, "dim3": 16, "cutoff": 5,
                 "gc_count": 2, "post_fc_count": 1, "batch_norm": "False",
                 "dropout_rate": 0.0}}
KERNEL = {"CGCNN": "fused", "GCN": "pallas", "SchNet": "fused"}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


@pytest.fixture(scope="module")
def single_pass():
    """The emulation for the whole module: one jax.clear_caches() on entry
    and one on exit, so that the module's tests share their compiled
    operations."""
    with emulate_single_pass(pytest.MonkeyPatch()):
        yield


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _gaps(got, ref) -> tuple[float, float]:
    """(median, largest) of |got - ref| over max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    d = np.abs(got - ref) / max(float(np.abs(ref).max()), 1e-30)
    return float(np.median(d)), float(d.max())


def _check(name, got, ref):
    med, big = _gaps(got, ref)
    assert med <= MEDIAN and big <= LARGEST, (
        f"{name}: median gap {med:.3g}, largest {big:.3g} of max|ref| "
        f"(limits {MEDIAN}, {LARGEST:.3g})")


def _batches(ds, name):
    """The JAX batch of the plan (windowed, marked kernel_bf16; fused for
    CGCNN and SchNet) and the port's (windowed under pallas, flat
    dst-sorted under fused), both marked for the single-pass arm."""
    fused = KERNEL[name] == "fused"
    layout = JW.build_windowed_layout(ds, TW_, TE_)
    jspec = JB.BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                     len(IDS), align=TW_, align_edges=TE_)
    jdata = JB.DeviceDataset.from_graph_dataset(ds).replace(
        windowed=JB.WindowedDeviceData.from_layout(layout))
    jb = JB.assemble_batch_windowed(jdata, jdata.windowed, jnp.asarray(IDS),
                                    jspec, TW_, TE_, bf16=True, fused=fused)
    if fused:
        spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                        len(IDS))
        tdata = TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", edge_order="dst", kernel_fused=True, kernel_bf16=True)
    else:
        tl = TW.build_windowed_layout(ds, TW_, TE_)
        spec = TB.BatchSpec.for_dataset(tl.node_counts_w, tl.wedge_counts,
                                        len(IDS), align=TW_, align_edges=TE_)
        tdata = TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", windowed=TB.WindowedDeviceData.from_layout(tl, "cpu"),
            kernel_bf16=True)
    tb = TB.assemble(tdata, IDS, spec)
    assert tb.kernel_bf16 and jb.kernel_bf16
    return jb, tb


@pytest.mark.parametrize("name", ["CGCNN", "GCN", "SchNet"])
def test_model_on_the_single_pass_arm_matches_jax(toy_dataset, single_pass,
                                                  name):
    ds = toy_dataset
    jb, tb = _batches(ds, name)
    jmodel = j_build_model(name, ds, HP[name])
    variables = jax.jit(lambda k, b: jmodel.init(k, b, training=False))(
        jax.random.PRNGKey(1), jb)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    gmask = np.asarray(jb.graph_mask)
    cot = np.random.default_rng(4).standard_normal(gmask.shape).astype(
        np.float32)

    def jloss(p, b):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, b,
                              training=True, mutable=["batch_stats"])
        return jnp.sum(out * gmask * cot), out

    # the batch an argument, not a constant the compiler would fold
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jb)

    model = build_model(name, ds, HP[name], device="cpu")
    model.load_state_dict(params_from_jax(_tree(params), _tree(stats)))
    model.train()
    out = model(tb)
    (out * torch.as_tensor(gmask * cot)).sum().backward()
    g = gmask > 0
    _check(f"{name} outputs", out.detach().numpy()[g], np.asarray(jout)[g])
    tgrads = {k: p.grad for k, p in model.named_parameters()}
    for k, ref in params_from_jax(_tree(jgrads)).items():
        _check(f"{name} d {k}", tgrads[k].numpy(), ref.numpy())


def test_cgcnn_trainer_on_the_single_pass_arm_matches_jax(toy_dataset,
                                                          single_pass):
    """setup_run + run_fused_training, three epochs, CGCNN under fused
    with kernel_precision bf16, in both packages from the same
    parameters."""
    ds = toy_dataset
    mp = {"model": "CGCNN", **HP["CGCNN"], "kernel": "fused",
          "kernel_precision": "bf16", "kernel_tw": TW_, "kernel_te": TE_,
          "batch_size": 4, "epochs": 3, "lr": 0.01, "optimizer": "AdamW",
          "optimizer_args": {}, "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                             "min_lr": 1e-5, "threshold": 2e-4},
          "print_model": False}
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    jrun = JJ.setup_run(ds, mp, "l1_loss", seed=9)
    init = params_from_jax(_tree(jrun.state.params),
                           _tree(jrun.state.batch_stats or {}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(jrun, train_idx=idx[0], val_idx=idx[1],
                              epochs=3, verbosity=1, seed=9)
    jepochs = [float(m.group(3)) for m in EPOCH_LINE.finditer(buf.getvalue())]

    run = TJ.setup_run(ds, mp, "l1_loss", seed=9, device="cpu")
    assert run.data.kernel_bf16 and run.kernel == "fused"
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(run, train_idx=idx[0],
                                          val_idx=idx[1], epochs=3,
                                          verbosity=1, seed=9)
    assert len(jepochs) == len(history) == 3
    for e, (jtr, (tr, _, _)) in enumerate(zip(jepochs, history)):
        assert np.isfinite(tr)
        np.testing.assert_allclose(tr, jtr, rtol=1e-3,
                                   err_msg=f"epoch {e + 1} train error")
