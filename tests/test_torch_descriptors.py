"""The port's descriptor slice against the JAX package on the CPU.

* data/descriptors.py: the Coulomb and sine matrices, the eigenspectrum,
  sm_features and soap_features against the JAX package's, in float64 to
  rtol 1e-12 (the same numpy arithmetic), and SOAP against the
  brute-force integration oracle of tests/test_soap_oracle.py (rtol 2e-3,
  that test's tolerance);
* process_data with SM_descriptor / SOAP_descriptor: the same float32
  descriptors as the JAX package's, kept by the .npz cache;
* batch.extra on padded, packed and windowed batches: the JAX package's
  rows on real graph slots, zero rows on pad slots;
* SM and SOAP (fc_count 0 and 2): forward and parameter gradients from
  converted JAX parameters to rtol 1e-5, and 3-epoch SM and SOAP trainer
  trajectory against JAX setup_run + run_fused_training to rtol 2e-3 (the
  trainer parity tolerance of tests/test_torch_training.py);
* the SM/SOAP kernel plan (xla, with the JAX note) and the analytic FLOP
  count (the JAX formula with in_dim the descriptor width).
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
from matdeeplearn_tpu.data import descriptors as JDS
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.utils import profiling as JP
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.data import descriptors as TDS
from matdeeplearn_torch.data.structures import Structure
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.utils import profiling as TP

from conftest import TOY_PROCESSING_ARGS, _make_structures
from test_soap_oracle import _oracle_power_spectrum

EXACT = dict(rtol=1e-12, atol=0)
SOAP_ARGS = dict(rcut=4.0, nmax=3, lmax=2, sigma=0.5)
MODEL = {"dim1": 16, "batch_size": 4, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "print_model": False}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _port(structs):
    return [Structure(s.numbers, s.positions, s.cell, s.pbc, s.structure_id)
            for s in structs]


@pytest.fixture(scope="module")
def mixed_structures():
    """Periodic and non-periodic structures from the conftest generator."""
    return (_make_structures(np.random.default_rng(3), n=4)
            + _make_structures(np.random.default_rng(4), n=4, periodic=False))


def test_matrix_helpers_match_jax(mixed_structures):
    for s, p in zip(mixed_structures, _port(mixed_structures)):
        cm = TDS.coulomb_matrix(p, 10)
        np.testing.assert_allclose(cm, JDS.coulomb_matrix(s, 10), **EXACT)
        np.testing.assert_allclose(TDS.eigenspectrum(cm),
                                   JDS.eigenspectrum(cm), **EXACT)
        if s.pbc.any():
            np.testing.assert_allclose(TDS.sine_matrix(p, 10),
                                       JDS.sine_matrix(s, 10), **EXACT)


def test_sm_features_match_jax(mixed_structures):
    got = TDS.sm_features(_port(mixed_structures), 9)
    np.testing.assert_allclose(got, JDS.sm_features(mixed_structures, 9),
                               **EXACT)
    assert got.shape == (8, 9) and np.abs(got).max() > 0


def test_soap_features_match_jax(mixed_structures):
    species = sorted({int(z) for s in mixed_structures for z in s.numbers})
    got = TDS.soap_features(_port(mixed_structures), species, **SOAP_ARGS,
                            n_workers=1)
    want = JDS.soap_features(mixed_structures, species, **SOAP_ARGS,
                             n_workers=1)
    np.testing.assert_allclose(got, want, **EXACT)
    n_sp = len(species)
    assert got.shape == (8, n_sp * (n_sp + 1) // 2 * 3 * 3)


def test_soap_matches_the_oracle():
    """The case of tests/test_soap_oracle.py on the port's soap_features."""
    rng = np.random.default_rng(3)
    pos = np.array([[0.0, 0.0, 0.0], [1.1, 0.4, -0.3], [-0.7, 1.2, 0.5],
                    [0.3, -0.9, 1.0]]) + rng.normal(scale=0.05, size=(4, 3))
    s = Structure(np.array([8, 1, 1, 8]), pos, np.zeros((3, 3)),
                  np.zeros(3, bool), "oracle")
    got = TDS.soap_features([s], [1, 8], 4.0, 3, 3, 0.5)[0]
    want = _oracle_power_spectrum(s, [1, 8], 4.0, 3, 3, 0.5)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3)


@pytest.fixture(scope="module", params=["SM", "SOAP"])
def descriptor_datasets(request, toy_data_dir):
    """(kind, JAX dataset, port dataset) processed from the toy files with
    the descriptor on, each package into its own processed directory."""
    kind = request.param
    args = {**TOY_PROCESSING_ARGS, f"{kind}_descriptor": "True",
            "SOAP_rcut": 4.0, "SOAP_nmax": 3, "SOAP_lmax": 2,
            "SOAP_sigma": 0.5}
    jds = JD.get_dataset(toy_data_dir, 0, "True",
                         {**args, "processed_path": f"jax_{kind}"})
    tds = TD.get_dataset(toy_data_dir, 0, "True",
                         {**args, "processed_path": f"port_{kind}"})
    return kind, jds, tds


def test_process_data_descriptors_match_jax(descriptor_datasets, toy_data_dir):
    kind, jds, tds = descriptor_datasets
    assert list(tds.extra_features) == [kind]
    got = tds.extra_features[kind]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jds.extra_features[kind])
    cached = TD.get_dataset(toy_data_dir, 0, "False",
                            {**TOY_PROCESSING_ARGS,
                             "processed_path": f"port_{kind}"})
    np.testing.assert_array_equal(cached.extra_features[kind], got)


IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)


@pytest.mark.parametrize("layout", ["padded", "packed", "windowed"])
def test_batches_carry_the_descriptors(descriptor_datasets, layout):
    kind, jds, tds = descriptor_datasets
    nc, ec = tds.node_counts(), tds.edge_counts()
    windowed = None
    if layout == "windowed":
        lay = tds.windowed_layout()
        windowed = TB.WindowedDeviceData.from_layout(lay, "cpu")
        nc, ec = np.asarray(lay.node_counts_w), np.asarray(lay.wedge_counts)
        spec = TB.BatchSpec.for_dataset(nc, ec, len(IDS), align=lay.tw,
                                        align_edges=lay.te)
    elif layout == "packed":
        spec = TB.BatchSpec.packed_for_dataset(nc, ec, 4)
    else:
        spec = TB.BatchSpec.for_dataset(nc, ec, len(IDS))
    ids = np.full(spec.num_graphs, -1, np.int32)
    ids[:6] = IDS[:6]
    data = TB.DeviceDataset.from_graph_dataset(tds, "cpu", windowed=windowed)
    batch = TB.assemble(data, ids, spec)
    jdata = JB.DeviceDataset.from_graph_dataset(jds)
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    jb = JB.assemble_batch(jdata, jnp.asarray(ids), jspec)
    real = ids >= 0
    np.testing.assert_array_equal(batch.extra.numpy()[real],
                                  np.asarray(jb.extra)[real])
    assert not batch.extra[~torch.as_tensor(real)].any()


def _jax_descriptor_model(kind, jds, fc_count, seed=0):
    model = j_build_model(kind, jds, {"dim1": 16, "fc_count": fc_count})
    spec = JB.BatchSpec.for_dataset(jds.node_counts(), jds.edge_counts(),
                                    len(IDS))
    jb = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(jds),
                           jnp.asarray(IDS), spec)
    params = model.init(jax.random.PRNGKey(seed), jb)["params"]
    return model, jax.tree.map(np.asarray, params), jb


@pytest.mark.parametrize("fc_count", [0, 2])
def test_descriptor_models_match_jax(descriptor_datasets, fc_count):
    """Forward and every parameter gradient of a loss over the real rows."""
    kind, jds, tds = descriptor_datasets
    jmodel, params, jb = _jax_descriptor_model(kind, jds, fc_count)
    real = IDS >= 0
    cot = np.random.default_rng(1).standard_normal(len(IDS)).astype(np.float32)
    cot[~real] = 0

    def jloss(p):
        return jnp.sum(jmodel.apply({"params": p}, jb) * cot)

    jout = jmodel.apply({"params": params}, jb)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))

    model = build_model(kind, tds, {"dim1": 16, "fc_count": fc_count},
                        device="cpu")
    model.load_state_dict(params_from_jax(params))
    spec = TB.BatchSpec.for_dataset(tds.node_counts(), tds.edge_counts(),
                                    len(IDS))
    batch = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(tds, "cpu"),
                              IDS, spec)
    out = model(batch)
    (out * torch.as_tensor(cot)).sum().backward()
    assert out.shape == (len(IDS),)
    np.testing.assert_allclose(out.detach().numpy()[real],
                               np.asarray(jout)[real], rtol=1e-5, atol=1e-5)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def test_descriptor_model_needs_descriptors(toy_dataset):
    with pytest.raises(ValueError, match="need extra features"):
        build_model("SM", toy_dataset, {"dim1": 8}, device="cpu")


def test_descriptor_trainer_matches_jax_three_epochs(descriptor_datasets):
    kind, jds, tds = descriptor_datasets
    mp = {**MODEL, "model": kind, "fc_count": 2}
    idx = JD.split_data(jds, 0.7, 0.15, 0.15, seed=9)
    jrun = JJ.setup_run(jds, {**mp, "kernel": "xla"}, "l1_loss", seed=9)
    init = params_from_jax(jax.tree.map(np.asarray, jrun.state.params))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JJ.run_fused_training(jrun, train_idx=idx[0], val_idx=idx[1],
                              epochs=3, verbosity=1, seed=9)
    jepochs = [tuple(float(v) for v in m.groups()[1:])
               for m in EPOCH_LINE.finditer(buf.getvalue())]
    run = TJ.setup_run(tds, mp, "l1_loss", seed=9, device="cpu")
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(run, train_idx=idx[0],
                                          val_idx=idx[1], epochs=3,
                                          verbosity=1, seed=9)
    assert len(jepochs) == len(history) == 3
    for (lr, tr, va), (ptr, pva, plr) in zip(jepochs, history):
        np.testing.assert_allclose([ptr, pva], [tr, va], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(plr, lr, rtol=1e-6)


@pytest.mark.parametrize("kernel", ["auto", "xla", "csr", "fused", "pallas"])
def test_descriptor_models_resolve_to_xla(kernel, capsys):
    for dev in (torch.device("cpu"), torch.device("cuda")):
        plan = TJ.resolve_kernel("SOAP", kernel, "padded", dev)
        assert (plan.name, plan.edge_order, plan.fused, plan.windowed) == (
            "xla", None, False, False)
    out = capsys.readouterr().out
    assert ("descriptor models have no edge aggregation" in out) == (
        kernel in ("csr", "fused", "pallas"))


def test_analytic_flops_use_the_descriptor_width(descriptor_datasets):
    kind, jds, tds = descriptor_datasets
    run = TJ.setup_run(tds, {**MODEL, "model": kind, "fc_count": 2},
                       "l1_loss", seed=1, device="cpu")
    width = tds.extra_features[kind].shape[1]
    assert run.model_config["in_dim"] == width
    spec = run.spec
    got = TP.analytic_step_flops(kind, run.model_config, spec.num_nodes,
                                 spec.num_edges, spec.num_graphs)
    want = JP.analytic_step_flops(kind, {"dim1": 16, "fc_count": 2,
                                         "in_dim": width},
                                  spec.num_nodes, spec.num_edges,
                                  spec.num_graphs)
    assert got == want == 2 * spec.num_graphs * (width * 16 + 2 * 16 * 16
                                                 + 16)
