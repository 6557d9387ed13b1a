"""PyTorch port CGConv / CGCNN vs the JAX package on the CPU, with the JAX
parameters moved over by the port's converter.

Parameters are random (flax init, then random BatchNorm scale/bias) and so
are the BatchNorm running statistics. The JAX side runs both its XLA
order and its CSR order (Pallas kernels in interpret mode); the port runs
the same batch order (plain versions of its CSR kernels on dst-sorted
batches). Tolerance 2e-4, as tests/test_csr.py's model parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.nn.conv import CGConv as JCGConv
from matdeeplearn_tpu.ops.edge_basis import gaussian_basis as j_gaussian_basis
from matdeeplearn_torch.convert import params_from_jax, params_to_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn.conv import CGConv
from matdeeplearn_torch.ops.edge_basis import gaussian_basis

TOL = dict(rtol=2e-4, atol=2e-4)
WIDTHS = {
    "small": {"dim1": 12, "dim2": 10, "gc_count": 2, "post_fc_count": 1},
    # CGCNN_demo (config.yml)
    "demo": {"dim1": 100, "dim2": 150, "pre_fc_count": 1, "gc_count": 4,
             "post_fc_count": 3, "pool": "global_mean_pool",
             "pool_order": "early", "batch_norm": "True",
             "batch_track_stats": "True", "act": "relu", "dropout_rate": 0.0},
}
IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)


def _batches(ds, edge_order):
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(IDS))
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    jb = JB.assemble_batch(
        JB.DeviceDataset.from_graph_dataset(ds, edge_order=edge_order),
        jnp.asarray(IDS), jspec)
    tb = TB.assemble_batch(
        TB.DeviceDataset.from_graph_dataset(ds, "cpu", edge_order=edge_order),
        IDS, spec)
    return jb, tb


def _randomize(variables, seed):
    """Random BatchNorm scale/bias and running statistics (numpy trees)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    for name, bn in stats.items():
        d = bn["mean"].shape[0]
        bn["mean"] = rng.normal(0.0, 0.5, d).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        params[name]["bias"] = rng.normal(0.0, 0.2, d).astype(np.float32)
    return params, stats


def _jax_cgcnn(ds, width, seed=0):
    model = j_build_model("CGCNN", ds, WIDTHS[width])
    jb, _ = _batches(ds, None)
    variables = model.init(jax.random.PRNGKey(seed), jb, training=False)
    return model, _randomize(variables, seed)


def _port_cgcnn(ds, width, params, stats):
    model = build_model("CGCNN", ds, WIDTHS[width], device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model.eval()


def test_converter_round_trip(toy_dataset):
    _, (params, stats) = _jax_cgcnn(toy_dataset, "demo")
    sd = params_from_jax(params, stats)
    assert sd["conv0.lin_f.weight"].shape == (100, 250)  # [x_i, x_j, e] fan-in
    model = _port_cgcnn(toy_dataset, "demo", params, stats)
    p2, s2 = params_to_jax(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for (ka, a), (kb, b) in zip(flat(params), flat(p2)):
        assert ka == kb
        np.testing.assert_array_equal(b, a)
    for (_, a), (_, b) in zip(flat(stats), flat(s2)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("edge_order", [None, "dst"])
def test_cgconv_matches_jax(toy_dataset, edge_order):
    """One CGConv layer: forward, d/dx and d/dparams."""
    ds = toy_dataset
    jb, tb = _batches(ds, edge_order)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((jb.num_nodes, 16)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    conv = JCGConv(16)
    ea = j_gaussian_basis(jb.edge_dist_norm, 0.0, 1.0, 50, 0.2)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb, ea)["params"]

    def jloss(p, xv):
        return jnp.sum(conv.apply({"params": p}, xv, jb, ea) * cot)

    jout = conv.apply({"params": params}, jnp.asarray(x), jb, ea)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    tconv = CGConv(16, 50)
    tconv.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    xt = torch.tensor(x, requires_grad=True)
    out = tconv(xt, tb, gaussian_basis(tb.edge_dist_norm, 0.0, 1.0, 50, 0.2))
    (out * torch.as_tensor(cot)).sum().backward()
    nm = np.asarray(jb.node_mask) > 0
    np.testing.assert_allclose(out.detach().numpy()[nm], np.asarray(jout)[nm],
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    tgrads = {k: p.grad for k, p in tconv.named_parameters()}
    for k, g in params_from_jax(jax.tree.map(np.asarray, gp)).items():
        sc = max(float(np.abs(g.numpy()).max()), 1e-6)
        np.testing.assert_allclose(tgrads[k].numpy(), g.numpy(), rtol=2e-4,
                                   atol=2e-4 * sc, err_msg=k)


@pytest.mark.parametrize("edge_order", [None, "dst"])
@pytest.mark.parametrize("width", ["small", "demo"])
def test_cgcnn_matches_jax(toy_dataset, width, edge_order):
    ds = toy_dataset
    model, (params, stats) = _jax_cgcnn(ds, width)
    jb, tb = _batches(ds, edge_order)
    ref = model.apply({"params": params, "batch_stats": stats}, jb,
                      training=False)
    tmodel = _port_cgcnn(ds, width, params, stats)
    with torch.no_grad():
        out = tmodel(tb)
    gm = np.asarray(jb.graph_mask) > 0
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy()[gm], np.asarray(ref)[gm], **TOL)
    assert np.isfinite(out.numpy()).all()
