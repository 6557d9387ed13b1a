"""The port's fused CGConv (ops/fused_cgconv.py) against the JAX package on
the CPU.

* The op and its gradients against the JAX `ops.pallas_fused.fused_cgconv`
  run as the JAX package's own tests run it (interpret mode, hilo). The
  flat dst-sorted batch is windowed on the JAX side with `windowize_edges`,
  xj and dist permuted by its `order`, and d_xj mapped back through it.
  Tolerance rtol 1e-4, atol 1e-4·max|ref| (the interpret-mode kernel sums
  hi/lo bf16 products in another order than the port's plain GEMMs).
* The port's fused CGConv against its unfused CSR CGConv (same parameters,
  same dst-sorted batch): rtol 1e-5, atol 1e-5·max|ref|.
* A small CGCNN in training mode under kernel fused against the JAX CGCNN
  under kernel fused (windowed batch, interpret mode): per-graph outputs
  and every parameter gradient, rtol 2e-4, atol 2e-4·max|ref|, the
  tolerance of tests/test_csr.py's model parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.ops import pallas_fused as PF
from matdeeplearn_tpu.ops.pallas_segment import windowize_edges
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn.conv import CGConv
from matdeeplearn_torch.ops import fused_cgconv as FC
from matdeeplearn_torch.ops.edge_basis import gaussian_basis

IDS = {"eight": np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32),
       "twelve": np.array([11, 2, 5, 7, 13, 4, 8, 10, 12, 15, -1, -1], np.int32)}
NAMES = ["x", "xj", "wfi", "wfj", "wfe", "bf", "wsi", "wsj", "wse", "bs"]


def _close(a, b, tol, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * max(float(np.abs(b).max()), 1e-30),
                               err_msg=name)


def _flat_batches(ds, ids):
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(ids))
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    jb = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(ds, edge_order="dst"),
                           jnp.asarray(ids), jspec)
    return jb


@pytest.mark.parametrize("ids", sorted(IDS))
def test_fused_op_and_gradients_match_jax_interpret(toy_dataset, ids):
    d, de, width, tw, te = 16, 20, 0.2, 16, 32
    jb = _flat_batches(toy_dataset, IDS[ids])
    n, e = jb.num_nodes, jb.num_edges
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, d)) * np.asarray(jb.node_mask)[:, None]
         ).astype(np.float32)
    shapes = [(d, d), (d, d), (de, d), (1, d), (d, d), (d, d), (de, d), (1, d)]
    params = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    cot = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = np.asarray(jb.edge_src), np.asarray(jb.edge_dst)
    mask, dist = np.asarray(jb.edge_mask), np.asarray(jb.edge_dist_norm)
    xj = x[src]

    # JAX: the windowed layout of the same flat dst-sorted batch
    we = windowize_edges(jnp.asarray(dst), jnp.asarray(mask), n, tw, te)
    order, valid = np.asarray(we.order), np.asarray(we.valid) > 0
    cfg = (n, tw, te, de, width, True, True)  # interpret, hilo

    def jloss(x_, xjw, *p):
        out = PF.fused_cgconv(cfg, x_, xjw, jnp.asarray(dist[order]), we, *p)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(10)), has_aux=True)(
        jnp.asarray(x), jnp.asarray(xj[order]), *map(jnp.asarray, params))
    jgrads = [np.asarray(g) for g in jgrads]
    d_xj = np.zeros_like(xj)
    d_xj[order[valid]] = jgrads[1][valid]
    jgrads[1] = d_xj

    # the port: the plain version through its autograd Function
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, xj] + params]
    out = FC.FusedCGConv.apply(
        leaves[0], leaves[1], torch.as_tensor(dist), torch.as_tensor(dst),
        torch.as_tensor(mask), *leaves[2:], n, width)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), jout, 1e-4, "forward")
    for name, leaf, ref in zip(NAMES, leaves, jgrads):
        _close(leaf.grad.numpy(), ref, 1e-4, f"d_{name}")
    assert not leaves[1].grad.numpy()[mask == 0].any()


@pytest.mark.parametrize("ids", sorted(IDS))
def test_fused_cgconv_matches_unfused_csr_cgconv(toy_dataset, ids):
    ds = toy_dataset
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                    len(IDS[ids]))
    conv = CGConv(24, 50, generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((spec.num_nodes, 24)).astype(np.float32)
    cot = torch.as_tensor(rng.standard_normal(x0.shape).astype(np.float32))
    res = {}
    for fused in (False, True):
        b = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", edge_order="dst", kernel_fused=fused), IDS[ids], spec)
        x = torch.tensor(x0, requires_grad=True)
        conv.zero_grad()
        edge_attr = (None if fused else
                     gaussian_basis(b.edge_dist_norm, 0.0, 1.0, 50, 0.2))
        out = conv(x, b, edge_attr)
        (out * cot * b.node_mask[:, None]).sum().backward()
        res[fused] = [out.detach() * b.node_mask[:, None], x.grad] + [
            p.grad.clone() for p in conv.parameters()]
    for i, (a, b) in enumerate(zip(res[True], res[False])):
        _close(a.numpy(), b.numpy(), 1e-5, f"output {i}")


def _windowed_batch(ds, ids):
    layout = ds.windowed_layout()
    tw, te = layout.tw, layout.te
    spec = JB.BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                    len(ids), align=tw, align_edges=te)
    data = JB.DeviceDataset.from_graph_dataset(ds).replace(
        windowed=JB.WindowedDeviceData.from_layout(layout))
    return JB.assemble_batch_windowed(data, data.windowed, jnp.asarray(ids),
                                      spec, tw, te, fused=True)


@pytest.mark.parametrize("ids", sorted(IDS))
def test_fused_cgcnn_matches_jax_fused_cgcnn(toy_dataset, ids):
    """Training-mode forward (BatchNorm batch statistics) and parameter
    gradients of a small CGCNN, both packages on their fused kernels."""
    ds = toy_dataset
    hp = {"dim1": 16, "dim2": 12, "gc_count": 2, "post_fc_count": 1,
          "batch_norm": "True"}
    jbatch = _windowed_batch(ds, IDS[ids])
    jmodel = j_build_model("CGCNN", ds, hp)
    variables = jmodel.init(jax.random.PRNGKey(1), jbatch, training=False)
    params, stats = variables["params"], variables["batch_stats"]
    gmask = np.asarray(jbatch.graph_mask)
    cot = np.random.default_rng(4).standard_normal(gmask.shape).astype(np.float32)

    def jloss(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jbatch,
                              training=True, mutable=["batch_stats"])
        return jnp.sum(out * gmask * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = build_model("CGCNN", ds, hp, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          jax.tree.map(np.asarray, stats)))
    model.train()
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                    len(IDS[ids]))
    batch = TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", edge_order="dst", kernel_fused=True), IDS[ids], spec)
    out = model(batch)
    (out * torch.as_tensor(gmask * cot)).sum().backward()
    g = gmask > 0
    _close(out.detach().numpy()[g], np.asarray(jout)[g], 2e-4, "outputs")
    tgrads = {k: p.grad for k, p in model.named_parameters()}
    for k, ref in params_from_jax(jax.tree.map(np.asarray, jgrads)).items():
        _close(tgrads[k].numpy(), ref.numpy(), 2e-4, k)
