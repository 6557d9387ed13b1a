"""The port's fused SchNet cfconv (ops/fused_cfconv.py) against the JAX
package on the CPU.

* The op and its five gradients (xj, w0, b0, w1, b1) against the JAX
  `ops.pallas_fused_schnet.fused_cfconv`, run as the JAX package's own
  tests run it (interpret mode, hilo), and against its `_reference_compose`.
  The port takes the flat batch as it is: dst-sorted with tail pads,
  permuted, or with a scattered mask. `_reference_compose` takes the same
  flat layout. The Pallas kernel needs dst-sorted real edges, so its side
  gets the real edges in stable dst order, windowed with `windowize_edges`,
  and its d_xj is mapped back through that order. Tolerance rtol 2e-4 and
  atol 2e-5·max|ref|, the JAX package's own (tests/test_fused_schnet.py).
  d_xj is exactly 0 on every masked edge.
* The plain weight-gradient reduction against a dense sum of its partial
  layout, and the kernels' weight stack taken apart by split_wgrad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.ops import pallas_fused_schnet as PFS
from matdeeplearn_tpu.ops.pallas_segment import WindowedEdges, windowize_edges
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.ops import fused_cfconv as FS

IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
NAMES = ["xj", "w0", "b0", "w1", "b1"]
DE, WIDTH, CUTOFF, TW, TE = 20, 0.2, 5.0, 16, 32


def _close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=2e-4,
                               atol=2e-5 * max(float(np.abs(b).max()), 1e-30),
                               err_msg=name)


def _inputs(ds, case, f):
    """One flat dst-sorted batch of the toy dataset, laid out as `case`
    says, with random xj (pad rows too), filter parameters and cotangent."""
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(IDS))
    jb = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(ds, edge_order="dst"),
                           jnp.asarray(IDS),
                           JB.BatchSpec(spec.num_graphs, spec.num_nodes,
                                        spec.num_edges))
    n, e = jb.num_nodes, jb.num_edges
    rng = np.random.default_rng(f)
    dst, mask = np.array(jb.edge_dst), np.array(jb.edge_mask)
    dist, wraw = np.array(jb.edge_dist_norm), np.array(jb.edge_weight)
    if case == "permuted":
        perm = rng.permutation(e)
        dst, mask, dist, wraw = dst[perm], mask[perm], dist[perm], wraw[perm]
    elif case == "scattered":
        mask = mask * (rng.random(e) > 0.3).astype(np.float32)
    xj = rng.standard_normal((e, f)).astype(np.float32)
    shapes = [(DE, f), (1, f), (f, f), (1, f)]
    params = [(0.4 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    cot = rng.standard_normal((n, f)).astype(np.float32)
    return n, dst, mask, dist, wraw, xj, params, cot


def _jax_interpret(n, dst, mask, dist, wraw, xj, params, cot):
    """The Pallas kernel in interpret mode on the real edges in stable dst
    order; returns (out, grads) with d_xj in the port's edge order."""
    e = len(dst)
    real = np.flatnonzero(mask > 0)
    keep = real[np.argsort(dst[real], kind="stable")]
    comp = np.zeros(e, np.int64)
    comp[:len(keep)] = keep
    cdst = np.zeros(e, np.int32)
    cdst[:len(keep)] = dst[keep]
    cmask = (np.arange(e) < len(keep)).astype(np.float32)
    we = windowize_edges(jnp.asarray(cdst), jnp.asarray(cmask), n, TW, TE)
    order, valid = np.asarray(we.order), np.asarray(we.valid) > 0
    widx = comp[order]
    cfg = (n, TW, TE, DE, WIDTH, CUTOFF, True, True)  # interpret, hilo

    def loss(xjw, *p):
        out = PFS.fused_cfconv(cfg, xjw, jnp.asarray(dist[widx]),
                               jnp.asarray(wraw[widx]), we, *p)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(5)),
                                         has_aux=True)(
        jnp.asarray(xj[widx]), *map(jnp.asarray, params))
    grads = [np.asarray(g) for g in grads]
    d_xj = np.zeros_like(xj)
    d_xj[widx[valid]] = grads[0][valid]
    return np.asarray(out), [d_xj] + grads[1:]


def _jax_compose(n, dst, mask, dist, wraw, xj, params, cot):
    """_reference_compose on the port's flat layout."""
    we = WindowedEdges(order=jnp.asarray(dst), dst=jnp.asarray(dst),
                       window_id=jnp.zeros(1, jnp.int32),
                       first_tile=jnp.zeros(1, jnp.int32),
                       valid=jnp.asarray(mask))

    def loss(xj_, *p):
        out = PFS._reference_compose(xj_, jnp.asarray(dist), jnp.asarray(wraw),
                                     we, p, n, DE, WIDTH, CUTOFF)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(5)),
                                         has_aux=True)(
        jnp.asarray(xj), *map(jnp.asarray, params))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("f", [3, 16])
@pytest.mark.parametrize("case", ["sorted", "permuted", "scattered"])
@pytest.mark.parametrize("ref", ["interpret", "compose"])
def test_fused_cfconv_and_gradients_match_jax(toy_dataset, ref, case, f):
    n, dst, mask, dist, wraw, xj, params, cot = _inputs(toy_dataset, case, f)
    jax_fn = _jax_interpret if ref == "interpret" else _jax_compose
    jout, jgrads = jax_fn(n, dst, mask, dist, wraw, xj, params, cot)

    leaves = [torch.tensor(a, requires_grad=True) for a in [xj] + params]
    out = FS.FusedCFConv.apply(
        leaves[0], torch.as_tensor(dist), torch.as_tensor(wraw),
        torch.as_tensor(dst), torch.as_tensor(mask), *leaves[1:], n, WIDTH,
        CUTOFF)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), jout, "forward")
    for name, leaf, want in zip(NAMES, leaves, jgrads):
        _close(leaf.grad.numpy(), want, f"d_{name}")
    d_xj = leaves[0].grad.numpy()
    assert (d_xj[mask == 0] == 0).all()
    assert (mask == 0).any() and (mask > 0).any()


@pytest.mark.parametrize("f,de", [(3, 20), (150, 50)])
def test_wgrad_reduce_plain_is_the_dense_sum_of_its_layout(f, de):
    """Micro-tile m of a block covers rows 4·(m // CG) and columns
    4·(m % CG) of the (round4(De+1) + round4(F+1), round4(F)) stack."""
    r4 = lambda v: (v + 3) // 4 * 4
    rows, cols = r4(de + 1) + r4(f + 1), r4(f)
    cg, blocks = cols // 4, 3
    partial = np.random.default_rng(f).standard_normal(
        (blocks, rows // 4 * cg, 4, 4)).astype(np.float32)
    dense = np.zeros((rows, cols), np.float64)
    for b in range(blocks):
        for m in range(partial.shape[1]):
            k, c = 4 * (m // cg), 4 * (m % cg)
            dense[k:k + 4, c:c + 4] += partial[b, m]
    got = FS.wgrad_reduce(torch.as_tensor(partial.reshape(-1)), blocks, f, de)
    np.testing.assert_allclose(got.numpy(), dense[:, :f], rtol=1e-5, atol=1e-5)

    d_w0, d_b0, d_w1, d_b1 = FS.split_wgrad(got, f, de, (1, f), (f,))
    np.testing.assert_array_equal(d_w0.numpy(), got.numpy()[:de])
    np.testing.assert_array_equal(d_b0.numpy(), got.numpy()[de:de + 1])
    np.testing.assert_array_equal(d_w1.numpy(), got.numpy()[r4(de + 1):][:f])
    np.testing.assert_array_equal(d_b1.numpy(), got.numpy()[r4(de + 1) + f])
