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
* The arithmetic of the tensor-core backward (the edge rows on wgmma and
  the weight gradient in slices), emulated in torch (3xTF32 as
  tests/test_torch_fused_bilinear.py emulates it, in the kernels' k-step
  and chunk order, over the split weights' B operands `bwd_b`), at
  SchNet_demo width (F 150, De 50, 200 edges): d_xj and all four weight
  gradients within the chip check's limit of the VJP of JAX's
  `_reference_compose` (rtol 1e-4, atol 1e-4·max|ref|), and the
  single-pass TF32 emulation outside it for each. The layout of `bwd_b`,
  its pair order and its hi/lo split.
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


# ------------------------------- the tensor-core backward's arithmetic

# The 3xTF32 emulation (operands rounded as cvt.rna, lo·hi + hi·lo + hi·hi
# with f32 accumulation, one 8-deep k-step at a time) and the chip check's
# limit share, shared with the bilinear kernels' tests (tests/ is on
# sys.path under pytest).
from test_torch_fused_bilinear import _limit_share, _mma  # noqa: E402

from matdeeplearn_torch.ops.edge_basis import gaussian_basis  # noqa: E402
from matdeeplearn_torch.ops.fused_cgconv import split_kmajor, tf32  # noqa: E402


@pytest.fixture(scope="module")
def schnet_width():
    """~200 edges at SchNet_demo width (F 150, De 50) over 40 nodes, dst
    sorted, a scattered mask and a tail of pads, and JAX's
    `_reference_compose` output and VJP on the same flat layout."""
    e, n, f, de, width, cutoff = 200, 40, 150, 50, 0.2, 8.0
    rng = np.random.default_rng(150)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    mask = (rng.random(e) > 0.3).astype(np.float32)
    mask[170:] = 0
    dst[170:] = 0
    xj = rng.standard_normal((e, f)).astype(np.float32)
    dist = rng.random(e).astype(np.float32)
    wraw = (cutoff * rng.random(e)).astype(np.float32)
    shapes = [(de, f), (1, f), (f, f), (1, f)]
    params = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    cot = rng.standard_normal((n, f)).astype(np.float32)
    we = WindowedEdges(order=jnp.asarray(dst), dst=jnp.asarray(dst),
                       window_id=jnp.zeros(1, jnp.int32),
                       first_tile=jnp.zeros(1, jnp.int32),
                       valid=jnp.asarray(mask))
    out, vjp = jax.vjp(
        lambda xj_, *p: PFS._reference_compose(
            xj_, jnp.asarray(dist), jnp.asarray(wraw), we, p, n, de, width,
            cutoff), jnp.asarray(xj), *map(jnp.asarray, params))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    t = [torch.as_tensor(v) for v in (xj, dist, wraw, dst, mask)]
    return (t, [torch.as_tensor(p) for p in params], torch.as_tensor(cot), n,
            de, width, cutoff, grads)


def _chain(a, b, passes):
    """a @ bᵀ as the kernels take it: one _mma a k-step of 8 columns."""
    acc = a.new_zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], 8):
        acc = _mma(acc, a[:, k0:k0 + 8], b[:, k0:k0 + 8].t(), passes)
    return acc


def _emulated_cfconv_bwd(xj, dist, wraw, dst, mask, w0, b0, w1, b1, cot, n,
                         de, width, cutoff, passes: int, slices: int):
    """The backward's arithmetic in its kernels' order. The edge kernel:
    pre = b·W0 over ⌈De/8⌉ k-steps, + b0; a = ssp(pre); w = a·W1 and
    dpre = (dw·W1ᵀ)·σ(pre) over the np columns in k-steps of 8, their A
    columns and B rows in pair_order (bwd_b); + b1; d_xj = gg·w, dw =
    gg·xj. The weight gradient: per slice, the chunks slice, slice +
    slices, ... 8 edges a k-step, [b | 1]ᵀ·dpre and [a | 1]ᵀ·dw; then the
    slices in order."""
    e, f = xj.shape
    np_ = FS.row_width(f)
    b = FS.bwd_b(w0, w1)
    k0 = b.shape[1] - 2 * np_
    s = FS.edge_scale(wraw, dst, mask, n, cutoff)
    real = (s != 0)[:, None]
    basis = xj.new_zeros(e, k0)
    basis[:, :de] = gaussian_basis(dist, 0.0, 1.0, de, width)
    basis = torch.where(real, basis, 0.0)
    cols = torch.arange(np_) < f
    pad = lambda v: torch.cat([v.reshape(-1), v.new_zeros(np_ - f)])
    pre = _chain(basis, b[:, :k0], passes) + pad(b0)
    a = torch.where(real & cols, torch.nn.functional.softplus(pre) - FS._LOG2,
                    0.0)
    order = FS.pair_order(np_)
    w = _chain(a[:, order], b[:, k0:k0 + np_], passes) + pad(b1)
    gg = torch.where(real, cot[torch.where(s != 0, dst, 0).long()], 0.0)
    gg = torch.cat([gg * s[:, None], gg.new_zeros(e, np_ - f)], 1)
    d_xj = (gg * w)[:, :f]
    dw = gg * torch.cat([xj, xj.new_zeros(e, np_ - f)], 1)
    dpre = _chain(dw[:, order], b[:, k0 + np_:], passes) * torch.sigmoid(pre)
    z0 = torch.cat([basis[:, :de], real.float()], 1)
    z1 = torch.cat([a[:, :f], real.float()], 1)
    chunk = torch.arange(e) // FS.WGRAD_CHUNK
    dw0 = torch.zeros(de + 1, np_)
    dw1 = torch.zeros(f + 1, np_)
    for sl in range(slices):
        acc0, acc1 = torch.zeros_like(dw0), torch.zeros_like(dw1)
        for ch in range(sl, int(chunk.max()) + 1, slices):
            for e0 in range(ch * FS.WGRAD_CHUNK, min(e, (ch + 1) * FS.WGRAD_CHUNK), 8):
                r = slice(e0, min(e, e0 + 8))
                acc0 = _mma(acc0, z0[r].t(), dpre[r], passes)
                acc1 = _mma(acc1, z1[r].t(), dw[r], passes)
        dw0, dw1 = dw0 + acc0, dw1 + acc1
    return d_xj, dw0[:de, :f], dw0[de, :f], dw1[:f, :f], dw1[f, :f]


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_emulated_bwd_against_jax_vjp_at_the_chip_limit(schnet_width, passes,
                                                        within):
    """At SchNet_demo width the 3xTF32 emulation of the backward's two
    kernels falls within the chip check's limit of the VJP of JAX's
    `_reference_compose` (chip_smoke.py:assert_fused: rtol 1e-4, atol
    1e-4·max|ref|) for d_xj and all four weight gradients; the single-pass
    TF32 one (hi·hi alone) falls outside it for each of the five. Masked
    edges get exactly zero d_xj rows."""
    (xj, dist, wraw, dst, mask), ws, cot, n, de, width, cutoff, grads = \
        schnet_width
    got = _emulated_cfconv_bwd(xj, dist, wraw, dst, mask, *ws, cot, n, de,
                               width, cutoff, passes, slices=3)
    assert (got[0][mask == 0] == 0).all()
    shares = [_limit_share(g.reshape(r.shape), r) for g, r in zip(got, grads)]
    print(f"backward, {passes}xTF32: worst shares of the limit, d_xj, d_w0, "
          f"d_b0, d_w1, d_b1: {', '.join(f'{v:.4g}' for v in shares)}")
    if within:
        assert max(shares) < 1.0, shares
    else:
        assert min(shares) > 1.0, shares


@pytest.mark.parametrize("f,de", [(1, 50), (3, 7), (150, 50), (152, 9),
                                  (256, 50)])
def test_bwd_b_is_w0_and_w1_in_pair_order(f, de):
    """bwd_b, the B operands that the backward kernel splits once a call:
    W0ᵀ, then W1ᵀ and W1 with their columns in pair_order, zeros past De
    and F, np = row_width(F) >= F rows; split_kmajor's hi + lo gives it
    back to f32 accuracy."""
    rng = np.random.default_rng(f)
    w0 = torch.as_tensor(rng.standard_normal((de, f)), dtype=torch.float32)
    w1 = torch.as_tensor(rng.standard_normal((f, f)), dtype=torch.float32)
    b = FS.bwd_b(w0, w1)
    np_, k0 = FS.row_width(f), -(-de // 8) * 8
    assert np_ >= f and np_ % 8 == 0
    assert b.shape == (np_, k0 + 2 * np_)
    order = FS.pair_order(np_)
    assert sorted(order.tolist()) == list(range(np_))
    inv = torch.argsort(order)
    units = [b[:, :k0].clone(), b[:, k0:k0 + np_][:, inv],
             b[:, k0 + np_:][:, inv]]
    for u, want in zip(units, (w0.t(), w1.t(), w1)):
        assert torch.equal(u[:want.shape[0], :want.shape[1]], want)
        u[:want.shape[0], :want.shape[1]] = 0
        assert not u.any()
    words = split_kmajor(b)
    parts = words.view(torch.float32).view(b.shape[1] // 8, 2, np_ // 8, 2,
                                           8, 4)
    back = parts.permute(1, 2, 4, 0, 3, 5).reshape(2, np_, b.shape[1])
    assert torch.equal(back[0], tf32(b))
    torch.testing.assert_close(back[0] + back[1], b, rtol=2e-7, atol=1e-30)


def test_pair_order_puts_accumulator_pairs_at_t_and_t_plus_4():
    """An accumulator fragment holds columns 2t and 2t + 1 of an n8-tile;
    an A fragment takes columns t and t + 4 of a k-step."""
    order = FS.pair_order(16).view(2, 8)
    for j in range(2):
        for t in range(4):
            assert order[j, t] == 8 * j + 2 * t
            assert order[j, t + 4] == 8 * j + 2 * t + 1
