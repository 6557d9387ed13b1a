"""The port's fused CGConv (ops/fused_cgconv.py) against the JAX package on
the CPU.

* The op and its gradients against the JAX `ops.pallas_fused.fused_cgconv`
  run as the JAX package's own tests run it (interpret mode, hilo). The
  flat dst-sorted batch is windowed on the JAX side with `windowize_edges`,
  xj and dist permuted by its `order`, and d_xj mapped back through it.
  Tolerance rtol 1e-4, atol 1e-4·max|ref| (the interpret-mode kernel sums
  hi/lo bf16 products in another order than the port's plain GEMMs).
* The plain versions of the card's three backward kernels (edge rows,
  weight-gradient slices, slice sum), composed as the card composes them,
  against the same JAX gradients (1e-4) and the autograd backward of the
  plain forward (rtol 1e-5, atol 1e-5·max|ref|: f32 in another order); and
  the slices' micro-tile layout against a dense sum written out.
* The port's fused CGConv against its unfused CSR CGConv (same parameters,
  same dst-sorted batch): rtol 1e-5, atol 1e-5·max|ref|.
* A small CGCNN in training mode under kernel fused against the JAX CGCNN
  under kernel fused (windowed batch, interpret mode): per-graph outputs
  and every parameter gradient, rtol 2e-4, atol 2e-4·max|ref|, the
  tolerance of tests/test_csr.py's model parity.
* The arithmetic of the wgmma forward kernel, emulated in torch (3xTF32
  as tests/test_torch_fused_bilinear.py emulates it, over the split
  weight's B operand `fwd_b` in its k-step order), at CGCNN_demo width
  (D 100, De 50, 200 edges): within the chip check's limit of JAX's
  `_reference_compose` (rtol 1e-4, atol 1e-4·max|ref|), and the
  single-pass TF32 emulation outside it. The layout of `fwd_b` and of its
  hi/lo split (`split_kmajor`) at every width bucket.
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


def _jax_case(ds, ids, d=16, de=20, width=0.2, tw=16, te=32):
    """Inputs of one flat dst-sorted batch and the JAX fused_cgconv's
    output and ten gradients on them (interpret mode, hilo: `_bwd_kernel`
    computes the gradients). The JAX side runs the windowed layout of the
    same batch; d_xj is mapped back through its order."""
    jb = _flat_batches(ds, ids)
    n = jb.num_nodes
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, d)) * np.asarray(jb.node_mask)[:, None]
         ).astype(np.float32)
    shapes = [(d, d), (d, d), (de, d), (1, d), (d, d), (d, d), (de, d), (1, d)]
    params = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    cot = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = np.asarray(jb.edge_src), np.asarray(jb.edge_dst)
    mask, dist = np.asarray(jb.edge_mask), np.asarray(jb.edge_dist_norm)
    xj = x[src]

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
    return dict(x=x, xj=xj, dist=dist, dst=dst, mask=mask, params=params,
                cot=cot, n=n, de=de, width=width, jout=np.asarray(jout),
                jgrads=jgrads)


@pytest.mark.parametrize("ids", sorted(IDS))
def test_fused_op_and_gradients_match_jax_interpret(toy_dataset, ids):
    c = _jax_case(toy_dataset, IDS[ids])
    # the port: the plain version through its autograd Function
    leaves = [torch.tensor(a, requires_grad=True)
              for a in [c["x"], c["xj"]] + c["params"]]
    out = FC.FusedCGConv.apply(
        leaves[0], leaves[1], torch.as_tensor(c["dist"]),
        torch.as_tensor(c["dst"]), torch.as_tensor(c["mask"]), *leaves[2:],
        c["n"], c["width"])
    (out * torch.as_tensor(c["cot"])).sum().backward()
    _close(out.detach().numpy(), c["jout"], 1e-4, "forward")
    for name, leaf, ref in zip(NAMES, leaves, c["jgrads"]):
        _close(leaf.grad.numpy(), ref, 1e-4, f"d_{name}")
    assert not leaves[1].grad.numpy()[c["mask"] == 0].any()


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("ids", sorted(IDS))
def test_backward_stages_match_jax_bwd_kernel_and_autograd(toy_dataset, ids,
                                                           slices):
    """The plain versions of the backward's three kernels, composed as the
    card composes them (edge rows, weight-gradient slices, slice sum),
    against JAX's `_bwd_kernel` gradients (interpret mode) and the autograd
    backward of the plain forward; tolerances as above."""
    c = _jax_case(toy_dataset, IDS[ids])
    t = {k: torch.as_tensor(c[k]) for k in ("x", "xj", "dist", "dst", "mask",
                                            "cot")}
    ws = [torch.as_tensor(p) for p in c["params"]]
    args = (t["x"], t["xj"], t["dist"], t["dst"], t["mask"], *ws, c["n"],
            c["width"])
    d_x, d_xj, da = FC.fused_cgconv_bwd_rows(t["cot"], *args)
    d = t["xj"].shape[1]
    assert da.shape == (t["xj"].shape[0], 2 * 16)       # D 16: no pad columns
    assert not da.numpy()[c["mask"] == 0].any()
    partial, s = FC.fused_cgconv_wgrad(*args[:5], da, c["n"], c["de"],
                                       c["width"], slices)
    assert s == slices
    dw = FC.wgrad_reduce(partial, s, d, c["de"])
    got = (d_x, d_xj) + FC.unpack_weights(dw, d, ws[3].shape)
    auto = FC.fused_cgconv_bwd_plain(t["cot"], *args)
    for name, a, jref, aref in zip(NAMES, got, c["jgrads"], auto):
        _close(a.numpy(), jref, 1e-4, f"d_{name} vs JAX")
        _close(a.numpy(), aref.numpy(), 1e-5, f"d_{name} vs autograd")


@pytest.mark.parametrize("d,de", [(3, 7), (100, 50)])
def test_wgrad_layout_and_plain_sum(d, de):
    """Micro-tile m of a slice covers rows 4·(m // CG) and columns
    4·(m % CG) of the (2D+De+1, 2D) gradient (CG = round4(2D)/4);
    wgrad_reduce_plain is the dense sum of the slices, and the layout
    round-trips."""
    k1, nb = 2 * d + de + 1, 2 * d
    kg, cg, slices = -(-k1 // 4), -(-nb // 4), 5
    rng = np.random.default_rng(d)
    partial = rng.standard_normal((slices, kg * cg, 4, 4)).astype(np.float32)
    dense = np.zeros((slices, 4 * kg, 4 * cg), np.float64)
    for s in range(slices):
        for m in range(kg * cg):
            k, c = 4 * (m // cg), 4 * (m % cg)
            dense[s, k:k + 4, c:c + 4] = partial[s, m]
    p = torch.as_tensor(partial.reshape(-1))
    np.testing.assert_array_equal(FC.from_partial_layout(p, k1, nb).numpy(),
                                  dense[:, :k1, :nb])
    np.testing.assert_allclose(FC.wgrad_reduce_plain(p, d, de).numpy(),
                               dense[:, :k1, :nb].sum(0), rtol=1e-5, atol=1e-5)
    back = FC.to_partial_layout(torch.as_tensor(dense[:, :k1, :nb]).float())
    np.testing.assert_array_equal(
        FC.from_partial_layout(back, k1, nb).numpy(),
        dense[:, :k1, :nb].astype(np.float32))


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


# ------------------------------------ the wgmma forward kernel's arithmetic

# The 3xTF32 emulation (operands rounded as cvt.rna, lo·hi + hi·lo + hi·hi
# with f32 accumulation, one 8-deep k-step at a time) and the chip check's
# limit share, shared with the bilinear kernels' tests (tests/ is on
# sys.path under pytest).
from test_torch_fused_bilinear import _limit_share, _mma  # noqa: E402


@pytest.fixture(scope="module")
def cgcnn_width():
    """~200 edges at CGCNN_demo width (D 100, De 50) over 40 nodes, dst
    sorted, a scattered mask and a tail of pads, and JAX's
    `_reference_compose` output on the same flat layout."""
    e, n, d, de, width = 200, 40, 100, 50, 0.2
    rng = np.random.default_rng(101)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    mask = (rng.random(e) > 0.3).astype(np.float32)
    mask[170:] = 0
    dst[170:] = 0
    x = rng.standard_normal((n, d)).astype(np.float32)
    xj = rng.standard_normal((e, d)).astype(np.float32)
    dist = rng.random(e).astype(np.float32)
    shapes = [(d, d), (d, d), (de, d), (d,), (d, d), (d, d), (de, d), (d,)]
    params = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    we = PF.WindowedEdges(order=jnp.asarray(dst), dst=jnp.asarray(dst),
                          window_id=jnp.zeros(1, jnp.int32),
                          first_tile=jnp.zeros(1, jnp.int32),
                          valid=jnp.asarray(mask))
    out = PF._reference_compose(jnp.asarray(x), jnp.asarray(xj),
                                jnp.asarray(dist), we,
                                [jnp.asarray(p) for p in params], n, de, width)
    t = [torch.as_tensor(v) for v in (x, xj, dist, dst, mask)]
    return t, [torch.as_tensor(p) for p in params], n, de, width, np.asarray(out)


def _emulated_cgconv_fwd(x, xj, dist, dst, mask, ws, n, de, width,
                         passes: int):
    """The forward kernel's arithmetic in its order: acc = z·B over
    round8(K1) in k-steps of 8 (B = fwd_b, af and as of a feature in
    adjacent columns), then mask·σ(af)·softplus(as) summed at dst."""
    d = xj.shape[1]
    b = FC.fwd_b(FC.pack_weights(*ws), d)
    z, w = FC._edge_terms(x, xj, dist, dst, mask, n, de, width)
    zp = z.new_zeros(z.shape[0], b.shape[1])
    zp[:, :z.shape[1]] = z
    acc = z.new_zeros(z.shape[0], b.shape[0])
    for k0 in range(0, b.shape[1], 8):
        acc = _mma(acc, zp[:, k0:k0 + 8], b[:, k0:k0 + 8].t(), passes)
    msg = w[:, None] * torch.sigmoid(acc[:, 0:2 * d:2]) * \
        torch.nn.functional.softplus(acc[:, 1:2 * d:2])
    return torch.zeros(n, d).index_add_(0, dst.long(), msg)


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_emulated_fwd_against_jax_at_the_chip_limit(cgcnn_width, passes,
                                                    within):
    """At CGCNN_demo width the 3xTF32 emulation of the forward kernel falls
    within the chip check's limit of JAX's `_reference_compose`
    (chip_smoke.py:assert_fused: rtol 1e-4, atol 1e-4·max|ref|), and the
    single-pass TF32 one (hi·hi alone) outside it."""
    (x, xj, dist, dst, mask), ws, n, de, width, ref = cgcnn_width
    got = _emulated_cgconv_fwd(x, xj, dist, dst, mask, ws, n, de, width,
                               passes)
    share = _limit_share(got, ref)
    print(f"forward, {passes}xTF32: worst share of the limit {share:.4g}")
    assert (share < 1.0) == within, share


@pytest.mark.parametrize("d", [1, 3, 100, 128, 129, 150, 256])
def test_fwd_b_is_the_packed_weight_interleaved(d):
    """fwd_b, the B operand that the forward kernel splits once a call:
    af and as of feature c in rows 2c and 2c + 1, zeros past 2D rows and
    K1 columns, NP = 8·NTW·WN rows (one warpgroup up to D = 128, two
    past it); split_kmajor's hi + lo gives it back to f32 accuracy."""
    de = 7
    rng = np.random.default_rng(d)
    w = torch.as_tensor(rng.standard_normal((2 * d + de + 1, 2 * d)),
                        dtype=torch.float32)
    b = FC.fwd_b(w, d)
    wn = 1 if d <= 128 else 2
    nt = -(-2 * d // 8) if wn == 1 else -(-d // 8)
    assert b.shape == (8 * wn * FC.ntw_bucket(nt), -(-(2 * d + de + 1) // 8) * 8)
    assert b.shape[0] >= 2 * d
    assert torch.equal(b[0:2 * d:2, :w.shape[0]], w[:, :d].t())
    assert torch.equal(b[1:2 * d:2, :w.shape[0]], w[:, d:].t())
    assert not b[2 * d:].any() and not b[:, w.shape[0]:].any()
    words = FC.split_kmajor(b)
    assert words.numel() == 2 * b.numel()
    parts = words.view(torch.float32).view(b.shape[1] // 8, 2, b.shape[0] // 8,
                                           2, 8, 4)
    # back to (part, NP, columns): k-step s, half kh, column c is 8s + 4kh + c
    back = parts.permute(1, 2, 4, 0, 3, 5).reshape(2, b.shape[0], b.shape[1])
    assert torch.equal(back[0], FC.tf32(b))
    torch.testing.assert_close(back[0] + back[1], b, rtol=2e-7, atol=1e-30)
