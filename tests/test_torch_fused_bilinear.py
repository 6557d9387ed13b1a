"""The port's bilinear NNConv message (ops/fused_bilinear.py) against the
JAX package on the CPU.

* The op and its four gradients (xj, a, w1, b1) against the JAX
  `ops.pallas_bilinear.fused_bilinear_msg` run as the JAX package's own
  tests run it, in interpret mode: the unit-loop schedule (`(te, True)`)
  and the chunked one (`(te, True, False, True)`), and against its
  `_reference_compose`. Shapes: E 300, D 10, H 8, K 10 (the JAX test's);
  D ≠ K with H not a multiple of 8; E 700 and 1030 at the tiles where the
  JAX test found its tail faults. Forward rtol 1e-5, atol 1e-5; gradients
  rtol 1e-4, atol 1e-5·max|ref| (the JAX test's own). With the mask all
  ones the two functions are identical; with a scattered mask the port is
  held to mask·fused_bilinear_msg, and its masked rows are exactly zero in
  the output, d_xj and d_a.
* The plain versions process edges in chunks: any chunk size gives the
  same values, and the wrappers on CPU tensors launch nothing.
* The layout of the kernels' weight [W1; b1], its padded form for the
  forward kernel, and its gradient.
* The arithmetic of the forward and weight-gradient kernels, emulated in
  torch: operands rounded to TF32 as `cvt.rna` does, a·b taken as
  lo·hi + hi·lo + hi·hi with f32 accumulation (3xTF32), in the kernels'
  order (the forward walks the flat reduction of (H+1)·D rows 8 at a time;
  the weight gradient deals the 32-edge chunks that hold a real edge to
  its splits in turn, walks each split's chunks 8 edges at a time, then
  adds the splits in order). At MPNN_demo width (D = H = K = 100, 200
  edges) the 3xTF32 emulation falls within the chip check's limit of the
  JAX `fused_bilinear_msg` and its VJP (chip_smoke.py:assert_fused, rtol
  1e-4 and atol 1e-4·max|ref|), and the single-pass TF32 emulation (hi·hi
  alone) falls outside it: the limit tells the two builds apart.
* The backward to the rows (d_xj, d_a) the same way, in its kernel's
  order: U_h = (mask·g) @ W_hᵀ over round8(K) in k-steps of 8, then unit by
  unit d_xj = fmaf(a_h, U_h, d_xj) and d_a[:, h] as each lane's fmaf chain
  over its columns, added over the 4 lanes of a row's quad. At D = H = K =
  100 the 3xTF32 emulation falls within the chip limit of JAX's chunked
  VJP, and the 1xTF32 one outside it (at a reduction of K = 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.ops.pallas_bilinear import (_reference_compose,
                                                  fused_bilinear_msg)
from matdeeplearn_torch.ops import fused_bilinear as FB

NAMES = ["xj", "a", "w1", "b1"]
# (E, D, H, K, edge tile of the JAX kernels)
CASES = {"e300": (300, 10, 8, 10, 128), "d_ne_k": (300, 12, 7, 6, 128),
         "e700": (700, 10, 8, 10, 512), "e1030": (1030, 10, 8, 10, 1500)}
JAX_FNS = {
    "unit": lambda te: lambda *p: fused_bilinear_msg((te, True), *p),
    "chunked": lambda te: lambda *p: fused_bilinear_msg((te, True, False, True),
                                                        *p),
    "compose": lambda te: _reference_compose,
}


def _inputs(case, masked):
    e, d, h, k, _ = CASES[case]
    rng = np.random.default_rng(e + d + h + k)
    xj = rng.standard_normal((e, d)).astype(np.float32)
    a = rng.standard_normal((e, h)).astype(np.float32)
    w1 = (0.2 * rng.standard_normal((h, d * k))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(d * k)).astype(np.float32)
    mask = (rng.random(e) > 0.3 if masked else np.ones(e)).astype(np.float32)
    cot = rng.standard_normal((e, k)).astype(np.float32)
    return [xj, a, w1, b1], mask, cot


def _close_fwd(a, b, name):
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def _close_grad(a, b, name):
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(b).max()), 1e-6),
                               err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["ones", "scattered"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", list(JAX_FNS))
def test_fused_bilinear_and_gradients_match_jax(ref, case, masked):
    args, mask, cot = _inputs(case, masked)
    fn = JAX_FNS[ref](CASES[case][4])
    jm = jnp.asarray(mask)[:, None]

    def loss(*p):
        out = jm * fn(*p)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*map(jnp.asarray, args))

    leaves = [torch.tensor(v, requires_grad=True) for v in args]
    out = FB.FusedBilinear.apply(*leaves, torch.as_tensor(mask))
    (out * torch.as_tensor(cot)).sum().backward()
    _close_fwd(out.detach().numpy(), np.asarray(jout), "forward")
    for name, leaf, want in zip(NAMES, leaves, jgrads):
        _close_grad(leaf.grad.numpy(), np.asarray(want), f"d_{name}")
    off = mask == 0
    assert off.any() == masked
    for got in (out.detach(), leaves[0].grad, leaves[1].grad):
        assert (got.numpy()[off] == 0).all()


def test_plain_versions_agree_at_every_chunk_size(monkeypatch):
    args, mask, cot = _inputs("d_ne_k", True)
    t = [torch.as_tensor(v) for v in args]
    m, g = torch.as_tensor(mask), torch.as_tensor(cot)
    whole = (FB.fused_bilinear(*t, m), *FB.fused_bilinear_bwd(g, *t, m))
    e, d, h, k, _ = CASES["d_ne_k"]
    for floats in (1, (h + 1) * d * 7, d * k * 13):  # 1 edge, 7, 13 a chunk
        monkeypatch.setattr(FB, "_CHUNK_FLOATS", floats)
        assert len(FB._chunks(e, (h + 1) * d)) > 1
        got = (FB.fused_bilinear(*t, m), *FB.fused_bilinear_bwd(g, *t, m))
        # d_w1 and d_b1 add the chunks' sums in another grouping
        for name, a, b in zip(["out"] + NAMES, got, whole):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()),
                                       msg=lambda s, n=name: f"{n}: {s}")


def test_cpu_tensors_take_the_plain_versions_without_launching():
    args, mask, cot = _inputs("e300", True)
    t = [torch.as_tensor(v) for v in args]
    m, g = torch.as_tensor(mask), torch.as_tensor(cot)
    before = dict(FB.LAUNCHES)
    out = FB.fused_bilinear(*t, m)
    grads = FB.fused_bilinear_bwd(g, *t, m)
    assert FB.LAUNCHES == before
    torch.testing.assert_close(out, FB.fused_bilinear_plain(*t, m))
    for a, b in zip(grads, FB.fused_bilinear_bwd_plain(g, *t, m)):
        torch.testing.assert_close(a, b)


def test_weight_layout_puts_the_bias_last_as_unit_h():
    """Row h·D + d of [W1; b1] is W1[h, d·K:(d+1)·K], the reference's
    reshape(-1, D, K); the last D rows are b1; split_wgrad inverts it."""
    h, d, k = 3, 4, 5
    w1 = torch.arange(h * d * k, dtype=torch.float32).reshape(h, d * k)
    b1 = -torch.arange(1, d * k + 1, dtype=torch.float32)
    w = FB.extend_weight(w1, b1, d)
    assert w.shape == ((h + 1) * d, k)
    for hh in range(h):
        for dd in range(d):
            assert torch.equal(w[hh * d + dd], w1[hh, dd * k:(dd + 1) * k])
    assert torch.equal(w[h * d:], b1.reshape(d, k))
    d_w1, d_b1 = FB.split_wgrad(w, w1.shape, b1.shape)
    assert torch.equal(d_w1, w1) and torch.equal(d_b1, b1)


@pytest.mark.parametrize("h,d,k", [(3, 4, 5), (7, 3, 8), (1, 33, 9),
                                   (100, 100, 100)])
def test_padded_weight_is_extend_weight_zero_padded(h, d, k):
    """Rows to a multiple of FWD_CHUNK, columns to round8(K), zeros beyond
    extend_weight's ((H+1)·D, K) block."""
    rng = np.random.default_rng(h * d * k)
    w1 = torch.tensor(rng.standard_normal((h, d * k)), dtype=torch.float32)
    b1 = torch.tensor(rng.standard_normal(d * k), dtype=torch.float32)
    wp = FB.padded_weight(w1, b1, d)
    rows = (h + 1) * d
    assert wp.shape == (-(-rows // FB.FWD_CHUNK) * FB.FWD_CHUNK, -(-k // 8) * 8)
    assert wp.is_contiguous()
    assert torch.equal(wp[:rows, :k], FB.extend_weight(w1, b1, d))
    assert not wp[rows:].any() and not wp[:, k:].any()


# ------------------------------------- the tensor-core kernels' arithmetic


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 word to 10 mantissa bits, to
    nearest with ties away from zero (sign-magnitude, so one add does)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma(acc, a, b, passes: int):
    """acc (f32) += a @ b as the kernels' mma_3xtf32 takes it: lo_a·hi_b,
    hi_a·lo_b, then hi_a·hi_b, each one m16n8k8 step (products of TF32
    values are exact; the 8-term sum is added to the f32 accumulator).
    passes=1 keeps hi_a·hi_b alone (single-pass TF32)."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3 else [(ahi, bhi)]
    for x, y in terms:
        acc = (acc.double() + x.double() @ y.double()).float()
    return acc


def _x_rows(xj, a) -> torch.Tensor:
    """X (E, (H+1)·D): X[e, h·D + d] = [a | 1][e, h]·xj[e, d], one f32
    product, as the kernels form it."""
    ext = torch.cat([a, torch.ones_like(a[:, :1])], 1)
    return (ext[:, :, None] * xj[:, None, :]).reshape(len(xj), -1)


def _emulated_forward(xj, a, w1, b1, mask, passes: int):
    d = xj.shape[1]
    x = _x_rows(xj, a)
    wp = FB.padded_weight(w1, b1, d)
    x = torch.cat([x, x.new_zeros(len(x), wp.shape[0] - x.shape[1])], 1)
    acc = x.new_zeros(len(x), wp.shape[1])
    for r in range(0, wp.shape[0], 8):
        acc = _mma(acc, x[:, r:r + 8], wp[r:r + 8], passes)
    k = b1.numel() // d
    return mask[:, None] * acc[:, :k]


def _emulated_wgrad(g, xj, a, mask, splits: int, passes: int):
    x = _x_rows(xj, a)
    ge = mask[:, None] * g
    e = len(x)
    chunks = -(-e // FB.WGRAD_CHUNK)
    pad = chunks * FB.WGRAD_CHUNK - e
    x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    ge = torch.cat([ge, ge.new_zeros(pad, ge.shape[1])])
    # the chunks with a real edge, dealt to the splits in turn
    live = [ch for ch in range(chunks)
            if mask[ch * FB.WGRAD_CHUNK:(ch + 1) * FB.WGRAD_CHUNK].any()]
    total = x.new_zeros(x.shape[1], g.shape[1])
    for s in range(splits):
        acc = torch.zeros_like(total)
        for ch in live[s::splits]:
            for e0 in range(ch * FB.WGRAD_CHUNK, (ch + 1) * FB.WGRAD_CHUNK, 8):
                acc = _mma(acc, x[e0:e0 + 8].t(), ge[e0:e0 + 8], passes)
        total = total + acc
    return total


def _fma(x, y, acc):
    """fmaf: x·y + acc rounded once to f32 (the f32 product is exact in
    f64)."""
    return (x.double() * y.double() + acc.double()).float()


def _emulated_bwd_rows(g, xj, a, w1, b1, mask, passes: int):
    """The backward-to-the-rows kernel's arithmetic in its order, for one
    warp column (D <= 104): U_h = ge @ W_hᵀ by _mma over round8(K) in
    k-steps of 8; after each unit d_xj = fmaf(a_h, U_h, d_xj) (the bias unit
    by 1), and d_a[:, h] over the columns a lane holds (8 j + 2 t and
    8 j + 2 t + 1 for its t = lane % 4, an fmaf chain in that order), then
    the 4 lanes of the quad as (v0 + v1) + (v2 + v3). Rows whose mask is 0
    stay zero: the kernel never writes them."""
    e, d = xj.shape
    h = a.shape[1]
    k = b1.numel() // d
    kp, dp = -(-k // 8) * 8, -(-d // 8) * 8
    ge = torch.zeros(e, kp)
    ge[:, :k] = mask[:, None] * g
    w = torch.zeros(h + 1, dp, kp)
    w[:, :d, :k] = FB.extend_weight(w1, b1, d).view(h + 1, d, k)
    xp = torch.zeros(e, dp)
    xp[:, :d] = xj
    ext = torch.cat([a, torch.ones_like(a[:, :1])], 1)
    lanes = [[c for j in range(dp // 8) for c in (8 * j + 2 * t, 8 * j + 2 * t + 1)]
             for t in range(4)]
    d_xj = torch.zeros(e, dp)
    d_a = torch.zeros(e, h)
    for u in range(h + 1):
        acc = torch.zeros(e, dp)
        for k0 in range(0, kp, 8):
            acc = _mma(acc, ge[:, k0:k0 + 8], w[u, :, k0:k0 + 8].t(), passes)
        d_xj = _fma(ext[:, u:u + 1], acc, d_xj)
        if u < h:
            v = []
            for cols in lanes:
                dot = torch.zeros(e)
                for c in cols:
                    dot = _fma(xp[:, c], acc[:, c], dot)
                v.append(dot)
            d_a[:, u] = (v[0] + v[1]) + (v[2] + v[3])
    off = mask == 0
    d_xj[off] = 0
    d_a[off] = 0
    return d_xj[:, :d], d_a


def _limit_share(out, ref) -> float:
    """chip_smoke.py:limit_share: the worst |out - ref| over what
    assert_fused allows (1e-4·max|ref| + 1e-4·|ref|); below 1 passes."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    allowed = 1e-4 * max(np.abs(ref).max(), 1e-30) + 1e-4 * np.abs(ref)
    return float((np.abs(out - ref) / allowed).max())


@pytest.fixture(scope="module")
def mpnn_width():
    """200 edges at D = H = K = 100 (a scattered mask, then 50 pads) and
    the JAX chunked kernel's message and VJP, in interpret mode, as its own
    tests run it."""
    e, d, h, k = 200, 100, 100, 100
    rng = np.random.default_rng(100)
    xj = rng.standard_normal((e, d)).astype(np.float32)
    a = np.maximum(rng.standard_normal((e, h)), 0).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((h, d * k))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(d * k)).astype(np.float32)
    mask = (rng.random(e) > 0.3).astype(np.float32)
    mask[150:] = 0  # a tail of pads: the last two 32-edge chunks hold none
    cot = rng.standard_normal((e, k)).astype(np.float32)
    jm = jnp.asarray(mask)[:, None]
    out, vjp = jax.vjp(
        lambda *p: jm * fused_bilinear_msg((128, True, False, True), *p),
        *map(jnp.asarray, (xj, a, w1, b1)))
    d_xj, d_a, d_w1, d_b1 = vjp(jnp.asarray(cot))
    t = [torch.as_tensor(v) for v in (xj, a, w1, b1, mask, cot)]
    return (t, np.asarray(out), np.asarray(d_w1), np.asarray(d_b1),
            np.asarray(d_xj), np.asarray(d_a))


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_emulated_forward_against_jax_at_the_chip_limit(mpnn_width, passes,
                                                        within):
    (xj, a, w1, b1, mask, _), out, *_ = mpnn_width
    got = _emulated_forward(xj, a, w1, b1, mask, passes)
    assert got.shape == out.shape
    assert (got[mask == 0] == 0).all()
    share = _limit_share(got, out)
    assert (share < 1.0) == within, share


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_emulated_wgrad_against_jax_vjp_at_the_chip_limit(mpnn_width, passes,
                                                          within, splits):
    (xj, a, w1, b1, mask, cot), _, d_w1, d_b1, *_ = mpnn_width
    dw = _emulated_wgrad(cot, xj, a, mask, splits, passes)
    got = FB.split_wgrad(dw, w1.shape, b1.shape)
    shares = [_limit_share(x, r) for x, r in zip(got, (d_w1, d_b1))]
    assert all((s < 1.0) == within for s in shares), shares


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_emulated_bwd_rows_against_jax_vjp_at_the_chip_limit(mpnn_width,
                                                             passes, within):
    (xj, a, w1, b1, mask, cot), *_, d_xj, d_a = mpnn_width
    got = _emulated_bwd_rows(cot, xj, a, w1, b1, mask, passes)
    for x, r in zip(got, (d_xj, d_a)):
        assert x.shape == r.shape
        assert (x[mask == 0] == 0).all()
    shares = [_limit_share(x, r) for x, r in zip(got, (d_xj, d_a))]
    assert all((s < 1.0) == within for s in shares), shares


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # one ulp of TF32 above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      one + 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0, one, 1.0, -one, one + 2.0 ** -10],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
