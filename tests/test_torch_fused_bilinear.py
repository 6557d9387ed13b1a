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
* The bf16 arm (`bf16=True`, what `precision: bf16` runs) against the JAX
  `fused_bilinear_msg((te, True, True, True), ...)`, the chunked schedule
  with mxu_bf16, and its VJP. The port keeps every rounding point of the
  chunked schedule (the forward, d_xj, d_a, d_w1, d_b1) and agrees to the
  f32 tolerances above: the rounded products are exact, only f32 sums
  differ in order. d_xj rounds each unit's a_h·g to bf16 before its
  product with bf16(W_h)ᵀ, as the chunked kernel does; the formula the
  port took before (a·g exact) parts from it by more than 1e-5 and less
  than 2⁻⁸ (one bf16 rounding) of max|d_xj|, so the tolerance tells the
  two apart. The forward's bias term stays unrounded as in the chunked
  schedule, unlike the unit-loop one (which JAX's model tests run on the
  CPU): a test with a = 0 tells them apart. torch's bf16 rounding is to
  nearest with ties to even, not away as TF32's cvt.rna.
* The bf16 arm's kernel arithmetic emulated at MPNN_demo width, in the
  order of its bf16 tensor-core kernels: the forward unit after unit, each
  unit's D rows in k16-steps (zero-padded), sixteen exact bf16 products a
  step added to the f32 accumulator, then the bias unit in 3xTF32 over its
  k8-steps; the weight gradient over the 64-edge chunks (BF16_CHUNK) that
  hold a real edge, dealt to its splits (3 at this size on 132 SMs, and 1),
  four k16-steps a chunk; d_xj in the forward's order over (mask·g, a,
  W1ᵀ, b1ᵀ), and d_a as T_h = bf16(xj) @ bf16(W_h) in k16-steps, then each
  lane's fmaf chain of T_h against mask·g over its columns and the 4 lanes
  of a quad. It falls within the chip check's limit of the JAX chunked
  bf16 arm, and the f32 arm on the same inputs (the unrounded 3xTF32 path,
  which a build that skipped the rounding would run) falls outside it on
  every output: the limit tells the arms apart. The forward kernel's
  weight image (`weight_image_plain`, the layout kernels' plain twin) reads
  back to bf16(W1) and b1, and its transposed image to bf16(W1ᵀ) and b1ᵀ.
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


# ---------------------------------------------------------- the bf16 arm


def _jax_chunked_bf16(args, mask, cot, te):
    """JAX's chunked mxu_bf16 kernel (interpret mode) times the mask: the
    message and the VJP (d_xj, d_a, d_w1, d_b1), as numpy."""
    jm = jnp.asarray(mask)[:, None]
    out, vjp = jax.vjp(
        lambda *p: jm * fused_bilinear_msg((te, True, True, True), *p),
        *map(jnp.asarray, args))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("masked", [False, True], ids=["ones", "scattered"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_arm_matches_jax_chunked_where_it_keeps_its_points(case, masked):
    args, mask, cot = _inputs(case, masked)
    jout, jdxj, jda, jdw1, jdb1 = _jax_chunked_bf16(args, mask, cot,
                                                     CASES[case][4])
    t = [torch.as_tensor(v) for v in args]
    m, g = torch.as_tensor(mask), torch.as_tensor(cot)
    _close_fwd(FB.fused_bilinear(*t, m, bf16=True).numpy(), jout, "forward")
    d_xj, d_a, d_w1, d_b1 = FB.fused_bilinear_bwd(g, *t, m, bf16=True)
    for name, got, want in (("d_xj", d_xj, jdxj), ("d_a", d_a, jda),
                            ("d_w1", d_w1, jdw1), ("d_b1", d_b1, jdb1)):
        _close_grad(got.numpy(), want, name)
    # and the autograd Function carries the flag
    leaves = [v.clone().requires_grad_(True) for v in t]
    out = FB.FusedBilinear.apply(*leaves, m, True)
    (out * g).sum().backward()
    torch.testing.assert_close(out.detach(), FB.fused_bilinear_plain(
        *t, m, bf16=True), rtol=0, atol=0)
    torch.testing.assert_close(leaves[1].grad, d_a, rtol=0, atol=0)


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("case", ["e300", "d_ne_k"])
def test_bf16_arm_d_xj_takes_a_times_g_unrounded(case):
    """d_xj at the chunked schedule's point: the port's equals the JAX
    chunked VJP (which rounds a_h·g to bf16 before its product with
    bf16(W_h)ᵀ) to the gradient tolerance, and equals that formula in f64
    to 1e-5; the formula the port took before, a_h·g unrounded, parts from
    both by more than 1e-5 and less than 2⁻⁸ (one bf16 rounding) of
    max|d_xj|, so the tolerance tells the two apart."""
    (xj, a, w1, b1), mask, cot = _inputs(case, True)
    e, d, h, k, te = CASES[case]
    _, jdxj, *_ = _jax_chunked_bf16((xj, a, w1, b1), mask, cot, te)
    t = [torch.as_tensor(v) for v in (xj, a, w1, b1)]
    d_xj, _ = FB.fused_bilinear_bwd_rows(torch.as_tensor(cot), *t,
                                         torch.as_tensor(mask), bf16=True)
    _close_grad(d_xj.numpy(), jdxj, "d_xj")
    ge = (mask[:, None] * cot).astype(np.float64)
    w3 = _bf16(w1).reshape(h, d, k).astype(np.float64)
    bias = ge @ b1.reshape(d, k).T.astype(np.float64)
    unrounded = np.einsum("eh,ehd->ed", a,
                          np.einsum("ek,hdk->ehd", ge, w3)) + bias
    ag = _bf16((a[:, :, None] * (mask[:, None] * cot)[:, None, :])
               .astype(np.float32)).astype(np.float64)
    chunked = np.einsum("ehk,hdk->ed", ag, w3) + bias
    scale = float(np.abs(jdxj).max())
    np.testing.assert_allclose(d_xj.numpy(), chunked, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(jdxj, chunked, rtol=1e-5, atol=1e-5 * scale)
    gap = float(np.abs(unrounded - jdxj).max()) / scale
    assert 1e-5 < gap < 2.0 ** -8, gap


def test_bf16_arm_leaves_the_bias_term_unrounded_as_the_chunked_schedule():
    """With a = 0 the message is xj @ b1 alone: unrounded in the chunked
    schedule and in the port, bf16(xj) @ bf16(b1) in the unit loop."""
    (xj, a, w1, b1), mask, _ = _inputs("e300", False)
    a = np.zeros_like(a)
    chunked = np.asarray(fused_bilinear_msg((128, True, True, True),
                                            *map(jnp.asarray, (xj, a, w1, b1))))
    unit = np.asarray(fused_bilinear_msg((128, True, True),
                                         *map(jnp.asarray, (xj, a, w1, b1))))
    t = [torch.as_tensor(v) for v in (xj, a, w1, b1)]
    got = FB.fused_bilinear(*t, torch.as_tensor(mask), bf16=True).numpy()
    _close_fwd(got, chunked, "chunked")
    assert np.abs(got - unit).max() > 1e-3 * np.abs(unit).max()


def test_bf16_rounding_is_round_to_nearest_ties_to_even():
    one = 1.0 + 2.0 ** -7  # one bf16 unit above 1
    x = torch.tensor([1.0 + 2.0 ** -8, one + 2.0 ** -8, -(1.0 + 2.0 ** -8),
                      1.0 + 2.0 ** -9, 1.0 + 3 * 2.0 ** -9],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one + 2.0 ** -7, -1.0, 1.0, one],
                        dtype=torch.float32)
    assert torch.equal(FB.round_bf16(x), want)
    # ties away from zero (TF32's cvt.rna at bf16's width) would differ
    u = x.view(torch.int32)
    away = ((u + 0x8000) & ~0xFFFF).view(torch.float32)
    assert not torch.equal(away, want)
    np.testing.assert_array_equal(_bf16(x.numpy()), want.numpy())


def _mma_bf16(acc, a, b):
    """acc (f32) += a @ b for one wgmma k16-step of bf16 values: the 16
    products of each sum are exact, and the sum is added to the f32
    accumulator."""
    return (acc.double() + a.double() @ b.double()).float()


def _emulated_forward_bf16(xj, a, w1, b1, mask):
    """The bf16 forward kernel: unit after unit, each unit's D rows
    zero-padded to whole k16-steps, bf16(a_h·xj) @ bf16(W1[h]) one k16-step
    at a time into the f32 accumulator; then the bias unit xj @ b1 in
    3xTF32 over its k8-steps."""
    e, d = xj.shape
    h = a.shape[1]
    k = b1.numel() // d
    dp = 16 * -(-d // 16)
    xp = torch.zeros(e, dp)
    xp[:, :d] = xj
    w = torch.zeros(h, dp, k)
    w[:, :d] = FB.round_bf16(w1).reshape(h, d, k)
    bias = torch.zeros(dp, k)
    bias[:d] = b1.reshape(d, k)
    acc = torch.zeros(e, k)
    for u in range(h):
        x = FB.round_bf16(a[:, u:u + 1] * xp)
        for s0 in range(0, dp, 16):
            acc = _mma_bf16(acc, x[:, s0:s0 + 16], w[u, s0:s0 + 16])
    for s0 in range(0, dp, 8):
        acc = _mma(acc, xp[:, s0:s0 + 8], bias[s0:s0 + 8], 3)
    return mask[:, None] * acc


def _emulated_wgrad_bf16(g, xj, a, mask, splits: int):
    """The bf16 weight-gradient kernel: X (the bias unit too) and mask·g
    rounded; the BF16_CHUNK-edge chunks that hold a real edge dealt to the
    splits in turn, each chunk four k16-steps into the split's f32
    accumulator, then the splits added in order."""
    x = FB.round_bf16(_x_rows(xj, a))
    ge = FB.round_bf16(mask[:, None] * g)
    e = len(x)
    c = FB.BF16_CHUNK
    chunks = -(-e // c)
    pad = chunks * c - e
    x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    ge = torch.cat([ge, ge.new_zeros(pad, ge.shape[1])])
    live = [ch for ch in range(chunks) if mask[ch * c:(ch + 1) * c].any()]
    total = x.new_zeros(x.shape[1], g.shape[1])
    for s in range(splits):
        acc = torch.zeros_like(total)
        for ch in live[s::splits]:
            for e0 in range(ch * c, (ch + 1) * c, 16):
                acc = _mma_bf16(acc, x[e0:e0 + 16].t(), ge[e0:e0 + 16])
        total = total + acc
    return total


@pytest.mark.parametrize("h,d,k,pad", [(3, 4, 5, 0), (7, 3, 8, 9),
                                       (1, 33, 9, 1), (2, 100, 100, 2)])
def test_bf16_weight_image_rebuilds_w(h, d, k, pad):
    """The bf16 forward's weight image (weight_image_plain, the plain twin
    of its layout kernels): read back through the core-matrix permutation,
    its bf16 tiles give bf16(W1) exactly, zeros past D and K and in `pad`
    padding k16-steps, and its TF32 hi + lo words give b1 to 2^-20 of
    max|b1|."""
    rng = np.random.default_rng(h + d + k)
    w1 = torch.tensor(rng.standard_normal((h, d * k)), dtype=torch.float32)
    b1 = torch.tensor(rng.standard_normal(d * k), dtype=torch.float32)
    kd, n8 = -(-d // 16), FB.wgmma_width(k)
    np_, steps = 8 * n8, h * kd + pad
    img = FB.weight_image_plain(w1, b1, d, steps)
    assert img.dtype == torch.uint8
    assert img.numel() == steps * np_ * 32 + kd * np_ * 128
    tiles = img[:steps * np_ * 32].view(torch.int16).reshape(steps, n8, 2, 8, 8)
    # (step, n8, kh, r, c) -> (step, kh, c, n8, r): rows d, columns n
    w = tiles.permute(0, 2, 4, 1, 3).reshape(steps * 16, np_)
    w = w.view(torch.bfloat16).float()
    units = w[:h * kd * 16].reshape(h, 16 * kd, np_)
    assert torch.equal(units[:, :d, :k], FB.round_bf16(w1).reshape(h, d, k))
    assert not units[:, d:].any() and not units[:, :, k:].any()
    assert not w[h * kd * 16:].any()
    words = img[steps * np_ * 32:].view(torch.int32).reshape(2 * kd, 2, n8, 2,
                                                            8, 4)
    hi, lo = (words[:, i].view(torch.float32).double() for i in (0, 1))
    # (t, n8, kh, r, c) -> (t, kh, c, n8, r): positions, columns
    part = (hi + lo).permute(0, 2, 4, 1, 3).reshape(2 * kd, 8, np_)
    cols = torch.zeros_like(part)
    cols[:, [0, 2, 4, 6, 1, 3, 5, 7]] = part  # position c holds row pair_col(c)
    bias = cols.reshape(16 * kd, np_)
    ref = b1.reshape(d, k).double()
    assert (bias[:d, :k] - ref).abs().max() <= 2.0 ** -20 * ref.abs().max()
    assert not bias[d:].any() and not bias[:, k:].any()


@pytest.mark.parametrize("h,d,k", [(3, 4, 5), (2, 100, 100), (1, 33, 9)])
def test_transposed_weight_swaps_each_units_rows_and_columns(h, d, k):
    """W1ᵀ[h, n·D + d] = W1[h, d·K + n] and b1ᵀ[n·D + d] = b1[d·K + n]: the
    weight of widths (K, D) whose forward over g is d_xj; its image
    (transposed=True, what the layout kernels write reading W1 in place) is
    the image of that weight."""
    rng = np.random.default_rng(h * d + k)
    w1 = torch.tensor(rng.standard_normal((h, d * k)), dtype=torch.float32)
    b1 = torch.tensor(rng.standard_normal(d * k), dtype=torch.float32)
    w1t, b1t = FB.transposed_weight(w1, b1, d)
    assert w1t.shape == (h, k * d) and b1t.shape == (k * d,)
    for dd in range(d):
        for n in range(k):
            assert torch.equal(w1t[:, n * d + dd], w1[:, dd * k + n])
            assert b1t[n * d + dd] == b1[dd * k + n]
    assert torch.equal(FB.weight_image_plain(w1, b1, d, transposed=True),
                       FB.weight_image_plain(w1t, b1t, k))


@pytest.fixture(scope="module")
def mpnn_width_bf16(mpnn_width):
    """mpnn_width's inputs through the JAX chunked kernel's bf16 arm."""
    (xj, a, w1, b1, mask, cot), *_ = mpnn_width
    ref = _jax_chunked_bf16([v.numpy() for v in (xj, a, w1, b1)],
                            mask.numpy(), cot.numpy(), 128)
    return (xj, a, w1, b1, mask, cot), ref


def test_emulated_bf16_forward_within_the_chip_limit_and_f32_outside(
        mpnn_width_bf16):
    (xj, a, w1, b1, mask, _), (out, *_) = mpnn_width_bf16
    got = _emulated_forward_bf16(xj, a, w1, b1, mask)
    assert (got[mask == 0] == 0).all()
    assert _limit_share(got, out) < 1.0
    assert _limit_share(FB.fused_bilinear_plain(xj, a, w1, b1, mask), out) > 1.0


@pytest.mark.parametrize("splits", [1, 3])
def test_emulated_bf16_wgrad_within_the_chip_limit_and_f32_outside(
        mpnn_width_bf16, splits):
    (xj, a, w1, b1, mask, cot), (_, _, _, d_w1, d_b1) = mpnn_width_bf16
    dw = _emulated_wgrad_bf16(cot, xj, a, mask, splits)
    got = FB.split_wgrad(dw, w1.shape, b1.shape)
    assert all(_limit_share(x, r) < 1.0 for x, r in zip(got, (d_w1, d_b1)))
    f32 = FB.split_wgrad(FB.wgrad_plain(cot, xj, a, mask, 100),
                         w1.shape, b1.shape)
    assert all(_limit_share(x, r) > 1.0 for x, r in zip(f32, (d_w1, d_b1)))


def _emulated_bwd_a_bf16(g, xj, w1, mask):
    """The bf16 d_a kernel: T_h = bf16(xj) @ bf16(W_h) one k16-step at a
    time into the f32 accumulator (D zero-padded to whole steps, K to the
    wgmma width), then each lane's fmaf chain of T_h against mask·g over
    its columns 8 j + 2 t and 8 j + 2 t + 1 (t = lane % 4), and the quad's
    4 lanes as (v0 + v1) + (v2 + v3). Masked rows stay zero."""
    e, d = xj.shape
    h = w1.shape[0]
    k = w1.shape[1] // d
    dp, kp = 16 * -(-d // 16), 8 * FB.wgmma_width(k)
    xd = torch.zeros(e, dp)
    xd[:, :d] = FB.round_bf16(xj)
    w = torch.zeros(h, dp, kp)
    w[:, :d, :k] = FB.round_bf16(w1).reshape(h, d, k)
    ge = torch.zeros(e, kp)
    ge[:, :k] = mask[:, None] * g
    lanes = [[c for j in range(kp // 8) for c in (8 * j + 2 * t, 8 * j + 2 * t + 1)]
             for t in range(4)]
    d_a = torch.zeros(e, h)
    for u in range(h):
        acc = torch.zeros(e, kp)
        for s0 in range(0, dp, 16):
            acc = _mma_bf16(acc, xd[:, s0:s0 + 16], w[u, s0:s0 + 16])
        v = []
        for cols in lanes:
            dot = torch.zeros(e)
            for c in cols:
                dot = _fma(acc[:, c], ge[:, c], dot)
            v.append(dot)
        d_a[:, u] = (v[0] + v[1]) + (v[2] + v[3])
    d_a[mask == 0] = 0
    return d_a


def test_emulated_bf16_bwd_rows_within_the_chip_limit_and_f32_outside(
        mpnn_width_bf16):
    """The backward to the rows' bf16 arm in its kernels' order: d_xj as
    the bf16 forward over (mask·g, a, W1ᵀ, b1ᵀ), d_a as
    _emulated_bwd_a_bf16. Both within the limit of the chunked arm; the
    f32 arm on the same inputs outside it."""
    (xj, a, w1, b1, mask, cot), (_, d_xj, d_a, *_) = mpnn_width_bf16
    got = (_emulated_forward_bf16(cot * mask[:, None], a,
                                  *FB.transposed_weight(w1, b1, 100), mask),
           _emulated_bwd_a_bf16(cot, xj, w1, mask))
    for x, r in zip(got, (d_xj, d_a)):
        assert x.shape == r.shape
        assert (x[mask == 0] == 0).all()
        assert _limit_share(x, r) < 1.0
    f32 = FB.bwd_rows_plain(cot, xj, a, w1, b1, mask)
    assert all(_limit_share(x, r) > 1.0 for x, r in zip(f32, (d_xj, d_a)))
