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
* The layout of the kernels' weight [W1; b1] and its gradient.
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
