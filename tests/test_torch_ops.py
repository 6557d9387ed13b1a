"""PyTorch port ops vs the JAX package on the CPU: Gaussian basis, masked
segment ops, and the CSR segment-sum/gather (forward and gradient).

The JAX CSR ops run their Pallas kernels in interpret mode (te=128), as
tests/test_csr.py does. The port's wrappers take their plain PyTorch
versions here because the tensors lie on the CPU; tests/test_torch_cuda.py
compares the hand-written kernels with those plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.ops import segment as jseg
from matdeeplearn_tpu.ops.edge_basis import gaussian_basis as j_gaussian_basis
from matdeeplearn_tpu.ops.pallas_csr import sorted_gather, sorted_segment_sum
from matdeeplearn_torch.ops import csr
from matdeeplearn_torch.ops import segment as tseg
from matdeeplearn_torch.ops.edge_basis import gaussian_basis

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(rng, case, d, n_real=150, n=256, pad_to=1152):
    """Hole-free dst with per-node runs (the self-loop invariant) + tail
    pads at dst 0. case: "sorted" | "unsorted" (real edges permuted) |
    "nomask" (real edges only, mask None)."""
    deg = rng.integers(1, 9, n_real)
    dst = np.repeat(np.arange(n_real), deg).astype(np.int32)
    e_real = len(dst)
    if case == "unsorted":
        dst = dst[rng.permutation(e_real)]
    if case == "nomask":
        return dst, None, e_real, n
    dstp = np.concatenate([dst, np.zeros(pad_to - e_real, np.int32)])
    mask = np.zeros(pad_to, np.float32)
    mask[:e_real] = 1.0
    return dstp, mask, e_real, n


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_gaussian_basis_parity():
    rng = np.random.default_rng(0)
    dist = rng.random(500).astype(np.float32)
    ref = np.asarray(j_gaussian_basis(jnp.asarray(dist), 0.0, 1.0, 50, 0.2))
    out = gaussian_basis(torch.as_tensor(dist), 0.0, 1.0, 50, 0.2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "count", "mean", "max"])
def test_masked_segment_ops_parity(op):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 12, 200).astype(np.int32)
    ids[:5] = 11  # segment 10 stays empty: 0 for every op
    ids[ids == 10] = 3
    vals = rng.standard_normal((200, 7)).astype(np.float32)
    mask = (rng.random(200) > 0.3).astype(np.float32)
    jfn = {"sum": jseg.segment_sum, "mean": jseg.segment_mean,
           "max": jseg.segment_max}
    tfn = {"sum": tseg.segment_sum, "mean": tseg.segment_mean,
           "max": tseg.segment_max}
    if op == "count":
        ref = jseg.segment_count(jnp.asarray(ids), 12, jnp.asarray(mask))
        out = tseg.segment_count(torch.as_tensor(ids).long(), 12,
                                 torch.as_tensor(mask))
    else:
        ref = jfn[op](jnp.asarray(vals), jnp.asarray(ids), 12, jnp.asarray(mask))
        out = tfn[op](torch.as_tensor(vals), torch.as_tensor(ids).long(), 12,
                      torch.as_tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "nomask"])
@pytest.mark.parametrize("d", [1, 24, 100, 150])
def test_csr_segment_sum_parity(case, d):
    rng = np.random.default_rng(d)
    dst, mask, _, n = _problem(rng, case, d)
    msg = rng.standard_normal((len(dst), d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)

    ref = sorted_segment_sum(jnp.asarray(msg), jnp.asarray(dst), _j(mask), n,
                             128, True, True)
    gref = jax.grad(lambda m: jnp.sum(sorted_segment_sum(
        m, jnp.asarray(dst), _j(mask), n, 128, True, True) * cot))(
            jnp.asarray(msg))

    m = torch.tensor(msg, requires_grad=True)
    out = csr.sorted_segment_sum(m, torch.as_tensor(dst), _t(mask), n)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(gref), **TOL)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "nomask"])
@pytest.mark.parametrize("d", [1, 24, 100, 150])
def test_csr_gather_parity(case, d):
    rng = np.random.default_rng(100 + d)
    dst, mask, _, n = _problem(rng, case, d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((len(dst), d)).astype(np.float32)

    ref = sorted_gather(jnp.asarray(x), jnp.asarray(dst), _j(mask), n, 128,
                        True, True)
    gref = jax.grad(lambda v: jnp.sum(sorted_gather(
        v, jnp.asarray(dst), _j(mask), n, 128, True, True) * cot))(
            jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    out = csr.sorted_gather(xt, torch.as_tensor(dst), _t(mask))
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), **TOL)


def test_cpu_tensors_take_plain_versions():
    """CPU tensors never reach the kernel: no launch is counted."""
    rng = np.random.default_rng(3)
    dst, mask, _, n = _problem(rng, "sorted", 8)
    before = dict(csr.LAUNCHES)
    x = torch.as_tensor(rng.standard_normal((n, 8)).astype(np.float32))
    g = csr.gather(x, torch.as_tensor(dst), torch.as_tensor(mask))
    csr.segment_sum(g, torch.as_tensor(dst), torch.as_tensor(mask), n)
    assert csr.LAUNCHES == before
