"""The single-pass arms (`kernel_precision: bf16`) of the port's windowed,
fused CGConv, fused cfconv and CSR kernels against the JAX package's
kernels on the CPU.

The reference is each JAX function with hilo=False, run as the package's
own tests run it (interpret mode), under single_pass_oracle's emulation of
the TPU MXU's single pass: the data operand of every one-hot product
rounded to bf16 (single_pass_oracle.py says why the emulation is the TPU's
behaviour). The port's side is each entry point's plain twin with
single_pass=True, the version the autograd Functions run on the CPU and
the card's kernels are held to (tests/test_torch_cuda.py).

* Per entry point (the windowed sum, SpMM and gather; the CGConv forward,
  backward rows and weight gradient; the cfconv forward and backward
  rows; the CSR sum and gather): values and every gradient the custom VJP
  defines, within 1e-5 of max|ref|. Both sides round the same f32 values
  to bf16; what differs is the order of the f32 sums, and, in the fused
  ops, the f32 arithmetic that forms the rounded message, which can move a
  value by an ulp. That ulp tips a bf16 rounding only when the value lies
  within it of a bf16 midpoint (about 2⁻¹⁵ of values); the cases below
  hold none, and a tipped rounding would show as a gap near 2⁻⁹ of one
  term.
* The mutation check: the f32 twin (single_pass=False) misses that limit
  by at least 10× on every output whose rounded operand is not already a
  bf16 value, so the limit sees the rounding.
* Each case has masked edges (pad slots, and on the flat layout edges with
  mask 0) and a window of nodes no edge reaches; the "bf16" cases feed
  inputs that are bf16 values cast up, as under `precision: bf16`, where
  rounding a gathered or summed input is the identity and the twins of
  both arms agree on it exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.ops import pallas_csr as PC
from matdeeplearn_tpu.ops import pallas_fused as PF
from matdeeplearn_tpu.ops import pallas_fused_schnet as PFS
from matdeeplearn_tpu.ops import pallas_segment as PS
from matdeeplearn_torch.ops import csr
from matdeeplearn_torch.ops import fused_cfconv as FS
from matdeeplearn_torch.ops import fused_cgconv as FC
from matdeeplearn_torch.ops import windowed as WO
from single_pass_oracle import emulate_single_pass

LIMIT = 1e-5     # of max|ref|
MUTATION = 10.0  # the f32 twin misses the limit by at least this factor
N, D, TW, TE, DE, WIDTH, CUTOFF = 24, 16, 8, 16, 20, 0.2, 5.0
INPUTS = ["f32", "bf16"]


@pytest.fixture(scope="module")
def single_pass():
    """The emulation for the whole module: one jax.clear_caches() on entry
    and one on exit, so that the module's tests share their compiled
    operations."""
    with emulate_single_pass(pytest.MonkeyPatch()):
        yield


@functools.cache
def _jax(kind: str):
    """The JAX function of one entry point (hilo=False, interpret mode),
    jitted once for the module: the layout, the data and the cotangent are
    arguments, so the cases of both input kinds share one compile."""
    def cgconv_loss(x, xjw, wfi, wfj, wfe, bf, wsi, wsj, wse, bs, dist, we,
                    cot):
        cfg = (N, TW, TE, DE, WIDTH, True, False)
        out = PF.fused_cgconv(cfg, x, xjw, dist, we, wfi, wfj, wfe, bf, wsi,
                              wsj, wse, bs)
        return jnp.sum(out * cot), out

    def cfconv_loss(xjw, w0, b0, w1, b1, dist, wraw, we, cot):
        cfg = (N, TW, TE, DE, WIDTH, CUTOFF, True, False)
        out = PFS.fused_cfconv(cfg, xjw, dist, wraw, we, w0, b0, w1, b1)
        return jnp.sum(out * cot), out

    fns = {
        "sum": lambda m, w, we: PS.windowed_segment_sum(m, we, N, TW, TE,
                                                        True, False),
        "spmm": lambda m, w, we: PS.windowed_spmm(w, m, we, N, TW, TE, True,
                                                  False),
        "gather": lambda x, we: PS.windowed_gather(x, we, TW, TE, True,
                                                   False),
        "csr sum": lambda v, dst, mask: PC.sorted_segment_sum(
            v, dst, mask, N, 128, True, False),
        "csr gather": lambda v, dst, mask: PC.sorted_gather(
            v, dst, mask, N, 128, True, False),
        "cgconv": jax.value_and_grad(cgconv_loss, argnums=tuple(range(10)),
                                     has_aux=True),
        "cfconv": jax.value_and_grad(cfconv_loss, argnums=tuple(range(5)),
                                     has_aux=True),
    }
    return jax.jit(fns[kind])


def _round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _data(rng, shape, inputs, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return _round(a) if inputs == "bf16" else a


def _gap(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(name, got, ref, f32=None):
    """got within LIMIT of ref; the f32 twin's f32, if given, misses it by
    MUTATION or more."""
    gap = _gap(got, ref)
    assert gap <= LIMIT, f"{name}: {gap:.3g} of max|ref| (limit {LIMIT})"
    if f32 is not None:
        miss = _gap(f32, ref)
        assert miss >= MUTATION * LIMIT, (
            f"{name}: the f32 twin is {miss:.3g} of max|ref| from the "
            f"single-pass reference, inside {MUTATION}x the limit")


def _flat_edges(rng, e=96, pads=12):
    """A flat dst-sorted edge list over N nodes: nodes 16-23 (the third
    window of 8) receive no edge, every fifth real edge (from the third) and the last
    `pads` slots are masked (the pads at dst 0, as the port's batches
    hold them)."""
    dst = np.sort(rng.integers(0, 16, e - pads)).astype(np.int32)
    dst = np.concatenate([dst, np.zeros(pads, np.int32)])
    mask = np.ones(e, np.float32)
    mask[2::5] = 0.0
    mask[e - pads:] = 0.0
    return dst, mask


def _layout(dst, mask):
    """The JAX windowed layout of a flat edge list's real edges (which
    windowize_edges takes packed ahead of the pads) and, for each windowed
    slot, its edge's index in the flat list (0 on pad slots)."""
    keep = np.flatnonzero(mask > 0)
    comp = np.zeros(len(dst), np.int64)
    comp[:len(keep)] = keep
    cdst = np.zeros(len(dst), np.int32)
    cdst[:len(keep)] = dst[keep]
    cmask = (np.arange(len(dst)) < len(keep)).astype(np.float32)
    we = PS.windowize_edges(jnp.asarray(cdst), jnp.asarray(cmask), N, TW, TE)
    return we, comp[np.asarray(we.order)]


def _windowed(rng):
    """The JAX windowed layout of a flat edge list and the port's view of
    the same arrays."""
    we, _ = _layout(*_flat_edges(rng))
    twe = WO.WindowedEdges(*(torch.as_tensor(np.array(a)) for a in we))
    return we, twe


# ------------------------------------------------------------- windowed


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("op", ["sum", "spmm"])
def test_windowed_sum_arm_matches_jax(single_pass, op, inputs):
    """The windowed sum (rounds msg) and SpMM (rounds w·msg), forward and
    their VJPs (the rounding gather; d_w = Σ msg·gg)."""
    rng = np.random.default_rng(1)
    we, twe = _windowed(rng)
    ew = we.dst.shape[0]
    msg = _data(rng, (ew, D), inputs)
    w = rng.uniform(0.2, 1.5, ew).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)

    jfn = functools.partial(_jax(op), we=we)
    ref, vjp = jax.vjp(jfn, jnp.asarray(msg), jnp.asarray(w))
    d_msg, d_w = vjp(jnp.asarray(cot))

    def port(sp):
        m = torch.tensor(msg, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        if op == "sum":
            out = WO.windowed_segment_sum(m, twe, N, TW, sp)
        else:
            out = WO.windowed_spmm(wt, m, twe, N, TW, sp)
        (out * torch.as_tensor(cot)).sum().backward()
        return out.detach(), m.grad, wt.grad

    (out, gm, gw), (o32, gm32, gw32) = port(True), port(False)
    mutate = inputs == "f32" or op == "spmm"
    _check(f"{op} values", out, ref, o32 if mutate else None)
    # the VJP gathers g, which is f32 in every case
    _check(f"{op} d_msg", gm, d_msg, gm32)
    if op == "spmm":
        _check("spmm d_w", gw, d_w, gw32)
    if not mutate:  # bf16 messages: the rounding is the identity
        assert torch.equal(out, o32)


@pytest.mark.parametrize("inputs", INPUTS)
def test_windowed_gather_arm_matches_jax(single_pass, inputs):
    """The windowed gather (rounds the rows) and its VJP (the rounding
    sum); zero rows on pad slots."""
    rng = np.random.default_rng(2)
    we, twe = _windowed(rng)
    x = _data(rng, (N, D), inputs)
    cot = rng.standard_normal((we.dst.shape[0], D)).astype(np.float32)
    ref, vjp = jax.vjp(functools.partial(_jax("gather"), we=we),
                       jnp.asarray(x))
    (d_x,) = vjp(jnp.asarray(cot))

    def port(sp):
        xt = torch.tensor(x, requires_grad=True)
        out = WO.windowed_gather(xt, twe, TW, sp)
        (out * torch.as_tensor(cot)).sum().backward()
        return out.detach(), xt.grad

    (out, gx), (o32, gx32) = port(True), port(False)
    _check("gather values", out, ref, o32 if inputs == "f32" else None)
    _check("gather d_x", gx, d_x, gx32)
    assert not out.numpy()[np.asarray(we.valid) == 0].any()


# ------------------------------------------------------------------- CSR


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("op", ["sum", "gather"])
def test_csr_arm_matches_jax(single_pass, op, inputs):
    """The CSR sum (rounds msg·mask) and gather (rounds the rows), each
    with the other's rounding arm as its VJP; the arm no plan selects."""
    rng = np.random.default_rng(3)
    dst, mask = _flat_edges(rng)
    e = len(dst)
    if op == "sum":
        data = _data(rng, (e, D), inputs)
        cot = rng.standard_normal((N, D)).astype(np.float32)
        tfn = lambda v, sp: csr.sorted_segment_sum(
            v, torch.as_tensor(dst), torch.as_tensor(mask), N, sp)
    else:
        data = _data(rng, (N, D), inputs)
        cot = rng.standard_normal((e, D)).astype(np.float32)
        tfn = lambda v, sp: csr.sorted_gather(
            v, torch.as_tensor(dst), torch.as_tensor(mask), sp)
    jfn = functools.partial(_jax(f"csr {op}"), dst=jnp.asarray(dst),
                            mask=jnp.asarray(mask))
    ref, vjp = jax.vjp(jfn, jnp.asarray(data))
    (grad,) = vjp(jnp.asarray(cot))

    def port(sp):
        v = torch.tensor(data, requires_grad=True)
        out = tfn(v, sp)
        (out * torch.as_tensor(cot)).sum().backward()
        return out.detach(), v.grad

    (out, g), (o32, g32) = port(True), port(False)
    _check(f"csr {op} values", out, ref, o32 if inputs == "f32" else None)
    _check(f"csr {op} gradient", g, grad, g32)


# ------------------------------------------------------------ fused CGConv


def _cgconv_case(inputs):
    """Flat dst-sorted edges, x (N, D) and xj (E, D), the eight weight
    blocks and a cotangent; the JAX fused_cgconv's output and ten
    gradients under the emulation (the windowed layout of the same edges,
    d_xj mapped back through its order)."""
    rng = np.random.default_rng(4)
    dst, mask = _flat_edges(rng)
    e = len(dst)
    x = _data(rng, (N, D), inputs)
    xj = _data(rng, (e, D), inputs)
    dist = rng.random(e).astype(np.float32)
    shapes = [(D, D), (D, D), (DE, D), (1, D)] * 2
    params = [(0.3 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes]
    cot = rng.standard_normal((N, D)).astype(np.float32)
    we, order = _layout(dst, mask)
    valid = np.asarray(we.valid) > 0
    (_, out), grads = _jax("cgconv")(
        jnp.asarray(x), jnp.asarray(xj[order]), *map(jnp.asarray, params),
        jnp.asarray(dist[order]), we, jnp.asarray(cot))
    grads = [np.asarray(g) for g in grads]
    d_xj = np.zeros_like(xj)
    d_xj[order[valid]] = grads[1][valid]
    grads[1] = d_xj
    t = [torch.as_tensor(a) for a in (x, xj, dist, dst, mask)]
    return t, [torch.as_tensor(p) for p in params], torch.as_tensor(cot), \
        np.asarray(out), grads


@pytest.mark.parametrize("inputs", INPUTS)
def test_fused_cgconv_arm_matches_jax(single_pass, inputs):
    """The forward (x_i and the message rounded), the edge rows (d_x with
    g[dst] and d_x_i rounded, d_xj), the weight gradient's slices over the
    rounded x_i, summed, and the autograd Function's backward."""
    (x, xj, dist, dst, mask), ws, cot, ref, grads = _cgconv_case(inputs)
    args = (x, xj, dist, dst, mask, *ws, N, WIDTH)
    names = ["d_x", "d_xj", "wfi", "wfj", "wfe", "bf", "wsi", "wsj", "wse",
             "bs"]

    def stages(sp):
        out = FC.fused_cgconv(*args, single_pass=sp)
        d_x, d_xj, da = FC.fused_cgconv_bwd_rows(cot, *args, single_pass=sp)
        partial, s = FC.fused_cgconv_wgrad(*args[:5], da, N, DE, WIDTH, 3,
                                           single_pass=sp)
        dw = FC.wgrad_reduce(partial, s, D, DE)
        return [out, d_x, d_xj, *FC.unpack_weights(dw, D, ws[3].shape)]

    got, f32 = stages(True), stages(False)
    _check("cgconv forward", got[0], ref, f32[0])
    for name, a, a32, r in zip(names, got[1:], f32[1:], grads):
        # d_xj and the x_j, basis and bias blocks see only rounded g and
        # activations; every gradient moves under the arm
        _check(f"cgconv {name}", a, r, a32)
    leaves = [t.clone().requires_grad_(True) for t in (x, xj, *ws)]
    out = FC.FusedCGConv.apply(leaves[0], leaves[1], dist, dst, mask,
                               *leaves[2:], N, WIDTH, True)
    (out * cot).sum().backward()
    _check("cgconv autograd forward", out.detach(), ref)
    for name, leaf, r in zip(names, leaves, grads):
        _check(f"cgconv autograd {name}", leaf.grad, r)


# ------------------------------------------------------------- fused cfconv


@pytest.mark.parametrize("inputs", INPUTS)
def test_fused_cfconv_arm_matches_jax(single_pass, inputs):
    """The forward (the message xj·(w·c) rounded), the edge rows (g[dst]
    rounded: d_xj, and the rows a, dw, dpre the weight gradient reads, so
    that its f32 kernel gives the arm's weight gradients) and the autograd
    Function's backward."""
    rng = np.random.default_rng(5)
    dst, mask = _flat_edges(rng)
    e = len(dst)
    xj = _data(rng, (e, D), inputs)
    dist = rng.random(e).astype(np.float32)
    wraw = rng.uniform(1.0, CUTOFF, e).astype(np.float32)
    shapes = [(DE, D), (1, D), (D, D), (1, D)]
    params = [(0.4 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes]
    cot = rng.standard_normal((N, D)).astype(np.float32)
    we, order = _layout(dst, mask)
    valid = np.asarray(we.valid) > 0
    (_, ref), grads = _jax("cfconv")(
        jnp.asarray(xj[order]), *map(jnp.asarray, params),
        jnp.asarray(dist[order]), jnp.asarray(wraw[order]), we,
        jnp.asarray(cot))
    grads = [np.asarray(g) for g in grads]
    d_xj = np.zeros_like(xj)
    d_xj[order[valid]] = grads[0][valid]
    grads[0] = d_xj

    t = [torch.as_tensor(a) for a in (xj, dist, wraw, dst, mask)]
    ws = [torch.as_tensor(p) for p in params]
    args = (*t, *ws, N, WIDTH, CUTOFF)
    cot_t = torch.as_tensor(cot)
    names = ["d_xj", "w0", "b0", "w1", "b1"]

    def stages(sp):
        out = FS.fused_cfconv(*args, single_pass=sp)
        d, a, dw, dpre = FS.fused_cfconv_bwd_rows(cot_t, *args,
                                                  single_pass=sp)
        partial, s = FS.fused_cfconv_wgrad(t[1], t[2], t[3], t[4], a, dw,
                                           dpre, N, D, DE, WIDTH, CUTOFF, 3)
        dws = FS.split_wgrad(FS.wgrad_reduce(partial, s, D, DE), D, DE,
                             ws[1].shape, ws[3].shape)
        return [out, d, *dws]

    got, f32 = stages(True), stages(False)
    _check("cfconv forward", got[0], ref, f32[0])
    for name, a, a32, r in zip(names, got[1:], f32[1:], grads):
        _check(f"cfconv {name}", a, r, a32)
    leaves = [x.clone().requires_grad_(True) for x in (t[0], *ws)]
    out = FS.FusedCFConv.apply(leaves[0], *t[1:], *leaves[1:], N, WIDTH,
                               CUTOFF, True)
    (out * cot_t).sum().backward()
    _check("cfconv autograd forward", out.detach(), ref)
    for name, leaf, r in zip(names, leaves, grads):
        _check(f"cfconv autograd {name}", leaf.grad, r)
