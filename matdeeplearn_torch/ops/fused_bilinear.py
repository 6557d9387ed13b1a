"""NNConv's bilinear edge message in hand-written CUDA kernels, forward and
backward.

The kernels in csrc/fused_bilinear.cu replace the reference package's
ops/pallas_bilinear.py:_fwd_kernel and :_fwd_kernel_chunked (forward) and
:_bwd_kernel and :_bwd_kernel_chunked (backward): two TPU schedules of one
function, served here by one kernel each way. The function is that
package's `fused_bilinear_msg` (:438-462) times the edge mask:

  fused_bilinear(xj, a, w1, b1, mask)[e]
    = mask[e] · (Σ_h a[e,h]·(xj[e] @ W1[h]) + xj[e] @ b1)
    = mask[e] · xj[e] @ reshape(a[e] @ w1 + b1, (D, K))

xj (E, D) pre-gathered x[src]; a (E, H) the edge network's hidden layer;
w1 (H, D·K) its second layer in (in, out) layout and b1 (D·K,) that
layer's bias, with the flat index d·K + k; mask (E,) float32 (pad edges
0). It returns (E, K) float32. A row whose mask is 0 is exactly zero, and
so are its d_xj and d_a rows; it adds nothing to d_w1 or d_b1. The
reference function takes no mask, but its caller multiplies the messages
by it before the sum, so its cotangent is zero on pad rows there too.

With X[e, h·D + d] = [a | 1][e, h]·xj[e, d] over the flat reduction of
(H+1)·D rows, the message is mask·(X @ [W1; b1]) and the weight gradient
Xᵀ·(mask·g): two GEMMs with a generated operand. With U = (mask·g) @
[W1; b1]ᵀ cut into the H+1 units of D columns, d_xj = Σ_h [a | 1][:, h]·U_h
and d_a[:, h] = rowsum(xj·U_h). All three kernels run on the tensor cores
in 3xTF32 (f32 accuracy): the forward (`mma.sync`) over 128-edge tiles
against [W1; b1] padded to a multiple of FWD_CHUNK rows and round8(K)
columns (`padded_weight`); the weight gradient (`mma.sync`) over the 32-edge
chunks that hold a real edge, split into S partials (S from the SM count)
that a second kernel sums in a fixed order; the backward to the rows
(`wgmma`) over 128-edge tiles (64 for D > 104) whose mask·g is the A operand
of every unit, against [W1; b1] split once a call into TF32 hi and lo in
the layout its B descriptors read, folding each unit's U into d_xj and d_a
as it leaves the tensor cores. No atomics: d_xj, d_a, d_w1 and d_b1 are
bit-identical from run to run.
csrc/fused_bilinear.cu gives the tile sizes and bounds.

`bf16=True` is the arm `precision: bf16` runs (the reference's
`mxu_bf16`, which its NNConv turns on for bf16 activations): the heavy
products take operands rounded to bf16, to nearest with ties to even, and
accumulate in f32, at the rounding points of the reference's chunked
schedules (:_fwd_kernel_chunked, :_bwd_kernel_chunked), which are what its
TPU compiles, except one:

  * forward: bf16(a·xj) @ bf16(W1), plus xj @ b1 unrounded (:255, :272);
  * weight gradient: bf16(X)ᵀ bf16(mask·g), the bias unit too: d_b1 =
    bf16(xj)ᵀ bf16(mask·g) (:161, :207);
  * d_a[:, h] = bf16(xj) · (g @ bf16(W1[h])ᵀ), g unrounded (:191-197);
  * d_xj = Σ_h a_h·(g @ bf16(W1[h])ᵀ) + g @ b1ᵀ: the one point not
    followed. The reference rounds each unit's product a_h·g to bf16
    before its contraction (:216); the backward here folds one U_h =
    (mask·g) @ W_hᵀ into both d_xj and d_a, so a·g is never formed, and
    it takes the exact a_h·U_h instead. tests/test_torch_fused_bilinear.py
    pins every point and the size of this deviation.

Products of bf16 values are exact in f32 (and in TF32), so each arm is
exact up to the order of its f32 sums; the arms' plain versions compute
them in f32 over the rounded operands.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches, `LAUNCHES_BF16` those of the bf16 arm. The backward launches two wrappers:
`fused_bilinear_bwd` (d_xj and d_a) and `fused_bilinear_wgrad` (d_w1 and
d_b1). FusedBilinear saves its inputs alone and recomputes in the
backward.
"""

from __future__ import annotations

import ctypes

import torch

from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import _check_cuda, _raise_on, round_bf16

LAUNCHES = {"fused_bilinear_fwd": 0, "fused_bilinear_bwd": 0,
            "fused_bilinear_wgrad": 0}
# the bf16 arm's launches, counted apart
LAUNCHES_BF16 = {"fused_bilinear_fwd_bf16": 0, "fused_bilinear_bwd_bf16": 0,
                 "fused_bilinear_wgrad_bf16": 0}
MAX_WIDTH = 256  # the kernels' largest D and K
FWD_CHUNK = 32   # flat rows of [W1; b1] a forward chunk stages (csrc kFK)
WGRAD_CHUNK = 32  # edges of a weight-gradient chunk (csrc kWK)
# The plain versions' largest per-edge intermediate ((rows, D·K) or
# (rows, (H+1)·D)): 2^26 floats, 256 MB. A training batch's whole (E, D, K)
# tensor at MPNN_demo width would be 3.2 GB.
_CHUNK_FLOATS = 1 << 26

_lib = None


def _load():
    """The bound library of csrc/fused_bilinear.cu (ops/_build.py); the
    last int of the three kernels and of the splits query selects the bf16
    arm."""
    global _lib
    if _lib is None:
        lib = _build.library("fused_bilinear")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mdl_fused_bilinear_fwd.argtypes = [vp] * 5 + [cl, ci, ci, ci, ci,
                                                          vp]
        lib.mdl_fused_bilinear_fwd.restype = ci
        lib.mdl_fused_bilinear_bwd.argtypes = [vp] * 8 + [cl, ci, ci, ci, ci,
                                                          vp]
        lib.mdl_fused_bilinear_bwd.restype = ci
        lib.mdl_fused_bilinear_wgrad.argtypes = ([vp] * 7
                                                 + [cl, ci, ci, ci, ci, ci, vp])
        lib.mdl_fused_bilinear_wgrad.restype = ci
        lib.mdl_fused_bilinear_split_words.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_split_words.restype = cl
        lib.mdl_fused_bilinear_partial_floats.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_partial_floats.restype = cl
        lib.mdl_fused_bilinear_wgrad_splits.argtypes = [cl, ci, ci, ci, ci]
        lib.mdl_fused_bilinear_wgrad_splits.restype = ci
        _lib = lib
    return _lib


def _count(name: str, bf16: bool):
    if bf16:
        LAUNCHES_BF16[name + "_bf16"] += 1
    else:
        LAUNCHES[name] += 1


def _dims(xj, a, b1) -> tuple[int, int, int, int]:
    """(E, D, H, K)."""
    e, d = xj.shape
    return e, d, a.shape[1], b1.numel() // d


def extend_weight(w1, b1, d: int) -> torch.Tensor:
    """The kernels' ((H+1)·D, K) weight [W1; b1]: unit h is rows h·D to
    h·D + D - 1, and the bias is unit H."""
    k = b1.numel() // d
    return torch.cat([w1.reshape(-1, k), b1.reshape(d, k)], 0).contiguous()


def padded_weight(w1, b1, d: int) -> torch.Tensor:
    """The forward kernel's weight: extend_weight's ((H+1)·D, K) rows,
    zero-padded to a multiple of FWD_CHUNK rows and to round8(K) columns,
    so every chunk is whole 16-byte rows."""
    w = extend_weight(w1, b1, d)
    rows, k = w.shape
    rp = -(-rows // FWD_CHUNK) * FWD_CHUNK
    wp = w.new_zeros((rp, -(-k // 8) * 8))
    wp[:rows, :k] = w
    return wp


def split_wgrad(dw: torch.Tensor, w1_shape, b1_shape) -> tuple:
    """(d_w1, d_b1) out of the ((H+1)·D, K) gradient of [W1; b1]."""
    hd = w1_shape[0] * (dw.shape[0] // (w1_shape[0] + 1))  # H·D
    return dw[:hd].reshape(w1_shape), dw[hd:].reshape(b1_shape)


def _chunks(e: int, width: int) -> list[slice]:
    step = max(1, _CHUNK_FLOATS // max(width, 1))
    return [slice(s, min(e, s + step)) for s in range(0, e, step)]


def _with_bias_unit(a) -> torch.Tensor:
    """[a | 1]: the bias as unit H."""
    return torch.cat([a, torch.ones_like(a[:, :1])], 1)


def arm_weight(w1, bf16: bool) -> torch.Tensor:
    """W1 as the bf16 arm reads it (rounded to bf16; b1 never is), or
    W1 itself."""
    return round_bf16(w1) if bf16 else w1


# ------------------------------------------------------------- plain versions


def fused_bilinear_plain(xj, a, w1, b1, mask, bf16: bool = False):
    """Plain PyTorch version: the reference's `_reference_compose` times
    the mask, in chunks of edges; the bf16 arm as X @ [W1; b1] over the
    rounded products bf16(a·xj) and bf16(W1), the bias unit unrounded."""
    e, d, h, k = _dims(xj, a, b1)
    out = torch.empty((e, k), dtype=xj.dtype, device=xj.device)
    if bf16:
        w1r = round_bf16(w1).reshape(h * d, k)
        for sl in _chunks(e, h * d):
            x = round_bf16(a[sl][:, :, None] * xj[sl][:, None, :])
            out[sl] = x.reshape(-1, h * d) @ w1r + xj[sl] @ b1.reshape(d, k)
        return out * mask[:, None]
    for sl in _chunks(e, d * k):
        w_e = (a[sl] @ w1 + b1.reshape(-1)).reshape(-1, d, k)
        out[sl] = torch.einsum("ed,edk->ek", xj[sl], w_e)
    return out * mask[:, None]


def bwd_rows_plain(g, xj, a, w1, b1, mask, bf16: bool = False) -> tuple:
    """Plain (d_xj, d_a): with ge = mask·g and U[e, h] = ge[e] @ W[h]ᵀ
    over the units of [W1; b1], d_xj = Σ_h [a | 1][e, h]·U[e, h] and
    d_a[e, h] = xj[e] · U[e, h]. The bf16 arm takes W1 and, in d_a, xj
    rounded to bf16 (ge and the bias unit unrounded)."""
    e, d, h, _ = _dims(xj, a, b1)
    ge = g * mask[:, None]
    wt = extend_weight(arm_weight(w1, bf16), b1, d).t()
    xd = round_bf16(xj) if bf16 else xj
    d_xj, d_a = torch.empty_like(xj), torch.empty_like(a)
    for sl in _chunks(e, (h + 1) * d):
        u = (ge[sl] @ wt).reshape(-1, h + 1, d)
        d_xj[sl] = torch.einsum("eh,ehd->ed", _with_bias_unit(a[sl]), u)
        d_a[sl] = torch.einsum("ed,ehd->eh", xd[sl], u[:, :h])
    return d_xj, d_a


def wgrad_plain(g, xj, a, mask, k: int, bf16: bool = False) -> torch.Tensor:
    """Plain gradient of [W1; b1], ((H+1)·D, K): Xᵀ (mask·g) with
    X[e, h·D + d] = [a | 1][e, h]·xj[e, d]; the bf16 arm rounds X (the
    bias unit too) and mask·g to bf16."""
    e, d = xj.shape
    h = a.shape[1]
    ge = g * mask[:, None]
    if bf16:
        ge = round_bf16(ge)
    dw = torch.zeros(((h + 1) * d, k), dtype=xj.dtype, device=xj.device)
    for sl in _chunks(e, (h + 1) * d):
        x = (_with_bias_unit(a[sl])[:, :, None] * xj[sl][:, None, :])
        if bf16:
            x = round_bf16(x)
        dw += x.reshape(-1, (h + 1) * d).t() @ ge[sl]
    return dw


def fused_bilinear_bwd_plain(g, xj, a, w1, b1, mask, bf16: bool = False
                             ) -> tuple:
    """Plain backward: (d_xj, d_a, d_w1, d_b1)."""
    d_xj, d_a = bwd_rows_plain(g, xj, a, w1, b1, mask, bf16)
    dw = wgrad_plain(g, xj, a, mask, b1.numel() // xj.shape[1], bf16)
    return (d_xj, d_a, *split_wgrad(dw, w1.shape, b1.shape))


# ------------------------------------------------------------------ wrappers


def _check_inputs(xj, a, mask, w1=None, b1=None, g=None):
    _check_cuda("xj", xj, torch.float32, 2)
    _check_cuda("a", a, torch.float32, 2)
    _check_cuda("mask", mask, torch.float32, 1)
    e, d = xj.shape
    h = a.shape[1]
    ts = [xj, a, mask]
    bad = a.shape[0] != e or mask.shape[0] != e or d == 0
    if w1 is not None:
        k = b1.numel() // max(d, 1)
        bad = bad or b1.numel() != d * k or tuple(w1.shape) != (h, d * k)
        ts += [w1, b1]
    if g is not None:
        _check_cuda("g", g, torch.float32, 2)
        bad = bad or g.shape[0] != e
        ts.append(g)
    if bad:
        raise ValueError(
            f"fused_bilinear: inconsistent shapes xj {tuple(xj.shape)}, a "
            f"{tuple(a.shape)}, mask {tuple(mask.shape)}"
            + ("" if w1 is None else f", w1 {tuple(w1.shape)}, b1 "
               f"{tuple(b1.shape)}")
            + ("" if g is None else f", g {tuple(g.shape)}"))
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("fused_bilinear: every tensor must be float32")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"fused_bilinear: tensors on several devices {devs}")


def _check_widths(d: int, k: int):
    if d > MAX_WIDTH or k > MAX_WIDTH:
        raise ValueError(f"fused_bilinear: D={d}, K={k}: wider than the "
                         f"kernels' {MAX_WIDTH}")


def fused_bilinear(xj, a, w1, b1, mask, bf16: bool = False) -> torch.Tensor:
    """(E, K) f32 messages mask[e]·xj[e] @ reshape(a[e] @ w1 + b1, (D, K));
    bf16 runs the bf16 arm."""
    if xj.device.type == "cpu":
        return fused_bilinear_plain(xj, a, w1, b1, mask, bf16)
    _check_inputs(xj, a, mask, w1, b1)
    e, d, h, k = _dims(xj, a, b1)
    _check_widths(d, k)
    out = torch.zeros((e, k), dtype=torch.float32, device=xj.device)
    if e == 0 or k == 0:
        return out
    w = padded_weight(arm_weight(w1, bf16), b1, d)
    lib = _load()
    with torch.cuda.device(xj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_bilinear_fwd(xj.data_ptr(), a.data_ptr(),
                                        w.data_ptr(), mask.data_ptr(),
                                        out.data_ptr(), e, d, k, h, int(bf16),
                                        stream)
    _raise_on(rc, "mdl_fused_bilinear_fwd")
    _count("fused_bilinear_fwd", bf16)
    return out


def fused_bilinear_bwd_rows(g, xj, a, w1, b1, mask, bf16: bool = False
                            ) -> tuple:
    """(d_xj, d_a) for the cotangent g: the backward kernel (its bf16 arm
    with bf16)."""
    if xj.device.type == "cpu":
        return bwd_rows_plain(g, xj, a, w1, b1, mask, bf16)
    _check_inputs(xj, a, mask, w1, b1, g)
    e, d, h, k = _dims(xj, a, b1)
    _check_widths(d, k)
    if g.shape[1] != k:
        raise ValueError(f"fused_bilinear_bwd: g {tuple(g.shape)} must be "
                         f"({e}, {k})")
    d_xj = torch.zeros_like(xj)
    d_a = torch.zeros_like(a)
    if e == 0 or k == 0:
        return d_xj, d_a
    w = extend_weight(arm_weight(w1, bf16), b1, d)
    lib = _load()
    # the kernel's TF32 hi/lo split of w, in the order its tiles read it
    ws = torch.empty(lib.mdl_fused_bilinear_split_words(d, k, h),
                     dtype=torch.int32, device=xj.device)
    with torch.cuda.device(xj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_bilinear_bwd(xj.data_ptr(), a.data_ptr(),
                                        w.data_ptr(), ws.data_ptr(),
                                        mask.data_ptr(), g.data_ptr(),
                                        d_xj.data_ptr(), d_a.data_ptr(), e, d,
                                        k, h, int(bf16), stream)
    _raise_on(rc, "mdl_fused_bilinear_bwd")
    _count("fused_bilinear_bwd", bf16)
    return d_xj, d_a


def fused_bilinear_wgrad(g, xj, a, mask, bf16: bool = False) -> torch.Tensor:
    """The ((H+1)·D, K) gradient of [W1; b1] for the cotangent g (E, K):
    the weight-gradient kernel (its bf16 arm with bf16) and its
    fixed-order sum of the splits, bit-identical from run to run on one
    card."""
    if xj.device.type == "cpu":
        return wgrad_plain(g, xj, a, mask, g.shape[1], bf16)
    _check_inputs(xj, a, mask, g=g)
    e, d = xj.shape
    h, k = a.shape[1], g.shape[1]
    _check_widths(d, k)
    dev = xj.device
    if e == 0 or k == 0:
        return torch.zeros(((h + 1) * d, k), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        splits = lib.mdl_fused_bilinear_wgrad_splits(e, d, k, h, int(bf16))
    if splits < 1:
        _raise_on(-splits, "mdl_fused_bilinear_wgrad_splits")
    partial = torch.empty(splits * lib.mdl_fused_bilinear_partial_floats(d, k, h),
                          dtype=torch.float32, device=dev)
    live = torch.empty(1 + -(-e // WGRAD_CHUNK), dtype=torch.int32, device=dev)
    dw = torch.empty(((h + 1) * d, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_bilinear_wgrad(
            xj.data_ptr(), a.data_ptr(), mask.data_ptr(), g.data_ptr(),
            live.data_ptr(), partial.data_ptr(), dw.data_ptr(), e, d, k, h,
            splits, int(bf16), stream)
    _raise_on(rc, "mdl_fused_bilinear_wgrad")
    _count("fused_bilinear_wgrad", bf16)
    return dw


def fused_bilinear_bwd(g, xj, a, w1, b1, mask, bf16: bool = False) -> tuple:
    """Gradients of fused_bilinear for the output cotangent g: (d_xj, d_a,
    d_w1, d_b1). Each of the two wrappers it calls dispatches by device."""
    d_xj, d_a = fused_bilinear_bwd_rows(g, xj, a, w1, b1, mask, bf16)
    dw = fused_bilinear_wgrad(g, xj, a, mask, bf16)
    return (d_xj, d_a, *split_wgrad(dw, w1.shape, b1.shape))


# ------------------------------------------------------------------ autograd


class FusedBilinear(torch.autograd.Function):
    """fused_bilinear with the backward kernels as its backward; no
    gradient for the mask. apply(xj, a, w1, b1, mask, bf16=False)."""

    @staticmethod
    def forward(ctx, xj, a, w1, b1, mask, bf16=False):
        ctx.save_for_backward(xj, a, w1, b1, mask)
        ctx.bf16 = bool(bf16)
        return fused_bilinear(xj.contiguous(), a.contiguous(), w1, b1, mask,
                              ctx.bf16)

    @staticmethod
    def backward(ctx, g):
        xj, a, w1, b1, mask = ctx.saved_tensors
        grads = fused_bilinear_bwd(g.contiguous(), xj.contiguous(),
                                   a.contiguous(), w1, b1, mask, ctx.bf16)
        return (*grads, None, None)
