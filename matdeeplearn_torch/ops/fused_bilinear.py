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
TPU compiles:

  * forward: bf16(a·xj) @ bf16(W1), plus xj @ b1 unrounded (:255, :272);
  * weight gradient: bf16(X)ᵀ bf16(mask·g), the bias unit too: d_b1 =
    bf16(xj)ᵀ bf16(mask·g) (:161, :207);
  * d_a[:, h] = rowsum((bf16(xj) @ bf16(W1[h]))·g), g unrounded
    (:194-197);
  * d_xj = Σ_h bf16(a_h·g) @ bf16(W1[h])ᵀ + g @ b1ᵀ, the bias term
    unrounded (:215-217, :406): the forward's function over (g, a, W1ᵀ,
    b1ᵀ) with D and K exchanged.

Products of bf16 values are exact in f32 (and in TF32), so each arm is
exact up to the order of its f32 sums; the arms' plain versions compute
them in f32 over the rounded operands.

The bf16 arm runs on kernels of its own (csrc/fused_bilinear_bf16.cu), on
the bf16 tensor cores (`wgmma` m64nNk16, bf16 operands, f32 sums), bound by
their operations at 989.4 TFLOP/s (PERF.md §6). The forward takes W as a
bf16 image laid out once a call as the tensor cores' B tiles read it
(`weight_image`; its plain twin `weight_image_plain`), streamed into shared
memory by bulk copies through a ring of mbarrier-guarded stages, with
bf16(a·xj) formed in registers; the bias unit stays 3xTF32. The backward to
the rows runs d_xj on the forward's kernel over the image of each unit's
transpose (`weight_image(..., transposed=True)`), and d_a on a kernel of
its own over the forward's image, a unit a stage, with bf16(xj) built once
a tile in registers. The weight gradient takes bf16(mask·g) as one such
image per 64-edge chunk (BF16_CHUNK) and forms bf16(X)ᵀ in registers from
the chunk's f32 rows, split over the chunks with a real edge and summed in
a fixed order. Shapes whose tiles do not fit raise.

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
BF16_CHUNK = 64  # edges of a bf16 weight-gradient chunk (csrc kChunk)
WGMMA_WIDTHS = (4, 13, 19, 25, 32)  # the bf16 kernels' n8-tiles (wgmma N / 8)
# The plain versions' largest per-edge intermediate ((rows, D·K) or
# (rows, (H+1)·D)): 2^26 floats, 256 MB. A training batch's whole (E, D, K)
# tensor at MPNN_demo width would be 3.2 GB.
_CHUNK_FLOATS = 1 << 26

_lib = None
_lib_bf16 = None


def _load():
    """The bound library of csrc/fused_bilinear.cu (ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("fused_bilinear")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mdl_fused_bilinear_fwd.argtypes = [vp] * 5 + [cl, ci, ci, ci, vp]
        lib.mdl_fused_bilinear_fwd.restype = ci
        lib.mdl_fused_bilinear_bwd.argtypes = [vp] * 8 + [cl, ci, ci, ci, vp]
        lib.mdl_fused_bilinear_bwd.restype = ci
        lib.mdl_fused_bilinear_wgrad.argtypes = ([vp] * 7
                                                 + [cl, ci, ci, ci, ci, vp])
        lib.mdl_fused_bilinear_wgrad.restype = ci
        lib.mdl_fused_bilinear_split_words.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_split_words.restype = cl
        lib.mdl_fused_bilinear_partial_floats.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_partial_floats.restype = cl
        lib.mdl_fused_bilinear_wgrad_splits.argtypes = [cl, ci, ci, ci]
        lib.mdl_fused_bilinear_wgrad_splits.restype = ci
        _lib = lib
    return _lib


def _load_bf16():
    """The bound library of csrc/fused_bilinear_bf16.cu: the bf16 arm."""
    global _lib_bf16
    if _lib_bf16 is None:
        lib = _build.library("fused_bilinear_bf16")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mdl_fused_bilinear_bf16_image_bytes.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_bf16_image_bytes.restype = cl
        lib.mdl_fused_bilinear_bf16_weight_image.argtypes = (
            [vp] * 3 + [ci] * 4 + [vp])
        lib.mdl_fused_bilinear_bf16_weight_image.restype = ci
        lib.mdl_fused_bilinear_bf16_fwd.argtypes = [vp] * 7 + [cl, ci, ci, ci,
                                                               vp]
        lib.mdl_fused_bilinear_bf16_fwd.restype = ci
        for fn in (lib.mdl_fused_bilinear_bf16_fwd_image,
                   lib.mdl_fused_bilinear_bf16_bwd_a):
            fn.argtypes = [vp] * 5 + [cl, ci, ci, ci, vp]
            fn.restype = ci
        lib.mdl_fused_bilinear_bf16_gimg_bytes.argtypes = [cl, ci, ci, ci]
        lib.mdl_fused_bilinear_bf16_gimg_bytes.restype = cl
        lib.mdl_fused_bilinear_bf16_partial_floats.argtypes = [ci, ci, ci]
        lib.mdl_fused_bilinear_bf16_partial_floats.restype = cl
        lib.mdl_fused_bilinear_bf16_wgrad_splits.argtypes = [cl, ci, ci, ci]
        lib.mdl_fused_bilinear_bf16_wgrad_splits.restype = ci
        lib.mdl_fused_bilinear_bf16_wgrad.argtypes = ([vp] * 8
                                                      + [cl, ci, ci, ci, ci, vp])
        lib.mdl_fused_bilinear_bf16_wgrad.restype = ci
        _lib_bf16 = lib
    return _lib_bf16


def _size(n: int, name: str) -> int:
    """A size query's answer, or raise on its minus error code."""
    if n < 0:
        _raise_on(-n, name)
    return n


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


def wgmma_width(k: int) -> int:
    """The bf16 kernels' n8-tiles for K columns: the smallest of
    WGMMA_WIDTHS that holds round8(K)."""
    nt = -(-k // 8)
    for w in WGMMA_WIDTHS:
        if nt <= w:
            return w
    raise ValueError(f"fused_bilinear: K={k} is wider than the kernels' "
                     f"{8 * WGMMA_WIDTHS[-1]}")


def _tf32_split(v: torch.Tensor) -> tuple:
    """(hi, lo) int32 words of v: cvt.rna.tf32.f32 (to nearest, ties away
    from zero) and the rest rounded the same way, as csrc split_tf32."""
    hi = (v.view(torch.int32) + 0x1000) & ~0x1FFF
    rest = (v - hi.view(torch.float32)).contiguous()
    return hi, (rest.view(torch.int32) + 0x1000) & ~0x1FFF


def transposed_weight(w1, b1, d: int) -> tuple:
    """(W1ᵀ, b1ᵀ): each unit's (D, K) matrix and the bias transposed, the
    weight of widths (K, D) whose forward over g is d_xj."""
    h, k = w1.shape[0], b1.numel() // d
    return (w1.reshape(h, d, k).transpose(1, 2).reshape(h, k * d),
            b1.reshape(d, k).t().reshape(-1))


def weight_image_plain(w1, b1, d: int, steps: int | None = None,
                       transposed: bool = False) -> torch.Tensor:
    """The bf16 forward's weight image as bytes (uint8), as its layout
    kernels write it: for each unit h < H and k16-step s of its D rows
    (zero-padded to whole k16-steps), the B tile of wgmma m64nNk16 in
    K-major core matrices of 8 rows x 16 bytes (np = 8·wgmma_width(K)
    rows, zero past K): 16 bytes at ((n8·2 + kh)·8 + r) hold bf16(W1[h·D +
    16s + 8kh + c, 8n8 + r]) for c < 8; then zero k16-steps up to `steps`
    (the kernel pads to whole ring stages; default none). Then b1 split
    into TF32 hi and lo words for the bias unit's 3xTF32 k8-steps t:
    position c of a k8-step is b1 row 8t + (2c if c < 4 else 2c - 7), the
    column order of the A fragments the kernel takes from its xj pairs.
    transposed: the image of transposed_weight(w1, b1, d), of widths
    (K, D)."""
    if transposed:
        k = b1.numel() // d
        w1, b1 = transposed_weight(w1, b1, d)
        d = k
    h = w1.shape[0]
    k = b1.numel() // d
    kd, n8 = -(-d // 16), wgmma_width(k)
    np_ = 8 * n8
    steps = h * kd if steps is None else steps
    w = torch.zeros(steps * 16, np_, dtype=torch.float32, device=w1.device)
    w[:h * kd * 16].view(h, 16 * kd, np_)[:, :d, :k] = w1.reshape(h, d, k)
    bits = w.to(torch.bfloat16).view(torch.int16)
    # (step, kh, c, n8, r) -> (step, n8, kh, r, c)
    tiles = bits.reshape(steps, 2, 8, n8, 8).permute(0, 3, 1, 4, 2)
    b = torch.zeros(16 * kd, np_, dtype=torch.float32, device=w1.device)
    b[:d, :k] = b1.reshape(d, k)
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    bt = b.reshape(2 * kd, 8, np_)[:, order].contiguous()
    # (t, kh, c, n8, r) -> (t, n8, kh, r, c), hi then lo a k8-step
    words = torch.stack([x.reshape(2 * kd, 2, 4, n8, 8).permute(0, 3, 1, 4, 2)
                         for x in _tf32_split(bt)], 1)
    return torch.cat([tiles.contiguous().view(torch.uint8).reshape(-1),
                      words.contiguous().view(torch.uint8).reshape(-1)])


def weight_image(w1, b1, d: int, transposed: bool = False) -> torch.Tensor:
    """weight_image_plain on a CPU tensor; on a CUDA tensor what the bf16
    forward's layout kernels write (the kernels alone, uncounted), reading
    W1 and b1 transposed in place with `transposed`."""
    if w1.device.type == "cpu":
        return weight_image_plain(w1, b1, d, transposed=transposed)
    k = b1.numel() // d
    h = w1.shape[0]
    wd, wk = (k, d) if transposed else (d, k)  # the image's widths
    lib = _load_bf16()
    img = torch.empty(_size(lib.mdl_fused_bilinear_bf16_image_bytes(wd, wk, h),
                            "mdl_fused_bilinear_bf16_image_bytes"),
                      dtype=torch.uint8, device=w1.device)
    with torch.cuda.device(w1.device):
        rc = lib.mdl_fused_bilinear_bf16_weight_image(
            w1.contiguous().data_ptr(), b1.contiguous().data_ptr(),
            img.data_ptr(), wd, wk, h, int(transposed),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mdl_fused_bilinear_bf16_weight_image")
    return img


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
    d_a[e, h] = xj[e] · U[e, h]. The bf16 arm at the chunked schedule's
    points: d_xj = fused_bilinear_plain(ge, a, W1ᵀ, b1ᵀ, mask, bf16) (the
    forward with D and K exchanged) and d_a[e, h] = (bf16(xj) @
    bf16(W1[h]))[e] · ge[e]."""
    e, d, h, k = _dims(xj, a, b1)
    ge = g * mask[:, None]
    if bf16:
        d_xj = fused_bilinear_plain(ge, a, *transposed_weight(w1, b1, d), mask,
                                    bf16=True)
        # (D, H·K): column h·K + n is bf16(W1[h])[:, n]
        w = round_bf16(w1).reshape(h, d, k).transpose(0, 1).reshape(d, h * k)
        xd = round_bf16(xj)
        d_a = torch.empty_like(a)
        for sl in _chunks(e, h * k):
            t = (xd[sl] @ w).reshape(-1, h, k)
            d_a[sl] = (t * ge[sl, None, :]).sum(-1)
        return d_xj, d_a
    wt = extend_weight(w1, b1, d).t()
    d_xj, d_a = torch.empty_like(xj), torch.empty_like(a)
    for sl in _chunks(e, (h + 1) * d):
        u = (ge[sl] @ wt).reshape(-1, h + 1, d)
        d_xj[sl] = torch.einsum("eh,ehd->ed", _with_bias_unit(a[sl]), u)
        d_a[sl] = torch.einsum("ed,ehd->eh", xj[sl], u[:, :h])
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
    if bf16:
        lib = _load_bf16()
        img = torch.empty(
            _size(lib.mdl_fused_bilinear_bf16_image_bytes(d, k, h),
                  "mdl_fused_bilinear_bf16_image_bytes"),
            dtype=torch.uint8, device=xj.device)
        with torch.cuda.device(xj.device):
            rc = lib.mdl_fused_bilinear_bf16_fwd(
                xj.data_ptr(), a.data_ptr(), w1.contiguous().data_ptr(),
                b1.contiguous().data_ptr(), img.data_ptr(), mask.data_ptr(),
                out.data_ptr(), e, d, k, h,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(rc, "mdl_fused_bilinear_bf16_fwd")
        _count("fused_bilinear_fwd", bf16)
        return out
    w = padded_weight(w1, b1, d)
    lib = _load()
    with torch.cuda.device(xj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_bilinear_fwd(xj.data_ptr(), a.data_ptr(),
                                        w.data_ptr(), mask.data_ptr(),
                                        out.data_ptr(), e, d, k, h, stream)
    _raise_on(rc, "mdl_fused_bilinear_fwd")
    _count("fused_bilinear_fwd", bf16)
    return out


def fused_bilinear_bwd_rows(g, xj, a, w1, b1, mask, bf16: bool = False
                            ) -> tuple:
    """(d_xj, d_a) for the cotangent g: the backward kernel, or with bf16
    the bf16 arm's two (_bwd_rows_bf16)."""
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
    if bf16:
        return _bwd_rows_bf16(g, xj, a, w1, b1, mask, d_xj, d_a)
    w = extend_weight(w1, b1, d)
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
                                        k, h, stream)
    _raise_on(rc, "mdl_fused_bilinear_bwd")
    _count("fused_bilinear_bwd", False)
    return d_xj, d_a


def _bwd_rows_bf16(g, xj, a, w1, b1, mask, d_xj, d_a) -> tuple:
    """fused_bilinear_bwd_rows's bf16 arm on the card (checked inputs,
    zeroed outputs): the layout kernels of W1ᵀ and W1, then d_xj on the
    forward's tiles over (g, a, W1ᵀ, b1ᵀ) and d_a on its own kernel; one
    count."""
    e, d, h, k = _dims(xj, a, b1)
    img_t = weight_image(w1, b1, d, transposed=True)
    img = weight_image(w1, b1, d)
    lib = _load_bf16()
    with torch.cuda.device(xj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_bilinear_bf16_fwd_image(
            g.data_ptr(), a.data_ptr(), img_t.data_ptr(), mask.data_ptr(),
            d_xj.data_ptr(), e, k, d, h, stream)
        _raise_on(rc, "mdl_fused_bilinear_bf16_fwd_image")
        rc = lib.mdl_fused_bilinear_bf16_bwd_a(
            xj.data_ptr(), img.data_ptr(), mask.data_ptr(), g.data_ptr(),
            d_a.data_ptr(), e, d, k, h, stream)
    _raise_on(rc, "mdl_fused_bilinear_bf16_bwd_a")
    _count("fused_bilinear_bwd", True)
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
    if bf16:
        return _wgrad_bf16(g, xj, a, mask)
    lib = _load()
    with torch.cuda.device(dev):
        splits = lib.mdl_fused_bilinear_wgrad_splits(e, d, k, h)
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
            splits, stream)
    _raise_on(rc, "mdl_fused_bilinear_wgrad")
    _count("fused_bilinear_wgrad", bf16)
    return dw


def _wgrad_bf16(g, xj, a, mask) -> torch.Tensor:
    """fused_bilinear_wgrad's bf16 arm on the card (checked inputs)."""
    e, d = xj.shape
    h, k = a.shape[1], g.shape[1]
    dev = xj.device
    if xj.data_ptr() % 16:  # its chunks land by 16-byte bulk copies
        xj = xj.clone()
    lib = _load_bf16()
    with torch.cuda.device(dev):
        splits = _size(lib.mdl_fused_bilinear_bf16_wgrad_splits(e, d, k, h),
                       "mdl_fused_bilinear_bf16_wgrad_splits")
    partial = torch.empty(
        splits * _size(lib.mdl_fused_bilinear_bf16_partial_floats(d, k, h),
                       "mdl_fused_bilinear_bf16_partial_floats"),
        dtype=torch.float32, device=dev)
    gimg = torch.empty(_size(lib.mdl_fused_bilinear_bf16_gimg_bytes(e, d, k, h),
                             "mdl_fused_bilinear_bf16_gimg_bytes"),
                       dtype=torch.uint8, device=dev)
    live = torch.empty(1 + -(-e // BF16_CHUNK), dtype=torch.int32, device=dev)
    dw = torch.empty(((h + 1) * d, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mdl_fused_bilinear_bf16_wgrad(
            xj.data_ptr(), a.data_ptr(), mask.data_ptr(), g.data_ptr(),
            live.data_ptr(), gimg.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), e, d, k, h, splits,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mdl_fused_bilinear_bf16_wgrad")
    _count("fused_bilinear_wgrad", True)
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
