"""Fused SchNet cfconv: filter MLP, Gaussian edge basis, cosine cutoff and
sum aggregation in one hand-written CUDA kernel, with a fused backward on
the tensor cores.

The kernels in csrc/fused_cfconv.cu replace the reference package's
ops/pallas_fused_schnet.py:_fwd_kernel and :_bwd_kernel. The function is
that package's `fused_cfconv` (:212-223) on the flat edge layout:

  fused_cfconv(xj, dist, wraw, dst, mask, w0, b0, w1, b1, num_nodes,
               edge_width, cutoff)[n]
    = Σ_{e: dst[e]=n} mask[e] · c(wraw[e]) · xj[e] ⊙ (ssp(basis(dist[e])·W0
                                                       + b0)·W1 + b1),
  c(d) = 0.5·(cos(π·d/cutoff) + 1),  ssp(p) = softplus(p) - ln 2

xj (E, F) pre-gathered h[src]; dist (E,) normalized distances (the basis
input); wraw (E,) raw distances (the cutoff input); dst (E,) int32; mask
(E,) float32 (pad edges 0, and they add nothing); w0 (De, F), w1 (F, F) in
(in, out) layout, biases (F,) or (1, F). It returns the SUM aggregation.
Any dst order is right (the forward flushes runs of equal dst with
atomics); dst-sorted edges are the cheap case. Every output is zeroed by
the wrapper, so the reference's window masking has no counterpart.

`dist` and `wraw` are data and are not differentiated (the reference
contract, :212-248): FusedCFConv returns gradients for xj, w0, b0, w1 and
b1 only. d_xj is exactly zero on every masked edge, so the backward of the
h[src] gather adds nothing into the row pad edges point at.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches. The forward is one kernel on the FMA
pipes (bound: operations, 0.041 ms at chip_smoke's training batch at 67
TFLOP/s). The backward launches three, every product in 3xTF32 on the
tensor cores (csrc/fused_cfconv.cu says why; bound: operations, 7.51e9
FLOP at that batch, 0.0455 ms at 495/3 TFLOP/s): the edge rows
(`fused_cfconv_bwd`, on wgmma: d_xj, and the rows a, dw and dpre, after a
split of W0 and W1 into TF32 hi/lo once a call), the weight gradients in
slices (`fused_cfconv_wgrad`, on mma.sync: [b | 1]ᵀ·dpre and [a | 1]ᵀ·dw
over strided 32-edge chunks) and the fixed-order sum of the slices
(`wgrad_reduce`).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import _check_cuda, _raise_on, segment_sum_plain
from matdeeplearn_torch.ops.edge_basis import gaussian_basis
from matdeeplearn_torch.ops.fused_cgconv import _basis_constants, ntw_bucket

LAUNCHES = {"fused_cfconv_fwd": 0, "fused_cfconv_bwd": 0,
            "fused_cfconv_wgrad": 0, "fused_cfconv_wgrad_reduce": 0}
MAX_WIDTH = 256  # the kernels' largest F
WGRAD_CHUNK = 32  # edges of a weight-gradient chunk (csrc kWK)
BLOCKS_PER_SM = 2  # weight-gradient blocks per SM the slice count aims at
_LOG2 = 0.6931471805599453

_lib = None


def _load():
    """The bound library of csrc/fused_cfconv.cu (ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("fused_cfconv")
        vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.mdl_fused_cfconv_fwd.argtypes = ([vp] * 8
                                             + [cl, ci, ci, ci, cf, cf, cf, vp])
        lib.mdl_fused_cfconv_fwd.restype = ci
        lib.mdl_fused_cfconv_bwd.argtypes = ([vp] * 15
                                             + [cl, ci, ci, ci, cf, cf, cf, vp])
        lib.mdl_fused_cfconv_bwd.restype = ci
        lib.mdl_fused_cfconv_bwd_split_words.argtypes = [ci, ci]
        lib.mdl_fused_cfconv_bwd_split_words.restype = cl
        lib.mdl_fused_cfconv_wgrad.argtypes = ([vp] * 8
                                               + [cl, ci, ci, ci, cf, cf, cf, ci,
                                                  vp])
        lib.mdl_fused_cfconv_wgrad.restype = ci
        lib.mdl_fused_cfconv_wgrad_tiles.argtypes = [ci, ci]
        lib.mdl_fused_cfconv_wgrad_tiles.restype = ci
        lib.mdl_fused_cfconv_wgrad_reduce.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.mdl_fused_cfconv_wgrad_reduce.restype = ci
        lib.mdl_fused_cfconv_partial_floats.argtypes = [ci, ci]
        lib.mdl_fused_cfconv_partial_floats.restype = cl
        _lib = lib
    return _lib


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _extend(w, b) -> torch.Tensor:
    """[w; b]: the kernels' weight with its bias as the last row."""
    return torch.cat([w, b.reshape(1, -1)], 0).contiguous()


# ------------------------------------------------------------- plain versions


def fused_cfconv_plain(xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                       num_nodes: int, edge_width: float, cutoff: float):
    """Plain PyTorch version (the reference's `_reference_compose`)."""
    e = gaussian_basis(dist, 0.0, 1.0, w0.shape[0], edge_width)
    a = F.softplus(e @ w0 + b0.reshape(-1)) - _LOG2
    w = a @ w1 + b1.reshape(-1)
    c = 0.5 * (torch.cos(wraw * (math.pi / cutoff)) + 1.0)
    return segment_sum_plain(xj * w * c[:, None], dst, mask, num_nodes)


def fused_cfconv_bwd_plain(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                           num_nodes: int, edge_width: float, cutoff: float):
    """Plain backward: autograd through the plain version. Returns (d_xj,
    d_w0, d_b0, d_w1, d_b1)."""
    diff = [t.detach().requires_grad_(True) for t in (xj, w0, b0, w1, b1)]
    with torch.enable_grad():
        xjv, *ws = diff
        out = fused_cfconv_plain(xjv, dist, wraw, dst, mask, *ws, num_nodes,
                                 edge_width, cutoff)
        return torch.autograd.grad(out, diff, g)


def row_width(f: int) -> int:
    """Columns of the backward's row buffers a, dw and dpre: 8 n8-tiles of
    a warpgroup (csrc mdl_fused_cfconv_row_width), >= F."""
    return 8 * ntw_bucket(-(-f // 8))


def pair_order(k: int) -> torch.Tensor:
    """The column each k-step position takes in the backward's second and
    third products (csrc/wgmma.cuh:pair_col): within each 8, positions t
    and t + 4 hold columns 2t and 2t + 1, so one product's accumulators
    are the next one's A fragments as they stand."""
    p = torch.arange(k)
    q = p % 8
    return p - q + torch.where(q < 4, 2 * q, 2 * (q - 4) + 1)


def bwd_b(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The backward kernel's B operands, (NP, 8·(kt0 + 2·NTW)) with NP =
    row_width(F) = 8·NTW and kt0 = ⌈De/8⌉, unit after unit along the
    columns: W0ᵀ (pre = b·W0), then W1ᵀ and W1 (w = a·W1, dw·W1ᵀ) with
    their columns in pair_order; zeros past De and F."""
    de, f = w0.shape
    np_, k0 = row_width(f), -(-de // 8) * 8
    u0 = w0.new_zeros(np_, k0)
    u0[:f, :de] = w0.t()
    u1 = w0.new_zeros(np_, np_)
    u1[:f, :f] = w1.t()
    u2 = w0.new_zeros(np_, np_)
    u2[:f, :f] = w1
    order = pair_order(np_)
    return torch.cat([u0, u1[:, order], u2[:, order]], 1)


def edge_scale(wraw, dst, mask, num_nodes: int, cutoff: float):
    """s = mask · c(wraw) where 0 <= dst < num_nodes, else 0: an edge with
    s = 0 adds nothing anywhere (the kernels' row scale)."""
    real = (dst >= 0) & (dst < num_nodes) & (mask != 0)
    c = 0.5 * (torch.cos(wraw * (math.pi / cutoff)) + 1.0)
    return torch.where(real, mask * c, torch.zeros_like(mask))


def bwd_rows_plain(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                   num_nodes: int, edge_width: float, cutoff: float) -> tuple:
    """Plain version of the backward's edge kernel: (d_xj, a, dw, dpre),
    the last three (E, row_width(F)) rows ssp(pre), g[dst]·s·xj and
    (dw·W1ᵀ)·sigmoid(pre), zero past F and on edges whose s is 0 (the
    kernel leaves those rows unwritten)."""
    e, f = xj.shape
    s = edge_scale(wraw, dst, mask, num_nodes, cutoff)
    basis = gaussian_basis(dist, 0.0, 1.0, w0.shape[0], edge_width)
    pre = basis @ w0 + b0.reshape(-1)
    a = F.softplus(pre) - _LOG2
    w = a @ w1 + b1.reshape(-1)
    idx = torch.where(s != 0, dst, 0).to(torch.int64)
    gg = g[idx] * s[:, None]
    dw = gg * xj
    dpre = (dw @ w1.t()) * torch.sigmoid(pre)
    real = (s != 0)[:, None]
    rows = []
    for t in (a, dw, dpre):
        r = t.new_zeros(e, row_width(f))
        r[:, :f] = torch.where(real, t, torch.zeros_like(t))
        rows.append(r)
    return (gg * w, *rows)


def wgrad_partials_plain(dist, wraw, dst, mask, a, dw, dpre, num_nodes: int,
                         f: int, de: int, edge_width: float, cutoff: float,
                         slices: int) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: slice s holds the sums
    over the 32-edge chunks s, s + slices, ... of [b | 1]ᵀ·dpre and
    [a | 1]ᵀ·dw, stacked as wgrad_reduce takes them (each block of rows
    padded to a multiple of 4, zeros in the pads), in its micro-tile
    layout. a, dw and dpre are the edge kernel's rows (bwd_rows_plain);
    edges whose s is 0 add nothing."""
    from matdeeplearn_torch.ops.fused_cgconv import to_partial_layout

    e = dist.shape[0]
    ldn = _round4(f)
    real = (edge_scale(wraw, dst, mask, num_nodes, cutoff) != 0)[:, None]
    z0 = dist.new_zeros(e, _round4(de + 1))
    z0[:, :de] = gaussian_basis(dist, 0.0, 1.0, de, edge_width)
    z0[:, de] = 1.0
    z1 = dist.new_zeros(e, _round4(f + 1))
    z1[:, :f] = a[:, :f]
    z1[:, f] = 1.0
    z0, z1 = (torch.where(real, z, torch.zeros_like(z)) for z in (z0, z1))
    d0, d1 = (torch.where(real, t[:, :ldn], torch.zeros_like(t[:, :ldn]))
              for t in (dpre, dw))
    chunk = torch.arange(e, device=dist.device) // WGRAD_CHUNK
    dws = [torch.cat([z0[sel].t() @ d0[sel], z1[sel].t() @ d1[sel]])
           for sel in (chunk % slices == sl for sl in range(slices))]
    return to_partial_layout(torch.stack(dws))


def wgrad_reduce_plain(partial: torch.Tensor, f: int, de: int) -> torch.Tensor:
    """Plain version of the partial-gradient sum: (blocks, micro-tiles, 4, 4)
    partials, with micro-tile m covering rows 4·(m // CG) and columns
    4·(m % CG) (CG = round4(F)/4), → the (round4(De+1) + round4(F+1), F)
    stack of [dW0; db0] and [dW1; db1] that split_wgrad takes apart."""
    kg = (_round4(de + 1) + _round4(f + 1)) // 4
    cg = _round4(f) // 4
    s = partial.reshape(-1, kg, cg, 4, 4).sum(0)
    return s.permute(0, 2, 1, 3).reshape(4 * kg, 4 * cg)[:, :f]


def split_wgrad(dw: torch.Tensor, f: int, de: int, b0_shape, b1_shape
                ) -> tuple:
    """(d_w0, d_b0, d_w1, d_b1) out of wgrad_reduce's stack."""
    r1 = _round4(de + 1)
    return (dw[:de], dw[de].reshape(b0_shape),
            dw[r1:r1 + f], dw[r1 + f].reshape(b1_shape))


# ------------------------------------------------------------------ wrappers


def _check_inputs(xj, dist, wraw, dst, mask, w0, b0, w1, b1):
    _check_cuda("xj", xj, torch.float32, 2)
    for name, t in (("dist", dist), ("wraw", wraw), ("mask", mask)):
        _check_cuda(name, t, torch.float32, 1)
    _check_cuda("dst", dst, torch.int32, 1)
    e, f = xj.shape
    if any(t.shape[0] != e for t in (dist, wraw, dst, mask)) \
            or w0.dim() != 2 or w0.shape[1] != f or w1.shape != (f, f) \
            or b0.numel() != f or b1.numel() != f:
        raise ValueError(
            f"fused_cfconv: inconsistent shapes xj {tuple(xj.shape)}, dist "
            f"{tuple(dist.shape)}, wraw {tuple(wraw.shape)}, dst "
            f"{tuple(dst.shape)}, mask {tuple(mask.shape)}, w0 "
            f"{tuple(w0.shape)}, b0 {tuple(b0.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}")
    if f > MAX_WIDTH:
        raise ValueError(f"fused_cfconv: F={f} is wider than the kernels' "
                         f"{MAX_WIDTH}")
    devs = {t.device for t in (xj, dist, wraw, dst, mask, w0, b0, w1, b1)}
    if len(devs) != 1:
        raise ValueError(f"fused_cfconv: tensors on several devices {devs}")


def _constants(de: int, edge_width: float, cutoff: float) -> tuple:
    """(coeff, step, scale): the basis exp(coeff·(dist - k·step)²) and the
    cutoff's cos(wraw·scale)."""
    return (*_basis_constants(de, edge_width), math.pi / cutoff)


def fused_cfconv(xj, dist, wraw, dst, mask, w0, b0, w1, b1, num_nodes: int,
                 edge_width: float, cutoff: float) -> torch.Tensor:
    """(num_nodes, F) f32 sums of the filtered messages at dst."""
    if xj.device.type == "cpu":
        return fused_cfconv_plain(xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                                  num_nodes, edge_width, cutoff)
    _check_inputs(xj, dist, wraw, dst, mask, w0, b0, w1, b1)
    w0e, w1e = _extend(w0, b0), _extend(w1, b1)
    e, f = xj.shape
    de = w0.shape[0]
    out = torch.zeros((num_nodes, f), dtype=torch.float32, device=xj.device)
    if e == 0 or f == 0 or num_nodes == 0:
        return out
    lib = _load()
    with torch.cuda.device(xj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cfconv_fwd(
            xj.data_ptr(), dist.data_ptr(), wraw.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), w0e.data_ptr(), w1e.data_ptr(), out.data_ptr(),
            e, f, de, num_nodes, *_constants(de, edge_width, cutoff), stream)
    _raise_on(rc, "mdl_fused_cfconv_fwd")
    LAUNCHES["fused_cfconv_fwd"] += 1
    return out


def wgrad_reduce(partial: torch.Tensor, blocks: int, f: int, de: int
                 ) -> torch.Tensor:
    """Sum of the weight gradient's `blocks` slices → the (round4(De+1) +
    round4(F+1), F) stack that split_wgrad takes apart, in a fixed order
    (bit-identical from run to run)."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, f, de)
    _check_cuda("partial", partial, torch.float32, 1)
    lib = _load()
    if partial.numel() != blocks * lib.mdl_fused_cfconv_partial_floats(f, de):
        raise ValueError(f"wgrad_reduce: {partial.numel()} partial floats do "
                         f"not match {blocks} slices at F={f}, De={de}")
    dw = torch.empty((_round4(de + 1) + _round4(f + 1), f),
                     dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cfconv_wgrad_reduce(partial.data_ptr(),
                                               dw.data_ptr(), blocks, f, de,
                                               stream)
    _raise_on(rc, "mdl_fused_cfconv_wgrad_reduce")
    LAUNCHES["fused_cfconv_wgrad_reduce"] += 1
    return dw


def fused_cfconv_bwd_rows(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                          num_nodes: int, edge_width: float, cutoff: float
                          ) -> tuple:
    """The backward's edge kernel: (d_xj, a, dw, dpre), the last three the
    (E, row_width(F)) rows of real edges for fused_cfconv_wgrad
    (bwd_rows_plain says the layout; rows of other edges are not written
    on the card)."""
    if xj.device.type == "cpu":
        return bwd_rows_plain(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                              num_nodes, edge_width, cutoff)
    w0, b0, w1, b1 = (t.contiguous() for t in (w0, b0, w1, b1))
    _check_inputs(xj, dist, wraw, dst, mask, w0, b0, w1, b1)
    _check_cuda("g", g, torch.float32, 2)
    e, f = xj.shape
    de = w0.shape[0]
    if g.shape != (num_nodes, f):
        raise ValueError(f"fused_cfconv_bwd: g {tuple(g.shape)} must be "
                         f"({num_nodes}, {f})")
    dev = xj.device
    d_xj = torch.zeros((e, f), dtype=torch.float32, device=dev)
    rows = [torch.empty((e, row_width(f)), dtype=torch.float32, device=dev)
            for _ in range(3)]
    if e == 0 or f == 0 or num_nodes == 0 or de == 0:
        return (d_xj, *rows)
    lib = _load()
    words = lib.mdl_fused_cfconv_bwd_split_words(f, de)
    if words < 0:
        _raise_on(-words, "mdl_fused_cfconv_bwd_split_words")
    # the kernel's TF32 hi/lo split of W0, W1 and W1ᵀ, in the order its
    # tiles read them
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cfconv_bwd(
            xj.data_ptr(), dist.data_ptr(), wraw.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), ws.data_ptr(), g.data_ptr(), d_xj.data_ptr(),
            *(r.data_ptr() for r in rows), e, f, de, num_nodes,
            *_constants(de, edge_width, cutoff), stream)
    _raise_on(rc, "mdl_fused_cfconv_bwd")
    LAUNCHES["fused_cfconv_bwd"] += 1
    return (d_xj, *rows)


def wgrad_slices(e: int, f: int, de: int, device) -> int:
    """The weight gradient's slice count on a CUDA device: about
    BLOCKS_PER_SM blocks an SM, and no more slices than 32-edge chunks."""
    tiles = _load().mdl_fused_cfconv_wgrad_tiles(f, de)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-e // WGRAD_CHUNK), round(BLOCKS_PER_SM * sms / tiles)))


def fused_cfconv_wgrad(dist, wraw, dst, mask, a, dw, dpre, num_nodes: int,
                       f: int, de: int, edge_width: float, cutoff: float,
                       slices: int | None = None) -> tuple:
    """The backward's weight-gradient kernel: (partial, slices), the slices
    of [b | 1]ᵀ·dpre and [a | 1]ᵀ·dw over strided 32-edge chunks in
    wgrad_reduce's layout. `slices` defaults to wgrad_slices on the card and
    1 on the CPU."""
    if dist.device.type == "cpu":
        sl = slices or 1
        return wgrad_partials_plain(dist, wraw, dst, mask, a, dw, dpre,
                                    num_nodes, f, de, edge_width, cutoff,
                                    sl), sl
    for name, t in (("dist", dist), ("wraw", wraw), ("mask", mask)):
        _check_cuda(name, t, torch.float32, 1)
    _check_cuda("dst", dst, torch.int32, 1)
    e = dist.shape[0]
    for name, t in (("a", a), ("dw", dw), ("dpre", dpre)):
        _check_cuda(name, t, torch.float32, 2)
        if t.shape != (e, row_width(f)):
            raise ValueError(f"fused_cfconv_wgrad: {name} {tuple(t.shape)} "
                             f"must be ({e}, {row_width(f)})")
    lib = _load()
    sl = slices or wgrad_slices(e, f, de, dist.device)
    floats = sl * lib.mdl_fused_cfconv_partial_floats(f, de)
    if e == 0 or num_nodes == 0:
        return torch.zeros(floats, dtype=torch.float32, device=dist.device), sl
    partial = torch.empty(floats, dtype=torch.float32, device=dist.device)
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cfconv_wgrad(
            dist.data_ptr(), wraw.data_ptr(), dst.data_ptr(), mask.data_ptr(),
            a.data_ptr(), dw.data_ptr(), dpre.data_ptr(), partial.data_ptr(),
            e, f, de, num_nodes, *_constants(de, edge_width, cutoff), sl,
            stream)
    _raise_on(rc, "mdl_fused_cfconv_wgrad")
    LAUNCHES["fused_cfconv_wgrad"] += 1
    return partial, sl


def fused_cfconv_bwd(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                     num_nodes: int, edge_width: float, cutoff: float
                     ) -> tuple:
    """Gradients of fused_cfconv for the output cotangent g: (d_xj, d_w0,
    d_b0, d_w1, d_b1)."""
    if xj.device.type == "cpu":
        return fused_cfconv_bwd_plain(g, xj, dist, wraw, dst, mask, w0, b0,
                                      w1, b1, num_nodes, edge_width, cutoff)
    f, de = xj.shape[1], w0.shape[0]
    d_xj, a, dw, dpre = fused_cfconv_bwd_rows(
        g, xj, dist, wraw, dst, mask, w0, b0, w1, b1, num_nodes, edge_width,
        cutoff)
    partial, slices = fused_cfconv_wgrad(dist, wraw, dst, mask, a, dw, dpre,
                                         num_nodes, f, de, edge_width, cutoff)
    dwr = wgrad_reduce(partial, slices, f, de)
    return (d_xj,) + split_wgrad(dwr, f, de, b0.shape, b1.shape)


# ------------------------------------------------------------------ autograd


class FusedCFConv(torch.autograd.Function):
    """fused_cfconv with the fused backward kernel as its backward; no
    gradient for dist, wraw, dst, mask, num_nodes, edge_width or cutoff."""

    @staticmethod
    def forward(ctx, xj, dist, wraw, dst, mask, w0, b0, w1, b1, num_nodes,
                edge_width, cutoff):
        ctx.save_for_backward(xj, dist, wraw, dst, mask, w0, b0, w1, b1)
        ctx.args = (num_nodes, edge_width, cutoff)
        return fused_cfconv(xj.contiguous(), dist, wraw, dst, mask, w0, b0,
                            w1, b1, num_nodes, edge_width, cutoff)

    @staticmethod
    def backward(ctx, g):
        xj, dist, wraw, dst, mask, *ws = ctx.saved_tensors
        d_xj, *d_ws = fused_cfconv_bwd(g.contiguous(), xj.contiguous(), dist,
                                       wraw, dst, mask, *ws, *ctx.args)
        return (d_xj, None, None, None, None, *d_ws, None, None, None)
