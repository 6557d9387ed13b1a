"""Fused SchNet cfconv: filter MLP, Gaussian edge basis, cosine cutoff and
sum aggregation in one hand-written CUDA kernel, with a fused backward
kernel.

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
`LAUNCHES` counts kernel launches. The backward launches two kernels: the
fused backward, which leaves per-block partial weight gradients, and
`wgrad_reduce`, which sums them (csrc/fused_cfconv.cu says why).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import _check_cuda, _raise_on, segment_sum_plain
from matdeeplearn_torch.ops.edge_basis import gaussian_basis
from matdeeplearn_torch.ops.fused_cgconv import BLOCKS_PER_SM, _basis_constants

LAUNCHES = {"fused_cfconv_fwd": 0, "fused_cfconv_bwd": 0,
            "fused_cfconv_wgrad_reduce": 0}
MAX_WIDTH = 256  # the kernels' largest F
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
        lib.mdl_fused_cfconv_bwd.argtypes = ([vp] * 11
                                             + [cl, ci, ci, ci, cf, cf, cf, ci,
                                                vp])
        lib.mdl_fused_cfconv_bwd.restype = ci
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


def _check_inputs(xj, dist, wraw, dst, mask, w0e, w1e):
    _check_cuda("xj", xj, torch.float32, 2)
    for name, t in (("dist", dist), ("wraw", wraw), ("mask", mask)):
        _check_cuda(name, t, torch.float32, 1)
    _check_cuda("dst", dst, torch.int32, 1)
    e, f = xj.shape
    if any(t.shape[0] != e for t in (dist, wraw, dst, mask)) \
            or w0e.shape[1] != f or w1e.shape != (f + 1, f):
        raise ValueError(
            f"fused_cfconv: inconsistent shapes xj {tuple(xj.shape)}, dist "
            f"{tuple(dist.shape)}, wraw {tuple(wraw.shape)}, dst "
            f"{tuple(dst.shape)}, mask {tuple(mask.shape)}, [w0; b0] "
            f"{tuple(w0e.shape)}, [w1; b1] {tuple(w1e.shape)}")
    if f > MAX_WIDTH:
        raise ValueError(f"fused_cfconv: F={f} is wider than the kernels' "
                         f"{MAX_WIDTH}")
    devs = {t.device for t in (xj, dist, wraw, dst, mask, w0e, w1e)}
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
    w0e, w1e = _extend(w0, b0), _extend(w1, b1)
    _check_inputs(xj, dist, wraw, dst, mask, w0e, w1e)
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
    """Sum of the backward's per-block partial weight gradients → the
    (round4(De+1) + round4(F+1), F) stack that split_wgrad takes apart."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, f, de)
    _check_cuda("partial", partial, torch.float32, 1)
    lib = _load()
    if partial.numel() != blocks * lib.mdl_fused_cfconv_partial_floats(f, de):
        raise ValueError(f"wgrad_reduce: {partial.numel()} partial floats do "
                         f"not match {blocks} blocks at F={f}, De={de}")
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


def fused_cfconv_bwd_partials(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                              num_nodes: int, edge_width: float,
                              cutoff: float) -> tuple:
    """The backward kernel alone (CUDA tensors only): (d_xj, partial,
    blocks), where partial holds each block's share of the weight
    gradients for wgrad_reduce."""
    w0e, w1e = _extend(w0, b0), _extend(w1, b1)
    _check_inputs(xj, dist, wraw, dst, mask, w0e, w1e)
    _check_cuda("g", g, torch.float32, 2)
    e, f = xj.shape
    de = w0.shape[0]
    if g.shape != (num_nodes, f):
        raise ValueError(f"fused_cfconv_bwd: g {tuple(g.shape)} must be "
                         f"({num_nodes}, {f})")
    dev = xj.device
    d_xj = torch.zeros((e, f), dtype=torch.float32, device=dev)
    lib = _load()
    blocks = max(1, min(-(-e // 32), BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count))
    partial = torch.zeros(blocks * lib.mdl_fused_cfconv_partial_floats(f, de),
                          dtype=torch.float32, device=dev)
    if e > 0 and f > 0 and num_nodes > 0:
        w1t = w1.t().contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mdl_fused_cfconv_bwd(
                xj.data_ptr(), dist.data_ptr(), wraw.data_ptr(),
                dst.data_ptr(), mask.data_ptr(), w0e.data_ptr(),
                w1e.data_ptr(), w1t.data_ptr(), g.data_ptr(), d_xj.data_ptr(),
                partial.data_ptr(), e, f, de, num_nodes,
                *_constants(de, edge_width, cutoff), blocks, stream)
        _raise_on(rc, "mdl_fused_cfconv_bwd")
        LAUNCHES["fused_cfconv_bwd"] += 1
    return d_xj, partial, blocks


def fused_cfconv_bwd(g, xj, dist, wraw, dst, mask, w0, b0, w1, b1,
                     num_nodes: int, edge_width: float, cutoff: float
                     ) -> tuple:
    """Gradients of fused_cfconv for the output cotangent g: (d_xj, d_w0,
    d_b0, d_w1, d_b1)."""
    if xj.device.type == "cpu":
        return fused_cfconv_bwd_plain(g, xj, dist, wraw, dst, mask, w0, b0,
                                      w1, b1, num_nodes, edge_width, cutoff)
    d_xj, partial, blocks = fused_cfconv_bwd_partials(
        g, xj, dist, wraw, dst, mask, w0, b0, w1, b1, num_nodes, edge_width,
        cutoff)
    f, de = xj.shape[1], w0.shape[0]
    dw = wgrad_reduce(partial, blocks, f, de)
    return (d_xj,) + split_wgrad(dw, f, de, b0.shape, b1.shape)


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
