"""Fused CGConv: message MLPs, Gaussian edge basis and sum aggregation in
one hand-written CUDA kernel, with a fused backward kernel.

The kernels in csrc/fused_cgconv.cu replace the reference package's
ops/pallas_fused.py:_fwd_kernel and :_bwd_kernel. The function is that
package's `fused_cgconv` (:320-338) on the flat edge layout:

  fused_cgconv(x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj, wse, bs,
               num_nodes, edge_width)[n]
    = Σ_{e: dst[e]=n} mask[e] · σ(z·Wf + bf) ⊙ softplus(z·Ws + bs),
  z = [x[dst[e]] ‖ xj[e] ‖ basis(dist[e])],  Wf = [wfi; wfj; wfe]

x (N, D) node features; xj (E, D) pre-gathered x[src]; dist (E,) normalized
distances; dst (E,) int32; mask (E,) float32 (pad edges 0, and they add
nothing); the weight blocks in (in, out) layout: wfi, wfj, wsi, wsj (D, D),
wfe, wse (De, D), biases (D,) or (1, D). It returns the SUM aggregation;
CGConv divides by the in-degree. The layout is the batch's own: any dst
order is right (the kernels flush runs of equal dst with atomics), and
dst-sorted edges are the cheap case. No windowed layout is needed, so the
reference's `_visited_nodes` masking has no counterpart here: every output
is zeroed by the wrapper.

`dist` is data and is not differentiated (the reference docstring at
:331-335): FusedCGConv returns no gradient for it, nor for dst and mask.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches. The backward launches two kernels: the
fused backward, which leaves per-block partial weight gradients, and
`wgrad_reduce`, which sums them (csrc/fused_cgconv.cu says why).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import _check_cuda, _raise_on, segment_sum_plain
from matdeeplearn_torch.ops.edge_basis import gaussian_basis

LAUNCHES = {"fused_cgconv_fwd": 0, "fused_cgconv_bwd": 0,
            "fused_cgconv_wgrad_reduce": 0}
MAX_WIDTH = 256      # the kernels' largest D
BLOCKS_PER_SM = 2    # the backward's persistent grid

_lib = None


def _load():
    """The bound library of csrc/fused_cgconv.cu (ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("fused_cgconv")
        vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.mdl_fused_cgconv_fwd.argtypes = [vp] * 7 + [cl, ci, ci, ci, cf, cf, vp]
        lib.mdl_fused_cgconv_fwd.restype = ci
        lib.mdl_fused_cgconv_bwd.argtypes = ([vp] * 11
                                             + [cl, ci, ci, ci, cf, cf, ci, vp])
        lib.mdl_fused_cgconv_bwd.restype = ci
        lib.mdl_fused_cgconv_wgrad_reduce.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.mdl_fused_cgconv_wgrad_reduce.restype = ci
        lib.mdl_fused_cgconv_partial_floats.argtypes = [ci, ci]
        lib.mdl_fused_cgconv_partial_floats.restype = cl
        _lib = lib
    return _lib


def pack_weights(wfi, wfj, wfe, bf, wsi, wsj, wse, bs) -> torch.Tensor:
    """The kernels' (2D+De+1, 2D) weight: [[wfi wsi]; [wfj wsj]; [wfe wse];
    [bf bs]]."""
    return torch.cat([torch.cat([wfi, wsi], 1), torch.cat([wfj, wsj], 1),
                      torch.cat([wfe, wse], 1),
                      torch.cat([bf.reshape(1, -1), bs.reshape(1, -1)], 1)],
                     0).contiguous()


def unpack_weights(w: torch.Tensor, d: int, bias_shape) -> tuple:
    """Inverse of pack_weights: (wfi, wfj, wfe, bf, wsi, wsj, wse, bs)."""
    f, s = w[:, :d], w[:, d:]
    return (f[:d], f[d:2 * d], f[2 * d:-1], f[-1].reshape(bias_shape),
            s[:d], s[d:2 * d], s[2 * d:-1], s[-1].reshape(bias_shape))


def _basis_constants(de: int, edge_width: float) -> tuple[float, float]:
    """(coeff, step): the kernels' basis is exp(coeff·(dist - k·step)²)."""
    return -0.5 / (edge_width * edge_width), (1.0 / (de - 1) if de > 1 else 0.0)


# ------------------------------------------------------------- plain versions


def fused_cgconv_plain(x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj,
                       wse, bs, num_nodes: int, edge_width: float):
    """Plain PyTorch version (the reference's `_reference_compose`)."""
    xi = x[dst.to(torch.int64)]
    e = gaussian_basis(dist, 0.0, 1.0, wfe.shape[0], edge_width)
    af = xi @ wfi + xj @ wfj + e @ wfe + bf
    as_ = xi @ wsi + xj @ wsj + e @ wse + bs
    msg = torch.sigmoid(af) * F.softplus(as_)
    return segment_sum_plain(msg, dst, mask, num_nodes)


def fused_cgconv_bwd_plain(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi,
                           wsj, wse, bs, num_nodes: int, edge_width: float):
    """Plain backward: autograd through the plain version. Returns (d_x,
    d_xj, d_wfi, d_wfj, d_wfe, d_bf, d_wsi, d_wsj, d_wse, d_bs)."""
    diff = [t.detach().requires_grad_(True)
            for t in (x, xj, wfi, wfj, wfe, bf, wsi, wsj, wse, bs)]
    with torch.enable_grad():
        xv, xjv, *ws = diff
        out = fused_cgconv_plain(xv, xjv, dist, dst, mask, *ws, num_nodes,
                                 edge_width)
        return torch.autograd.grad(out, diff, g)


def wgrad_reduce_plain(partial: torch.Tensor, d: int, de: int) -> torch.Tensor:
    """Plain version of the partial-gradient sum: (blocks, micro-tiles, 4, 4)
    partials, with micro-tile m covering rows 4·(m // CG) and columns
    4·(m % CG) (CG = round4(2D)/4), → the (2D+De+1, 2D) weight gradient."""
    k1, nb = 2 * d + de + 1, 2 * d
    kg, cg = (k1 + 3) // 4, (nb + 3) // 4
    s = partial.reshape(-1, kg, cg, 4, 4).sum(0)
    return s.permute(0, 2, 1, 3).reshape(4 * kg, 4 * cg)[:k1, :nb]


# ------------------------------------------------------------------ wrappers


def _check_inputs(x, xj, dist, dst, mask, w):
    _check_cuda("x", x, torch.float32, 2)
    _check_cuda("xj", xj, torch.float32, 2)
    _check_cuda("dist", dist, torch.float32, 1)
    _check_cuda("dst", dst, torch.int32, 1)
    _check_cuda("mask", mask, torch.float32, 1)
    e, d = xj.shape
    if x.shape[1] != d or dist.shape[0] != e or dst.shape[0] != e \
            or mask.shape[0] != e:
        raise ValueError(
            f"fused_cgconv: inconsistent shapes x {tuple(x.shape)}, xj "
            f"{tuple(xj.shape)}, dist {tuple(dist.shape)}, dst "
            f"{tuple(dst.shape)}, mask {tuple(mask.shape)}")
    if d > MAX_WIDTH:
        raise ValueError(f"fused_cgconv: D={d} is wider than the kernels' "
                         f"{MAX_WIDTH}")
    devs = {t.device for t in (x, xj, dist, dst, mask, w)}
    if len(devs) != 1:
        raise ValueError(f"fused_cgconv: tensors on several devices {devs}")


def fused_cgconv(x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj, wse,
                 bs, num_nodes: int, edge_width: float) -> torch.Tensor:
    """(num_nodes, D) f32 sums of the gated messages at dst."""
    if x.device.type == "cpu":
        return fused_cgconv_plain(x, xj, dist, dst, mask, wfi, wfj, wfe, bf,
                                  wsi, wsj, wse, bs, num_nodes, edge_width)
    w = pack_weights(wfi, wfj, wfe, bf, wsi, wsj, wse, bs)
    _check_inputs(x, xj, dist, dst, mask, w)
    e, d = xj.shape
    de = wfe.shape[0]
    if x.shape[0] != num_nodes:
        raise ValueError(f"fused_cgconv: x has {x.shape[0]} rows, "
                         f"num_nodes is {num_nodes}")
    out = torch.zeros((num_nodes, d), dtype=torch.float32, device=x.device)
    if e == 0 or d == 0 or num_nodes == 0:
        return out
    lib = _load()
    coeff, step = _basis_constants(de, edge_width)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cgconv_fwd(
            x.data_ptr(), xj.data_ptr(), dist.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), w.data_ptr(), out.data_ptr(), e, d, de,
            num_nodes, coeff, step, stream)
    _raise_on(rc, "mdl_fused_cgconv_fwd")
    LAUNCHES["fused_cgconv_fwd"] += 1
    return out


def wgrad_reduce(partial: torch.Tensor, blocks: int, d: int, de: int
                 ) -> torch.Tensor:
    """Sum of the backward's per-block partial weight gradients →
    (2D+De+1, 2D)."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, d, de)
    _check_cuda("partial", partial, torch.float32, 1)
    lib = _load()
    if partial.numel() != blocks * lib.mdl_fused_cgconv_partial_floats(d, de):
        raise ValueError(f"wgrad_reduce: {partial.numel()} partial floats do "
                         f"not match {blocks} blocks at D={d}, De={de}")
    dw = torch.empty((2 * d + de + 1, 2 * d), dtype=torch.float32,
                     device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cgconv_wgrad_reduce(partial.data_ptr(),
                                               dw.data_ptr(), blocks, d, de,
                                               stream)
    _raise_on(rc, "mdl_fused_cgconv_wgrad_reduce")
    LAUNCHES["fused_cgconv_wgrad_reduce"] += 1
    return dw


def fused_cgconv_bwd_partials(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf,
                              wsi, wsj, wse, bs, num_nodes: int,
                              edge_width: float) -> tuple:
    """The backward kernel alone (CUDA tensors only): (d_x, d_xj, partial,
    blocks), where partial holds each block's share of the weight
    gradient for wgrad_reduce."""
    w = pack_weights(wfi, wfj, wfe, bf, wsi, wsj, wse, bs)
    _check_inputs(x, xj, dist, dst, mask, w)
    _check_cuda("g", g, torch.float32, 2)
    e, d = xj.shape
    de = wfe.shape[0]
    if g.shape != (num_nodes, d) or x.shape[0] != num_nodes:
        raise ValueError(f"fused_cgconv_bwd: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be ({num_nodes}, {d})")
    dev = x.device
    d_x = torch.zeros((num_nodes, d), dtype=torch.float32, device=dev)
    d_xj = torch.zeros((e, d), dtype=torch.float32, device=dev)
    lib = _load()
    blocks = max(1, min(-(-e // 32), BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count))
    partial = torch.zeros(blocks * lib.mdl_fused_cgconv_partial_floats(d, de),
                          dtype=torch.float32, device=dev)
    if e > 0 and d > 0 and num_nodes > 0:
        wt = w[:2 * d].t().contiguous()
        coeff, step = _basis_constants(de, edge_width)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mdl_fused_cgconv_bwd(
                x.data_ptr(), xj.data_ptr(), dist.data_ptr(), dst.data_ptr(),
                mask.data_ptr(), w.data_ptr(), wt.data_ptr(), g.data_ptr(),
                d_x.data_ptr(), d_xj.data_ptr(), partial.data_ptr(), e, d, de,
                num_nodes, coeff, step, blocks, stream)
        _raise_on(rc, "mdl_fused_cgconv_bwd")
        LAUNCHES["fused_cgconv_bwd"] += 1
    return d_x, d_xj, partial, blocks


def fused_cgconv_bwd(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj,
                     wse, bs, num_nodes: int, edge_width: float) -> tuple:
    """Gradients of fused_cgconv for the output cotangent g: (d_x, d_xj,
    d_wfi, d_wfj, d_wfe, d_bf, d_wsi, d_wsj, d_wse, d_bs)."""
    if x.device.type == "cpu":
        return fused_cgconv_bwd_plain(g, x, xj, dist, dst, mask, wfi, wfj, wfe,
                                      bf, wsi, wsj, wse, bs, num_nodes,
                                      edge_width)
    d_x, d_xj, partial, blocks = fused_cgconv_bwd_partials(
        g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj, wse, bs,
        num_nodes, edge_width)
    dw = wgrad_reduce(partial, blocks, xj.shape[1], wfe.shape[0])
    return (d_x, d_xj) + unpack_weights(dw, xj.shape[1], bf.shape)


# ------------------------------------------------------------------ autograd


class FusedCGConv(torch.autograd.Function):
    """fused_cgconv with the fused backward kernel as its backward; no
    gradient for dist, dst, mask, num_nodes or edge_width."""

    @staticmethod
    def forward(ctx, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj, wse,
                bs, num_nodes, edge_width):
        ctx.save_for_backward(x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi,
                              wsj, wse, bs)
        ctx.num_nodes, ctx.edge_width = num_nodes, edge_width
        return fused_cgconv(x.contiguous(), xj.contiguous(), dist, dst, mask,
                            wfi, wfj, wfe, bf, wsi, wsj, wse, bs, num_nodes,
                            edge_width)

    @staticmethod
    def backward(ctx, g):
        x, xj, dist, dst, mask, *ws = ctx.saved_tensors
        d_x, d_xj, *d_ws = fused_cgconv_bwd(
            g.contiguous(), x.contiguous(), xj.contiguous(), dist, dst, mask,
            *ws, ctx.num_nodes, ctx.edge_width)
        return (d_x, d_xj, None, None, None, *d_ws, None, None)
