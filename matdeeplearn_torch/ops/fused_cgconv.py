"""Fused CGConv: message MLPs, Gaussian edge basis and sum aggregation in
one hand-written CUDA kernel, with a fused backward, all on the tensor
cores.

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
`LAUNCHES` counts kernel launches. Every product runs on the tensor cores
in 3xTF32 (f32 accuracy; csrc/fused_cgconv.cu says how). The forward
(`fused_cgconv_fwd`) is one call of two launches, a split of the weight
into TF32 hi/lo in the order of its wgmma B descriptors (`fwd_b` and
`split_kmajor` say which) and the edge tiles; bound: operations, 4.55e9
FLOP at chip_smoke's training batch, 0.0276 ms at 495/3 TFLOP/s. The
backward launches three kernels, on mma.sync: the edge rows
(`fused_cgconv_bwd_rows`: d_x, d_xj and dA = [d_af | d_as]), the weight
gradient in slices (`fused_cgconv_wgrad`: zᵀ·dA over strided 32-edge
chunks) and the fixed-order sum of the slices (`wgrad_reduce`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import _check_cuda, _raise_on, segment_sum_plain
from matdeeplearn_torch.ops.edge_basis import gaussian_basis

LAUNCHES = {"fused_cgconv_fwd": 0, "fused_cgconv_bwd": 0,
            "fused_cgconv_wgrad": 0, "fused_cgconv_wgrad_reduce": 0}
MAX_WIDTH = 256      # the kernels' largest D
WGRAD_CHUNK = 32     # edges of a weight-gradient chunk (csrc kWK)
BLOCKS_PER_SM = 2    # weight-gradient blocks per SM the slice count aims at

_lib = None


def _load():
    """The bound library of csrc/fused_cgconv.cu (ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("fused_cgconv")
        vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.mdl_fused_cgconv_fwd.argtypes = [vp] * 8 + [cl, ci, ci, ci, cf, cf, vp]
        lib.mdl_fused_cgconv_fwd.restype = ci
        lib.mdl_fused_cgconv_fwd_split_words.argtypes = [ci, ci]
        lib.mdl_fused_cgconv_fwd_split_words.restype = cl
        lib.mdl_fused_cgconv_bwd.argtypes = ([vp] * 11
                                             + [cl, ci, ci, ci, cf, cf, vp])
        lib.mdl_fused_cgconv_bwd.restype = ci
        lib.mdl_fused_cgconv_wgrad.argtypes = ([vp] * 7
                                               + [cl, ci, ci, ci, cf, cf, ci, vp])
        lib.mdl_fused_cgconv_wgrad.restype = ci
        lib.mdl_fused_cgconv_wgrad_reduce.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.mdl_fused_cgconv_wgrad_reduce.restype = ci
        lib.mdl_fused_cgconv_partial_floats.argtypes = [ci, ci]
        lib.mdl_fused_cgconv_partial_floats.restype = cl
        lib.mdl_fused_cgconv_wgrad_tiles.argtypes = [ci, ci]
        lib.mdl_fused_cgconv_wgrad_tiles.restype = ci
        _lib = lib
    return _lib


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_weights(wfi, wfj, wfe, bf, wsi, wsj, wse, bs) -> torch.Tensor:
    """The kernels' (2D+De+1, 2D) weight: [[wfi wsi]; [wfj wsj]; [wfe wse];
    [bf bs]]."""
    return torch.cat([torch.cat([wfi, wsi], 1), torch.cat([wfj, wsj], 1),
                      torch.cat([wfe, wse], 1),
                      torch.cat([bf.reshape(1, -1), bs.reshape(1, -1)], 1)],
                     0).contiguous()


def pad_weights(w: torch.Tensor, d: int) -> tuple:
    """The backward kernel's weights, from pack_weights' w: (Wp, WTp). Wp is
    w with its rows padded to round8(2D+De+1) and each half of its columns
    to DP = round8(D), zeros in the pads; WTp is W[:2D]ᵀ in the same padded
    layout, (2·DP, 2·DP): WTp[h·DP + c, h'·DP + c'] = w[h'·D + c', h·D + c].
    Every row is then a whole number of 16-byte copies."""
    k1, dp = w.shape[0], _round(d, 8)
    wp = w.new_zeros(_round(k1, 8), 2, dp)
    wp[:k1, :, :d] = w.view(k1, 2, d)
    wtp = w.new_zeros(2, dp, 2, dp)
    wtp[..., :d] = wp[:2 * d].view(2, d, 2, dp).permute(2, 3, 0, 1)
    return wp.view(-1, 2 * dp), wtp.view(2 * dp, 2 * dp)


def unpack_weights(w: torch.Tensor, d: int, bias_shape) -> tuple:
    """Inverse of pack_weights: (wfi, wfj, wfe, bf, wsi, wsj, wse, bs)."""
    f, s = w[:, :d], w[:, d:]
    return (f[:d], f[d:2 * d], f[2 * d:-1], f[-1].reshape(bias_shape),
            s[:d], s[d:2 * d], s[2 * d:-1], s[-1].reshape(bias_shape))


def ntw_bucket(nt: int) -> int:
    """The n8-tiles a warpgroup of the wgmma kernels spans for nt needed
    (csrc/wgmma.cuh:ntw_bucket): the smallest of 4, 13, 19, 25, 32 that is
    >= nt, or 0 past 32."""
    return next((b for b in (4, 13, 19, 25, 32) if nt <= b), 0)


def fwd_b(w: torch.Tensor, d: int) -> torch.Tensor:
    """The forward kernel's B operand, (NP, round8(K1)), from pack_weights'
    w: B[n, k] = w[k, (n % 2)·D + n // 2] for n // 2 < D, zero beyond, with
    NP = 8·NTW·WN the columns of its warpgroups (one warpgroup of
    ntw_bucket(⌈2D/8⌉) n8-tiles up to D = 128, two of ntw_bucket(⌈D/8⌉)
    past it). af and as of one feature are adjacent rows of B, so they land
    in one thread's accumulator pair."""
    k1 = w.shape[0]
    wn = 1 if d <= 128 else 2
    np_ = 8 * wn * ntw_bucket(-(-2 * d // 8) if wn == 1 else -(-d // 8))
    b = w.new_zeros(np_, _round(k1, 8))
    b[:2 * d:2, :k1] = w[:, :d].t()
    b[1:2 * d:2, :k1] = w[:, d:].t()
    return b


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the f32 word rounded to 10 mantissa bits, to
    nearest with ties away from zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_kmajor(b: torch.Tensor) -> torch.Tensor:
    """What csrc/wgmma.cuh:split_kmajor_kernel writes for a B operand b
    (NP rows, 8·S columns): int32 words, per k-step s the TF32 hi part, then
    the lo part (tf32(b - hi)), each NP/8 groups of two 8 x 4 core matrices
    (the k-step's columns 0-3, then 4-7), rows of 4 contiguous words."""
    np_, kp = b.shape
    hi = tf32(b)
    parts = torch.stack([hi, tf32(b - hi)])             # (2, NP, 8·S)
    words = parts.view(2, np_ // 8, 8, kp // 8, 2, 4)   # part, n8, r, s, kh, c
    return words.permute(3, 0, 1, 4, 2, 5).contiguous().view(torch.int32).reshape(-1)


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


def _edge_terms(x, xj, dist, dst, mask, num_nodes: int, de: int,
                edge_width: float) -> tuple:
    """(z, w): the (E, 2D+De+1) rows [x[dst] | xj | basis | 1] and each
    edge's weight (mask, 0 where dst lies outside [0, num_nodes)), with z
    zero on edges of weight 0, as the kernels see them."""
    real = (dst >= 0) & (dst < num_nodes)
    w = torch.where(real, mask, torch.zeros_like(mask))
    xi = x[torch.where(real, dst, 0).to(torch.int64)]
    z = torch.cat([xi, xj, gaussian_basis(dist, 0.0, 1.0, de, edge_width),
                   torch.ones_like(dist)[:, None]], 1)
    return torch.where((w != 0)[:, None], z, torch.zeros_like(z)), w


def bwd_rows_plain(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj,
                   wse, bs, num_nodes: int, edge_width: float) -> tuple:
    """Plain version of the backward's edge kernel: (d_x, d_xj, da), da
    the (E, 2·DP) rows [d_af | d_as], each half zero-padded to DP =
    round8(D), zero on masked edges (the kernel leaves those rows
    unwritten)."""
    d, de = xj.shape[1], wfe.shape[0]
    w = pack_weights(wfi, wfj, wfe, bf, wsi, wsj, wse, bs)
    z, we = _edge_terms(x, xj, dist, dst, mask, num_nodes, de, edge_width)
    a = z @ w
    af, as_ = a[:, :d], a[:, d:]
    idx = torch.where(we != 0, dst, 0).to(torch.int64)
    gg = g[idx] * we[:, None]
    sf = torch.sigmoid(af)
    dan = torch.cat([gg * F.softplus(as_) * sf * (1 - sf),
                     gg * sf * torch.sigmoid(as_)], 1)
    dz = dan @ w[:2 * d].t()
    d_x = torch.zeros_like(x).index_add_(0, idx, dz[:, :d])
    da = dan.new_zeros(dan.shape[0], 2, _round(d, 8))
    da[..., :d] = dan.view(-1, 2, d)
    return d_x, dz[:, d:].contiguous(), da.view(dan.shape[0], -1)


def wgrad_partials_plain(x, xj, dist, dst, mask, da, num_nodes: int,
                         de: int, edge_width: float, slices: int
                         ) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: slice s holds the sum
    over the 32-edge chunks s, s + slices, ... of zᵀ·[d_af | d_as], in
    wgrad_reduce's micro-tile layout (zeros in its pads)."""
    d = xj.shape[1]
    z, w = _edge_terms(x, xj, dist, dst, mask, num_nodes, de, edge_width)
    dan = da.view(-1, 2, _round(d, 8))[..., :d].reshape(-1, 2 * d)
    dan = torch.where((w != 0)[:, None], dan, torch.zeros_like(dan))
    chunk = torch.arange(z.shape[0], device=z.device) // WGRAD_CHUNK
    dw = torch.stack([z[chunk % slices == s].t() @ dan[chunk % slices == s]
                      for s in range(slices)])
    return to_partial_layout(dw)


def to_partial_layout(dw: torch.Tensor) -> torch.Tensor:
    """(S, K, N) slices → wgrad_reduce's flat layout: per slice, micro-tile
    m = (k // 4)·CG + n // 4 (CG = round4(N)/4) holds dw[4·(m // CG) + i,
    4·(m % CG) + q] at 16·m + 4·i + q, zeros where k or n overrun."""
    s, k, n = dw.shape
    kg, cg = -(-k // 4), -(-n // 4)
    p = dw.new_zeros(s, 4 * kg, 4 * cg)
    p[:, :k, :n] = dw
    return p.view(s, kg, 4, cg, 4).permute(0, 1, 3, 2, 4).reshape(-1)


def from_partial_layout(partial: torch.Tensor, k: int, n: int
                        ) -> torch.Tensor:
    """Inverse of to_partial_layout: the (S, K, N) slices."""
    kg, cg = -(-k // 4), -(-n // 4)
    p = partial.reshape(-1, kg, cg, 4, 4).permute(0, 1, 3, 2, 4)
    return p.reshape(-1, 4 * kg, 4 * cg)[:, :k, :n]


def wgrad_reduce_plain(partial: torch.Tensor, d: int, de: int) -> torch.Tensor:
    """Plain version of the slice sum: the (2D+De+1, 2D) weight gradient
    from to_partial_layout's slices."""
    return from_partial_layout(partial, 2 * d + de + 1, 2 * d).sum(0)


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
    words = lib.mdl_fused_cgconv_fwd_split_words(d, de)
    if words < 0:
        _raise_on(-words, "mdl_fused_cgconv_fwd_split_words")
    # the kernel's TF32 hi/lo split of w, in the order its tiles read it
    ws = torch.empty(words, dtype=torch.int32, device=x.device)
    coeff, step = _basis_constants(de, edge_width)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cgconv_fwd(
            x.data_ptr(), xj.data_ptr(), dist.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(), e,
            d, de, num_nodes, coeff, step, stream)
    _raise_on(rc, "mdl_fused_cgconv_fwd")
    LAUNCHES["fused_cgconv_fwd"] += 1
    return out


def wgrad_reduce(partial: torch.Tensor, blocks: int, d: int, de: int
                 ) -> torch.Tensor:
    """Sum of the weight gradient's `blocks` slices → (2D+De+1, 2D), in a
    fixed order (bit-identical from run to run)."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, d, de)
    _check_cuda("partial", partial, torch.float32, 1)
    lib = _load()
    if partial.numel() != blocks * lib.mdl_fused_cgconv_partial_floats(d, de):
        raise ValueError(f"wgrad_reduce: {partial.numel()} partial floats do "
                         f"not match {blocks} slices at D={d}, De={de}")
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


def fused_cgconv_bwd_rows(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf,
                          wsi, wsj, wse, bs, num_nodes: int,
                          edge_width: float) -> tuple:
    """The backward's edge kernel: (d_x, d_xj, da), da the (E, 2·DP) rows
    [d_af | d_as] of real edges for fused_cgconv_wgrad (bwd_rows_plain
    says the layout; rows of masked edges are not written on the card)."""
    if x.device.type == "cpu":
        return bwd_rows_plain(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf,
                              wsi, wsj, wse, bs, num_nodes, edge_width)
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
    da = torch.empty((e, 2 * _round(d, 8)), dtype=torch.float32, device=dev)
    if e == 0 or d == 0 or num_nodes == 0:
        return d_x, torch.zeros_like(xj), da
    d_xj = torch.empty((e, d), dtype=torch.float32, device=dev)
    wp, wtp = pad_weights(w, d)
    lib = _load()
    coeff, step = _basis_constants(de, edge_width)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cgconv_bwd(
            x.data_ptr(), xj.data_ptr(), dist.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), wp.data_ptr(), wtp.data_ptr(), g.data_ptr(),
            d_x.data_ptr(), d_xj.data_ptr(), da.data_ptr(), e, d, de,
            num_nodes, coeff, step, stream)
    _raise_on(rc, "mdl_fused_cgconv_bwd")
    LAUNCHES["fused_cgconv_bwd"] += 1
    return d_x, d_xj, da


def wgrad_slices(e: int, d: int, de: int, device) -> int:
    """The weight gradient's slice count on a CUDA device: about
    BLOCKS_PER_SM blocks an SM, and no more slices than 32-edge chunks."""
    tiles = _load().mdl_fused_cgconv_wgrad_tiles(d, de)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-e // WGRAD_CHUNK), round(BLOCKS_PER_SM * sms / tiles)))


def fused_cgconv_wgrad(x, xj, dist, dst, mask, da, num_nodes: int, de: int,
                       edge_width: float, slices: int | None = None) -> tuple:
    """The backward's weight-gradient kernel: (partial, slices), the slices
    of zᵀ·[d_af | d_as] over strided 32-edge chunks in wgrad_reduce's
    layout. `slices` defaults to wgrad_slices on the card and 1 on the
    CPU."""
    if x.device.type == "cpu":
        s = slices or 1
        return wgrad_partials_plain(x, xj, dist, dst, mask, da, num_nodes, de,
                                    edge_width, s), s
    _check_inputs(x, xj, dist, dst, mask, da)
    _check_cuda("da", da, torch.float32, 2)
    e, d = xj.shape
    if da.shape != (e, 2 * _round(d, 8)):
        raise ValueError(f"fused_cgconv_wgrad: da {tuple(da.shape)} must be "
                         f"({e}, {2 * _round(d, 8)})")
    lib = _load()
    s = slices or wgrad_slices(e, d, de, x.device)
    floats = s * lib.mdl_fused_cgconv_partial_floats(d, de)
    if e == 0 or d == 0 or num_nodes == 0:
        return torch.zeros(floats, dtype=torch.float32, device=x.device), s
    partial = torch.empty(floats, dtype=torch.float32, device=x.device)
    coeff, step = _basis_constants(de, edge_width)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_fused_cgconv_wgrad(
            x.data_ptr(), xj.data_ptr(), dist.data_ptr(), dst.data_ptr(),
            mask.data_ptr(), da.data_ptr(), partial.data_ptr(), e, d, de,
            num_nodes, coeff, step, s, stream)
    _raise_on(rc, "mdl_fused_cgconv_wgrad")
    LAUNCHES["fused_cgconv_wgrad"] += 1
    return partial, s


def fused_cgconv_bwd(g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj,
                     wse, bs, num_nodes: int, edge_width: float) -> tuple:
    """Gradients of fused_cgconv for the output cotangent g: (d_x, d_xj,
    d_wfi, d_wfj, d_wfe, d_bf, d_wsi, d_wsj, d_wse, d_bs)."""
    if x.device.type == "cpu":
        return fused_cgconv_bwd_plain(g, x, xj, dist, dst, mask, wfi, wfj, wfe,
                                      bf, wsi, wsj, wse, bs, num_nodes,
                                      edge_width)
    d, de = xj.shape[1], wfe.shape[0]
    d_x, d_xj, da = fused_cgconv_bwd_rows(
        g, x, xj, dist, dst, mask, wfi, wfj, wfe, bf, wsi, wsj, wse, bs,
        num_nodes, edge_width)
    partial, slices = fused_cgconv_wgrad(x, xj, dist, dst, mask, da,
                                         num_nodes, de, edge_width)
    dw = wgrad_reduce(partial, slices, d, de)
    return (d_x, d_xj) + unpack_weights(dw, d, bf.shape)


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
