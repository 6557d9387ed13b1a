"""Windowed segment-sum, SpMM and gather: hand-written CUDA kernels with
plain twins, over the graph-aligned windowed edge layout.

The three kernels in csrc/windowed.cu replace the reference package's
ops/pallas_segment.py:_seg_sum_kernel, :_seg_sum_weighted_kernel and
:_gather_kernel:

  windowed_segment_sum(msg, we, n)[v] = Σ_{e: dst[e]=v} msg[e]
  windowed_spmm(w, msg, we, n)[v]     = Σ_{e: dst[e]=v} w[e]·msg[e]
  windowed_gather(x, we)[e]           = x[dst[e]]  (a zero row on pad slots)

The layout (data/windowed.py, data/batching.py:assemble_batch_windowed):
nodes in windows of tw rows, edges in tiles of te slots, every tile's real
edges in one window (`window_id`), each window's tiles consecutive and the
first one flagged (`first_tile`), pad slots with dst = -1. A slot counts
only where its dst lies in its tile's window: pad slots are skipped, never
multiplied by 0, so whatever they hold (NaN included) stays out of the
sums. Windows that own no tile sum to zero.

What the TPU kernels needed and these do not: the one-hot (TE, TW) MXU
matmul and the hi/lo bf16 split; the sums run in f32 on the CUDA cores.

`single_pass=True` is the reference's single-pass MXU arm (`hilo=False`,
which `kernel_precision: bf16` selects, ops/pallas_segment.py:132-167):
the data operand of each one-hot product is rounded to bf16, to nearest
with ties to even, and the sum stays f32. The sum rounds msg, the SpMM
rounds w·msg after the f32 product, the gather rounds the gathered rows;
the kernels are the f32 ones with that rounding (csrc/windowed.cu, kSP).

The autograd Functions carry the reference's custom VJPs, in the forward's
arm: the sum's backward is the gather; the SpMM's backward is the gather,
then d_msg = gg·w and d_w = Σ_d msg·gg in f32 torch, as the reference
computes them outside its kernel; the gather's backward is the sum.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches (plain calls are not counted),
`LAUNCHES_SP` those of the single-pass arm. The library is built with nvcc
at first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from matdeeplearn_torch.data.windowed import round_up
from matdeeplearn_torch.ops import _build
from matdeeplearn_torch.ops.csr import (_check_cuda, _ptr, _raise_on, count,
                                        round_bf16)

LAUNCHES = {"windowed_segment_sum": 0, "windowed_spmm": 0, "windowed_gather": 0}
# the single-pass arm's launches, counted apart
LAUNCHES_SP = {"windowed_segment_sum_sp": 0, "windowed_spmm_sp": 0,
               "windowed_gather_sp": 0}

_lib = None


class WindowedEdges(NamedTuple):
    """Edge arrays re-bucketed into aligned dst windows."""

    order: torch.Tensor       # (EW,) int64 gather map into the original edge
                              #   arrays (0 on pad slots)
    dst: torch.Tensor         # (EW,) int32 destination, -1 on pad slots
    window_id: torch.Tensor   # (T,) int32 window of each edge tile
    first_tile: torch.Tensor  # (T,) int32 1 where a tile starts its window
    valid: torch.Tensor       # (EW,) float32 1 on real edge slots

    @property
    def num_tiles(self) -> int:
        return self.window_id.shape[0]


def windowed_sizes(num_nodes: int, num_edges: int, tw: int, te: int):
    """(number of windows, padded edge capacity) for a batch shape."""
    nw = max(1, round_up(num_nodes, tw) // tw)
    return nw, round_up(num_edges, te) + nw * te


def windowize_edges(edge_dst, edge_mask, num_nodes: int, tw: int, te: int
                    ) -> WindowedEdges:
    """The windowed layout of a flat edge list whose real edges are sorted
    by dst (pads anywhere): each window's edges padded to whole tiles, an
    empty window given one tile, the tiles past the packed extent parked on
    the last window. The tests build random layouts with it."""
    e = edge_dst.shape[0]
    dev = edge_dst.device
    nw, ew = windowed_sizes(num_nodes, e, tw, te)
    valid_in = edge_mask > 0
    w_of_edge = torch.where(valid_in, edge_dst.long() // tw, nw - 1)
    counts = torch.zeros(nw, dtype=torch.int64, device=dev).index_add_(
        0, w_of_edge, valid_in.long())
    padded = torch.clamp((counts + te - 1) // te * te, min=te)
    pad_off = torch.cumsum(padded, 0) - padded
    real_off = torch.cumsum(counts, 0) - counts
    eidx = torch.arange(e, device=dev)
    pos = torch.where(valid_in, pad_off[w_of_edge] + eidx - real_off[w_of_edge],
                      ew)  # pads land on a dropped extra slot
    order = torch.zeros(ew + 1, dtype=torch.int64, device=dev)
    order[pos] = eidx
    taken = torch.zeros(ew + 1, dtype=torch.bool, device=dev)
    taken[pos] = True
    order, taken = order[:ew], taken[:ew]
    dst = torch.where(taken, edge_dst[order].long(), -1).to(torch.int32)
    tile_start = torch.arange(ew // te, device=dev) * te
    window_id = torch.clamp(torch.searchsorted(torch.cumsum(padded, 0),
                                               tile_start, right=True),
                            max=nw - 1)
    first_tile = tile_start == pad_off[window_id]
    return WindowedEdges(order=order, dst=dst,
                         window_id=window_id.to(torch.int32),
                         first_tile=first_tile.to(torch.int32),
                         valid=taken.to(torch.float32))


# ------------------------------------------------------------- plain versions


def slot_valid(dst, window_id, tw: int, n: int):
    """(EW,) bool: the slot's dst is a node below n in its tile's window."""
    te = dst.shape[0] // window_id.shape[0]
    win = window_id.long().repeat_interleave(te)
    d = dst.long()
    return (d >= 0) & (d < n) & (d // tw == win)


def segment_sum_plain(msg, dst, window_id, n: int, tw: int, w=None,
                      single_pass: bool = False):
    """Plain PyTorch windowed sum (and SpMM with weights `w`): index_add_ on
    the clamped dst, with invalid slots replaced by zeros (not multiplied,
    so a NaN on a pad slot stays out). single_pass: msg (w·msg) rounded to
    bf16 before the sum."""
    valid = slot_valid(dst, window_id, tw, n)[:, None]
    m = msg if w is None else msg * w[:, None]
    if single_pass:
        m = round_bf16(m)
    m = torch.where(valid, m, torch.zeros((), dtype=msg.dtype, device=msg.device))
    out = torch.zeros((n, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, torch.clamp(dst.long(), min=0), m)


def gather_plain(x, dst, window_id, tw: int, single_pass: bool = False):
    """Plain PyTorch windowed gather: index_select on the clamped dst,
    zero rows on invalid slots. single_pass: the rows rounded to bf16."""
    valid = slot_valid(dst, window_id, tw, x.shape[0])[:, None]
    out = torch.index_select(x, 0, torch.clamp(dst.long(), min=0))
    if single_pass:
        out = round_bf16(out)
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------ wrappers


def _load():
    """The bound library of csrc/windowed.cu (built at first use)."""
    global _lib
    if _lib is None:
        lib = _build.library("windowed")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mdl_windowed_segment_sum.argtypes = [vp, vp, vp, vp, vp, vp,
                                                 ci, ci, ci, ci, ci, ci, vp]
        lib.mdl_windowed_segment_sum.restype = ci
        lib.mdl_windowed_gather.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                            ci, ci, ci, vp]
        lib.mdl_windowed_gather.restype = ci
        _lib = lib
    return _lib


def _check_layout(dst, window_id, first_tile, e, device):
    _check_cuda("dst", dst, torch.int32, 1)
    _check_cuda("window_id", window_id, torch.int32, 1)
    _check_cuda("first_tile", first_tile, torch.int32, 1)
    t = window_id.shape[0]
    if dst.shape[0] != e or first_tile.shape[0] != t or t == 0 or e % t:
        raise ValueError(f"windowed layout: {e} edge slots, dst "
                         f"{tuple(dst.shape)}, {t} tiles, first_tile "
                         f"{tuple(first_tile.shape)}: the tiles must split "
                         "the slots evenly")
    for name, x in (("dst", dst), ("window_id", window_id),
                    ("first_tile", first_tile)):
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
    return e // t


def _sum(msg, w, we: WindowedEdges, n: int, tw: int, key: str,
         single_pass: bool):
    """The sum or, with weights w, the SpMM: plain on the CPU, the kernel on
    the card."""
    if msg.device.type == "cpu":
        return segment_sum_plain(msg, we.dst, we.window_id, n, tw, w,
                                 single_pass)
    _check_cuda("msg", msg, torch.float32, 2)
    e, d = msg.shape
    te = _check_layout(we.dst, we.window_id, we.first_tile, e, msg.device)
    if w is not None:
        _check_cuda("w", w, torch.float32, 1)
        if w.shape[0] != e or w.device != msg.device:
            raise ValueError(f"w: expected ({e},) on {msg.device}, got "
                             f"{tuple(w.shape)} on {w.device}")
    out = torch.zeros((n, d), dtype=torch.float32, device=msg.device)
    if d == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_windowed_segment_sum(
            msg.data_ptr(), _ptr(w), we.dst.data_ptr(), we.window_id.data_ptr(),
            we.first_tile.data_ptr(), out.data_ptr(), e, d, n, tw, te,
            int(single_pass), stream)
    _raise_on(rc, "mdl_windowed_segment_sum")
    count(LAUNCHES, LAUNCHES_SP, key, single_pass)
    return out


def segment_sum(msg: torch.Tensor, we: WindowedEdges, n: int, tw: int,
                single_pass: bool = False) -> torch.Tensor:
    """(EW, D) f32 messages in windowed order → (n, D) f32 sums at dst."""
    return _sum(msg, None, we, n, tw, "windowed_segment_sum", single_pass)


def spmm(w: torch.Tensor, msg: torch.Tensor, we: WindowedEdges, n: int,
         tw: int, single_pass: bool = False) -> torch.Tensor:
    """(EW,) f32 weights and (EW, D) f32 messages → (n, D) f32 weighted sums."""
    return _sum(msg, w, we, n, tw, "windowed_spmm", single_pass)


def gather(x: torch.Tensor, we: WindowedEdges, tw: int,
           single_pass: bool = False) -> torch.Tensor:
    """(N, D) f32 rows → (EW, D) f32 rows x[dst], zero on invalid slots."""
    if x.device.type == "cpu":
        return gather_plain(x, we.dst, we.window_id, tw, single_pass)
    _check_cuda("x", x, torch.float32, 2)
    n, d = x.shape
    e = we.dst.shape[0]
    te = _check_layout(we.dst, we.window_id, we.first_tile, e, x.device)
    out = torch.empty((e, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    lib = _load()
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_windowed_gather(
            x.data_ptr(), we.dst.data_ptr(), we.window_id.data_ptr(),
            out.data_ptr(), e, d, n, tw, te, vec4, int(single_pass), stream)
    _raise_on(rc, "mdl_windowed_gather")
    count(LAUNCHES, LAUNCHES_SP, "windowed_gather", single_pass)
    return out


# ------------------------------------------------------------------ autograd


class WindowedSegmentSum(torch.autograd.Function):
    """segment_sum with the gather as its backward, in the same arm."""

    @staticmethod
    def forward(ctx, msg, we, n, tw, single_pass=False):
        ctx.we, ctx.tw, ctx.single_pass = we, tw, single_pass
        return segment_sum(msg.contiguous(), we, n, tw, single_pass)

    @staticmethod
    def backward(ctx, g):
        return (gather(g.contiguous(), ctx.we, ctx.tw, ctx.single_pass), None,
                None, None, None)


class WindowedSpmm(torch.autograd.Function):
    """spmm with the reference's VJP: gg = gather(g) in the same arm,
    d_msg = gg·w, d_w = Σ_d msg·gg; only the gradients asked for are
    formed."""

    @staticmethod
    def forward(ctx, w, msg, we, n, tw, single_pass=False):
        ctx.save_for_backward(w, msg)
        ctx.we, ctx.tw, ctx.single_pass = we, tw, single_pass
        return spmm(w.contiguous(), msg.contiguous(), we, n, tw, single_pass)

    @staticmethod
    def backward(ctx, g):
        w, msg = ctx.saved_tensors
        need_w, need_msg = ctx.needs_input_grad[:2]
        if not (need_w or need_msg):
            return None, None, None, None, None, None
        gg = gather(g.contiguous(), ctx.we, ctx.tw, ctx.single_pass)
        d_w = torch.sum(msg * gg, dim=-1) if need_w else None
        d_msg = gg * w[:, None] if need_msg else None
        return d_w, d_msg, None, None, None, None


class WindowedGather(torch.autograd.Function):
    """gather with segment_sum as its backward, in the same arm."""

    @staticmethod
    def forward(ctx, x, we, tw, single_pass=False):
        ctx.we, ctx.tw, ctx.n = we, tw, x.shape[0]
        ctx.single_pass = single_pass
        return gather(x.contiguous(), we, tw, single_pass)

    @staticmethod
    def backward(ctx, g):
        return (segment_sum(g.contiguous(), ctx.we, ctx.n, ctx.tw,
                            ctx.single_pass), None, None, None)


def windowed_segment_sum(msg, we: WindowedEdges, n: int, tw: int,
                         single_pass: bool = False):
    """Differentiable windowed segment-sum (the reference's
    windowed_segment_sum); (EW, D) → (n, D)."""
    return WindowedSegmentSum.apply(msg, we, n, tw, single_pass)


def windowed_spmm(w, msg, we: WindowedEdges, n: int, tw: int,
                  single_pass: bool = False):
    """Differentiable windowed SpMM (the reference's windowed_spmm), in
    both operands; (EW,), (EW, D) → (n, D)."""
    return WindowedSpmm.apply(w, msg, we, n, tw, single_pass)


def windowed_gather(x, we: WindowedEdges, tw: int, single_pass: bool = False):
    """Differentiable windowed gather (the reference's windowed_gather);
    (N, D) → (EW, D)."""
    return WindowedGather.apply(x, we, tw, single_pass)
