"""CSR segment-sum and gather: hand-written CUDA kernels with plain twins.

The two kernels in csrc/csr.cu replace the reference package's
ops/pallas_csr.py:_csr_sum_kernel and :_csr_gather_kernel. Each is the
other's backward, as in that package's custom_vjp pair:

  segment_sum(msg, dst, mask, n)[n] = Σ_{e: dst[e]=n} msg[e]·mask[e]
  gather(x, dst, mask)[e]          = x[dst[e]]·mask[e]  (zero row if mask 0)

Both are bound by bytes on the card (one read of each input, one write of
each output, at most one multiply-add per element); csrc/csr.cu describes
each design. segment_sum is right for any index order and any mask; where
the real edges are sorted and pads follow them (the port's sorted
batches), each row is summed in edge order by one warp, so the result is
the same bits every run. An index outside [0, n) adds nothing and gathers
a zero row, in the kernels and their plain versions alike. What the TPU
kernels needed and these do not: the one-hot MXU matmul, the hi/lo bf16
split, the NSUB/EXTRA_W windows and the VMEM budget; the kernels run at
every N.

`single_pass=True` is the reference's single-pass MXU arm (`hilo=False`,
ops/pallas_csr.py:119-132): the data operand is rounded to bf16, to
nearest with ties to even, and the sum stays f32. The sum rounds
msg·mask, the gather rounds the x rows; each arm's backward is the other's
rounding arm, as in the reference's custom VJPs (:293-310, :360-380). No
plan of the port selects it: the reference never reaches it either (its
CSR batches carry no `kernel_bf16`), so `kernel: csr` runs f32 whatever
`kernel_precision` says.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches (plain calls are not counted),
`LAUNCHES_SP` those of the single-pass arm.

The library is built with nvcc at first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from matdeeplearn_torch.ops import _build

LAUNCHES = {"segment_sum": 0, "gather": 0}
# the single-pass arm's launches, counted apart
LAUNCHES_SP = {"segment_sum_sp": 0, "gather_sp": 0}

_lib = None


def _load():
    """The bound library of csrc/csr.cu (built at first use, ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("csr")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mdl_csr_segment_sum.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.mdl_csr_segment_sum.restype = ci
        lib.mdl_csr_gather.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.mdl_csr_gather.restype = ci
        _lib = lib
    return _lib


def _check_cuda(name, t, dtype, ndim):
    if not t.is_cuda or t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-D {dtype} CUDA tensor, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _check_edges(dst, mask, e, device):
    _check_cuda("dst", dst, torch.int32, 1)
    if mask is not None:
        _check_cuda("mask", mask, torch.float32, 1)
    for name, t in (("dst", dst), ("mask", mask)):
        if t is not None and (t.shape[0] != e or t.device != device):
            raise ValueError(f"{name}: expected ({e},) on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest, ties to even), kept in t's dtype. Its
    autograd backward rounds the gradient the same way, which is the
    reference's single-pass VJP wherever a rounded operand feeds a sum or
    a gather."""
    return t.to(torch.bfloat16).to(t.dtype)


def count(launches: dict, launches_sp: dict, name: str, single_pass: bool):
    """One launch of `name`, in LAUNCHES_SP under name + "_sp" for the
    single-pass arm."""
    if single_pass:
        launches_sp[name + "_sp"] += 1
    else:
        launches[name] += 1


# ------------------------------------------------------------- plain versions


def _in_range(dst, n: int):
    """(dst as int64 clamped into [0, n), 1.0 where dst was in range)."""
    idx = dst.to(torch.int64)
    valid = ((idx >= 0) & (idx < n)).to(torch.float32)
    return idx.clamp(0, max(n - 1, 0)), valid


def segment_sum_plain(msg, dst, mask, n: int, single_pass: bool = False):
    """Plain PyTorch segment_sum: masked index_add_; an edge whose dst lies
    outside [0, n) adds nothing, as in the kernel. single_pass: msg·mask
    rounded to bf16 before the sum."""
    idx, valid = _in_range(dst, n)
    w = valid if mask is None else mask * valid
    m = msg * w[:, None]
    if single_pass:
        m = round_bf16(m)
    out = torch.zeros((n, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, idx, m)


def gather_plain(x, dst, mask, single_pass: bool = False):
    """Plain PyTorch gather: indexing, times the mask; a zero row where dst
    lies outside [0, n), as in the kernel. single_pass: the rows rounded to
    bf16 before the mask."""
    idx, valid = _in_range(dst, x.shape[0])
    w = valid if mask is None else mask * valid
    rows = x[idx]
    if single_pass:
        rows = round_bf16(rows)
    return rows * w[:, None]


# ------------------------------------------------------------------ wrappers


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None,
                n: int, single_pass: bool = False) -> torch.Tensor:
    """(E, D) f32 messages → (n, D) f32 sums at dst (mask may be None)."""
    if msg.device.type == "cpu":
        return segment_sum_plain(msg, dst, mask, n, single_pass)
    _check_cuda("msg", msg, torch.float32, 2)
    e, d = msg.shape
    _check_edges(dst, mask, e, msg.device)
    out = torch.zeros((n, d), dtype=torch.float32, device=msg.device)
    if e == 0 or d == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_csr_segment_sum(msg.data_ptr(), dst.data_ptr(), _ptr(mask),
                                      out.data_ptr(), e, d, n,
                                      int(single_pass), stream)
    _raise_on(rc, "mdl_csr_segment_sum")
    count(LAUNCHES, LAUNCHES_SP, "segment_sum", single_pass)
    return out


def gather(x: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None,
           single_pass: bool = False) -> torch.Tensor:
    """(N, D) f32 rows → (E, D) f32 rows x[dst]·mask (mask may be None)."""
    if x.device.type == "cpu":
        return gather_plain(x, dst, mask, single_pass)
    _check_cuda("x", x, torch.float32, 2)
    n, d = x.shape
    e = dst.shape[0]
    _check_edges(dst, mask, e, x.device)
    out = torch.empty((e, d), dtype=torch.float32, device=x.device)
    if e == 0 or d == 0:
        return out.zero_()
    lib = _load()
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mdl_csr_gather(x.data_ptr(), dst.data_ptr(), _ptr(mask),
                                 out.data_ptr(), e, d, n, vec4,
                                 int(single_pass), stream)
    _raise_on(rc, "mdl_csr_gather")
    count(LAUNCHES, LAUNCHES_SP, "gather", single_pass)
    return out


# ------------------------------------------------------------------ autograd


class SortedSegmentSum(torch.autograd.Function):
    """segment_sum with gather as its backward (d_msg = g[dst]·mask), both
    in the same arm."""

    @staticmethod
    def forward(ctx, msg, dst, mask, n, single_pass=False):
        ctx.save_for_backward(dst, mask)
        ctx.single_pass = single_pass
        return segment_sum(msg.contiguous(), dst, mask, n, single_pass)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        return (gather(g.contiguous(), dst, mask, ctx.single_pass), None,
                None, None, None)


class SortedGather(torch.autograd.Function):
    """gather with segment_sum as its backward (d_x = Σ_dst g·mask), both
    in the same arm."""

    @staticmethod
    def forward(ctx, x, dst, mask, single_pass=False):
        ctx.save_for_backward(dst, mask)
        ctx.n, ctx.single_pass = x.shape[0], single_pass
        return gather(x.contiguous(), dst, mask, single_pass)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        return (segment_sum(g.contiguous(), dst, mask, ctx.n, ctx.single_pass),
                None, None, None)


def sorted_segment_sum(msg, dst, mask, n: int, single_pass: bool = False):
    """Differentiable segment_sum (the reference's sorted_segment_sum)."""
    return SortedSegmentSum.apply(msg, dst, mask, n, single_pass)


def sorted_gather(x, dst, mask, single_pass: bool = False):
    """Differentiable gather (the reference's sorted_gather)."""
    return SortedGather.apply(x, dst, mask, single_pass)
