"""CSR segment-sum and gather: hand-written CUDA kernels with plain twins.

The two kernels in csrc/csr.cu replace the reference package's
ops/pallas_csr.py:_csr_sum_kernel and :_csr_gather_kernel. Each is the
other's backward, as in that package's custom_vjp pair:

  segment_sum(msg, dst, mask, n)[n] = Σ_{e: dst[e]=n} msg[e]·mask[e]
  gather(x, dst, mask)[e]          = x[dst[e]]·mask[e]  (zero row if mask 0)

Both are bound by bytes on the card (one read of each input, one write of
each output, at most one multiply-add per element); csrc/csr.cu describes
each design. segment_sum is right for any dst order and any mask: a
dst-sorted edge list only makes it cheaper (fewer atomics). What the TPU
kernels needed and these do not: the one-hot MXU matmul, the hi/lo bf16
split, the NSUB/EXTRA_W windows and the VMEM budget; the kernels run at
every N.

Dispatch goes by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`*_plain`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts kernel launches (plain calls are not counted).

The library is built with nvcc at first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from matdeeplearn_torch.ops import _build

LAUNCHES = {"segment_sum": 0, "gather": 0}

_lib = None


def _load():
    """The bound library of csrc/csr.cu (built at first use, ops/_build.py)."""
    global _lib
    if _lib is None:
        lib = _build.library("csr")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mdl_csr_segment_sum.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.mdl_csr_segment_sum.restype = ci
        lib.mdl_csr_gather.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
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


# ------------------------------------------------------------- plain versions


def segment_sum_plain(msg, dst, mask, n: int):
    """Plain PyTorch segment_sum: masked index_add_."""
    m = msg if mask is None else msg * mask[:, None]
    out = torch.zeros((n, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, dst.to(torch.int64), m)


def gather_plain(x, dst, mask):
    """Plain PyTorch gather: indexing, times the mask."""
    out = x[dst.to(torch.int64)]
    return out if mask is None else out * mask[:, None]


# ------------------------------------------------------------------ wrappers


def segment_sum(msg: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None,
                n: int) -> torch.Tensor:
    """(E, D) f32 messages → (n, D) f32 sums at dst (mask may be None)."""
    if msg.device.type == "cpu":
        return segment_sum_plain(msg, dst, mask, n)
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
                                      out.data_ptr(), e, d, n, stream)
    _raise_on(rc, "mdl_csr_segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out


def gather(x: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None
           ) -> torch.Tensor:
    """(N, D) f32 rows → (E, D) f32 rows x[dst]·mask (mask may be None)."""
    if x.device.type == "cpu":
        return gather_plain(x, dst, mask)
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
                                 out.data_ptr(), e, d, n, vec4, stream)
    _raise_on(rc, "mdl_csr_gather")
    LAUNCHES["gather"] += 1
    return out


# ------------------------------------------------------------------ autograd


class SortedSegmentSum(torch.autograd.Function):
    """segment_sum with gather as its backward (d_msg = g[dst]·mask)."""

    @staticmethod
    def forward(ctx, msg, dst, mask, n):
        ctx.save_for_backward(dst, mask)
        return segment_sum(msg.contiguous(), dst, mask, n)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        return gather(g.contiguous(), dst, mask), None, None, None


class SortedGather(torch.autograd.Function):
    """gather with segment_sum as its backward (d_x = Σ_dst g·mask)."""

    @staticmethod
    def forward(ctx, x, dst, mask):
        ctx.save_for_backward(dst, mask)
        ctx.n = x.shape[0]
        return gather(x.contiguous(), dst, mask)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        return segment_sum(g.contiguous(), dst, mask, ctx.n), None, None


def sorted_segment_sum(msg, dst, mask, n: int):
    """Differentiable segment_sum (the reference's sorted_segment_sum)."""
    return SortedSegmentSum.apply(msg, dst, mask, n)


def sorted_gather(x, dst, mask):
    """Differentiable gather (the reference's sorted_gather)."""
    return SortedGather.apply(x, dst, mask)
