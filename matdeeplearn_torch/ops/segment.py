"""Masked segment reductions over static-shape padded buffers.

The counterpart of torch_scatter's scatter_add/scatter_mean/scatter_max as
the reference uses them (models/cgcnn.py:13), and the per-segment softmax of
Set2Set. Every function takes an explicit mask, so padding is a provable
no-op; accumulation is f32, bf16 values included (the reference package's
ops/segment.py:35-42): a bf16 sum accumulates in f32 and rounds once, and a
bf16 mean divides the rounded sum by the count in f32, then rounds again.
The pools and the unsorted aggregation path use these; sorted aggregation
goes through the CSR kernels (ops/csr.py).
"""

from __future__ import annotations

import torch


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum of `dtype` values accumulates in: f32 for bf16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _masked(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values
    m = mask.to(values.dtype)
    return values * m.reshape(m.shape + (1,) * (values.ndim - m.ndim))


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Sum of `values` rows per segment; masked rows contribute zero. A
    bf16 input accumulates in f32 (a bf16 accumulator loses low bits after
    ~256 addends) and the sum is cast back."""
    v = _masked(values, mask)
    acc = _acc_dtype(v.dtype)
    out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=acc,
                      device=v.device)
    return out.index_add_(0, segment_ids, v.to(acc)).to(v.dtype)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Number of (unmasked) rows per segment, as float32."""
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Mean per segment over true (unmasked) counts; empty segments → 0
    (torch_scatter.scatter_mean semantics)."""
    total = segment_sum(values, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    count = count.reshape(count.shape + (1,) * (total.ndim - count.ndim))
    # the division in f32 (bf16 cannot hold counts above 256 exactly)
    return (total.to(_acc_dtype(total.dtype))
            / torch.clamp(count, min=1.0)).to(total.dtype)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Max per segment; masked rows excluded; empty segments → 0 (what
    torch_scatter.scatter_max leaves in a zero-initialized output)."""
    if mask is not None:
        m = mask.to(torch.bool).reshape(
            mask.shape + (1,) * (values.ndim - mask.ndim))
        values = torch.where(m, values, float("-inf"))
    idx = segment_ids.to(torch.int64).reshape(
        segment_ids.shape + (1,) * (values.ndim - 1)).expand_as(values)
    out = torch.full((num_segments,) + tuple(values.shape[1:]), float("-inf"),
                     dtype=values.dtype, device=values.device)
    out = out.scatter_reduce(0, idx, values, reduce="amax", include_self=True)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_softmax(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Softmax within each segment (Set2Set's attention), shifted by the
    segment's max for stability. Masked rows get probability 0; an
    all-masked segment gives zeros."""
    vmax = segment_max(values, segment_ids, num_segments, mask)
    e = _masked(torch.exp(values - vmax[segment_ids]), mask)
    denom = segment_sum(e, segment_ids, num_segments)
    return e / torch.clamp(denom[segment_ids], min=1e-16)
