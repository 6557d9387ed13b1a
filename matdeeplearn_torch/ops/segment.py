"""Masked segment reductions over static-shape padded buffers.

The counterpart of torch_scatter's scatter_add/scatter_mean/scatter_max as
the reference uses them (models/cgcnn.py:13). Every function takes an
explicit mask, so padding is a provable no-op; accumulation is f32. The
pools and the unsorted aggregation path use these; dst-sorted aggregation
goes through the CSR kernels (ops/csr.py).
"""

from __future__ import annotations

import torch


def _masked(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values
    m = mask.to(values.dtype)
    return values * m.reshape(m.shape + (1,) * (values.ndim - m.ndim))


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Sum of `values` rows per segment; masked rows contribute zero."""
    v = _masked(values, mask)
    out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, segment_ids, v)


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
    return total / torch.clamp(count, min=1.0)


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
