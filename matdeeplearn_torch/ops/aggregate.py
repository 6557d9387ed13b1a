"""Edge→node aggregation and node→edge gathers for message passing.

On a dst-sorted batch (edge_order "dst") the dst-side ops go through the
CSR kernels (ops/csr.py), at every width: the TPU package kept widths
below 8 on XLA because of its 128-lane one-hot matmul, which these kernels
do not have. Other batches use the masked segment ops (ops/segment.py).
Pad edges gather zero rows on both paths.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.ops import csr, segment


def edge_aggregate(messages: torch.Tensor, batch, reduce: str = "sum"
                   ) -> torch.Tensor:
    """Aggregate per-edge `messages` (E, D) at destination nodes → (N, D).

    reduce: "sum" | "mean"; mean divides by the true in-degree (at least 1:
    a node without edges sums to 0), torch_scatter's aggr="mean". A
    dst-sorted batch carries the in-degree from the dataset (batch.in_degree).
    """
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce {reduce!r}")
    n = batch.num_nodes
    if batch.dst_sorted:
        out = csr.sorted_segment_sum(messages, batch.edge_dst, batch.edge_mask, n)
        if reduce == "mean":
            out = out / torch.clamp(batch.in_degree, min=1.0)[:, None]
        return out
    fn = segment.segment_mean if reduce == "mean" else segment.segment_sum
    return fn(messages, batch.edge_dst.long(), n, batch.edge_mask)


def gather_dst(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_dst] (CGConv's x_i): the CSR gather on a dst-sorted batch,
    whose backward is the CSR segment-sum; zero rows on pad edges."""
    if batch.dst_sorted:
        return csr.sorted_gather(x, batch.edge_dst, batch.edge_mask)
    return x[batch.edge_dst.long()] * batch.edge_mask[:, None]


def gather_src(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_src] (CGConv's x_j) as index_select, whose backward is an
    index_add_ (atomics). Advanced indexing x[idx] would give the same
    values, but its backward on CUDA (a sort, then indexing_backward_kernel,
    which walks each run of equal indices serially) took 22 ms a CGConv
    layer at a CGCNN_demo training batch, 91% of a training epoch's device
    time (chip_smoke, NVIDIA H100 80GB HBM3, 700 W). Pad edges point at
    node 0; every caller masks them out of the aggregation."""
    return torch.index_select(x, 0, batch.edge_src)
