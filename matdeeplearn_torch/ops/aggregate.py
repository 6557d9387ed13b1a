"""Edge→node aggregation and node→edge gathers for message passing.

On a windowed batch (data/batching.py:assemble_batch_windowed) the sums go
through the windowed kernels (ops/windowed.py): the SpMM where per-edge
weights are given, the segment-sum otherwise. On a dst-sorted batch
(edge_order "dst") the dst-side ops go through the CSR kernels
(ops/csr.py), at every width: the TPU package kept widths below 8 on XLA
because of its 128-lane one-hot matmul, which these kernels do not have.
Other batches use the masked segment ops (ops/segment.py).

Pad edges gather zero rows at dst on every path (gather_dst). gather_src
returns x[0] rows on pad edges (they point at node 0) and relies on its
callers' masks: every aggregation multiplies by edge_mask or skips pad
slots, and the fused kernels give masked edges zero gradients.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.ops import csr, segment
from matdeeplearn_torch.ops import windowed as WO


def _windowed_edges(batch) -> WO.WindowedEdges:
    return WO.WindowedEdges(order=batch.edge_dst, dst=batch.edge_dst,
                            window_id=batch.tile_window,
                            first_tile=batch.tile_first, valid=batch.edge_mask)


def edge_aggregate(messages: torch.Tensor, batch, reduce: str = "sum",
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregate per-edge `messages` (E, D) at destination nodes → (N, D).

    reduce: "sum" | "mean"; mean divides by the true in-degree (at least 1:
    a node without edges sums to 0), torch_scatter's aggr="mean". Dst-sorted
    and windowed batches carry the in-degree from the dataset
    (batch.in_degree).

    weights: optional (E,) per-edge scalars folded into the sum,
    out[n] = Σ w[e]·msg[e] (GCN's normalised aggregation). On a windowed
    batch that is the SpMM kernel, which multiplies in registers; elsewhere
    the messages are scaled first.
    """
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce {reduce!r}")
    n = batch.num_nodes
    if batch.is_windowed:
        we = _windowed_edges(batch)
        if weights is not None:
            out = WO.windowed_spmm(weights, messages, we, n, batch.window_size)
        else:
            out = WO.windowed_segment_sum(messages, we, n, batch.window_size)
        # the kernels zero windows that own no tile; node slots past a
        # graph's atoms are masked as in the reference
        out = torch.where(batch.node_mask[:, None] > 0, out, 0.0)
        if reduce == "mean":
            out = out / torch.clamp(batch.in_degree, min=1.0)[:, None]
        return out
    if weights is not None:
        messages = messages * weights[:, None]
    if batch.dst_sorted:
        out = csr.sorted_segment_sum(messages, batch.edge_dst, batch.edge_mask, n)
        if reduce == "mean":
            out = out / torch.clamp(batch.in_degree, min=1.0)[:, None]
        return out
    fn = segment.segment_mean if reduce == "mean" else segment.segment_sum
    return fn(messages, batch.edge_dst.long(), n, batch.edge_mask)


def gather_dst(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_dst] (CGConv's x_i): the CSR gather on a dst-sorted batch,
    whose backward is the CSR segment-sum; elsewhere index_select on the
    clamped dst (a windowed batch's pad slots hold -1) times the mask, whose
    backward is index_add_ (see gather_src). Zero rows on pad edges."""
    if batch.dst_sorted:
        return csr.sorted_gather(x, batch.edge_dst, batch.edge_mask)
    return torch.index_select(x, 0, batch.edge_dst_safe) * batch.edge_mask[:, None]


def gather_src(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_src] (CGConv's x_j) as index_select, whose backward is an
    index_add_ (atomics). Advanced indexing x[idx] would give the same
    values, but its backward on CUDA (a sort, then indexing_backward_kernel,
    which walks each run of equal indices serially) took 22 ms a CGConv
    layer at a CGCNN_demo training batch, 91% of a training epoch's device
    time (chip_smoke, NVIDIA H100 80GB HBM3, 700 W). Pad edges point at
    node 0; every caller masks them out of the aggregation."""
    return torch.index_select(x, 0, batch.edge_src)
