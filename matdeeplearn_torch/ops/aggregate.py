"""Edge→node aggregation and node→edge gathers for message passing.

On a windowed batch (data/batching.py:assemble_batch_windowed) the sums go
through the windowed kernels (ops/windowed.py): the SpMM where per-edge
weights are given, the segment-sum otherwise. On a dst-sorted batch
(edge_order "dst") the dst-side ops go through the CSR kernels
(ops/csr.py), and on a src-sorted batch (edge_order "src", MEGNet's csr
layout) the src-side ones do: gather_src, gather_edge_graph (whose index
node_graph[edge_src] is then sorted too) and src_segment_mean. The other
side's ops go plain on a sorted batch. The kernels run at every width: the
TPU package kept widths below 8 on XLA because of its 128-lane one-hot
matmul, which these kernels do not have. Other batches use the masked
segment ops (ops/segment.py).

Pad edges point at node 0 with mask 0. The CSR kernels skip them (a sum
adds nothing, a gather writes a zero row), so the index may fall back to 0
after the last real edge: the kernels ask for sorted real edges only.
Pad edges gather zero rows at dst on every path (gather_dst). The plain
gather_src and gather_edge_graph return row-0 values on pad edges and rely
on their callers' masks: every aggregation multiplies by edge_mask or
skips pad slots, and the fused kernels give masked edges zero gradients.

Under bf16 activations (`precision: bf16`) the kernels still see f32: a
bf16 input is cast up before each CSR or windowed kernel and its result
cast back, as in the reference package (ops/aggregate.py:67-71, :109,
:118-132, :196-201). A windowed batch marked kernel_bf16
(`kernel_precision: bf16`) runs the windowed kernels' single-pass arm,
which rounds that f32 operand to bf16 (the reference's hilo=False,
:94-102); the CSR kernels never see the mark, as the reference's CSR
batches never carry it. The plain paths stay in bf16 (their sums accumulate
in f32: ops/segment.py), with the per-edge weights and the mask cast to
the messages' dtype as there (:134-135).

On an edge shard (GraphBatch.ep, parallel/spmd.py:slice_edge_shard: this
member's 1/ep of the padded edge slots) every edge→node reduction is the
shard's (parallel/ring.py:EdgeShard): a local partial reduction and the
halo exchange of the partial node rows, or under `ep_impl: gspmd` the
edge-sized values gathered and reduced whole; the reference's
edge-sharded branches (ops/aggregate.py:54-70, :278-320). A shard is never
sorted or windowed, so the gathers there are index_select.
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
    dtype = messages.dtype
    if batch.ep is not None:
        if weights is not None:
            messages = messages * weights.to(dtype)[:, None]
        fn = batch.ep.segment_mean if reduce == "mean" else batch.ep.segment_sum
        return fn(messages, batch.edge_dst_safe.long(), n, batch.edge_mask)
    if batch.is_windowed:
        we = _windowed_edges(batch)
        m32 = messages.float()
        sp = batch.kernel_bf16
        if weights is not None:
            out = WO.windowed_spmm(weights, m32, we, n, batch.window_size, sp)
        else:
            out = WO.windowed_segment_sum(m32, we, n, batch.window_size, sp)
        # the kernels zero windows that own no tile; node slots past a
        # graph's atoms are masked as in the reference
        out = torch.where(batch.node_mask[:, None] > 0, out, 0.0)
        if reduce == "mean":
            out = out / torch.clamp(batch.in_degree, min=1.0)[:, None]
        return out.to(dtype)
    if batch.dst_sorted:
        m32 = messages.float()
        if weights is not None:
            m32 = m32 * weights[:, None]
        out = csr.sorted_segment_sum(m32, batch.edge_dst, batch.edge_mask, n)
        if reduce == "mean":
            out = out / torch.clamp(batch.in_degree, min=1.0)[:, None]
        return out.to(dtype)
    if weights is not None:
        messages = messages * weights.to(dtype)[:, None]
    fn = segment.segment_mean if reduce == "mean" else segment.segment_sum
    return fn(messages, batch.edge_dst.long(), n, batch.edge_mask)


def gather_dst(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_dst] (CGConv's x_i): the CSR gather on a dst-sorted batch,
    whose backward is the CSR segment-sum; elsewhere index_select on the
    clamped dst (a windowed batch's pad slots hold -1) times the mask, whose
    backward is index_add_ (see gather_src). Zero rows on pad edges."""
    if batch.dst_sorted:
        return csr.sorted_gather(x.float(), batch.edge_dst,
                                 batch.edge_mask).to(x.dtype)
    return (torch.index_select(x, 0, batch.edge_dst_safe)
            * batch.edge_mask.to(x.dtype)[:, None])


def gather_src(x: torch.Tensor, batch) -> torch.Tensor:
    """x[edge_src] (CGConv's x_j). On a src-sorted batch the CSR gather,
    whose backward is the CSR segment-sum at src (zero rows on pad edges).
    Otherwise index_select, whose backward is an index_add_ (atomics).
    Advanced indexing x[idx] would give the same values, but its backward
    on CUDA (a sort, then indexing_backward_kernel, which walks each run of
    equal indices serially) took 22 ms a CGConv layer at a CGCNN_demo
    training batch, 91% of a training epoch's device time (chip_smoke,
    NVIDIA H100 80GB HBM3, 700 W). Pad edges point at node 0; every caller
    masks them out of the aggregation."""
    if batch.src_sorted:
        return csr.sorted_gather(x.float(), batch.edge_src,
                                 batch.edge_mask).to(x.dtype)
    return torch.index_select(x, 0, batch.edge_src)


def gather_edge_graph(u: torch.Tensor, edge_graph: torch.Tensor, batch
                      ) -> torch.Tensor:
    """u[edge_graph], the per-edge broadcast of graph features (MEGNet's u
    into the edge model), edge_graph = node_graph[edge_src]. The index is
    clamped to the last graph slot: a pad edge of a batch whose first node
    slot is a pad (an all-pad packed eval bin) points at the dummy segment
    B. On a src-sorted batch the index is non-decreasing over real edges
    (graphs take consecutive node slots), so the CSR gather runs it, with
    the CSR segment-sum into the B graph rows as its backward; zero rows on
    pad edges. Otherwise index_select (pad edges read a real graph's row;
    callers mask them)."""
    idx = torch.clamp(edge_graph, max=u.shape[0] - 1)
    if batch.src_sorted:
        return csr.sorted_gather(u.float(), idx.to(torch.int32),
                                 batch.edge_mask).to(u.dtype)
    return torch.index_select(u, 0, idx)


def edge_segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, mask: torch.Tensor,
                      ep=None) -> torch.Tensor:
    """Mean of per-edge `values` at `segment_ids` (MEGNet's edge→node means
    at arbitrary node ids): the masked segment mean, over the whole edge set
    of an edge shard's batch when `ep` (its GraphBatch.ep) is given."""
    fn = segment.segment_mean if ep is None else ep.segment_mean
    return fn(values, segment_ids.long(), num_segments, mask)


def edge_segment_reduce(kind: str, values: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int,
                        mask: torch.Tensor, ep=None) -> torch.Tensor:
    """Sum ("sum" or "add"), mean or max of per-edge `values` at node ids
    (MEGNet's edge→source-node pooling), the torch_scatter reduce names of
    the reference's pool map; on an edge shard (`ep`) over the whole edge
    set, the max exchanged before its empty → 0 clamp."""
    if kind == "mean":
        return edge_segment_mean(values, segment_ids, num_segments, mask, ep)
    if ep is None:
        fn = (segment.segment_sum if kind in ("sum", "add")
              else segment.segment_max)
    else:
        fn = ep.segment_sum if kind in ("sum", "add") else ep.segment_max
    return fn(values, segment_ids.long(), num_segments, mask)


def src_segment_mean(values: torch.Tensor, batch) -> torch.Tensor:
    """Mean of per-edge `values` (E, D) at the source node → (N, D), MEGNet's
    edge→node direction. On a src-sorted batch the CSR segment-sum over
    edge_src, divided by the out-degree the batch carries (batch.in_degree
    under edge_order "src"); nodes without out-edges get 0. Otherwise the
    masked segment mean."""
    n = batch.num_nodes
    if batch.src_sorted:
        out = csr.sorted_segment_sum(values.float(), batch.edge_src,
                                     batch.edge_mask, n)
        return (out / torch.clamp(batch.in_degree, min=1.0)[:, None]
                ).to(values.dtype)
    return edge_segment_mean(values, batch.edge_src, n, batch.edge_mask,
                             batch.ep)
