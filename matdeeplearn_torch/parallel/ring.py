"""Edge-parallel reductions: the halo exchange over an ep group.

The reference package's parallel/ring.py. Each member of an ep group holds
1/ep of a replica's padded edge slots (spmd.slice_edge_shard) and the
replica's node and graph rows whole. A reduction of edge values at nodes
is then a local partial reduction plus an exchange of the partial node
rows, the halo: `halo_exchange_sum` is an all_reduce(SUM) over the group.
On NCCL that is the ring reduce-scatter + all-gather the reference writes
out, and it needs no padding of the node rows to a multiple of ep.

Gradients keep the reference's convention (parallel/spmd.py:176-184,
nn/layers.py:24-38): the backward of every exchange is an all_reduce(SUM)
of the members' cotangents. The members compute the same downstream
values, so every cotangent that crosses an exchange comes back ep times
over, and the node paths, computed on every member, give ep copies of
their gradient too: every gradient path carries a uniform factor of ep,
which the step divides out once (spmd.StepReducer).

  * `halo_exchange_max`: the max over members, taken before the empty → 0
    clamp (the reference's ops/aggregate.py:309-320); its gradient goes to
    the member or members holding the max, split equally among ties, as
    the reference's max splits it;
  * `gather_edges`: the edge-sized operand whole on every member, an
    all_reduce of a zero-filled (E, ...) buffer holding this member's
    slice (gloo has no all_gather on CUDA tensors in its documented
    table). `ep_impl: gspmd` reduces that locally, which is how XLA's
    partitioner computed the same function (ring.py:27-34);
  * `EdgeShard`: a batch's handle on its ep group (GraphBatch.ep), whose
    segment sum, count and max are the edge-parallel versions of
    ops/segment.py's, by ring or by gather.

A bf16 exchange runs in f32 (the sums of ops/segment.py accumulate in f32;
the reference's psum of a bf16 partial would round once more).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from matdeeplearn_torch.ops import segment


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _HaloSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _HaloMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        out = _all_reduce(local, group, dist.ReduceOp.MAX)
        ctx.group = group
        ctx.save_for_backward(local, out)
        return out

    @staticmethod
    def backward(ctx, g):
        local, out = ctx.saved_tensors
        wins = (local == out).to(g.dtype)
        # one exchange: the cotangents' sum and the number of tied members
        both = _all_reduce(torch.stack([g, wins]), ctx.group)
        return wins * both[0] / both[1], None


class _GatherEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rows = group, slice(rank * x.shape[0],
                                           (rank + 1) * x.shape[0])
        full = x.new_zeros((size * x.shape[0],) + tuple(x.shape[1:]))
        full[ctx.rows] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[ctx.rows], None, None, None


def _f32(fn, x, *args):
    """fn on x, through f32 for a bf16 x."""
    if x.dtype == torch.bfloat16:
        return fn(x.float(), *args).to(x.dtype)
    return fn(x, *args)


def halo_exchange_sum(partial: torch.Tensor, group) -> torch.Tensor:
    """The members' partial rows summed, the same on every member (partial
    itself without a group)."""
    if group is None:
        return partial
    return _f32(_HaloSum.apply, partial, group)


def halo_exchange_max(local: torch.Tensor, group) -> torch.Tensor:
    """The members' elementwise max (its gradient to the winners)."""
    if group is None:
        return local
    return _f32(_HaloMax.apply, local, group)


def gather_edges(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """The members' (E/ep, ...) slices concatenated in rank order: (E, ...)."""
    return _f32(_GatherEdges.apply, x, group, rank, size)


@dataclass(frozen=True)
class EdgeShard:
    """A batch's edge shard: member `rank` of an ep group of `size`, which
    holds edge slots [rank·E/ep, (rank+1)·E/ep) of its replica's batch.
    impl "ring" reduces locally and exchanges node rows; "gspmd" gathers
    the edge-sized values, indices and mask and reduces them whole."""

    group: object
    rank: int
    size: int
    impl: str = "ring"

    def _whole(self, values, segment_ids, mask):
        """(values, ids, mask) of every edge slot of the replica's batch."""
        with torch.no_grad():  # indices below 2**24: exact in f32
            ids = gather_edges(segment_ids.float(), self.group, self.rank,
                               self.size).long()
            m = gather_edges(mask.float(), self.group, self.rank, self.size)
        return (gather_edges(values, self.group, self.rank, self.size), ids, m)

    def segment_sum(self, values, segment_ids, num_segments, mask):
        """ops/segment.segment_sum over the replica's whole edge set."""
        if self.impl == "gspmd":
            v, ids, m = self._whole(values, segment_ids, mask)
            return segment.segment_sum(v, ids, num_segments, m)
        return halo_exchange_sum(
            segment.segment_sum(values, segment_ids, num_segments, mask),
            self.group)

    def segment_count(self, segment_ids, num_segments, mask):
        ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                          device=segment_ids.device)
        with torch.no_grad():
            return self.segment_sum(ones, segment_ids, num_segments, mask)

    def segment_mean(self, values, segment_ids, num_segments, mask):
        """Sum over count (at least 1), in f32 for bf16 values, as
        ops/segment.segment_mean."""
        total = self.segment_sum(values, segment_ids, num_segments, mask)
        count = self.segment_count(segment_ids, num_segments, mask)
        count = count.reshape(count.shape + (1,) * (total.ndim - count.ndim))
        acc = torch.float32 if total.dtype == torch.bfloat16 else total.dtype
        return (total.to(acc) / torch.clamp(count, min=1.0)).to(total.dtype)

    def segment_max(self, values, segment_ids, num_segments, mask):
        """ops/segment.segment_max over the whole edge set: the members'
        maxima combined before the empty → 0 clamp, so a node whose edges
        all lie on another member takes that member's max."""
        if self.impl == "gspmd":
            v, ids, m = self._whole(values, segment_ids, mask)
            return segment.segment_max(v, ids, num_segments, m)
        m = mask.to(torch.bool).reshape(
            mask.shape + (1,) * (values.ndim - mask.ndim))
        idx = segment_ids.to(torch.int64).reshape(
            segment_ids.shape + (1,) * (values.ndim - 1)).expand_as(values)
        local = torch.full((num_segments,) + tuple(values.shape[1:]),
                           float("-inf"), dtype=values.dtype,
                           device=values.device)
        local = local.scatter_reduce(0, idx,
                                     torch.where(m, values, float("-inf")),
                                     reduce="amax", include_self=True)
        out = halo_exchange_max(local, self.group)
        return torch.where(torch.isfinite(out), out, 0.0)
