"""The dp/ep train and eval steps, one process a mesh member.

The reference package's parallel/spmd.py runs one program over a (dp, ep)
mesh with shard_map. Here every process runs the single-card step on
its part of the work and the step ends in collectives:

  * each dp replica assembles its own row of the (dp, B) id matrix: the
    trainer's id rows are dp·B wide (a padded epoch at batch dp·B, or
    packed_id_matrix_sharded's bins), row-major over (dp, B), and replica
    d takes slots [d·B, (d+1)·B) (`local_ids`);
  * under ep each member of the replica's ep group keeps a contiguous 1/ep
    of the batch's padded edge slots (`slice_edge_shard`), whose sums at
    nodes go through the halo exchange (parallel/ring.py,
    ops/aggregate.py). The sorted kernel routes are off on an edge shard,
    as in the reference's ops/aggregate.py:193-261; MPNN's bilinear
    message reads only the mask and stays on its kernel;
  * the loss is count-weighted, as the reference's (spmd.py:11-13,
    :161-186): each member runs backward on its local loss·count, and one
    flat all_reduce over the world carries every gradient, the loss sum,
    the graph count and the BatchNorm running buffers (`StepReducer`).
    The loss sum and the count come back ep times over (the ep members
    hold the same values), the gradients ep times over by the halo's
    convention (parallel/ring.py), the buffers dp·ep times: the step
    divides them out, the gradients by csum·ep, csum = max(Σ count, 1),
    so every replica's BatchNorm runs on its own batch and its running
    statistics are averaged over dp after the step. optimizer.step() then
    runs on every rank on the same gradients, so the parameters stay the
    same everywhere. No DistributedDataParallel wrapper: the step keeps
    one collective, which a CUDA graph captures under NCCL;
  * the eval step sums the loss and count over the dp group and returns
    every replica's outputs in id order (row-major over (dp, B), the
    reference's spmd.py:268-276), by one all_reduce of a zero-filled
    (dp, B, T) buffer holding this replica's rows.

Without a process group (a mesh of one process) the steps run no
collective. lr × dp is the job layer's (training/jobs.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from matdeeplearn_torch.data.batching import GraphBatch, assemble
from matdeeplearn_torch.parallel.mesh import Mesh
from matdeeplearn_torch.parallel.ring import EdgeShard

_EDGE_FIELDS = ("edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
                "edge_mask")


def local_ids(ids, mesh: Mesh | None):
    """This replica's slots of a (dp·B,) id row (the row without a mesh)."""
    if mesh is None or mesh.dp == 1:
        return ids
    b = len(ids) // mesh.dp
    return ids[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def slice_edge_shard(batch: GraphBatch, mesh: Mesh | None) -> GraphBatch:
    """This ep member's contiguous 1/ep of the batch's padded edge slots
    (the batch itself at ep 1): the edge arrays sliced, the node and graph
    arrays whole, GraphBatch.ep the member's EdgeShard. The sorted routes
    go off (edge_order None, kernel_fused False); a dst-sorted batch keeps
    MPNN's bilinear message (kernel_bilinear). The edge slots must divide
    by ep (the Run's spec aligns them to 8·ep); a windowed batch cannot be
    sharded."""
    if mesh is None or mesh.ep == 1:
        return batch
    if batch.is_windowed:
        raise ValueError("a windowed batch cannot be edge-sharded")
    e = batch.num_edges
    if e % mesh.ep:
        raise ValueError(f"padded edge slots {e} not divisible by ep={mesh.ep}")
    rows = slice(mesh.ep_rank * (e // mesh.ep), (mesh.ep_rank + 1) * (e // mesh.ep))
    return dataclasses.replace(
        batch, **{k: getattr(batch, k)[rows] for k in _EDGE_FIELDS},
        edge_order=None, kernel_fused=False,
        kernel_bilinear=batch.kernel_bilinear or batch.dst_sorted,
        ep=EdgeShard(mesh.ep_group, mesh.ep_rank, mesh.ep, mesh.ep_impl))


def local_batch(data, ids, spec, mesh: Mesh | None) -> GraphBatch:
    """This member's batch of a (dp·B,) id row."""
    return slice_edge_shard(assemble(data, local_ids(ids, mesh), spec), mesh)


class StepReducer:
    """The train step's one collective over a model's gradients, loss sum,
    count and floating buffers (the BatchNorm running statistics): their
    flat all_reduce over the world, divided as the module docstring says.
    Parameters without a gradient (None: no path from the loss) stay
    None, as in the single-card step; the members agree on which."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.params = list(model.parameters())
        self.buffers = [b for b in model.buffers() if b.is_floating_point()]

    def __call__(self, lsum: torch.Tensor, count: torch.Tensor):
        """(loss, csum): the global count-weighted loss and max(Σ count, 1);
        the gradients and buffers rewritten in place."""
        mesh = self.mesh
        grads = [p.grad for p in self.params if p.grad is not None]
        parts = ([g.reshape(-1) for g in grads]
                 + [lsum.reshape(1).float(), count.reshape(1).float()]
                 + [b.reshape(-1) for b in self.buffers])
        flat = torch.cat(parts)
        if mesh.world_group is not None:
            dist.all_reduce(flat, group=mesh.world_group)
        ng = sum(g.numel() for g in grads)
        total, csum = flat[ng] / mesh.ep, flat[ng + 1] / mesh.ep
        csum = torch.clamp(csum, min=1.0)
        grad_flat = flat[:ng] / (csum * mesh.ep)
        buf_flat = flat[ng + 2:] / mesh.world
        for t, new in ((grads, grad_flat), (self.buffers, buf_flat)):
            at = 0
            with torch.no_grad():
                for x in t:
                    x.copy_(new[at:at + x.numel()].view_as(x))
                    at += x.numel()
        return total / csum, csum


def train_batch(model, optimizer, loss_fn, batch: GraphBatch,
                reducer: StepReducer):
    """The dp/ep train step on this member's batch (train.train_batch's
    counterpart): backward on the local loss·count, the reducer's one
    collective, optimizer.step(). Returns the global (loss, csum) as
    device tensors, the same on every rank."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(batch)
    y = batch.y if out.ndim > 1 else batch.y[:, 0]
    count = torch.sum(batch.graph_mask)
    lsum = loss_fn(out, y, batch.graph_mask) * count
    lsum.backward()
    loss, csum = reducer(lsum.detach(), count)
    optimizer.step()
    return loss, csum


@torch.no_grad()
def eval_batch(model, loss_fn, batch: GraphBatch, mesh: Mesh,
               out: bool = False):
    """(loss, csum, outputs) over the replicas: the dp-summed loss·count
    over max(Σ count, 1) and, with `out`, every replica's (B, ...)
    outputs stacked in dp order ((dp·B, ...), row-major over (dp, B));
    without `out`, this member's outputs. One all_reduce over the dp group
    (none at dp 1 or without a process group)."""
    pred = model(batch)
    y = batch.y if pred.ndim > 1 else batch.y[:, 0]
    count = torch.sum(batch.graph_mask)
    lsum = loss_fn(pred, y, batch.graph_mask) * count
    if mesh.dp == 1 or mesh.dp_group is None:
        csum = torch.clamp(count, min=1.0)
        return lsum / csum, csum, pred
    head = torch.stack([lsum.float(), count.float()])
    if out:
        rows = pred.new_zeros((mesh.dp,) + tuple(pred.shape), dtype=torch.float32)
        rows[mesh.dp_rank] = pred
        flat = torch.cat([head, rows.reshape(-1)])
    else:
        flat = head
    dist.all_reduce(flat, group=mesh.dp_group)
    csum = torch.clamp(flat[1], min=1.0)
    outs = (flat[2:].view((mesh.dp * pred.shape[0],) + tuple(pred.shape[1:]))
            if out else pred)
    return flat[0] / csum, csum, outs

