"""Graph convolutions on the static-shape padded batch (data/batching.py).

Message passing follows PyG's source_to_target flow: edge (src, dst)
carries a message from src that is aggregated at dst. CGConv, SchNet's
interaction block, MPNN's NNConv, GCNConv and MEGNet's block (which
aggregates at the source node) are ported.

Each conv runs in the dtype of its input x: f32, or bf16 under `precision:
bf16` (models/base.py). The fused CGConv and cfconv kernels sum in f32 and
see f32 inputs, their results cast back to x's dtype (the reference
package's nn/conv.py:93-111, :227-248); on a batch marked kernel_bf16
(`kernel_precision: bf16`) they run their single-pass arm, which rounds
their one-hot products' data operands to bf16 (:104, :240), whatever the
activations' dtype. NNConv's bilinear kernel runs its bf16 arm for bf16
activations (:171-176) and never reads kernel_bf16; parameters used outside
a Linear are cast to x's dtype where they are used.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matdeeplearn_torch.nn.layers import (Linear, MaskedBatchNorm,
                                          get_activation, shifted_softplus,
                                          sigmoid, softplus, torch_linear_init)
from matdeeplearn_torch.ops import segment
from matdeeplearn_torch.ops.aggregate import (edge_aggregate, gather_dst,
                                              gather_edge_graph, gather_src,
                                              src_segment_mean)
from matdeeplearn_torch.ops.fused_bilinear import FusedBilinear
from matdeeplearn_torch.ops.fused_cfconv import FusedCFConv
from matdeeplearn_torch.ops.fused_cgconv import FusedCGConv


class CGConv(nn.Module):
    """Crystal-graph conv: out_i = x_i + mean_{j→i} σ(W_f z) ⊙ softplus(W_s z),
    z = [x_i ‖ x_j ‖ e_ij]. aggr="mean", no internal BN (models/cgcnn.py:80-82).

    On a batch whose kernel plan is fused (batch.kernel_fused), the message
    MLPs, the Gaussian edge basis of batch.edge_dist_norm and the sum run
    as one kernel (ops/fused_cgconv.py), fed the row blocks of lin_f and
    lin_s; edge_attr is not read. Otherwise, on a dst-sorted batch the x_i
    gather and the mean run on the CSR kernels (ops/csr.py). F.softplus
    switches to x above 20, where it agrees with the unthresholded softplus
    in f32. Both paths keep the Linear parameters and their names.
    """

    def __init__(self, dim: int, edge_dim: int, edge_width: float = 0.2, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        din = 2 * dim + edge_dim
        self.dim, self.edge_width = dim, edge_width
        self.lin_f = Linear(din, dim, generator=generator, device=device)
        self.lin_s = Linear(din, dim, generator=generator, device=device)

    def forward(self, x, batch, edge_attr):
        if batch.kernel_fused:
            return x + self._fused_mean(x.float(), batch).to(x.dtype)
        # [x_i, x_j, e]: PyG CGConv's concat order
        z = torch.cat([gather_dst(x, batch), gather_src(x, batch), edge_attr],
                      dim=-1)
        gate = sigmoid(self.lin_f(z))
        core = softplus(self.lin_s(z))
        return x + edge_aggregate(gate * core, batch, reduce="mean")

    def _fused_mean(self, x, batch):
        d = self.dim
        # z = [x_i ‖ x_j ‖ e] → row blocks of the (in, out) weight matrices
        kf, ks = self.lin_f.weight.t(), self.lin_s.weight.t()
        xj = gather_src(x, batch)
        agg = FusedCGConv.apply(
            x, xj, batch.edge_dist_norm, batch.edge_dst, batch.edge_mask,
            kf[:d], kf[d:2 * d], kf[2 * d:], self.lin_f.bias,
            ks[:d], ks[d:2 * d], ks[2 * d:], self.lin_s.bias,
            batch.num_nodes, self.edge_width, batch.kernel_bf16)
        return agg / torch.clamp(batch.in_degree, min=1.0)[:, None]


class SchNetInteraction(nn.Module):
    """PyG schnet.InteractionBlock: cfconv (a filter MLP on the edge basis
    times the cosine cutoff of the raw distance batch.edge_weight, sum
    aggregation) → lin2 → shifted softplus → lin. Xavier-uniform weights,
    zero biases. Returns the block's output; SchNet adds the residual.

    On a batch whose kernel plan is fused (batch.kernel_fused), the filter
    MLP, the Gaussian basis of batch.edge_dist_norm, the cutoff and the sum
    run as one kernel (ops/fused_cfconv.py), fed mlp0's and mlp1's (in,
    out) matrices; edge_attr is not read. lin1, the h[src] gather, lin2 and
    lin stay outside the kernel, as in the reference package. Both branches
    keep one parameter tree.
    """

    def __init__(self, dim: int, edge_dim: int, filters: int, cutoff: float,
                 edge_width: float = 0.2, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cutoff, self.edge_width = float(cutoff), edge_width
        kw = dict(init="xavier", generator=generator, device=device)
        self.mlp0 = Linear(edge_dim, filters, **kw)
        self.mlp1 = Linear(filters, filters, **kw)
        self.lin1 = Linear(dim, filters, bias=False, **kw)
        self.lin2 = Linear(filters, dim, **kw)
        self.lin = Linear(dim, dim, **kw)

    def forward(self, x, batch, edge_attr):
        h = self.lin1(x)
        if batch.kernel_fused:
            # the kernel reads f32 rows: gathered in f32, their gradient
            # sums in f32 (a bf16 gather's index_add_ adds in bf16)
            xj = gather_src(h.float(), batch)
            agg = FusedCFConv.apply(
                xj, batch.edge_dist_norm, batch.edge_weight,
                batch.edge_dst, batch.edge_mask, self.mlp0.weight.t(),
                self.mlp0.bias, self.mlp1.weight.t(), self.mlp1.bias,
                batch.num_nodes, self.edge_width, self.cutoff,
                batch.kernel_bf16)
            agg = torch.where(batch.node_mask[:, None] > 0, agg,
                              0.0).to(x.dtype)
        else:
            xj = gather_src(h, batch)
            w = self.mlp1(shifted_softplus(self.mlp0(edge_attr)))
            c = 0.5 * (torch.cos(batch.edge_weight * math.pi / self.cutoff)
                       + 1.0)
            # the reference's order: the cutoff into the filters, then xj
            w = w * (c * batch.edge_mask).to(w.dtype)[:, None]
            agg = edge_aggregate(xj * w, batch, reduce="sum")
        return self.lin(shifted_softplus(self.lin2(agg)))


class EdgeNetFactored(nn.Module):
    """MPNN's edge network, Linear(edge_dim, hidden) → ReLU → Linear(hidden,
    D·K), with the second layer handed over raw: forward returns (a, w1, b1)
    with a = relu(lin0(e)), w1 = lin1's (hidden, D·K) matrix in (in, out)
    layout and b1 its (D·K,) bias, so that a @ w1 + b1 is the per-edge D×K
    weight, flat index d·K + k."""

    def __init__(self, edge_dim: int, hidden: int, dout: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.lin0 = Linear(edge_dim, hidden, generator=generator, device=device)
        self.lin1 = Linear(hidden, dout, generator=generator, device=device)

    def forward(self, e):
        return F.relu(self.lin0(e)), self.lin1.weight.t(), self.lin1.bias


class NNConv(nn.Module):
    """Edge-conditioned conv (MPNN): out_i = x_i·root + bias + mean_{j→i}
    x_j·W(e_ij), W(e) the D×K matrix of the edge network (EdgeNetFactored,
    whose (a, w1, b1) forward takes as given), aggr="mean". root (din, dim)
    from U(-1/√din, 1/√din), bias zeros.

    On a dst-sorted batch (kernels csr and fused) the message runs on the
    bilinear kernel (ops/fused_bilinear.py), which never forms the (E, D, K)
    per-edge weights, and the mean on the CSR kernels; on a streamed batch
    of the fused plan (batch.kernel_bilinear, the reference edge order)
    the message runs on the kernel and the mean on the plain segment ops;
    otherwise it is the einsum over the formed weights. Both branches keep one
    parameter tree. Under bf16 activations the kernel runs its bf16 arm on
    f32 copies of xj and a (ops/fused_bilinear.py), its message cast back,
    and the einsum takes the per-edge weights formed in bf16 (the reference
    package's nn/conv.py:171-183). The kernel's xj is gathered from the f32
    copy of x (the same values as the reference's cast after the gather),
    so its gradient into x sums in f32 before the one cast to bf16.
    """

    def __init__(self, din: int, dim: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.dim = dim
        self.root = nn.Parameter(torch.empty(din, dim, device=device))
        torch_linear_init(self.root, din, generator)
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, batch, a, w1, b1):
        dt = x.dtype
        if batch.dst_sorted or batch.kernel_bilinear:
            # the kernel reads f32 rows: gathered in f32, their gradient
            # sums in f32 (a bf16 gather's index_add_ adds in bf16)
            msg = FusedBilinear.apply(gather_src(x.float(), batch), a.float(),
                                      w1, b1, batch.edge_mask,
                                      dt == torch.bfloat16).to(dt)
        else:
            xj = gather_src(x, batch)
            w_e = (a @ w1.to(dt) + b1.to(dt)).reshape(-1, x.shape[1], self.dim)
            msg = torch.einsum("ed,edk->ek", xj, w_e)
        return (edge_aggregate(msg, batch, reduce="mean")
                + x @ self.root.to(dt) + self.bias.to(dt))


class GCNConv(nn.Module):
    """GCN with edge weights (PyG GCNConv with improved=True and
    add_self_loops=False, the reference's models/gcn.py:80-82; the graph
    already carries its self-loops): out = D^-1/2 Â D^-1/2 (x W) + b, the
    degree the raw edge weights summed at dst. Xavier-uniform `lin` without
    bias, zero `bias`.

    The normalisation is reassociated into node space, as in the reference
    package: out_i = dis_i · Σ_{j→i} ew · (dis_j · h_j) + b, so neither
    per-edge dis gather exists. Both sums go through edge_aggregate: the
    degree at D = 1 (the windowed segment-sum on a windowed batch), the
    message with ew folded in (the windowed SpMM; elsewhere the scaled
    messages).
    """

    def __init__(self, dim: int, *, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.lin = Linear(dim, dim, bias=False, init="xavier",
                          generator=generator, device=device)
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, batch):
        ew = batch.edge_weight * batch.edge_mask
        deg = edge_aggregate(ew[:, None], batch, reduce="sum")[:, 0]
        dis = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)
        dt = x.dtype
        hd = self.lin(x) * dis[:, None].to(dt)
        out = edge_aggregate(gather_src(hd, batch), batch, reduce="sum",
                             weights=ew)
        return out * dis[:, None].to(dt) + self.bias.to(dt)


class MEGNetMLP(nn.Module):
    """MEGNet's sub-MLP: (layers + 1) × [Linear → act → BatchNorm? →
    dropout], the activation before the BatchNorm (the reference's
    megnet.py:43-55). `lin{i}` and `bn{i}` as in the reference package.
    stat_group: the BatchNorms' statistics summed over this process group
    (the edge MLP under ep: MaskedBatchNorm's group, the reference's
    stat_axis)."""

    def __init__(self, din: int, dim: int, layers: int, act: str = "relu",
                 batch_norm: bool = True, track_stats: bool = True, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None, stat_group=None):
        super().__init__()
        self.depth, self.batch_norm = layers + 1, batch_norm
        self.act = get_activation(act)
        for i in range(self.depth):
            self.add_module(f"lin{i}", Linear(din if i == 0 else dim, dim,
                                              generator=generator,
                                              device=device))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(
                    dim, track_stats=track_stats, device=device,
                    group=stat_group))

    def forward(self, x, mask, dropout):
        for i in range(self.depth):
            x = self.act(getattr(self, f"lin{i}")(x))
            if self.batch_norm:
                x = getattr(self, f"bn{i}")(
                    x, mask=mask, use_running_average=not self.training)
            x = dropout(x)
        return x


class MEGNetBlock(nn.Module):
    """One MetaLayer step (the reference's megnet.py:16-147):

      e' = φ_e([x_src ‖ x_dst ‖ e ‖ u[g(src)]])
      x' = φ_v([x ‖ mean over the edges out of i of e' ‖ u[g(i)]])
      u' = φ_u([mean over g of that edge mean ‖ mean over g of x ‖ u])

    The edge means are at the source node. On a src-sorted batch (MEGNet's
    csr layout) x[src], the u broadcast at g(src) and the edge→node mean run
    on the CSR kernels (ops/aggregate.py); x[dst] stays plain. u's edge
    mean reuses the nodes' edge mean v_e (the same value), so the CSR sum
    runs once a block. forward takes the model's dropout. ep_group: the
    process group of an edge-sharded batch's ep members, over which the edge
    MLP's BatchNorms sum their statistics (the reference's ep_axis; the
    node and global MLPs see whole rows on every member)."""

    def __init__(self, dim: int, fc_layers: int, act: str = "relu",
                 batch_norm: bool = True, track_stats: bool = True, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None, ep_group=None):
        super().__init__()
        kw = dict(layers=fc_layers, act=act, batch_norm=batch_norm,
                  track_stats=track_stats, generator=generator, device=device)
        self.edge_mlp = MEGNetMLP(4 * dim, dim, **kw, stat_group=ep_group)
        self.node_mlp = MEGNetMLP(3 * dim, dim, **kw)
        self.global_mlp = MEGNetMLP(3 * dim, dim, **kw)

    def forward(self, x, e, u, batch, dropout):
        b = batch.num_graphs
        node_graph = batch.node_graph
        edge_graph = node_graph[batch.edge_src.long()]
        comb_e = torch.cat([gather_src(x, batch), gather_dst(x, batch), e,
                            gather_edge_graph(u, edge_graph, batch)], dim=-1)
        e_out = self.edge_mlp(comb_e, batch.edge_mask, dropout)

        v_e = src_segment_mean(e_out, batch)
        # index_select, not u[idx]: on CUDA the latter's backward sorts and
        # walks runs serially (ops/aggregate.py:gather_src)
        u_node = torch.index_select(u, 0, torch.clamp(node_graph, max=b - 1))
        comb_v = torch.cat([x, v_e, u_node], dim=-1)
        x_out = self.node_mlp(comb_v, batch.node_mask, dropout)

        u_e = segment.segment_mean(v_e, node_graph, b + 1, batch.node_mask)[:b]
        u_v = segment.segment_mean(x, node_graph, b + 1, batch.node_mask)[:b]
        u_out = self.global_mlp(torch.cat([u_e, u_v, u], dim=-1),
                                batch.graph_mask, dropout)
        return x_out, e_out, u_out
