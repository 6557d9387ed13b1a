"""Graph convolutions on the static-shape padded batch (data/batching.py).

Message passing follows PyG's source_to_target flow: edge (src, dst)
carries a message from src that is aggregated at dst. CGConv, SchNet's
interaction block, MPNN's NNConv and GCNConv are ported; ROADMAP queue 1
item 10 holds MEGNet's block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matdeeplearn_torch.nn.layers import (Linear, shifted_softplus,
                                          torch_linear_init)
from matdeeplearn_torch.ops.aggregate import edge_aggregate, gather_dst, gather_src
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
            return x + self._fused_mean(x, batch)
        # [x_i, x_j, e]: PyG CGConv's concat order
        z = torch.cat([gather_dst(x, batch), gather_src(x, batch), edge_attr],
                      dim=-1)
        gate = torch.sigmoid(self.lin_f(z))
        core = F.softplus(self.lin_s(z))
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
            batch.num_nodes, self.edge_width)
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
        xj = gather_src(self.lin1(x), batch)
        if batch.kernel_fused:
            agg = FusedCFConv.apply(
                xj, batch.edge_dist_norm, batch.edge_weight, batch.edge_dst,
                batch.edge_mask, self.mlp0.weight.t(), self.mlp0.bias,
                self.mlp1.weight.t(), self.mlp1.bias, batch.num_nodes,
                self.edge_width, self.cutoff)
            agg = torch.where(batch.node_mask[:, None] > 0, agg, 0.0)
        else:
            w = self.mlp1(shifted_softplus(self.mlp0(edge_attr)))
            c = 0.5 * (torch.cos(batch.edge_weight * math.pi / self.cutoff)
                       + 1.0)
            agg = edge_aggregate(xj * w * (c * batch.edge_mask)[:, None],
                                 batch, reduce="sum")
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
    per-edge weights, and the mean on the CSR kernels; on the reference
    order it is the einsum over the formed weights. Both branches keep one
    parameter tree.
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
        xj = gather_src(x, batch)
        if batch.dst_sorted:
            msg = FusedBilinear.apply(xj, a, w1, b1, batch.edge_mask)
        else:
            w_e = (a @ w1 + b1).reshape(-1, x.shape[1], self.dim)
            msg = torch.einsum("ed,edk->ek", xj, w_e)
        return edge_aggregate(msg, batch, reduce="mean") + x @ self.root + self.bias


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
        hd = self.lin(x) * dis[:, None]
        out = edge_aggregate(gather_src(hd, batch), batch, reduce="sum",
                             weights=ew)
        return out * dis[:, None] + self.bias
