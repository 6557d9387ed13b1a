"""Graph convolutions on the static-shape padded batch (data/batching.py).

Message passing follows PyG's source_to_target flow: edge (src, dst)
carries a message from src that is aggregated at dst. Only CGConv is
ported so far (ROADMAP queue 1, items 8-11 hold the others).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matdeeplearn_torch.nn.layers import Linear
from matdeeplearn_torch.ops.aggregate import edge_aggregate, gather_dst, gather_src
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
