"""GCN — weighted graph convolutions (reference: models/gcn.py).

Stack: pre-FC → gc_count × [GCNConv (edge-weight normalised) → BatchNorm? →
act → dropout] (an activation after every conv, gcn.py:145) → pool →
post-FC → lin_out. The edge weights are the raw distances
(batch.edge_weight), as in the reference.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.base import GNNBase
from matdeeplearn_torch.nn.conv import GCNConv
from matdeeplearn_torch.nn.layers import MaskedBatchNorm


class GCN(GNNBase):
    def __init__(self, num_features: int = 114, dim1: int = 64, dim2: int = 64,
                 pre_fc_count: int = 1, gc_count: int = 3, post_fc_count: int = 1,
                 pool: str = "global_mean_pool", pool_order: str = "early",
                 batch_norm: bool = True, batch_track_stats: bool = True,
                 act: str = "relu", dropout_rate: float = 0.0,
                 output_dim: int = 1, edge_resolution: int = 50,
                 edge_width: float = 0.2,
                 remat: bool = False, precision: str = "f32", *,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__(
            num_features=num_features, dim1=dim1, dim2=dim2,
            pre_fc_count=pre_fc_count, post_fc_count=post_fc_count, pool=pool,
            pool_order=pool_order, act=act, output_dim=output_dim,
            edge_resolution=edge_resolution, edge_width=edge_width,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            remat=remat, precision=precision, generator=generator,
            device=device,
        )
        self.gc_count = gc_count
        self.batch_norm = batch_norm
        for i in range(gc_count):
            self.add_module(f"conv{i}", GCNConv(self.gc_dim, generator=generator,
                                                device=device))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(
                    self.gc_dim, track_stats=batch_track_stats, device=device))

    def forward(self, batch, embed: bool = False):
        out = self.apply_pre_fc(batch.x)
        for i in range(self.gc_count):
            out = self.run_conv(getattr(self, f"conv{i}"), out, batch)
            if self.batch_norm:
                out = getattr(self, f"bn{i}")(
                    out, mask=batch.node_mask,
                    use_running_average=not self.training)
            out = self.dropout(self.act(out))
        return self.apply_head(out, batch, embed=embed)
