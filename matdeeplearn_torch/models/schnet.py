"""SchNet — continuous-filter convolutions (reference: models/schnet.py).

Stack: pre-FC → gc_count × [out = out + InteractionBlock(out) (residual,
schnet.py:134-143) → BatchNorm? → dropout] (no inter-conv activation) →
pool → post-FC → lin_out. The cosine cutoff acts on the raw edge distance
(batch.edge_weight), the filter MLP on the Gaussian basis of the normalized
one.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.base import GNNBase
from matdeeplearn_torch.nn.conv import SchNetInteraction
from matdeeplearn_torch.nn.layers import MaskedBatchNorm


class SchNet(GNNBase):
    def __init__(self, num_features: int = 114, dim1: int = 64, dim2: int = 64,
                 dim3: int = 64, cutoff: float = 8.0, pre_fc_count: int = 1,
                 gc_count: int = 3, post_fc_count: int = 1,
                 pool: str = "global_mean_pool", pool_order: str = "early",
                 batch_norm: bool = True, batch_track_stats: bool = True,
                 act: str = "relu", dropout_rate: float = 0.0,
                 output_dim: int = 1, edge_resolution: int = 50,
                 edge_width: float = 0.2, *,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__(
            num_features=num_features, dim1=dim1, dim2=dim2,
            pre_fc_count=pre_fc_count, post_fc_count=post_fc_count, pool=pool,
            pool_order=pool_order, act=act, output_dim=output_dim,
            edge_resolution=edge_resolution, edge_width=edge_width,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            generator=generator, device=device,
        )
        self.gc_count = gc_count
        self.batch_norm = batch_norm
        for i in range(gc_count):
            self.add_module(f"conv{i}", SchNetInteraction(
                self.gc_dim, edge_resolution, dim3, float(cutoff), edge_width,
                generator=generator, device=device))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(
                    self.gc_dim, track_stats=batch_track_stats, device=device))

    def forward(self, batch):
        # the fused cfconv builds the edge basis inside its kernel
        edge_attr = None if batch.kernel_fused else self.edge_features(batch)
        out = self.apply_pre_fc(batch.x)
        for i in range(self.gc_count):
            out = out + getattr(self, f"conv{i}")(out, batch, edge_attr)
            if self.batch_norm:
                out = getattr(self, f"bn{i}")(
                    out, mask=batch.node_mask,
                    use_running_average=not self.training)
            out = self.dropout(out)
        return self.apply_head(out, batch)
