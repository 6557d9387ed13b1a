"""CGCNN — crystal graph conv network (reference: matdeeplearn/models/cgcnn.py).

Stack: pre-FC → gc_count × [CGConv → BatchNorm? → dropout] (no inter-conv
activation, cgcnn.py:146) → pool → post-FC → lin_out.

Dropout masks come from the model's own torch.Generator, seeded with
`dropout_seed` (the job seed), one per device, never from torch's global
generator: the same seed gives the same masks.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.base import GNNBase
from matdeeplearn_torch.nn.conv import CGConv
from matdeeplearn_torch.nn.layers import MaskedBatchNorm


class CGCNN(GNNBase):
    def __init__(self, num_features: int = 114, dim1: int = 64, dim2: int = 64,
                 pre_fc_count: int = 1, gc_count: int = 3, post_fc_count: int = 1,
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
            generator=generator, device=device,
        )
        self.gc_count = gc_count
        self.batch_norm = batch_norm
        self.dropout_rate = dropout_rate
        self.dropout_seed = dropout_seed
        self._dropout_gens: dict[torch.device, torch.Generator] = {}
        for i in range(gc_count):
            self.add_module(f"conv{i}", CGConv(
                self.gc_dim, edge_resolution, edge_width, generator=generator,
                device=device))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(
                    self.gc_dim, track_stats=batch_track_stats, device=device))

    def dropout(self, x):
        """Inverted dropout with a mask drawn from the model's generator."""
        if not self.training or self.dropout_rate <= 0:
            return x
        gen = self._dropout_gens.get(x.device)
        if gen is None:
            gen = torch.Generator(device=x.device).manual_seed(self.dropout_seed)
            self._dropout_gens[x.device] = gen
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.dropout_rate
        return x * keep / (1.0 - self.dropout_rate)

    def forward(self, batch):
        # the fused CGConv builds the edge basis inside its kernel
        edge_attr = None if batch.kernel_fused else self.edge_features(batch)
        out = self.apply_pre_fc(batch.x)
        for i in range(self.gc_count):
            out = getattr(self, f"conv{i}")(out, batch, edge_attr)
            if self.batch_norm:
                out = getattr(self, f"bn{i}")(
                    out, mask=batch.node_mask,
                    use_running_average=not self.training)
            out = self.dropout(out)
        return self.apply_head(out, batch)
