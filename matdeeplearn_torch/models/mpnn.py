"""MPNN — edge-conditioned convolutions with a GRU (reference:
models/mpnn.py).

Stack: pre-FC → out = h → gc_count × [m = NNConv(out) → BatchNorm? → act →
dropout; h = GRU(m, h); out = h] (the hidden state h threads through every
layer, mpnn.py:141-161) → pool → post-FC → lin_out. Each layer's edge
network `edge_nn{i}` sits beside `conv{i}`, as in the reference package's
parameter tree, and runs inside the conv's call (`_message`): under remat
both are recomputed, as the reference's nn.remat(NNConv) recomputes the
edge network it calls.
"""

from __future__ import annotations

from functools import partial

import torch

from matdeeplearn_torch.models.base import GNNBase
from matdeeplearn_torch.nn.conv import EdgeNetFactored, NNConv
from matdeeplearn_torch.nn.layers import GRUCell, MaskedBatchNorm


class MPNN(GNNBase):
    def __init__(self, num_features: int = 114, dim1: int = 64, dim2: int = 64,
                 dim3: int = 64, pre_fc_count: int = 1, gc_count: int = 3,
                 post_fc_count: int = 1, pool: str = "global_mean_pool",
                 pool_order: str = "early", batch_norm: bool = True,
                 batch_track_stats: bool = True, act: str = "relu",
                 dropout_rate: float = 0.0, output_dim: int = 1,
                 edge_resolution: int = 50, edge_width: float = 0.2,
                 remat: bool = False, *,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__(
            num_features=num_features, dim1=dim1, dim2=dim2,
            pre_fc_count=pre_fc_count, post_fc_count=post_fc_count, pool=pool,
            pool_order=pool_order, act=act, output_dim=output_dim,
            edge_resolution=edge_resolution, edge_width=edge_width,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            remat=remat, generator=generator, device=device,
        )
        self.gc_count = gc_count
        self.batch_norm = batch_norm
        d = self.gc_dim
        kw = dict(generator=generator, device=device)
        for i in range(gc_count):
            self.add_module(f"edge_nn{i}",
                            EdgeNetFactored(edge_resolution, dim3, d * d, **kw))
            self.add_module(f"conv{i}", NNConv(d, d, **kw))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(
                    d, track_stats=batch_track_stats, device=device))
            self.add_module(f"gru{i}", GRUCell(d, d, **kw))

    def _message(self, i: int, out, batch, edge_attr):
        a, w1, b1 = getattr(self, f"edge_nn{i}")(edge_attr)
        return getattr(self, f"conv{i}")(out, batch, a, w1, b1)

    def forward(self, batch, embed: bool = False):
        edge_attr = self.edge_features(batch)
        out = self.apply_pre_fc(batch.x)
        h = out
        for i in range(self.gc_count):
            m = self.run_conv(partial(self._message, i), out, batch, edge_attr)
            if self.batch_norm:
                m = getattr(self, f"bn{i}")(
                    m, mask=batch.node_mask,
                    use_running_average=not self.training)
            m = self.dropout(self.act(m))
            h = getattr(self, f"gru{i}")(m, h)
            out = h
        return self.apply_head(out, batch, embed=embed)
