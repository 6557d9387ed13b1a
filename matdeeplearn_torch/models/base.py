"""Shared GNN skeleton: pre-FC → conv stack → pool → post-FC → output.

Every reference GNN follows the same frame (e.g. models/cgcnn.py:46-174):
`pre_fc_count` dense layers, `gc_count` conv blocks with optional
BatchNorm, early or late pooling, `post_fc_count` dense layers, a final
`lin_out`, and a squeeze to (B,) for single targets. Subclasses build the
conv stack. f32 only: bf16 activations are not ported yet (ROADMAP queue 1,
item 5).
"""

from __future__ import annotations

import torch
from torch import nn

from matdeeplearn_torch.nn.layers import Linear, get_activation
from matdeeplearn_torch.nn.pool import get_pool
from matdeeplearn_torch.ops.edge_basis import gaussian_basis


class GNNBase(nn.Module):
    """Pre-FC and head layers; subclasses add the conv stack and forward."""

    def __init__(self, *, num_features: int, dim1: int, dim2: int,
                 pre_fc_count: int, post_fc_count: int, pool: str,
                 pool_order: str, act: str, output_dim: int,
                 edge_resolution: int, edge_width: float,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        if pool_order not in ("early", "late"):
            raise ValueError(f"pool_order must be 'early' or 'late', got {pool_order!r}")
        self.num_features, self.dim1, self.dim2 = num_features, dim1, dim2
        self.pre_fc_count, self.post_fc_count = pre_fc_count, post_fc_count
        self.pool_order = pool_order
        self.pool = get_pool(pool)
        self.act = get_activation(act)
        self.edge_resolution, self.edge_width = edge_resolution, edge_width
        kw = dict(generator=generator, device=device)
        for i in range(pre_fc_count):
            fan_in = num_features if i == 0 else dim1
            self.add_module(f"pre_lin{i}", Linear(fan_in, dim1, **kw))
        # early pool: the head runs on pooled gc_dim features; late pool:
        # on node features of the same width, pooled after lin_out.
        width = self.gc_dim
        for i in range(post_fc_count):
            self.add_module(f"post_lin{i}", Linear(width, dim2, **kw))
            width = dim2
        self.lin_out = Linear(width, output_dim, **kw)

    @property
    def gc_dim(self) -> int:
        return self.num_features if self.pre_fc_count == 0 else self.dim1

    def edge_features(self, batch):
        """On-device Gaussian expansion of stored normalized distances."""
        return gaussian_basis(batch.edge_dist_norm, 0.0, 1.0,
                              self.edge_resolution, self.edge_width)

    def apply_pre_fc(self, x):
        for i in range(self.pre_fc_count):
            x = self.act(getattr(self, f"pre_lin{i}")(x))
        return x

    def _post_fc(self, out):
        for i in range(self.post_fc_count):
            out = self.act(getattr(self, f"post_lin{i}")(out))
        return self.lin_out(out)

    def apply_head(self, out, batch):
        """Early/late pooling + post-FC stack + lin_out (+ squeeze)."""
        pool_args = (batch.node_graph, batch.node_mask, batch.num_graphs)
        if self.pool_order == "early":
            out = self._post_fc(self.pool(out, *pool_args))
        else:
            out = self.pool(self._post_fc(out), *pool_args)
        if out.shape[-1] == 1:
            return out.reshape(-1)
        return out
