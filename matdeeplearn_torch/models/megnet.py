"""MEGNet — MatErials Graph Network (reference: models/megnet.py).

Stack: pre-FC → gc_count × [{e, x, u} embedding MLPs `e_embed{i}`,
`x_embed{i}`, `u_embed{i}` (two ReLU layers of dim3 each) → MEGNetBlock
`conv{i}` → residual adds: the first block adds the embedded values, later
blocks the running state (megnet.py:313-336)] → head. Early pooling
concatenates the pooled x, the pooled edge features (edge → source node →
graph) and u: 3·dim3 wide, 5·dim3 with set2set (`set2set_x`, `set2set_e`).
Late pooling runs the head on x, then the pool (`set2set_x` and
`lin_out_2` for set2set). Under remat each block is recomputed in the
backward (models/base.py:run_conv), as the reference package's
nn.remat(MEGNetBlock).
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.base import GNNBase
from matdeeplearn_torch.nn.conv import MEGNetBlock
from matdeeplearn_torch.nn.layers import MLP
from matdeeplearn_torch.nn.pool import Set2Set
from matdeeplearn_torch.ops.aggregate import (edge_segment_reduce,
                                              src_segment_mean)

U_WIDTH = 3  # the dataset's per-graph features u (data/batching.py)
_REDUCE_KIND = {
    "global_mean_pool": "mean",
    "global_max_pool": "max",
    "global_sum_pool": "sum",
    "global_add_pool": "sum",
}


class MEGNet(GNNBase):
    def __init__(self, num_features: int = 114, dim1: int = 64, dim2: int = 64,
                 dim3: int = 64, pre_fc_count: int = 1, gc_count: int = 3,
                 gc_fc_count: int = 2, post_fc_count: int = 1,
                 pool: str = "global_mean_pool", pool_order: str = "early",
                 batch_norm: bool = True, batch_track_stats: bool = True,
                 act: str = "relu", dropout_rate: float = 0.0,
                 output_dim: int = 1, edge_resolution: int = 50,
                 edge_width: float = 0.2, remat: bool = False,
                 precision: str = "f32", *,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__(
            num_features=num_features, dim1=dim1, dim2=dim2,
            pre_fc_count=pre_fc_count, post_fc_count=post_fc_count, pool=pool,
            pool_order=pool_order, act=act, output_dim=output_dim,
            edge_resolution=edge_resolution, edge_width=edge_width,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            remat=remat, precision=precision, head_width=dim3,
            pooled_width=(5 if pool == "set2set" else 3) * dim3,
            set2set_name="set2set_x", generator=generator, device=device,
        )
        self.gc_count, self.pool_name = gc_count, pool
        kw = dict(generator=generator, device=device)
        for i in range(gc_count):
            widths = ((edge_resolution, self.gc_dim, U_WIDTH) if i == 0
                      else (dim3, dim3, dim3))
            for name, din in zip(("e", "x", "u"), widths):
                self.add_module(f"{name}_embed{i}",
                                MLP(din, (dim3, dim3), "relu", **kw))
            self.add_module(f"conv{i}", MEGNetBlock(
                dim3, gc_fc_count, act=act, batch_norm=batch_norm,
                track_stats=batch_track_stats, **kw))
        if pool == "set2set" and pool_order == "early":
            self.set2set_x = Set2Set(dim3, **kw)
            self.set2set_e = Set2Set(dim3, **kw)

    def forward(self, batch, embed: bool = False):
        edge_attr = self.edge_features(batch)
        x, e = self.apply_pre_fc(batch.x), edge_attr
        u = batch.u.to(self.compute_dtype)
        for i in range(self.gc_count):
            e_temp = getattr(self, f"e_embed{i}")(e)
            x_temp = getattr(self, f"x_embed{i}")(x)
            u_temp = getattr(self, f"u_embed{i}")(u)
            x_out, e_out, u_out = self.run_conv(
                getattr(self, f"conv{i}"), x_temp, e_temp, u_temp, batch,
                self.dropout)
            if i == 0:
                x, e, u = x_out + x_temp, e_out + e_temp, u_out + u_temp
            else:
                x, e, u = x_out + x, e_out + e, u_out + u
        if self.pool_order == "late":
            return self.apply_head(x, batch, embed=embed)
        args = (batch.node_graph, batch.node_mask, batch.num_graphs)
        n = batch.num_nodes
        if self.pool_name == "set2set":
            e_node = edge_segment_reduce("mean", e, batch.edge_src, n,
                                         batch.edge_mask)
            pooled = [self.set2set_x(x, *args), self.set2set_e(e_node, *args)]
        else:
            kind = _REDUCE_KIND[self.pool_name]
            # the mean rides the CSR segment-sum on a src-sorted batch
            e_node = (src_segment_mean(e, batch) if kind == "mean"
                      else edge_segment_reduce(kind, e, batch.edge_src, n,
                                               batch.edge_mask))
            pooled = [self.pool(x, *args), self.pool(e_node, *args)]
        return self.apply_head(torch.cat(pooled + [u], dim=-1), batch,
                               pooled=True, embed=embed)
