"""Graph-level pooling: global mean/add/max and Set2Set.

PyG's global_{mean,add,max}_pool and Set2Set as the reference resolves them
by name (models/cgcnn.py:150-154, 112-119). Pools run over the padded node
buffer with a dummy segment for pad nodes (id = num_graphs), then drop it.
"""

from __future__ import annotations

import torch
from torch import nn

from matdeeplearn_torch.nn.layers import LSTMCell
from matdeeplearn_torch.ops import segment


def global_mean_pool(x, node_graph, node_mask, num_graphs: int):
    return segment.segment_mean(x, node_graph, num_graphs + 1,
                                node_mask)[:num_graphs]


def global_add_pool(x, node_graph, node_mask, num_graphs: int):
    return segment.segment_sum(x, node_graph, num_graphs + 1,
                               node_mask)[:num_graphs]


def global_max_pool(x, node_graph, node_mask, num_graphs: int):
    return segment.segment_max(x, node_graph, num_graphs + 1,
                               node_mask)[:num_graphs]


POOLS = {
    "global_mean_pool": global_mean_pool,
    "global_add_pool": global_add_pool,
    "global_sum_pool": global_add_pool,
    "global_max_pool": global_max_pool,
}


class Set2Set(nn.Module):
    """Order-invariant set pooling (Vinyals et al.) with PyG's semantics:

      q* = 0 of (B, 2d)
      for t in 1..processing_steps:
          q   = LSTM(q*)              (input 2d, hidden d)
          α_i = softmax over the nodes i of g of <x_i, q_g>
          r_g = Σ_i α_i x_i
          q*  = [q ‖ r]

    Output width 2d. Pad nodes stay out of the softmax and the sum. Called
    as the other pools are: (x, node_graph, node_mask, num_graphs)."""

    def __init__(self, dim: int, processing_steps: int = 3, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.dim, self.processing_steps = dim, processing_steps
        self.lstm = LSTMCell(2 * dim, dim, generator=generator, device=device)

    def forward(self, x, node_graph, node_mask, num_graphs: int):
        b = num_graphs
        q_star = x.new_zeros((b, 2 * self.dim))
        h = x.new_zeros((b, self.dim))
        c = x.new_zeros((b, self.dim))
        ng = torch.clamp(node_graph, max=b - 1)  # pad nodes: masked anyway
        for _ in range(self.processing_steps):
            q, c = self.lstm(q_star, h, c)
            h = q
            e = torch.sum(x * torch.index_select(q, 0, ng), dim=-1,
                          keepdim=True)
            a = segment.segment_softmax(e, node_graph, b + 1, node_mask)
            r = segment.segment_sum(a * x, node_graph, b + 1, node_mask)[:b]
            q_star = torch.cat([q, r], dim=-1)
        return q_star


def get_pool(name: str):
    """The pool function of `name`; for "set2set" the Set2Set module class,
    which the caller builds at its width."""
    if name == "set2set":
        return Set2Set
    if name not in POOLS:
        raise ValueError(f"Unknown pool '{name}'")
    return POOLS[name]
