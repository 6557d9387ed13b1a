"""Graph-level pooling: global mean/add/max.

PyG's global_{mean,add,max}_pool as the reference resolves them by name
(models/cgcnn.py:150-154). Pools run over the padded node buffer with a
dummy segment for pad nodes (id = num_graphs), then drop it. Set2Set is
not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

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


def get_pool(name: str):
    if name == "set2set":
        raise NotImplementedError(
            "set2set pooling is not ported yet (ROADMAP queue 1, item 4)")
    if name not in POOLS:
        raise ValueError(f"Unknown pool '{name}'")
    return POOLS[name]
