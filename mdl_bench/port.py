"""What the benchmark hands the program: its corpus as the program's
GraphDataset. The rest of the program is driven through its own entries
(kinds/)."""

from __future__ import annotations

import numpy as np


def graph_dataset(c: dict):
    from matdeeplearn_torch.data.dataset import GraphDataset

    n = int(c["n"])
    return GraphDataset(
        node_x=c["node_x"], node_z=c["node_z"].astype(np.int32),
        edge_src=c["edge_src"].astype(np.int32),
        edge_dst=c["edge_dst"].astype(np.int32),
        edge_weight=c["edge_weight"], edge_dist_norm=c["edge_dist_norm"],
        node_ptr=c["node_ptr"], edge_ptr=c["edge_ptr"], y=c["y"],
        u=np.zeros((n, 3), np.float32),
        structure_ids=[str(i) for i in range(n)],
        edge_resolution=int(c["edge_resolution"]))
