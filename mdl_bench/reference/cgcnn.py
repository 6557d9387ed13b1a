"""Plain CGCNN (Xie and Grossman, PRL 120, 145301, 2018) as MatDeepLearn's
models/cgcnn.py composes it: pre_fc_count ReLU layers, gc_count CGConv
layers each followed by BatchNorm (no activation between), a global mean
pool, post_fc_count ReLU layers and a linear output. PyG's CGConv with
aggr "mean": x_i + mean over the edges j→i of sigmoid(z W_f + b_f) ⊙
softplus(z W_s + b_s), z = [x_i ‖ x_j ‖ e_ij], e_ij the Gaussian basis of
the normalised distance. Dropout 0, as the configurations state."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mdl_bench.reference import common as C


def param_table(cfg: dict, num_features: int) -> list:
    d, de = int(cfg["dim1"]), int(cfg["edge_resolution"])
    table = C.linear_table("pre_lin0", num_features, d)
    for i in range(1, int(cfg["pre_fc_count"])):
        table += C.linear_table(f"pre_lin{i}", d, d)
    for i in range(int(cfg["gc_count"])):
        table += C.linear_table(f"conv{i}.lin_f", 2 * d + de, d)
        table += C.linear_table(f"conv{i}.lin_s", 2 * d + de, d)
        table += C.batch_norm_table(f"bn{i}", d)
    return table + C.head_table(cfg, d)


def forward(w: dict, g: dict, cfg: dict, train: bool, new_stats: dict):
    h = g["x"]
    for i in range(int(cfg["pre_fc_count"])):
        h = F.relu(C.linear(w, f"pre_lin{i}", h))
    e = C.gaussian(g["dist"], int(cfg["edge_resolution"]))
    src, dst = g["src"], g["dst"]
    for i in range(int(cfg["gc_count"])):
        z = torch.cat([h[dst], h[src], e], dim=1)
        msg = (torch.sigmoid(C.linear(w, f"conv{i}.lin_f", z))
               * F.softplus(C.linear(w, f"conv{i}.lin_s", z)))
        h = h + C.mean_at(msg, dst, h.shape[0])
        h = C.batch_norm(w, f"bn{i}", h, train, new_stats)
    return C.head(w, cfg, h, g)
