"""Plain MPNN (Gilmer et al., ICML 2017) as MatDeepLearn's models/mpnn.py
composes it: pre_fc_count ReLU layers; then gc_count times an NNConv
message (PyG NNConv, aggr "mean": x_i·root + bias + mean over the edges
j→i of x_j·W(e_ij), W(e) the (D, D) matrix that the edge network
Linear(edge_resolution, dim3) → ReLU → Linear(dim3, D·D) gives, flat index
d·D + k), BatchNorm, ReLU and a GRU cell whose hidden state threads through
the layers; a global mean pool, post_fc_count ReLU layers and a linear
output. The GRU is torch.nn.GRU's: gates r, z, n in that order. Dropout 0,
as the configurations state."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mdl_bench.reference import common as C


def param_table(cfg: dict, num_features: int) -> list:
    d, d3, de = int(cfg["dim1"]), int(cfg["dim3"]), int(cfg["edge_resolution"])
    table = C.linear_table("pre_lin0", num_features, d)
    for i in range(1, int(cfg["pre_fc_count"])):
        table += C.linear_table(f"pre_lin{i}", d, d)
    b = 1.0 / math.sqrt(d)
    for i in range(int(cfg["gc_count"])):
        table += C.linear_table(f"edge_nn{i}.lin0", de, d3)
        table += C.linear_table(f"edge_nn{i}.lin1", d3, d * d)
        table += [(f"conv{i}.root", (d, d), "uniform", b),
                  (f"conv{i}.bias", (d,), "uniform", b)]
        table += C.batch_norm_table(f"bn{i}", d)
        table += [(f"gru{i}.weight_ih", (3 * d, d), "uniform", b),
                  (f"gru{i}.weight_hh", (3 * d, d), "uniform", b),
                  (f"gru{i}.bias_ih", (3 * d,), "uniform", b),
                  (f"gru{i}.bias_hh", (3 * d,), "uniform", b)]
    return table + C.head_table(cfg, d)


def gru(w: dict, name: str, x, h):
    i_r, i_z, i_n = (C.product("nd,od->no", x, w[f"{name}.weight_ih"])
                     + w[f"{name}.bias_ih"]).chunk(3, 1)
    h_r, h_z, h_n = (C.product("nd,od->no", h, w[f"{name}.weight_hh"])
                     + w[f"{name}.bias_hh"]).chunk(3, 1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def forward(w: dict, g: dict, cfg: dict, train: bool, new_stats: dict):
    h = g["x"]
    for i in range(int(cfg["pre_fc_count"])):
        h = F.relu(C.linear(w, f"pre_lin{i}", h))
    d = h.shape[1]
    e = C.gaussian(g["dist"], int(cfg["edge_resolution"]))
    src, dst = g["src"], g["dst"]
    out = h
    for i in range(int(cfg["gc_count"])):
        a = F.relu(C.linear(w, f"edge_nn{i}.lin0", e))
        w_e = C.linear(w, f"edge_nn{i}.lin1", a).reshape(-1, d, d)
        msg = C.product("ed,edk->ek", out[src], w_e)
        m = (C.mean_at(msg, dst, out.shape[0])
             + C.product("nd,dk->nk", out, w[f"conv{i}.root"])
             + w[f"conv{i}.bias"])
        m = F.relu(C.batch_norm(w, f"bn{i}", m, train, new_stats))
        h = gru(w, f"gru{i}", m, h)
        out = h
    return C.head(w, cfg, out, g)
