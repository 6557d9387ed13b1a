"""The benchmark's frozen work model: what a step or a layer must do,
counted on the real nodes, edges and graphs it processes (never on a
batch's padded slots), and the peaks of the card it ran on.

`step_flops` is a copy of the program's analytic model at the time the
benchmark was written (2·MAC, dense products only; gathers, scatters and
elementwise work count nothing). A training step counts 3 forwards, an
evaluation step or a Predict batch one. `conv_flops` is the part of it that
the gc_count message-passing layers do, and `conv_bytes` the least bytes
those layers move: the node rows in, each edge's two indices and distance
in, and the node rows out, each once. Neither depends on how a kernel
implements the work."""

from __future__ import annotations

# Dense BF16 tensor-core FLOP/s and HBM bytes/s of one card, by
# torch.cuda.get_device_name() (NVIDIA's H100 data sheet, dense rates).
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


def _dims(cfg: dict, num_features: int):
    g = lambda k, d: int(cfg.get(k, d) or d)  # noqa: E731
    d1 = g("dim1", 64)
    return dict(F=num_features, D1=d1, D2=g("dim2", 64), D3=g("dim3", 64),
                De=g("edge_resolution", 50), pre=g("pre_fc_count", 1),
                gc=g("gc_count", 3), post=g("post_fc_count", 1),
                D=d1 if g("pre_fc_count", 1) > 0 else num_features)


def conv_flops(model: str, cfg: dict, num_features: int, n_nodes: float,
               n_edges: float) -> float:
    """Forward FLOPs of the gc_count message-passing layers."""
    k = _dims(cfg, num_features)
    D, De, D3, N, E = k["D"], k["De"], k["D3"], float(n_nodes), float(n_edges)
    if model == "CGCNN":
        return k["gc"] * (2 * 2 * E * (2 * D + De) * D)   # gate + core
    if model == "MPNN":
        return k["gc"] * (2 * E * (De * D3 + D3 * D * D)  # edge network
                          + 2 * E * D * D                 # message
                          + 2 * N * D * D)                # root
    raise ValueError(f"no work model for {model}")


def step_flops(model: str, cfg: dict, num_features: int, n_nodes: float,
               n_edges: float, n_graphs: float) -> float:
    """Forward FLOPs of one batch of real counts."""
    k = _dims(cfg, num_features)
    D, D2, N, B = k["D"], k["D2"], float(n_nodes), float(n_graphs)
    f = 0.0
    if k["pre"] > 0:
        f += 2 * N * (k["F"] * k["D1"] + (k["pre"] - 1) * k["D1"] ** 2)
    f += conv_flops(model, cfg, num_features, n_nodes, n_edges)
    if model == "MPNN":
        f += k["gc"] * 2 * N * 2 * 3 * D * D             # GRU gates
    f += 2 * B * (D2 * D2 * max(k["post"], 1) + D2)     # head
    return f


def conv_bytes(cfg: dict, num_features: int, n_nodes: float,
               n_edges: float, backward: bool = False) -> float:
    """Least HBM bytes of the gc_count layers' forward (and backward: the
    cotangent in and the node gradient out, the edges read again)."""
    k = _dims(cfg, num_features)
    one = 4.0 * (2 * n_nodes * k["D"] + 3 * n_edges)
    return k["gc"] * one * (2 if backward else 1)


def least_seconds(flops: float, nbytes: float, peaks) -> float:
    return max(flops / peaks[0], nbytes / peaks[1])
