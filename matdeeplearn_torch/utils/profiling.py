"""Profiling and throughput observability (the reference package's
utils/profiling.py, for PyTorch on CUDA):

  * ThroughputMeter — edges/s, graphs/s, epochs/hr and ms/step over a
    training run, measured at chunk granularity with each chunk shape's
    first chunk (the kernels' nvcc build at first use, allocator warm-up)
    excluded, plus MFU / HBM-rate shares from the analytic work model when
    the card's peaks are known;
  * analytic_step_flops / analytic_step_bytes — the analytic model of one
    padded batch's forward matmul FLOPs and HBM traffic, the reference's
    own numbers (attach_analytic_flops sets a meter's per-epoch work);
  * op_cost() — FLOPs of one call from torch.utils.flop_counter (the
    counterpart of the reference's xla_cost; the port's hand kernels are
    as opaque to it as the Pallas calls are to XLA's cost model);
  * device_peaks() — the card's dense BF16 tensor-core peak and HBM rate,
    the roofline denominators;
  * trace() — a torch.profiler context writing one Chrome trace (.json),
    enabled per job by the `profile: "True"` / `profile_dir` job
    parameters.

MFU is reported against the BF16 tensor-core peak whatever the compute
dtype, the reference's convention: an f32 or 3xTF32 run cannot read above
100%, and at the 3xTF32 ceiling (495/3 = 165 TFLOP/s on an H100 SXM) it
reads 16.7%.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# Dense BF16 tensor-core FLOP/s and HBM bytes/s of one card, by
# torch.cuda.get_device_name(), from NVIDIA's H100 datasheet (SXM: 989.4
# TFLOP/s, 3.35 TB/s; PCIe: 756 TFLOP/s, 2.0 TB/s; NVL: 835 TFLOP/s,
# 3.9 TB/s).
GPU_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


def device_peaks(device=None) -> tuple[float, float] | None:
    """(peak_flops_per_s, peak_hbm_bytes_per_s) of one card, or None off
    CUDA and for a card the table does not hold (no guess)."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    return GPU_PEAKS.get(torch.cuda.get_device_name(dev))


def op_cost(fn, *args, **kwargs) -> float | None:
    """FLOPs of one call fn(*args, **kwargs), counted by
    torch.utils.flop_counter.FlopCounterMode (the operators it knows:
    matmuls, convolutions, attention); None when it counts nothing. The
    call runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


@dataclass
class ThroughputMeter:
    """Accumulates work counters over chunks of epochs and reports rates.

    edges/s is the SpMM-equivalent workload rate (messages aggregated per
    second); per-card rates divide by the device count used.

    Preferred accounting is `add_chunk(epochs, steps, seconds)` per chunk:
    warmup chunks accumulate into `warmup_s` and are excluded from every
    rate. The start()/tick() wall-clock accounting remains for callers
    without chunk boundaries.

    When `flops_per_epoch`/`bytes_per_epoch` are set (attach_analytic_flops
    or op_cost) and the card's peaks are known, rates() also reports mfu_pct
    (achieved FLOP/s over the BF16 peak × devices) and hbm_util_pct.
    """

    num_devices: int = 1
    edges_per_epoch: float = 0.0
    graphs_per_epoch: float = 0.0
    epochs: int = 0
    warmup_chunks: int = 1
    flops_per_epoch: float = 0.0  # model FLOPs (all devices)
    bytes_per_epoch: float = 0.0  # model HBM bytes (all devices)
    precision: str = "f32"  # the model's; report() names it when not f32
    steps: int = 0
    warmup_s: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    _timed_s: float = 0.0
    _timed_epochs: float = 0.0
    _timed_steps: int = 0
    _chunks_seen: int = 0
    _seen_keys: set = field(default_factory=set)

    def start(self):
        self._t0 = time.perf_counter()
        self.epochs = 0
        return self

    def tick(self, epochs: int = 1):
        self.epochs += epochs

    def add_chunk(self, epochs: int, steps: int, seconds: float,
                  warmup: bool | None = None, key=None):
        """Account one chunk. Warmup resolution order: explicit `warmup`
        flag; else `key` (a hashable chunk-shape id — its FIRST occurrence
        on this meter is warmup, later ones are steady state, across
        trainer calls); else the first `warmup_chunks` chunks."""
        self._chunks_seen += 1
        self.epochs += epochs
        self.steps += steps
        if warmup is None:
            if key is not None:
                warmup = key not in self._seen_keys
                self._seen_keys.add(key)
            else:
                warmup = self._chunks_seen <= self.warmup_chunks
        if warmup:
            self.warmup_s += seconds
            return
        self._timed_s += seconds
        self._timed_epochs += epochs
        self._timed_steps += steps

    @property
    def elapsed(self) -> float:
        return max(time.perf_counter() - self._t0, 1e-9)

    def rates(self) -> dict:
        if self._timed_epochs > 0:
            el, epochs, steps = self._timed_s, self._timed_epochs, self._timed_steps
        else:  # wall-clock accounting (includes warmup)
            el, epochs, steps = self.elapsed, self.epochs, self.steps
        el = max(el, 1e-9)
        eps = epochs / el
        out = {
            "epochs": self.epochs,
            "wall_s": round(el, 3),
            "warmup_s": round(self.warmup_s, 3),
            "epochs_per_hr": round(eps * 3600.0, 2),
            "edges_per_s": round(self.edges_per_epoch * eps, 1),
            "edges_per_s_per_chip": round(
                self.edges_per_epoch * eps / max(self.num_devices, 1), 1
            ),
            "graphs_per_s": round(self.graphs_per_epoch * eps, 1),
        }
        if steps:
            out["step_ms"] = round(1e3 * el / steps, 3)
        if self.flops_per_epoch > 0:
            flops_s = self.flops_per_epoch * eps
            out["model_flops_per_s"] = round(flops_s)
            peaks = device_peaks()
            if peaks is not None:
                peak_f, peak_b = peaks
                out["mfu_pct"] = round(
                    100.0 * flops_s / (peak_f * max(self.num_devices, 1)), 2
                )
                if self.bytes_per_epoch > 0:
                    out["hbm_util_pct"] = round(
                        100.0 * self.bytes_per_epoch * eps
                        / (peak_b * max(self.num_devices, 1)),
                        2,
                    )
        return out

    # Below this many steady-state steps, rates are launch-latency noise
    # (a 2-epoch toy run would print "1,972 epochs/hr"): report() then
    # declines to print rates at all.
    MIN_REPORT_STEPS = 20

    def report(self) -> str:
        r = self.rates()
        steps = self._timed_steps if self._timed_epochs > 0 else self.steps
        # (tick()-based accounting has steps == 0: no suppression)
        if steps and steps < self.MIN_REPORT_STEPS:
            return (
                f"Throughput: run too short to report rates "
                f"({steps} steady-state steps < {self.MIN_REPORT_STEPS})"
            )
        msg = (
            "Throughput: {edges_per_s_per_chip:,.0f} edges/s/chip "
            "({edges_per_s:,.0f} edges/s), {graphs_per_s:,.0f} graphs/s, "
            "{epochs_per_hr:,.1f} epochs/hr over {epochs} epochs".format(**r)
        )
        if "step_ms" in r:
            msg += ", {step_ms:.2f} ms/step".format(**r)
        if "mfu_pct" in r:
            msg += ", MFU {mfu_pct:.1f}%".format(**r)
            if "hbm_util_pct" in r:
                msg += " / HBM {hbm_util_pct:.1f}%".format(**r)
        if self.precision != "f32":
            msg += f", precision {self.precision}"
        return msg


def analytic_step_flops(model_name: str, cfg: dict, n_nodes: int,
                        n_edges: int, n_graphs: int) -> float:
    """Forward-pass matmul FLOPs of one padded batch (2·MAC convention,
    dense layers only — gathers/scatters/elementwise don't count).

    Hand kernels are opaque to an operator-level counter, so MFU uses this
    analytic count — the same convention as the 6ND-style numbers in LLM
    reporting. Training steps cost ~3x a forward (fwd + 2x bwd)."""
    g = lambda k, d: int(cfg.get(k, d) or d)
    F = g("num_features", 114)
    D1, D2, D3 = g("dim1", 64), g("dim2", 64), g("dim3", 64)
    De = g("edge_resolution", 50)
    pre, gc, post = g("pre_fc_count", 1), g("gc_count", 3), g("post_fc_count", 1)
    out = g("output_dim", 1)
    N, E, B = float(n_nodes), float(n_edges), float(n_graphs)
    D = D1 if pre > 0 else F

    if model_name in ("SM", "SOAP"):
        din = g("in_dim", 100)
        fc = g("fc_count", 1)
        return 2 * B * (din * D1 + fc * D1 * D1 + D1 * out)

    f = 0.0
    if pre > 0:
        f += 2 * N * (F * D1 + (pre - 1) * D1 * D1)
    if model_name == "CGCNN":
        Z = 2 * D + De
        f += gc * (2 * 2 * E * Z * D)                     # gate+core MLPs
    elif model_name == "GCN":
        f += gc * (2 * N * D * D)
    elif model_name == "SchNet":
        f += gc * (2 * E * (De * D3 + D3 * D3)            # filter MLP
                   + 2 * N * (D * D3 + D3 * D + D * D))   # lin1/lin2/lin
    elif model_name == "MPNN":
        f += gc * (2 * E * (De * D3 + D3 * D * D)         # edge net
                   + 2 * E * D * D                        # message matmul
                   + 2 * N * D * D                        # root
                   + 2 * N * 2 * 3 * D * D)               # GRU gates
    elif model_name == "MEGNet":
        fc = g("gc_fc_count", 2)
        blk = lambda rows, zin: 2 * rows * (zin * D3 + fc * D3 * D3)
        f += gc * (
            2 * (E + N + B) * 2 * D3 * D3                 # e/x/u embed MLPs
            + 2 * E * De * D3 + 2 * N * D * D3            # embed first layers
            + blk(E, 4 * D3) + blk(N, 3 * D3) + blk(B, 3 * D3)
        )
    # post-FC head (pooled rows = B; pooled width approximated by D2 input)
    f += 2 * B * (D2 * D2 * max(post, 1) + D2 * out)
    return f


def analytic_step_bytes(model_name: str, cfg: dict, n_nodes: int,
                        n_edges: int, n_graphs: int, *,
                        fused_kernel: bool = False,
                        bytes_per_el: int = 4) -> float:
    """Forward-pass HBM traffic of one padded batch, in bytes — the roofline
    sibling of analytic_step_flops.

    Counts the large tensors a graph conv moves: per-edge feature gathers,
    edge-intermediate writes+reads (z / filters / messages), the
    aggregation scatter, and per-node activations. Weights and per-graph
    rows are negligible at bulk scale and are ignored. A ±2× accounting
    (fusion removes some intermediates; gathers move whole cache lines for
    narrow rows); it answers "single-digit or half-peak", not the third
    decimal.

    fused_kernel (CGCNN, SchNet, MPNN): the fused kernel keeps its edge
    intermediates on chip — per CGConv only x, x[src], dist are read and
    the (N, D) output written.

    Training steps cost ~3× a forward (bwd re-reads activations, writes
    gradient-sized tensors) — the same convention the FLOP model uses.
    """
    g = lambda k, d: int(cfg.get(k, d) or d)
    F = g("num_features", 114)
    D1, D2, D3 = g("dim1", 64), g("dim2", 64), g("dim3", 64)
    De = g("edge_resolution", 50)
    pre, gc = g("pre_fc_count", 1), g("gc_count", 3)
    N, E, B = float(n_nodes), float(n_edges), float(n_graphs)
    D = D1 if pre > 0 else F

    b = 0.0
    b += N * (F + D)  # pre-FC read+write
    if model_name in ("SM", "SOAP"):
        return bytes_per_el * B * (g("in_dim", 100) + 2 * D1)
    if model_name == "CGCNN":
        Z = 2 * D + De
        if fused_kernel:
            # x read + xj gather + dist + output write per conv
            conv = N * D + E * (D + 1) + N * D
        else:
            # xi/xj gathers, basis, z write+2 reads, gate/core write+read,
            # msg write, scatter read E·D + write N·D
            conv = (2 * E * D + E * De + 3 * E * Z
                    + 4 * E * D + 2 * E * D + N * D)
        b += gc * conv
    elif model_name == "GCN":
        b += gc * (2 * N * D + 2 * E * D + E)  # h, gather, scatter, weights
    elif model_name == "SchNet":
        if fused_kernel:
            # fused cfconv: h, h[src] gather, dist+raw, output write
            b += gc * (N * D3 + E * D3 + 2 * E + N * D3)
        else:
            # filter MLP on edge_attr (E·De read, E·D3 ×2 write+read),
            # h gather, msg, scatter
            b += gc * (E * De + 4 * E * D3 + N * D3 + 2 * E * D3 + N * D)
    elif model_name == "MPNN":
        if fused_kernel:
            # bilinear kernel: the (E, D, D) weight tensor never reaches
            # HBM — xj, a, msg and grads only
            b += gc * (E * De + 2 * E * D3 + 3 * E * D + N * D * 8)
        else:
            # edge-net intermediate (E·D3), per-edge weight matrices E·D·D
            # (the dominant term), message gather+scatter, GRU node traffic
            b += gc * (E * De + E * D3 + 2 * E * D * D + 2 * E * D
                       + N * D * 8)
    elif model_name == "MEGNet":
        # comb_e (E·4D3) write+read, e_out, node comb (N·3D3), u rows
        b += gc * (3 * E * 4 * D3 + 2 * E * D3 + 3 * N * 3 * D3
                   + 2 * N * D3)
    b += B * D2 * 2  # post-FC head
    return bytes_per_el * b


def attach_analytic_flops(meter: ThroughputMeter, model_name: str,
                          cfg: dict, spec, n_train: int, n_val: int,
                          batch_size: int, fused_kernel: bool = False,
                          steps_per_epoch: int | None = None,
                          replicas: int = 1) -> None:
    """Set meter.flops_per_epoch / bytes_per_epoch from the analytic models
    (train steps ~3x forward, val steps 1x) unless already set.

    steps_per_epoch: the actual step count where ceil(n/batch)
    underestimates it (packed batching). replicas: the dp replicas (the
    reference package's profiling.py:342-366): spec is one replica's and
    batch_size the steps' global batch, so a step's work counts every
    replica's batch, against the meter's devices (meter_for_training)."""
    if meter.flops_per_epoch > 0:
        return
    fwd = replicas * analytic_step_flops(model_name, cfg, spec.num_nodes,
                                         spec.num_edges, spec.num_graphs)
    fwd_b = replicas * analytic_step_bytes(model_name, cfg, spec.num_nodes,
                                           spec.num_edges, spec.num_graphs,
                                           fused_kernel=fused_kernel)
    tr_steps = steps_per_epoch or max(1, -(-n_train // max(batch_size, 1)))
    va_steps = -(-n_val // max(batch_size, 1)) if n_val else 0
    meter.flops_per_epoch = 3.0 * fwd * tr_steps + fwd * va_steps
    meter.bytes_per_epoch = 3.0 * fwd_b * tr_steps + fwd_b * va_steps


@contextlib.contextmanager
def trace(log_dir: str | None, enabled: bool = True):
    """torch.profiler over the block, written as one Chrome trace
    (`trace.json`, viewable in chrome://tracing or Perfetto) into
    `log_dir`: CPU activity, and CUDA activity when a card is available.
    A no-op when disabled or log_dir is None."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def meter_for_training(dataset, train_idx, precision: str = "f32",
                       mesh=None) -> ThroughputMeter:
    """Meter sized to one training epoch over train_idx, over the mesh's
    dp·ep devices (one without a mesh; the reference package's
    profiling.py:378-388)."""
    idx = np.asarray(train_idx)
    return ThroughputMeter(
        num_devices=1 if mesh is None else mesh.world,
        edges_per_epoch=float(dataset.edge_counts()[idx].sum()),
        graphs_per_epoch=float(len(idx)),
        precision=precision,
    )
