"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100. It:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the build time of every kernel (all csrc/*.cu, one nvcc
   each, in parallel), and turns TF32 off;
2. writes 1,000 periodic structures (8-64 atoms, cubic cells of 16 Å^3 per
   atom, numpy seed 0) and featurizes them with config.yml's Processing
   values; builds CGCNN_demo, SchNet_demo, MPNN_demo and GCN_demo at full
   width from torch.Generator seed 0, with non-trivial BatchNorm running
   statistics, and saves each with the port's checkpoint;
3. checks each CSR kernel against its plain PyTorch version on the card, at
   the shapes of a Predict batch (sorted dst with tail pads, permuted dst,
   scattered mask, D in {1, 3, 150}, one gradient of each autograd pair):
   gather bit-exact, sum to rtol 1e-5 and atol 1e-5·max|ref| (atomics
   reorder the additions);
4. times each CSR kernel, its plain version and a library yardstick
   (index_add_ / index_select, which the port never calls on the card) with
   CUDA events, beside the memory bound (bytes over 3.35 TB/s);
5. checks the fused CGConv kernels against their plain versions at the
   shapes of a CGCNN_demo training batch (batch 100, De 50; D 100, 3 and
   150; sorted dst with tail pads, permuted dst, scattered mask): output,
   d_x, d_xj, the six weight blocks and two biases (bit-identical between
   two calls), and each kernel of the backward against its plain stage
   (the edge rows d_x, d_xj and dA, every weight-gradient slice, the slice
   sum), to rtol 1e-4 and atol 1e-4·max|ref|, printing each check's worst
   share of that limit (it raises after the last case if any is above 1);
   then times them beside their bound (bytes, or operations over 495/3
   TFLOP/s for these 3xTF32 tensor-core kernels, with the bound at the
   FMA pipes' 67 TFLOP/s f32 beside the forward's) and a library
   yardstick: for the forward the unfused composition the csr CGConv runs
   (concat + 2 F.linear + activations + csr.segment_sum), for the edge
   kernel its autograd backward to x and xj, for the weight gradient one
   torch.mm of zᵀ·dA, for the slice sum partial.sum(0); then the whole
   backward (every launch and allocation) against the unfused autograd
   backward, its split by kernel, and the fused forward plus backward
   against the unfused pair; then the same for the fused SchNet cfconv
   kernels (F 150, 3 and 100, cutoff 8, every case run and its worst
   shares printed before a failure is raised: output, d_xj, the four
   filter gradients, bit-identical between two calls, zero d_xj on masked
   edges, and each kernel of the backward against its plain stage: the
   edge rows d_xj, a, dw and dpre, every weight-gradient slice, the slice
   sum; times beside their bounds, the backward's edge rows and weight
   gradient at the 3xTF32 rate with the FMA rate's beside; the yardstick
   is the unfused SchNet composition: basis, 2 F.linear with shifted
   softplus, cutoff, index_select, csr.segment_sum, and its autograd
   backward (to h alone for the edge rows), one torch.bmm of [b | 1]ᵀ·dpre
   and [a | 1]ᵀ·dw for the weight gradient; then the whole backward
   against its autograd yardstick);
6. checks the bilinear NNConv kernels (forward, backward, weight gradient)
   against their plain versions on the same training batch, at (D, H, K) =
   (100, 100, 100), (3, 7, 5) and (150, 100, 150), with sorted dst and
   tail pads, permuted rows and a scattered mask: output, d_xj, d_a, d_w1
   and d_b1 to rtol 1e-4 and atol 1e-4·max|ref|, masked rows exactly zero
   in the output, d_xj and d_a, and d_xj/d_a and d_w1/d_b1 each
   bit-identical between two calls; then times them at MPNN_demo's widths
   beside their operations bound (3xTF32 rate, the FMA rate beside it),
   their plain versions and one torch.einsum over the same inputs (and its
   autograd backward to xj and a) as the library yardstick;
7. runs Predict through cli.run on the card with the launch counters reset
   just before and read just after (each CSR kernel >= 32: 8 batches x 4
   CGConv layers), then the same Predict on the CPU (plain versions, same
   checkpoint), and requires 1,000 finite predictions that agree to
   rtol 1e-4, atol 1e-4;
8. trains CGCNN_demo through cli.run on the card (--run_mode=Training,
   kernel auto, 5 epochs, verbosity 1, from that checkpoint) with the
   launch counters reset just before and read just after: each fused
   kernel must launch at least 4 layers x 8 steps x 5 epochs times; then
   2 epochs of the same on the CPU (plain versions): the first epoch's
   train error agrees to rtol 1e-3, every error is finite, and the card's
   last train error is below its first; Predict on the card from the
   checkpoint Training saved gives 1,000 finite predictions;
9. trains 3 epochs under kernel csr and 3 more under kernel fused, and
   prints the warm epoch time of each; profiles one warm training epoch
   under each of fused and csr (device busy share, top kernels);
10. does 8 for SchNet_demo (each cfconv kernel >= 4 x 8 x 5 launches), then
    SchNet Predict on the card from the checkpoint Training saved (counters
    reset just before: csr_segment_sum >= 4 x 8 launches; 1,000 finite
    predictions that agree with the CPU Predict of that checkpoint to rtol
    1e-4, atol 1e-4; one more profiled), then does 9 for SchNet_demo;
11. does 8 for MPNN_demo: the bilinear forward, backward and weight-gradient
    kernels and csr_segment_sum and csr_gather each >= 4 x 8 x 5 launches;
    the comparison with the CPU (kernel fused, plain versions) runs 1 epoch
    on each side on the first 200 structures (a plain epoch over all 1,000
    takes minutes on the CPU; the Predict comparison keeps all 1,000); then
    MPNN Predict on the card from the checkpoint Training saved (counters
    reset just before: the bilinear forward and csr_segment_sum >= 4 x 8
    launches; 1,000 finite predictions that agree with the CPU Predict of
    that checkpoint to rtol 1e-4, atol 1e-4; one more profiled); then 3
    warm-timed epochs under kernel xla (the einsum over the formed per-edge
    weights) and 3 under kernel fused, and one profiled warm epoch;
12. builds the windowed layout of the 1,000 structures and checks the
    windowed kernels (segment-sum, SpMM, gather) against their plain
    versions on the card, at the layout of a GCN_demo training batch with 10
    pad graph slots (windows that own no tile, tail capacity tiles) and at a
    random windowize_edges layout with an empty window, D in {1, 100, 150},
    NaN in the messages and weights of pad slots: sums to rtol 1e-5 and atol
    1e-5·max|ref| (a fixed order, not index_add_'s), finite, bit-identical
    twice, zero on nodes without edges; the gather bit-exact; the gradients
    of the three autograd Functions; then times them at the full training
    batch beside their bound, their plain versions and index_add_ /
    index_select as the library yardsticks (this phase runs right after 6);
13. trains 3 epochs of CGCNN_demo under kernel pallas beside 9's csr and
    fused epochs (the windowed segment-sum at D 100 and its gather);
14. does 8 for GCN_demo under kernel pallas: the windowed SpMM (every
    message sum), segment-sum (every degree) and gather (the SpMM's
    backward) each >= 4 x 8 x 5 launches, 2 CPU epochs to compare; then GCN
    Predict on the card from the checkpoint Training saved (dst-sorted CSR
    plan; counters reset just before: csr_segment_sum >= 2 x 4 x 8
    launches; 1,000 finite predictions that agree with the CPU Predict of
    that checkpoint to rtol 1e-4, atol 1e-4; one more profiled); then 3
    warm-timed epochs each under kernels xla, csr and pallas, and one
    profiled warm pallas epoch;
15. prints a {"kernels": [...]} line, the nvidia-smi line and, last,
    {"ok": true, "device": {...}}.

Every failed check raises and the script exits non-zero. Without CUDA, or
without the rest of the repository beside it, it exits non-zero and prints
no result. Work files go under build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM f32 rate outside the tensor cores
# H100 SXM dense TF32 tensor-core rate (495 TFLOP/s) over the three TF32
# products (mma.sync or wgmma) that 3xTF32 spends on each f32 product
TF32X3_FLOPS = 495e12 / 3
N_STRUCTURES = 1000

# config.yml's values, written out because the card's Python has no yaml
# (tests/test_torch_predict.py holds them to config.yml).
PROCESSING = {
    "dataset_type": "inmemory", "data_path": "data",
    "target_path": "targets.csv", "dictionary_source": "default",
    "dictionary_path": "atom_dict.json", "data_format": "json",
    "verbose": "True", "graph_max_radius": 8.0, "graph_max_neighbors": 12,
    "edge_features": "True", "graph_edge_length": 50,
    "SM_descriptor": "False", "SOAP_descriptor": "False", "SOAP_rcut": 8.0,
    "SOAP_nmax": 6, "SOAP_lmax": 4, "SOAP_sigma": 0.3,
}
TRAINING = {
    "target_index": 0, "loss": "l1_loss", "train_ratio": 0.8,
    "val_ratio": 0.05, "test_ratio": 0.15, "verbosity": 5,
}
PREDICT_JOB = {
    "job_name": "my_predict_job", "reprocess": "False",
    "model_path": "my_model.ckpt", "write_output": "True", "seed": 0,
}
TRAIN_JOB = {
    "job_name": "my_train_job", "reprocess": "False", "model": "CGCNN_demo",
    "load_model": "False", "save_model": "True", "model_path": "my_model.ckpt",
    "write_output": "True", "parallel": "True", "seed": 0,
}
TRAIN_SEED = 7
EPOCHS_CARD, EPOCHS_CPU, EPOCHS_AB = 5, 2, 3
EPOCHS_CPU_MPNN = 1  # MPNN's plain versions on the CPU take longest
N_COMPARE_MPNN = 200  # structures of MPNN's card/CPU training comparison
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+), "
                        r"Time per epoch \(s\): ([0-9.]+)")
CGCNN_DEMO = {
    "model": "CGCNN", "dim1": 100, "dim2": 150, "pre_fc_count": 1,
    "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
    "pool_order": "early", "batch_norm": "True", "batch_track_stats": "True",
    "act": "relu", "dropout_rate": 0.0, "epochs": 250, "lr": 0.002,
    "batch_size": 100, "optimizer": "AdamW", "optimizer_args": {},
    "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}
MPNN_DEMO = {
    "model": "MPNN", "dim1": 100, "dim2": 100, "dim3": 100, "pre_fc_count": 1,
    "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
    "pool_order": "early", "batch_norm": "True", "batch_track_stats": "True",
    "act": "relu", "dropout_rate": 0.0, "epochs": 250, "lr": 0.001,
    "batch_size": 100, "optimizer": "AdamW", "optimizer_args": {},
    "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}
GCN_DEMO = {
    "model": "GCN", "dim1": 100, "dim2": 150, "pre_fc_count": 1,
    "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
    "pool_order": "early", "batch_norm": "True", "batch_track_stats": "True",
    "act": "relu", "dropout_rate": 0.0, "epochs": 250, "lr": 0.002,
    "batch_size": 100, "optimizer": "AdamW", "optimizer_args": {},
    "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}
SCHNET_DEMO = {
    "model": "SchNet", "dim1": 100, "dim2": 100, "dim3": 150, "cutoff": 8,
    "pre_fc_count": 1, "gc_count": 4, "post_fc_count": 3,
    "pool": "global_mean_pool", "pool_order": "early", "batch_norm": "True",
    "batch_track_stats": "True", "act": "relu", "dropout_rate": 0.0,
    "epochs": 250, "lr": 0.0005, "batch_size": 100, "optimizer": "AdamW",
    "optimizer_args": {}, "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}


def predict_config(data_path: str, model_path: str, job_name: str,
                   device: str) -> dict:
    """The config cli.load_config gives for --run_mode=Predict, with the
    data, checkpoint, job name and device of this run."""
    job = {**PREDICT_JOB, "run_mode": "Predict", "model_path": model_path,
           "job_name": job_name, "seed": 1, "device": device}
    return {"Job": job, "Processing": {**PROCESSING, "data_path": data_path},
            "Training": dict(TRAINING), "Models": {}}


def training_config(data_path: str, model_path: str, job_name: str,
                    device: str, epochs: int, kernel: str = "auto",
                    model: dict = CGCNN_DEMO) -> dict:
    """The config cli.load_config gives for --run_mode=Training of `model`
    (CGCNN_demo, SchNet_demo, MPNN_demo or GCN_demo), resuming from `model_path`
    (load_model True), with this run's epochs, kernel, device and
    verbosity 1."""
    job = {**TRAIN_JOB, "run_mode": "Training", "job_name": job_name,
           "seed": TRAIN_SEED, "device": device, "load_model": "True",
           "model_path": model_path, "parallel": "False"}
    model = {**model, "epochs": epochs, "kernel": kernel,
             "print_model": False}
    return {"Job": job, "Processing": {**PROCESSING, "data_path": data_path},
            "Training": {**TRAINING, "verbosity": 1}, "Models": model}


def write_structures(root: str, n: int = N_STRUCTURES, seed: int = 0):
    """n periodic structures, 8-64 atoms, cubic cells of 16 Å^3 per atom,
    random species 1-83, as ase-json, with targets.csv."""
    from matdeeplearn_torch.data.structures import Structure, write_ase_json

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    rows = []
    for i in range(n):
        na = int(rng.integers(8, 65))
        cell = np.eye(3) * (16.0 * na) ** (1.0 / 3.0)
        pos = rng.random((na, 3)) @ cell
        z = rng.integers(1, 84, na)
        write_ase_json(Structure(z, pos, cell, np.ones(3, bool), str(i)),
                       os.path.join(root, f"{i}.json"))
        rows.append(f"{i},{0.01 * float(z.sum()) / na + rng.normal():.6f}")
    with open(os.path.join(root, "targets.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, reps: int = 100) -> float:
    """Mean device time of fn() in ms: the launches queue up behind a sleep
    kernel, so the host's per-call cost leaves no gaps between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    f32 operations over `rate` (the FMA pipes' unless the kernel runs them
    on the tensor cores), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernels(dst, mask, n, dev):
    """Each kernel against its plain version on the card; returns the
    largest |kernel - plain| of each."""
    from matdeeplearn_torch.ops import csr

    g = torch.Generator(device=dev).manual_seed(1)
    e = dst.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    cases = [("sorted dst, tail pads", dst, mask, 100),
             ("permuted dst", dst[perm].contiguous(), mask[perm].contiguous(), 100),
             ("scattered mask", dst, scattered, 100),
             ("mask None", dst, None, 100)]
    cases += [(f"D={d}", dst, mask, d) for d in (1, 3, 150)]
    err = {"segment_sum": 0.0, "gather": 0.0}
    for name, dv, mv, d in cases:
        msg = torch.randn(e, d, device=dev, generator=g)
        x = torch.randn(n, d, device=dev, generator=g)
        ref = csr.segment_sum_plain(msg, dv, mv, n)
        out = csr.segment_sum(msg, dv, mv, n)
        torch.testing.assert_close(out, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()),
                                   msg=lambda m: f"segment_sum, {name}: {m}")
        gout = csr.gather(x, dv, mv)
        if not torch.equal(gout, csr.gather_plain(x, dv, mv)):
            raise AssertionError(f"gather, {name}: not bit-exact")
        diff = float((out - ref).abs().max())
        err["segment_sum"] = max(err["segment_sum"], diff)
        print(f"  kernel check ok: {name}: segment_sum max |diff| {diff:.3e} "
              f"(max |ref| {float(ref.abs().max()):.3e}), gather bit-exact")
    # one gradient of each autograd pair
    msg = torch.randn(e, 100, device=dev, generator=g, requires_grad=True)
    x = torch.randn(n, 100, device=dev, generator=g, requires_grad=True)
    cot_n = torch.randn(n, 100, device=dev, generator=g)
    cot_e = torch.randn(e, 100, device=dev, generator=g)
    (csr.sorted_segment_sum(msg, dst, mask, n) * cot_n).sum().backward()
    if not torch.equal(msg.grad, csr.gather_plain(cot_n, dst, mask)):
        raise AssertionError("SortedSegmentSum backward (gather) not bit-exact")
    (csr.sorted_gather(x, dst, mask) * cot_e).sum().backward()
    ref = csr.segment_sum_plain(cot_e, dst, mask, n)
    torch.testing.assert_close(x.grad, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    err["segment_sum"] = max(err["segment_sum"], float((x.grad - ref).abs().max()))
    print("  kernel check ok: gradients of SortedSegmentSum and SortedGather")
    return err


def time_kernels(dst, mask, n, dev, d=100):
    """Kernel, plain and library times at one Predict batch's shapes, and
    the bound of each (bytes each function must move over the memory rate,
    or its f32 operations over the f32 rate, whichever is larger)."""
    from matdeeplearn_torch.ops import csr

    g = torch.Generator(device=dev).manual_seed(2)
    e = dst.shape[0]
    msg = torch.randn(e, d, device=dev, generator=g)
    x = torch.randn(n, d, device=dev, generator=g)
    msg_m = msg * mask[:, None]
    acc = torch.zeros(n, d, device=dev)
    real = mask > 0
    e_real = int(real.sum())
    rows = int(torch.unique(dst[real]).numel())

    res = {
        "segment_sum": {
            "ms": device_ms(lambda: csr.segment_sum(msg, dst, mask, n)),
            "plain_ms": device_ms(lambda: csr.segment_sum_plain(msg, dst, mask, n)),
            # out.index_add_ on pre-masked messages (one call, accumulating)
            "library_ms": device_ms(lambda: acc.index_add_(0, dst, msg_m)),
            **bound(4 * (e_real * d + 2 * e + n * d), 2 * e_real * d),
        },
        "gather": {
            "ms": device_ms(lambda: csr.gather(x, dst, mask)),
            "plain_ms": device_ms(lambda: csr.gather_plain(x, dst, mask)),
            # index_select without the mask multiply
            "library_ms": device_ms(lambda: torch.index_select(x, 0, dst)),
            **bound(4 * (rows * d + 2 * e + e * d), e_real * d),
        },
    }
    return res, e_real


FUSED_GRADS = ["x", "xj", "wfi", "wfj", "wfe", "bf", "wsi", "wsj", "wse", "bs"]


def fused_inputs(batch, d, de, g, dev):
    """Random node features (xj = x[src], as CGConv gathers it) and the
    eight weight blocks of one CGConv at width d."""
    x = torch.randn(batch.num_nodes, d, device=dev, generator=g)
    xj = x[batch.edge_src.long()].contiguous()
    shapes = ((d, d), (d, d), (de, d), (d,), (d, d), (d, d), (de, d), (d,))
    ws = [0.1 * torch.randn(*sh, device=dev, generator=g) for sh in shapes]
    return x, xj, ws


def limit_share(out, ref) -> float:
    """The worst element's |out - ref| over what assert_fused allows it
    (1e-4·max|ref| + 1e-4·|ref|): below 1 passes; inf if out is not finite
    where ref is."""
    if not bool(torch.isfinite(out[torch.isfinite(ref)]).all()):
        return float("inf")
    allowed = 1e-4 * max(float(ref.abs().max()), 1e-30) + 1e-4 * ref.abs()
    return float(((out - ref).abs() / allowed).max())


def assert_fused(out, ref, what) -> float:
    """rtol 1e-4, atol 1e-4·max|ref|: atomics reorder the f32 sums, and the
    weight gradients sum over every edge in another order than the plain
    version's GEMMs. Returns max |out - ref|."""
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * max(float(ref.abs().max()), 1e-30),
                               msg=lambda m: f"{what}: {m}")
    return float((out - ref).abs().max())


def check_fused(batch, dev, de=50):
    """The fused CGConv kernels against their plain versions on the card;
    returns the largest |kernel - plain| of each kernel. Every comparison of
    every case runs and prints its worst share of the limit (limit_share)
    before the first failure is raised."""
    from matdeeplearn_torch.ops import fused_cgconv as FC

    g = torch.Generator(device=dev).manual_seed(3)
    dst, mask, dist, n = (batch.edge_dst, batch.edge_mask,
                          batch.edge_dist_norm, batch.num_nodes)
    e = dst.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {k: 0.0 for k in FC.LAUNCHES}
    failures = []

    def reading(pairs, what):
        """max |out - ref| and the worst limit_share over (name, out, ref)
        pairs; a failed assert_fused is kept, not raised."""
        diff = share = 0.0
        for k, out, ref in pairs:
            try:
                diff = max(diff, assert_fused(out, ref, f"{what} {k}"))
            except AssertionError as exc:
                failures.append(str(exc))
                diff = max(diff, float((out - ref).abs().max()))
            share = max(share, limit_share(out, ref))
        return diff, share

    for d in (100, 3, 150):
        x, xj, ws = fused_inputs(batch, d, de, g, dev)
        cot = torch.randn(n, d, device=dev, generator=g)
        cases = [("sorted dst, tail pads", xj, dist, dst, mask),
                 ("permuted dst", xj[perm].contiguous(), dist[perm].contiguous(),
                  dst[perm].contiguous(), mask[perm].contiguous()),
                 ("scattered mask", xj, dist, dst, scattered)]
        for name, xjv, dv, dsv, mv in cases:
            what = f"D={d}, {name}"
            failed = len(failures)
            args = (x, xjv, dv, dsv, mv, *ws, n, 0.2)
            fwd, s_fwd = reading([("output", FC.fused_cgconv(*args),
                                   FC.fused_cgconv_plain(*args))],
                                 f"fused forward, {what}:")
            got = FC.fused_cgconv_bwd(cot, *args)
            refs = list(zip(FUSED_GRADS, got, FC.fused_cgconv_bwd_plain(cot, *args)))
            nodes = reading(refs[:2], f"fused backward, {what}: d_")
            weights = reading(refs[2:], f"fused backward, {what}: d_")
            bwd = max(nodes[0], weights[0])
            if float(got[1][mv == 0].abs().max()) != 0.0:
                raise AssertionError(f"fused, {what}: pad edges got non-zero "
                                     "d_xj rows")
            if not all(torch.equal(a, b) for a, b in
                       zip(got[2:], FC.fused_cgconv_bwd(cot, *args)[2:])):
                raise AssertionError(f"fused weight gradients, {what}: two "
                                     "calls differ")
            # each kernel of the backward against its plain stage
            rows = FC.fused_cgconv_bwd_rows(cot, *args)
            prow = FC.bwd_rows_plain(cot, *args)
            real = mv != 0
            edge, s_edge = reading([("d_x", rows[0], prow[0]),
                                    ("d_xj", rows[1], prow[1]),
                                    ("dA", rows[2][real], prow[2][real])],
                                   f"fused backward rows, {what}:")
            partial, slices = FC.fused_cgconv_wgrad(x, xjv, dv, dsv, mv,
                                                    rows[2], n, de, 0.2)
            want = FC.wgrad_partials_plain(x, xjv, dv, dsv, mv, prow[2], n, de,
                                           0.2, slices)
            k1 = 2 * d + de + 1
            wgr, s_wgr = reading([("slices",
                                   FC.from_partial_layout(partial, k1, 2 * d),
                                   FC.from_partial_layout(want, k1, 2 * d))],
                                 f"fused wgrad, {what}:")
            red, s_red = reading([("sum", FC.wgrad_reduce(partial, slices, d, de),
                                   FC.wgrad_reduce_plain(partial, d, de))],
                                 f"wgrad_reduce, {what}:")
            for key, v in (("fused_cgconv_fwd", fwd), ("fused_cgconv_bwd", edge),
                           ("fused_cgconv_wgrad", wgr),
                           ("fused_cgconv_wgrad_reduce", red)):
                err[key] = max(err[key], v)
            verdict = "ok" if len(failures) == failed else "FAILED"
            print(f"  fused kernel check {verdict}: {what}: forward max |diff| "
                  f"{fwd:.3e}, backward (10 gradients) {bwd:.3e}, bit-identical "
                  f"twice; edge rows {edge:.3e}, {slices} wgrad slices "
                  f"{wgr:.3e}, reduce {red:.3e}; worst share of the limit: "
                  f"forward {s_fwd:.3g}, d_x and d_xj {nodes[1]:.3g}, weight "
                  f"gradients {weights[1]:.3g}, edge rows {s_edge:.3g}, slices "
                  f"{s_wgr:.3g}, reduce {s_red:.3g}")
    if failures:
        raise AssertionError(f"{len(failures)} fused CGConv checks failed; "
                             f"the first: {failures[0]}")
    return err


def time_fused(batch, dev, d=100, de=50):
    """Fused kernel, plain and library times at one training batch's shapes
    (sorted dst), and the bound of each. The library yardstick is the
    unfused composition PR 1's CGConv runs on the card (basis, CSR gather,
    concat, two F.linear, sigmoid·softplus, CSR segment sum) and its
    autograd backward; the port never calls it under kernel fused."""
    import torch.nn.functional as F

    from matdeeplearn_torch.ops import csr
    from matdeeplearn_torch.ops import fused_cgconv as FC
    from matdeeplearn_torch.ops.edge_basis import gaussian_basis

    g = torch.Generator(device=dev).manual_seed(4)
    dst, mask, dist, n = (batch.edge_dst, batch.edge_mask,
                          batch.edge_dist_norm, batch.num_nodes)
    e = dst.shape[0]
    e_real = int((mask > 0).sum())
    x, xj, ws = fused_inputs(batch, d, de, g, dev)
    cot = torch.randn(n, d, device=dev, generator=g)
    args = (x, xj, dist, dst, mask, *ws, n, 0.2)
    k, nb = 2 * d + de, 2 * d
    k1 = k + 1

    # the unfused composition, in torch.nn.Linear's (out, in) layout
    leaves = [x.clone().requires_grad_(True), xj.clone().requires_grad_(True),
              torch.cat(ws[0:3], 0).t().contiguous().requires_grad_(True),
              ws[3].clone().requires_grad_(True),
              torch.cat(ws[4:7], 0).t().contiguous().requires_grad_(True),
              ws[7].clone().requires_grad_(True)]

    def unfused(xv, xjv, wf, bf, wsm, bs):
        z = torch.cat([csr.sorted_gather(xv, dst, mask), xjv,
                       gaussian_basis(dist, 0.0, 1.0, de, 0.2)], -1)
        msg = torch.sigmoid(F.linear(z, wf, bf)) * F.softplus(F.linear(z, wsm, bs))
        return csr.sorted_segment_sum(msg, dst, mask, n)

    out = unfused(*leaves)
    da = FC.fused_cgconv_bwd_rows(cot, *args)[2]
    wg = (x, xj, dist, dst, mask, da, n, de, 0.2)
    partial, blocks = FC.fused_cgconv_wgrad(*wg)
    pfloats = partial.numel()
    # the library yardstick of the weight gradient: one product zᵀ·dA
    # over the formed rows
    zt = FC._edge_terms(x, xj, dist, dst, mask, n, de, 0.2)[0].t().contiguous()
    dan = FC.bwd_rows_plain(cot, *args)[2].view(e, 2, -1)[..., :d].reshape(e, nb)
    fwd_bytes = 4 * (2 * n * d + e_real * d + 3 * e + k1 * nb)
    fwd_flops = 2 * e_real * k * nb
    res = {
        # z·W on wgmma in 3xTF32 (with its weight split); the FMA pipes'
        # bound beside it, the parent design's
        "fused_cgconv_fwd": {
            "ms": device_ms(lambda: FC.fused_cgconv(*args)),
            "plain_ms": device_ms(lambda: FC.fused_cgconv_plain(*args)),
            "library_ms": device_ms(lambda: unfused(*leaves)),
            **bound(fwd_bytes, fwd_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(fwd_bytes, fwd_flops)["bound_ms"],
        },
        # the edge kernel: d_x, d_xj and dA from the recompute z·W and
        # dA·W[:2D]ᵀ; its yardstick is the unfused autograd backward to x
        # and xj alone
        "fused_cgconv_bwd": {
            "ms": device_ms(lambda: FC.fused_cgconv_bwd_rows(cot, *args)),
            "plain_ms": device_ms(lambda: FC.bwd_rows_plain(cot, *args)),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves[:2], cot, retain_graph=True)),
            **bound(4 * (3 * n * d + e_real * d + 3 * e + k1 * nb + nb * nb
                         + e * d + e_real * nb),
                    2 * e_real * (k * nb + nb * nb), TF32X3_FLOPS),
        },
        # the weight gradient zᵀ·dA in slices; its bound counts the slices
        # as its output
        "fused_cgconv_wgrad": {
            "ms": device_ms(lambda: FC.fused_cgconv_wgrad(*wg)),
            "plain_ms": device_ms(lambda: FC.wgrad_partials_plain(*wg, blocks)),
            "library_ms": device_ms(lambda: torch.mm(zt, dan)),
            **bound(4 * (n * d + e_real * d + 3 * e + e_real * nb + pfloats),
                    2 * e_real * k1 * nb, TF32X3_FLOPS),
        },
        "fused_cgconv_wgrad_reduce": {
            "ms": device_ms(lambda: FC.wgrad_reduce(partial, blocks, d, de)),
            "plain_ms": device_ms(lambda: FC.wgrad_reduce_plain(partial, d, de)),
            "library_ms": device_ms(lambda: partial.view(blocks, -1).sum(0)),
            **bound(4 * (pfloats + k1 * nb), pfloats),
        },
    }
    # the whole backward (every launch and allocation) against its autograd
    # yardstick, and its split; the forward and backward pairs are sums of
    # their timed parts (one forward + autograd backward per call outruns
    # device_ms's sleep on the host)
    whole_bytes = 4 * (3 * n * d + e_real * d + 3 * e + 2 * k1 * nb + e * d)
    whole_flops = 2 * e_real * (k * nb + nb * nb + k1 * nb)
    whole = {
        "bwd_ms": device_ms(lambda: FC.fused_cgconv_bwd(cot, *args)),
        "autograd_ms": device_ms(lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True)),
        "alloc_ms": device_ms(lambda: (
            torch.zeros(n, d, device=dev), torch.empty_like(da),
            torch.empty_like(xj), torch.empty_like(partial),
            FC.pad_weights(FC.pack_weights(*ws), d))),
        **bound(whole_bytes, whole_flops, TF32X3_FLOPS),
        # the same operations at the FMA pipes' rate, the bound of the
        # scalar-FMA design this backward replaced
        "fma_bound_ms": bound(whole_bytes, whole_flops)["bound_ms"],
    }
    whole["pair_ms"] = res["fused_cgconv_fwd"]["ms"] + whole["bwd_ms"]
    whole["unfused_pair_ms"] = (res["fused_cgconv_fwd"]["library_ms"]
                                + whole["autograd_ms"])
    return res, e_real, blocks, whole


CFCONV_GRADS = ["xj", "w0", "b0", "w1", "b1"]


def cfconv_inputs(batch, f, de, g, dev):
    """xj = h[src] of random node features h, and the four filter
    parameters of one cfconv at width f."""
    h = torch.randn(batch.num_nodes, f, device=dev, generator=g)
    xj = torch.index_select(h, 0, batch.edge_src)
    shapes = ((de, f), (f,), (f, f), (f,))
    ws = [0.1 * torch.randn(*sh, device=dev, generator=g) for sh in shapes]
    return h, xj, ws


def check_cfconv(batch, dev, de=50, cutoff=8.0):
    """The fused cfconv kernels against their plain versions on the card;
    returns the largest |kernel - plain| of each kernel. Every comparison of
    every case runs and prints its worst share of the limit (limit_share)
    before the first failure is raised: the output, d_xj and the four
    weight gradients, and each kernel of the backward against its plain
    stage (the edge rows d_xj, a, dw and dpre of real edges, every
    weight-gradient slice, the slice sum). The weight gradients must be
    bit-identical between two calls and masked d_xj rows exactly zero."""
    from matdeeplearn_torch.ops import fused_cfconv as FS

    g = torch.Generator(device=dev).manual_seed(5)
    dst, mask, n = batch.edge_dst, batch.edge_mask, batch.num_nodes
    dist, wraw = batch.edge_dist_norm, batch.edge_weight
    e = dst.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {k: 0.0 for k in FS.LAUNCHES}
    failures = []

    def reading(pairs, what):
        """max |out - ref| and the worst limit_share over (name, out, ref)
        pairs; a failed assert_fused is kept, not raised."""
        diff = share = 0.0
        for k, out, ref in pairs:
            try:
                diff = max(diff, assert_fused(out, ref, f"{what} {k}"))
            except AssertionError as exc:
                failures.append(str(exc))
                diff = max(diff, float((out - ref).abs().max()))
            share = max(share, limit_share(out, ref))
        return diff, share

    for f in (150, 3, 100):
        _, xj, ws = cfconv_inputs(batch, f, de, g, dev)
        cot = torch.randn(n, f, device=dev, generator=g)
        p = lambda t: t[perm].contiguous()
        cases = [("sorted dst, tail pads", xj, dist, wraw, dst, mask),
                 ("permuted dst", p(xj), p(dist), p(wraw), p(dst), p(mask)),
                 ("scattered mask", xj, dist, wraw, dst, scattered)]
        for name, *edges in cases:
            what = f"F={f}, {name}"
            failed = len(failures)
            args = (*edges, *ws, n, 0.2, cutoff)
            fwd, s_fwd = reading([("output", FS.fused_cfconv(*args),
                                   FS.fused_cfconv_plain(*args))],
                                 f"cfconv forward, {what}:")
            got = FS.fused_cfconv_bwd(cot, *args)
            refs = list(zip(CFCONV_GRADS, got, FS.fused_cfconv_bwd_plain(cot, *args)))
            rows_in, s_rows_in = reading(refs[:1], f"cfconv backward, {what}: d_")
            weights, s_weights = reading(refs[1:], f"cfconv backward, {what}: d_")
            if float(got[0][edges[4] == 0].abs().max()) != 0.0:
                raise AssertionError(f"cfconv, {what}: masked edges got "
                                     "non-zero d_xj rows")
            if not all(torch.equal(a, b) for a, b in
                       zip(got[1:], FS.fused_cfconv_bwd(cot, *args)[1:])):
                raise AssertionError(f"cfconv weight gradients, {what}: two "
                                     "calls differ")
            # each kernel of the backward against its plain stage
            rows = FS.fused_cfconv_bwd_rows(cot, *args)
            prow = FS.bwd_rows_plain(cot, *args)
            real = FS.edge_scale(edges[2], edges[3], edges[4], n, cutoff) != 0
            edge, s_edge = reading(
                [("d_xj", rows[0], prow[0])]
                + [(k, r[real], q[real]) for k, r, q in
                   zip(("a", "dw", "dpre"), rows[1:], prow[1:])],
                f"cfconv backward rows, {what}:")
            wg = (*edges[1:5], *rows[1:], n, f, de, 0.2, cutoff)
            partial, slices = FS.fused_cfconv_wgrad(*wg)
            want = FS.wgrad_partials_plain(*edges[1:5], *prow[1:], n, f, de,
                                           0.2, cutoff, slices)
            wgr, s_wgr = reading([("slices", partial, want)],
                                 f"cfconv wgrad, {what}:")
            red, s_red = reading([("sum", FS.wgrad_reduce(partial, slices, f, de),
                                   FS.wgrad_reduce_plain(partial, f, de))],
                                 f"cfconv wgrad_reduce, {what}:")
            for key, v in (("fused_cfconv_fwd", fwd), ("fused_cfconv_bwd", edge),
                           ("fused_cfconv_wgrad", wgr),
                           ("fused_cfconv_wgrad_reduce", red)):
                err[key] = max(err[key], v)
            verdict = "ok" if len(failures) == failed else "FAILED"
            print(f"  cfconv kernel check {verdict}: {what}: forward max |diff| "
                  f"{fwd:.3e}, d_xj {rows_in:.3e}, weight gradients "
                  f"{weights:.3e} (bit-identical twice); edge rows {edge:.3e}, "
                  f"{slices} wgrad slices {wgr:.3e}, reduce {red:.3e}; masked "
                  f"d_xj rows zero; worst share of the limit: forward "
                  f"{s_fwd:.3g}, d_xj {s_rows_in:.3g}, weight gradients "
                  f"{s_weights:.3g}, edge rows {s_edge:.3g}, slices "
                  f"{s_wgr:.3g}, reduce {s_red:.3g}")
    if failures:
        raise AssertionError(f"{len(failures)} cfconv checks failed; the "
                             f"first: {failures[0]}")
    return err


def time_cfconv(batch, dev, f=150, de=50, cutoff=8.0):
    """Fused cfconv kernel, plain and library times at one SchNet_demo
    training batch's shapes (sorted dst), and the bound of each. The
    library yardstick is the unfused SchNet composition (basis, two
    F.linear with shifted softplus, cutoff, index_select, CSR segment sum)
    and its autograd backward; the port never calls it under kernel
    fused."""
    import math

    import torch.nn.functional as F

    from matdeeplearn_torch.ops import csr
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops.edge_basis import gaussian_basis

    g = torch.Generator(device=dev).manual_seed(6)
    dst, mask, n = batch.edge_dst, batch.edge_mask, batch.num_nodes
    dist, wraw, src = batch.edge_dist_norm, batch.edge_weight, batch.edge_src
    e = dst.shape[0]
    e_real = int((mask > 0).sum())
    h, xj, ws = cfconv_inputs(batch, f, de, g, dev)
    cot = torch.randn(n, f, device=dev, generator=g)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, cutoff)

    # the unfused composition, in torch.nn.Linear's (out, in) layout
    leaves = [h.clone().requires_grad_(True),
              ws[0].t().contiguous().requires_grad_(True),
              ws[1].clone().requires_grad_(True),
              ws[2].t().contiguous().requires_grad_(True),
              ws[3].clone().requires_grad_(True)]

    def unfused(hv, w0, b0, w1, b1):
        basis = gaussian_basis(dist, 0.0, 1.0, de, 0.2)
        w = F.linear(F.softplus(F.linear(basis, w0, b0)) - 0.6931471805599453,
                     w1, b1)
        c = 0.5 * (torch.cos(wraw * (math.pi / cutoff)) + 1.0)
        msg = torch.index_select(hv, 0, src) * w * c[:, None]
        return csr.sorted_segment_sum(msg, dst, mask, n)

    out = unfused(*leaves)
    rows = FS.fused_cfconv_bwd_rows(cot, *args)
    wg = (dist, wraw, dst, mask, *rows[1:], n, f, de, 0.2, cutoff)
    partial, blocks = FS.fused_cfconv_wgrad(*wg)
    pfloats = partial.numel()
    weights = (de + 1) * f + (f + 1) * f
    # the library yardstick of the weight gradient: one batched product of
    # [b | 1]ᵀ·dpre and [a | 1]ᵀ·dw over the formed rows, both padded to
    # F + 1 rows
    prow = FS.bwd_rows_plain(cot, *args)
    zcat = torch.zeros(2, e, f + 1, device=dev)
    zcat[0, :, :de] = gaussian_basis(dist, 0.0, 1.0, de, 0.2)
    zcat[:, :, de] = 1.0
    zcat[1, :, :f] = prow[1][:, :f]
    zcat[1, :, f] = 1.0
    zt = zcat.transpose(1, 2).contiguous()
    dcat = torch.stack([prow[3][:, :f], prow[2][:, :f]]).contiguous()
    fwd_bytes = 4 * (n * f + e_real * f + 4 * e + weights)
    fwd_flops = 2 * e_real * (de * f + f * f)
    # the edge kernel: pre = b·W0, w = a·W1 and dw·W1ᵀ; it writes d_xj and
    # the a, dw and dpre rows (its outputs)
    rows_bytes = 4 * (n * f + e_real * f + 4 * e + weights + e * f
                      + 3 * e_real * f)
    rows_flops = 2 * e_real * (de * f + 2 * f * f)
    # the weight gradient [b | 1]ᵀ·dpre and [a | 1]ᵀ·dw from those rows
    wgrad_bytes = 4 * (3 * e + 3 * e_real * f + pfloats)
    wgrad_flops = 2 * e_real * ((de + 1) * f + (f + 1) * f)
    res = {
        "fused_cfconv_fwd": {
            "ms": device_ms(lambda: FS.fused_cfconv(*args)),
            "plain_ms": device_ms(lambda: FS.fused_cfconv_plain(*args)),
            "library_ms": device_ms(lambda: unfused(*leaves)),
            **bound(fwd_bytes, fwd_flops),
        },
        # the edge rows on wgmma in 3xTF32 (with its weight split); its
        # yardstick is the unfused autograd backward to h alone
        "fused_cfconv_bwd": {
            "ms": device_ms(lambda: FS.fused_cfconv_bwd_rows(cot, *args)),
            "plain_ms": device_ms(lambda: FS.bwd_rows_plain(cot, *args)),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves[:1], cot, retain_graph=True)),
            **bound(rows_bytes, rows_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(rows_bytes, rows_flops)["bound_ms"],
        },
        # the weight gradient in slices on mma.sync in 3xTF32; its bound
        # counts the slices as its output
        "fused_cfconv_wgrad": {
            "ms": device_ms(lambda: FS.fused_cfconv_wgrad(*wg)),
            "plain_ms": device_ms(lambda: FS.wgrad_partials_plain(
                *wg[:7], n, f, de, 0.2, cutoff, blocks)),
            "library_ms": device_ms(lambda: torch.bmm(zt, dcat)),
            **bound(wgrad_bytes, wgrad_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(wgrad_bytes, wgrad_flops)["bound_ms"],
        },
        "fused_cfconv_wgrad_reduce": {
            "ms": device_ms(lambda: FS.wgrad_reduce(partial, blocks, f, de)),
            "plain_ms": device_ms(lambda: FS.wgrad_reduce_plain(partial, f, de)),
            "library_ms": device_ms(lambda: partial.view(blocks, -1).sum(0)),
            # the output is the (round4(De+1) + round4(F+1), F) stack
            **bound(4 * (pfloats + f * (FS._round4(de + 1) + FS._round4(f + 1))),
                    pfloats),
        },
    }
    # the whole backward (every launch and allocation) against its autograd
    # yardstick: the function's operations at the 3xTF32 rate, and at the
    # FMA pipes' rate (the parent's one-kernel design)
    whole_bytes = 4 * (n * f + e_real * f + e * f + 4 * e + 2 * weights)
    whole_flops = 2 * e_real * (2 * de * f + 3 * f * f)
    whole = {
        "bwd_ms": device_ms(lambda: FS.fused_cfconv_bwd(cot, *args)),
        "autograd_ms": device_ms(lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True)),
        **bound(whole_bytes, whole_flops, TF32X3_FLOPS),
        "fma_bound_ms": bound(whole_bytes, whole_flops)["bound_ms"],
    }
    return res, e_real, blocks, whole


BILINEAR_GRADS = ["xj", "a", "w1", "b1"]


def bilinear_inputs(batch, d, h, k, g, dev):
    """xj = x[src] of random node features, a = relu(·) as the edge network
    gives it, and lin1's (H, D·K) matrix and bias, of one NNConv message."""
    x = torch.randn(batch.num_nodes, d, device=dev, generator=g)
    xj = torch.index_select(x, 0, batch.edge_src)
    a = torch.relu(torch.randn(xj.shape[0], h, device=dev, generator=g))
    w1 = 0.1 * torch.randn(h, d * k, device=dev, generator=g)
    b1 = 0.1 * torch.randn(d * k, device=dev, generator=g)
    return xj, a, w1, b1


def check_bilinear(batch, dev):
    """The bilinear NNConv kernels against their plain versions on the
    card; returns the largest |kernel - plain| of each kernel. Every
    comparison of every case runs and prints its worst share of the limit
    (limit_share) before the first failure is raised."""
    from matdeeplearn_torch.ops import fused_bilinear as FB

    g = torch.Generator(device=dev).manual_seed(8)
    mask = batch.edge_mask
    e = mask.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {k: 0.0 for k in FB.LAUNCHES}
    failures = []

    def reading(pairs, what):
        """max |out - ref| and the worst limit_share over (name, out, ref)
        pairs; a failed assert_fused is kept, not raised."""
        diff = share = 0.0
        for n, out, ref in pairs:
            try:
                diff = max(diff, assert_fused(out, ref, f"{what} {n}"))
            except AssertionError as exc:
                failures.append(str(exc))
                diff = max(diff, float((out - ref).abs().max()))
            share = max(share, limit_share(out, ref))
        return diff, share

    for d, h, k in ((100, 100, 100), (3, 7, 5), (150, 100, 150)):
        xj, a, w1, b1 = bilinear_inputs(batch, d, h, k, g, dev)
        cot = torch.randn(e, k, device=dev, generator=g)
        p = lambda t: t[perm].contiguous()
        cases = [("sorted dst, tail pads", xj, a, mask, cot),
                 ("permuted dst", p(xj), p(a), p(mask), p(cot)),
                 ("scattered mask", xj, a, scattered, cot)]
        for name, xjv, av, mv, cv in cases:
            what = f"D={d}, H={h}, K={k}, {name}"
            failed = len(failures)
            args = (xjv, av, w1, b1, mv)
            out = FB.fused_bilinear(*args)
            fwd, s_fwd = reading([("output", out, FB.fused_bilinear_plain(*args))],
                                 f"bilinear forward, {what}:")
            rows = FB.fused_bilinear_bwd_rows(cv, *args)
            again = FB.fused_bilinear_bwd_rows(cv, *args)
            if not all(torch.equal(x, y) for x, y in zip(again, rows)):
                raise AssertionError(f"bilinear d_xj/d_a, {what}: two calls "
                                     "differ")
            dw = FB.fused_bilinear_wgrad(cv, xjv, av, mv)
            if not torch.equal(FB.fused_bilinear_wgrad(cv, xjv, av, mv), dw):
                raise AssertionError(f"bilinear dW, {what}: two calls differ")
            got = (*rows, *FB.split_wgrad(dw, w1.shape, b1.shape))
            pairs = list(zip(BILINEAR_GRADS, got,
                             FB.fused_bilinear_bwd_plain(cv, *args)))
            bwd, s_bwd = reading(pairs[:2], f"bilinear, {what}: d_")
            wgr, s_wgr = reading(pairs[2:], f"bilinear, {what}: d_")
            for t in (out, *rows):
                if float(t[mv == 0].abs().max()) != 0.0:
                    raise AssertionError(f"bilinear, {what}: masked rows are "
                                         "not exactly zero")
            for key, v in (("fused_bilinear_fwd", fwd), ("fused_bilinear_bwd", bwd),
                           ("fused_bilinear_wgrad", wgr)):
                err[key] = max(err[key], v)
            verdict = "ok" if len(failures) == failed else "FAILED"
            print(f"  bilinear kernel check {verdict}: {what}: forward max "
                  f"|diff| {fwd:.3e}, d_xj/d_a {bwd:.3e}, d_w1/d_b1 {wgr:.3e} "
                  f"(both bit-identical twice); masked rows zero; worst share of "
                  f"the limit: forward {s_fwd:.3g}, d_xj/d_a {s_bwd:.3g}, "
                  f"d_w1/d_b1 {s_wgr:.3g}")
    if failures:
        raise AssertionError(f"{len(failures)} bilinear checks failed; the "
                             f"first: {failures[0]}")
    return err


def time_bilinear(batch, dev, d=100, h=100, k=100):
    """Bilinear kernel, plain and library times at one MPNN_demo training
    batch's shapes (sorted dst, tail pads), and the bound of each. The
    library yardstick is one torch.einsum over the same inputs (and its
    autograd backward to xj and a alone, the backward kernel's outputs);
    the port never calls it. Each bound counts the function's operations,
    not the kernel's schedule, at the 3xTF32 rate of the three tensor-core
    kernels (the forward, the backward to the rows, the weight gradient),
    with the FMA pipes' rate beside it as fma_bound_ms."""
    from matdeeplearn_torch.ops import fused_bilinear as FB

    g = torch.Generator(device=dev).manual_seed(9)
    mask = batch.edge_mask
    e = mask.shape[0]
    e_real = int((mask > 0).sum())
    xj, a, w1, b1 = bilinear_inputs(batch, d, h, k, g, dev)
    cot = torch.randn(e, k, device=dev, generator=g)
    args = (xj, a, w1, b1, mask)
    leaves = [t.clone().requires_grad_(True) for t in (xj, a)]

    def library(xjv, av, w1v, b1v):
        msg = (torch.einsum("eh,ed,hdk->ek", av, xjv, w1v.view(h, d, k))
               + xjv @ b1v.view(d, k))
        return msg * mask[:, None]

    out = library(*leaves, w1, b1)
    a_ext = torch.cat([a, torch.ones_like(a[:, :1])], 1)
    ge = cot * mask[:, None]
    units = h + 1
    w_floats = units * d * k
    # the forward's and the weight gradient's bytes (inputs once, output
    # once) and operations (X, then one GEMM)
    fwd_bytes = 4 * (e_real * (d + h + k) + e + w_floats)
    fwd_flops = e_real * h * d + 2 * e_real * units * d * k
    bwd_bytes = 4 * (e_real * (2 * d + 2 * h + k) + e + w_floats)
    bwd_flops = 2 * e_real * units * d * k + e_real * (4 * h * d + d)
    res = {
        "fused_bilinear_fwd": {
            "ms": device_ms(lambda: FB.fused_bilinear(*args), 20),
            "plain_ms": device_ms(lambda: FB.fused_bilinear_plain(*args), 10),
            "library_ms": device_ms(lambda: library(*args[:4]), 10),
            # X = [a | 1]·xj, then X @ [W1; b1]
            **bound(fwd_bytes, fwd_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(fwd_bytes, fwd_flops)["bound_ms"],
        },
        "fused_bilinear_bwd": {
            "ms": device_ms(lambda: FB.fused_bilinear_bwd_rows(cot, *args), 20),
            "plain_ms": device_ms(lambda: FB.bwd_rows_plain(cot, *args), 10),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True), 10),
            # U = ge @ [W1; b1]ᵀ, then d_xj = Σ_h [a | 1]·U, d_a = xj·U
            **bound(bwd_bytes, bwd_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(bwd_bytes, bwd_flops)["bound_ms"],
        },
        "fused_bilinear_wgrad": {
            "ms": device_ms(lambda: FB.fused_bilinear_wgrad(cot, xj, a, mask),
                            20),
            "plain_ms": device_ms(lambda: FB.wgrad_plain(cot, xj, a, mask, k),
                                  10),
            "library_ms": device_ms(lambda: torch.einsum(
                "eh,ed,ek->hdk", a_ext, xj, ge), 10),
            # X = [a | 1]·xj, then Xᵀ ge
            **bound(fwd_bytes, fwd_flops, TF32X3_FLOPS),
            "fma_bound_ms": bound(fwd_bytes, fwd_flops)["bound_ms"],
        },
    }
    return res, e_real


def assert_sum(out, ref, what) -> float:
    """rtol 1e-5, atol 1e-5·max|ref|: the windowed sums add in a fixed
    order that is not index_add_'s. Returns max |out - ref|."""
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * max(float(ref.abs().max()), 1e-30),
                               msg=lambda m: f"{what}: {m}")
    return float((out - ref).abs().max())


def batch_edges(batch):
    """The windowed layout of a windowed batch, as ops/windowed.py takes it."""
    from matdeeplearn_torch.ops.aggregate import _windowed_edges

    return _windowed_edges(batch)


def check_windowed(cases, dev):
    """The windowed kernels against their plain versions on the card, for
    each (name, layout, n, tw) case at D = 1, 100 and 150, with NaN in the
    messages and weights of pad slots: the sums to rtol 1e-5, atol
    1e-5·max|ref|, finite, bit-identical twice, exactly zero on nodes
    without edges (windows that own no tile included); the gather
    bit-exact; the gradients of the three autograd Functions (the SpMM's to
    both operands). Returns the largest |kernel - plain| of each kernel."""
    from matdeeplearn_torch.ops import windowed as WO

    g = torch.Generator(device=dev).manual_seed(10)
    err = {k: 0.0 for k in WO.LAUNCHES}
    for name, we, n, tw in cases:
        e = we.dst.shape[0]
        pad = we.dst < 0
        real = WO.slot_valid(we.dst, we.window_id, tw, n)
        no_edge = torch.ones(n, dtype=torch.bool, device=dev)
        no_edge[we.dst[real].long()] = False
        for d in (1, 100, 150):
            what = f"{name}, D={d}"
            msg = torch.randn(e, d, device=dev, generator=g)
            w = torch.randn(e, device=dev, generator=g)
            msg[pad], w[pad] = float("nan"), float("nan")
            x = torch.randn(n, d, device=dev, generator=g)
            cot_n = torch.randn(n, d, device=dev, generator=g)
            cot_e = torch.randn(e, d, device=dev, generator=g)
            for key, fn, wv in (("windowed_segment_sum",
                                 lambda: WO.segment_sum(msg, we, n, tw), None),
                                ("windowed_spmm",
                                 lambda: WO.spmm(w, msg, we, n, tw), w)):
                out = fn()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{key}, {what}: NaN from pad slots")
                if not torch.equal(out, fn()):
                    raise AssertionError(f"{key}, {what}: two calls differ")
                if float(out[no_edge].abs().max()) != 0.0:
                    raise AssertionError(f"{key}, {what}: nodes without edges "
                                         "are not zero")
                ref = WO.segment_sum_plain(msg, we.dst, we.window_id, n, tw, wv)
                err[key] = max(err[key], assert_sum(out, ref, f"{key}, {what}"))
            gout = WO.gather(x, we, tw)
            if not torch.equal(gout, WO.gather_plain(x, we.dst, we.window_id, tw)):
                raise AssertionError(f"windowed_gather, {what}: not bit-exact")
            # the autograd Functions: sum → gather, SpMM → gather and torch,
            # gather → sum
            m = msg.clone().requires_grad_(True)
            (WO.windowed_segment_sum(m, we, n, tw) * cot_n).sum().backward()
            gg = WO.gather_plain(cot_n, we.dst, we.window_id, tw)
            if not torch.equal(m.grad, gg):
                raise AssertionError(f"WindowedSegmentSum backward, {what}: "
                                     "not bit-exact")
            m = msg.clone().requires_grad_(True)
            wt = w.clone().requires_grad_(True)
            (WO.windowed_spmm(wt, m, we, n, tw) * cot_n).sum().backward()
            assert_sum(m.grad[real], (gg * w[:, None])[real],
                       f"WindowedSpmm d_msg, {what}")
            assert_sum(wt.grad[real], (msg * gg).sum(-1)[real],
                       f"WindowedSpmm d_w, {what}")
            xt = x.clone().requires_grad_(True)
            (WO.windowed_gather(xt, we, tw) * cot_e).sum().backward()
            ref = WO.segment_sum_plain(cot_e, we.dst, we.window_id, n, tw)
            err["windowed_segment_sum"] = max(
                err["windowed_segment_sum"],
                assert_sum(xt.grad, ref, f"WindowedGather backward, {what}"))
            print(f"  windowed kernel check ok: {what}: segment_sum max |diff| "
                  f"{err['windowed_segment_sum']:.3e}, spmm "
                  f"{err['windowed_spmm']:.3e}, gather bit-exact; NaN on pad "
                  f"slots kept out; sums bit-identical twice; gradients ok")
    return err


def time_windowed(batch, dev, d=100):
    """Windowed kernel, plain and library times at one GCN_demo training
    batch's layout, and the bound of each (bytes each function must move
    over the memory rate, or its f32 operations on real slots over the f32
    rate, whichever is larger). The library yardsticks: index_add_ over the
    same slots with the mask (and the weight) applied beforehand, and
    index_select; the port never calls them under kernel pallas. The
    segment-sum is timed at D = 1 (GCN's degree, its row in the kernels
    line) and at D = 100 (CGConv's mean under kernel pallas)."""
    from matdeeplearn_torch.ops import windowed as WO

    g = torch.Generator(device=dev).manual_seed(11)
    we, n, tw = batch_edges(batch), batch.num_nodes, batch.window_size
    e, t = we.dst.shape[0], we.window_id.shape[0]
    real = WO.slot_valid(we.dst, we.window_id, tw, n)
    e_real = int(real.sum())
    rows = int(torch.unique(we.dst[real]).numel())
    dst_safe = torch.clamp(we.dst, min=0)
    w = torch.rand(e, device=dev, generator=g)
    layout_bytes = 4 * (e + 2 * t)  # dst, window id and first flag

    def sums(dd):
        msg = torch.randn(e, dd, device=dev, generator=g)
        acc = torch.zeros(n, dd, device=dev)
        msg_m = torch.where(real[:, None], msg, 0.0)
        return msg, acc, msg_m

    res = {}
    for key, dd in (("windowed_segment_sum", 1), ("windowed_segment_sum_d100", d)):
        msg, acc, msg_m = sums(dd)
        res[key] = {
            "ms": device_ms(lambda: WO.segment_sum(msg, we, n, tw)),
            "plain_ms": device_ms(lambda: WO.segment_sum_plain(
                msg, we.dst, we.window_id, n, tw)),
            "library_ms": device_ms(lambda: acc.index_add_(0, dst_safe, msg_m)),
            **bound(4 * (e_real * dd + n * dd) + layout_bytes, e_real * dd),
            "d": dd,
        }
    msg, acc, _ = sums(d)
    msg_w = torch.where(real[:, None], msg * w[:, None], 0.0)
    res["windowed_spmm"] = {
        "ms": device_ms(lambda: WO.spmm(w, msg, we, n, tw)),
        "plain_ms": device_ms(lambda: WO.segment_sum_plain(
            msg, we.dst, we.window_id, n, tw, w)),
        "library_ms": device_ms(lambda: acc.index_add_(0, dst_safe, msg_w)),
        **bound(4 * (e_real * (d + 1) + n * d) + layout_bytes, 2 * e_real * d),
        "d": d,
    }
    x = torch.randn(n, d, device=dev, generator=g)
    res["windowed_gather"] = {
        "ms": device_ms(lambda: WO.gather(x, we, tw)),
        "plain_ms": device_ms(lambda: WO.gather_plain(x, we.dst, we.window_id,
                                                      tw)),
        "library_ms": device_ms(lambda: torch.index_select(x, 0, dst_safe)),
        **bound(4 * (rows * d + e * d) + layout_bytes, 0),
        "d": d,
    }
    return res, e_real


def run_cli(config) -> tuple[float, str]:
    """cli.run(config) with its output echoed (the settings dump left out);
    returns (wall seconds, the captured output)."""
    from matdeeplearn_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.run(config)
    if config["Job"]["device"] == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print("\n".join(ln for ln in text.splitlines()
                    if not ln.startswith((" ", "{", "Settings"))))
    return wall, text


def run_training(config) -> tuple[float, list]:
    """Training through cli.run; returns (wall seconds, one (epoch, lr,
    train error, val error, seconds) row per epoch line)."""
    wall, text = run_cli(config)
    rows = [(int(m.group(1)), *(float(v) for v in m.groups()[1:]))
            for m in EPOCH_LINE.finditer(text)]
    if len(rows) != config["Models"]["epochs"]:
        raise AssertionError(f"expected {config['Models']['epochs']} epoch "
                             f"lines, got {len(rows)}")
    if not np.isfinite([r[2:4] for r in rows]).all():
        raise AssertionError(f"non-finite errors in {rows}")
    return wall, rows


def warm_epoch_s(rows) -> float:
    """Mean time of the epochs after the first."""
    return float(np.mean([r[4] for r in rows[1:]]))


def profile_training(dataset, dev, model: dict = CGCNN_DEMO, top: int = 14,
                     kernel: str = "fused"):
    """One warm training epoch of `model` (kernel `kernel`) under
    torch.profiler: device time by kernel and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.training import jobs

    train_idx, val_idx, _ = split_data(dataset, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    run = jobs.setup_run(dataset, {**model, "kernel": kernel},
                         "l1_loss", seed=TRAIN_SEED, device=dev)
    kw = dict(train_idx=train_idx, val_idx=val_idx, epochs=1, verbosity=1,
              seed=TRAIN_SEED)
    jobs.run_fused_training(run, **kw)  # warm-up epoch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        jobs.run_fused_training(run, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if not rows:
        print(f"profiled {model['model']} training epoch: the profiler saw no "
              "device time (not measured)")
        return
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    print(f"profiled warm {model['model']} training epoch (kernel {kernel}): "
          f"device busy "
          f"{busy_ms:.3f} ms of "
          f"{1e3 * wall:.3f} ms wall ({100 * busy_ms / (1e3 * wall):.1f}%); "
          f"top device time:")
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{key[:100]}")


def run_predict(config) -> tuple[float, float]:
    """Predict through cli.run; returns (wall seconds, evaluation seconds)."""
    wall, text = run_cli(config)
    m = re.search(r"Evaluation time \(s\): ([0-9.]+)", text)
    return wall, float(m.group(1))


def device_rows(prof) -> list:
    """(name, device µs, count) of each kernel and copy the profiler saw.
    Device-side events only (an operator's own row repeats its kernels'
    time), and no user annotations (such as Optimizer.step's range, whose
    device span includes the kernels inside it and the gaps between them)."""
    return [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]


def profile_predict(config, label: str = "CGCNN", top: int = 12):
    """One more Predict on the card under torch.profiler: device time by
    kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, evaluation = run_predict(config)
    rows = device_rows(prof)
    if not rows:
        print(f"profiled {label} Predict: the profiler saw no device time "
              "(not measured)")
        return
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    copy_ms = sum(r[1] for r in rows if r[0].startswith("Memcpy")) / 1e3
    print(f"profiled {label} Predict: device busy {busy_ms:.3f} ms of "
          f"{1e3 * wall:.3f} ms "
          f"wall ({100 * busy_ms / (1e3 * wall):.1f}%), {copy_ms:.3f} ms of it "
          f"copies; kernels {busy_ms - copy_ms:.3f} ms against "
          f"{1e3 * evaluation:.3f} ms evaluation; top device time:")
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {key[:110]}")


def reset_launches(*counts):
    """Set every kernel launch counter in `counts` to 0."""
    for c in counts:
        for k in c:
            c[k] = 0


def read_predictions(path: str) -> tuple[list, np.ndarray]:
    with open(path) as f:
        lines = f.read().splitlines()[1:]
    ids = [ln.split(",")[0] for ln in lines]
    preds = np.array([float(ln.split(",")[-1]) for ln in lines])
    return ids, preds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  WindowedDeviceData, assemble,
                                                  assemble_batch)
    from matdeeplearn_torch.data.dataset import get_dataset, windowed_layout
    from matdeeplearn_torch.models import MODEL_FIELDS, build_model
    from matdeeplearn_torch.ops import _build, csr
    from matdeeplearn_torch.ops import fused_bilinear as FB
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops import fused_cgconv as FC
    from matdeeplearn_torch.ops import windowed as WO
    from matdeeplearn_torch.training.checkpoint import save_checkpoint

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN (full f32)")
    srcs = [os.path.relpath(p, REPO) for p in _build.sources()]
    print(f"kernel build of {', '.join(srcs)} (nvcc {' '.join(_build.NVCC_FLAGS)}, "
          f"one process each, in parallel): {_build.build():.2f} s")

    # ---- data and model ---------------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir = os.path.join(WORK, "data")
    t0 = time.perf_counter()
    write_structures(data_dir)
    dataset = get_dataset(data_dir, 0, "True", {**PROCESSING, "data_path": data_dir})
    print(f"{len(dataset)} structures written and featurized in "
          f"{time.perf_counter() - t0:.2f} s: {int(dataset.node_ptr[-1])} atoms, "
          f"{int(dataset.edge_ptr[-1])} edges "
          f"({dataset.edge_ptr[-1] / dataset.node_ptr[-1]:.2f} a node)")
    batch_size = 128  # Predict's default batch
    spec = BatchSpec.for_dataset(dataset.node_counts(), dataset.edge_counts(),
                                 batch_size)
    steps = -(-len(dataset) // batch_size)
    print(f"Predict spec on {card}: {spec.num_graphs} graphs, "
          f"{spec.num_nodes} nodes, {spec.num_edges} edges a batch; "
          f"{steps} batches")

    def initial_checkpoint(demo: dict, path: str) -> str:
        """`demo` at full width from torch.Generator seed 0, with random
        BatchNorm running statistics, saved with the port's checkpoint."""
        name = demo["model"]
        gen = torch.Generator().manual_seed(0)
        model = build_model(name, dataset, demo, generator=gen, device="cpu")
        with torch.no_grad():
            for key, buf in model.named_buffers():
                if key.endswith("running_mean"):
                    buf.copy_(torch.randn(buf.shape, generator=gen) * 0.5)
                elif key.endswith("running_var"):
                    buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)
        cfg = {k: v for k, v in demo.items() if k in MODEL_FIELDS[name]}
        cfg.update(num_features=dataset.num_features,
                   output_dim=dataset.output_dim,
                   edge_resolution=dataset.num_edge_features)
        save_checkpoint(path, model.state_dict(), name, cfg)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{name} at full width: {n_params} parameters, checkpoint {path}")
        return path

    model_path = initial_checkpoint(CGCNN_DEMO,
                                    os.path.join(WORK, "cgcnn_demo.ckpt"))
    schnet_path = initial_checkpoint(SCHNET_DEMO,
                                     os.path.join(WORK, "schnet_demo.ckpt"))
    mpnn_path = initial_checkpoint(MPNN_DEMO,
                                   os.path.join(WORK, "mpnn_demo.ckpt"))
    gcn_path = initial_checkpoint(GCN_DEMO, os.path.join(WORK, "gcn_demo.ckpt"))

    # ---- CSR kernel checks and times at a Predict batch's shapes ----------
    data = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="dst")
    batch = assemble_batch(data, np.arange(batch_size, dtype=np.int32), spec)
    dst, mask, n = batch.edge_dst, batch.edge_mask, spec.num_nodes
    print(f"kernel checks on {card} (E={dst.shape[0]}, N={n}):")
    err = check_kernels(dst, mask, n, dev)
    times, e_real = time_kernels(dst, mask, n, dev)
    for k, t in times.items():
        print(f"{k} on {smi}, E={dst.shape[0]} ({e_real} real), N={n}, D=100: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    del data, batch

    # ---- fused CGConv kernels at a training batch's shapes ----------------
    train_bs = CGCNN_DEMO["batch_size"]
    tspec = BatchSpec.for_dataset(dataset.node_counts(), dataset.edge_counts(),
                                  train_bs)
    tdata = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="dst",
                                             kernel_fused=True)
    tbatch = assemble_batch(tdata, np.arange(train_bs, dtype=np.int32), tspec)
    print(f"fused kernel checks on {card} (training batch: B={tspec.num_graphs}, "
          f"N={tspec.num_nodes}, E={tspec.num_edges}, De=50):")
    err.update(check_fused(tbatch, dev))
    ftimes, fe_real, blocks, whole = time_fused(tbatch, dev)
    times.update(ftimes)
    for k, t in ftimes.items():
        fma = (f"; at the 67 TFLOP/s FMA rate {t['fma_bound_ms']:.4f} ms, "
               f"{100 * t['fma_bound_ms'] / t['ms']:.1f}%"
               if "fma_bound_ms" in t else "")
        print(f"{k} on {smi}, E={tspec.num_edges} ({fe_real} real), "
              f"N={tspec.num_nodes}, D=100, De=50, {blocks} wgrad slices: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it{fma})")
    split = (f"allocations and weight padding {whole['alloc_ms']:.4f} ms, edge "
             f"kernel {ftimes['fused_cgconv_bwd']['ms']:.4f} ms, wgrad "
             f"{ftimes['fused_cgconv_wgrad']['ms']:.4f} ms, reduce "
             f"{ftimes['fused_cgconv_wgrad_reduce']['ms']:.4f} ms")
    print(f"whole fused CGConv backward (FC.fused_cgconv_bwd, every launch and "
          f"allocation) on {smi}: {whole['bwd_ms']:.4f} ms against its autograd "
          f"yardstick {whole['autograd_ms']:.4f} ms "
          f"({whole['autograd_ms'] / whole['bwd_ms']:.2f}x); bound "
          f"{whole['bound_ms']:.4f} ms ({whole['bound_by']}, "
          f"{100 * whole['bound_ms'] / whole['bwd_ms']:.1f}% of it; at the "
          f"67 TFLOP/s FMA rate {whole['fma_bound_ms']:.4f} ms, "
          f"{100 * whole['fma_bound_ms'] / whole['bwd_ms']:.1f}%); split: "
          f"{split}")
    print(f"fused CGConv forward + whole backward {whole['pair_ms']:.4f} ms "
          f"against the unfused pair on the CSR kernels (forward + autograd "
          f"backward) {whole['unfused_pair_ms']:.4f} ms on {smi}")
    if whole["pair_ms"] >= whole["unfused_pair_ms"]:
        raise AssertionError("the fused CGConv pair is slower than the "
                             "unfused pair, which kernel auto then must pick")
    print(f"cfconv kernel checks on {card} (the same training batch, De=50, "
          f"cutoff 8):")
    err.update(check_cfconv(tbatch, dev))
    stimes, se_real, sblocks, swhole = time_cfconv(tbatch, dev)
    times.update(stimes)
    for k, t in stimes.items():
        fma = (f"; at the 67 TFLOP/s FMA rate {t['fma_bound_ms']:.4f} ms, "
               f"{100 * t['fma_bound_ms'] / t['ms']:.1f}%"
               if "fma_bound_ms" in t else "")
        print(f"{k} on {smi}, E={tspec.num_edges} ({se_real} real), "
              f"N={tspec.num_nodes}, F=150, De=50, {sblocks} wgrad slices: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it{fma})")
    print(f"whole fused cfconv backward (FS.fused_cfconv_bwd, every launch and "
          f"allocation) on {smi}: {swhole['bwd_ms']:.4f} ms against its "
          f"autograd yardstick {swhole['autograd_ms']:.4f} ms "
          f"({swhole['autograd_ms'] / swhole['bwd_ms']:.2f}x); bound "
          f"{swhole['bound_ms']:.4f} ms ({swhole['bound_by']}, "
          f"{100 * swhole['bound_ms'] / swhole['bwd_ms']:.1f}% of it; at the "
          f"67 TFLOP/s FMA rate {swhole['fma_bound_ms']:.4f} ms, "
          f"{100 * swhole['fma_bound_ms'] / swhole['bwd_ms']:.1f}%)")
    print(f"bilinear kernel checks on {card} (the same training batch):")
    err.update(check_bilinear(tbatch, dev))
    btimes, be_real = time_bilinear(tbatch, dev)
    times.update(btimes)
    for k, t in btimes.items():
        fma = (f"; at the 67 TFLOP/s FMA rate {t['fma_bound_ms']:.4f} ms, "
               f"{100 * t['fma_bound_ms'] / t['ms']:.1f}%"
               if "fma_bound_ms" in t else "")
        print(f"{k} on {smi}, E={tspec.num_edges} ({be_real} real), "
              f"D=H=K=100: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, library {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it{fma})")
    del tdata, tbatch

    # ---- windowed kernels at a GCN_demo training batch's layout ----------
    t0 = time.perf_counter()
    layout = windowed_layout(dataset)
    tw, te = layout.tw, layout.te
    print(f"windowed layout of {len(dataset)} structures in "
          f"{time.perf_counter() - t0:.2f} s: tw={tw}, te={te}, "
          f"{int(layout.node_counts_w.sum())} node slots, "
          f"{int(layout.wedge_ptr[-1])} edge slots in {int(layout.tile_ptr[-1])} "
          f"tiles, {100 * float(layout.wvalid.mean()):.1f}% real")
    wspec = BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                  train_bs, align=max(8, tw), align_edges=te)
    wdata = DeviceDataset.from_graph_dataset(
        dataset, dev, windowed=WindowedDeviceData.from_layout(layout, dev))
    wbatch = assemble(wdata, np.arange(train_bs, dtype=np.int32), wspec)
    spec128 = BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                    128, align=max(8, tw), align_edges=te)
    used = int(layout.tile_counts[:train_bs].sum())
    print(f"windowed training spec: B={wspec.num_graphs}, N={wspec.num_nodes}, "
          f"E={wspec.num_edges} ({wspec.num_edges // te} tiles; the first "
          f"batch {int(wbatch.edge_mask.sum())} real edges in {used} tiles, "
          f"{wspec.num_edges // te - used} tail capacity tiles); at batch "
          f"128: N={spec128.num_nodes}, E={spec128.num_edges}")
    pad_ids = np.concatenate([np.arange(train_bs - 10),
                              np.full(10, -1)]).astype(np.int32)
    pbatch = assemble(wdata, pad_ids, wspec)
    rng = np.random.default_rng(12)
    n_r = wspec.num_nodes
    dst_r = np.sort(rng.integers(0, n_r, wspec.num_edges // 2))
    dst_r[(dst_r >= tw) & (dst_r < 2 * tw)] = 0
    mask_r = np.ones(len(dst_r), np.float32)
    mask_r[-500:] = 0
    we_r = WO.windowize_edges(torch.as_tensor(np.sort(dst_r).astype(np.int32),
                                              device=dev),
                              torch.as_tensor(mask_r, device=dev), n_r, tw, te)
    print(f"windowed kernel checks on {card}:")
    err.update(check_windowed(
        [("GCN_demo layout, 10 pad graph slots", batch_edges(pbatch),
          wspec.num_nodes, tw),
         ("windowize_edges, an empty window", we_r, n_r, tw)], dev))
    wtimes, we_real = time_windowed(wbatch, dev)
    times.update(wtimes)
    for k, t in wtimes.items():
        print(f"{k} on {smi}, E={wspec.num_edges} ({we_real} real), "
              f"N={wspec.num_nodes}, tw={tw}, te={te}, D={t['d']}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    del wdata, wbatch, pbatch

    # ---- main path 1: Predict on the card, then on the CPU ----------------
    os.chdir(WORK)
    gpu_cfg = predict_config(data_dir, model_path, "chip_gpu", "cuda")
    all_counts = (csr.LAUNCHES, FC.LAUNCHES, FS.LAUNCHES, FB.LAUNCHES,
                  WO.LAUNCHES)
    reset_launches(*all_counts)
    cold_wall, cold_eval = run_predict(gpu_cfg)
    launches = dict(csr.LAUNCHES)
    print(f"launches in one Predict: {launches}")
    for k, v in launches.items():
        if v < 4 * steps:
            raise AssertionError(f"{k} launched {v} times, expected >= {4 * steps}")
    print(f"Predict on {smi}, cold: {cold_wall:.4f} s wall, {cold_eval:.5f} s "
          f"evaluation")
    for i in range(3):
        warm_wall, warm_eval = run_predict(gpu_cfg)
        print(f"Predict on {smi}, warm run {i + 1}: {warm_wall:.4f} s wall, "
              f"{warm_eval:.5f} s evaluation ({len(dataset) / warm_eval:.1f} "
              f"graphs/s)")
    profile_predict(gpu_cfg)
    cpu_wall, _ = run_predict(
        predict_config(data_dir, model_path, "chip_cpu", "cpu"))
    print(f"Predict on the CPU (plain versions): {cpu_wall:.3f} s wall")
    ids_g, pred_g = read_predictions("chip_gpu_predicted_outputs.csv")
    ids_c, pred_c = read_predictions("chip_cpu_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"expected {N_STRUCTURES} finite predictions")
    if ids_g != ids_c:
        raise AssertionError("card and CPU predictions list different ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    print(f"card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- main path 2: Training on the card, then on the CPU ---------------
    def resume_from_init(name, init=model_path):
        path = os.path.join(WORK, f"{name}.ckpt")
        shutil.copy(init, path)
        return path

    n_train = int(len(dataset) * TRAINING["train_ratio"])
    train_steps = -(-n_train // train_bs)
    gpu_train = resume_from_init("train_gpu")
    reset_launches(*all_counts)
    wall, card_rows = run_training(training_config(
        data_dir, gpu_train, "chip_train_gpu", "cuda", EPOCHS_CARD))
    train_launches = dict(FC.LAUNCHES)
    print(f"launches in one Training run of {EPOCHS_CARD} epochs: "
          f"{train_launches}; CSR {dict(csr.LAUNCHES)}")
    need = 4 * train_steps * EPOCHS_CARD
    for k, v in train_launches.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times, expected >= {need}")
    warm = warm_epoch_s(card_rows)
    print(f"Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} epochs; "
          f"epoch 1 (cold) {card_rows[0][4]:.5f} s, warm epochs "
          f"{warm:.5f} s on average ({n_train / warm:.1f} train graphs/s)")
    cpu_train = resume_from_init("train_cpu")
    cpu_wall, cpu_rows = run_training(training_config(
        data_dir, cpu_train, "chip_train_cpu", "cpu", EPOCHS_CPU, "fused"))
    print(f"Training on the CPU (plain versions): {cpu_wall:.3f} s wall for "
          f"{EPOCHS_CPU} epochs")
    np.testing.assert_allclose(card_rows[0][2], cpu_rows[0][2], rtol=1e-3)
    if not card_rows[-1][2] < card_rows[0][2]:
        raise AssertionError(f"the card's train error did not fall: "
                             f"{card_rows[0][2]} -> {card_rows[-1][2]}")
    print(f"card vs CPU: epoch 1 train error {card_rows[0][2]:.5f} vs "
          f"{cpu_rows[0][2]:.5f} (rtol 1e-3); epoch 2 {card_rows[1][2]:.5f} "
          f"vs {cpu_rows[1][2]:.5f}; the card's train error "
          f"{card_rows[0][2]:.5f} -> {card_rows[-1][2]:.5f}")
    run_predict(predict_config(data_dir, gpu_train, "chip_trained", "cuda"))
    _, pred_t = read_predictions("chip_trained_predicted_outputs.csv")
    if len(pred_t) != N_STRUCTURES or not np.isfinite(pred_t).all():
        raise AssertionError(f"Predict from the trained checkpoint: expected "
                             f"{N_STRUCTURES} finite predictions")
    print(f"Predict from the checkpoint Training saved: {len(pred_t)} finite "
          f"predictions")

    # ---- kernels csr, fused and pallas, then a profiled warm epoch --------
    ab = {}
    for kernel in ("csr", "fused", "pallas"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"train_{kernel}"), f"chip_ab_{kernel}",
            "cuda", EPOCHS_AB, kernel))
        ab[kernel] = warm_epoch_s(rows)
    print(f"warm epoch on {smi}: kernel csr {ab['csr']:.5f} s, kernel fused "
          f"{ab['fused']:.5f} s, kernel pallas {ab['pallas']:.5f} s (main "
          f"path: {warm:.5f} s)")
    profile_training(dataset, dev)
    profile_training(dataset, dev, kernel="csr")

    # ---- main path 3: SchNet_demo Training on the card, then the CPU ------
    gpu_schnet = resume_from_init("schnet_gpu", schnet_path)
    reset_launches(*all_counts)
    wall, s_rows = run_training(training_config(
        data_dir, gpu_schnet, "chip_schnet_gpu", "cuda", EPOCHS_CARD,
        model=SCHNET_DEMO))
    schnet_launches = dict(FS.LAUNCHES)
    print(f"launches in one SchNet Training run of {EPOCHS_CARD} epochs: "
          f"{schnet_launches}; CSR {dict(csr.LAUNCHES)}; fused CGConv "
          f"{dict(FC.LAUNCHES)}")
    for k, v in schnet_launches.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times, expected >= {need}")
    s_warm = warm_epoch_s(s_rows)
    print(f"SchNet Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} "
          f"epochs; epoch 1 (cold) {s_rows[0][4]:.5f} s, warm epochs "
          f"{s_warm:.5f} s on average ({n_train / s_warm:.1f} train graphs/s)")
    cpu_wall, s_cpu_rows = run_training(training_config(
        data_dir, resume_from_init("schnet_cpu", schnet_path), "chip_schnet_cpu",
        "cpu", EPOCHS_CPU, "fused", model=SCHNET_DEMO))
    print(f"SchNet Training on the CPU (plain versions): {cpu_wall:.3f} s wall "
          f"for {EPOCHS_CPU} epochs")
    np.testing.assert_allclose(s_rows[0][2], s_cpu_rows[0][2], rtol=1e-3)
    if not s_rows[-1][2] < s_rows[0][2]:
        raise AssertionError(f"the card's SchNet train error did not fall: "
                             f"{s_rows[0][2]} -> {s_rows[-1][2]}")
    print(f"SchNet card vs CPU: epoch 1 train error {s_rows[0][2]:.5f} vs "
          f"{s_cpu_rows[0][2]:.5f} (rtol 1e-3); epoch 2 {s_rows[1][2]:.5f} vs "
          f"{s_cpu_rows[1][2]:.5f}; the card's train error "
          f"{s_rows[0][2]:.5f} -> {s_rows[-1][2]:.5f}")

    # ---- main path 4: SchNet_demo Predict on the card, then the CPU -------
    reset_launches(*all_counts)
    s_wall, s_eval = run_predict(predict_config(data_dir, gpu_schnet,
                                                "chip_schnet_predict", "cuda"))
    s_predict_launches = dict(csr.LAUNCHES)
    print(f"launches in one SchNet Predict: {s_predict_launches}")
    if s_predict_launches["segment_sum"] < 4 * steps:
        raise AssertionError(f"segment_sum launched "
                             f"{s_predict_launches['segment_sum']} times in "
                             f"SchNet Predict, expected >= {4 * steps}")
    s_warm_wall, s_warm_eval = run_predict(predict_config(
        data_dir, gpu_schnet, "chip_schnet_predict", "cuda"))
    print(f"SchNet Predict on {smi}: cold {s_wall:.4f} s wall, {s_eval:.5f} s "
          f"evaluation; warm {s_warm_wall:.4f} s wall, {s_warm_eval:.5f} s "
          f"evaluation ({len(dataset) / s_warm_eval:.1f} graphs/s)")
    profile_predict(predict_config(data_dir, gpu_schnet, "chip_schnet_predict",
                                   "cuda"), "SchNet")
    run_predict(predict_config(data_dir, gpu_schnet, "chip_schnet_predict_cpu",
                               "cpu"))
    ids_g, pred_g = read_predictions("chip_schnet_predict_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_schnet_predict_cpu_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"SchNet Predict: expected {N_STRUCTURES} finite "
                             f"predictions")
    if ids_g != ids_c:
        raise AssertionError("SchNet card and CPU predictions list different ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    print(f"SchNet card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- SchNet: kernel csr against kernel fused, then a profiled epoch ---
    s_ab = {}
    for kernel in ("csr", "fused"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"schnet_{kernel}", schnet_path),
            f"chip_schnet_ab_{kernel}", "cuda", EPOCHS_AB, kernel,
            model=SCHNET_DEMO))
        s_ab[kernel] = warm_epoch_s(rows)
    print(f"SchNet warm epoch on {smi}: kernel csr {s_ab['csr']:.5f} s, kernel "
          f"fused {s_ab['fused']:.5f} s (main path: {s_warm:.5f} s)")
    profile_training(dataset, dev, SCHNET_DEMO)

    # ---- main path 5: MPNN_demo Training on the card, then the CPU --------
    gpu_mpnn = resume_from_init("mpnn_gpu", mpnn_path)
    reset_launches(*all_counts)
    wall, m_rows = run_training(training_config(
        data_dir, gpu_mpnn, "chip_mpnn_gpu", "cuda", EPOCHS_CARD,
        model=MPNN_DEMO))
    mpnn_launches = dict(FB.LAUNCHES)
    mpnn_csr = dict(csr.LAUNCHES)
    print(f"launches in one MPNN Training run of {EPOCHS_CARD} epochs: "
          f"{mpnn_launches}; CSR {mpnn_csr}; fused CGConv {dict(FC.LAUNCHES)}; "
          f"cfconv {dict(FS.LAUNCHES)}")
    for k, v in {**mpnn_launches, **mpnn_csr}.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times in MPNN Training, "
                                 f"expected >= {need}")
    m_warm = warm_epoch_s(m_rows)
    print(f"MPNN Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} "
          f"epochs; epoch 1 (cold) {m_rows[0][4]:.5f} s, warm epochs "
          f"{m_warm:.5f} s on average ({n_train / m_warm:.1f} train graphs/s)")
    if not m_rows[-1][2] < m_rows[0][2]:
        raise AssertionError(f"the card's MPNN train error did not fall: "
                             f"{m_rows[0][2]} -> {m_rows[-1][2]}")
    # card against CPU, on the first structures only (PERF.md: one plain
    # MPNN epoch over all 1,000 took 107 s on the card's host)
    sub_dir = os.path.join(WORK, f"data_first{N_COMPARE_MPNN}")
    write_structures(sub_dir, n=N_COMPARE_MPNN)
    sub = {}
    for where in ("cuda", "cpu"):
        sub_wall, sub[where] = run_training(training_config(
            sub_dir, resume_from_init(f"mpnn_first_{where}", mpnn_path),
            f"chip_mpnn_first_{where}", where, EPOCHS_CPU_MPNN, "fused",
            model=MPNN_DEMO))
        print(f"MPNN Training on the first {N_COMPARE_MPNN} structures, "
              f"{'the card' if where == 'cuda' else 'the CPU (plain versions)'}"
              f": {sub_wall:.3f} s wall, the epoch {sub[where][0][4]:.3f} s")
    np.testing.assert_allclose(sub["cuda"][0][2], sub["cpu"][0][2], rtol=1e-3)
    print(f"MPNN card vs CPU on the first {N_COMPARE_MPNN} structures: epoch 1 "
          f"train error {sub['cuda'][0][2]:.5f} vs {sub['cpu'][0][2]:.5f} "
          f"(rtol 1e-3); on all {N_STRUCTURES}, the card's train error "
          f"{m_rows[0][2]:.5f} -> {m_rows[-1][2]:.5f}")

    # ---- main path 6: MPNN_demo Predict on the card, then the CPU ---------
    reset_launches(*all_counts)
    m_wall, m_eval = run_predict(predict_config(data_dir, gpu_mpnn,
                                                "chip_mpnn_predict", "cuda"))
    m_predict_launches = {**FB.LAUNCHES, **csr.LAUNCHES}
    print(f"launches in one MPNN Predict: {m_predict_launches}")
    for k in ("fused_bilinear_fwd", "segment_sum"):
        if m_predict_launches[k] < 4 * steps:
            raise AssertionError(f"{k} launched {m_predict_launches[k]} times "
                                 f"in MPNN Predict, expected >= {4 * steps}")
    m_warm_wall, m_warm_eval = run_predict(predict_config(
        data_dir, gpu_mpnn, "chip_mpnn_predict", "cuda"))
    print(f"MPNN Predict on {smi}: cold {m_wall:.4f} s wall, {m_eval:.5f} s "
          f"evaluation; warm {m_warm_wall:.4f} s wall, {m_warm_eval:.5f} s "
          f"evaluation ({len(dataset) / m_warm_eval:.1f} graphs/s)")
    profile_predict(predict_config(data_dir, gpu_mpnn, "chip_mpnn_predict",
                                   "cuda"), "MPNN")
    m_cpu_wall, _ = run_predict(predict_config(
        data_dir, gpu_mpnn, "chip_mpnn_predict_cpu", "cpu"))
    print(f"MPNN Predict on the CPU (plain versions): {m_cpu_wall:.3f} s wall")
    ids_g, pred_g = read_predictions("chip_mpnn_predict_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_mpnn_predict_cpu_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"MPNN Predict: expected {N_STRUCTURES} finite "
                             f"predictions")
    if ids_g != ids_c:
        raise AssertionError("MPNN card and CPU predictions list different ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    print(f"MPNN card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- MPNN: kernel xla against kernel fused, then a profiled epoch -----
    m_ab = {}
    for kernel in ("xla", "fused"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"mpnn_{kernel}", mpnn_path),
            f"chip_mpnn_ab_{kernel}", "cuda", EPOCHS_AB, kernel,
            model=MPNN_DEMO))
        m_ab[kernel] = warm_epoch_s(rows)
    print(f"MPNN warm epoch on {smi}: kernel xla (einsum) {m_ab['xla']:.5f} s, "
          f"kernel fused {m_ab['fused']:.5f} s (main path: {m_warm:.5f} s)")
    profile_training(dataset, dev, MPNN_DEMO)

    # ---- main path 7: GCN_demo Training (kernel pallas), card then CPU ----
    gpu_gcn = resume_from_init("gcn_gpu", gcn_path)
    reset_launches(*all_counts)
    wall, g_rows = run_training(training_config(
        data_dir, gpu_gcn, "chip_gcn_gpu", "cuda", EPOCHS_CARD, "pallas",
        model=GCN_DEMO))
    gcn_launches = dict(WO.LAUNCHES)
    print(f"launches in one GCN Training run of {EPOCHS_CARD} epochs (kernel "
          f"pallas): {gcn_launches}; CSR {dict(csr.LAUNCHES)}")
    for k, v in gcn_launches.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times in GCN Training, "
                                 f"expected >= {need}")
    g_warm = warm_epoch_s(g_rows)
    print(f"GCN Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} "
          f"epochs; epoch 1 (cold) {g_rows[0][4]:.5f} s, warm epochs "
          f"{g_warm:.5f} s on average ({n_train / g_warm:.1f} train graphs/s)")
    cpu_wall, g_cpu_rows = run_training(training_config(
        data_dir, resume_from_init("gcn_cpu", gcn_path), "chip_gcn_cpu", "cpu",
        EPOCHS_CPU, "pallas", model=GCN_DEMO))
    print(f"GCN Training on the CPU (plain versions): {cpu_wall:.3f} s wall "
          f"for {EPOCHS_CPU} epochs")
    np.testing.assert_allclose(g_rows[0][2], g_cpu_rows[0][2], rtol=1e-3)
    if not g_rows[-1][2] < g_rows[0][2]:
        raise AssertionError(f"the card's GCN train error did not fall: "
                             f"{g_rows[0][2]} -> {g_rows[-1][2]}")
    print(f"GCN card vs CPU: epoch 1 train error {g_rows[0][2]:.5f} vs "
          f"{g_cpu_rows[0][2]:.5f} (rtol 1e-3); epoch 2 {g_rows[1][2]:.5f} vs "
          f"{g_cpu_rows[1][2]:.5f}; the card's train error "
          f"{g_rows[0][2]:.5f} -> {g_rows[-1][2]:.5f}")

    # ---- main path 8: GCN_demo Predict on the card, then the CPU ----------
    reset_launches(*all_counts)
    g_wall, g_eval = run_predict(predict_config(data_dir, gpu_gcn,
                                                "chip_gcn_predict", "cuda"))
    g_predict_launches = dict(csr.LAUNCHES)
    print(f"launches in one GCN Predict: {g_predict_launches}; windowed "
          f"{dict(WO.LAUNCHES)}")
    if g_predict_launches["segment_sum"] < 2 * 4 * steps:
        raise AssertionError(f"segment_sum launched "
                             f"{g_predict_launches['segment_sum']} times in "
                             f"GCN Predict, expected >= {2 * 4 * steps}")
    g_warm_wall, g_warm_eval = run_predict(predict_config(
        data_dir, gpu_gcn, "chip_gcn_predict", "cuda"))
    print(f"GCN Predict on {smi}: cold {g_wall:.4f} s wall, {g_eval:.5f} s "
          f"evaluation; warm {g_warm_wall:.4f} s wall, {g_warm_eval:.5f} s "
          f"evaluation ({len(dataset) / g_warm_eval:.1f} graphs/s)")
    profile_predict(predict_config(data_dir, gpu_gcn, "chip_gcn_predict",
                                   "cuda"), "GCN")
    g_cpu_wall, _ = run_predict(predict_config(
        data_dir, gpu_gcn, "chip_gcn_predict_cpu", "cpu"))
    print(f"GCN Predict on the CPU (plain versions): {g_cpu_wall:.3f} s wall")
    ids_g, pred_g = read_predictions("chip_gcn_predict_predicted_outputs.csv")
    ids_c, pred_c = read_predictions("chip_gcn_predict_cpu_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"GCN Predict: expected {N_STRUCTURES} finite "
                             f"predictions")
    if ids_g != ids_c:
        raise AssertionError("GCN card and CPU predictions list different ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    print(f"GCN card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- GCN: kernels xla, csr and pallas, then a profiled pallas epoch ---
    g_ab = {}
    for kernel in ("xla", "csr", "pallas"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"gcn_{kernel}", gcn_path),
            f"chip_gcn_ab_{kernel}", "cuda", EPOCHS_AB, kernel,
            model=GCN_DEMO))
        g_ab[kernel] = warm_epoch_s(rows)
    print(f"GCN warm epoch on {smi}: kernel xla {g_ab['xla']:.5f} s, kernel "
          f"csr {g_ab['csr']:.5f} s, kernel pallas {g_ab['pallas']:.5f} s "
          f"(main path: {g_warm:.5f} s)")
    profile_training(dataset, dev, GCN_DEMO, kernel="pallas")

    kernels = []
    for key, name, src, line, count in (
            ("segment_sum", "csr_segment_sum", "csr.cu", "pallas_csr.py:135",
             launches["segment_sum"]),
            ("gather", "csr_gather", "csr.cu", "pallas_csr.py:159",
             launches["gather"]),
            ("fused_cgconv_fwd", "fused_cgconv_fwd", "fused_cgconv.cu",
             "pallas_fused.py:112", train_launches["fused_cgconv_fwd"]),
            ("fused_cgconv_bwd", "fused_cgconv_bwd", "fused_cgconv.cu",
             "pallas_fused.py:137", train_launches["fused_cgconv_bwd"]),
            ("fused_cgconv_wgrad", "fused_cgconv_wgrad", "fused_cgconv.cu",
             "pallas_fused.py:137", train_launches["fused_cgconv_wgrad"]),
            ("fused_cgconv_wgrad_reduce", "fused_cgconv_wgrad_reduce",
             "fused_cgconv.cu", "pallas_fused.py:137",
             train_launches["fused_cgconv_wgrad_reduce"]),
            ("fused_cfconv_fwd", "fused_cfconv_fwd", "fused_cfconv.cu",
             "pallas_fused_schnet.py:66", schnet_launches["fused_cfconv_fwd"]),
            ("fused_cfconv_bwd", "fused_cfconv_bwd", "fused_cfconv.cu",
             "pallas_fused_schnet.py:86", schnet_launches["fused_cfconv_bwd"]),
            ("fused_cfconv_wgrad", "fused_cfconv_wgrad", "fused_cfconv.cu",
             "pallas_fused_schnet.py:86", schnet_launches["fused_cfconv_wgrad"]),
            ("fused_cfconv_wgrad_reduce", "fused_cfconv_wgrad_reduce",
             "fused_cfconv.cu", "pallas_fused_schnet.py:86",
             schnet_launches["fused_cfconv_wgrad_reduce"]),
            ("fused_bilinear_fwd", "fused_bilinear_fwd", "fused_bilinear.cu",
             "pallas_bilinear.py:63, :235", mpnn_launches["fused_bilinear_fwd"]),
            ("fused_bilinear_bwd", "fused_bilinear_bwd", "fused_bilinear.cu",
             "pallas_bilinear.py:83, :134", mpnn_launches["fused_bilinear_bwd"]),
            ("fused_bilinear_wgrad", "fused_bilinear_wgrad", "fused_bilinear.cu",
             "pallas_bilinear.py:83, :134",
             mpnn_launches["fused_bilinear_wgrad"]),
            ("windowed_segment_sum", "windowed_segment_sum", "windowed.cu",
             "pallas_segment.py:144", gcn_launches["windowed_segment_sum"]),
            ("windowed_spmm", "windowed_spmm", "windowed.cu",
             "pallas_segment.py:174", gcn_launches["windowed_spmm"]),
            ("windowed_gather", "windowed_gather", "windowed.cu",
             "pallas_segment.py:209", gcn_launches["windowed_gather"])):
        t = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"matdeeplearn_torch/csrc/{src}",
            "replaces": f"matdeeplearn_tpu/ops/{line}",
            "launches": count, "max_abs_err": err[key],
            "check": "pass", "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
