"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100. It:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the build time of every kernel (all csrc/*.cu, one nvcc
   each, in parallel), and turns TF32 off;
2. writes 1,000 periodic structures (8-64 atoms, cubic cells of 16 Å^3 per
   atom, numpy seed 0) and featurizes them with config.yml's Processing
   values; builds CGCNN_demo and SchNet_demo at full width from
   torch.Generator seed 0, with non-trivial BatchNorm running statistics,
   and saves each with the port's checkpoint;
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
   d_x, d_xj, the six weight blocks and two biases, and the partial-sum
   reduction, to rtol 1e-4 and atol 1e-4·max|ref|; then times them beside
   their bound (operations over 67 TFLOP/s f32, or bytes) and the unfused
   composition PR 1's CGConv runs (concat + 2 F.linear + activations +
   csr.segment_sum, and its autograd backward) as the library yardstick;
   then the same for the fused SchNet cfconv kernels (F 150, 3 and 100,
   cutoff 8: output, d_xj, the four filter gradients, zero d_xj on masked
   edges, the reduction; the yardstick is the unfused SchNet composition:
   basis, 2 F.linear with shifted softplus, cutoff, index_select,
   csr.segment_sum, and its autograd backward);
6. runs Predict through cli.run on the card with the launch counters reset
   just before and read just after (each CSR kernel >= 32: 8 batches x 4
   CGConv layers), then the same Predict on the CPU (plain versions, same
   checkpoint), and requires 1,000 finite predictions that agree to
   rtol 1e-4, atol 1e-4;
7. trains CGCNN_demo through cli.run on the card (--run_mode=Training,
   kernel auto, 5 epochs, verbosity 1, from that checkpoint) with the
   launch counters reset just before and read just after: each fused
   kernel must launch at least 4 layers x 8 steps x 5 epochs times; then
   2 epochs of the same on the CPU (plain versions): the first epoch's
   train error agrees to rtol 1e-3, every error is finite, and the card's
   last train error is below its first; Predict on the card from the
   checkpoint Training saved gives 1,000 finite predictions;
8. trains 3 epochs under kernel csr and 3 more under kernel fused, and
   prints the warm epoch time of each; profiles one warm training epoch
   (device busy share, top kernels);
9. does 7 for SchNet_demo (each cfconv kernel >= 4 x 8 x 5 launches), then
   SchNet Predict on the card from the checkpoint Training saved (counters
   reset just before: csr_segment_sum >= 4 x 8 launches; 1,000 finite
   predictions that agree with the CPU Predict of that checkpoint to rtol
   1e-4, atol 1e-4; one more profiled), then does 8 for SchNet_demo;
10. prints a {"kernels": [...]} line, the nvidia-smi line and, last,
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
    (CGCNN_demo or SchNet_demo), resuming from `model_path` (load_model
    True), with this run's epochs, kernel, device and verbosity 1."""
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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    f32 operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
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
    returns the largest |kernel - plain| of each kernel."""
    from matdeeplearn_torch.ops import fused_cgconv as FC

    g = torch.Generator(device=dev).manual_seed(3)
    dst, mask, dist, n = (batch.edge_dst, batch.edge_mask,
                          batch.edge_dist_norm, batch.num_nodes)
    e = dst.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {"fused_cgconv_fwd": 0.0, "fused_cgconv_bwd": 0.0,
           "fused_cgconv_wgrad_reduce": 0.0}
    for d in (100, 3, 150):
        x, xj, ws = fused_inputs(batch, d, de, g, dev)
        cot = torch.randn(n, d, device=dev, generator=g)
        cases = [("sorted dst, tail pads", xj, dist, dst, mask),
                 ("permuted dst", xj[perm].contiguous(), dist[perm].contiguous(),
                  dst[perm].contiguous(), mask[perm].contiguous()),
                 ("scattered mask", xj, dist, dst, scattered)]
        for name, xjv, dv, dsv, mv in cases:
            args = (x, xjv, dv, dsv, mv, *ws, n, 0.2)
            fwd = assert_fused(FC.fused_cgconv(*args), FC.fused_cgconv_plain(*args),
                               f"fused forward, D={d}, {name}")
            got = FC.fused_cgconv_bwd(cot, *args)
            refs = FC.fused_cgconv_bwd_plain(cot, *args)
            bwd = max(assert_fused(a, b, f"fused d_{k}, D={d}, {name}")
                      for k, a, b in zip(FUSED_GRADS, got, refs))
            if float(got[1][mv == 0].abs().max()) != 0.0:
                raise AssertionError(f"fused, D={d}, {name}: pad edges got "
                                     "non-zero d_xj rows")
            err["fused_cgconv_fwd"] = max(err["fused_cgconv_fwd"], fwd)
            err["fused_cgconv_bwd"] = max(err["fused_cgconv_bwd"], bwd)
            print(f"  fused kernel check ok: D={d}, {name}: forward max |diff| "
                  f"{fwd:.3e}, backward (10 gradients) max |diff| {bwd:.3e}")
        _, _, partial, blocks = FC.fused_cgconv_bwd_partials(cot, *args)
        red = assert_fused(FC.wgrad_reduce(partial, blocks, d, de),
                           FC.wgrad_reduce_plain(partial, d, de),
                           f"wgrad_reduce, D={d}")
        err["fused_cgconv_wgrad_reduce"] = max(err["fused_cgconv_wgrad_reduce"],
                                               red)
        print(f"  fused kernel check ok: D={d}, wgrad_reduce over {blocks} "
              f"blocks max |diff| {red:.3e}")
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
    _, _, partial, blocks = FC.fused_cgconv_bwd_partials(cot, *args)
    pfloats = partial.numel()
    res = {
        "fused_cgconv_fwd": {
            "ms": device_ms(lambda: FC.fused_cgconv(*args)),
            "plain_ms": device_ms(lambda: FC.fused_cgconv_plain(*args)),
            "library_ms": device_ms(lambda: unfused(*leaves)),
            **bound(4 * (2 * n * d + e_real * d + 3 * e + k1 * nb),
                    2 * e_real * k * nb),
        },
        # the backward kernel leaves per-block partial weight gradients;
        # its bound counts the (2D+De+1, 2D) weight gradient as its output
        "fused_cgconv_bwd": {
            "ms": device_ms(lambda: FC.fused_cgconv_bwd_partials(cot, *args)),
            "plain_ms": device_ms(lambda: FC.fused_cgconv_bwd_plain(cot, *args)),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True)),
            **bound(4 * (3 * n * d + e_real * d + e * d + 3 * e + 2 * k1 * nb),
                    2 * e_real * (k * nb + nb * nb + k1 * nb)),
        },
        "fused_cgconv_wgrad_reduce": {
            "ms": device_ms(lambda: FC.wgrad_reduce(partial, blocks, d, de)),
            "plain_ms": device_ms(lambda: FC.wgrad_reduce_plain(partial, d, de)),
            "library_ms": device_ms(lambda: partial.view(blocks, -1).sum(0)),
            **bound(4 * (pfloats + k1 * nb), pfloats),
        },
    }
    return res, e_real, blocks


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
    returns the largest |kernel - plain| of each kernel."""
    from matdeeplearn_torch.ops import fused_cfconv as FS

    g = torch.Generator(device=dev).manual_seed(5)
    dst, mask, n = batch.edge_dst, batch.edge_mask, batch.num_nodes
    dist, wraw = batch.edge_dist_norm, batch.edge_weight
    e = dst.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {k: 0.0 for k in FS.LAUNCHES}
    for f in (150, 3, 100):
        _, xj, ws = cfconv_inputs(batch, f, de, g, dev)
        cot = torch.randn(n, f, device=dev, generator=g)
        p = lambda t: t[perm].contiguous()
        cases = [("sorted dst, tail pads", xj, dist, wraw, dst, mask),
                 ("permuted dst", p(xj), p(dist), p(wraw), p(dst), p(mask)),
                 ("scattered mask", xj, dist, wraw, dst, scattered)]
        for name, *edges in cases:
            args = (*edges, *ws, n, 0.2, cutoff)
            fwd = assert_fused(FS.fused_cfconv(*args), FS.fused_cfconv_plain(*args),
                               f"cfconv forward, F={f}, {name}")
            got = FS.fused_cfconv_bwd(cot, *args)
            refs = FS.fused_cfconv_bwd_plain(cot, *args)
            bwd = max(assert_fused(a, b, f"cfconv d_{k}, F={f}, {name}")
                      for k, a, b in zip(CFCONV_GRADS, got, refs))
            if float(got[0][edges[4] == 0].abs().max()) != 0.0:
                raise AssertionError(f"cfconv, F={f}, {name}: masked edges got "
                                     "non-zero d_xj rows")
            err["fused_cfconv_fwd"] = max(err["fused_cfconv_fwd"], fwd)
            err["fused_cfconv_bwd"] = max(err["fused_cfconv_bwd"], bwd)
            print(f"  cfconv kernel check ok: F={f}, {name}: forward max |diff| "
                  f"{fwd:.3e}, backward (5 gradients) max |diff| {bwd:.3e}")
        _, partial, blocks = FS.fused_cfconv_bwd_partials(cot, *args)
        red = assert_fused(FS.wgrad_reduce(partial, blocks, f, de),
                           FS.wgrad_reduce_plain(partial, f, de),
                           f"cfconv wgrad_reduce, F={f}")
        err["fused_cfconv_wgrad_reduce"] = max(
            err["fused_cfconv_wgrad_reduce"], red)
        print(f"  cfconv kernel check ok: F={f}, wgrad_reduce over {blocks} "
              f"blocks max |diff| {red:.3e}")
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
    _, partial, blocks = FS.fused_cfconv_bwd_partials(cot, *args)
    pfloats = partial.numel()
    weights = (de + 1) * f + (f + 1) * f
    res = {
        "fused_cfconv_fwd": {
            "ms": device_ms(lambda: FS.fused_cfconv(*args)),
            "plain_ms": device_ms(lambda: FS.fused_cfconv_plain(*args)),
            "library_ms": device_ms(lambda: unfused(*leaves)),
            **bound(4 * (n * f + e_real * f + 4 * e + weights),
                    2 * e_real * (de * f + f * f)),
        },
        # the backward kernel leaves per-block partial weight gradients;
        # its bound counts the four weight gradients as its output
        "fused_cfconv_bwd": {
            "ms": device_ms(lambda: FS.fused_cfconv_bwd_partials(cot, *args)),
            "plain_ms": device_ms(lambda: FS.fused_cfconv_bwd_plain(cot, *args)),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True)),
            **bound(4 * (n * f + e_real * f + e * f + 4 * e + 2 * weights),
                    2 * e_real * (2 * de * f + 3 * f * f)),
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
    return res, e_real, blocks


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


def profile_training(dataset, dev, model: dict = CGCNN_DEMO, top: int = 14):
    """One warm training epoch of `model` (kernel fused) under
    torch.profiler: device time by kernel and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.training import jobs

    train_idx, val_idx, _ = split_data(dataset, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    run = jobs.setup_run(dataset, {**model, "kernel": "fused"},
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
    print(f"profiled warm {model['model']} training epoch: device busy "
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
                                                  assemble_batch)
    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.models import MODEL_FIELDS, build_model
    from matdeeplearn_torch.ops import _build, csr
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops import fused_cgconv as FC
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
    ftimes, fe_real, blocks = time_fused(tbatch, dev)
    times.update(ftimes)
    for k, t in ftimes.items():
        print(f"{k} on {smi}, E={tspec.num_edges} ({fe_real} real), "
              f"N={tspec.num_nodes}, D=100, De=50, {blocks} backward blocks: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    print(f"cfconv kernel checks on {card} (the same training batch, De=50, "
          f"cutoff 8):")
    err.update(check_cfconv(tbatch, dev))
    stimes, se_real, sblocks = time_cfconv(tbatch, dev)
    times.update(stimes)
    for k, t in stimes.items():
        print(f"{k} on {smi}, E={tspec.num_edges} ({se_real} real), "
              f"N={tspec.num_nodes}, F=150, De=50, {sblocks} backward blocks: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    del tdata, tbatch

    # ---- main path 1: Predict on the card, then on the CPU ----------------
    os.chdir(WORK)
    gpu_cfg = predict_config(data_dir, model_path, "chip_gpu", "cuda")
    for k in csr.LAUNCHES:
        csr.LAUNCHES[k] = 0
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
    for counts in (csr.LAUNCHES, FC.LAUNCHES):
        for k in counts:
            counts[k] = 0
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

    # ---- kernel csr against kernel fused, then a profiled warm epoch ------
    ab = {}
    for kernel in ("csr", "fused"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"train_{kernel}"), f"chip_ab_{kernel}",
            "cuda", EPOCHS_AB, kernel))
        ab[kernel] = warm_epoch_s(rows)
    print(f"warm epoch on {smi}: kernel csr {ab['csr']:.5f} s, kernel fused "
          f"{ab['fused']:.5f} s (main path: {warm:.5f} s)")
    profile_training(dataset, dev)

    # ---- main path 3: SchNet_demo Training on the card, then the CPU ------
    gpu_schnet = resume_from_init("schnet_gpu", schnet_path)
    for counts in (csr.LAUNCHES, FC.LAUNCHES, FS.LAUNCHES):
        for k in counts:
            counts[k] = 0
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
    for k in csr.LAUNCHES:
        csr.LAUNCHES[k] = 0
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
            ("fused_cgconv_wgrad_reduce", "fused_cgconv_wgrad_reduce",
             "fused_cgconv.cu", "pallas_fused.py:137",
             train_launches["fused_cgconv_wgrad_reduce"]),
            ("fused_cfconv_fwd", "fused_cfconv_fwd", "fused_cfconv.cu",
             "pallas_fused_schnet.py:66", schnet_launches["fused_cfconv_fwd"]),
            ("fused_cfconv_bwd", "fused_cfconv_bwd", "fused_cfconv.cu",
             "pallas_fused_schnet.py:86", schnet_launches["fused_cfconv_bwd"]),
            ("fused_cfconv_wgrad_reduce", "fused_cfconv_wgrad_reduce",
             "fused_cfconv.cu", "pallas_fused_schnet.py:86",
             schnet_launches["fused_cfconv_wgrad_reduce"])):
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
