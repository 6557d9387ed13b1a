"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100. It:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the build time of every kernel (all csrc/*.cu, one nvcc
   each, in parallel), and turns TF32 off;
2. writes 1,000 periodic structures (8-64 atoms, cubic cells of 16 Å^3 per
   atom, numpy seed 0) and featurizes them with config.yml's Processing
   values; builds CGCNN_demo, SchNet_demo, MPNN_demo, GCN_demo and
   MEGNet_demo at full width from torch.Generator seed 0, with non-trivial
   BatchNorm running statistics, and saves each with the port's checkpoint;
3. checks each CSR kernel against its plain PyTorch version on the card, at
   the shapes of a Predict batch (sorted dst with tail pads, permuted dst,
   scattered mask, D in {1, 3, 150}, one gradient of each autograd pair):
   gather bit-exact, sum to rtol 1e-5 and atol 1e-5·max|ref| (atomics
   reorder the additions); then the same at MEGNet_demo's calls on a
   src-sorted training batch (D 100): edge_src with its tail pads into the
   nodes, and node_graph[edge_src] into the 100 graph rows, the sum
   bit-identical between two calls (sorted runs, one owner each);
4. times each CSR kernel, its plain version and a library yardstick
   (index_add_ / index_select, which the port never calls on the card) with
   CUDA events, beside the memory bound (bytes over 3.35 TB/s), at the
   Predict batch and at both src-sorted shapes;
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
   sum; times beside their bounds, the forward and the backward's edge
   rows and weight gradient at the 3xTF32 rate with the FMA rate's
   beside; the yardstick
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
6b. checks the bilinear kernels' bf16 arm (`precision: bf16`: operands
   rounded to bf16, f32 accumulation; csrc/fused_bilinear_bf16.cu: the
   forward, d_xj on the forward's tiles over W1ᵀ, d_a, the weight
   gradient) against its plain versions on the same batch, at (100, 100,
   100) sorted, permuted and scattered, (3, 7, 5) and (150, 100, 150): all
   five outputs to rtol 1e-4 and atol 1e-4·max|ref| (the same rounded
   operands, exact products, f32 sums in another order), bit-identical
   between two calls, masked rows zero; the mutation check: the f32 arm on
   the same inputs (the unrounded 3xTF32 path a build without the rounding
   runs) must fail that check on the forward, d_xj, d_a and the weight
   gradient; the forward's weight image and its transposed image (the
   layout kernels) byte for byte against weight_image_plain; then times
   the arm beside its bound at the dense BF16 rate (989.4 TFLOP/s), the f32
   arm's time in the same call, its plain versions and the same einsum
   compositions on bf16 tensors as the library yardstick, and the backward
   to the rows' d_xj and d_a launches alone;
7. runs Predict through cli.run on the card with the launch counters reset
   just before and read just after (each CSR kernel >= 32: 8 batches x 4
   CGConv layers), then the same Predict on the CPU (plain versions, same
   checkpoint), and requires 1,000 finite predictions that agree to
   rtol 1e-4, atol 1e-4;
8. trains CGCNN_demo through cli.run on the card (--run_mode=Training,
   kernel auto, 5 epochs, verbosity 1, from that checkpoint; like every
   card Training run here, on the trainer's CUDA graphs, which its
   resolved line must say: capture=graphs) with the
   launch counters reset just before and read just after: each fused
   kernel must launch at least 4 layers x 8 steps x 5 epochs times; then
   1 epoch of the same on the CPU (plain versions; one epoch, as for 10
   and 14, keeps the script inside its time limit): the first epoch's
   train error agrees to rtol 1e-3, every error is finite, and the card's
   last train error is below its first; Predict on the card from the
   checkpoint Training saved gives 1,000 finite predictions;
9. trains 3 epochs under kernel csr and 3 more under kernel fused, and
   prints the warm epoch time of each; profiles one warm training epoch
   under each of fused (on CUDA graphs and eager) and csr (device busy
   share, top kernels); every later profiled model epoch runs both ways
   too;
10. does 8 for SchNet_demo (each cfconv kernel >= 4 x 8 x 5 launches), then
    SchNet Predict on the card from the checkpoint Training saved (counters
    reset just before: csr_segment_sum >= 4 x 8 launches; 1,000 finite
    predictions that agree with the CPU Predict of that checkpoint to rtol
    1e-4, atol 1e-4; one more profiled), then does 9 for SchNet_demo;
11. does 8 for MPNN_demo: the bilinear forward, backward and weight-gradient
    kernels and csr_segment_sum and csr_gather each >= 4 x 8 x 5 launches;
    the comparison with the CPU (kernel fused, plain versions) runs 1 epoch
    on each side on the first 200 structures (a plain epoch over all 1,000
    takes minutes on the CPU; the CPU side trains the epoch alone,
    first_epoch_error, without the split outputs that a Training run
    writes after it); then MPNN Predict on the card from the
    checkpoint Training saved (counters reset just before: the bilinear
    forward and csr_segment_sum >= 4 x 8 launches; 1,000 finite
    predictions), and card against CPU Predict of that checkpoint on the
    first 200 structures to rtol 1e-4, atol 1e-4 (a plain Predict of all
    1,000 takes over a minute on the CPU; one more profiled); then 3
    warm-timed epochs under kernel xla (the einsum over the formed per-edge
    weights) and 3 under kernel fused, and one profiled warm epoch;
12. builds the windowed layout of the 1,000 structures and checks the
    windowed kernels (segment-sum, SpMM, gather) against their plain
    versions on the card, at the layout of a GCN_demo training batch with 10
    pad graph slots (windows that own no tile, tail capacity tiles) and at a
    random windowize_edges layout with an empty window, D in {1, 100, 150},
    NaN in the messages and weights of pad slots: sums to rtol 1e-5 and atol
    1e-5·max|ref| (a fixed order, not index_add_'s; each case prints the
    sums' worst share of that limit), finite, bit-identical twice, zero on
    nodes without edges; the gather bit-exact; the gradients
    of the three autograd Functions; then times them at the full training
    batch beside their bound, their plain versions and index_add_ /
    index_select as the library yardsticks (this phase runs right after 6);
13. trains 3 epochs of CGCNN_demo under kernel pallas beside 9's csr and
    fused epochs (the windowed segment-sum at D 100 and its gather);
14. does 8 for GCN_demo under kernel pallas: the windowed SpMM (every
    message sum), segment-sum (every degree) and gather (the SpMM's
    backward) each >= 4 x 8 x 5 launches, 1 CPU epoch to compare; then GCN
    Predict on the card from the checkpoint Training saved (dst-sorted CSR
    plan; counters reset just before: csr_segment_sum >= 2 x 4 x 8
    launches; 1,000 finite predictions that agree with the CPU Predict of
    that checkpoint to rtol 1e-4, atol 1e-4; one more profiled); then 3
    warm-timed epochs each under kernels xla, csr and pallas, and one
    profiled warm pallas epoch;
14a. does 8 for MEGNet_demo under kernel auto (csr on the src order): each
    CSR kernel >= 3 x 4 blocks x 8 steps x 5 epochs launches (a block a
    step: 2 gathers and 1 sum forward, 1 gather and 2 sums backward); the
    CPU comparison (1 epoch each side, all 1,000 structures) without
    BatchNorm (MEGNET_NOBN says why); MEGNet Predict on the card from the checkpoint Training saved
    (counters reset just before: gathers >= 2 x 4 x 8, sums >= 5 x 8;
    1,000 finite predictions within rtol 1e-4, atol 1e-4 of the CPU
    Predict; one more profiled); then 3 warm-timed epochs each under
    kernels xla, csr and pallas, and one profiled warm csr epoch;
14b. prints the packed spec of a training batch (batch 100) beside the
    padded one and the steps of an epoch; trains CGCNN_demo (kernel auto:
    fused) and MEGNet_demo (kernel auto: csr) 3 epochs each with batching
    packed (the fused kernels, and the CSR kernels, each launch at least
    the packed steps' count times the padded floors' factors), prints each
    warm epoch beside its padded one, and holds the first epoch's train
    error to a CPU packed run (1 epoch, rtol 1e-3; MEGNet without
    BatchNorm, 1 epoch on each side);
    then CGCNN_demo 3 epochs under packed csr and packed pallas, and one
    profiled warm packed epoch (kernel fused);
14c. trains every model and arm of 9, 13, 14, 14a and 14b (CGCNN csr,
    fused, pallas and packed fused, csr, pallas; SchNet csr, fused; MPNN
    xla, fused, and fused under precision bf16; GCN xla, csr, pallas;
    MEGNet xla, csr, pallas and packed csr) from its checkpoint on the trainer's CUDA graphs and on its eager
    loop (capture=False): 4 epochs each, printing the 3 warm epochs, the
    peak device memory and the launches, equal both ways; then 3 epochs
    each under torch.use_deterministic_algorithms, whose per-epoch train
    and val errors agree to rtol 1e-6, launches equal; then the fastest
    arm of each model and batching, captured (kernel auto's picks
    re-checked), and the busy shares of the profiled epochs both ways;
15. prints the throughput meter's line of 8's card Training (5 epochs of 8
    steps in chunks of one epoch: the first chunk is warmup, 32 steps are
    rated), which must give edges/s > 0 and 0 < MFU <= 100% (against the
    BF16 peak); and, after 14, each model's largest card-vs-CPU Predict gap;
16. trains CGCNN_demo 2 epochs under --profile True (Job.profile) and
    requires its Chrome trace to name the kernels of the fused CGConv
    forward, backward, weight gradient and slice sum;
17. trains each of CGCNN_demo, SchNet_demo and MPNN_demo (kernel auto:
    fused) and GCN_demo (kernel pallas) 2 epochs from its checkpoint with
    and without remat (jobs.run_fused_training, full-precision errors): the
    forward kernel (fused CGConv, cfconv, bilinear forward, windowed SpMM)
    launches exactly 4 layers x 8 steps x 2 epochs more times with remat
    (the recomputed training forwards); run again under
    torch.use_deterministic_algorithms (index_add_'s ordered path), the
    per-epoch train errors agree to rtol 1e-6; prints the worst gap, the
    gap of the plain runs with and without determinism, and epoch 2's time
    with and without remat; then the same for MEGNet_demo (kernel auto:
    csr), whose CSR gather launches 2 more times a recomputed block;
18. runs `python -m matdeeplearn_torch.bench` as a subprocess and prints
    its JSON line, whose MAE gate must pass (trained on CUDA graphs) and
    which must hold the packed arms' keys, the bf16 arms' (kernel_precision
    bf16 under csr among them) and the eager loop's (`*_eager`);
19. drives the descriptor models and the other run modes, each phase
    printing its wall time and warm epoch time beside the nvidia-smi line:
    a. SM_demo (config.yml's widths) on the 1,000 periodic structures with
       SM_descriptor: processing must print "Data processed (native)", the
       native featurizer's edges equal the numpy featurizer's on the first
       100 structures (indices exact, distances to 1e-12), with both
       featurize times; 5 epochs on the card on CUDA graphs, the first
       epoch's train error against 1 CPU epoch to rtol 1e-4, and Predict
       card vs CPU to rtol 1e-4, atol 1e-4, with its largest gap printed;
    b. the same for SOAP_demo on 1,000 write_clusters Pt clusters (10 atoms,
       seed 0) with SOAP_descriptor and config.yml's SOAP values, plus the
       seconds of soap_features, whose output the processed descriptors
       equal;
    c. CV of CGCNN_demo, 3 folds x 3 epochs: the trainer captures its
       graphs in fold 0 only (2 captures: the train step and the epoch
       tail, no val split); under torch.use_deterministic_algorithms fold
       1 on the reused Run (jobs.reset_run) gives a fresh Run's fold 1
       errors to rtol 1e-6;
    d. Repeat of CGCNN_demo, 2 trials x 3 epochs on one Run (graphs
       captured in trial 0 only: 3, the train step, eval step and tail):
       <job>_all_errorvalues.csv with 2 finite trial rows, the mean and the
       standard deviation;
    e. Ensemble of CGCNN_demo and SchNet_demo, 3 epochs each: the
       ensemble's L1 error on the test outputs is <= the mean of the
       members' (convexity);
    f. Analysis: the graph embeddings of 8's trained CGCNN_demo on the
       card (the CSR kernels, counters reset just before) against the
       CPU's, rtol 1e-4 and atol 1e-4·max|CPU|; the run mode itself runs
       t-SNE where sklearn is installed and must raise an ImportError
       naming scikit-learn where it is not;
    g. Hyperparameter: CGCNN_demo's search space, 3 trials x 4 epochs,
       concurrency 1: device memory allocated after trial 3 within 64 MiB
       of that after trial 1 (each trial's Run and graphs are freed), and a
       second call resumes and trains no trial;
21. precision bf16: trains MPNN_demo under `precision: bf16` (kernel
    auto: fused, so every NNConv message and gradient runs on the bilinear
    kernels' bf16 arm) 5 epochs from its checkpoint, the launch counters
    reset just before: each bf16 arm >= 4 x 8 x 5 launches, the f32 arm
    none, the resolved line saying precision=bf16; its warm epoch beside
    the f32 run's of 11; the first-epoch train error card vs CPU on the
    first 200 structures (1 epoch each, the CPU's alone as in 11) to rtol
    2^-6 (BF16_RTOL says why); Predict from its checkpoint on the card (1,000 finite
    predictions, the bf16 forward >= 4 x 8 launches) and card vs CPU on
    the first 200 structures, to 2^-6 of the largest prediction; the busy
    share of a profiled captured epoch; then CGCNN_demo, SchNet_demo,
    GCN_demo, MEGNet_demo (kernel auto), SM_demo and SOAP_demo (19's
    data) under bf16, 3 epochs each on the card: errors finite and the
    train error falling;
22. kernel_precision bf16, the single-pass arms (the data operands of the
    reference's one-hot products rounded to bf16, f32 sums): checks each
    arm against its plain twin on the card (the fused CGConv at D 100 and
    cfconv at F 150 on a training batch, sorted and with a scattered mask:
    forward and every gradient to SP_MEDIAN and SP_LARGEST, which say why,
    bit-identical twice on sorted edges; the windowed arms on the GCN_demo
    windowed batch with pad graph slots and the CSR arms on a Predict
    batch, D 1 and 100: sums to rtol 1e-5, atol 1e-5·max|ref|,
    bit-identical twice, gathers bit-exact) with the mutation check (the
    f32 arm on the same inputs misses each limit by 10x or more); times
    each arm beside its f32 arm in the same call, its plain twin, its
    bound (the f32 arm's: the same bytes and operations) and, for the
    windowed and CSR arms, index_add_ / index_select over operands rounded
    beforehand; then trains CGCNN_demo under kernel_precision bf16 (kernel
    auto: fused, the CGConv kernels' arm, on CUDA graphs) 5 epochs from its
    checkpoint, the counters reset just before: each arm >= 4 x 8 x 5
    launches, the f32 CGConv arm none; its warm epoch beside main path 2's,
    the first epoch against 1 CPU epoch of the twins (rtol 2^-6), Predict
    from its checkpoint card vs CPU to 2^-6 of the largest prediction, the
    busy share of a profiled captured epoch; then SchNet_demo under fused
    and GCN_demo and CGCNN_demo under pallas, 3 epochs each with the key:
    each arm of the path launched, its f32 arm not, the errors falling;
23. disk streaming (`dataset_type: large`, check_streaming says what it
    holds): the 1,000 structures in 16 shards of 64 against the LRU's 8;
    the shard write and the link bytes of a training batch, wire and full;
    MPNN_demo streamed 4 epochs through cli.run on CUDA graphs (kernel
    auto: every message on the bilinear kernels over the reference edge
    order; each >= 4 x 8 x 4 launches, no other kernel), its warm epoch
    beside main path 5's, the host's assembly a batch, the busy share of a
    profiled warm streamed epoch, the peak memory beside phase 14c's and
    the Throughput line; card vs CPU on the first 64 (rtol 1e-3, bf16
    2^-6); CGCNN_demo captured with the prefetch ring against eager with a
    synchronous assembler (rtol 1e-6, deterministic); streamed Predict
    against in-memory Predict (wire off rtol 1e-4, atol 1e-4; wire on
    WIRE_RTOL);
24. data and edge parallelism (matdeeplearn_torch/parallel; check_parallel
    says what each part holds): (a) CGCNN_demo, BatchNorm on, two dp steps
    in a 2-rank gloo world on this card (CUDA tensors, deterministic) on
    the fused CGConv kernels, against two single-replica steps averaged by
    count in one process (P24_EXACT) and against the plain versions on the
    CPU (P24_PLAIN), the dp steps' fused launches counted; (b) MEGNet_demo,
    BatchNorm on, ep 2 on that world against the single-card steps on the
    same batches (P24_EP_LOSS, P24_EP_STATE); (c) train_regular on a
    1-rank NCCL mesh on CUDA graphs (the step's all_reduce captured), 2
    epochs against the mesh-less run (P24_TRAIN_RTOL); (d) with two or more
    cards, (a) on NCCL across two of them, else a line saying it did not
    run; each part's gaps and seconds printed before any failure raises;
25. the port's bench_bulk (matdeeplearn_torch/bench_bulk.py; check_bulk
    says what it holds): its MP-skew corpus at 1,024 structures; the 17
    configurations that the bench's bulk segment lacks (CGCNN packed xla
    and fused; GCN, SchNet and MEGNet (src and dst) packed csr; MPNN xla
    padded and packed fused; MEGNet, GCN and SchNet packed xla; SchNet xla
    padded, fused padded and packed; CGCNN streamed padded, packed, and
    packed with the wire off), full widths, 1 warm and 1 timed epoch on
    CUDA graphs and the same eagerly: each plan's kernels >= gc_count x
    steps x epochs launches and no other kernel, a finite record, device
    memory back within 64 MiB, the peak printed; card vs CPU, first-epoch
    train error rtol 1e-3, for SchNet packed fused and csr, GCN packed
    csr, MEGNet packed xla and csr on dst, CGCNN streamed packed (first
    128 structures) and MPNN packed fused (first 32);
20. prints a {"kernels": [...]} line (the CSR rows with their callers,
    each path's launches and the src-sorted shapes' times; each
    single-pass arm's row and each bilinear bf16 arm's row with `f32_ms`,
    its f32 arm's time in the same call), the nvidia-smi line and, last,
    {"ok": true, "device": {...}};
    the three bf16 arm rows' launches are 21's MPNN_demo Training's, the
    single-pass rows' 22's (the CSR arm is on no path: 0); the f32
    bilinear rows add `launches_by_path`, 5's and 23's streamed Training
    and Predict, and the fused CGConv rows theirs, main path 2's and phase
    24 (a)'s dp steps (both ranks); the CSR, fused CGConv, cfconv and f32
    bilinear rows add each phase 25 configuration that launched them.

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
import socket
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
# H100 SXM dense BF16 tensor-core rate: the bilinear kernels' bf16 arm
# (one pass over bf16 operands) is bounded by it
BF16_FLOPS = 989.4e12
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
# config.yml's Job sections of the other run modes (held to it by
# tests/test_torch_jobs.py)
RUN_MODE_JOBS = {
    "Repeat": {"job_name": "my_repeat_job", "reprocess": "False",
               "model": "CGCNN_demo", "model_path": "my_model.ckpt",
               "write_output": "False", "parallel": "True", "seed": 0,
               "repeat_trials": 5},
    "CV": {"job_name": "my_CV_job", "reprocess": "False",
           "model": "CGCNN_demo", "write_output": "True", "parallel": "True",
           "seed": 0, "cv_folds": 5},
    "Hyperparameter": {"job_name": "my_hyperparameter_job",
                       "reprocess": "False", "model": "CGCNN_demo", "seed": 0,
                       "hyper_trials": 10, "hyper_concurrency": 1,
                       "max_failures": 4, "hyper_iter": 1,
                       "hyper_resume": "True",
                       "hyper_delete_processed": "True"},
    "Ensemble": {"job_name": "my_ensemble_job", "reprocess": "False",
                 "save_model": "False", "model_path": "my_model.ckpt",
                 "write_output": "Partial", "parallel": "True", "seed": 0,
                 "ensemble_list": "CGCNN_demo,CGCNN_demo,CGCNN_demo,"
                                  "CGCNN_demo,CGCNN_demo"},
    "Analysis": {"job_name": "my_job", "reprocess": "False",
                 "model": "CGCNN_demo", "model_path": "my_model.ckpt",
                 "write_output": "True", "seed": 0},
}
TRAIN_SEED = 7
# EPOCHS_CPU: the CPU side of the CGCNN, SchNet and GCN card/CPU
# comparisons, which hold the first epoch: one epoch keeps the script
# inside its time limit
EPOCHS_CARD, EPOCHS_CPU, EPOCHS_AB = 5, 1, 3
# epochs of the CPU side of the card/CPU comparisons of MPNN (on the first
# N_COMPARE structures), MEGNet and the packed runs: their plain versions
# take longest on the CPU
EPOCHS_COMPARE = 1
EPOCHS_REMAT = 2     # epochs of each --profile and remat run
# epochs of each timed run of the captured-against-eager phase (the first
# holds the build and the captures; 3 warm) and of each deterministic run
EPOCHS_CAPTURE, EPOCHS_CAPTURE_DET = 4, 3
BENCH_TIMEOUT_S = 600
# the kernels mdl_fused_cgconv_fwd/_bwd/_wgrad launch, as a trace names them
PROFILED_KERNELS = ("fused_cgconv_fwd_kernel", "fused_cgconv_bwd_kernel",
                    "fused_cgconv_wgrad_kernel", "wgrad_reduce_kernel")
N_COMPARE = 200  # structures of MPNN's card/CPU training comparison
# structures of phase 23 (c)'s streamed card/CPU comparison: its CPU side
# runs the plain bilinear versions, whose cost grows with the structures
N_COMPARE_STREAM = 64
# phase 23: disk streaming. The 1,000 structures in shards of 64 graphs (16
# shards against the LRU's 8, so every epoch evicts); the streamed MPNN_demo
# run's epochs (3 warm: the meter's 20 steady-state steps); the epochs of
# each run of the captured-against-synchronous check; and the limit of
# streamed Predict with the wire on (f16 features and distances) against
# in-memory f32 Predict, the JAX package's wire tolerance
# (tests/test_streaming.py:test_wire_format_roundtrip)
N_SHARD_GRAPHS = 64
EPOCHS_STREAM, EPOCHS_STREAM_RACE = 4, 2
WIRE_RTOL = 1e-3
# phase 24: parallelism. P24_STEPS dp and ep steps of 2 x 100 graphs; (a)
# against single-replica steps with the same kernels: the same arithmetic
# (a sum of two terms commutes), so P24_EXACT; against the plain versions on
# the CPU, the card/CPU training limit of main path 2; (b) MEGNet_demo under
# ep, its partial sums in another order: the loss to P24_EP_LOSS and the
# state to P24_EP_STATE, five of AdamW's steps at MEGNet_demo's rate (an
# element whose gradient is rounding noise, MEGNET_NOBN says why, moves by
# up to about the rate in each of AdamW's first two steps (betas 0.9 and
# 0.999), either way on either side: 4 rates apart, and slack); (c)
# P24_EPOCHS epochs of train_regular on a 1-rank NCCL mesh against the
# mesh-less run, whose gradients round otherwise (divided by the count in
# the backward, not after it); the epoch lines print 5 decimals
P24_STEPS, P24_EPOCHS = 2, 2
P24_EXACT, P24_PLAIN, P24_TRAIN_RTOL = 1e-6, 1e-3, 1e-4
P24_EP_LOSS, P24_EP_STATE = 1e-4, 5 * 0.0005
# phase 25: the port's bench_bulk (matdeeplearn_torch/bench_bulk.py). Its
# MP-skew corpus at N_BULK structures; the configurations that the bench's
# bulk segment lacks, each at full width under its batch rule for
# P25_EPOCHS warm and as many timed epochs, captured, then eager; the
# card-vs-CPU comparisons (first-epoch train error, rtol 1e-3, at batch
# P25_COMPARE_BATCH so that several steps land in the epoch) on the
# corpus' first P25_COMPARE_N structures, MPNN's on its first
# P25_MPNN_COMPARE_N (the plain versions of its bilinear kernels take
# longest on the CPU); the streamed one on shards of P25_SHARD_GRAPHS
N_BULK = 1024
P25_CONFIGS = ("packed", "packed-fused", "gcn-packed-csr", "schnet-packed-csr",
               "megnet-packed-csr", "megnet-packed-csr-dst", "mpnn-xla",
               "megnet-packed", "gcn-packed", "schnet-packed", "schnet-xla",
               "mpnn-packed-fused", "schnet-fused", "schnet-packed-fused",
               "stream", "stream-packed", "stream-packed-nowire")
P25_COMPARE = ("schnet-packed-fused", "schnet-packed-csr", "gcn-packed-csr",
               "megnet-packed", "megnet-packed-csr-dst", "stream-packed",
               "mpnn-packed-fused")
P25_EPOCHS = 1
P25_COMPARE_N, P25_MPNN_COMPARE_N, P25_COMPARE_BATCH = 128, 32, 32
P25_SHARD_GRAPHS = 32
# phase 19: the descriptor models (config.yml's SM_demo and SOAP_demo), the
# run modes' sizes, and the SOAP corpus (write_clusters' Pt clusters)
SM_DEMO = {
    "model": "SM", "dim1": 100, "fc_count": 2, "epochs": 200, "lr": 0.002,
    "batch_size": 100, "optimizer": "AdamW", "optimizer_args": {},
    "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}
SOAP_DEMO = {**SM_DEMO, "model": "SOAP"}
N_NATIVE_CHECK = 100  # structures whose native and numpy edges are compared
CV_FOLDS, REPEAT_TRIALS, HYPER_TRIALS, EPOCHS_HYPER = 3, 2, 3, 4
HYPER_MEMORY_SLACK_MIB = 64
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+), "
                        r"Time per epoch \(s\): ([0-9.]+)")
THROUGHPUT_LINE = re.compile(r"\(([0-9,]+) edges/s\).*, MFU ([0-9.]+)%")
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
MEGNET_DEMO = {
    "model": "MEGNet", "dim1": 100, "dim2": 100, "dim3": 100,
    "pre_fc_count": 1, "gc_count": 4, "gc_fc_count": 1, "post_fc_count": 3,
    "pool": "global_mean_pool", "pool_order": "early", "batch_norm": "True",
    "batch_track_stats": "True", "act": "relu", "dropout_rate": 0.0,
    "epochs": 250, "lr": 0.0005, "batch_size": 100, "optimizer": "AdamW",
    "optimizer_args": {}, "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 0.00001, "threshold": 0.0002},
}
# MEGNet_demo's card/CPU comparisons run without BatchNorm: its sub-MLPs put
# biases behind training-mode BatchNorms (ROADMAP §3), whose rounding-noise
# gradients AdamW turns into steps of the learning rate, so two runs that
# differ only in summation order part by more than 1e-3 within 8 steps
# (PERF.md); without BatchNorm they agree.
MEGNET_NOBN = {**MEGNET_DEMO, "batch_norm": "False"}
# MPNN_demo under `precision: bf16` (phase 21), and the bf16 limit of its
# card/CPU comparisons: both run the same operations at the same rounding
# points, but an f32 sum in another order (cuBLAS's GEMMs, the kernels) can
# tip a value to the neighbouring bf16 one, 2^-8 of it; 2^-6 allows a few
# such steps through the model's layers
MPNN_BF16 = {**MPNN_DEMO, "precision": "bf16"}
BF16_RTOL = 2.0 ** -6
# phase 22: `kernel_precision: bf16`, the fused, windowed and CSR kernels'
# single-pass arms. The fused arms round a message (and d_x_i) that the
# kernel forms in 3xTF32 and its plain twin with f32 GEMMs, an ulp apart:
# where such a value lies within an ulp of a bf16 midpoint, the two sides
# round it to neighbouring bf16 values (2^-8 of it apart). So they are held
# by the median of |kernel - twin| over the median of |twin| (SP_MEDIAN: f32
# order alone) and by the largest gap (SP_LARGEST of max|twin|: a few tipped
# roundings, not a missing arm); the f32 arm on the same inputs must miss
# SP_MEDIAN by SP_MUTATION or more. The windowed and CSR arms round exactly
# what their twins round and keep the f32 arms' limits.
SP_MEDIAN, SP_LARGEST, SP_MUTATION = 1e-5, 2.0 ** -7, 10.0
CGCNN_SP = {**CGCNN_DEMO, "kernel_precision": "bf16"}
# the arms' rows of the kernels line: key, kernel, source, what it replaces
SP_ROWS = (
    ("fused_cgconv_fwd_sp", "fused_cgconv.cu", "pallas_fused.py:112"),
    ("fused_cgconv_bwd_sp", "fused_cgconv.cu", "pallas_fused.py:137"),
    ("fused_cgconv_wgrad_sp", "fused_cgconv.cu", "pallas_fused.py:137"),
    ("fused_cfconv_fwd_sp", "fused_cfconv.cu", "pallas_fused_schnet.py:66"),
    ("fused_cfconv_bwd_sp", "fused_cfconv.cu", "pallas_fused_schnet.py:86"),
    ("windowed_segment_sum_sp", "windowed.cu", "pallas_segment.py:144"),
    ("windowed_spmm_sp", "windowed.cu", "pallas_segment.py:174"),
    ("windowed_gather_sp", "windowed.cu", "pallas_segment.py:209"),
    ("segment_sum_sp", "csr.cu", "pallas_csr.py:135"),
    ("gather_sp", "csr.cu", "pallas_csr.py:159"))
# the bench's keys of the bulk segment's bf16 arms
BENCH_BF16_KEYS = ("bulk_epoch_s_bf16", "bulk_epoch_s_bf16_packed",
                   "bulk_epoch_s_bf16_packed_fused",
                   "bulk_mpnn_epoch_s_packed_fused_bf16",
                   "bulk_epoch_s_bf16_packed_csr")
# the bench's keys of the packed arms (matdeeplearn_torch/bench.py)
BENCH_PACKED_KEYS = ("bulk_epoch_s_csr_packed", "bulk_csr_packed_speedup",
                     "bulk_mpnn_epoch_s_csr_fused", "bulk_mpnn_epoch_s_xla",
                     "bulk_mpnn_csr_fused_speedup")
# its keys of the eager loop (every other time is captured)
BENCH_EAGER_KEYS = ("value_eager", "bulk_epoch_s_fused_eager",
                    "bulk_epoch_s_pallas_eager", "bulk_epoch_s_xla_eager",
                    "bulk_epoch_s_csr_packed_eager",
                    "bulk_mpnn_epoch_s_csr_fused_eager",
                    "bulk_mpnn_epoch_s_xla_eager")
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
    (CGCNN_demo, SchNet_demo, MPNN_demo, GCN_demo or MEGNet_demo, with
    "batching": "packed" for packed batches), resuming from `model_path`
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
    random species 1-83, as ase-json, with targets.csv
    (data/synthetic.py:write_periodic)."""
    from matdeeplearn_torch.data.synthetic import write_periodic

    write_periodic(root, n, seed)


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


def check_src_kernels(batch, dev, d=100) -> tuple[dict, list]:
    """The CSR kernels at MEGNet's calls on one src-sorted training batch:
    edge_src into the N nodes (x[src] gathers, the edge→node means) and
    node_graph[edge_src] into the B graph rows (the u broadcast, whose
    backward sums runs of a graph's edges), with the tail pads (index 0,
    mask 0) the batch gives. Gather bit-exact, sum rtol 1e-5 and atol
    1e-5·max|ref| and bit-identical between two calls (sorted runs), and
    the gradient of each autograd pair. Returns the
    largest |kernel - plain| of each kernel and the (name, index, n)
    cases."""
    from matdeeplearn_torch.ops import csr

    mask = batch.edge_mask
    real = mask > 0
    edge_graph = batch.node_graph[batch.edge_src.long()].to(torch.int32)
    cases = [("edge_src", batch.edge_src, batch.num_nodes),
             ("node_graph[edge_src]", edge_graph, batch.num_graphs)]
    g = torch.Generator(device=dev).manual_seed(3)
    err = {"segment_sum": 0.0, "gather": 0.0}
    for name, idx, n in cases:
        sorted_real = bool((idx[real][1:] >= idx[real][:-1]).all())
        tail = int(idx[~real].abs().max()) if bool((~real).any()) else -1
        if not sorted_real or tail != 0:
            raise AssertionError(f"{name}: expected sorted real edges and tail "
                                 f"pads at 0 (sorted {sorted_real}, pad max "
                                 f"{tail})")
        x = torch.randn(n, d, device=dev, generator=g, requires_grad=True)
        msg = torch.randn(idx.shape[0], d, device=dev, generator=g,
                          requires_grad=True)
        out = csr.sorted_gather(x, idx, mask)
        if not torch.equal(out, csr.gather_plain(x.detach(), idx, mask)):
            raise AssertionError(f"gather, {name}: not bit-exact")
        cot = torch.randn(out.shape, device=dev, generator=g)
        (out * cot).sum().backward()
        ref = csr.segment_sum_plain(cot, idx, mask, n)
        torch.testing.assert_close(x.grad, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        diff = float((x.grad - ref).abs().max())
        s = csr.sorted_segment_sum(msg, idx, mask, n)
        ref_s = csr.segment_sum_plain(msg.detach(), idx, mask, n)
        torch.testing.assert_close(s, ref_s, rtol=1e-5,
                                   atol=1e-5 * float(ref_s.abs().max()))
        if not torch.equal(s, csr.segment_sum(msg.detach(), idx, mask, n)):
            raise AssertionError(f"segment_sum, {name}: sorted runs, yet not "
                                 "the same bits twice")
        cot_n = torch.randn(s.shape, device=dev, generator=g)
        (s * cot_n).sum().backward()
        if not torch.equal(msg.grad, csr.gather_plain(cot_n, idx, mask)):
            raise AssertionError(f"segment_sum backward, {name}: not bit-exact")
        diff = max(diff, float((s.detach() - ref_s).abs().max()))
        err["segment_sum"] = max(err["segment_sum"], diff)
        runs = torch.unique_consecutive(idx[real], return_counts=True)[1]
        print(f"  src kernel check ok: {name} (n={n}, {int(real.sum())} real "
              f"of {idx.shape[0]} edges, runs of up to {int(runs.max())} "
              f"equal indices): segment_sum and the gather's backward max "
              f"|diff| {diff:.3e}, the sum bit-identical twice, gather and "
              f"the sum's backward bit-exact")
    return err, cases


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
        # pre = b·W0 and w = a·W1 on wgmma in 3xTF32 (with its weight split)
        "fused_cfconv_fwd": {
            "ms": device_ms(lambda: FS.fused_cfconv(*args)),
            "plain_ms": device_ms(lambda: FS.fused_cfconv_plain(*args)),
            "library_ms": device_ms(lambda: unfused(*leaves)),
            **bound(fwd_bytes, fwd_flops, TF32X3_FLOPS),
            # the same operations at the FMA pipes' rate, the bound of the
            # scalar-FMA design this forward replaced
            "fma_bound_ms": bound(fwd_bytes, fwd_flops)["bound_ms"],
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


BF16_NAMES = ["output"] + [f"d_{n}" for n in BILINEAR_GRADS]


def check_bilinear_bf16(batch, dev) -> tuple[dict, dict]:
    """The bilinear kernels' bf16 arm (`precision: bf16`) against its plain
    versions on the card, as check_bilinear holds the f32 arm (rtol 1e-4,
    atol 1e-4·max|ref|: the same rounded operands, whose products are
    exact, summed in another f32 order), at (D, H, K) = (100, 100, 100)
    sorted, permuted and scattered, (3, 7, 5) and (150, 100, 150) sorted;
    masked rows exactly zero, each kernel bit-identical between two calls.
    The mutation check: the f32 arm on the same inputs (the unrounded
    3xTF32 path, which a build without the bf16 rounding would run) must
    fail that check on the forward, d_xj, d_a and the weight gradient at
    MPNN width, by a share of the limit above 1. Returns (the largest
    |kernel - plain| of each bf16 kernel, the f32 arm's shares)."""
    from matdeeplearn_torch.ops import fused_bilinear as FB

    g = torch.Generator(device=dev).manual_seed(18)
    mask = batch.edge_mask
    e = mask.shape[0]
    perm = torch.randperm(e, device=dev, generator=g)
    scattered = mask * (torch.rand(e, device=dev, generator=g) > 0.3).float()
    err = {k: 0.0 for k in FB.LAUNCHES_BF16}
    mutant = {}
    failures = []
    for d, h, k in ((100, 100, 100), (3, 7, 5), (150, 100, 150)):
        xj, a, w1, b1 = bilinear_inputs(batch, d, h, k, g, dev)
        cot = torch.randn(e, k, device=dev, generator=g)
        p = lambda t: t[perm].contiguous()
        cases = [("sorted dst, tail pads", xj, a, mask, cot)]
        if d == 100:
            cases += [("permuted dst", p(xj), p(a), p(mask), p(cot)),
                      ("scattered mask", xj, a, scattered, cot)]
        for name, xjv, av, mv, cv in cases:
            what = f"bf16 arm, D={d}, H={h}, K={k}, {name}"
            args = (xjv, av, w1, b1, mv)
            got = (FB.fused_bilinear(*args, bf16=True),
                   *FB.fused_bilinear_bwd(cv, *args, bf16=True))
            again = (FB.fused_bilinear(*args, bf16=True),
                     *FB.fused_bilinear_bwd(cv, *args, bf16=True))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"bilinear {what}: two calls differ")
            ref = (FB.fused_bilinear_plain(*args, bf16=True),
                   *FB.fused_bilinear_bwd_plain(cv, *args, bf16=True))
            shares = {}
            for n, out, r in zip(BF16_NAMES, got, ref):
                try:
                    diff = assert_fused(out, r, f"bilinear {what}: {n}")
                except AssertionError as exc:
                    failures.append(str(exc))
                    diff = float((out - r).abs().max())
                shares[n] = limit_share(out, r)
                key = ("fused_bilinear_fwd_bf16" if n == "output" else
                       "fused_bilinear_bwd_bf16" if n in ("d_xj", "d_a") else
                       "fused_bilinear_wgrad_bf16")
                err[key] = max(err[key], diff)
            for t in got[:3]:
                if float(t[mv == 0].abs().max()) != 0.0:
                    raise AssertionError(f"bilinear {what}: masked rows are "
                                         "not exactly zero")
            print(f"  bilinear kernel check: {what}: worst share of the "
                  f"limit " + ", ".join(f"{n} {v:.3g}" for n, v in
                                        shares.items())
                  + "; bit-identical twice; masked rows zero")
            if name == "sorted dst, tail pads":
                check_weight_image(w1, b1, d, what)
                check_weight_image(w1, b1, d, what, transposed=True)
            if (d, name) == (100, "sorted dst, tail pads"):
                f32 = (FB.fused_bilinear(*args),
                       *FB.fused_bilinear_bwd(cv, *args))
                mutant = {n: limit_share(out, r) for n, out, r in
                          zip(BF16_NAMES, f32, ref)}
                print(f"  mutation check, the f32 arm (unrounded 3xTF32) "
                      f"against the bf16 arm's plain versions: share of the "
                      f"limit " + ", ".join(f"{n} {v:.3g}"
                                            for n, v in mutant.items()))
                for n in ("output", "d_xj", "d_a", "d_w1"):
                    if not mutant[n] > 1.0:
                        failures.append(f"the unrounded f32 arm passes the "
                                        f"bf16 arm's check on {n}: the check "
                                        "cannot tell the arms apart")
    if failures:
        raise AssertionError(f"{len(failures)} bilinear bf16 checks failed; "
                             f"the first: {failures[0]}")
    return err, mutant


def check_weight_image(w1, b1, d, what, transposed=False):
    """The bf16 forward's layout kernels against weight_image_plain: the
    bf16 tiles (and the zero k16-steps that pad the image to whole ring
    stages) byte for byte, b1's TF32 words in their 19 bits (cvt.rna leaves
    the low 13 unspecified); with `transposed`, the image of W1ᵀ and b1ᵀ
    that d_xj runs on."""
    from matdeeplearn_torch.ops import fused_bilinear as FB

    got = FB.weight_image(w1, b1, d, transposed).cpu()
    k = b1.numel() // d
    wd, wk = (k, d) if transposed else (d, k)
    kd, np_ = -(-wd // 16), 8 * FB.wgmma_width(wk)
    steps = (got.numel() - kd * np_ * 128) // (np_ * 32)
    ref = FB.weight_image_plain(w1.cpu(), b1.cpu(), d, steps, transposed)
    nb = steps * np_ * 32
    same = got.numel() == ref.numel() and torch.equal(got[:nb], ref[:nb])
    same = same and torch.equal(got[nb:].view(torch.int32) & ~0x1FFF,
                                ref[nb:].view(torch.int32) & ~0x1FFF)
    if not same:
        raise AssertionError(f"bilinear {what}: the bf16 forward's "
                             f"{'transposed ' if transposed else ''}weight "
                             "image differs from weight_image_plain")
    print(f"  bilinear {what}: {'transposed ' if transposed else ''}weight "
          f"image ({got.numel()} bytes, {steps - w1.shape[0] * kd} padding "
          "k16-steps) equals weight_image_plain")


def time_bilinear_bf16(batch, dev, d=100, h=100, k=100):
    """time_bilinear for the bf16 arm: kernel and plain times at one
    MPNN_demo training batch, the bound at the dense BF16 rate (the
    function's operations; the bytes as the f32 arm's, which reads f32
    rows), and the library yardstick on bf16 tensors: the same
    torch.einsum compositions over bf16 copies of the inputs (cuBLAS's bf16
    GEMMs, f32 accumulation), which the port never calls. The backward to
    the rows' parts too (`parts_ms`): its d_xj launch (the forward's tiles
    over the transposed image) and d_a launch on ready images, and its two
    layout kernels."""
    from matdeeplearn_torch.ops import fused_bilinear as FB

    g = torch.Generator(device=dev).manual_seed(19)
    mask = batch.edge_mask
    e = mask.shape[0]
    e_real = int((mask > 0).sum())
    xj, a, w1, b1 = bilinear_inputs(batch, d, h, k, g, dev)
    cot = torch.randn(e, k, device=dev, generator=g)
    args = (xj, a, w1, b1, mask)
    bf = torch.bfloat16
    xj16, a16, w16, b16, m16, c16 = (t.to(bf) for t in (xj, a, w1, b1, mask,
                                                        cot))
    leaves = [t.clone().requires_grad_(True) for t in (xj16, a16)]

    def library(xjv, av):
        msg = (torch.einsum("eh,ed,hdk->ek", av, xjv, w16.view(h, d, k))
               + xjv @ b16.view(d, k))
        return msg * m16[:, None]

    out = library(*leaves)
    a_ext = torch.cat([a16, torch.ones_like(a16[:, :1])], 1)
    ge = c16 * m16[:, None]
    units = h + 1
    w_floats = units * d * k
    fwd_bytes = 4 * (e_real * (d + h + k) + e + w_floats)
    fwd_flops = e_real * h * d + 2 * e_real * units * d * k
    bwd_bytes = 4 * (e_real * (2 * d + 2 * h + k) + e + w_floats)
    bwd_flops = 2 * e_real * units * d * k + e_real * (4 * h * d + d)
    res = {
        "fused_bilinear_fwd_bf16": {
            "ms": device_ms(lambda: FB.fused_bilinear(*args, bf16=True), 20),
            "plain_ms": device_ms(
                lambda: FB.fused_bilinear_plain(*args, bf16=True), 10),
            "library_ms": device_ms(lambda: library(xj16, a16), 10),
            **bound(fwd_bytes, fwd_flops, BF16_FLOPS),
        },
        "fused_bilinear_bwd_bf16": {
            "ms": device_ms(lambda: FB.fused_bilinear_bwd_rows(
                cot, *args, bf16=True), 20),
            "plain_ms": device_ms(lambda: FB.bwd_rows_plain(
                cot, *args, bf16=True), 10),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                out, leaves, c16, retain_graph=True), 10),
            **bound(bwd_bytes, bwd_flops, BF16_FLOPS),
        },
        "fused_bilinear_wgrad_bf16": {
            "ms": device_ms(lambda: FB.fused_bilinear_wgrad(
                cot, xj, a, mask, bf16=True), 20),
            "plain_ms": device_ms(lambda: FB.wgrad_plain(
                cot, xj, a, mask, k, bf16=True), 10),
            "library_ms": device_ms(lambda: torch.einsum(
                "eh,ed,ek->hdk", a_ext, xj16, ge), 10),
            **bound(fwd_bytes, fwd_flops, BF16_FLOPS),
        },
    }
    lib = FB._load_bf16()
    img_t = FB.weight_image(w1, b1, d, transposed=True)
    img = FB.weight_image(w1, b1, d)
    d_xj, d_a = torch.zeros_like(xj), torch.zeros_like(a)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name, *args):
        rc = getattr(lib, name)(*args)
        if rc != 0:
            raise AssertionError(f"{name} returned {rc}")

    res["fused_bilinear_bwd_bf16"]["parts_ms"] = {
        "d_xj": device_ms(lambda: launch(
            "mdl_fused_bilinear_bf16_fwd_image", cot.data_ptr(), a.data_ptr(),
            img_t.data_ptr(), mask.data_ptr(), d_xj.data_ptr(), e, k, d, h,
            stream), 20),
        "d_a": device_ms(lambda: launch(
            "mdl_fused_bilinear_bf16_bwd_a", xj.data_ptr(), img.data_ptr(),
            mask.data_ptr(), cot.data_ptr(), d_a.data_ptr(), e, d, k, h,
            stream), 20),
        "layouts": device_ms(lambda: (FB.weight_image(w1, b1, d, True),
                                      FB.weight_image(w1, b1, d)), 20),
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


def sum_share(out, ref) -> float:
    """The worst element's |out - ref| over what assert_sum allows it
    (1e-5·max|ref| + 1e-5·|ref|): below 1 passes."""
    allowed = 1e-5 * max(float(ref.abs().max()), 1e-30) + 1e-5 * ref.abs()
    return float(((out - ref).abs() / allowed).max())


def check_windowed(cases, dev):
    """The windowed kernels against their plain versions on the card, for
    each (name, layout, n, tw) case at D = 1, 100 and 150, with NaN in the
    messages and weights of pad slots: the sums to rtol 1e-5, atol
    1e-5·max|ref|, finite, bit-identical twice, exactly zero on nodes
    without edges (windows that own no tile included); the gather
    bit-exact; the gradients of the three autograd Functions (the SpMM's to
    both operands). Prints the sums' worst share of the limit (sum_share).
    Returns the largest |kernel - plain| of each kernel."""
    from matdeeplearn_torch.ops import windowed as WO

    g = torch.Generator(device=dev).manual_seed(10)
    err = {k: 0.0 for k in WO.LAUNCHES}
    share = {k: 0.0 for k in WO.LAUNCHES}
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
                share[key] = max(share[key], sum_share(out, ref))
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
                  f"slots kept out; sums bit-identical twice; gradients ok; "
                  f"worst share of the limit: segment_sum "
                  f"{share['windowed_segment_sum']:.3g}, spmm "
                  f"{share['windowed_spmm']:.3g}")
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


def sp_shares(out, ref) -> tuple[float, float]:
    """(median |out - ref| over median |ref|, both over the entries that
    are not zero on both sides (masked rows are exactly zero), and max
    |out - ref| over max |ref|): the fused single-pass arms' statistics
    (SP_MEDIAN)."""
    out, ref = out.double(), ref.double()
    diff = (out - ref).abs()
    nz = (out != 0) | (ref != 0)
    if not bool(nz.any()):
        return 0.0, 0.0
    return (float(diff[nz].median()
                  / max(float(ref[nz].abs().median()), 1e-30)),
            float(diff.max() / max(float(ref.abs().max()), 1e-30)))


def check_single_pass(fbatch, wbatch, cbatch, dev) -> tuple[dict, dict]:
    """Phase 22's kernel checks: each single-pass arm against its plain twin
    (single_pass=True) on the card. The fused CGConv (D 100, De 50) and
    cfconv (F 150) arms on a training batch, sorted and with a scattered
    mask: forward and every gradient of the fused backward, to SP_MEDIAN
    and SP_LARGEST, bit-identical twice on sorted edges, d_xj zero on
    masked edges. The windowed arms on a GCN_demo windowed batch with pad
    graph slots and NaN on pad slots, D 1 and 100: the sum and SpMM to
    rtol 1e-5, atol 1e-5·max|ref|, bit-identical twice, the gather
    bit-exact. The CSR arms on a Predict batch, D 1 and 100: likewise. The
    mutation check: the f32 arm on the same inputs misses each limit by
    SP_MUTATION or more (the fused arms on the forward, d_x (d_xj) and the
    first weight block; the sums by their share of the limit; the gathers
    are not bit-equal). Returns (the largest |kernel - twin| of each arm,
    the f32 arm's worst ratio to the limit)."""
    from matdeeplearn_torch.ops import csr
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops import fused_cgconv as FC
    from matdeeplearn_torch.ops import windowed as WO

    g = torch.Generator(device=dev).manual_seed(22)
    err = {row[0]: 0.0 for row in SP_ROWS}
    mutant = {}
    failures = []

    def fused_case(label, keys, got, ref, f32, mutate, masked, dxj):
        shares = []
        for i, (a, b) in enumerate(zip(got, ref)):
            med, big = sp_shares(a, b)
            shares.append((med, big))
            if not (med <= SP_MEDIAN and big <= SP_LARGEST):
                failures.append(f"{label} output {i}: median {med:.3g}, "
                                f"largest {big:.3g}")
            err[keys[i]] = max(err[keys[i]], float((a - b).abs().max()))
        for i in mutate:
            ratio = sp_shares(f32[i], ref[i])[0] / SP_MEDIAN
            mutant[f"{label} output {i}"] = ratio
            if ratio < SP_MUTATION:
                failures.append(f"{label}: the f32 arm's output {i} is "
                                f"{ratio:.3g}x the median limit from the "
                                "single-pass twin")
        if float(got[dxj][masked].abs().max()) != 0.0:
            failures.append(f"{label}: d_xj is not zero on masked edges")
        print(f"  single-pass check: {label}: median / largest share "
              + ", ".join(f"{m / SP_MEDIAN:.3g} / {b / SP_LARGEST:.3g}"
                          for m, b in shares[:4])
              + "; the f32 arm " + ", ".join(
                  f"{mutant[f'{label} output {i}']:.3g}x" for i in mutate))

    mask = fbatch.edge_mask
    scattered = mask * (torch.rand(mask.shape[0], device=dev,
                                   generator=g) > 0.3).float()
    n = fbatch.num_nodes
    for case, mv in (("sorted", mask), ("scattered mask", scattered)):
        x, xj, ws = fused_inputs(fbatch, 100, 50, g, dev)
        args = (x, xj, fbatch.edge_dist_norm, fbatch.edge_dst, mv, *ws, n, 0.2)
        cot = torch.randn(n, 100, device=dev, generator=g)

        def cg(sp):
            return (FC.fused_cgconv(*args, single_pass=sp),
                    *FC.fused_cgconv_bwd(cot, *args, single_pass=sp))
        got = cg(True)
        if case == "sorted" and not all(
                torch.equal(a, b) for a, b in zip(got, cg(True))):
            failures.append("CGConv single-pass arm: two calls differ")
        ref = (FC.fused_cgconv_plain(*args, single_pass=True),
               *FC.fused_cgconv_bwd_plain(cot, *args, single_pass=True))
        # the forward, the edge rows' d_x and d_xj, the weight gradient's
        # eight blocks
        fused_case(f"CGConv, {case}", ["fused_cgconv_fwd_sp"]
                   + ["fused_cgconv_bwd_sp"] * 2
                   + ["fused_cgconv_wgrad_sp"] * 8,
                   got, ref, cg(False), (0, 1, 3), mv == 0, 2)
        h, xj, ws = cfconv_inputs(fbatch, 150, 50, g, dev)
        args = (xj, fbatch.edge_dist_norm, fbatch.edge_weight,
                fbatch.edge_dst, mv, *ws, n, 0.2, 8.0)
        cot = torch.randn(n, 150, device=dev, generator=g)

        def cf(sp):
            return (FS.fused_cfconv(*args, single_pass=sp),
                    *FS.fused_cfconv_bwd(cot, *args, single_pass=sp))
        got = cf(True)
        if case == "sorted" and not all(
                torch.equal(a, b) for a, b in zip(got, cf(True))):
            failures.append("cfconv single-pass arm: two calls differ")
        ref = (FS.fused_cfconv_plain(*args, single_pass=True),
               *FS.fused_cfconv_bwd_plain(cot, *args, single_pass=True))
        # the forward; d_xj and the weight gradients, which the f32 weight
        # gradient kernel forms from the arm's edge rows
        fused_case(f"cfconv, {case}", ["fused_cfconv_fwd_sp"]
                   + ["fused_cfconv_bwd_sp"] * 5,
                   got, ref, cf(False), (0, 1), mv == 0, 1)

    we, nw, tw = batch_edges(wbatch), wbatch.num_nodes, wbatch.window_size
    pad = we.dst < 0
    cdst, cmask, nc = cbatch.edge_dst, cbatch.edge_mask, cbatch.num_nodes
    for d in (1, 100):
        msg = torch.randn(we.dst.shape[0], d, device=dev, generator=g)
        w = torch.randn(we.dst.shape[0], device=dev, generator=g)
        msg[pad], w[pad] = float("nan"), float("nan")
        x = torch.randn(nw, d, device=dev, generator=g)
        cmsg = torch.randn(cdst.shape[0], d, device=dev, generator=g)
        cx = torch.randn(nc, d, device=dev, generator=g)
        sums = (("windowed_segment_sum_sp",
                 lambda sp: WO.segment_sum(msg, we, nw, tw, sp),
                 WO.segment_sum_plain(msg, we.dst, we.window_id, nw, tw,
                                      None, True)),
                ("windowed_spmm_sp",
                 lambda sp: WO.spmm(w, msg, we, nw, tw, sp),
                 WO.segment_sum_plain(msg, we.dst, we.window_id, nw, tw, w,
                                      True)),
                ("segment_sum_sp",
                 lambda sp: csr.segment_sum(cmsg, cdst, cmask, nc, sp),
                 csr.segment_sum_plain(cmsg, cdst, cmask, nc, True)))
        for key, fn, ref in sums:
            out = fn(True)
            try:
                err[key] = max(err[key], assert_sum(out, ref, f"{key}, D={d}"))
            except AssertionError as exc:
                failures.append(str(exc))
            if not torch.equal(out, fn(True)):
                failures.append(f"{key}, D={d}: two calls differ")
            mutant[f"{key}, D={d}"] = sum_share(fn(False), ref)
            if mutant[f"{key}, D={d}"] < SP_MUTATION:
                failures.append(f"{key}, D={d}: the f32 arm is within "
                                f"{SP_MUTATION}x the limit")
        gathers = (("windowed_gather_sp",
                    lambda sp: WO.gather(x, we, tw, sp),
                    WO.gather_plain(x, we.dst, we.window_id, tw, True)),
                   ("gather_sp", lambda sp: csr.gather(cx, cdst, cmask, sp),
                    csr.gather_plain(cx, cdst, cmask, True)))
        for key, fn, ref in gathers:
            if not torch.equal(fn(True), ref):
                failures.append(f"{key}, D={d}: not bit-exact")
            if torch.equal(fn(False), ref):
                failures.append(f"{key}, D={d}: the f32 arm equals the "
                                "single-pass twin")
        print(f"  single-pass check: windowed and CSR arms, D={d}: sums "
              f"within the f32 limit, bit-identical twice, gathers bit-exact;"
              f" the f32 arm's sums at " + ", ".join(
                  f"{mutant[f'{k}, D={d}']:.3g}x" for k, _, _ in sums)
              + " the limit, its gathers not bit-equal")
    if failures:
        raise AssertionError(f"{len(failures)} single-pass checks failed; "
                             f"the first: {failures[0]}")
    return err, mutant


def time_single_pass(fbatch, wbatch, cbatch, dev) -> dict:
    """Phase 22's times: each single-pass arm, its f32 arm in the same call,
    its plain twin and, where one PyTorch call computes the same function,
    that call on operands rounded beforehand (index_add_ over the rounded
    messages, index_select over the rounded rows; the fused arms have none),
    at the shapes of PERF.md's table: the fused arms at a training batch
    (CGConv D 100, De 50; cfconv F 150), the windowed arms at a GCN_demo
    windowed batch (the sum at D 1, the SpMM and gather at D 100), the CSR
    arms at a Predict batch (D 100). The bound is the f32 arm's: the arm
    reads the same f32 operands, moves the same bytes and does the same
    operations (on the tensor cores in 3xTF32 for the fused arms)."""
    from matdeeplearn_torch.ops import csr
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops import fused_cgconv as FC
    from matdeeplearn_torch.ops import windowed as WO

    g = torch.Generator(device=dev).manual_seed(23)
    rb = lambda t: t.to(torch.bfloat16).float()
    res = {}

    def row(key, arm, f32, plain, library, nbytes, flops, rate=F32_FLOPS,
            reps=100):
        res[key] = {"ms": device_ms(lambda: arm(), reps),
                    "f32_ms": device_ms(lambda: f32(), reps),
                    "plain_ms": device_ms(lambda: plain(), 10),
                    "library_ms": (None if library is None
                                   else device_ms(lambda: library(), reps)),
                    **bound(nbytes, flops, rate)}

    dst, mask, dist, n = (fbatch.edge_dst, fbatch.edge_mask,
                          fbatch.edge_dist_norm, fbatch.num_nodes)
    e = dst.shape[0]
    e_real = int((mask > 0).sum())
    d, de = 100, 50
    x, xj, ws = fused_inputs(fbatch, d, de, g, dev)
    cot = torch.randn(n, d, device=dev, generator=g)
    args = (x, xj, dist, dst, mask, *ws, n, 0.2)
    k, nb = 2 * d + de, 2 * d
    k1 = k + 1
    da = FC.fused_cgconv_bwd_rows(cot, *args, single_pass=True)[2]
    wg = (x, xj, dist, dst, mask, da, n, de, 0.2)
    partial, blocks = FC.fused_cgconv_wgrad(*wg, single_pass=True)
    row("fused_cgconv_fwd_sp",
        lambda: FC.fused_cgconv(*args, single_pass=True),
        lambda: FC.fused_cgconv(*args),
        lambda: FC.fused_cgconv_plain(*args, single_pass=True), None,
        4 * (2 * n * d + e_real * d + 3 * e + k1 * nb), 2 * e_real * k * nb,
        TF32X3_FLOPS)
    row("fused_cgconv_bwd_sp",
        lambda: FC.fused_cgconv_bwd_rows(cot, *args, single_pass=True),
        lambda: FC.fused_cgconv_bwd_rows(cot, *args),
        lambda: FC.bwd_rows_plain(cot, *args, single_pass=True), None,
        4 * (3 * n * d + e_real * d + 3 * e + k1 * nb + nb * nb + e * d
             + e_real * nb),
        2 * e_real * (k * nb + nb * nb), TF32X3_FLOPS)
    row("fused_cgconv_wgrad_sp",
        lambda: FC.fused_cgconv_wgrad(*wg, single_pass=True),
        lambda: FC.fused_cgconv_wgrad(*wg),
        lambda: FC.wgrad_partials_plain(*wg, blocks, single_pass=True), None,
        4 * (n * d + e_real * d + 3 * e + e_real * nb + partial.numel()),
        2 * e_real * k1 * nb, TF32X3_FLOPS)
    f = 150
    _, xj, ws = cfconv_inputs(fbatch, f, de, g, dev)
    cot = torch.randn(n, f, device=dev, generator=g)
    args = (xj, dist, fbatch.edge_weight, dst, mask, *ws, n, 0.2, 8.0)
    weights = (de + 1) * f + (f + 1) * f
    row("fused_cfconv_fwd_sp",
        lambda: FS.fused_cfconv(*args, single_pass=True),
        lambda: FS.fused_cfconv(*args),
        lambda: FS.fused_cfconv_plain(*args, single_pass=True), None,
        4 * (n * f + e_real * f + 4 * e + weights),
        2 * e_real * (de * f + f * f), TF32X3_FLOPS)
    row("fused_cfconv_bwd_sp",
        lambda: FS.fused_cfconv_bwd_rows(cot, *args, single_pass=True),
        lambda: FS.fused_cfconv_bwd_rows(cot, *args),
        lambda: FS.bwd_rows_plain(cot, *args, single_pass=True), None,
        4 * (n * f + e_real * f + 4 * e + weights + e * f + 3 * e_real * f),
        2 * e_real * (de * f + 2 * f * f), TF32X3_FLOPS)

    we, nw, tw = batch_edges(wbatch), wbatch.num_nodes, wbatch.window_size
    ew, t = we.dst.shape[0], we.window_id.shape[0]
    real = WO.slot_valid(we.dst, we.window_id, tw, nw)
    w_real = int(real.sum())
    rows = int(torch.unique(we.dst[real]).numel())
    dst_safe = torch.clamp(we.dst, min=0)
    layout_bytes = 4 * (ew + 2 * t)
    w = torch.rand(ew, device=dev, generator=g)
    for key, dd in (("windowed_segment_sum_sp", 1), ("windowed_spmm_sp", 100)):
        msg = torch.randn(ew, dd, device=dev, generator=g)
        acc = torch.zeros(nw, dd, device=dev)
        wv = None if key == "windowed_segment_sum_sp" else w
        scaled = msg if wv is None else msg * wv[:, None]
        msg_r = torch.where(real[:, None], rb(scaled), 0.0)
        row(key, lambda: WO._sum(msg, wv, we, nw, tw, key[:-3], True),
            lambda: WO._sum(msg, wv, we, nw, tw, key[:-3], False),
            lambda: WO.segment_sum_plain(msg, we.dst, we.window_id, nw, tw,
                                         wv, True),
            lambda: acc.index_add_(0, dst_safe, msg_r),
            4 * (w_real * (dd + (wv is not None)) + nw * dd) + layout_bytes,
            (1 + (wv is not None)) * w_real * dd)
        res[key]["d"] = dd
    xw = torch.randn(nw, 100, device=dev, generator=g)
    xw_r = rb(xw)
    row("windowed_gather_sp", lambda: WO.gather(xw, we, tw, True),
        lambda: WO.gather(xw, we, tw),
        lambda: WO.gather_plain(xw, we.dst, we.window_id, tw, True),
        lambda: torch.index_select(xw_r, 0, dst_safe),
        4 * (rows * 100 + ew * 100) + layout_bytes, 0)
    res["windowed_gather_sp"]["d"] = 100

    cdst, cmask, nc = cbatch.edge_dst, cbatch.edge_mask, cbatch.num_nodes
    ce = cdst.shape[0]
    c_real = int((cmask > 0).sum())
    c_rows = int(torch.unique(cdst[cmask > 0]).numel())
    cmsg = torch.randn(ce, 100, device=dev, generator=g)
    cx = torch.randn(nc, 100, device=dev, generator=g)
    cmsg_r, cx_r = rb(cmsg * cmask[:, None]), rb(cx)
    cacc = torch.zeros(nc, 100, device=dev)
    row("segment_sum_sp", lambda: csr.segment_sum(cmsg, cdst, cmask, nc, True),
        lambda: csr.segment_sum(cmsg, cdst, cmask, nc),
        lambda: csr.segment_sum_plain(cmsg, cdst, cmask, nc, True),
        lambda: cacc.index_add_(0, cdst, cmsg_r),
        4 * (c_real * 100 + 2 * ce + nc * 100), 2 * c_real * 100)
    row("gather_sp", lambda: csr.gather(cx, cdst, cmask, True),
        lambda: csr.gather(cx, cdst, cmask),
        lambda: csr.gather_plain(cx, cdst, cmask, True),
        lambda: torch.index_select(cx_r, 0, cdst),
        4 * (c_rows * 100 + 2 * ce + ce * 100), c_real * 100)
    return res


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
    wall, rows, _ = run_training_text(config)
    return wall, rows


def run_training_text(config) -> tuple[float, list, str]:
    """run_training, with the captured output as well. A card run must
    train on CUDA graphs (its resolved line says capture=graphs)."""
    wall, text = run_cli(config)
    if config["Job"]["device"] == "cuda" and "capture=graphs" not in text:
        raise AssertionError("a card Training run did not resolve to "
                             "capture=graphs")
    rows = [(int(m.group(1)), *(float(v) for v in m.groups()[1:]))
            for m in EPOCH_LINE.finditer(text)]
    if len(rows) != config["Models"]["epochs"]:
        raise AssertionError(f"expected {config['Models']['epochs']} epoch "
                             f"lines, got {len(rows)}")
    if not np.isfinite([r[2:4] for r in rows]).all():
        raise AssertionError(f"non-finite errors in {rows}")
    return wall, rows, text


def check_throughput(text: str) -> str:
    """The meter's line of a card Training run: edges/s > 0 and
    0 < MFU <= 100% (against the BF16 peak)."""
    lines = [ln for ln in text.splitlines() if ln.startswith("Throughput:")]
    if len(lines) != 1:
        raise AssertionError(f"expected one Throughput line, got {lines}")
    m = THROUGHPUT_LINE.search(lines[0])
    if m is None:
        raise AssertionError(f"the Throughput line reports no rates and no "
                             f"MFU: {lines[0]}")
    edges, mfu = float(m.group(1).replace(",", "")), float(m.group(2))
    if not (edges > 0 and 0 < mfu <= 100):
        raise AssertionError(f"edges/s {edges} and MFU {mfu}% out of range")
    return lines[0]


def throughput_line(text: str) -> str:
    """The meter's line of a Training run."""
    lines = [ln for ln in text.splitlines() if ln.startswith("Throughput:")]
    if len(lines) != 1:
        raise AssertionError(f"expected one Throughput line, got {lines}")
    return lines[0]


def warm_epoch_s(rows) -> float:
    """Mean time of the epochs after the first."""
    return float(np.mean([r[4] for r in rows[1:]]))


def profile_training(dataset, dev, model: dict = CGCNN_DEMO, top: int = 14,
                     kernel: str = "fused", capture=None) -> float | None:
    """One warm training epoch of `model` (kernel `kernel`; CUDA graphs,
    or the eager loop with capture=False) under torch.profiler: device time
    by kernel and the device's busy share of the wall time, which it
    returns (None: the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.training import jobs

    train_idx, val_idx, _ = split_data(dataset, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    run = jobs.setup_run(dataset, {**model, "kernel": kernel},
                         "l1_loss", seed=TRAIN_SEED, device=dev)
    kw = dict(train_idx=train_idx, val_idx=val_idx, epochs=1, verbosity=1,
              seed=TRAIN_SEED, capture=capture)
    jobs.run_fused_training(run, **kw)  # warm-up epoch (and the captures)
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
        return None
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    print(f"profiled warm {model['model']} training epoch (kernel {kernel}, "
          f"{model.get('batching', 'padded')} batches, "
          f"{'eager' if capture is False else 'CUDA graphs'}): "
          f"device busy "
          f"{busy_ms:.3f} ms of "
          f"{1e3 * wall:.3f} ms wall ({100 * busy_ms / (1e3 * wall):.1f}%); "
          f"top device time:")
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{key[:100]}")
    return busy_ms / (1e3 * wall)


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


def check_profile_trace(config, prof_dir: str, smi: str):
    """One Training run under --profile True: its trace must name the
    kernels that mdl_fused_cgconv_fwd, mdl_fused_cgconv_bwd and
    mdl_fused_cgconv_wgrad launch."""
    config["Job"].update(profile="True", profile_dir=prof_dir)
    wall, _ = run_training(config)
    path = os.path.join(prof_dir, "trace.json")
    with open(path) as f:
        names = [str(ev.get("name", "")) for ev in json.load(f)["traceEvents"]]
    counts = {k: sum(k in n for n in names) for k in PROFILED_KERNELS}
    print(f"--profile True on {smi}: {config['Models']['epochs']} epochs in "
          f"{wall:.3f} s wall, {path} ({os.path.getsize(path)} bytes, "
          f"{len(names)} events); kernel events {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"the --profile trace names no {missing}")


def train_from_checkpoint(dataset, dev, model: dict, init: str, epochs: int,
                          deterministic: bool, capture=None,
                          stream_depth: int | None = None):
    """jobs.run_fused_training of `model` (with its kernel, batching and
    remat) from the checkpoint `init` on TRAIN_SEED's split, verbosity 1,
    under torch.use_deterministic_algorithms when `deterministic`; returns
    (run, the per-epoch history as an array, the epoch lines' seconds, the
    run's output). stream_depth sets a streamed run's prefetch depth (0:
    assembled in the main thread)."""
    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.training import jobs
    from matdeeplearn_torch.training.checkpoint import load_checkpoint

    train_idx, val_idx, _ = split_data(dataset, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run = jobs.setup_run(dataset, model, "l1_loss", seed=TRAIN_SEED,
                                 device=dev)
            run.model.load_state_dict(load_checkpoint(init)[1])
            if stream_depth is not None:
                run.feed.depth = stream_depth
            _, _, hist = jobs.run_fused_training(
                run, train_idx=train_idx, val_idx=val_idx, epochs=epochs,
                verbosity=1, seed=TRAIN_SEED, capture=capture)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    text = buf.getvalue()
    secs = [float(m.group(5)) for m in EPOCH_LINE.finditer(text)]
    return run, np.array(hist), secs, text


def check_remat(cases, dataset, dev, smi: str) -> dict:
    """Each (label, demo, checkpoint, kernel, counters, forward key,
    launches of that key a block's forward) trained EPOCHS_REMAT epochs
    (jobs.run_fused_training, TRAIN_SEED's split) from one checkpoint with
    and without remat, twice: as the trainer runs (epoch times; the forward
    kernel's launches must grow by exactly the recomputed training
    forwards, per block x gc_count x steps x epochs), and under
    torch.use_deterministic_algorithms, where the per-epoch train errors
    must agree to rtol 1e-6. Without it, index_add_ (the x_j gathers'
    backward) adds in another order each run, and AdamW turns the rounding
    noise of the gradients that cancel behind BatchNorm into steps of the
    learning rate: two plain runs part by more than 1e-6 on their own
    (printed as the plain runs' gap). Returns label -> (worst relative gap
    under determinism, plain runs' gap, launches plain, launches remat,
    last epoch's s plain, with remat)."""
    from matdeeplearn_torch.data.dataset import split_data

    train_idx, _, _ = split_data(dataset, TRAINING["train_ratio"],
                                 TRAINING["val_ratio"], TRAINING["test_ratio"],
                                 TRAIN_SEED)

    def train(demo, init, kernel, remat, deterministic):
        run, hist, secs, _ = train_from_checkpoint(
            dataset, dev, {**demo, "kernel": kernel, "remat": remat}, init,
            EPOCHS_REMAT, deterministic)
        return hist[:, 0], secs[-1], run.kernel

    def rel_gap(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    out = {}
    for label, demo, init, kernel, counts, key, per_block in cases:
        launches, secs, errs = {}, {}, {}
        for remat in ("False", "True"):
            counts[key] = 0
            errs[remat], secs[remat], plan = train(demo, init, kernel, remat,
                                                   False)
            launches[remat] = counts[key]
        det = {remat: train(demo, init, kernel, remat, True)[0]
               for remat in ("False", "True")}
        gap = rel_gap(det["True"], det["False"])
        noise = rel_gap(errs["False"], det["False"])
        steps = -(-len(train_idx) // int(demo["batch_size"]))
        recomputed = per_block * demo["gc_count"] * steps * EPOCHS_REMAT
        n_p, n_r = launches["False"], launches["True"]
        print(f"remat {label} (kernel {plan}) on {smi}: deterministic train "
              f"errors {det['False'].tolist()} plain, {det['True'].tolist()} "
              f"remat, worst relative gap {gap:.3e} (rtol 1e-6; the plain "
              f"runs with and without determinism part by {noise:.3e}); "
              f"{key} launches {n_p} plain, {n_r} remat (+{n_r - n_p}, "
              f"expected +{recomputed}); epoch {EPOCHS_REMAT} "
              f"{secs['False']:.5f} s plain, {secs['True']:.5f} s remat")
        if not np.isfinite(det["False"]).all():
            raise AssertionError(f"remat {label}: non-finite train errors")
        np.testing.assert_allclose(det["True"], det["False"], rtol=1e-6)
        if n_r - n_p != recomputed:
            raise AssertionError(f"remat {label}: {key} launched {n_r - n_p} "
                                 f"more times, expected {recomputed}")
        out[label] = (gap, noise, n_p, n_r, secs["False"], secs["True"])
    return out


def check_capture(cases, dataset, dev, smi: str) -> dict:
    """Each (label, demo, checkpoint, kernel, batching) trained from its
    checkpoint on the trainer's CUDA graphs and on its eager loop
    (jobs.run_fused_training, capture None and False, TRAIN_SEED's split):

      * timed: EPOCHS_CAPTURE epochs each, the kernels' launch counters
        reset and the peak memory statistics reset just before; prints the
        warm epochs (the first holds the captures), the peak device memory
        (torch.cuda.max_memory_allocated) and the launches, which must be
        equal;
      * under torch.use_deterministic_algorithms, EPOCHS_CAPTURE_DET
        epochs each: the per-epoch train and val errors and rates must
        agree to rtol 1e-6 (the same operations in the same order) and the
        launches must be equal.

    Returns (label, kernel, batching) -> (warm epochs captured, eager,
    peak MiB captured, eager)."""
    import gc

    from matdeeplearn_torch.training.graphs import launch_counters

    counters = launch_counters()

    def train(demo, init, kernel, batching, capture, epochs, deterministic):
        gc.collect()  # the graphs and pools of the runs before
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*counters)
        _, hist, secs, text = train_from_checkpoint(
            dataset, dev, {**demo, "kernel": kernel, "batching": batching},
            init, epochs, deterministic, capture)
        if capture is None and "capture=graphs" not in text:
            raise AssertionError(f"{demo['model']} {kernel} {batching}: the "
                                 "run did not resolve to capture=graphs")
        launches = {k: v for c in counters for k, v in c.items() if v}
        return (hist, secs[1:], launches,
                torch.cuda.max_memory_allocated() / 2**20)

    out = {}
    for label, demo, init, kernel, batching in cases:
        timed = {mode: train(demo, init, kernel, batching, mode,
                             EPOCHS_CAPTURE, False) for mode in (False, None)}
        det = {mode: train(demo, init, kernel, batching, mode,
                           EPOCHS_CAPTURE_DET, True) for mode in (False, None)}
        (_, w_e, l_e, m_e), (_, w_g, l_g, m_g) = timed[False], timed[None]
        h_e, h_g = det[False][0], det[None][0]
        gap = float(np.max(np.abs(h_g - h_e) / np.abs(h_e)))
        print(f"captured {label} {kernel} {batching} on {smi}: warm epochs "
              f"{', '.join(f'{t:.5f}' for t in w_g)} s captured, "
              f"{', '.join(f'{t:.5f}' for t in w_e)} s eager "
              f"({np.mean(w_e) / np.mean(w_g):.2f}x); peak device memory "
              f"{m_g:.1f} MiB captured, {m_e:.1f} MiB eager; deterministic "
              f"train errors {h_g[:, 0].tolist()} captured, "
              f"{h_e[:, 0].tolist()} eager, worst relative gap {gap:.3e} "
              f"(rtol 1e-6); launches {l_g}")
        if not np.isfinite(h_e[:, :2]).all():
            raise AssertionError(f"captured {label} {kernel} {batching}: "
                                 "non-finite errors")
        np.testing.assert_allclose(h_g, h_e, rtol=1e-6)
        for what, (a, b) in (("timed", (l_g, l_e)),
                             ("deterministic", (det[None][2], det[False][2]))):
            if a != b:
                raise AssertionError(f"captured {label} {kernel} {batching} "
                                     f"({what}): launches {a} captured, {b} "
                                     "eager")
        out[(label, kernel, batching)] = (float(np.mean(w_g)),
                                          float(np.mean(w_e)), m_g, m_e)
    return out


def stream_processing(data_dir: str) -> dict:
    """Processing of a `dataset_type: large` run of phase 23: data_dir in
    shards of N_SHARD_GRAPHS graphs."""
    return {**PROCESSING, "data_path": data_dir, "dataset_type": "large",
            "large_shard_graphs": N_SHARD_GRAPHS}


def first_epoch_error(ds, device: str, model: dict, init: str,
                      kernel: str) -> tuple[float, float]:
    """(epoch 1's train error, wall seconds) of `model` under `kernel` from
    the checkpoint `init` on TRAIN_SEED's train split of `ds`, without the
    val split (which the train error does not read) and without the split
    outputs that a Training run writes after it."""
    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.training import jobs
    from matdeeplearn_torch.training.checkpoint import load_checkpoint

    train_idx, _, _ = split_data(ds, TRAINING["train_ratio"],
                                 TRAINING["val_ratio"],
                                 TRAINING["test_ratio"], TRAIN_SEED)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = jobs.setup_run(ds, {**model, "kernel": kernel}, "l1_loss",
                             seed=TRAIN_SEED, device=device)
        run.model.load_state_dict(load_checkpoint(init)[1])
        _, _, hist = jobs.run_fused_training(
            run, train_idx=train_idx, val_idx=np.array([], np.int64),
            epochs=1, verbosity=1, seed=TRAIN_SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    return float(hist[0][0]), time.perf_counter() - t0


def check_streaming(dataset, data_dir, mpnn_path, model_path, dev, smi,
                    m_warm, mem_peak_mib, resume) -> dict:
    """Phase 23: disk streaming (dataset_type large, data/streaming.py and
    training/stream.py) on the 1,000 structures in shards of
    N_SHARD_GRAPHS graphs, more shards than the LRU holds:

      a. the shard write (seconds, bytes on disk) and the bytes of one
         training batch over the link, wire against full, from the spec;
      b. MPNN_demo streamed through cli.run, EPOCHS_STREAM epochs, kernel
         auto (fused: the bilinear kernels over the reference edge order),
         the wire on, on CUDA graphs: each bilinear kernel >= epochs x
         train steps x gc_count launches, no CSR, CGConv, cfconv or
         windowed launch; the warm streamed epoch beside main path 5's
         in-memory one; the host's assembly per batch, wire and full; the
         busy share of a profiled warm streamed epoch; the peak device
         memory beside the in-memory run's; the Throughput line;
      c. card against CPU, the first epoch of MPNN_demo streamed on the
         first N_COMPARE_STREAM structures: rtol 1e-3, and under precision
         bf16 BF16_RTOL;
      d. CGCNN_demo streamed, kernel xla, the wire off, EPOCHS_STREAM_RACE
         epochs under deterministic algorithms, captured with the prefetch
         ring against eager with a synchronous assembler (depth 0): the
         per-epoch errors to rtol 1e-6;
      e. Predict on the streamed dataset from b's checkpoint against
         in-memory Predict from it: the wire off to rtol 1e-4 and atol
         1e-4, the wire on (f16 features and distances) to WIRE_RTOL; the
         largest gaps printed.

    Returns the bilinear kernels' launches of b and of e's streamed
    Predict."""
    import gc

    from matdeeplearn_torch.data.batching import BatchSpec
    from matdeeplearn_torch.data.dataset import get_dataset, split_data
    from matdeeplearn_torch.data.streaming import StreamingGraphDataset
    from matdeeplearn_torch.ops import fused_bilinear as FB
    from matdeeplearn_torch.training import jobs
    from matdeeplearn_torch.training import stream as ST
    from matdeeplearn_torch.training.graphs import launch_counters

    t_phase = time.perf_counter()
    counters = launch_counters()
    # ---- a. shards and link bytes
    t0 = time.perf_counter()
    sds = get_dataset(data_dir, 0, "False", stream_processing(data_dir))
    t_shard = time.perf_counter() - t0
    if not isinstance(sds, StreamingGraphDataset):
        raise AssertionError("dataset_type large gave no StreamingGraphDataset")
    disk = sum(os.path.getsize(os.path.join(sds.path, f))
               for f in os.listdir(sds.path))
    n_shards = int(sds._meta["num_shards"])
    if n_shards <= sds.cache_shards:
        raise AssertionError(f"{n_shards} shards fit the LRU's "
                             f"{sds.cache_shards}: no epoch would evict")
    bs = int(MPNN_DEMO["batch_size"])
    spec = BatchSpec.for_dataset(sds.node_counts(), sds.edge_counts(), bs,
                                 align=8, align_edges=8)
    link = {w: {k: t.nbytes for k, t in sds.buffers(spec, w).items()}
            for w in (True, False)}
    print(f"phase 23 shards: {len(sds)} structures in {n_shards} shards of "
          f"{N_SHARD_GRAPHS} (LRU {sds.cache_shards}), written in "
          f"{t_shard:.3f} s (the processed cache read included), {disk} bytes "
          f"on disk; a training batch (B={spec.num_graphs}, "
          f"N={spec.num_nodes}, E={spec.num_edges}) over the link: wire "
          f"{sum(link[True].values())} bytes (x {link[True]['x']}), full "
          f"{sum(link[False].values())} bytes (x {link[False]['x']})")

    # the host's assembly of one epoch's batches, shard reads included
    train_idx, val_idx, _ = split_data(sds, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    rows = list(ST._train_id_batches(sds, train_idx, bs, TRAIN_SEED + 1))
    assembly = {}
    for wire in (True, False):
        fresh = StreamingGraphDataset(sds.path)  # an empty LRU
        buf = fresh.buffers(spec, wire)
        fill = ST._assembler(fresh, spec, wire)
        t0 = time.perf_counter()
        for r in rows:
            fill(r, buf)
        assembly[wire] = 1e3 * (time.perf_counter() - t0) / len(rows)

    # ---- b. MPNN_demo streamed on CUDA graphs, through cli.run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*counters)
    ckpt = resume("mpnn_stream", mpnn_path)
    cfg = training_config(data_dir, ckpt, "chip_mpnn_stream", "cuda",
                          EPOCHS_STREAM, model=MPNN_DEMO)
    cfg["Processing"] = stream_processing(data_dir)
    wall, s_rows, text = run_training_text(cfg)
    peak = torch.cuda.max_memory_allocated() / 2**20
    launched = {k: v for c in counters for k, v in c.items() if v}
    train_launches = dict(FB.LAUNCHES)
    if "stream=y" not in text or "kernel=fused" not in text:
        raise AssertionError("the streamed MPNN run resolved to no "
                             "stream=y kernel=fused")
    need = EPOCHS_STREAM * len(rows) * MPNN_DEMO["gc_count"]
    for k, v in train_launches.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times in the streamed "
                                 f"MPNN Training, expected >= {need}")
    stray = {k: v for k, v in launched.items() if k not in FB.LAUNCHES}
    if stray:
        raise AssertionError(f"the streamed MPNN run launched {stray}")
    s_warm = warm_epoch_s(s_rows)
    thr = check_throughput(text)
    if not s_rows[-1][2] < s_rows[0][2]:
        raise AssertionError(f"the streamed MPNN train error did not fall: "
                             f"{s_rows[0][2]} -> {s_rows[-1][2]}")
    print(f"streamed MPNN Training on {smi}: {wall:.3f} s wall for "
          f"{EPOCHS_STREAM} epochs; epoch 1 (cold) {s_rows[0][4]:.5f} s, warm "
          f"epochs {s_warm:.5f} s against {m_warm:.5f} s in memory (main "
          f"path 5, {s_warm / m_warm:.2f}x); host assembly "
          f"{assembly[True]:.3f} ms a batch wire, {assembly[False]:.3f} ms "
          f"full; peak device memory {peak:.1f} MiB streamed, "
          f"{mem_peak_mib:.1f} MiB in memory (phase 14c); launches "
          f"{train_launches} (>= {need}); {thr}")
    busy = profile_training(sds, dev, MPNN_DEMO, kernel="auto")

    # ---- c. card against CPU on the first N_COMPARE_STREAM structures
    sub_dir = os.path.join(WORK, f"data_first{N_COMPARE_STREAM}")
    write_structures(sub_dir, n=N_COMPARE_STREAM)
    sub_sds = get_dataset(sub_dir, 0, "False", stream_processing(sub_dir))
    compare = {}
    for label, demo, rtol in (("f32", MPNN_DEMO, 1e-3),
                              ("bf16", MPNN_BF16, BF16_RTOL)):
        card, t_card = first_epoch_error(sub_sds, "cuda", demo, mpnn_path,
                                         "auto")
        cpu, t_cpu = first_epoch_error(sub_sds, "cpu", demo, mpnn_path,
                                       "fused")
        compare[label] = (card, cpu, abs(card - cpu) / abs(cpu))
        print(f"streamed MPNN {label} card vs CPU on the first "
              f"{N_COMPARE_STREAM} "
              f"structures: epoch 1 train error {card:.6f} vs {cpu:.6f}, "
              f"relative gap {compare[label][2]:.3e} (rtol {rtol:g}); "
              f"{t_card:.3f} s card, {t_cpu:.3f} s CPU (plain versions)")
        np.testing.assert_allclose(card, cpu, rtol=rtol)

    # ---- d. captured with the prefetch ring against eager, synchronous
    race = {}
    for capture, depth in ((None, 2), (False, 0)):
        _, hist, secs, text_d = train_from_checkpoint(
            sds, dev, {**CGCNN_DEMO, "kernel": "xla", "stream_wire": "False"},
            model_path, EPOCHS_STREAM_RACE, True, capture, stream_depth=depth)
        if capture is None and "capture=graphs" not in text_d:
            raise AssertionError("the streamed CGCNN run did not capture")
        race[depth] = (hist, secs)
    r_gap = float(np.max(np.abs(race[2][0] - race[0][0]) / np.abs(race[0][0])))
    print(f"streamed CGCNN (xla, wire off) on {smi} under deterministic "
          f"algorithms: train errors {race[2][0][:, 0].tolist()} captured "
          f"with the prefetch ring, {race[0][0][:, 0].tolist()} eager and "
          f"synchronous, worst relative gap {r_gap:.3e} (rtol 1e-6); epoch "
          f"seconds {race[2][1]} and {race[0][1]}")
    if not np.isfinite(race[0][0][:, :2]).all():
        raise AssertionError("streamed CGCNN: non-finite errors")
    np.testing.assert_allclose(race[2][0], race[0][0], rtol=1e-6)

    # ---- e. Predict on the stream from b's checkpoint against in memory
    reset_launches(*counters)
    pcfg = predict_config(data_dir, ckpt, "chip_mpnn_stream_predict", "cuda")
    pcfg["Processing"] = stream_processing(data_dir)
    p_wall, p_eval = run_predict(pcfg)
    predict_launches = dict(FB.LAUNCHES)
    stray = {k: v for c in counters for k, v in c.items()
             if v and k not in FB.LAUNCHES}
    p_steps = -(-len(sds) // 128)
    if predict_launches["fused_bilinear_fwd"] < 4 * p_steps or stray:
        raise AssertionError(f"streamed MPNN Predict launched "
                             f"{predict_launches}, others {stray}")
    run_predict(predict_config(data_dir, ckpt, "chip_mpnn_mem_predict",
                               "cuda"))
    ids_s, pred_s = read_predictions(
        "chip_mpnn_stream_predict_predicted_outputs.csv")
    ids_m, pred_m = read_predictions(
        "chip_mpnn_mem_predict_predicted_outputs.csv")
    if ids_s != ids_m or len(ids_s) != len(sds):
        raise AssertionError("streamed and in-memory Predict list different "
                             "ids")
    _, model = jobs.load_model_for_inference(sds, ckpt, dev)
    feed = jobs.predict_feed(sds, BatchSpec.for_dataset(
        sds.node_counts(), sds.edge_counts(), 128), dev, "MPNN", wire=False)
    _, pred_f, _ = ST.stream_evaluate(model, "l1_loss", feed,
                                      np.arange(len(sds)), out=True)
    top = float(np.abs(pred_m).max())
    gaps = {"wire": float(np.abs(pred_s - pred_m).max()),
            "full": float(np.abs(pred_f - pred_m).max())}
    print(f"streamed MPNN Predict on {smi}: {p_wall:.4f} s wall, "
          f"{p_eval:.5f} s evaluation, launches {predict_launches}; against "
          f"in-memory Predict: max |diff| {gaps['full']:.3e} wire off (rtol "
          f"1e-4, atol 1e-4), {gaps['wire']:.3e} wire on (rtol {WIRE_RTOL:g}, "
          f"atol {WIRE_RTOL:g} of max(1, {top:.3f})); predictions up to "
          f"{top:.3f}")
    np.testing.assert_allclose(pred_f, pred_m, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pred_s, pred_m, rtol=WIRE_RTOL,
                               atol=WIRE_RTOL * max(1.0, top))
    print(f"phase 23 (streaming) on {smi}: "
          f"{time.perf_counter() - t_phase:.1f} s wall; streamed MPNN warm "
          f"epoch {s_warm:.5f} s against {m_warm:.5f} s in memory, busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f}%")
          + " of a profiled warm streamed epoch")
    return {"MPNN streamed Training": train_launches,
            "MPNN streamed Predict": predict_launches}


def run_bench(smi: str) -> dict:
    """python -m matdeeplearn_torch.bench as a subprocess: its one JSON
    line, whose gate must pass."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "matdeeplearn_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    notes = [ln for ln in proc.stderr.splitlines()
             if ln.startswith(("meter:", "bulk", "warmup", "eager",
                               "s/epoch"))]
    print("\n".join(f"  bench: {ln}" for ln in notes))
    if proc.returncode != 0 or len(lines) != 1:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the bench exited {proc.returncode} with "
                             f"{len(lines)} stdout lines")
    out = json.loads(lines[0])
    print(f"bench (python -m matdeeplearn_torch.bench) on {smi}, "
          f"{wall:.1f} s wall:")
    print(lines[0])
    if out["mae_gate"] != "pass":
        raise AssertionError(f"the bench's MAE gate: {out['mae_gate']}")
    return out


def predict_gap_of(pred_g, pred_c) -> tuple[float, float]:
    """(largest |card - CPU| prediction gap, the largest |CPU prediction|)."""
    return (float(np.abs(pred_g - pred_c).max()),
            float(np.abs(pred_c).max()))


def read_predictions(path: str) -> tuple[list, np.ndarray]:
    with open(path) as f:
        lines = f.read().splitlines()[1:]
    ids = [ln.split(",")[0] for ln in lines]
    preds = np.array([float(ln.split(",")[-1]) for ln in lines])
    return ids, preds


def run_mode_config(run_mode: str, data_dir: str, job_name: str, device: str,
                    job: dict, models: dict, processing: dict | None = None
                    ) -> dict:
    """The config cli.load_config gives for `run_mode` (config.yml's Job
    section of that mode, RUN_MODE_JOBS, on one card: parallel False;
    updated by `job`), with this run's data, job name, device, verbosity 1
    and Models section `models`."""
    base = {**RUN_MODE_JOBS[run_mode]}
    if "parallel" in base:
        base["parallel"] = "False"
    return {"Job": {**base, **job, "run_mode": run_mode, "job_name": job_name,
                    "device": device},
            "Processing": {**PROCESSING, **(processing or {}),
                           "data_path": data_dir},
            "Training": {**TRAINING, "verbosity": 1}, "Models": models}


def epoch_seconds(text: str) -> list:
    """The seconds of every epoch line in a run's output."""
    return [float(m.group(5)) for m in EPOCH_LINE.finditer(text)]


def descriptor_checkpoint(dataset, demo: dict, path: str) -> str:
    """`demo` (SM or SOAP) from torch.Generator seed 0, saved with the
    port's checkpoint."""
    from matdeeplearn_torch.models import MODEL_FIELDS, build_model
    from matdeeplearn_torch.training.checkpoint import save_checkpoint

    name = demo["model"]
    model = build_model(name, dataset, demo,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    cfg = {k: v for k, v in demo.items() if k in MODEL_FIELDS[name]}
    cfg["output_dim"] = dataset.output_dim
    save_checkpoint(path, model.state_dict(), name, cfg)
    return path


def check_native_edges(data_dir: str, n_check: int) -> tuple[float, float]:
    """The native featurizer's edges against the numpy featurizer's on the
    first `n_check` structures of `data_dir` (indices exact, distances to
    1e-12); returns both featurizers' seconds over all the structures."""
    from matdeeplearn_torch.data import graphs as G
    from matdeeplearn_torch.data.native import featurize_structures
    from matdeeplearn_torch.data.structures import read_structure

    with open(os.path.join(data_dir, "targets.csv")) as f:
        ids = [ln.split(",")[0] for ln in f.read().splitlines() if ln]
    structs = [read_structure(os.path.join(data_dir, f"{i}.json"), "json", i)
               for i in ids]
    radius = float(PROCESSING["graph_max_radius"])
    nbrs = int(PROCESSING["graph_max_neighbors"])
    t0 = time.perf_counter()
    native = featurize_structures(structs, radius, nbrs)
    native_s = time.perf_counter() - t0
    if native is None:
        raise AssertionError("the native featurizer did not build or run")
    t0 = time.perf_counter()
    plain = [G.build_graph(s, radius, nbrs) for s in structs]
    numpy_s = time.perf_counter() - t0
    for i in range(n_check):
        src, dst, dist = plain[i]
        if not (np.array_equal(native[0][i], src)
                and np.array_equal(native[1][i], dst)):
            raise AssertionError(f"structure {ids[i]}: native edges differ "
                                 "from the numpy featurizer's")
        np.testing.assert_allclose(native[2][i], dist, rtol=0, atol=1e-12)
    return native_s, numpy_s


def check_descriptor_model(label, demo, data_dir, processing, smi,
                           extra_s: str = "") -> dict:
    """Phases 19a and 19b: `demo` processed with `processing` (which must
    print "Data processed (native)"), trained EPOCHS_CARD epochs on the
    card on CUDA graphs and EPOCHS_COMPARE on the CPU from one checkpoint
    (first-epoch train error to rtol 1e-4), then Predict on both from the
    card's checkpoint (largest gap <= 1e-4)."""
    from matdeeplearn_torch.data.dataset import get_dataset

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ds = get_dataset(data_dir, 0, "True",
                         {**PROCESSING, **processing, "data_path": data_dir})
    proc_s = time.perf_counter() - t0
    if "Data processed (native)" not in buf.getvalue():
        raise AssertionError(f"{label}: processing did not run the native "
                             "featurizer")
    key = demo["model"]
    width = ds.extra_features[key].shape[1]
    init = descriptor_checkpoint(ds, demo, os.path.join(WORK, f"{label}.ckpt"))
    rows = {}
    for device, epochs in (("cuda", EPOCHS_CARD), ("cpu", EPOCHS_COMPARE)):
        path = os.path.join(WORK, f"{label}_{device}.ckpt")
        shutil.copy(init, path)
        cfg = training_config(data_dir, path, f"chip_{label}_{device}",
                              device, epochs, model=demo)
        cfg["Processing"].update(processing)
        wall, rows[device], text = run_training_text(cfg)
        if device == "cuda":
            card_wall, card_text = wall, text
    np.testing.assert_allclose(rows["cuda"][0][2], rows["cpu"][0][2],
                               rtol=1e-4)
    preds = {}
    for device in ("cuda", "cpu"):
        cfg = predict_config(data_dir, os.path.join(WORK, f"{label}_cuda.ckpt"),
                             f"chip_{label}_pred_{device}", device)
        cfg["Processing"].update(processing)
        run_predict(cfg)
        preds[device] = read_predictions(
            f"chip_{label}_pred_{device}_predicted_outputs.csv")[1]
    if not (len(preds["cuda"]) == len(ds) and np.isfinite(preds["cuda"]).all()):
        raise AssertionError(f"{label} Predict: expected {len(ds)} finite "
                             "predictions")
    gap, top = predict_gap_of(preds["cuda"], preds["cpu"])
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], rtol=1e-4,
                               atol=1e-4)
    warm = warm_epoch_s(rows["cuda"])
    print(f"{label} on {smi}: {len(ds)} structures, descriptor width {width}, "
          f"processing {proc_s:.2f} s{extra_s}; Training {EPOCHS_CARD} epochs "
          f"in {card_wall:.3f} s wall, warm epochs {warm:.5f} s "
          f"({throughput_line(card_text)}); epoch 1 train error "
          f"{rows['cuda'][0][2]:.6f} card vs {rows['cpu'][0][2]:.6f} CPU "
          f"(rtol 1e-4), {rows['cuda'][0][2]:.5f} -> {rows['cuda'][-1][2]:.5f}"
          f"; Predict card vs CPU max |diff| {gap:.3e} of {top:.3f} "
          f"(rtol 1e-4, atol 1e-4)")
    return {"warm_s": warm, "wall_s": card_wall, "width": width,
            "predict_gap": gap}


def check_cv(dataset, data_dir, dev, smi, counters) -> dict:
    """Phase 19c: the CV run mode, then fold 1 reused against fresh."""
    from matdeeplearn_torch.data.dataset import split_data_CV
    from matdeeplearn_torch.training import graphs, jobs

    reset_launches(*counters)
    before = graphs.CAPTURES["graphs"]
    cfg = run_mode_config("CV", data_dir, "chip_cv", "cuda",
                          {"cv_folds": CV_FOLDS, "seed": TRAIN_SEED},
                          {**CGCNN_DEMO, "epochs": EPOCHS_AB,
                           "print_model": False})
    wall, text = run_cli(cfg)
    captures = graphs.CAPTURES["graphs"] - before
    launches = {k: v for c in counters for k, v in c.items() if v}
    folds = [float(m.group(1))
             for m in re.finditer(r"Fold \d+ test error: ([0-9.]+)", text)]
    secs = epoch_seconds(text)
    if len(folds) != CV_FOLDS or not np.isfinite(folds).all():
        raise AssertionError(f"CV: expected {CV_FOLDS} finite fold errors, "
                             f"got {folds}")
    if captures != 2:
        raise AssertionError(f"CV: {captures} graph captures, expected 2 "
                             "(fold 0's train step and epoch tail)")
    # fold 1 on a reused Run against a fresh Run, deterministic
    cv_idx = split_data_CV(dataset, CV_FOLDS, TRAIN_SEED)
    test1 = cv_idx[1]
    train1 = np.concatenate([cv_idx[j] for j in range(CV_FOLDS) if j != 1])
    train0 = np.concatenate([cv_idx[j] for j in range(CV_FOLDS) if j != 0])
    model = {**CGCNN_DEMO, "print_model": False}
    hist = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run = jobs.setup_run(dataset, model, "l1_loss", seed=TRAIN_SEED,
                                 device=dev)
            for k, idx in ((0, train0), (1, train1)):
                jobs.reset_run(run, TRAIN_SEED + k)
                _, _, h = jobs.run_fused_training(
                    run, train_idx=idx, val_idx=np.array([], np.int64),
                    epochs=EPOCHS_AB, verbosity=1, seed=TRAIN_SEED + k)
            hist["reused"] = np.array(h)
            fresh = jobs.setup_run(dataset, model, "l1_loss",
                                   seed=TRAIN_SEED + 1, device=dev)
            _, _, h = jobs.run_fused_training(
                fresh, train_idx=train1, val_idx=np.array([], np.int64),
                epochs=EPOCHS_AB, verbosity=1, seed=TRAIN_SEED + 1)
            hist["fresh"] = np.array(h)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = hist["reused"][:, 0], hist["fresh"][:, 0]
    gap = float(np.max(np.abs(a - b) / np.abs(b)))
    np.testing.assert_allclose(a, b, rtol=1e-6)
    warm = float(np.mean(secs[1:]))
    print(f"CV on {smi}: {CV_FOLDS} folds x {EPOCHS_AB} epochs of CGCNN_demo "
          f"in {wall:.3f} s wall, warm epochs {warm:.5f} s; fold errors "
          f"{folds}; graph captures {captures} (fold 0 only); launches "
          f"{launches}; deterministic fold 1 train errors reused "
          f"{a.tolist()} vs fresh {b.tolist()}, worst relative gap "
          f"{gap:.3e} (rtol 1e-6)")
    return {"warm_s": warm, "wall_s": wall, "launches": launches}


def check_repeat(data_dir, smi, counters) -> dict:
    """Phase 19d: the Repeat run mode."""
    from matdeeplearn_torch.training import graphs

    reset_launches(*counters)
    before = graphs.CAPTURES["graphs"]
    np.random.seed(TRAIN_SEED)  # the trials' seeds come from numpy's
    cfg = run_mode_config("Repeat", data_dir, "chip_repeat", "cuda",
                          {"repeat_trials": REPEAT_TRIALS},
                          {**CGCNN_DEMO, "epochs": EPOCHS_AB,
                           "print_model": False})
    wall, text = run_cli(cfg)
    captures = graphs.CAPTURES["graphs"] - before
    launches = {k: v for c in counters for k, v in c.items() if v}
    with open("chip_repeat_all_errorvalues.csv") as f:
        rows = [ln.split(",") for ln in f.read().splitlines()]
    heads = [r[0] for r in rows]
    want = ([""] + [f"Trial {t}" for t in range(REPEAT_TRIALS)]
            + ["Mean", "Std"])
    if heads != want:
        raise AssertionError(f"Repeat: the CSV's rows are {heads}")
    errs = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    if not np.isfinite(errs).all():
        raise AssertionError(f"Repeat: non-finite errors {errs}")
    if captures != 3:
        raise AssertionError(f"Repeat: {captures} graph captures, expected 3 "
                             "(trial 0's train step, eval step and tail)")
    secs = epoch_seconds(text)
    warm = float(np.mean(secs[1:]))
    print(f"Repeat on {smi}: {REPEAT_TRIALS} trials x {EPOCHS_AB} epochs of "
          f"CGCNN_demo in {wall:.3f} s wall, warm epochs {warm:.5f} s; "
          f"chip_repeat_all_errorvalues.csv trials "
          f"{errs[:REPEAT_TRIALS].tolist()}, mean {errs[-2].tolist()}; graph "
          f"captures {captures}; launches {launches}")
    return {"warm_s": warm, "wall_s": wall, "launches": launches}


def check_ensemble(data_dir, smi, counters) -> dict:
    """Phase 19e: the Ensemble run mode of CGCNN_demo and SchNet_demo."""
    reset_launches(*counters)
    models = {"CGCNN_demo": {**CGCNN_DEMO, "epochs": EPOCHS_AB,
                             "print_model": False},
              "SchNet_demo": {**SCHNET_DEMO, "epochs": EPOCHS_AB,
                              "print_model": False}}
    cfg = run_mode_config("Ensemble", data_dir, "chip_ensemble", "cuda",
                          {"ensemble_list": list(models), "seed": TRAIN_SEED},
                          models)
    wall, text = run_cli(cfg)
    launches = {k: v for c in counters for k, v in c.items() if v}
    with open("chip_ensemble_test_ensemble_outputs.csv") as f:
        lines = f.read().splitlines()
    if lines[0] != "ids,target,CGCNN_demo,SchNet_demo,ensemble":
        raise AssertionError(f"Ensemble: the CSV's header is {lines[0]}")
    vals = np.array([[float(v) for v in ln.split(",")[1:]] for ln in lines[1:]])
    t, members, ens = vals[:, 0], vals[:, 1:3], vals[:, 3]
    member_l1 = np.abs(members - t[:, None]).mean(axis=0)
    ens_l1 = float(np.abs(ens - t).mean())
    if not ens_l1 <= member_l1.mean() + 1e-9:
        raise AssertionError(f"Ensemble: L1 {ens_l1} above the members' mean "
                             f"{member_l1.mean()}")
    secs = epoch_seconds(text)
    warm = float(np.mean(secs[1:EPOCHS_AB] + secs[EPOCHS_AB + 1:]))
    print(f"Ensemble on {smi}: CGCNN_demo and SchNet_demo, {EPOCHS_AB} epochs "
          f"each, in {wall:.3f} s wall, warm epochs {warm:.5f} s; test L1 "
          f"members {member_l1.tolist()}, ensemble {ens_l1:.5f} (<= their "
          f"mean {member_l1.mean():.5f}); launches {launches}")
    return {"warm_s": warm, "wall_s": wall, "launches": launches}


def check_analysis(dataset, data_dir, trained, dev, smi, counters) -> dict:
    """Phase 19f: the Analysis mode's embeddings on the card against the
    CPU's, then the run mode itself."""
    from matdeeplearn_torch.training import jobs

    emb = {}
    for device in ("cpu", "cuda"):
        d = torch.device(device)
        meta, model = jobs.load_model_for_inference(dataset, trained, d)
        if device == "cuda":
            reset_launches(*counters)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb[device] = jobs.graph_embeddings(model, meta["model_name"],
                                            dataset, d)
        secs = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items() if v}
    if emb["cuda"].shape != (len(dataset), CGCNN_DEMO["dim1"]):
        raise AssertionError(f"Analysis: embeddings of shape "
                             f"{emb['cuda'].shape}")
    if not launches.get("gather") or not launches.get("segment_sum"):
        raise AssertionError(f"Analysis: the CSR kernels did not run: "
                             f"{launches}")
    top = float(np.abs(emb["cpu"]).max())
    gap = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    np.testing.assert_allclose(emb["cuda"], emb["cpu"], rtol=1e-4,
                               atol=1e-4 * top)
    cfg = run_mode_config("Analysis", data_dir, "chip_analysis", "cuda",
                          {"model_path": trained}, {})
    try:
        import sklearn  # noqa: F401
        have_sklearn = True
    except ImportError:
        have_sklearn = False
    t0 = time.perf_counter()
    if have_sklearn:
        run_cli(cfg)
        mode = "t-SNE ran (sklearn installed)"
    else:
        try:
            run_cli(cfg)
        except ImportError as e:
            if "scikit-learn" not in str(e):
                raise
            mode = f"raised ImportError naming scikit-learn ({e})"
        else:
            raise AssertionError("Analysis without sklearn did not raise")
    print(f"Analysis on {smi}: embeddings of {len(dataset)} structures "
          f"({emb['cuda'].shape[1]} wide) in {secs:.3f} s on the card, "
          f"launches {launches}; card vs CPU max |diff| {gap:.3e} of "
          f"{top:.3f} (rtol 1e-4); the run mode "
          f"{mode}, {time.perf_counter() - t0:.3f} s")
    return {"wall_s": secs, "launches": launches}


def check_hyperparameter(data_dir, smi, counters) -> dict:
    """Phase 19g: the Hyperparameter run mode, its memory from trial to
    trial, then its resume."""
    import gc

    from matdeeplearn_torch import cli
    from matdeeplearn_torch.training import hyper

    real = hyper.run_trial
    memory, peaks, trained = [], [], []

    def recording(*a, **k):
        torch.cuda.reset_peak_memory_stats()
        out = real(*a, **k)
        gc.collect()
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated() / 2**20)
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        trained.append(len(out[1]))
        return out

    cfg = run_mode_config("Hyperparameter", data_dir, "chip_hyper", "cuda",
                          {"hyper_trials": HYPER_TRIALS, "seed": TRAIN_SEED},
                          {**CGCNN_DEMO, "epochs": EPOCHS_HYPER,
                           "print_model": False})
    shutil.rmtree(os.path.join("results", "chip_hyper"), ignore_errors=True)
    hyper.run_trial = recording
    reset_launches(*counters)
    try:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.run(cfg)
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items() if v}
        text = buf.getvalue()
        n_first = len(memory)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.run(cfg)
    finally:
        hyper.run_trial = real
    vals = [float(m.group(1))
            for m in re.finditer(r"Trial \d+: val=([0-9.naN]+)", text)]
    if n_first != HYPER_TRIALS or len(vals) != HYPER_TRIALS:
        raise AssertionError(f"Hyperparameter: {n_first} trials ran, "
                             f"{len(vals)} reported")
    if len(memory) != n_first:
        raise AssertionError(f"Hyperparameter: the resumed sweep trained "
                             f"{len(memory) - n_first} trials, expected 0")
    if not os.path.exists("chip_hyper_optimized_hyperparameters.json"):
        raise AssertionError("Hyperparameter: no optimized hyperparameters")
    drift = memory[-1] - memory[0]
    if abs(drift) > HYPER_MEMORY_SLACK_MIB:
        raise AssertionError(f"Hyperparameter: device memory after trial "
                             f"{HYPER_TRIALS} is {memory[-1]:.1f} MiB, after "
                             f"trial 1 {memory[0]:.1f} MiB")
    secs = epoch_seconds(text)
    warm = [t for i, t in enumerate(secs) if i % EPOCHS_HYPER]
    print(f"Hyperparameter on {smi}: {HYPER_TRIALS} trials x {EPOCHS_HYPER} "
          f"epochs of CGCNN_demo's space in {wall:.3f} s wall, warm epochs "
          f"{float(np.mean(warm)):.5f} s on average; best vals {vals}; "
          f"device memory allocated after each trial "
          f"{[round(m, 1) for m in memory]} MiB (drift {drift:+.1f}, limit "
          f"{HYPER_MEMORY_SLACK_MIB}), peaks {[round(p, 1) for p in peaks]} "
          f"MiB; launches {launches}; the resumed call trained 0 trials")
    return {"warm_s": float(np.mean(warm)), "wall_s": wall,
            "launches": launches, "memory_mib": memory}


def check_run_modes(dataset, data_dir, trained, dev, smi, counters) -> dict:
    """Phase 19: the descriptor models and the run modes CV, Repeat,
    Ensemble, Analysis and Hyperparameter (the docstring's 19a-g)."""
    from matdeeplearn_torch.data import descriptors
    from matdeeplearn_torch.data.structures import read_structure
    from matdeeplearn_torch.data.synthetic import write_clusters

    t_all = time.perf_counter()
    out = {}
    native_s, numpy_s = check_native_edges(data_dir, N_NATIVE_CHECK)
    print(f"featurizers on the {N_STRUCTURES} periodic structures: native "
          f"{native_s:.3f} s, numpy {numpy_s:.3f} s (edges equal on the "
          f"first {N_NATIVE_CHECK})")
    out["SM"] = check_descriptor_model(
        "SM_demo", SM_DEMO, data_dir,
        {"SM_descriptor": "True", "processed_path": "processed_sm"}, smi,
        f" (native featurizer {native_s:.3f} s, numpy {numpy_s:.3f} s)")
    soap_dir = os.path.join(WORK, "clusters")
    write_clusters(soap_dir, N_STRUCTURES, seed=0)
    soap_proc = {"SOAP_descriptor": "True", "processed_path": "processed_soap"}
    structs = [read_structure(os.path.join(soap_dir, f"{i}.json"), "json",
                              str(i)) for i in range(N_STRUCTURES)]
    t0 = time.perf_counter()
    feats = descriptors.soap_features(
        structs, sorted({int(z) for s in structs for z in s.numbers}),
        rcut=PROCESSING["SOAP_rcut"], nmax=PROCESSING["SOAP_nmax"],
        lmax=PROCESSING["SOAP_lmax"], sigma=PROCESSING["SOAP_sigma"])
    soap_s = time.perf_counter() - t0
    out["SOAP"] = check_descriptor_model(
        "SOAP_demo", SOAP_DEMO, soap_dir, soap_proc, smi,
        f" (soap_features alone {soap_s:.3f} s, "
        f"{os.cpu_count()} host cores)")
    from matdeeplearn_torch.data.dataset import GraphDataset

    stored = GraphDataset.load(os.path.join(soap_dir, "processed_soap"))
    if not np.array_equal(stored.extra_features["SOAP"],
                          feats.astype(np.float32)):
        raise AssertionError("the processed SOAP descriptors differ from "
                             "soap_features'")
    out["CV"] = check_cv(dataset, data_dir, dev, smi, counters)
    out["Repeat"] = check_repeat(data_dir, smi, counters)
    out["Ensemble"] = check_ensemble(data_dir, smi, counters)
    out["Analysis"] = check_analysis(dataset, data_dir, trained, dev, smi,
                                     counters)
    out["Hyperparameter"] = check_hyperparameter(data_dir, smi, counters)
    print(f"phase 19 (descriptor models and run modes) on {smi}: "
          f"{time.perf_counter() - t_all:.1f} s wall")
    return out


# ---- phase 24: data and edge parallelism ---------------------------------


def free_port() -> int:
    """A localhost port nothing listens on (for a world's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p24_steps(dataset, demo: dict, init: str, rows, dp: int, dev,
              mesh=None) -> dict:
    """Two (len(rows)) training steps of `demo` from the checkpoint `init`
    on the id rows `rows` (dp·B ids each), under deterministic algorithms.
    With a mesh: the dp/ep step (parallel/spmd.py) of this process's part,
    the fused CGConv kernels' launches counted from 0 just before. Without
    one: the same arithmetic in this process, the collective's part done by
    hand: each replica's forward and backward of loss·count in turn (the
    gradients summed by autograd, the BatchNorm running statistics reset to
    the step's start for each replica and averaged after), the gradients
    divided by max(Σ count, 1), one optimizer step. Returns the step
    losses, the final state (on the CPU), the launches and the seconds."""
    from matdeeplearn_torch.data.batching import assemble
    from matdeeplearn_torch.ops import fused_cgconv as FC
    from matdeeplearn_torch.parallel import spmd
    from matdeeplearn_torch.training import jobs
    from matdeeplearn_torch.training.checkpoint import load_checkpoint
    from matdeeplearn_torch.training.train import get_loss

    loss_fn = get_loss("l1_loss")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run = jobs.setup_run(dataset, demo, "l1_loss", seed=TRAIN_SEED,
                                 device=dev, mesh=mesh)
        run.model.load_state_dict(load_checkpoint(init)[1])
        model, opt = run.model, run.optimizer
        reducer = None if mesh is None else spmd.StepReducer(model, run.mesh)
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        b = len(rows[0]) // dp
        reset_launches(FC.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for row in rows:
            if mesh is not None:
                loss, _ = spmd.train_batch(
                    model, opt, loss_fn,
                    spmd.local_batch(run.data, row, run.spec, run.mesh),
                    reducer)
                losses.append(loss)
                continue
            model.train()
            opt.zero_grad(set_to_none=True)
            start = [t.clone() for t in bufs]
            ends, lsum, count = [], 0.0, 0.0
            for r in range(dp):
                with torch.no_grad():
                    for t, s in zip(bufs, start):
                        t.copy_(s)
                batch = assemble(run.data, row[r * b:(r + 1) * b], run.spec)
                out = model(batch)
                c = torch.sum(batch.graph_mask)
                part = loss_fn(out, batch.y[:, 0], batch.graph_mask) * c
                part.backward()
                ends.append([t.clone() for t in bufs])
                lsum, count = lsum + part.detach(), count + c
            csum = torch.clamp(count, min=1.0)
            with torch.no_grad():
                for i, t in enumerate(bufs):
                    t.copy_(sum(e[i] for e in ends) / dp)
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad /= csum
            opt.step()
            losses.append(lsum / csum)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    resolved = [line for line in buf.getvalue().splitlines()
                if line.startswith("resolved:")]
    return {"losses": [float(v) for v in losses], "seconds": seconds,
            "state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "launches": dict(FC.LAUNCHES), "resolved": resolved[-1]}


def p24_worker(rank: int, world: int, port: int, backend: str, data_dir: str,
               parts: dict, out: str):
    """One rank of phase 24's world (spawned; `backend` gloo: every rank on
    card 0, NCCL: rank r on card r): joins the world, runs p24_steps with
    a mesh for each of `parts` ({name: (demo, init, rows, dp, ep)}) and
    saves {name: result} to out.<rank>."""
    import datetime

    import torch.distributed as dist

    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            dataset = get_dataset(data_dir, 0, "False",
                                  {**PROCESSING, "data_path": data_dir})
        res = {}
        for name, (demo, init, rows, dp, ep) in parts.items():
            mesh = make_mesh(dp=dp, ep=ep, device=dev)
            res[name] = p24_steps(dataset, demo, init, rows, dp, dev, mesh)
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def p24_world(backend: str, data_dir: str, parts: dict, out: str, world=2):
    """Start phase 24's world of `world` spawned ranks; returns them."""
    import multiprocessing

    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=p24_worker,
                         args=(r, world, port, backend, data_dir, parts, out))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def p24_results(procs, out: str, timeout: float = 300.0) -> list:
    """Each rank's results, once every rank exited 0 (else it raises)."""
    for p in procs:
        p.join(timeout)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
    if bad:
        raise RuntimeError(f"phase 24 ranks (rank, exit code) {bad} failed")
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(len(procs))]


def p24_gap(got: dict, want: dict) -> tuple[float, float]:
    """(largest |got - want| over all state entries relative to max(1,
    max|want entry|), largest relative step-loss gap)."""
    state = max(float((got["state"][k] - v).abs().max())
                / max(1.0, float(v.abs().max()))
                for k, v in want["state"].items())
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["losses"], want["losses"]))
    return state, loss


def check_parallel(dataset, data_dir: str, model_path: str, megnet_path: str,
                   dev, smi: str) -> dict:
    """Phase 24: data and edge parallelism (matdeeplearn_torch/parallel).

    (a) CGCNN_demo at full width (kernel auto: the fused CGConv kernels),
        BatchNorm on, a 2-rank world on this card under gloo with CUDA
        tensors: two dp steps (2 x 100 graphs a step) against p24_steps'
        two single-replica steps in this process, averaged by count on the
        card (the same kernels: to P24_EXACT of the state, loss and
        parameters) and with the kernels' plain versions on the CPU (step
        losses to P24_PLAIN); the ranks' fused launches;
    (b) MEGNet_demo at full width, ep 2 on that world (kernel auto under
        ep: xla on edge shards), BatchNorm on with the edge BatchNorms'
        statistics summed over ep: two steps against the single-card steps
        on the same batches (kernel xla): step losses to P24_EP_LOSS, the
        state to P24_EP_STATE (AdamW's noise steps, MEGNET_NOBN says why);
    (c) a 1-rank NCCL world in this process: jobs.train_regular on its
        mesh, on CUDA graphs with the step's all_reduce captured, 2 epochs
        from CGCNN_demo's checkpoint, against the mesh-less run, both
        deterministic: per-epoch train and val errors to P24_TRAIN_RTOL;
    (d) with two or more cards, (a) on NCCL across two of them.
    Prints each part's gaps and seconds; any miss raises after the prints."""
    import torch.distributed as dist

    from matdeeplearn_torch.data.dataset import split_data
    from matdeeplearn_torch.parallel.mesh import make_mesh
    from matdeeplearn_torch.training import graphs, jobs
    from matdeeplearn_torch.training import train as T

    t_phase = time.perf_counter()
    train_idx, val_idx, _ = split_data(dataset, TRAINING["train_ratio"],
                                       TRAINING["val_ratio"],
                                       TRAINING["test_ratio"], TRAIN_SEED)
    ids = T.epoch_id_matrix(train_idx, 2 * 100, True, TRAIN_SEED)
    rows_a = ids[:P24_STEPS]
    rows_b = ids[:P24_STEPS].reshape(-1, 100)[:P24_STEPS]
    out = os.path.join(WORK, "phase24")
    parts = {"a": (CGCNN_DEMO, model_path, rows_a, 2, 1),
             "b": (MEGNET_DEMO, megnet_path, rows_b, 1, 2)}
    procs = p24_world("gloo", data_dir, parts, out)
    # the references while the ranks run
    ref_a = p24_steps(dataset, CGCNN_DEMO, model_path, rows_a, 2, dev)
    cpu_a = p24_steps(dataset, {**CGCNN_DEMO, "kernel": "fused"}, model_path,
                      rows_a, 2, torch.device("cpu"))
    ref_b = p24_steps(dataset, {**MEGNET_DEMO, "kernel": "xla"}, megnet_path,
                      rows_b, 1, dev)
    ranks = p24_results(procs, out)
    fails = []
    for part, ref in (("a", ref_a), ("b", ref_b)):
        for r, res in enumerate(ranks):
            state, loss = p24_gap(res[part], ref)
            print(f"phase 24 ({part}) rank {r} on {smi}: {res[part]['resolved']}; "
                  f"losses {res[part]['losses']} against {ref['losses']}; "
                  f"state gap {state:.3g}, loss gap {loss:.3g} of the "
                  f"single-card steps; steps {res[part]['seconds']:.3f} s "
                  f"(single-card {ref['seconds']:.3f} s)")
            lim_s, lim_l = ((P24_EXACT, P24_EXACT) if part == "a"
                            else (P24_EP_STATE, P24_EP_LOSS))
            if state > lim_s or loss > lim_l:
                fails.append(f"({part}) rank {r}: state {state:.3g} (limit "
                             f"{lim_s}), loss {loss:.3g} (limit {lim_l})")
        for r, res in enumerate(ranks[1:], 1):
            if any(not torch.equal(v, ranks[0][part]["state"][k])
                   for k, v in res[part]["state"].items()):
                fails.append(f"({part}) rank {r}'s state differs from rank 0's")
    _, plain = p24_gap(ranks[0]["a"], cpu_a)
    print(f"phase 24 (a) on {smi}: dp step losses against the plain versions "
          f"on the CPU {cpu_a['losses']}: largest gap {plain:.3g} (limit "
          f"{P24_PLAIN})")
    if plain > P24_PLAIN:
        fails.append(f"(a) against the plain versions: {plain:.3g}")
    launches = {k: sum(res["a"]["launches"][k] for res in ranks)
                for k in ranks[0]["a"]["launches"]}
    print(f"phase 24 (a) fused CGConv launches in the dp steps, both ranks: "
          f"{launches}")
    if min(launches.values()) < 2 * P24_STEPS * CGCNN_DEMO["gc_count"]:
        fails.append(f"(a) fused kernels not launched in the dp step: "
                     f"{launches}")
    if "mesh=dp1xep2" not in ranks[0]["b"]["resolved"]:
        fails.append(f"(b) resolved {ranks[0]['b']['resolved']}")

    # (c) a 1-rank NCCL world: the captured step with its collective
    t_c = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh(device=dev)
        rows = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            before = graphs.CAPTURES["graphs"]
            torch.use_deterministic_algorithms(True, warn_only=True)
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    jobs.train_regular(
                        dataset, {"job_name": f"p24_{label}",
                                  "seed": TRAIN_SEED, "load_model": "True",
                                  "model_path": model_path,
                                  "save_model": "False",
                                  "write_output": "False"},
                        {**TRAINING, "verbosity": 1},
                        {**CGCNN_DEMO, "epochs": P24_EPOCHS}, device=dev,
                        mesh=m)
            finally:
                torch.use_deterministic_algorithms(False)
            text = buf.getvalue()
            rows[label] = np.array([[float(v) for v in mt.groups()[2:4]]
                                    for mt in EPOCH_LINE.finditer(text)])
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("resolved:"))
            captured = graphs.CAPTURES["graphs"] - before
            print(f"phase 24 (c) {label} on {smi}: {line}; {captured} graphs "
                  f"captured; (train, val) by epoch {rows[label].tolist()}")
            if "capture=graphs" not in line or captured < 2 or (
                    m is not None and "mesh=dp1xep1" not in line):
                fails.append(f"(c) {label}: {line}, {captured} captures")
        gap = float(np.max(np.abs(rows["mesh"] - rows["plain"])
                           / np.abs(rows["plain"])))
        print(f"phase 24 (c) on {smi}: NCCL world of 1, train_regular on its "
              f"mesh against the mesh-less run, largest relative gap {gap:.3g} "
              f"(limit {P24_TRAIN_RTOL}); {time.perf_counter() - t_c:.1f} s")
        if rows["mesh"].shape != (P24_EPOCHS, 2) or not gap <= P24_TRAIN_RTOL:
            fails.append(f"(c) gap {gap:.3g}")
    finally:
        dist.destroy_process_group()

    # (d) (a) on NCCL across two cards
    if torch.cuda.device_count() >= 2:
        out_d = os.path.join(WORK, "phase24_nccl")
        nccl = p24_results(p24_world("nccl", data_dir, {"a": parts["a"]},
                                     out_d), out_d)
        for r, res in enumerate(nccl):
            state, loss = p24_gap(res["a"], ref_a)
            print(f"phase 24 (d) rank {r} (card {r}, NCCL) on {smi}: state "
                  f"gap {state:.3g}, loss gap {loss:.3g}; steps "
                  f"{res['a']['seconds']:.3f} s")
            if state > P24_EXACT or loss > P24_EXACT:
                fails.append(f"(d) rank {r}: {state:.3g}, {loss:.3g}")
    else:
        print(f"phase 24 (d): {torch.cuda.device_count()} card visible; (a) "
              "on NCCL across cards did not run")
    print(f"phase 24 (parallelism) on {smi}: "
          f"{time.perf_counter() - t_phase:.1f} s wall")
    if fails:
        raise AssertionError("phase 24: " + "; ".join(fails))
    return launches



def first_graphs(ds, k: int):
    """The first k graphs of a GraphDataset, as one of their own."""
    from dataclasses import replace

    n1, e1 = int(ds.node_ptr[k]), int(ds.edge_ptr[k])
    return replace(
        ds, node_x=ds.node_x[:n1], node_z=ds.node_z[:n1],
        edge_src=ds.edge_src[:e1], edge_dst=ds.edge_dst[:e1],
        edge_weight=ds.edge_weight[:e1], edge_dist_norm=ds.edge_dist_norm[:e1],
        node_ptr=ds.node_ptr[:k + 1], edge_ptr=ds.edge_ptr[:k + 1],
        y=ds.y[:k], u=ds.u[:k], structure_ids=ds.structure_ids[:k],
        cache_dir=None)


def p25_plan(name: str) -> list:
    """The launch counters of the kernels a bench_bulk configuration's plan
    runs (training/jobs.py:resolve_kernel on a card): fused CGConv, cfconv
    or bilinear (MPNN's mean on the CSR sum, its backward the CSR gather),
    csr the CSR kernels (MEGNet on the dst order: the x[dst] gather and its
    backward; its src-side gathers and means plain), xla and the CGCNN
    streams none."""
    from matdeeplearn_torch import bench_bulk as BB
    from matdeeplearn_torch.ops import csr
    from matdeeplearn_torch.ops import fused_bilinear as FB
    from matdeeplearn_torch.ops import fused_cfconv as FS
    from matdeeplearn_torch.ops import fused_cgconv as FC

    extra, stream = BB.CONFIGS[name]
    kernel, model = extra["kernel"], extra.get("model", "CGCNN")
    if stream or kernel == "xla":
        return []
    if kernel == "csr":
        return [csr.LAUNCHES]
    return {"CGCNN": [FC.LAUNCHES], "SchNet": [FS.LAUNCHES],
            "MPNN": [FB.LAUNCHES, csr.LAUNCHES]}[model]


def check_bulk(dev, smi: str) -> dict:
    """Phase 25: the port's bench_bulk (matdeeplearn_torch/bench_bulk.py),
    in this process so that it reads the launch counters:

      a. its MP-skew corpus at N_BULK structures (seed 0), cached under
         build/chip_smoke/bench_bulk/: median, p95 and largest atoms, edges;
      b. each of P25_CONFIGS through bench_bulk.run_config (its batch rule
         at --batch 256, full widths, P25_EPOCHS warm and timed epochs on
         CUDA graphs, then on the eager loop), the counters reset just
         before: each kernel of the plan (p25_plan) launched at least
         gc_count x train steps x the epochs run, no other kernel; every
         number of the record finite and s/epoch > 0; device memory
         allocated after it within HYPER_MEMORY_SLACK_MIB of before (its
         Runs and graphs freed; from the second configuration on, as phase
         19g holds from its second trial); its peak memory printed;
      c. card against CPU (plain versions) for each of P25_COMPARE: the
         first epoch's train error from one initial state on the corpus'
         first P25_COMPARE_N structures (MPNN: P25_MPNN_COMPARE_N) at
         batch P25_COMPARE_BATCH, all of them in the train split, rtol
         1e-3; MEGNet without BatchNorm (MEGNET_NOBN says why); the stream
         on shards of P25_SHARD_GRAPHS.

    Every check is printed before a miss raises. Returns each
    configuration's launches by kernel name, for the kernels line."""
    import gc

    from matdeeplearn_torch import bench_bulk as BB
    from matdeeplearn_torch.data.streaming import load_or_create_sharded
    from matdeeplearn_torch.training import jobs
    from matdeeplearn_torch.training.graphs import launch_counters

    t_phase = time.perf_counter()
    BB.CACHE = os.path.join(WORK, "bench_bulk")
    counters = launch_counters()
    fails = []
    # ---- a. the corpus
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        ds = BB.build_corpus(N_BULK)
    nc, ec = ds.node_counts(), ds.edge_counts()
    print(f"phase 25 corpus (bench_bulk.build_corpus, n {N_BULK}, seed 0): "
          f"built in {time.perf_counter() - t0:.2f} s; atoms median "
          f"{np.median(nc):.0f}, p95 {np.percentile(nc, 95):.0f}, max "
          f"{nc.max()}; {int(nc.sum())} atoms, {int(ec.sum())} edges "
          f"({ec.mean():.1f} a structure)")
    tr, va = BB.split(len(ds))

    # ---- b. the configurations
    epochs_run = 4 * P25_EPOCHS  # warm and timed, captured and eager
    launches = {}
    for name in P25_CONFIGS:
        extra, stream, batch, label = BB.config(name, 256)
        sdir = (os.path.join(BB.CACHE, f"shards_{N_BULK}") if stream
                else None)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        reset_launches(*counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rec = BB.run_config(label, ds, extra, tr, va, batch, P25_EPOCHS,
                                dev, stream_dir=sdir)
        wall = time.perf_counter() - t0
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        plan = p25_plan(name)
        launched = {k: v for c in plan for k, v in c.items()}
        stray = {k: v for c in counters if not any(c is p for p in plan)
                 for k, v in c.items() if v}
        need = int(BB.MODEL["gc_count"]) * rec["steps_per_epoch"] * epochs_run
        launches[name] = launched
        numbers = [v for k, v in rec.items() if not isinstance(v, str)]
        grew = (after - before) / 2**20
        print(f"phase 25 {name} ({label}, kernel_mode {rec['kernel_mode']}) "
              f"on {smi}: {rec['s_per_epoch']:.5f} s/epoch captured, "
              f"{rec['s_per_epoch_eager']:.5f} eager, "
              f"{rec['steps_per_epoch']} steps, {rec['step_ms']:.3f} "
              f"ms/step, {rec['edges_per_s_per_chip']} edges/s, MFU "
              f"{rec.get('mfu_pct')}%, HBM {rec.get('hbm_util_pct')}%"
              + (f", assembly {rec['stream_assembly_ms_per_batch']:.3f} ms a "
                 "batch" if stream else "")
              + f"; peak {rec['peak_mem_mib']:.1f} MiB, allocated "
              f"{before / 2**20:.1f} -> {after / 2**20:.1f} MiB; launches "
              f"{launched} (each >= {need}), others {stray}; {wall:.1f} s")
        if any(v < need for v in launched.values()) or stray:
            fails.append(f"{name}: launches {launched} (>= {need}), "
                         f"others {stray}")
        if not (np.isfinite(numbers).all() and rec["s_per_epoch"] > 0):
            fails.append(f"{name}: record {rec}")
        # the first configuration may leave the process's one-time state
        # (the trainer's stream and its cuBLAS workspace), as phase 19g's
        # first trial does: the rule holds from the second on
        if name != P25_CONFIGS[0] and abs(grew) > HYPER_MEMORY_SLACK_MIB:
            fails.append(f"{name}: device memory grew {grew:.1f} MiB")

    # ---- c. card against CPU
    for name in P25_COMPARE:
        extra, stream, _, label = BB.config(name, P25_COMPARE_BATCH)
        mp = {**BB.MODEL, "batch_size": P25_COMPARE_BATCH, "epochs": 1,
              **extra}
        if mp["model"] == "MEGNet":
            mp["batch_norm"] = "False"
        k = P25_MPNN_COMPARE_N if mp["model"] == "MPNN" else P25_COMPARE_N
        data = first_graphs(ds, k)
        if stream:
            data = load_or_create_sharded(
                data, os.path.join(BB.CACHE, f"shards_first{k}"),
                graphs_per_shard=P25_SHARD_GRAPHS)
        errs, secs, init = {}, {}, None
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run = jobs.setup_run(data, mp, "l1_loss", seed=TRAIN_SEED,
                                     device=device)
                if init is None:
                    init = {n: v.detach().cpu().clone()
                            for n, v in run.model.state_dict().items()}
                else:
                    run.model.load_state_dict(init)
                _, _, hist = jobs.run_fused_training(
                    run, train_idx=np.arange(k), val_idx=np.array([], np.int64),
                    epochs=1, verbosity=1, seed=TRAIN_SEED)
            if device == "cuda":
                torch.cuda.synchronize()
            errs[device] = float(hist[0][0])
            secs[device] = time.perf_counter() - t0
            del run
        gap = abs(errs["cuda"] - errs["cpu"]) / abs(errs["cpu"])
        print(f"phase 25 (c) {name} ({label}) card vs CPU on the first {k} "
              f"structures at batch {P25_COMPARE_BATCH}: epoch 1 train error "
              f"{errs['cuda']:.6f} vs {errs['cpu']:.6f}, relative gap "
              f"{gap:.3e} (rtol 1e-3); {secs['cuda']:.2f} s card, "
              f"{secs['cpu']:.2f} s CPU")
        if not (np.isfinite(list(errs.values())).all() and gap <= 1e-3):
            fails.append(f"(c) {name}: {errs}")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 25 (bench_bulk) on {smi}: "
          f"{time.perf_counter() - t_phase:.1f} s wall")
    if fails:
        raise AssertionError("phase 25: " + "; ".join(fails))
    return launches


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  WindowedDeviceData, assemble,
                                                  assemble_batch,
                                                  packed_id_matrix,
                                                  packed_steps)
    from matdeeplearn_torch.data.dataset import (get_dataset, split_data,
                                                 windowed_layout)
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("TF32 off for matmul and cuDNN (full f32); bf16 GEMMs reduce in "
          "f32")
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
    megnet_path = initial_checkpoint(MEGNET_DEMO,
                                     os.path.join(WORK, "megnet_demo.ckpt"))
    megnet_nobn_path = initial_checkpoint(
        MEGNET_NOBN, os.path.join(WORK, "megnet_demo_nobn.ckpt"))

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

    # ---- CSR kernels at a src-sorted MEGNet_demo training batch -----------
    train_bs = CGCNN_DEMO["batch_size"]
    tspec = BatchSpec.for_dataset(dataset.node_counts(), dataset.edge_counts(),
                                  train_bs)
    sdata = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="src")
    sbatch = assemble_batch(sdata, np.arange(train_bs, dtype=np.int32), tspec)
    print(f"src kernel checks on {card} (MEGNet_demo training batch, "
          f"edge_order src: B={tspec.num_graphs}, N={tspec.num_nodes}, "
          f"E={tspec.num_edges}, D=100):")
    serr, scases = check_src_kernels(sbatch, dev)
    for k, v in serr.items():
        err[k] = max(err[k], v)
    src_times = []
    for name, idx, n in scases:
        st, se_real = time_kernels(idx, sbatch.edge_mask, n, dev)
        for k, t in st.items():
            src_times.append({"kernel": k, "index": name, "n": n, **t})
            print(f"{k} on {smi}, index {name}, E={tspec.num_edges} ({se_real} "
                  f"real), n={n}, D=100: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{100 * t['bound_ms'] / t['ms']:.1f}% of it)")
    del sdata, sbatch

    # ---- fused CGConv kernels at a training batch's shapes ----------------
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
    print(f"bilinear bf16 arm checks on {card} (the same training batch):")
    bf16_err, bf16_mutant = check_bilinear_bf16(tbatch, dev)
    err.update(bf16_err)
    b16times, _ = time_bilinear_bf16(tbatch, dev)
    times.update(b16times)
    for k, t in b16times.items():
        f32k = k[:-len("_bf16")]
        t["f32_ms"] = btimes[f32k]["ms"]
        parts = "".join(f", {n} {v:.4f} ms" for n, v in
                        t.get("parts_ms", {}).items())
        print(f"{k} on {smi}, E={tspec.num_edges} ({be_real} real), "
              f"D=H=K=100: kernel {t['ms']:.4f} ms (the f32 arm "
              f"{btimes[f32k]['ms']:.4f} ms{parts}), plain "
              f"{t['plain_ms']:.4f} ms, library (bf16 einsum) "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']} at the BF16 rate, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it)")
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
    predict_gap = {"CGCNN": predict_gap_of(pred_g, pred_c)}
    print(f"card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- main path 2: Training on the card, then on the CPU ---------------
    def resume_from_init(name, init=model_path):
        path = os.path.join(WORK, f"{name}.ckpt")
        shutil.copy(init, path)
        return path

    def compare_with_cpu(label, data, demo, init, kernel, card_rows=None):
        """The first epoch's train error of `demo` on the card (card_rows,
        or a run of EPOCHS_COMPARE epochs under kernel auto) against
        EPOCHS_COMPARE epochs on the CPU under `kernel` (plain versions),
        from one checkpoint: rtol 1e-3. Returns (card, CPU)."""
        if card_rows is None:
            _, card_rows = run_training(training_config(
                data, resume_from_init(f"{label}_cmp_gpu", init),
                f"chip_{label}_cmp_gpu", "cuda", EPOCHS_COMPARE, model=demo))
        cpu_wall, cpu_rows = run_training(training_config(
            data, resume_from_init(f"{label}_cmp_cpu", init),
            f"chip_{label}_cmp_cpu", "cpu", EPOCHS_COMPARE, kernel,
            model=demo))
        print(f"{label} Training on the CPU (plain versions): {cpu_wall:.3f} s "
              f"wall, the epoch {cpu_rows[0][4]:.3f} s")
        np.testing.assert_allclose(card_rows[0][2], cpu_rows[0][2], rtol=1e-3)
        return card_rows[0][2], cpu_rows[0][2]

    n_train = int(len(dataset) * TRAINING["train_ratio"])
    train_steps = -(-n_train // train_bs)
    gpu_train = resume_from_init("train_gpu")
    reset_launches(*all_counts)
    wall, card_rows, train_text = run_training_text(training_config(
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
    print(f"throughput meter of that run on {smi} (MFU against the BF16 "
          f"peak): {check_throughput(train_text)}")
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
          f"{cpu_rows[0][2]:.5f} (rtol 1e-3); the card's train error "
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
    busy = {}

    def profile_both(label, model=CGCNN_DEMO, kernel="fused"):
        """A profiled warm epoch on CUDA graphs and one eager: the busy
        shares (label -> (captured, eager))."""
        busy[label] = tuple(profile_training(dataset, dev, model,
                                             kernel=kernel, capture=c)
                            for c in (None, False))

    profile_both("CGCNN fused")
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
          f"{s_cpu_rows[0][2]:.5f} (rtol 1e-3); the card's train error "
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
    predict_gap["SchNet"] = predict_gap_of(pred_g, pred_c)
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
    profile_both("SchNet fused", SCHNET_DEMO)

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
    sub_dir = os.path.join(WORK, f"data_first{N_COMPARE}")
    write_structures(sub_dir, n=N_COMPARE)
    # the CPU side trains its first epoch alone (first_epoch_error: no val
    # split, no split outputs), the plain versions' cost a minute each
    sub = {}
    sub_wall, rows = run_training(training_config(
        sub_dir, resume_from_init("mpnn_first_cuda", mpnn_path),
        "chip_mpnn_first_cuda", "cuda", EPOCHS_COMPARE, "fused",
        model=MPNN_DEMO))
    sub["cuda"] = rows[0][2]
    print(f"MPNN Training on the first {N_COMPARE} structures, the card: "
          f"{sub_wall:.3f} s wall, the epoch {rows[0][4]:.3f} s")
    sub_ds = get_dataset(sub_dir, 0, "False",
                         {**PROCESSING, "data_path": sub_dir})
    sub["cpu"], sub_wall = first_epoch_error(sub_ds, "cpu", MPNN_DEMO,
                                             mpnn_path, "fused")
    print(f"MPNN Training on the first {N_COMPARE} structures, the CPU "
          f"(plain versions): the epoch {sub_wall:.3f} s")
    np.testing.assert_allclose(sub["cuda"], sub["cpu"], rtol=1e-3)
    print(f"MPNN card vs CPU on the first {N_COMPARE} structures: epoch 1 "
          f"train error {sub['cuda']:.5f} vs {sub['cpu']:.5f} "
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
    _, pred_g = read_predictions("chip_mpnn_predict_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"MPNN Predict: expected {N_STRUCTURES} finite "
                             f"predictions")
    # card against CPU on the first N_COMPARE structures (a plain Predict
    # over all 1,000 takes over a minute on the card's host)
    run_predict(predict_config(sub_dir, gpu_mpnn, "chip_mpnn_predict_sub",
                               "cuda"))
    m_cpu_wall, _ = run_predict(predict_config(
        sub_dir, gpu_mpnn, "chip_mpnn_predict_cpu", "cpu"))
    print(f"MPNN Predict on the CPU (plain versions), the first {N_COMPARE} "
          f"structures: {m_cpu_wall:.3f} s wall")
    ids_g, pred_g = read_predictions(
        "chip_mpnn_predict_sub_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_mpnn_predict_cpu_predicted_outputs.csv")
    if ids_g != ids_c:
        raise AssertionError("MPNN card and CPU predictions list different ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    predict_gap["MPNN"] = predict_gap_of(pred_g, pred_c)
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
    profile_both("MPNN fused", MPNN_DEMO)

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
          f"{g_cpu_rows[0][2]:.5f} (rtol 1e-3); the card's train error "
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
    predict_gap["GCN"] = predict_gap_of(pred_g, pred_c)
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
    profile_both("GCN pallas", GCN_DEMO, "pallas")

    # ---- main path 9: MEGNet_demo Training (kernel auto: csr, src order) --
    gpu_megnet = resume_from_init("megnet_gpu", megnet_path)
    reset_launches(*all_counts)
    wall, mg_rows, mg_text = run_training_text(training_config(
        data_dir, gpu_megnet, "chip_megnet_gpu", "cuda", EPOCHS_CARD,
        model=MEGNET_DEMO))
    if "kernel=csr(src)" not in mg_text:
        raise AssertionError("MEGNet Training did not resolve to csr(src)")
    megnet_launches = dict(csr.LAUNCHES)
    print(f"launches in one MEGNet Training run of {EPOCHS_CARD} epochs "
          f"(kernel auto: csr, src order): {megnet_launches}")
    # a block a step: 2 gathers and 1 sum forward, 1 gather and 2 sums back
    mg_need = 3 * MEGNET_DEMO["gc_count"] * train_steps * EPOCHS_CARD
    for k, v in megnet_launches.items():
        if v < mg_need:
            raise AssertionError(f"{k} launched {v} times in MEGNet Training, "
                                 f"expected >= {mg_need}")
    mg_warm = warm_epoch_s(mg_rows)
    print(f"MEGNet Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} "
          f"epochs; epoch 1 (cold) {mg_rows[0][4]:.5f} s, warm epochs "
          f"{mg_warm:.5f} s on average ({n_train / mg_warm:.1f} train graphs/s)")
    if not mg_rows[-1][2] < mg_rows[0][2]:
        raise AssertionError(f"the card's MEGNet train error did not fall: "
                             f"{mg_rows[0][2]} -> {mg_rows[-1][2]}")
    mg_cmp = compare_with_cpu("MEGNet", data_dir, MEGNET_NOBN,
                              megnet_nobn_path, "csr")
    print(f"MEGNet card vs CPU (without BatchNorm; all {N_STRUCTURES} "
          f"structures): epoch 1 train error {mg_cmp[0]:.5f} vs "
          f"{mg_cmp[1]:.5f} (rtol 1e-3); the card's train error with it "
          f"{mg_rows[0][2]:.5f} -> {mg_rows[-1][2]:.5f}")

    # ---- main path 10: MEGNet_demo Predict on the card, then the CPU ------
    reset_launches(*all_counts)
    mg_wall, mg_eval = run_predict(predict_config(
        data_dir, gpu_megnet, "chip_megnet_predict", "cuda"))
    mg_predict_launches = dict(csr.LAUNCHES)
    print(f"launches in one MEGNet Predict: {mg_predict_launches}")
    want = {"gather": 2 * MEGNET_DEMO["gc_count"] * steps,
            "segment_sum": (MEGNET_DEMO["gc_count"] + 1) * steps}
    for k, v in want.items():
        if mg_predict_launches[k] < v:
            raise AssertionError(f"{k} launched {mg_predict_launches[k]} times "
                                 f"in MEGNet Predict, expected >= {v}")
    mg_warm_wall, mg_warm_eval = run_predict(predict_config(
        data_dir, gpu_megnet, "chip_megnet_predict", "cuda"))
    print(f"MEGNet Predict on {smi}: cold {mg_wall:.4f} s wall, {mg_eval:.5f} "
          f"s evaluation; warm {mg_warm_wall:.4f} s wall, {mg_warm_eval:.5f} s "
          f"evaluation ({len(dataset) / mg_warm_eval:.1f} graphs/s)")
    profile_predict(predict_config(data_dir, gpu_megnet, "chip_megnet_predict",
                                   "cuda"), "MEGNet")
    mg_cpu_wall, _ = run_predict(predict_config(
        data_dir, gpu_megnet, "chip_megnet_predict_cpu", "cpu"))
    print(f"MEGNet Predict on the CPU (plain versions): {mg_cpu_wall:.3f} s "
          f"wall")
    ids_g, pred_g = read_predictions("chip_megnet_predict_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_megnet_predict_cpu_predicted_outputs.csv")
    if len(pred_g) != N_STRUCTURES or not np.isfinite(pred_g).all():
        raise AssertionError(f"MEGNet Predict: expected {N_STRUCTURES} finite "
                             f"predictions")
    if ids_g != ids_c:
        raise AssertionError("MEGNet card and CPU predictions list different "
                             "ids")
    np.testing.assert_allclose(pred_g, pred_c, rtol=1e-4, atol=1e-4)
    predict_gap["MEGNet"] = predict_gap_of(pred_g, pred_c)
    print(f"MEGNet card vs CPU predictions: max |diff| "
          f"{float(np.abs(pred_g - pred_c).max()):.3e} (rtol 1e-4, atol 1e-4)")

    # ---- MEGNet: kernels xla, csr and pallas, then a profiled csr epoch ---
    mg_ab = {}
    for kernel in ("xla", "csr", "pallas"):
        _, rows = run_training(training_config(
            data_dir, resume_from_init(f"megnet_{kernel}", megnet_path),
            f"chip_megnet_ab_{kernel}", "cuda", EPOCHS_AB, kernel,
            model=MEGNET_DEMO))
        mg_ab[kernel] = warm_epoch_s(rows)
    print(f"MEGNet warm epoch on {smi}: kernel xla {mg_ab['xla']:.5f} s, "
          f"kernel csr {mg_ab['csr']:.5f} s, kernel pallas "
          f"{mg_ab['pallas']:.5f} s (main path: {mg_warm:.5f} s)")
    profile_both("MEGNet csr", MEGNET_DEMO, "csr")

    # ---- main path 11: packed batching, CGCNN_demo and MEGNet_demo --------
    train_idx, _, _ = split_data(dataset, TRAINING["train_ratio"],
                                 TRAINING["val_ratio"], TRAINING["test_ratio"],
                                 TRAIN_SEED)
    nc, ec = dataset.node_counts(), dataset.edge_counts()
    pspec = BatchSpec.packed_for_dataset(nc, ec, train_bs)
    p_steps = packed_steps(train_idx, nc, ec, pspec, train_bs)
    t0 = time.perf_counter()
    packed_id_matrix(train_idx, nc, ec, pspec, train_bs, True, TRAIN_SEED)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    print(f"packed spec (batch {train_bs}): {pspec.num_graphs} graph slots, "
          f"{pspec.num_nodes} nodes, {pspec.num_edges} edges, {p_steps} steps "
          f"an epoch; padded: {tspec.num_graphs} / {tspec.num_nodes} / "
          f"{tspec.num_edges}, {train_steps} steps; one epoch's bins "
          f"(packed_id_matrix, numpy on the host) {pack_ms:.1f} ms")
    packed_launches = {}
    for label, demo, init, counts, per_step, padded_warm in (
            ("CGCNN", CGCNN_DEMO, model_path, FC.LAUNCHES,
             CGCNN_DEMO["gc_count"], warm),
            ("MEGNet", MEGNET_DEMO, megnet_path, csr.LAUNCHES,
             3 * MEGNET_DEMO["gc_count"], mg_warm)):
        packed = {**demo, "batching": "packed"}
        reset_launches(*all_counts)
        wall, rows, text = run_training_text(training_config(
            data_dir, resume_from_init(f"{label}_packed", init),
            f"chip_{label}_packed", "cuda", EPOCHS_AB, model=packed))
        if "batching=packed" not in text:
            raise AssertionError(f"{label} packed: the run did not pack")
        packed_launches[label] = dict(counts)
        p_need = per_step * p_steps * EPOCHS_AB
        print(f"{label} packed (kernel auto) on {smi}: launches "
              f"{packed_launches[label]} (each >= {p_need}); warm epochs "
              f"{warm_epoch_s(rows):.5f} s against padded {padded_warm:.5f} s "
              f"({p_steps} steps an epoch against {train_steps}); train error "
              f"{rows[0][2]:.5f} -> {rows[-1][2]:.5f}")
        for k, v in packed_launches[label].items():
            if v < p_need:
                raise AssertionError(f"{k} launched {v} times in {label} "
                                     f"packed Training, expected >= {p_need}")
        if not rows[-1][2] < rows[0][2]:
            raise AssertionError(f"the card's {label} packed train error did "
                                 f"not fall: {rows[0][2]} -> {rows[-1][2]}")
        if label == "CGCNN":
            card_cpu = compare_with_cpu(f"{label}_packed", data_dir, packed,
                                        init, "fused", card_rows=rows)
        else:  # without BatchNorm, as above
            card_cpu = compare_with_cpu(
                f"{label}_packed", data_dir,
                {**MEGNET_NOBN, "batching": "packed"}, megnet_nobn_path, "csr")
        print(f"{label} packed card vs CPU"
              f"{'' if label == 'CGCNN' else ' (without BatchNorm)'}: epoch 1 "
              f"train error {card_cpu[0]:.5f} vs {card_cpu[1]:.5f} (rtol 1e-3)")
    p_ab = {}
    for kernel in ("csr", "pallas"):
        _, rows, text = run_training_text(training_config(
            data_dir, resume_from_init(f"packed_{kernel}"),
            f"chip_packed_ab_{kernel}", "cuda", EPOCHS_AB, kernel,
            model={**CGCNN_DEMO, "batching": "packed"}))
        p_ab[kernel] = warm_epoch_s(rows)
        spec_line = re.search(r"spec=\([^)]*\)", text).group(0)
        print(f"CGCNN packed kernel {kernel} on {smi}: {spec_line}, warm "
              f"epochs {p_ab[kernel]:.5f} s")
    profile_both("CGCNN packed fused", {**CGCNN_DEMO, "batching": "packed"})

    # ---- CUDA graphs against the eager loop, every model and arm ---------
    capture_times = check_capture(
        [("CGCNN", CGCNN_DEMO, model_path, k, "padded")
         for k in ("csr", "fused", "pallas")]
        + [("CGCNN", CGCNN_DEMO, model_path, k, "packed")
           for k in ("fused", "csr", "pallas")]
        + [("SchNet", SCHNET_DEMO, schnet_path, k, "padded")
           for k in ("csr", "fused")]
        + [("MPNN", MPNN_DEMO, mpnn_path, k, "padded") for k in ("xla", "fused")]
        + [("MPNN bf16", MPNN_BF16, mpnn_path, "fused", "padded")]
        + [("GCN", GCN_DEMO, gcn_path, k, "padded")
           for k in ("xla", "csr", "pallas")]
        + [("MEGNet", MEGNET_DEMO, megnet_path, k, "padded")
           for k in ("xla", "csr", "pallas")]
        + [("MEGNet", MEGNET_DEMO, megnet_path, "csr", "packed")],
        dataset, dev, smi)
    fastest = {}
    for (label, kernel, batching), (t_g, t_e, _, _) in capture_times.items():
        best = fastest.get((label, batching))
        if best is None or t_g < best[1]:
            fastest[(label, batching)] = (kernel, t_g)
    print(f"fastest arm captured on {smi} (kernel auto picks fused for "
          f"CGCNN, SchNet and MPNN, csr for GCN and MEGNet): " + ", ".join(
              f"{label} {batching} {k} {t:.5f} s"
              for (label, batching), (k, t) in fastest.items()))
    print("profiled warm epochs, device busy share captured / eager: "
          + ", ".join(f"{k} {100 * g:.1f}% / {100 * e:.1f}%"
                      for k, (g, e) in busy.items() if g and e))

    # ---- the meter's neighbours: --profile, remat and the bench ---------
    print("card vs CPU Predict, largest gap by model (max |card - CPU|, "
          "largest |prediction|): " + ", ".join(
              f"{k} {g:.3e} of {p:.3f}" for k, (g, p) in predict_gap.items()))
    check_profile_trace(
        training_config(data_dir, resume_from_init("train_profile"),
                        "chip_profile", "cuda", EPOCHS_REMAT),
        os.path.join(WORK, "cgcnn_profile"), smi)
    check_remat([("CGCNN", CGCNN_DEMO, model_path, "auto", FC.LAUNCHES,
                  "fused_cgconv_fwd", 1),
                 ("SchNet", SCHNET_DEMO, schnet_path, "auto", FS.LAUNCHES,
                  "fused_cfconv_fwd", 1),
                 ("MPNN", MPNN_DEMO, mpnn_path, "auto", FB.LAUNCHES,
                  "fused_bilinear_fwd", 1),
                 ("GCN", GCN_DEMO, gcn_path, "pallas", WO.LAUNCHES,
                  "windowed_spmm", 1),
                 # x[src] and u[g(src)] a block
                 ("MEGNet", MEGNET_DEMO, megnet_path, "auto", csr.LAUNCHES,
                  "gather", 2)], dataset, dev, smi)
    bench = run_bench(smi)
    missing = [k for k in BENCH_PACKED_KEYS + BENCH_EAGER_KEYS
               if k not in bench]
    missing += [k for k in BENCH_BF16_KEYS if k not in bench]
    if missing:
        raise AssertionError(f"the bench's line lacks the keys {missing}")

    # ---- the descriptor models and the other run modes ---------------------
    modes = check_run_modes(dataset, data_dir, gpu_train, dev, smi, all_counts)

    # ---- precision bf16: MPNN_demo on the bilinear kernels' bf16 arm ------
    t_bf = time.perf_counter()
    gpu_bf16 = resume_from_init("mpnn_bf16_gpu", mpnn_path)
    reset_launches(*all_counts, FB.LAUNCHES_BF16)
    wall, b_rows, b_text = run_training_text(training_config(
        data_dir, gpu_bf16, "chip_mpnn_bf16_gpu", "cuda", EPOCHS_CARD,
        model=MPNN_BF16))
    bf16_launches = dict(FB.LAUNCHES_BF16)
    print(f"launches in one MPNN bf16 Training run of {EPOCHS_CARD} epochs: "
          f"{bf16_launches}; the f32 arm {dict(FB.LAUNCHES)}; CSR "
          f"{dict(csr.LAUNCHES)}")
    if "precision=bf16" not in b_text:
        raise AssertionError("the bf16 run's resolved line names no "
                             "precision=bf16")
    for k, v in bf16_launches.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times in MPNN bf16 "
                                 f"Training, expected >= {need}")
    if any(FB.LAUNCHES.values()):
        raise AssertionError(f"the f32 bilinear arm launched under bf16: "
                             f"{dict(FB.LAUNCHES)}")
    b_warm = warm_epoch_s(b_rows)
    print(f"MPNN bf16 Training on {smi}: {wall:.3f} s wall for {EPOCHS_CARD} "
          f"epochs; epoch 1 (cold) {b_rows[0][4]:.5f} s, warm epochs "
          f"{b_warm:.5f} s on average (f32, main path 5: {m_warm:.5f} s; "
          f"{m_warm / b_warm:.2f}x); {throughput_line(b_text)}")
    if not b_rows[-1][2] < b_rows[0][2]:
        raise AssertionError(f"the card's MPNN bf16 train error did not "
                             f"fall: {b_rows[0][2]} -> {b_rows[-1][2]}")
    bsub = {}
    sub_wall, rows = run_training(training_config(
        sub_dir, resume_from_init("mpnn_bf16_first_cuda", mpnn_path),
        "chip_mpnn_bf16_first_cuda", "cuda", EPOCHS_COMPARE, "fused",
        model=MPNN_BF16))
    bsub["cuda"] = rows[0][2]
    print(f"MPNN bf16 Training on the first {N_COMPARE} structures, the "
          f"card: {sub_wall:.3f} s wall")
    bsub["cpu"], sub_wall = first_epoch_error(sub_ds, "cpu", MPNN_BF16,
                                              mpnn_path, "fused")
    print(f"MPNN bf16 Training on the first {N_COMPARE} structures, the CPU "
          f"(plain versions, the first epoch alone): {sub_wall:.3f} s")
    b_gap = abs(bsub["cuda"] - bsub["cpu"]) / bsub["cpu"]
    print(f"MPNN bf16 card vs CPU on the first {N_COMPARE} structures: epoch "
          f"1 train error {bsub['cuda']:.6f} vs {bsub['cpu']:.6f}"
          f", relative gap {b_gap:.3e} (limit {BF16_RTOL:g}); f32 in main "
          f"path 5: {sub['cuda']:.6f} vs {sub['cpu']:.6f}")
    np.testing.assert_allclose(bsub["cuda"], bsub["cpu"],
                               rtol=BF16_RTOL)
    reset_launches(*all_counts, FB.LAUNCHES_BF16)
    bp_wall, bp_eval = run_predict(predict_config(
        data_dir, gpu_bf16, "chip_mpnn_bf16_predict", "cuda"))
    bf16_predict_launches = {**FB.LAUNCHES_BF16, **csr.LAUNCHES}
    if (bf16_predict_launches["fused_bilinear_fwd_bf16"] < 4 * steps
            or any(FB.LAUNCHES.values())):
        raise AssertionError(f"MPNN bf16 Predict launched "
                             f"{bf16_predict_launches}, the f32 arm "
                             f"{dict(FB.LAUNCHES)}")
    _, pred_b = read_predictions("chip_mpnn_bf16_predict_predicted_outputs.csv")
    if len(pred_b) != N_STRUCTURES or not np.isfinite(pred_b).all():
        raise AssertionError(f"MPNN bf16 Predict: expected {N_STRUCTURES} "
                             "finite predictions")
    for where in ("cuda", "cpu"):
        run_predict(predict_config(sub_dir, gpu_bf16,
                                   f"chip_mpnn_bf16_sub_{where}", where))
    ids_g, pred_g = read_predictions(
        "chip_mpnn_bf16_sub_cuda_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_mpnn_bf16_sub_cpu_predicted_outputs.csv")
    if ids_g != ids_c:
        raise AssertionError("MPNN bf16 card and CPU predictions list "
                             "different ids")
    bp_gap, bp_top = predict_gap_of(pred_g, pred_c)
    print(f"MPNN bf16 Predict on {smi}: {N_STRUCTURES} finite predictions, "
          f"{bp_wall:.4f} s wall, {bp_eval:.5f} s evaluation; launches "
          f"{bf16_predict_launches}; card vs CPU on the first {N_COMPARE} "
          f"structures: max |diff| {bp_gap:.3e} of {bp_top:.3f} (limit "
          f"{BF16_RTOL:g} of the largest)")
    np.testing.assert_allclose(pred_g, pred_c, rtol=0,
                               atol=BF16_RTOL * bp_top)
    busy["MPNN fused bf16"] = (profile_training(
        dataset, dev, MPNN_BF16, kernel="fused", capture=None), None)
    others = {}
    for label, demo, init, ddir, processing in (
            ("CGCNN", CGCNN_DEMO, model_path, data_dir, {}),
            ("SchNet", SCHNET_DEMO, schnet_path, data_dir, {}),
            ("GCN", GCN_DEMO, gcn_path, data_dir, {}),
            ("MEGNet", MEGNET_DEMO, megnet_path, data_dir, {}),
            ("SM", SM_DEMO, os.path.join(WORK, "SM_demo.ckpt"), data_dir,
             {"SM_descriptor": "True", "processed_path": "processed_sm"}),
            ("SOAP", SOAP_DEMO, os.path.join(WORK, "SOAP_demo.ckpt"),
             os.path.join(WORK, "clusters"),
             {"SOAP_descriptor": "True", "processed_path": "processed_soap"})):
        cfg = training_config(ddir, resume_from_init(f"{label}_bf16", init),
                              f"chip_{label}_bf16", "cuda", EPOCHS_AB,
                              model={**demo, "precision": "bf16"})
        cfg["Processing"].update(processing)
        _, rows, text = run_training_text(cfg)
        plan = re.search(r"kernel=(\S+)", text).group(1)
        if "precision=bf16" not in text:
            raise AssertionError(f"{label} bf16: no precision=bf16 in its "
                                 "resolved line")
        if not rows[-1][2] < rows[0][2]:
            raise AssertionError(f"{label} bf16: the train error did not "
                                 f"fall: {rows[0][2]} -> {rows[-1][2]}")
        others[label] = (plan, [r[2] for r in rows], warm_epoch_s(rows))
    print(f"bf16, {EPOCHS_AB} epochs each on {smi} (kernel auto): " + "; ".join(
        f"{k} ({p}) train errors {', '.join(f'{e:.5f}' for e in errs)}, warm "
        f"epochs {w:.5f} s" for k, (p, errs, w) in others.items()))
    print(f"phase 21 (precision bf16) on {smi}: "
          f"{time.perf_counter() - t_bf:.1f} s wall; MPNN bf16 warm epoch "
          f"{b_warm:.5f} s against f32 {m_warm:.5f} s, busy "
          f"{100 * busy['MPNN fused bf16'][0]:.1f}% of a profiled captured "
          f"epoch")

    # ---- kernel_precision bf16: the single-pass arms ----------------------
    t_sp = time.perf_counter()
    sp_counts = (csr.LAUNCHES_SP, FC.LAUNCHES_SP, FS.LAUNCHES_SP,
                 WO.LAUNCHES_SP)
    fdata = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="dst",
                                             kernel_fused=True)
    fbatch = assemble_batch(fdata, np.arange(train_bs, dtype=np.int32), tspec)
    cdata = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="dst")
    cbatch = assemble_batch(cdata, np.arange(batch_size, dtype=np.int32), spec)
    wdata = DeviceDataset.from_graph_dataset(
        dataset, dev, windowed=WindowedDeviceData.from_layout(layout, dev))
    wbatch = assemble(wdata, pad_ids, wspec)
    print(f"single-pass arm checks on {card} (CGConv and cfconv at a "
          f"training batch, the windowed arms at a GCN_demo windowed batch "
          f"with 10 pad graph slots, the CSR arms at a Predict batch):")
    sp_err, sp_mutant = check_single_pass(fbatch, wbatch, cbatch, dev)
    err.update(sp_err)
    wtbatch = assemble(wdata, np.arange(train_bs, dtype=np.int32), wspec)
    sp_times = time_single_pass(fbatch, wtbatch, cbatch, dev)
    times.update(sp_times)
    for k, t in sp_times.items():
        lib = ("none (no one call computes it)" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        print(f"{k} on {smi}: kernel {t['ms']:.4f} ms (the f32 arm "
              f"{t['f32_ms']:.4f} ms in this call), plain {t['plain_ms']:.4f} "
              f"ms, library {lib}, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it)")
    del fdata, fbatch, cdata, cbatch, wdata, wbatch, wtbatch

    # CGCNN_demo at full width under kernel_precision bf16, kernel auto
    # (fused on the card: the CGConv kernels' single-pass arm)
    gpu_sp = resume_from_init("cgcnn_sp_gpu")
    reset_launches(*all_counts, *sp_counts, FB.LAUNCHES_BF16)
    wall, sp_rows, sp_text = run_training_text(training_config(
        data_dir, gpu_sp, "chip_cgcnn_sp_gpu", "cuda", EPOCHS_CARD,
        model=CGCNN_SP))
    sp_cgcnn = dict(FC.LAUNCHES_SP)
    print(f"launches in one CGCNN kernel_precision bf16 Training run of "
          f"{EPOCHS_CARD} epochs: {sp_cgcnn}; the f32 arm {dict(FC.LAUNCHES)}")
    if "kernel=fused(single-pass)" not in sp_text \
            or "capture=graphs" not in sp_text:
        raise AssertionError("the kernel_precision bf16 run's resolved line "
                             "names no kernel=fused(single-pass) on CUDA "
                             "graphs")
    for k, v in sp_cgcnn.items():
        if v < need:
            raise AssertionError(f"{k} launched {v} times in CGCNN "
                                 f"kernel_precision bf16 Training, expected "
                                 f">= {need}")
    if any(FC.LAUNCHES[k] for k in ("fused_cgconv_fwd", "fused_cgconv_bwd",
                                    "fused_cgconv_wgrad")):
        raise AssertionError(f"the f32 CGConv arm launched under "
                             f"kernel_precision bf16: {dict(FC.LAUNCHES)}")
    sp_warm = warm_epoch_s(sp_rows)
    if not sp_rows[-1][2] < sp_rows[0][2]:
        raise AssertionError(f"the single-pass CGCNN train error did not "
                             f"fall: {sp_rows[0][2]} -> {sp_rows[-1][2]}")
    _, sp_cpu = run_training(training_config(
        data_dir, resume_from_init("cgcnn_sp_cpu"), "chip_cgcnn_sp_cpu",
        "cpu", EPOCHS_CPU, "fused", model=CGCNN_SP))
    sp_gap = abs(sp_rows[0][2] - sp_cpu[0][2]) / sp_cpu[0][2]
    print(f"CGCNN kernel_precision bf16 Training on {smi}: {wall:.3f} s wall "
          f"for {EPOCHS_CARD} epochs; epoch 1 (cold) {sp_rows[0][4]:.5f} s, "
          f"warm epochs {sp_warm:.5f} s (f32, main path 2: {warm:.5f} s); "
          f"train error {sp_rows[0][2]:.5f} -> {sp_rows[-1][2]:.5f}; card vs "
          f"CPU (plain twins) epoch 1 {sp_rows[0][2]:.6f} vs "
          f"{sp_cpu[0][2]:.6f}, relative gap {sp_gap:.3e} (limit "
          f"{BF16_RTOL:g}); {throughput_line(sp_text)}")
    np.testing.assert_allclose(sp_rows[0][2], sp_cpu[0][2], rtol=BF16_RTOL)
    reset_launches(*all_counts, *sp_counts)
    spp_wall, spp_eval = run_predict(predict_config(
        data_dir, gpu_sp, "chip_cgcnn_sp_predict", "cuda"))
    if csr.LAUNCHES["gather"] < 4 * steps or any(
            v for c in sp_counts for v in c.values()):
        raise AssertionError(f"Predict from the single-pass checkpoint "
                             f"launched CSR {dict(csr.LAUNCHES)}, single-pass "
                             f"{[dict(c) for c in sp_counts]}")
    run_predict(predict_config(data_dir, gpu_sp, "chip_cgcnn_sp_predict_cpu",
                               "cpu"))
    ids_g, pred_g = read_predictions(
        "chip_cgcnn_sp_predict_predicted_outputs.csv")
    ids_c, pred_c = read_predictions(
        "chip_cgcnn_sp_predict_cpu_predicted_outputs.csv")
    if (ids_g != ids_c or len(pred_g) != N_STRUCTURES
            or not np.isfinite(pred_g).all()):
        raise AssertionError(f"Predict from the single-pass checkpoint: "
                             f"expected {N_STRUCTURES} finite predictions "
                             "with the CPU's ids")
    spp_gap, spp_top = predict_gap_of(pred_g, pred_c)
    print(f"Predict from the kernel_precision bf16 checkpoint on {smi}: "
          f"{N_STRUCTURES} finite predictions, {spp_wall:.4f} s wall, "
          f"{spp_eval:.5f} s evaluation (the CSR plan, f32 kernels); card vs "
          f"CPU max |diff| {spp_gap:.3e} of {spp_top:.3f} (limit "
          f"{BF16_RTOL:g} of the largest)")
    np.testing.assert_allclose(pred_g, pred_c, rtol=0,
                               atol=BF16_RTOL * spp_top)
    busy["CGCNN fused single-pass"] = (profile_training(
        dataset, dev, CGCNN_SP, kernel="auto", capture=None), None)
    # the same key at a smaller depth: SchNet under fused (the cfconv arm),
    # GCN and CGCNN under pallas (the windowed arms)
    sp_other, sp_launch = {}, {"CGCNN": sp_cgcnn}
    for label, demo, init, kernel, counts, f32_counts, needed in (
            ("SchNet", SCHNET_DEMO, schnet_path, "fused", FS.LAUNCHES_SP,
             FS.LAUNCHES, tuple(FS.LAUNCHES_SP)),
            ("GCN", GCN_DEMO, gcn_path, "pallas", WO.LAUNCHES_SP,
             WO.LAUNCHES, tuple(WO.LAUNCHES_SP)),
            # CGConv's mean: the sum, and the gather as its backward
            ("CGCNN pallas", CGCNN_DEMO, model_path, "pallas", WO.LAUNCHES_SP,
             WO.LAUNCHES, ("windowed_segment_sum_sp", "windowed_gather_sp"))):
        reset_launches(*all_counts, *sp_counts)
        _, rows, text = run_training_text(training_config(
            data_dir, resume_from_init(f"{label.replace(' ', '_')}_sp", init),
            f"chip_{label.replace(' ', '_')}_sp", "cuda", EPOCHS_AB, kernel,
            model={**demo, "kernel_precision": "bf16"}))
        sp_launch[label] = dict(counts)
        if f"kernel={kernel}(single-pass)" not in text:
            raise AssertionError(f"{label} kernel_precision bf16: no "
                                 f"kernel={kernel}(single-pass) in its "
                                 "resolved line")
        if not all(counts[k] for k in needed) or any(
                f32_counts[k[:-len("_sp")]] for k in counts):
            raise AssertionError(f"{label} kernel_precision bf16 launched "
                                 f"the arm {dict(counts)}, the f32 arm "
                                 f"{dict(f32_counts)}")
        if not (np.isfinite([r[2] for r in rows]).all()
                and rows[-1][2] < rows[0][2]):
            raise AssertionError(f"{label} kernel_precision bf16: the train "
                                 f"error did not fall: {rows[0][2]} -> "
                                 f"{rows[-1][2]}")
        sp_other[label] = ([r[2] for r in rows], warm_epoch_s(rows))
    print(f"kernel_precision bf16, {EPOCHS_AB} epochs each on {smi}: " + "; ".join(
        f"{k} train errors {', '.join(f'{e:.5f}' for e in errs)}, warm epochs "
        f"{w:.5f} s, launches {sp_launch[k]}"
        for k, (errs, w) in sp_other.items()))
    print(f"phase 22 (kernel_precision bf16) on {smi}: "
          f"{time.perf_counter() - t_sp:.1f} s wall; CGCNN_demo single-pass "
          f"warm epoch {sp_warm:.5f} s against f32 {warm:.5f} s, busy "
          f"{100 * busy['CGCNN fused single-pass'][0]:.1f}% of a profiled "
          f"captured epoch; the f32 arm's worst miss of a single-pass limit "
          f"{min(sp_mutant.values()):.3g}x")

    # ---- disk streaming: dataset_type large ------------------------------
    stream_launches = check_streaming(
        dataset, data_dir, mpnn_path, model_path, dev, smi, m_warm,
        capture_times[("MPNN", "fused", "padded")][2], resume_from_init)

    # ---- parallelism: dp and ep on torch.distributed --------------------
    dp_launches = check_parallel(dataset, data_dir, model_path, megnet_path,
                                 dev, smi)

    # ---- the port's bench_bulk: the configurations bench.py lacks -------
    bulk_launches = check_bulk(dev, smi)

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
            ("fused_bilinear_fwd_bf16", "fused_bilinear_fwd_bf16",
             "fused_bilinear_bf16.cu", "pallas_bilinear.py:235, :63 (mxu_bf16)",
             bf16_launches["fused_bilinear_fwd_bf16"]),
            ("fused_bilinear_bwd_bf16", "fused_bilinear_bwd_bf16",
             "fused_bilinear_bf16.cu", "pallas_bilinear.py:134, :83 (mxu_bf16)",
             bf16_launches["fused_bilinear_bwd_bf16"]),
            ("fused_bilinear_wgrad_bf16", "fused_bilinear_wgrad_bf16",
             "fused_bilinear_bf16.cu", "pallas_bilinear.py:134, :83 (mxu_bf16)",
             bf16_launches["fused_bilinear_wgrad_bf16"]),
            ("windowed_segment_sum", "windowed_segment_sum", "windowed.cu",
             "pallas_segment.py:144", gcn_launches["windowed_segment_sum"]),
            ("windowed_spmm", "windowed_spmm", "windowed.cu",
             "pallas_segment.py:174", gcn_launches["windowed_spmm"]),
            ("windowed_gather", "windowed_gather", "windowed.cu",
             "pallas_segment.py:209", gcn_launches["windowed_gather"])) + tuple(
            # the single-pass arms: launches of phase 22's runs (the CGConv
            # arm's CGCNN_demo, the cfconv arm's SchNet_demo, the windowed
            # arms' GCN_demo); the CSR arm is on no path
            (key, f"{'csr_' if src == 'csr.cu' else ''}{key}", src,
             f"{line} (hilo=False)",
             sp_launch["CGCNN"].get(key, sp_launch["SchNet"].get(
                 key, sp_launch["GCN"].get(key, 0))))
            for key, src, line in SP_ROWS):
        t = times[key]
        row = {
            "name": name, "route": "cuda",
            "source": f"matdeeplearn_torch/csrc/{src}",
            "replaces": f"matdeeplearn_tpu/ops/{line}",
            "launches": count, "max_abs_err": err[key],
            "check": "pass", "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }
        if "f32_ms" in t:
            row["f32_ms"] = t["f32_ms"]  # the f32 arm, timed in the same call
        if "parts_ms" in t:
            row["parts_ms"] = t["parts_ms"]  # its launches alone
        if key in FC.LAUNCHES:
            # the dp path's launches (phase 24 (a), both ranks)
            row["launches_by_path"] = {"CGCNN Training": count,
                                       "CGCNN dp2 Training": dp_launches[key]}
        if key in FB.LAUNCHES:
            # the streamed paths' launches (phase 23), beside main path 5's
            row["launches_by_path"] = {"MPNN Training": count, **{
                path: lc[key] for path, lc in stream_launches.items()}}
        if key in ("segment_sum", "gather"):
            # the CSR kernels' callers: each path's launches (counters reset
            # just before it), and the src-sorted shapes MEGNet gives them
            row["callers"] = (
                "CGConv x_i gather and mean, cfconv sum, NNConv mean, GCN "
                "sums (dst order); MEGNet x[src], u[node_graph[src]] and "
                "edge->node means (src order); their backwards")
            row["launches_by_path"] = {
                "CGCNN Predict": launches[key],
                "MPNN Training": mpnn_csr[key],
                "GCN Predict": g_predict_launches[key],
                "MEGNet Training": megnet_launches[key],
                "MEGNet Predict": mg_predict_launches[key],
                "MEGNet packed Training": packed_launches["MEGNet"][key],
                "CGCNN Analysis": modes["Analysis"]["launches"][key]}
            row["src_order_shapes"] = [
                {k: v for k, v in st.items() if k != "kernel"}
                for st in src_times if st["kernel"] == key]
        # phase 25's bench_bulk configurations on this kernel (each one's
        # launches, captured and eager); the cfconv rows' main path is
        # SchNet_demo's Training
        for cfg, lc in bulk_launches.items():
            if lc.get(key):
                row.setdefault("launches_by_path", {"SchNet Training": count})[
                    f"bench_bulk {cfg} (n {N_BULK})"] = lc[key]
        kernels.append(row)
    print(f"chip_smoke on {smi}: {time.perf_counter() - t_script:.1f} s in "
          "all, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
