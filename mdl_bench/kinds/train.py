"""Training traffic: the program's Training entry on the corpus of the mix.

Set-up builds one Run (jobs.setup_run: model, AdamW, packed batches, the
dataset on the device) and writes the benchmark's weights into it. It then
drives that Run from the seed through `check_steps` steps, each one call
of jobs.run_fused_training (the window's entry, with its packed feed and
CUDA graphs) over one packed bin of distinct training graphs, and keeps
each step's loss, the first gradient as AdamW holds it (exp_avg / (1 -
beta1) after one step) and the state after the last; then one full epoch
(train steps, the val pass, the epoch tail) captures the window's graphs.
The window runs whole epochs of that same Run in one run_fused_training
call, in chunks of the mix's `verbosity` epochs with one sync each, until
--seconds have passed, and ends in a synchronize. After the
window the program is freed and the reference follows the check steps
from the same weights on the same graphs."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from mdl_bench import compare, corpus as CORPUS, layer_time, port, trace as TR
from mdl_bench import kinds as K, weights as W
from mdl_bench.kinds import peak, release, sync
from mdl_bench.reference import common as RC


def check_bins(train_ids, nc, ec, spec, batch_size: int, rng, k: int) -> list:
    """k disjoint sets of training graphs, drawn in the order of a seeded
    permutation, each as large as one packed bin of `spec` holds (at most
    batch_size graphs; nodes and edges within the capacity less the
    largest graph, the packer's bound for one step)."""
    perm = rng.permutation(train_ids)
    out, pos = [], 0
    for _ in range(k):
        take, sn, se, mn, me = [], 0, 0, 0, 0
        while pos < len(perm) and len(take) < min(batch_size, spec.num_graphs):
            i = perm[pos]
            n, e = int(nc[i]), int(ec[i])
            if (sn + n + max(mn, n) > spec.num_nodes
                    or se + e + max(me, e) > spec.num_edges):
                break
            take.append(i)
            sn, se, mn, me = sn + n, se + e, max(mn, n), max(me, e)
            pos += 1
        out.append(np.asarray(take, np.int64))
    return out


def program_grads(run) -> dict:
    """The first step's gradient of every parameter, from AdamW's first
    moment after one step."""
    beta1 = run.optimizer.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in run.model.named_parameters()}
    return {names[id(p)]: (st["exp_avg"] / (1.0 - beta1)).detach().clone()
            for p, st in run.optimizer.state.items()}


class FirstOutputs:
    """The model's outputs at its first call outside a CUDA graph's capture:
    the trainer runs a step's first call eagerly and then captures it, so
    at the first check step these are step 1's predictions, one a graph
    slot."""

    def __init__(self, model):
        self.out = None
        self.handle = model.register_forward_hook(self)

    def __call__(self, module, args, out):
        if self.out is None and not (
                out.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.out = out.detach().reshape(out.shape[0], -1)[:, 0].clone()


def in_bin_order(slot_out, row, ids) -> np.ndarray:
    """Per-slot outputs of the packed row `row` (-1 a pad slot) as one a
    graph, in the order of `ids`."""
    real = row >= 0
    by_id = dict(zip(row[real].tolist(),
                     slot_out.double().cpu().numpy()[real].tolist()))
    if sorted(by_id) != sorted(np.asarray(ids).tolist()):
        raise RuntimeError("step 1's packed row holds other graphs than its "
                           "check bin")
    return np.asarray([by_id[i] for i in np.asarray(ids).tolist()])


def _counts(ids, nc, ec):
    ids = np.asarray(ids)
    return float(nc[ids].sum()), float(ec[ids].sum()), float(len(ids))


def run(cell, t_start: float, log) -> dict:
    from matdeeplearn_torch.data.batching import assemble
    from matdeeplearn_torch.training import jobs as J

    dev, tr_cfg = cell.device, cell.traffic

    def stage(name):
        log(f"set-up: {name} at {time.perf_counter() - t_start:.3f} s")

    stage("imports")
    c = CORPUS.load(tr_cfg["corpus"], log)
    stage("corpus")
    tr, va, _ = CORPUS.split(c["n"], tr_cfg["split"])
    nc, ec = CORPUS.node_counts(c), CORPUS.edge_counts(c)
    params = {**cell.model, "batch_size": int(tr_cfg["batch_size"]),
              "edge_resolution": c["edge_resolution"]}
    run = J.setup_run(port.graph_dataset(c), params, "l1_loss",
                      seed=cell.seed, device=dev)
    stage("setup_run")
    ref_model = cell.reference()
    w0 = W.make(ref_model.param_table(params, c["node_x"].shape[1]),
                cell.seed, dev)
    W.load_into(run.model, w0)
    rng = np.random.default_rng(cell.seed)
    bins = check_bins(tr, nc, ec, run.spec, run.batch_size, rng,
                      int(tr_cfg["check_steps"]))
    check_rows = [run.id_matrix(b, True, cell.seed + 1) for b in bins]
    for b, r in zip(bins, check_rows):
        if r.shape[0] != 1:
            raise RuntimeError(f"a check bin of {len(b)} graphs packs into "
                               f"{r.shape[0]} steps, not 1")
    prog = {"losses": [], "grad1": None}
    none = np.zeros(0, np.int64)
    first = FirstOutputs(run.model)
    for b in bins:
        _, _, hist = J.run_fused_training(run, train_idx=b, val_idx=none,
                                          epochs=1, verbosity=1,
                                          seed=cell.seed)
        prog["losses"].append(float(hist[0][0]))
        if prog["grad1"] is None:
            prog["grad1"] = program_grads(run)
    first.handle.remove()
    sync(dev)
    # none read (no eager first call) compares as an infinite forward_gap
    prog["pred1"] = (None if first.out is None
                     else in_bin_order(first.out, check_rows[0][0], bins[0]))
    prog["state"] = {k: v.detach().clone()
                     for k, v in run.model.state_dict().items()}
    stage("check steps")

    steps = run.id_matrix(tr, True, cell.seed).shape[0]
    val_steps = run.id_matrix(va, False, None).shape[0]
    rows, window, record = [], None, {"kind": "train"}
    if not cell.calibrate:
        # one epoch captures the window's graphs (train, eval, tail)
        J.run_fused_training(run, train_idx=tr, val_idx=va, epochs=1,
                             verbosity=1, seed=cell.seed)
        sync(dev)
        stage("warm-up epoch")
        setup_s = time.perf_counter() - t_start
        peak_setup = peak(dev, reset=True)
        limit = cell.window_seconds
        t0 = [0.0]

        def chunk_fn(epoch, chunk_rows, sched):
            rows.extend(map(tuple, chunk_rows))
            return time.perf_counter() - t0[0] >= limit

        with TR.profiled(cell.trace, dev.type) as holder:
            with TR.window_span():
                t0[0] = time.perf_counter()
                J.run_fused_training(run, train_idx=tr, val_idx=va,
                                     epochs=10 ** 9,
                                     verbosity=int(tr_cfg["verbosity"]),
                                     seed=cell.seed + 1, chunk_fn=chunk_fn)
                sync(dev)
                window = time.perf_counter() - t0[0]
        peak_window = peak(dev)
        epochs = len(rows)
        log(f"window: {epochs} epochs of {steps} steps and {val_steps} val "
            f"steps in {window:.4f} s; setup {setup_s:.4f} s")
        if cell.trace:
            record.update(_trace_record(cell, params, run, holder, c, tr, va,
                                        nc, ec, epochs, steps, val_steps,
                                        assemble))
        record["peak_mem_bytes"] = peak_window
    kept = run if cell.calibrate else None  # calibrate.py's witness
    del run
    release(dev)

    batches = [RC.batch_of(c, b, dev) for b in bins]
    with RC.matmul_precision(tf32=False):
        ref = RC.train_steps(ref_model, params, w0, batches,
                             float(params["lr"]))
    if K.CONTROL:
        with RC.matmul_precision(tf32=True):
            prog = RC.train_steps(ref_model, params, w0, batches,
                                  float(params["lr"]))
    worst = {}
    checks = compare.train_gaps(prog, ref, w0, worst)
    log(f"worst leaves: {worst}; losses program {prog['losses']} reference "
        f"{ref['losses']}")
    out = {"checks": checks, "worst": worst, "record": record,
           "reference": ref, "program": prog, "weights": w0, "bins": bins,
           "corpus": c, "params": params, "run": kept}
    if cell.calibrate:
        return out
    bad = sum(not math.isfinite(r[0]) for r in rows)
    out.update(
        attempted=len(rows) * steps, failed=bad * steps,
        memory_peak_bytes=max(peak_setup, peak_window),
        metrics={"train_graphs_per_s": len(rows) * len(tr) / window,
                 "setup_s": setup_s})
    return out


def _trace_record(cell, params, run, holder, c, tr, va, nc, ec, epochs,
                  steps, val_steps, assemble) -> dict:
    """What the per-layer readers read of a traced training window."""
    n_tr, e_tr, b_tr = _counts(tr, nc, ec)
    n_va, e_va, b_va = _counts(va, nc, ec)
    # the window's last batch: its last epoch's last packed bin
    row = run.id_matrix(tr, True, cell.seed + 1 + epochs)[-1]
    real = row[row >= 0]
    batch = assemble(run.data, torch.as_tensor(row, device=cell.device),
                     run.spec)
    run.model.train()
    conv_s = layer_time.conv_seconds(
        run.model, batch, cell.convs().layers(run.model, batch), backward=True)
    rec = {
        "model": cell.model["model"], "config": params,
        "num_features": int(c["node_x"].shape[1]),
        "epochs": epochs, "steps": epochs * steps,
        "val_steps": epochs * val_steps,
        "train_counts": [n_tr * epochs, e_tr * epochs, b_tr * epochs],
        "val_counts": [n_va * epochs, e_va * epochs, b_va * epochs],
        "edge_slots": epochs * (steps + val_steps) * run.spec.num_edges,
        "conv": {"counts": _counts(real, nc, ec)[:2], "seconds": conv_s,
                 "backward": True},
        "device_name": (torch.cuda.get_device_name(cell.device)
                        if cell.device.type == "cuda" else "cpu"),
    }
    if holder.prof is not None:
        rec["trace"] = TR.summarize(holder.prof)
    return rec
