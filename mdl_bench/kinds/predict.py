"""Predict traffic: a screening user's closed loop with one client.

Set-up writes a checkpoint of the benchmark's weights, loads it through the
program's Predict entry (jobs.load_model_for_inference), puts the mix's
held-out structures on the device in the edge order Predict uses
(jobs.csr_side) and sizes Predict's padded batch (BatchSpec.for_dataset at
the mix's batch size over them); one request warms up. Each request is
`request_size` distinct structures of that pool drawn with --seed, answered
by train.evaluate(..., out=True), and timed from its call until its
predictions are on the host. The window sends requests one after another
until --seconds have passed. Every answer of the window is then held to
the reference's prediction for its structure (the reference predicts the
whole pool once, after the program is freed)."""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from mdl_bench import compare, corpus as CORPUS, layer_time, port, trace as TR
from mdl_bench import kinds as K, weights as W
from mdl_bench.kinds import peak, release, sync
from mdl_bench.reference import common as RC


def run(cell, t_start: float, log) -> dict:
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble)
    from matdeeplearn_torch.models import MODEL_FIELDS, build_model
    from matdeeplearn_torch.training import jobs as J
    from matdeeplearn_torch.training import train as T
    from matdeeplearn_torch.training.checkpoint import save_checkpoint

    dev, mix = cell.device, cell.traffic

    def stage(name):
        log(f"set-up: {name} at {time.perf_counter() - t_start:.3f} s")

    stage("imports")
    c = CORPUS.load(mix["corpus"], log)
    stage("corpus")
    _, _, held = CORPUS.split(c["n"], mix["split"])
    pool = CORPUS.subset(c, held)
    ds = port.graph_dataset(pool)
    name = cell.model["model"]
    model_cfg = {**cell.model, "edge_resolution": c["edge_resolution"]}
    ref_model = cell.reference()
    w = W.make(ref_model.param_table(model_cfg, pool["node_x"].shape[1]),
               cell.seed, dev)
    cfg = {k: v for k, v in model_cfg.items() if k in MODEL_FIELDS[name]}
    cfg.update(num_features=ds.num_features, output_dim=ds.output_dim,
               edge_resolution=ds.num_edge_features)
    cpu_model = build_model(name, ds, cfg,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    W.load_into(cpu_model, {k: v.cpu() for k, v in w.items()})
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "model.ckpt")
        save_checkpoint(path, cpu_model.state_dict(), name, cfg)
        _, model = J.load_model_for_inference(ds, path, dev)
    finally:
        shutil.rmtree(tmp)
    del cpu_model
    stage("checkpoint and load_model_for_inference")
    data = DeviceDataset.from_graph_dataset(ds, dev,
                                            edge_order=J.csr_side(name))
    bs, size = int(mix["batch_size"]), int(mix["request_size"])
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), bs)
    rng = np.random.default_rng(cell.seed)

    def request():
        ids = rng.choice(pool["n"], size=size, replace=False)
        t0 = time.perf_counter()
        _, preds, _ = T.evaluate(model, "l1_loss", spec, data, ids, bs,
                                 out=True)
        return ids, preds, time.perf_counter() - t0

    stage("dataset on the device")
    request()  # warm-up: every shape of the window
    sync(dev)
    stage("warm-up request")
    setup_s = time.perf_counter() - t_start
    peak_setup = peak(dev, reset=True)
    answers, latencies, failed = [], [], 0
    limit = cell.window_seconds
    with TR.profiled(cell.trace, dev.type) as holder:
        with TR.window_span():
            t0 = time.perf_counter()
            while True:
                try:
                    ids, preds, lat = request()
                except Exception as e:  # noqa: BLE001 - a failed request
                    log(f"request failed: {e!r}")
                    failed += 1
                else:
                    if np.all(np.isfinite(preds)):
                        answers.append((ids, preds))
                        latencies.append(lat)
                    else:
                        failed += 1
                if time.perf_counter() - t0 >= limit:
                    break
            sync(dev)
            window = time.perf_counter() - t0
    peak_window = peak(dev)
    n_req = len(answers) + failed
    lat_ms = np.asarray(latencies) * 1e3
    q = (np.percentile(lat_ms, [50, 90, 95, 99, 100]) if len(lat_ms)
         else [math.nan] * 5)
    log(f"window: {n_req} requests ({failed} failed) of {size} structures "
        f"in {window:.4f} s; latency ms p50 {q[0]:.4f} p90 {q[1]:.4f} p95 "
        f"{q[2]:.4f} p99 {q[3]:.4f} max {q[4]:.4f} over {len(lat_ms)} "
        f"requests; setup {setup_s:.4f} s")
    record = {"kind": "predict", "peak_mem_bytes": peak_window}
    if cell.trace:
        nc, ec = np.diff(pool["node_ptr"]), np.diff(pool["edge_ptr"])
        batches = n_req * -(-size // bs)
        every = np.concatenate([a[0] for a in answers]) if answers else []
        last = T.epoch_id_matrix(answers[-1][0], bs, False, None)[-1]
        batch = assemble(data, torch.as_tensor(last, device=dev), spec)
        real = last[last >= 0]
        conv_s = layer_time.conv_seconds(
            model, batch, cell.convs().layers(model, batch), backward=False)
        record.update({
            "model": name, "config": model_cfg,
            "num_features": int(ds.num_features), "batches": batches,
            "requests": n_req,
            "predict_counts": [float(nc[every].sum()), float(ec[every].sum()),
                               float(len(every))],
            "edge_slots": batches * spec.num_edges,
            "conv": {"counts": [float(nc[real].sum()), float(ec[real].sum())],
                     "seconds": conv_s, "backward": False},
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
        })
        if holder.prof is not None:
            record["trace"] = TR.summarize(holder.prof)
    del model, data
    release(dev)

    with RC.matmul_precision(tf32=False):
        ref = RC.predict(ref_model, model_cfg, w, pool,
                         np.arange(pool["n"]), dev)
    if K.CONTROL:
        with RC.matmul_precision(tf32=True):
            ctrl = RC.predict(ref_model, model_cfg, w, pool,
                              np.arange(pool["n"]), dev)
        answers = [(ids, ctrl[ids]) for ids, _ in answers]
    out = {"checks": {"answer_gap": compare.answer_gap(answers, ref)},
           "record": record, "reference": ref, "weights": w, "pool": pool,
           "answers": answers}
    out.update(
        attempted=n_req, failed=failed,
        memory_peak_bytes=max(peak_setup, peak_window),
        metrics={"predict_graphs_per_s": len(answers) * size / window,
                 "predict_p95_ms": float(np.percentile(lat_ms, 95))
                 if len(lat_ms) else math.inf,
                 "setup_s": setup_s})
    return out
