"""Benchmark: CGCNN training throughput and accuracy on the synthetic
analog of the reference's test_data, on one card.

    python -m matdeeplearn_torch.bench [--device cuda|cpu] [--n 1000] [--epochs 250]

The counterpart of the reference package's bench.py:

* corpus: 1,000 Pt clusters of 10 atoms in a 20 Å box with pair-potential
  targets (data/synthetic.py:write_clusters, generator seed 0), written
  under build/bench/ and featurized with the default processing values;
* model: CGCNN_demo's parameters (bench.py:61-69), seed 123; split
  0.8/0.05/0.15 at seed 123;
* warmup: 5 epochs in one chunk of K = 5 (the kernels' build, the
  allocator's first pass and, on CUDA, the capture of the trainer's CUDA
  graphs); timing: 50 epochs in chunks of K under a ThroughputMeter
  (utils/profiling.py) with warmup_chunks=0; accuracy: training goes on to
  250 epochs in all, and the best-val model's test MAE goes through the
  gate (`mae_gate`, the band of bench_band.json). Training runs as the
  trainer runs by default: CUDA graphs on a card (`value`). On CUDA the
  eager loop (capture=False) is timed too, on a fresh run of the same
  model: K warm epochs, then EAGER_EPOCHS timed (`value_eager`);
* bulk segment (on CUDA only, as the reference's runs on its TPU only):
  2,048 in-memory graphs of 24-96 atoms (data/synthetic.py:
  synthetic_dataset, seed 7), batch 256, 5 epochs warm and 5 timed under
  each padded arm (fused, pallas, xla) and CGCNN's csr arm on packed
  batches (the reference's production path, bench.py:223); then MPNN_demo's
  widths on packed batches of 64 under csr (its bilinear kernel with the
  CSR mean, the reference's csr+fused) and xla (bench.py:258-302); then
  the `precision: bf16` arms of bench_bulk.py:294-319: CGCNN xla padded
  (`bf16`), xla packed (`bf16_packed`) and fused packed
  (`bf16_packed_fused`), and MPNN fused packed (`packed_fused_bf16`, the
  bilinear kernels' bf16 arm); every arm captured (its key) and eager (the
  key with `_eager`). The main line and its gate stay f32.

Prints ONE JSON line on stdout; diagnostics go to stderr. Exits 1 when the
gate fails; an arm that fails raises, so no line lacks an arm. Runs on CUDA unless --device names the CPU; a CUDA request
without CUDA fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_band.json")
METRIC = "epoch_time_synthetic_cgcnn"
N_CORPUS, CORPUS_SEED = 1000, 0
SEED = 123                       # model init and shuffle (bench.py:71)
SPLIT = (0.8, 0.05, 0.15)
SPLIT_SEED = 123
K = 5                            # epochs a chunk, and the warmup's epochs
TIMED_EPOCHS = 50
EAGER_EPOCHS = 10                # timed epochs of the eager loop (CUDA)
EPOCHS = 250
BENCH_MODEL = {                  # bench.py:61-69
    "model": "CGCNN", "dim1": 100, "dim2": 150, "pre_fc_count": 1,
    "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
    "batch_norm": "True", "act": "relu", "epochs": 250, "lr": 0.002,
    "batch_size": 100, "optimizer": "AdamW", "optimizer_args": {},
    "scheduler": "ReduceLROnPlateau",
    "scheduler_args": {"mode": "min", "factor": 0.8, "patience": 10,
                       "min_lr": 1e-5, "threshold": 2e-4},
}
# (kernel, batching) of the bulk segment's CGCNN arms, and MPNN's arms
BULK_ARMS = (("fused", "padded"), ("pallas", "padded"), ("xla", "padded"),
             ("csr", "packed"))
BULK_MPNN_ARMS = ("csr", "xla")
# the bf16 arms: key suffix -> (model, kernel, batching)
BULK_BF16_ARMS = {"bf16": ("CGCNN", "xla", "padded"),
                  "bf16_packed": ("CGCNN", "xla", "packed"),
                  "bf16_packed_fused": ("CGCNN", "fused", "packed"),
                  "packed_fused_bf16": ("MPNN", "fused", "packed")}
BULK = {"n_graphs": 2048, "batch": 256, "epochs": 5, "seed": 7}
BULK_MPNN = {"model": "MPNN", "dim1": 100, "dim2": 100, "dim3": 100,
             "pre_fc_count": 1, "gc_count": 4, "post_fc_count": 3,
             "batch_size": 64, "lr": 0.001, "optimizer": "AdamW",
             "scheduler": "ReduceLROnPlateau", "batching": "packed"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def corpus_dir(n: int = N_CORPUS) -> str:
    """The corpus of n clusters under build/bench/, written once."""
    from matdeeplearn_torch.data.synthetic import write_clusters

    path = os.path.join(REPO, "build", "bench", f"clusters_n{n}_seed{CORPUS_SEED}")
    if not os.path.exists(os.path.join(path, "targets.csv")):
        write_clusters(path, n=n, seed=CORPUS_SEED)
        log(f"wrote {n} clusters to {path}")
    return path


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mae_gate(err: float, epochs: int, n: int, path: str = BAND_PATH) -> dict:
    """Accuracy gate: the best-val model's test MAE must sit inside the band
    of bench_band.json, mean ± max(4σ, 0.15·mean) over the reference
    package's CPU runs of this bench's procedure, one a seed (its formula,
    bench.py:187-190).
    Skipped when the run's epochs or corpus differ from the band's."""
    with open(path) as f:
        band = json.load(f)
    if epochs != band["epochs"]:
        return {"mae_gate": "skipped (epochs differ from the band's)"}
    if n != band["corpus"]["n"]:
        return {"mae_gate": "skipped (corpus differs from the band's)"}
    maes = [r["test_mae"] for r in band["runs"]]
    mean, std = float(np.mean(maes)), float(np.std(maes))
    half = max(4 * std, 0.15 * mean)
    lo, hi = mean - half, mean + half
    text = (f"[{lo:.4f}, {hi:.4f}] (reference CPU {len(maes)}-seed mean {mean:.4f} "
            f"± max(4σ={4 * std:.4f}, 15%))")
    return {"mae_gate": "pass" if lo <= err <= hi else "FAIL",
            "mae_gate_band": text}


def finish(out: dict, err: float, epochs: int, n: int,
           band_path: str = BAND_PATH) -> int:
    """Add the gate to `out`, print the JSON line; 1 when the gate fails."""
    gate = mae_gate(err, epochs, n, band_path)
    out.update(gate)
    print(json.dumps(out), flush=True)
    if gate["mae_gate"] == "FAIL":
        log(f"MAE GATE FAILED: {err:.4f} outside {gate['mae_gate_band']}")
        return 1
    return 0


def _warm_epoch_s(ds, mp: dict, tr, va, dev, capture=None, seed=None,
                  timed=None) -> float:
    """s/epoch of `timed` (default mp["epochs"]) timed epochs after
    mp["epochs"] warm ones, on the second call of one run (the graphs
    captured by the first are replayed); `capture` as the trainer takes
    it."""
    from matdeeplearn_torch.training import jobs as J

    seed = BULK["seed"] if seed is None else seed
    run = J.setup_run(ds, mp, "l1_loss", seed=seed, device=dev)
    kw = dict(train_idx=tr, val_idx=va, capture=capture)
    J.run_fused_training(run, epochs=mp["epochs"], verbosity=mp["epochs"],
                         seed=seed, **kw)  # warm
    _sync(dev)
    timed = timed or mp["epochs"]
    t0 = time.perf_counter()
    J.run_fused_training(run, epochs=timed, verbosity=timed, seed=seed + 1,
                         **kw)
    _sync(dev)
    return (time.perf_counter() - t0) / timed


def _bulk_epoch_times(dev) -> dict:
    """Warm s/epoch of CGCNN at bulk graph sizes under each arm, then of
    MPNN under its packed arms (same data, parameters and seed)."""
    from matdeeplearn_torch.data.synthetic import synthetic_dataset

    t0 = time.perf_counter()
    ds = synthetic_dataset(num_graphs=BULK["n_graphs"], seed=BULK["seed"],
                           min_atoms=24, max_atoms=96, max_neighbors=12)
    batch, epochs = BULK["batch"], BULK["epochs"]
    edges_per_batch = float(np.mean(ds.edge_counts())) * batch
    log(f"bulk workload: {len(ds)} graphs built in "
        f"{time.perf_counter() - t0:.1f} s, {edges_per_batch:,.0f} edges/batch")
    idx = np.arange(len(ds), dtype=np.int64)
    tr, va = idx[: int(0.9 * len(ds))], idx[int(0.9 * len(ds)):]
    times, eager = {}, {}
    cgcnn = {**{k: BENCH_MODEL[k] for k in ("model", "dim1", "dim2",
                                            "pre_fc_count", "gc_count",
                                            "post_fc_count", "lr",
                                            "optimizer", "scheduler")},
             "batch_size": batch, "epochs": epochs}
    for kern, batching in BULK_ARMS:
        mp = {**cgcnn, "kernel": kern, "batching": batching}
        times[kern] = _warm_epoch_s(ds, mp, tr, va, dev)
        eager[kern] = _warm_epoch_s(ds, mp, tr, va, dev, capture=False)
        log(f"bulk {kern} ({batching}): {times[kern]:.4f} s/epoch "
            f"captured, {eager[kern]:.4f} eager")
    mtimes, meager = {}, {}
    for kern in BULK_MPNN_ARMS:
        mp = {**BULK_MPNN, "epochs": epochs, "kernel": kern}
        mtimes[kern] = _warm_epoch_s(ds, mp, tr, va, dev)
        meager[kern] = _warm_epoch_s(ds, mp, tr, va, dev, capture=False)
        log(f"bulk MPNN {kern} (packed, batch {BULK_MPNN['batch_size']}): "
            f"{mtimes[kern]:.4f} s/epoch captured, {meager[kern]:.4f} eager")
    bf16 = {}
    for name, (model, kern, batching) in BULK_BF16_ARMS.items():
        base = cgcnn if model == "CGCNN" else {**BULK_MPNN, "epochs": epochs}
        mp = {**base, "kernel": kern, "batching": batching,
              "precision": "bf16"}
        key = (f"bulk_epoch_s_{name}" if model == "CGCNN"
               else f"bulk_mpnn_epoch_s_{name}")
        bf16[key] = round(_warm_epoch_s(ds, mp, tr, va, dev), 4)
        bf16[f"{key}_eager"] = round(
            _warm_epoch_s(ds, mp, tr, va, dev, capture=False), 4)
        log(f"bulk {model} {kern} ({batching}, precision bf16): "
            f"{bf16[key]:.4f} s/epoch captured, {bf16[key + '_eager']:.4f} "
            "eager")
    return {
        "bulk_epoch_s_fused": round(times["fused"], 4),
        "bulk_epoch_s_pallas": round(times["pallas"], 4),
        "bulk_epoch_s_xla": round(times["xla"], 4),
        "bulk_epoch_s_csr_packed": round(times["csr"], 4),
        "bulk_fused_speedup": round(times["xla"] / times["fused"], 3),
        "bulk_pallas_speedup": round(times["xla"] / times["pallas"], 3),
        "bulk_csr_packed_speedup": round(times["xla"] / times["csr"], 3),
        "bulk_edges_per_batch": round(edges_per_batch),
        "bulk_mpnn_epoch_s_csr_fused": round(mtimes["csr"], 4),
        "bulk_mpnn_epoch_s_xla": round(mtimes["xla"], 4),
        "bulk_mpnn_csr_fused_speedup": round(mtimes["xla"] / mtimes["csr"], 3),
        "bulk_epoch_s_fused_eager": round(eager["fused"], 4),
        "bulk_epoch_s_pallas_eager": round(eager["pallas"], 4),
        "bulk_epoch_s_xla_eager": round(eager["xla"], 4),
        "bulk_epoch_s_csr_packed_eager": round(eager["csr"], 4),
        "bulk_mpnn_epoch_s_csr_fused_eager": round(meager["csr"], 4),
        "bulk_mpnn_epoch_s_xla_eager": round(meager["xla"], 4),
        **bf16,
    }


def run_bench(device: str = "cuda", n: int = N_CORPUS,
              epochs: int = EPOCHS) -> tuple[dict, float]:
    """The bench's measurements: (the JSON line's fields without the gate,
    the best-val model's test MAE)."""
    from matdeeplearn_torch.data.dataset import get_dataset, split_data
    from matdeeplearn_torch.training import jobs as J
    from matdeeplearn_torch.training import train as T
    from matdeeplearn_torch.utils.device import resolve_device
    from matdeeplearn_torch.utils.profiling import (ThroughputMeter,
                                                    attach_analytic_flops)

    if epochs <= K:
        raise ValueError(f"--epochs must exceed the {K} warmup epochs")
    t_start = time.time()
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {kind}")
    ds = get_dataset(corpus_dir(n), 0, "False", {"verbose": "False"})
    log(f"dataset: {len(ds)} graphs, {len(ds.edge_src)} edges")
    run = J.setup_run(ds, BENCH_MODEL, "l1_loss", seed=SEED, device=dev)
    train_idx, val_idx, test_idx = split_data(ds, *SPLIT, seed=SPLIT_SEED)
    kw = dict(train_idx=train_idx, val_idx=val_idx, verbosity=K)

    # warmup: one chunk of K epochs (the kernels' build at first use)
    t0 = time.time()
    J.run_fused_training(run, epochs=K, seed=SEED, **kw)
    _sync(dev)
    warmup_s = time.time() - t0
    log(f"warmup {K} epochs: {warmup_s:.2f}s")

    timed = min(TIMED_EPOCHS, epochs - K)
    meter = ThroughputMeter(
        num_devices=1,
        edges_per_epoch=float(ds.edge_counts()[train_idx].sum()),
        graphs_per_epoch=float(len(train_idx)),
        warmup_chunks=0,  # the warmup run above took the first chunk
    )
    attach_analytic_flops(meter, run.model_name, run.model_config, run.spec,
                          len(train_idx), len(val_idx), run.batch_size,
                          fused_kernel=run.fused_kernel)
    t0 = time.time()
    best, _, _ = J.run_fused_training(run, epochs=timed, seed=SEED + 1,
                                      meter=meter, **kw)
    _sync(dev)
    sec_per_epoch = (time.time() - t0) / timed
    edges_per_sec = float(np.sum(ds.edge_counts())) * SPLIT[0] / sec_per_epoch
    rates = meter.rates()
    log("meter:", meter.report())

    # the rest of the epoch budget; the best-val model of the last call
    rest = epochs - K - timed
    if rest > 0:
        best, _, _ = J.run_fused_training(run, epochs=rest, seed=SEED + 2, **kw)
    run.model.load_state_dict(best)
    err = T.evaluate(run.model, run.loss, run.spec, run.data, test_idx,
                     run.batch_size)

    if dev.type == "cuda":
        # the eager loop on a fresh run of the same model: K warm epochs,
        # EAGER_EPOCHS timed
        eager_s = _warm_epoch_s(ds, {**BENCH_MODEL, "epochs": K}, train_idx,
                                val_idx, dev, capture=False, seed=SEED,
                                timed=EAGER_EPOCHS)
        log(f"eager: {eager_s:.4f} s/epoch over {EAGER_EPOCHS} epochs")
        bulk = {"value_eager": round(eager_s, 4), **_bulk_epoch_times(dev)}
    else:
        bulk = {}
        log("eager timing and bulk segment: skipped off CUDA (the CPU runs "
            "eagerly)")
    log(f"s/epoch={sec_per_epoch:.4f} edges/s={edges_per_sec:.3g} "
        f"test_mae={err:.4f} warmup_s={warmup_s:.1f} "
        f"total_bench_s={time.time() - t_start:.1f} bulk={bulk}")
    out = {
        "metric": METRIC,
        "value": round(sec_per_epoch, 4),
        "unit": "s/epoch",
        "device": kind,
        "kernel": run.kernel,
        f"test_mae_{epochs}_epochs": round(err, 4),
        "warmup_s": round(warmup_s, 1),
        "edges_per_s": round(edges_per_sec),
        **bulk,
    }
    if "mfu_pct" in rates:
        out["mfu"] = rates["mfu_pct"]
    if "hbm_util_pct" in rates:
        out["bw_util"] = rates["hbm_util_pct"]
    if "model_flops_per_s" in rates:
        out["model_flops_per_s"] = rates["model_flops_per_s"]
    return out, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a CUDA request without "
                         "CUDA fails")
    ap.add_argument("--n", type=int, default=N_CORPUS,
                    help="clusters in the corpus (the gate needs 1000)")
    ap.add_argument("--epochs", type=int, default=EPOCHS,
                    help="epochs in all (the gate needs 250)")
    args = ap.parse_args(argv)
    # the library's progress lines go to stderr: stdout holds the one line
    with contextlib.redirect_stdout(sys.stderr):
        out, err = run_bench(args.device, args.n, args.epochs)
    return finish(out, err, args.epochs, args.n)


if __name__ == "__main__":
    sys.exit(main())
