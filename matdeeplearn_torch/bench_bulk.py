"""Bulk-scale throughput: epochs/hr of the five GNNs on a corpus of Materials
Project size and size skew, on one card.

    python -m matdeeplearn_torch.bench_bulk [--n 46744] [--epochs 3]
        [--batch 256] [--configs all|name,name,...] [--device cuda|cpu]

The counterpart of the reference package's bench_bulk.py:

* corpus (build_corpus): n synthetic periodic structures with the Materials
  Project's size skew (lognormal atom counts, median 28, sigma 0.55, clipped
  to [8, 250]; species 1-89; cubic cells of side max(7, 2.2·n^(1/3)·1.6)),
  radius 8 and 12 neighbours, node features the default atom dictionary's
  one-hot plus a degree one-hot of 14 classes (degrees 0-13), min-max normalised distances
  and standard-normal targets, numpy seed `seed`: the reference package's
  corpus array for array. It is cached under build/bench_bulk/;
* configurations (CONFIGS): the reference's 27 names, each a model config's
  extras over CGCNN_demo's widths (MODEL), padded ones at batch
  min(--batch, 64) (BatchSpec.for_dataset sizes a padded batch for the B
  largest graphs) and packed ones at --batch; `all` runs ALL. An unknown name
  raises (the reference runs it as the default CGCNN);
* split: the ids shuffled by numpy seed 0, then 95/5 train/val;
* each configuration (run_config): setup_run at seed 7, `epochs` warm epochs
  at seed 7, then `epochs` timed at seed 8 in the same chunk length (the
  timed run replays the warm run's CUDA graphs), ending in a synchronize;
  its record has the reference's fields, and on CUDA the eager loop's
  s/epoch (`s_per_epoch_eager`, a fresh Run timed the same way) and the
  peak device memory (`peak_mem_mib`). Stream configurations serve the
  corpus from npz shards under build/bench_bulk/ (data/streaming.py) and add
  the host's assembly of a batch (`stream_assembly_ms_per_batch`).

Prints ONE JSON line on stdout, {"n_structures", "batch", "epochs_timed",
"total_edges", "device", "records"}; diagnostics go to stderr. A
configuration that fails is recorded as {"config", "error"}, the others
still run, and the exit code is 1. Runs on CUDA unless --device names the
CPU; a CUDA request without CUDA fails.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from matdeeplearn_torch.bench import _sync, _warm_epoch_s, log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "build", "bench_bulk")
N_DEFAULT = 46744                # the reference's bulk_data corpus
SEED = 7                         # setup_run and the warm run; timed: SEED + 1
SEED_ASSEMBLY = 123
ASSEMBLY_BATCHES = 8
PADDED_BATCH_CAP = 64

# CGCNN_demo's widths (bench_bulk.py's MODEL)
MODEL = {"model": "CGCNN", "dim1": 100, "dim2": 150, "pre_fc_count": 1,
         "gc_count": 4, "post_fc_count": 3, "pool": "global_mean_pool",
         "batch_norm": "True", "act": "relu", "lr": 0.002,
         "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau"}
_PACKED = {"batching": "packed"}
_GCN = {"model": "GCN", "dim1": 100, "dim2": 150}
_MPNN = {"model": "MPNN", "dim1": 100, "dim2": 100, "dim3": 100}
_SCHNET = {"model": "SchNet", "dim3": 150, "cutoff": 8.0}
_MEGNET = {"model": "MEGNet", "dim1": 100, "dim2": 100, "dim3": 100,
           "gc_fc_count": 2}
_BF16 = {"precision": "bf16"}

# name -> (model config extras, streamed from shards)
CONFIGS: dict[str, tuple[dict, bool]] = {
    "fused": ({"kernel": "auto"}, False),
    "xla": ({"kernel": "xla"}, False),
    "packed": ({"kernel": "xla", **_PACKED}, False),
    "packed-csr": ({"kernel": "csr", **_PACKED}, False),
    # the CSR kernels never read kernel_precision: they run f32
    "bf16-packed-csr": ({"kernel": "csr", **_PACKED, **_BF16,
                         "kernel_precision": "bf16"}, False),
    "gcn-packed-csr": ({**_GCN, "kernel": "csr", **_PACKED}, False),
    "mpnn-packed-csr": ({**_MPNN, "kernel": "csr", **_PACKED}, False),
    "schnet-packed-csr": ({**_SCHNET, "kernel": "csr", **_PACKED}, False),
    # csr_order is "src" for MEGNet by default (jobs.csr_side)
    "megnet-packed-csr": ({**_MEGNET, "kernel": "csr", **_PACKED}, False),
    "megnet-packed-csr-dst": ({**_MEGNET, "kernel": "csr", **_PACKED,
                               "csr_order": "dst"}, False),
    "packed-fused": ({"kernel": "fused", **_PACKED}, False),
    "bf16": ({"kernel": "xla", **_BF16}, False),
    "bf16-packed": ({"kernel": "xla", **_PACKED, **_BF16}, False),
    "bf16-packed-fused": ({"kernel": "fused", **_PACKED, **_BF16}, False),
    "mpnn-xla": ({**_MPNN, "kernel": "xla"}, False),
    "mpnn-packed": ({**_MPNN, "kernel": "xla", **_PACKED}, False),
    "mpnn-packed-fused": ({**_MPNN, "kernel": "fused", **_PACKED}, False),
    "mpnn-packed-fused-bf16": ({**_MPNN, "kernel": "fused", **_PACKED,
                                **_BF16}, False),
    "megnet-packed": ({**_MEGNET, "kernel": "xla", **_PACKED}, False),
    "gcn-packed": ({**_GCN, "kernel": "xla", **_PACKED}, False),
    "schnet-packed": ({**_SCHNET, "kernel": "xla", **_PACKED}, False),
    "schnet-xla": ({**_SCHNET, "kernel": "xla"}, False),
    "schnet-fused": ({**_SCHNET, "kernel": "fused"}, False),
    "schnet-packed-fused": ({**_SCHNET, "kernel": "fused", **_PACKED}, False),
    "stream": ({"kernel": "xla"}, True),
    "stream-packed": ({"kernel": "xla", **_PACKED}, True),
    # the wire-format ablation: full f32/i32 batches over the link
    "stream-packed-nowire": ({"kernel": "xla", **_PACKED,
                              "stream_wire": "False"}, True),
}
ALL = ("fused", "xla", "packed", "bf16", "stream")


def build_corpus(n: int, seed: int = 0):
    """The n-structure corpus as a GraphDataset, cached under CACHE."""
    from matdeeplearn_torch.data import graphs as G
    from matdeeplearn_torch.data.dataset import GraphDataset
    from matdeeplearn_torch.data.native import featurize_structures
    from matdeeplearn_torch.data.structures import Structure

    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"bulk_{n}_{seed}.npz")
    ids = [str(i) for i in range(n)]
    if os.path.exists(path):
        log(f"corpus cache hit: {path}")
        with np.load(path, allow_pickle=False) as d:
            arrays = {k: d[k] for k in d.files}
        return GraphDataset(structure_ids=ids, cache_dir=CACHE, **arrays)

    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(np.exp(rng.normal(np.log(28.0), 0.55, n))), 8,
                    250).astype(int)
    log(f"building {n} structures: median {np.median(sizes):.0f} atoms, "
        f"p95 {np.percentile(sizes, 95):.0f}, max {sizes.max()}")
    t0 = time.time()
    structures = []
    for i, na in enumerate(sizes):
        cell = np.eye(3) * max(7.0, 2.2 * na ** (1.0 / 3.0) * 1.6)
        structures.append(Structure(rng.integers(1, 90, na),
                                    rng.random((na, 3)) @ cell, cell,
                                    np.ones(3, bool), str(i)))
    edges = featurize_structures(structures, 8.0, 12)
    if edges is None:  # no g++: the numpy featurizer, the same edges
        edges = tuple(map(list, zip(*(G.build_graph(s, 8.0, 12)
                                      for s in structures))))
    all_src, all_dst, all_dist = edges
    atom_dict = G.default_atom_dictionary()
    xs = [np.concatenate([G.node_features(s.numbers, atom_dict),
                          G.one_hot_degree(src, len(s), 13)], axis=1)
          for s, src in zip(structures, all_src)]
    normed, _, _ = G.normalize_edges(all_dist)
    arrays = dict(
        node_x=np.concatenate(xs).astype(np.float32),
        node_z=np.concatenate([s.numbers for s in structures]).astype(np.int32),
        edge_src=np.concatenate(all_src).astype(np.int32),
        edge_dst=np.concatenate(all_dst).astype(np.int32),
        edge_weight=np.concatenate(all_dist).astype(np.float32),
        edge_dist_norm=np.concatenate(normed).astype(np.float32),
        node_ptr=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        edge_ptr=np.concatenate(
            [[0], np.cumsum([len(e) for e in all_src])]).astype(np.int64),
        y=rng.standard_normal((n, 1)).astype(np.float32),
        u=np.zeros((n, 3), np.float32),
    )
    np.savez(path, **arrays)
    log(f"corpus built in {time.time() - t0:.1f} s -> {path}")
    return GraphDataset(structure_ids=ids, cache_dir=CACHE, **arrays)


def config(name: str, batch: int) -> tuple[dict, bool, int, str]:
    """(extras, streamed, batch, label) of a configuration name; an unknown
    name raises."""
    if name not in CONFIGS:
        raise ValueError(f"unknown configuration {name!r}: expected one of "
                         f"{', '.join(CONFIGS)} or all")
    extra, stream = CONFIGS[name]
    if extra.get("batching") != "packed":
        batch = min(batch, PADDED_BATCH_CAP)
    label = "/".join(filter(None, [
        "streaming" if stream else "in-memory",
        extra.get("model", "CGCNN"),
        extra.get("batching", "padded"),
        extra.get("kernel"),
        "bf16" if extra.get("precision") == "bf16" else None,
        "nowire" if extra.get("stream_wire") == "False" else None,
        extra.get("csr_order"),
        f"b{batch}",
    ]))
    return dict(extra), stream, batch, label


def _release(dev):
    """Free what a dropped Run held (its graphs' private pools included)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def run_config(label: str, ds, extra: dict, tr, va, batch: int, epochs: int,
               device="cuda", stream_dir: str | None = None) -> dict:
    """One configuration's record (the reference's fields, bench_bulk.py's
    run_config, and its training steps an epoch); on CUDA also the eager
    loop's s/epoch and the peak memory. Its Runs are released before it
    returns."""
    from matdeeplearn_torch.data.streaming import load_or_create_sharded
    from matdeeplearn_torch.training import jobs as J
    from matdeeplearn_torch.utils.device import resolve_device
    from matdeeplearn_torch.utils.profiling import (ThroughputMeter,
                                                    attach_analytic_flops,
                                                    device_peaks)

    dev = resolve_device(device)
    dataset = ds if stream_dir is None else load_or_create_sharded(
        ds, stream_dir)
    mp = {**MODEL, "batch_size": batch, "epochs": epochs, **extra}
    train_edges = float(ds.edge_counts()[tr].sum())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = J.setup_run(dataset, mp, "l1_loss", seed=SEED, device=dev)
    setup_s = time.perf_counter() - t0
    steps = run.id_matrix(tr, True, SEED).shape[0]
    meter = ThroughputMeter(num_devices=1, edges_per_epoch=train_edges,
                            graphs_per_epoch=float(len(tr)))
    attach_analytic_flops(
        meter, run.model_name, run.model_config, run.spec, len(tr), len(va),
        batch, fused_kernel=run.fused_kernel,
        steps_per_epoch=steps if mp.get("batching") == "packed" else None)
    # `epochs` warm epochs, then as many timed in the same chunk length,
    # whose CUDA graphs the warm run captured
    kw = dict(train_idx=tr, val_idx=va, epochs=epochs, verbosity=epochs,
              meter=meter)
    t0 = time.perf_counter()
    J.run_fused_training(run, seed=SEED, **kw)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    J.run_fused_training(run, seed=SEED + 1, **kw)
    _sync(dev)
    sec = (time.perf_counter() - t0) / epochs
    peaks = device_peaks(dev)
    rec = {
        "config": label, "s_per_epoch": round(sec, 5),
        "epochs_per_hr": round(3600.0 / sec, 1),
        "edges_per_s_per_chip": round(train_edges / sec),
        "graphs_per_s": round(len(tr) / sec, 1),
        "step_ms": round(sec / steps * 1e3, 3),
        "model_flops_per_s": round(meter.flops_per_epoch / sec),
        "setup_s": round(setup_s, 3), "warmup_s": round(warm_s, 3),
        "kernel_mode": run.kernel, "steps_per_epoch": int(steps),
    }
    if peaks is not None and meter.flops_per_epoch > 0:
        rec["mfu_pct"] = round(
            100.0 * meter.flops_per_epoch / sec / peaks[0], 3)
    if peaks is not None and meter.bytes_per_epoch > 0:
        rec["hbm_util_pct"] = round(
            100.0 * meter.bytes_per_epoch / sec / peaks[1], 3)
    if run.feed is not None:
        # the host's assembly of the first batches of the feed's training
        # epoch at SEED_ASSEMBLY (shard_local_order(tr) cut into batches;
        # packed: its bins), shard reads included
        rows = run.id_matrix(tr, True, SEED_ASSEMBLY)[:ASSEMBLY_BATCHES]
        sds = run.streaming
        t0 = time.perf_counter()
        for row in rows:
            sds.assemble(row, run.spec)
        rec["stream_assembly_ms_per_batch"] = round(
            (time.perf_counter() - t0) / len(rows) * 1e3, 3)
    del run
    _release(dev)
    if dev.type == "cuda":
        rec["peak_mem_mib"] = round(
            torch.cuda.max_memory_allocated(dev) / 2**20, 1)
        # the eager loop on a fresh Run, timed the same way
        rec["s_per_epoch_eager"] = round(_warm_epoch_s(
            dataset, mp, tr, va, dev, capture=False, seed=SEED), 5)
        _release(dev)
    log(f"{label}: {json.dumps(rec)}")
    return rec


def split(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) ids: a shuffle by numpy seed 0, then 95/5."""
    idx = np.arange(n, dtype=np.int64)
    np.random.default_rng(0).shuffle(idx)
    n_tr = int(0.95 * n)
    return idx[:n_tr], idx[n_tr:]


def run_bulk(names, n: int = N_DEFAULT, epochs: int = 3, batch: int = 256,
             device: str = "cuda") -> tuple[dict, int]:
    """(the JSON line's object, the count of failed configurations)."""
    from matdeeplearn_torch.utils.device import resolve_device

    dev = resolve_device(device)
    wanted = [config(name, batch) for name in names]  # unknown names raise
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {kind}")
    ds = build_corpus(n)
    ec = ds.edge_counts()
    log(f"corpus: {len(ds)} graphs, {int(ec.sum()):,} edges, mean "
        f"{ec.mean():.0f} edges/graph")
    tr, va = split(len(ds))
    recs, failed = [], 0
    for name, (extra, stream, b, label) in zip(names, wanted):
        sdir = os.path.join(CACHE, f"shards_{n}") if stream else None
        try:
            recs.append(run_config(label, ds, extra, tr, va, b, epochs, dev,
                                   stream_dir=sdir))
        except Exception as e:  # recorded; the other configurations run
            log(f"config {name} FAILED: {e}\n{traceback.format_exc()}")
            recs.append({"config": name, "error": repr(e)})
            failed += 1
        # a failed configuration's Run is freed with its traceback, here
        _release(dev)
    out = {"n_structures": n, "batch": batch, "epochs_timed": epochs,
           "total_edges": int(ec.sum()), "device": kind, "records": recs}
    return out, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_DEFAULT,
                    help="structures in the corpus")
    ap.add_argument("--epochs", type=int, default=3,
                    help="warm epochs, then as many timed")
    ap.add_argument("--batch", type=int, default=256,
                    help="packed batch (padded: min(batch, 64))")
    ap.add_argument("--configs", default="all",
                    help=f"comma list of {', '.join(CONFIGS)}; all: "
                         f"{','.join(ALL)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a CUDA request without "
                         "CUDA fails")
    args = ap.parse_args(argv)
    names = list(ALL) if args.configs == "all" else args.configs.split(",")
    # the library's progress lines go to stderr: stdout holds the one line
    with contextlib.redirect_stdout(sys.stderr):
        out, failed = run_bulk(names, args.n, args.epochs, args.batch,
                               args.device)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
