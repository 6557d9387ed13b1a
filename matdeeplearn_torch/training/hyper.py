"""Hyperparameter search: the port's trial runner (the reference package's
training/hyper.py, on the port's trainer).

The reference delegates to Ray Tune + HyperOptSearch with checkpointed,
resumable trials (training/training.py:846-1065, main.py:367-509). Ray's
role there is host-level orchestration; here it is a dependency-free
runner with:

  * the same per-model search spaces (main.py:402-479) in a small space
    DSL (Choice / Uniform / LogUniform) and the same TPE suggester
    (`suggest_tpe`, numpy only, the same draws from the same generator as
    the reference package's);
  * median-rule early stopping at rungs (a quarter and half of the
    epochs): a trial whose val error trails the median of the finished
    trials at a rung stops;
  * resumable state: every trial appends to results/<job>/trials.jsonl and
    is skipped on a re-run; an interrupted trial whose trial_<t>.ckpt
    exists continues from its recorded epoch with its first config
    (hyper_resume, config.yml:54);
  * per-trial reprocessing into a timestamped directory when processing
    keys (SOAP rcut/nmax/lmax/sigma, the graph radius and neighbours) are
    sampled (reference training.py:872-875);
  * `hyper_concurrency` trials at once in spawned worker processes, one
    trial a process (max_tasks_per_child=1), each pinned to one card of a
    multi-card host through CUDA_VISIBLE_DEVICES, set before the worker
    touches CUDA; up to `max_failures` crashed trials are recorded and
    tolerated (reference training.py:1051).

Each trial builds its own Run (and its own CUDA graphs) and drops it; the
reference's "gnn_count" key, which its models ignore, is searched as
gc_count, as the reference package does. This module imports numpy only at
import time: the jobs, the dataset and torch load inside the functions, so
a spawned worker sets its card before torch is imported.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np


# ------------------------------------------------------------------ space DSL


@dataclass(frozen=True)
class Choice:
    options: tuple

    def sample(self, rng):
        return self.options[int(rng.integers(len(self.options)))]


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float

    def sample(self, rng):
        return float(rng.uniform(self.lo, self.hi))


@dataclass(frozen=True)
class LogUniform:
    lo: float
    hi: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))


def sample_space(space: dict, rng) -> dict:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if hasattr(v, "sample") else v
    return out


# -------------------------------------------------------------- TPE suggester


def _norm_logpdf(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2 - np.log(sigma) - 0.9189385332046727


def _kde_logdensity(x, centers, lo, hi):
    """Parzen-window log density: Gaussian mixture at observed points with a
    range-scaled bandwidth (HyperOpt-style heuristic) plus a uniform prior
    component so unexplored regions keep nonzero mass."""
    centers = np.asarray(centers, np.float64)
    span = max(hi - lo, 1e-12)
    sigma = max(span / max(np.sqrt(len(centers)), 1.0), 1e-3 * span)
    comp = _norm_logpdf(x, centers, sigma)  # (n_centers,)
    # mixture of the n kernels and one uniform(lo,hi) pseudo-kernel
    logs = np.concatenate([comp, [np.log(1.0 / span)]])
    return float(np.logaddexp.reduce(logs) - np.log(len(logs)))


def suggest_tpe(
    space: dict,
    results: list[dict],
    rng,
    n_initial: int = 5,
    gamma: float = 0.25,
    n_candidates: int = 24,
) -> dict:
    """Tree-structured Parzen Estimator suggestion (the reference's
    HyperOptSearch role, training/training.py:1004-1007, 5 initial points).

    Below `n_initial` completed trials: plain random sampling (identical
    rng stream to sample_space, so early trials are reproducible). After:
    split completed trials at the `gamma` quantile of val error into
    good/bad sets, model each dimension with Parzen windows l(x) (good) and
    g(x) (bad), draw `n_candidates` from l, keep the candidate maximizing
    Σ_dims log l(x)/g(x) (per-dimension independent TPE, as HyperOpt)."""
    obs = [
        (r["config"], float(r["best_val"]))
        for r in results
        if np.isfinite(r.get("best_val", np.inf))
    ]
    if len(obs) < n_initial:
        return sample_space(space, rng)
    obs.sort(key=lambda cv: cv[1])
    n_good = max(1, int(np.ceil(gamma * len(obs))))
    good = [c for c, _ in obs[:n_good]]
    bad = [c for c, _ in obs[n_good:]] or good

    best_cand, best_score = None, -np.inf
    for _ in range(n_candidates):
        cand, score = {}, 0.0
        for k, dist in space.items():
            if not hasattr(dist, "sample"):
                cand[k] = dist
                continue
            gv = [c[k] for c in good if k in c]
            bv = [c[k] for c in bad if k in c]
            if not gv or not bv:
                cand[k] = dist.sample(rng)
                continue
            if isinstance(dist, Choice):
                opts = list(dist.options)
                idx = {o: i for i, o in enumerate(opts)}
                pg = np.ones(len(opts))
                pb = np.ones(len(opts))
                for v in gv:
                    pg[idx[v]] += 1
                for v in bv:
                    pb[idx[v]] += 1
                pg /= pg.sum()
                pb /= pb.sum()
                i = int(rng.choice(len(opts), p=pg))
                cand[k] = opts[i]
                score += float(np.log(pg[i]) - np.log(pb[i]))
            else:
                logspace = isinstance(dist, LogUniform)
                tx = np.log if logspace else (lambda v: np.asarray(v, float))
                lo, hi = float(tx(dist.lo)), float(tx(dist.hi))
                gl = [float(tx(v)) for v in gv]
                bl = [float(tx(v)) for v in bv]
                span = max(hi - lo, 1e-12)
                sigma = max(span / max(np.sqrt(len(gl)), 1.0), 1e-3 * span)
                x = float(np.clip(
                    gl[int(rng.integers(len(gl)))] + sigma * rng.normal(),
                    lo, hi,
                ))
                score += (_kde_logdensity(x, gl, lo, hi)
                          - _kde_logdensity(x, bl, lo, hi))
                cand[k] = float(np.exp(x)) if logspace else x
        if score > best_score:
            best_cand, best_score = cand, score
    return best_cand


_DIMS = Choice(tuple(x * 10 for x in range(1, 20)))
_BATCH = Choice(tuple(x * 10 for x in range(1, 20)))
_GC = Choice((1, 2, 3, 4, 5, 6, 7, 8, 9))
_POST = Choice((1, 2, 3, 4, 5, 6))
_POOL = Choice(("global_mean_pool", "global_add_pool", "global_max_pool", "set2set"))
_LR = LogUniform(1e-4, 0.05)


def default_search_space(model_name: str, processing_args: dict | None = None) -> dict:
    """Per-model spaces matching main.py:402-479 (gnn_count → gc_count)."""
    base = {
        "dim1": _DIMS, "dim2": _DIMS, "gc_count": _GC, "post_fc_count": _POST,
        "pool": _POOL, "lr": _LR, "batch_size": _BATCH,
    }
    name = model_name.split("_")[0]
    if name in ("SchNet",):
        return {**base, "dim3": _DIMS,
                "cutoff": (processing_args or {}).get("graph_max_radius", 8.0)}
    if name in ("MPNN", "MEGNet"):
        return {**base, "dim3": _DIMS}
    if name == "SOAP":
        return {"dim1": _DIMS, "fc_count": _POST, "lr": _LR, "batch_size": _BATCH,
                "SOAP_nmax": _GC, "SOAP_lmax": _GC,
                "SOAP_sigma": Uniform(0.1, 2.0), "SOAP_rcut": Uniform(1.0, 10.0)}
    if name == "SM":
        return {"dim1": _DIMS, "fc_count": _POST, "lr": _LR, "batch_size": _BATCH}
    return base


_PROCESSING_KEYS = {
    "SOAP_nmax", "SOAP_lmax", "SOAP_sigma", "SOAP_rcut",
    "graph_max_radius", "graph_max_neighbors", "graph_edge_length",
}


# ---------------------------------------------------------------- trial runner


def _trial_dir(job_name: str) -> str:
    d = os.path.join("results", str(job_name))
    os.makedirs(d, exist_ok=True)
    return d


def _load_completed(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_trial(dataset, trial_config: dict, job_parameters: dict,
              training_parameters: dict, model_parameters: dict, *,
              report_every: int = 1,
              rung_checks: list[tuple[int, float]] | None = None,
              checkpoint_path: str | None = None, seed: int = 0,
              resume_from_checkpoint: bool = False):
    """Train one sampled config; returns (best val error, history).

    The trainer (jobs.run_fused_training, CUDA graphs on a card) runs in
    chunks of `report_every` epochs. After each chunk the val error of its
    last epoch goes to the history, and the last state (parameters,
    statistics, optimizer, scheduler, with the epoch and best_val in the
    header) to `checkpoint_path`; at a rung epoch (rung_checks: [(epoch,
    median val so far)]) a val error above the median ends the trial.
    With resume_from_checkpoint an interrupted trial continues from its
    recorded epoch, not from epoch 1 (reference training.py:932-939).

    trial_<t>.ckpt is a resume point, the last state of the latest report,
    not the best-val model: the winning weights come from retraining the
    best config (the optimized hyperparameters JSON)."""
    from matdeeplearn_torch.data import dataset as D
    from matdeeplearn_torch.training.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from matdeeplearn_torch.training.jobs import (_sync_scheduler,
                                                  run_fused_training,
                                                  setup_run)
    from matdeeplearn_torch.training.optimizers import optimizer_state

    mp = {**model_parameters, **{k: v for k, v in trial_config.items()
                                 if k not in _PROCESSING_KEYS}}
    loss = training_parameters.get("loss", "l1_loss")
    epochs = int(mp.get("epochs", 250))
    train_idx, val_idx, _ = D.split_data(
        dataset,
        training_parameters.get("train_ratio", 0.8),
        training_parameters.get("val_ratio", 0.05),
        training_parameters.get("test_ratio", 0.15),
        seed=seed,
    )
    run = setup_run(dataset, mp, loss, seed=seed, print_model=False,
                    device=job_parameters.get("device"))
    best_val = float("inf")
    start_epoch = 0
    plateau_start = None
    if (resume_from_checkpoint and checkpoint_path
            and os.path.exists(checkpoint_path)):
        meta, state_dict, opt_state = load_checkpoint(checkpoint_path,
                                                      with_optimizer=True)
        run.model.load_state_dict(state_dict)
        if opt_state is not None:
            run.load_optimizer_state(opt_state)
        if meta.get("scheduler"):
            run.scheduler = type(run.scheduler).from_state_dict(
                meta["scheduler"])
        start_epoch = int(meta.get("epoch", 0))
        best_val = float(meta.get("best_val", np.inf))
        sch = run.scheduler
        plateau_start = (
            float(sch.lr),
            float("inf") if getattr(sch, "best", None) is None else sch.best,
            int(getattr(sch, "num_bad_epochs", 0)),
            int(getattr(sch, "cooldown_counter", 0)))
        print(f"resuming trial from epoch {start_epoch} "
              f"(best_val={best_val:.5f})")
    history = []
    rungs = dict(rung_checks or [])
    best = [best_val]

    def chunk_fn(epoch, rows, sched):
        val_error = float(rows[-1][1])
        history.append({"epoch": epoch, "train": float(rows[-1][0]),
                        "val": val_error})
        if np.isfinite(val_error):
            best[0] = min(best[0], val_error)
        if checkpoint_path:
            _sync_scheduler(run, sched)
            save_checkpoint(checkpoint_path, run.model.state_dict(),
                            run.model_name, run.model_config, run.scheduler,
                            extra_meta={"epoch": epoch, "best_val": best[0]},
                            optimizer_state=optimizer_state(run.optimizer))
        if (epoch in rungs and np.isfinite(rungs[epoch])
                and val_error > rungs[epoch]):
            history.append({"epoch": epoch, "stopped": "median_rule"})
            return True
        return False

    if epochs > start_epoch:
        run_fused_training(
            run, train_idx=train_idx, val_idx=val_idx,
            epochs=epochs - start_epoch, verbosity=report_every, seed=seed,
            start_epoch=start_epoch, plateau_start=plateau_start,
            chunk_fn=chunk_fn)
    return best[0], history


def _execute_trial(payload: dict) -> dict:
    """Run one trial from a picklable payload; returns its result record.

    Top-level, so spawned worker processes can import it. payload
    ["device_env"] goes into os.environ first: in a fresh worker a trial
    (max_tasks_per_child=1) it pins the trial to one card
    (CUDA_VISIBLE_DEVICES) before anything here imports torch. Then it
    loads the dataset (or takes the payload's), reprocessing into
    processed_hyper_<stamp>_<trial> when processing keys were sampled,
    trains, and removes that directory."""
    denv = payload.get("device_env") or {}
    os.environ.update({k: str(v) for k, v in denv.items()})
    from matdeeplearn_torch.data import dataset as D

    t = payload["trial"]
    cfg = payload["config"]
    data_path = payload["data_path"]
    trial_ds = payload.get("dataset")
    proc_dir = None
    if trial_ds is None:
        pargs = {**payload["processing_parameters"],
                 **{k: v for k, v in cfg.items() if k in _PROCESSING_KEYS}}
        if payload["needs_reprocess"]:
            proc_dir = f"processed_hyper_{payload['stamp']}_{t}"
            pargs["processed_path"] = proc_dir
        trial_ds = D.get_dataset(
            data_path, payload["training_parameters"].get("target_index", 0),
            "False", pargs)
    t0 = time.time()
    try:
        best_val, history = run_trial(
            trial_ds, cfg, payload["job_parameters"],
            payload["training_parameters"], payload["model_parameters"],
            report_every=payload["report_every"],
            rung_checks=payload["rung_checks"],
            checkpoint_path=payload["checkpoint_path"],
            seed=payload["seed"],
            resume_from_checkpoint=payload.get("resume_trial", False))
    finally:
        if proc_dir and payload["delete_processed"] and data_path:
            import shutil

            full = os.path.join(data_path, proc_dir)
            if os.path.exists(full):
                shutil.rmtree(full)
    rec = {"trial": t, "config": cfg, "best_val": best_val,
           "history": history, "seconds": time.time() - t0}
    if denv:
        rec["device_env"] = denv
    return rec


def _rung_checks(rung_epochs, results) -> list[tuple[int, float]]:
    """Median val error of completed trials at each rung epoch."""
    out = []
    for re_ in rung_epochs:
        vals = [h["val"] for r in results for h in r.get("history", [])
                if h.get("epoch") == re_ and "val" in h]
        out.append((re_, float(np.median(vals)) if vals else float("inf")))
    return out


def _card_slots(concurrency: int, device: str) -> tuple[int, list | None]:
    """(concurrency, card ids) of a sweep: on a CUDA device with several
    visible cards one card a concurrent trial (the ids to pin them to);
    with one card the trials run serially, unless
    MDL_HYPER_FORCE_CONCURRENCY is set; off CUDA workers are not pinned
    (None)."""
    if concurrency <= 1 or not str(device).startswith("cuda"):
        return concurrency, None
    import torch

    n_cards = torch.cuda.device_count()
    if n_cards <= 1:
        if os.environ.get("MDL_HYPER_FORCE_CONCURRENCY"):
            return concurrency, None
        print(f"hyper_concurrency={concurrency} requested but this host has "
              "one CUDA card, which serves one process; running trials "
              "serially")
        return 1, None
    concurrency = min(concurrency, n_cards)
    print(f"pinning {concurrency} concurrent trials to one CUDA card each "
          f"({n_cards} cards visible)")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([c.strip() for c in visible.split(",")] if visible
           else [str(i) for i in range(n_cards)])
    return concurrency, ids[:n_cards]


def tune_setup(search_space: dict, job_parameters: dict,
               processing_parameters: dict, training_parameters: dict,
               model_parameters: dict, data_path: str | None = None,
               dataset=None) -> dict:
    """Run the search; returns {"config", "best_val", "trial", ...} of the
    winner (reference tune_setup, training/training.py:981-1065).

    hyper_search "tpe" (default; 5 random initial points, as the
    reference's HyperOptSearch) or "random"; hyper_trials, hyper_iter (the
    report interval), hyper_resume, hyper_delete_processed,
    hyper_concurrency, max_failures and seed as in config.yml. The trials
    run on job_parameters["device"] (CUDA by default). Resume: finished
    trials are skipped; an interrupted trial whose checkpoint exists
    continues mid-training with the config it started with (a "started"
    record); failed trials without a checkpoint are retried from
    scratch."""
    job_name = str(job_parameters.get("job_name", "hyper_job"))
    trials = int(job_parameters.get("hyper_trials", 10))
    report_every = int(job_parameters.get("hyper_iter", 1))
    resume = str(job_parameters.get("hyper_resume", "True")) == "True"
    delete_processed = str(
        job_parameters.get("hyper_delete_processed", "True")) == "True"
    seed = int(job_parameters.get("seed") or np.random.randint(1, 1_000_000))
    max_failures = int(job_parameters.get("max_failures", 4))
    search = str(job_parameters.get("hyper_search", "tpe")).lower()
    concurrency, card_ids = _card_slots(
        int(job_parameters.get("hyper_concurrency", 1)),
        job_parameters.get("device", "cuda"))

    tdir = _trial_dir(job_name)
    log_path = os.path.join(tdir, "trials.jsonl")
    done = _load_completed(log_path) if resume else []
    # failed records do not block a retry on resume
    done_ids = {d["trial"] for d in done if "best_val" in d}
    # the config each trial started with (for mid-training resume)
    started_cfgs = {d["trial"]: d["config"] for d in done
                    if d.get("event") == "started"}
    if not resume and os.path.exists(log_path):
        os.remove(log_path)
        done = []

    epochs = int(model_parameters.get("epochs", 250))
    rung_epochs = sorted({max(1, epochs // 4), max(1, epochs // 2)})
    needs_reprocess = any(k in _PROCESSING_KEYS for k in search_space)
    results = [d for d in done if "best_val" in d]
    stamp = int(time.time())

    def payload_for(t: int) -> dict:
        rng = np.random.default_rng(seed + 1000 * t)
        ckpt = os.path.join(tdir, f"trial_{t}.ckpt")
        resume_trial = bool(resume and t in started_cfgs
                            and os.path.exists(ckpt))
        if resume_trial:
            cfg = started_cfgs[t]
        elif search == "tpe":
            cfg = suggest_tpe(search_space, results, rng)
        else:
            cfg = sample_space(search_space, rng)
        return {
            "trial": t, "config": cfg, "seed": seed, "stamp": stamp,
            "resume_trial": resume_trial, "data_path": data_path,
            # the in-memory dataset only where there is no path to load
            # from (worker processes read the processed cache instead)
            "dataset": (dataset if (data_path is None and not needs_reprocess)
                        else None),
            "needs_reprocess": needs_reprocess,
            "delete_processed": delete_processed,
            "report_every": report_every,
            "rung_checks": _rung_checks(rung_epochs, results),
            "checkpoint_path": ckpt,
            "job_parameters": dict(job_parameters),
            "training_parameters": dict(training_parameters),
            "model_parameters": dict(model_parameters),
            "processing_parameters": dict(processing_parameters or {}),
        }

    def record(rec: dict):
        if "best_val" in rec:
            results.append(rec)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if rec.get("event") == "started":
            return
        if "best_val" in rec:
            print(f"Trial {rec['trial']}: val={rec['best_val']:.5f} "
                  f"config={rec['config']}")
        else:
            print(f"Trial {rec['trial']} FAILED: {rec['error']}")

    def record_start(p: dict):
        if not p["resume_trial"]:
            record({"trial": p["trial"], "config": p["config"],
                    "event": "started"})

    def failed(p: dict, e: Exception) -> RuntimeError | None:
        nonlocal failures
        failures += 1
        record({"trial": p["trial"], "config": p["config"], "error": repr(e)})
        if failures > max_failures:
            return RuntimeError(
                f"hyperparameter sweep aborted: {failures} trial failures "
                f"exceed max_failures={max_failures}")
        return None

    pending = [t for t in range(trials) if t not in done_ids]
    failures = 0
    if concurrency <= 1:
        for t in pending:
            p = payload_for(t)
            if dataset is not None and not needs_reprocess:
                p["dataset"] = dataset  # reusable in-process
            record_start(p)
            try:
                record(_execute_trial(p))
            except Exception as e:  # noqa: BLE001 - trial crash tolerance
                abort = failed(p, e)
                if abort is not None:
                    raise abort from e
    else:
        import concurrent.futures as cf
        import multiprocessing as mp

        slots = list(range(concurrency))

        def device_env(slot: int) -> dict:
            env = {"MDL_TRIAL_SLOT": str(slot)}
            if card_ids is not None:
                env["CUDA_VISIBLE_DEVICES"] = card_ids[slot]
            return env

        # spawn, never fork (the parent may hold a CUDA context); a fresh
        # worker a trial, so its device_env applies before torch loads
        with cf.ProcessPoolExecutor(
                max_workers=concurrency, mp_context=mp.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            running: dict = {}
            it = iter(pending)
            abort = None
            while True:
                while abort is None and len(running) < concurrency and slots:
                    t = next(it, None)
                    if t is None:
                        break
                    p = payload_for(t)
                    p["device_env"] = device_env(slots.pop(0))
                    record_start(p)
                    running[pool.submit(_execute_trial, p)] = p
                if not running:
                    break
                ready, _ = cf.wait(list(running),
                                   return_when=cf.FIRST_COMPLETED)
                for fut in ready:
                    p = running.pop(fut)
                    slots.append(int(p["device_env"]["MDL_TRIAL_SLOT"]))
                    try:
                        record(fut.result())
                    except Exception as e:  # noqa: BLE001 - crash tolerance
                        abort = abort or failed(p, e)
            if abort is not None:
                raise abort

    if not results:
        raise RuntimeError("no hyperparameter trial finished successfully")
    best = min(results, key=lambda r: r["best_val"])
    print("Best trial hyper_args: {}".format(best["config"]))
    print("Best trial final validation error: {:.5f}".format(best["best_val"]))
    return best
