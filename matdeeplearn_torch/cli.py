"""The port's CLI: `python -m matdeeplearn_torch --run_mode=<mode> ...`, for
the seven run modes Training, Predict, Repeat, CV, Ensemble, Analysis and
Hyperparameter.

Reads the same config.yml as the reference package's main.py (argparse
flags override YAML; the Job section is keyed by run mode and the Models
section by Job.model, or by every name of Job.ensemble_list for Ensemble;
seed 0 draws a random seed; settings dumped to <job>_settings.txt).
`--device` picks the device (CUDA unless told otherwise). Hyperparameter
writes `<job>_optimized_hyperparameters.json`; Analysis needs
scikit-learn. Training prints the throughput
meter's line ("Throughput: ... edges/s ..., MFU ...") after training;
`--profile True` runs the training under torch.profiler and writes a
Chrome trace (trace.json) to the job's `profile_dir` (default
`<job_name>_profile`). `--batching=packed` trains on budget-packed
batches (the bulk setting). `dataset_type: "large"` in the Processing
section streams the dataset from npz shards of `large_shard_graphs` graphs
(data/streaming.py; a model's `stream_wire` picks the wire batch), for
every run mode.

`--parallel=True` trains Training, Repeat, CV and Ensemble on a (dp, ep)
mesh (parallel/), one process a mesh member, `--ep` members to a replica's
edge group (it must divide the world): under torchrun's environment
(`python -m torch.distributed.run --nproc_per_node=N -m matdeeplearn_torch
... --parallel=True`) each process joins that world; without one, on a
host with k > 1 visible cards, the CLI spawns k workers, one a card (the
reference's main.py lays its mesh over every visible device). A world of
more than one process runs only those modes with --parallel=True. Rank 0
draws the seed for every rank and alone writes the settings, checkpoints
and CSVs.
"""

from __future__ import annotations

import argparse
import os
import pprint
import socket
import time

import numpy as np

RUN_MODES = ("Training", "Predict", "Repeat", "CV", "Ensemble", "Analysis",
             "Hyperparameter")
# the run modes that train on the parallel mesh in the reference package
MESH_MODES = ("Training", "Repeat", "CV", "Ensemble")
# the reference's t-SNE arguments of the Analysis mode (main.py:232-238)
TSNE_ARGS = {"perplexity": 50, "early_exaggeration": 12, "learning_rate": 300,
             "n_iter": 5000, "verbose": 1, "random_state": 42}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MatDeepLearn PyTorch port")
    parser.add_argument("--config_path", default="config.yml", type=str)
    parser.add_argument("--run_mode", default=None, type=str,
                        help="Training, Predict, Repeat, CV, Ensemble, "
                             "Analysis or Hyperparameter")
    parser.add_argument("--job_name", default=None, type=str)
    parser.add_argument("--model", default=None, type=str,
                        help="a Models section of the config, e.g. CGCNN_demo")
    parser.add_argument("--seed", default=None, type=int, help="0=random")
    parser.add_argument("--model_path", default=None, type=str)
    parser.add_argument("--save_model", default=None, type=str)
    parser.add_argument("--load_model", default=None, type=str)
    parser.add_argument("--write_output", default=None, type=str)
    parser.add_argument("--reprocess", default=None, type=str)
    parser.add_argument("--data_path", default=None, type=str)
    parser.add_argument("--format", default=None, type=str)
    parser.add_argument("--train_ratio", default=None, type=float)
    parser.add_argument("--val_ratio", default=None, type=float)
    parser.add_argument("--test_ratio", default=None, type=float)
    parser.add_argument("--verbosity", default=None, type=int)
    parser.add_argument("--target_index", default=None, type=int)
    parser.add_argument("--epochs", default=None, type=int)
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--lr", default=None, type=float)
    parser.add_argument("--kernel", default=None, type=str,
                        choices=["auto", "csr", "fused", "pallas", "xla"],
                        help="conv kernel path (training/jobs.py:resolve_kernel)")
    parser.add_argument("--batching", default=None, type=str,
                        choices=["padded", "packed"],
                        help="padded, or packed: bins of about mean·B + max "
                             "nodes and edges (the bulk setting)")
    parser.add_argument("--parallel", default=None, type=str,
                        help="True = train on a (dp, ep) mesh: torchrun's "
                             "world, or one worker per visible card")
    parser.add_argument("--ep", default=None, type=int,
                        help="edge-parallel members per replica (divides "
                             "the world; default 1)")
    parser.add_argument("--profile", default=None, type=str,
                        help="True = write a torch.profiler Chrome trace of "
                             "the training to profile_dir (default "
                             "<job_name>_profile)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu; a CUDA request without "
                             "CUDA fails")
    return parser


def load_config(args) -> dict:
    """config.yml merged with the command-line flags, for one run mode."""
    import yaml

    if not os.path.exists(args.config_path):
        raise FileNotFoundError("Config file not found in " + args.config_path)
    with open(args.config_path) as f:
        config = yaml.safe_load(f)

    if args.run_mode is not None:
        config["Job"]["run_mode"] = args.run_mode
    run_mode = config["Job"].get("run_mode")
    config["Job"] = config["Job"].get(run_mode)
    if config["Job"] is None:
        raise ValueError(f"Invalid run mode {run_mode!r}")
    config["Job"]["run_mode"] = run_mode

    for key in ("job_name", "model", "seed", "model_path", "load_model",
                "save_model", "write_output", "reprocess", "device",
                "profile", "parallel", "ep"):
        v = getattr(args, key, None)
        if v is not None:
            config["Job"][key] = v
    if args.data_path is not None:
        config["Processing"]["data_path"] = args.data_path
    if args.format is not None:
        config["Processing"]["data_format"] = args.format
    for key in ("train_ratio", "val_ratio", "test_ratio", "verbosity",
                "target_index"):
        v = getattr(args, key, None)
        if v is not None:
            config["Training"][key] = v
    for mkey in config["Models"]:
        for key in ("epochs", "batch_size", "lr", "kernel", "batching"):
            v = getattr(args, key, None)
            if v is not None:
                config["Models"][mkey][key] = v
    if run_mode == "Predict":
        config["Models"] = {}
    elif run_mode == "Ensemble":
        ens = config["Job"]["ensemble_list"]
        if isinstance(ens, str):
            ens = ens.split(",")
        config["Job"]["ensemble_list"] = ens
        config["Models"] = {name: config["Models"].get(name) for name in ens}
    elif run_mode in RUN_MODES:
        config["Models"] = config["Models"].get(config["Job"]["model"])
    if config["Job"].get("seed", 0) == 0:
        config["Job"]["seed"] = int(np.random.randint(1, 1e6))
    return config


def run(config: dict):
    """Run one configured job. Returns what its job function returns:
    Training its errors by split, Predict its test error, CV its mean
    error, Repeat its (trials, 3) errors, Ensemble its ensemble's error,
    Analysis the t-SNE coordinates, Hyperparameter the best trial. Spawned
    workers (spawn_workers) return None here."""
    import torch

    run_mode = config["Job"]["run_mode"]
    if run_mode not in RUN_MODES:
        raise ValueError(f"Invalid run mode {run_mode!r}")
    device = config["Job"].get("device", "cuda")
    parallel = (str(config["Job"].get("parallel")) == "True"
                and run_mode in MESH_MODES)
    if (parallel and "WORLD_SIZE" not in os.environ
            and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1):
        # the reference package trains on a mesh over every visible chip
        return spawn_workers(config, torch.cuda.device_count())
    mesh = join_mesh(config, parallel, device)
    try:
        return _run_job(config, run_mode, device if mesh is None
                        else mesh.device, mesh)
    finally:
        if mesh is not None and mesh.world_group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def join_mesh(config: dict, parallel: bool, device):
    """The run's mesh (parallel/mesh.py), or None. Under torchrun's
    environment the process joins the world (a failed rendezvous raises);
    with `parallel` the mesh takes `ep` from the Job section (it must
    divide the world), and every rank takes rank 0's seed and seeds
    numpy's global generator with it (Repeat draws its trials' seeds
    there). A world of more than one process without `parallel` (or in a
    run mode without a mesh) raises."""
    import torch
    import torch.distributed as dist

    from matdeeplearn_torch.parallel.mesh import (make_mesh,
                                                  maybe_initialize_distributed)

    if not maybe_initialize_distributed(device):
        return None
    if not parallel:
        world = dist.get_world_size()
        dist.destroy_process_group()
        if world > 1:
            raise ValueError(f"a world of {world} processes needs "
                             "--parallel=True and a run mode of "
                             f"{', '.join(MESH_MODES)}")
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(ep=int(config["Job"].get("ep") or 1), device=dev)
    seed = torch.tensor([int(config["Job"]["seed"])], device=dev)
    dist.broadcast(seed, 0)
    config["Job"]["seed"] = int(seed)
    np.random.seed(config["Job"]["seed"])
    print(f"Using mesh: dp={mesh.dp}, ep={mesh.ep} (rank {mesh.rank}, "
          f"{mesh.backend}, {mesh.device})")
    return mesh


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_worker(config: dict, rank: int, world: int, port: int):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    run(config)


def spawn_workers(config: dict, world: int):
    """Run the job on `world` spawned workers, one a card, as a torchrun
    world on this host would (rendezvous on a free localhost port). Waits
    for them; raises if one fails. Returns None: the workers hold the
    results (rank 0 writes the files)."""
    import multiprocessing

    port = _free_port()
    print(f"parallel: {world} visible cards, spawning {world} workers")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned_worker,
                         args=(config, rank, world, port))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"parallel workers {failed} failed (exit codes "
                           f"{[procs[r].exitcode for r in failed]})")
    return None


def _run_job(config: dict, run_mode: str, device, mesh):
    """run()'s job, on `device`, on `mesh` (None: no mesh)."""
    import torch.distributed

    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.training import jobs

    print("Settings: ")
    pprint.pprint(config)
    if mesh is None or mesh.is_main:
        with open(str(config["Job"]["job_name"]) + "_settings.txt",
                  "w") as log_file:
            pprint.pprint(config, log_file)

    if run_mode == "Hyperparameter":
        return run_hyperparameter(config)
    t0 = time.time()
    # in a world, rank 0 processes (or reads) the cache, the others then
    # read what it wrote
    ordered = mesh is not None and mesh.world_group is not None
    if ordered and not mesh.is_main:
        torch.distributed.barrier()
    dataset = get_dataset(
        config["Processing"]["data_path"],
        config["Training"]["target_index"],
        config["Job"].get("reprocess", "False")
        if mesh is None or mesh.is_main else "False",
        config["Processing"],
    )
    if ordered and mesh.is_main:
        torch.distributed.barrier()
    print(
        f"Dataset used: {len(dataset)} graphs, {dataset.num_features} node"
        f" features, {dataset.num_edge_features} edge features"
    )
    print("--- %s seconds for processing ---" % (time.time() - t0))
    args = (dataset, config["Job"], config["Training"], config["Models"])
    if run_mode == "Training":
        print("Starting regular training")
        return jobs.train_regular(*args, device=device, mesh=mesh)
    if run_mode == "Predict":
        print("Starting prediction from trained model")
        return jobs.predict(dataset, config["Training"]["loss"], config["Job"],
                            device=device)
    if run_mode == "Repeat":
        print(f"Repeat training for {config['Job']['repeat_trials']} trials")
        return jobs.train_repeat(*args, device=device, mesh=mesh)
    if run_mode == "CV":
        print("Starting cross validation")
        return jobs.train_CV(*args, device=device, mesh=mesh)
    if run_mode == "Ensemble":
        print("Starting ensemble training")
        return jobs.train_ensemble(*args, device=device, mesh=mesh)
    print("Starting analysis of graph features")
    return jobs.analysis(dataset, config["Job"]["model_path"], TSNE_ARGS,
                         device=device)


def run_hyperparameter(config: dict) -> dict:
    """The Hyperparameter run mode (reference main.py:242-268): the model's
    default search space (training/hyper.py), the sweep, and the best
    config, rounded to 6 digits, in `<job>_optimized_hyperparameters.json`.
    The dataset is loaded once here unless reprocess is "True" (then every
    trial processes it)."""
    import json

    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.training import hyper as H

    job = config["Job"]
    print("Starting hyperparameter optimization")
    print(f"running for {config['Models']['epochs']} epochs on "
          f"{job['model']} model")
    data_path = config["Processing"]["data_path"]
    dataset = None
    if str(job.get("reprocess", "False")) == "False":
        dataset = get_dataset(data_path, config["Training"]["target_index"],
                              "False", config["Processing"])
    space = H.default_search_space(job["model"], config["Processing"])
    best = H.tune_setup(space, job, config["Processing"], config["Training"],
                        config["Models"], data_path=data_path, dataset=dataset)
    hyperparameters = {k: round(v, 6) if isinstance(v, float) else v
                       for k, v in best["config"].items()}
    with open(f"{job['job_name']}_optimized_hyperparameters.json", "w",
              encoding="utf-8") as f:
        json.dump(hyperparameters, f, ensure_ascii=False, indent=4)
    print("Best hyperparameters written")
    return best


def main(argv=None):
    start_time = time.time()
    print("Starting...")
    config = load_config(build_parser().parse_args(argv))
    run(config)
    print("--- %s total seconds elapsed ---" % (time.time() - start_time))
