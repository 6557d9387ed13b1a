"""The port's CLI: `python -m matdeeplearn_torch --run_mode=Training|Predict ...`.

Reads the same config.yml as the reference package's main.py (argparse
flags override YAML; the Job section is keyed by run mode and the Models
section by Job.model; seed 0 draws a random seed; settings dumped to
<job>_settings.txt). Training and Predict are ported; `--device` picks the
device (CUDA unless told otherwise). Training prints the throughput
meter's line ("Throughput: ... edges/s ..., MFU ...") after training;
`--profile True` runs the training under torch.profiler and writes a
Chrome trace (trace.json) to the job's `profile_dir` (default
`<job_name>_profile`). `--batching=packed` trains on budget-packed
batches (the bulk setting). main.py's `--parallel` and `--ep` raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import pprint
import time

import numpy as np

# ROADMAP queue 1 items of the run modes still to port.
NOT_PORTED = {
    "Repeat": "item 13", "CV": "item 13", "Ensemble": "item 13",
    "Analysis": "item 13", "Hyperparameter": "item 13",
}
RUN_MODES = ("Training", "Predict")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MatDeepLearn PyTorch port")
    parser.add_argument("--config_path", default="config.yml", type=str)
    parser.add_argument("--run_mode", default=None, type=str,
                        help="Training or Predict (other run modes are not "
                             "ported yet)")
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
                        help="not ported yet (ROADMAP queue 1, item 16)")
    parser.add_argument("--ep", default=None, type=int,
                        help="not ported yet (ROADMAP queue 1, item 16)")
    parser.add_argument("--profile", default=None, type=str,
                        help="True = write a torch.profiler Chrome trace of "
                             "the training to profile_dir (default "
                             "<job_name>_profile)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu; a CUDA request without "
                             "CUDA fails")
    return parser


def _refuse_unported_flags(args):
    if args.parallel == "True" or (args.ep or 1) > 1:
        raise NotImplementedError(
            "--parallel/--ep (data and edge parallelism) are not ported yet "
            "(ROADMAP queue 1, item 16)")


def load_config(args) -> dict:
    """config.yml merged with the command-line flags, for one run mode."""
    import yaml

    _refuse_unported_flags(args)
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
                "profile"):
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
    elif run_mode in RUN_MODES:
        config["Models"] = config["Models"].get(config["Job"]["model"])
    if config["Job"].get("seed", 0) == 0:
        config["Job"]["seed"] = int(np.random.randint(1, 1e6))
    return config


def run(config: dict):
    """Run one configured job: Training returns its errors by split,
    Predict its test error."""
    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.training.jobs import predict, train_regular

    run_mode = config["Job"]["run_mode"]
    if run_mode in NOT_PORTED:
        raise NotImplementedError(
            f"run mode {run_mode} is not ported yet (ROADMAP queue 1, "
            f"{NOT_PORTED[run_mode]})")
    if run_mode not in RUN_MODES:
        raise ValueError(f"Invalid run mode {run_mode!r}")
    device = config["Job"].get("device", "cuda")
    if (run_mode == "Training" and str(config["Job"].get("parallel")) == "True"
            and str(device).startswith("cuda")):
        import torch

        if torch.cuda.device_count() > 1:
            # the reference package trains on a mesh over every visible chip
            raise NotImplementedError(
                "parallel: True with several visible cards is not ported yet "
                "(ROADMAP queue 1, item 16); make one card visible or set "
                "parallel: False")

    print("Settings: ")
    pprint.pprint(config)
    with open(str(config["Job"]["job_name"]) + "_settings.txt", "w") as log_file:
        pprint.pprint(config, log_file)

    t0 = time.time()
    dataset = get_dataset(
        config["Processing"]["data_path"],
        config["Training"]["target_index"],
        config["Job"].get("reprocess", "False"),
        config["Processing"],
    )
    print(
        f"Dataset used: {len(dataset)} graphs, {dataset.num_features} node"
        f" features, {dataset.num_edge_features} edge features"
    )
    print("--- %s seconds for processing ---" % (time.time() - t0))
    if run_mode == "Training":
        print("Starting regular training")
        return train_regular(dataset, config["Job"], config["Training"],
                             config["Models"], device=device)
    print("Starting prediction from trained model")
    return predict(dataset, config["Training"]["loss"], config["Job"],
                   device=device)


def main(argv=None):
    start_time = time.time()
    print("Starting...")
    config = load_config(build_parser().parse_args(argv))
    run(config)
    print("--- %s total seconds elapsed ---" % (time.time() - start_time))
