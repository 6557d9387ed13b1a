"""The port's CLI: `python -m matdeeplearn_torch --run_mode=Predict ...`.

Reads the same config.yml as the reference package's main.py (argparse
flags override YAML; the Job section is keyed by run mode; seed 0 draws a
random seed; settings dumped to <job>_settings.txt). Only Predict is
ported; `--device` picks the device (CUDA unless told otherwise).
"""

from __future__ import annotations

import argparse
import os
import pprint
import time

import numpy as np

# ROADMAP queue 1 items of the run modes still to port.
NOT_PORTED = {
    "Training": "items 6-7", "Repeat": "item 13", "CV": "item 13",
    "Ensemble": "item 13", "Analysis": "item 13", "Hyperparameter": "item 13",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MatDeepLearn PyTorch port")
    parser.add_argument("--config_path", default="config.yml", type=str)
    parser.add_argument("--run_mode", default=None, type=str,
                        help="Predict (other run modes are not ported yet)")
    parser.add_argument("--job_name", default=None, type=str)
    parser.add_argument("--seed", default=None, type=int, help="0=random")
    parser.add_argument("--model_path", default=None, type=str)
    parser.add_argument("--write_output", default=None, type=str)
    parser.add_argument("--reprocess", default=None, type=str)
    parser.add_argument("--data_path", default=None, type=str)
    parser.add_argument("--format", default=None, type=str)
    parser.add_argument("--target_index", default=None, type=int)
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

    for key in ("job_name", "seed", "model_path", "write_output", "reprocess",
                "device"):
        v = getattr(args, key, None)
        if v is not None:
            config["Job"][key] = v
    if args.data_path is not None:
        config["Processing"]["data_path"] = args.data_path
    if args.format is not None:
        config["Processing"]["data_format"] = args.format
    if args.target_index is not None:
        config["Training"]["target_index"] = args.target_index
    if run_mode == "Predict":
        config["Models"] = {}
    if config["Job"].get("seed", 0) == 0:
        config["Job"]["seed"] = int(np.random.randint(1, 1e6))
    return config


def run(config: dict) -> float:
    """Run one configured job; returns Predict's test error."""
    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.training.jobs import predict

    run_mode = config["Job"]["run_mode"]
    if run_mode in NOT_PORTED:
        raise NotImplementedError(
            f"run mode {run_mode} is not ported yet (ROADMAP queue 1, "
            f"{NOT_PORTED[run_mode]})")
    if run_mode != "Predict":
        raise ValueError(f"Invalid run mode {run_mode!r}")

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
    print("Starting prediction from trained model")
    return predict(dataset, config["Training"]["loss"], config["Job"],
                   device=config["Job"].get("device", "cuda"))


def main(argv=None):
    start_time = time.time()
    print("Starting...")
    config = load_config(build_parser().parse_args(argv))
    run(config)
    print("--- %s total seconds elapsed ---" % (time.time() - start_time))

