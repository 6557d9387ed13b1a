"""Kernels the device ran in the traced training window, per step (train
steps and val steps), from torch.profiler's CUDA events."""


def read(record):
    if record.get("kind") != "train" or "trace" not in record:
        return None
    steps = record["steps"] + record["val_steps"]
    return record["trace"]["kernels"] / steps if steps else None
