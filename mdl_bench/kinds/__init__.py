"""The general drivers a traffic mix names by its "kind": train.py and
predict.py. Each exposes run(cell, t_start, log) -> {"checks", "record",
"attempted", "failed", "memory_peak_bytes", "metrics", ...}."""

from __future__ import annotations

import torch

# the control (tests/fault_run.py control): what a run compares comes from
# the plain reference with TF32 products, the next precision below the
# configurations' float32, put in the program's place; the window still
# runs the program
CONTROL = False


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev, reset: bool = False) -> int:
    """torch's peak of allocated device memory (0 off a card), then reset
    if asked."""
    if dev.type != "cuda":
        return 0
    value = int(torch.cuda.max_memory_allocated(dev))
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return value


def release(dev):
    """Free what the program held before the reference runs."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
