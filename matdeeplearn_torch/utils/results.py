"""Output CSV writer (reference write_results, training/training.py:211-223).

It writes what it is given; on a (dp, ep) mesh only rank 0 calls it, by
the gate of training/jobs.py (Run.is_main).
"""

from __future__ import annotations

import csv

import numpy as np


def write_results(ids, targets, predictions, filename: str):
    """Write `ids, target..., prediction...` rows with the reference's header
    (column counts inferred from target width)."""
    targets = np.asarray(targets)
    predictions = np.asarray(predictions)
    if targets.ndim == 1:
        targets = targets[:, None]
    if predictions.ndim == 1:
        predictions = predictions[:, None]
    t = targets.shape[1]
    p = predictions.shape[1]
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ids"] + ["target"] * t + ["prediction"] * p)
        for i, row_id in enumerate(ids):
            w.writerow(
                [row_id]
                + [f"{v:.8g}" for v in targets[i]]
                + [f"{v:.8g}" for v in predictions[i]]
            )
