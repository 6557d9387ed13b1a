"""The numbers that decide `correct`: gaps between what the timed path
produced and what the plain reference works out from the same inputs.

Norm gaps are taken by the worst leaf: for each leaf the distance between
the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf (some leaves are all
but zero)."""

from __future__ import annotations

import math

import numpy as np
import torch

BUFFERS = ("running_mean", "running_var")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone: left out of the change's gap
STILL = 1e-3
# the output layer's weight: no ReLU lies between it and the loss, so its
# gradient moves with the forward's values alone (a unit whose input sits
# within rounding of 0 can switch a ReLU's slope, and with it every
# gradient that flows through that unit, on a few seeds)
OUTPUT = "lin_out.weight"


def _norms(tree: dict, keys) -> dict:
    """Each leaf's norm; a leaf the tree lacks (a gradient the optimizer
    never got) counts as zero."""
    return {k: float(torch.linalg.vector_norm(tree[k].double()))
            if k in tree else 0.0 for k in keys}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap of norms."""
    keys = list(keys)
    pn, rn = _norms(prog, keys), _norms(ref, keys)
    med = float(np.median(list(rn.values())))
    gaps = {}
    for k in keys:
        den = max(rn[k], med)
        g = abs(pn[k] - rn[k]) / den if den > 0 else (0.0 if pn[k] == 0 else math.inf)
        gaps[k] = g if math.isfinite(pn[k]) else math.inf
    return gaps


def norm_gap(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """(the worst leaf's gap, that leaf)."""
    gaps = leaf_gaps(prog, ref, keys)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(ref_grad1: dict, state_keys) -> list:
    """The leaves whose change is compared: every running statistic, and
    every parameter whose reference gradient is at least STILL of the
    median parameter's."""
    gn = _norms(ref_grad1, ref_grad1)
    med = float(np.median(list(gn.values())))
    return [k for k in state_keys
            if k.rsplit(".", 1)[-1] in BUFFERS or gn[k] >= STILL * med]


def train_gaps(prog: dict, ref: dict, w0: dict, worst: dict | None = None
               ) -> dict:
    """prog and ref: {"losses", "pred1", "grad1", "state"} of the same steps
    from the weights w0: loss_gap, the worst step's relative loss gap;
    forward_gap, the widest gap of step 1's prediction of a graph (as
    answer_gap); grad_gap and grad_median_gap, the worst and the median
    leaf's gap of step 1's gradient; out_grad_gap, the output layer's;
    delta_gap, the worst leaf's gap of the change over the steps
    (moved_leaves). `worst`, if given, takes the leaf that sets each worst
    gap."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    keys = moved_leaves(ref["grad1"], w0)
    dp = {k: prog["state"][k].double() - w0[k].double() for k in keys}
    dr = {k: ref["state"][k].double() - w0[k].double() for k in keys}
    grads = leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    deltas = leaf_gaps(dp, dr, keys)
    grad_leaf = max(grads, key=grads.get)
    delta_leaf = max(deltas, key=deltas.get)
    if worst is not None:
        worst.update(grad_gap=grad_leaf, delta_gap=delta_leaf)
    complete = len(losses) == len(ref["losses"])
    pred1 = prog.get("pred1")
    forward = (math.inf if pred1 is None or len(pred1) != len(ref["pred1"])
               else answer_gap([(np.arange(len(pred1)), pred1)], ref["pred1"]))
    return {"loss_gap": max(losses) if complete else math.inf,
            "forward_gap": forward,
            "grad_gap": grads[grad_leaf], "delta_gap": deltas[delta_leaf],
            "grad_median_gap": float(np.median(list(grads.values()))),
            "out_grad_gap": grads.get(OUTPUT, math.inf)}


def answer_gap(answers, ref: np.ndarray) -> float:
    """The widest gap of any answer [(pool ids, predictions)] from the
    reference's prediction for its graph, over the larger of that
    prediction's size and the median one's."""
    scale = np.maximum(np.abs(ref), np.median(np.abs(ref)))
    gap = 0.0
    for ids, pred in answers:
        d = np.abs(np.asarray(pred, np.float64) - ref[ids]) / scale[ids]
        gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d)) else math.inf)
    return gap
