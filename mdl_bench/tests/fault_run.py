"""One run of the harness with a fault planted under its timed path, for
the tests that see `correct` come out false:

    python -m mdl_bench.tests.fault_run <fault> --workload ... (run.py's
    arguments)

Faults: unchanged_state (a training step that computes its loss and
returns the model's state as it found it), half_batch (half of each
training batch's graphs left out, the loss the mean over the rest),
altered_answer (one Predict answer of each batch changed where it is
produced), half_answers (half of each Predict batch's answers left out),
control (not a fault: the control, the plain reference with TF32
products, in the program's place for everything the run compares)."""

from __future__ import annotations

import dataclasses
import sys

import torch


def _keep_half(mask):
    idx = torch.nonzero(mask > 0).flatten()
    keep = mask.clone()
    keep[idx[len(idx) // 2:]] = 0
    return keep


def plant(fault: str) -> None:
    from matdeeplearn_torch.training import train as T

    train_batch, eval_batch = T.train_batch, T.eval_batch
    if fault == "control":
        from mdl_bench import kinds

        kinds.CONTROL = True
    elif fault == "unchanged_state":
        def faulty(model, optimizer, loss_fn, batch):
            model.eval()
            with torch.no_grad():
                out = model(batch)
            model.train()
            return (loss_fn(out, batch.y[:, 0], batch.graph_mask),
                    torch.sum(batch.graph_mask))
        T.train_batch = faulty
    elif fault == "half_batch":
        def faulty(model, optimizer, loss_fn, batch):
            batch = dataclasses.replace(batch,
                                        graph_mask=_keep_half(batch.graph_mask))
            return train_batch(model, optimizer, loss_fn, batch)
        T.train_batch = faulty
    elif fault == "altered_answer":
        def faulty(model, loss_fn, batch):
            loss, count, out = eval_batch(model, loss_fn, batch)
            out = out.clone()
            out[0] = out[0] + 0.05 * (1.0 + out[0].abs())
            return loss, count, out
        T.eval_batch = faulty
    elif fault == "half_answers":
        def faulty(model, loss_fn, batch):
            loss, count, out = eval_batch(model, loss_fn, batch)
            return loss, count, out * (1.0 - batch.graph_mask
                                       + _keep_half(batch.graph_mask))
        T.eval_batch = faulty
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    plant(sys.argv[1])
    from mdl_bench import run

    sys.exit(run.main(sys.argv[2:]))
