"""The readings that a cell's limits are set from, on the card, in one
process:

    python -m mdl_bench.calibrate --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control 1] [--witness 0] [--out FILE]

For each seed: the numbers the run compares (the program's, through the
cell's own driver: training without its window, Predict with a short one
at the cell's load), and with --control 1 the same numbers of the
control, the reference computed with TF32 products in the program's place,
and of the faults planted in the reference (training: half of each batch
left out of the loss). With --witness 1 (training) step 1's gradient is
also worked out on the port's own paths and in float64 (witness()). One
JSON line a seed."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from mdl_bench import compare, run as R, weights as W
from mdl_bench.kinds import release
from mdl_bench.reference import common as RC


def _port_grads(run, batch) -> dict:
    """Step 1's gradient of every parameter, the port's model and loss run
    eagerly on `batch` from the weights it holds."""
    from matdeeplearn_torch.training import train as T

    run.model.train()
    run.model.zero_grad(set_to_none=True)
    out = run.model(batch)
    out = out.reshape(out.shape[0], -1)[:, 0]
    T.get_loss(run.loss)(out, batch.y[:, 0], batch.graph_mask).backward()
    grads = {n: p.grad.detach().clone()
             for n, p in run.model.named_parameters() if p.grad is not None}
    run.model.zero_grad(set_to_none=True)
    return grads


def _summary(grads: dict, truth: dict) -> dict:
    gaps = compare.leaf_gaps(grads, truth, truth)
    top = sorted(gaps, key=gaps.get, reverse=True)[:4]
    return {"worst": gaps[top[0]], "median": float(np.median(list(
        gaps.values()))), "top": {k: gaps[k] for k in top}}


def witness(cell, out: dict, ctrl_grad1: dict | None) -> dict:
    """Step 1's gradient on the first check bin, from the same weights,
    each held leaf by leaf (compare.leaf_gaps) to the reference in float64:
    the program's captured step (AdamW's moment), the port's model run
    eagerly on the same packed batch (its kernels), the port's plain path
    on that batch (the edge order cleared: index_select, index_add_ and,
    in MPNN, the formed per-edge weights), the reference in float32 and
    the control."""
    from matdeeplearn_torch.data.batching import assemble

    run, dev, b = out["run"], cell.device, out["bins"][0]
    row = run.id_matrix(b, True, cell.seed + 1)[0]
    batch = assemble(run.data, torch.as_tensor(row, device=dev), run.spec)
    plain = dataclasses.replace(batch, edge_order=None, kernel_fused=False,
                                kernel_bilinear=False)
    grads = {"program": out["program"]["grad1"],
             "reference_f32": out["reference"]["grad1"]}
    if ctrl_grad1 is not None:
        grads["control_tf32"] = ctrl_grad1
    for name, bt in (("port_kernels", batch), ("port_plain", plain)):
        W.load_into(run.model, out["weights"])
        grads[name] = _port_grads(run, bt)
        release(dev)
    del batch, plain
    g64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in RC.batch_of(out["corpus"], b, dev).items()}
    w64 = {k: v.double() for k, v in out["weights"].items()}
    with RC.matmul_precision(tf32=False):
        truth = RC.train_steps(cell.reference(), out["params"], w64, [g64],
                               float(out["params"]["lr"]))["grad1"]
    return {name: _summary(g, truth) for name, g in grads.items()}


def readings(cell, control: bool, witness_too: bool = False) -> dict:
    kind = cell.traffic["kind"]
    mod = __import__(f"mdl_bench.kinds.{kind}", fromlist=["run"])
    out = mod.run(cell, time.perf_counter(), R.log)
    rec = {"seed": cell.seed, "program": out["checks"]}
    if "worst" in out:
        rec["program_worst"] = out["worst"]
    ctrl = None
    if control:
        found, ctrl = _control_and_faults(cell, out, kind)
        rec.update(found)
    if witness_too and kind == "train":
        rec["witness"] = witness(cell, out, ctrl)
    out.pop("run", None)
    return rec


def _control_and_faults(cell, out: dict, kind: str) -> tuple[dict, dict]:
    """(the control's and the faults' numbers, the control's step-1
    gradient in training)."""
    rec, grad1 = {}, None
    ref_model, dev = cell.reference(), cell.device
    if kind == "train":
        batches = [RC.batch_of(out["corpus"], b, dev) for b in out["bins"]]
        lr = float(out["params"]["lr"])
        with RC.matmul_precision(tf32=True):
            ctrl = RC.train_steps(ref_model, out["params"], out["weights"],
                                  batches, lr)
        worst = {}
        rec["control_tf32"] = compare.train_gaps(ctrl, out["reference"],
                                                 out["weights"], worst)
        rec["control_worst"] = worst
        grad1 = ctrl["grad1"]
        with RC.matmul_precision(tf32=False):
            half = RC.train_steps(ref_model, out["params"], out["weights"],
                                  batches, lr, half_batch=True)
        rec["fault_half_batch"] = compare.train_gaps(half, out["reference"],
                                                     out["weights"])
    else:
        pool = out["pool"]
        cfg = {**cell.model, "edge_resolution": pool["edge_resolution"]}
        with RC.matmul_precision(tf32=True):
            ctrl = RC.predict(ref_model, cfg, out["weights"], pool,
                              np.arange(pool["n"]), dev)
        rec["control_tf32"] = {"answer_gap": compare.answer_gap(
            [(np.arange(pool["n"]), ctrl)], out["reference"])}
    return rec, grad1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = R._json(f"{R.ROOT}/BENCHMARK.json")
    dev = R.device_for(1)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in map(int, args.seeds.split(",")):
            with contextlib.redirect_stdout(sys.stderr):
                cell, _ = R.load_cell(bench, args.workload, seed,
                                      args.seconds, False, dev)
                cell.calibrate = True
                rec = readings(cell, bool(args.control),
                               bool(args.witness))
            line = json.dumps({"workload": args.workload, **rec})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
