"""One rank of a gloo world for tests/test_torch_parallel*.py.

    python torch_parallel_worker.py JOB RANK

JOB is a torch.save'd dict: "world", "ep" (the mesh), "store" (a FileStore
path, so no port is opened), "dataset" (a port GraphDataset directory),
"out" (a directory) and "cases", each a dict with "name" and "kind" (see
RUNNERS). The rank joins the world, runs every case in order and writes
its results to OUT/rank{RANK}.npz, keys "<case>|<result>". It imports
torch and the port only, never the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys

import numpy as np
import torch
import torch.distributed as dist

from matdeeplearn_torch.data.batching import BatchSpec, DeviceDataset
from matdeeplearn_torch.data.dataset import GraphDataset
from matdeeplearn_torch.data.streaming import StreamingGraphDataset
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.parallel import spmd
from matdeeplearn_torch.parallel.mesh import make_mesh
from matdeeplearn_torch.training import jobs
from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training.optimizers import build_optimizer

EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _model(case, ds, mesh):
    """The case's model with its initial state; the edge BatchNorms' ep
    group unless the case says "no_group"."""
    group = None if case.get("no_group") else mesh.ep_group
    model = build_model(case["model"], ds, case["hp"], device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        ep_group=group)
    model.load_state_dict(case["state"])
    return model


def _setup(case, ds, mesh):
    data = DeviceDataset.from_graph_dataset(ds, "cpu")
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(),
                                 case["batch"], align=case["align"])
    return data, spec, mesh.with_impl(case.get("ep_impl", "ring"))


def run_step(case, ds, mesh):
    """One dp/ep SGD step on ids case["ids"]: the state after it, the loss
    and the count."""
    data, spec, mesh = _setup(case, ds, mesh)
    model = _model(case, ds, mesh)
    opt = build_optimizer("SGD", model.parameters(), case["lr"], {},
                          device="cpu")
    reducer = spmd.StepReducer(model, mesh)
    loss, csum = spmd.train_batch(
        model, opt, T.get_loss("l1_loss"),
        spmd.local_batch(data, case["ids"], spec, mesh), reducer)
    out = {k: v.numpy() for k, v in model.state_dict().items()}
    out.update(loss=loss.numpy(), count=csum.numpy())
    return out


def run_eval(case, ds, mesh):
    """The dp/ep eval step on ids case["ids"] (loss, count, outputs) and
    train.evaluate over case["indices"] with and without the mesh."""
    data, spec, mesh = _setup(case, ds, mesh)
    model = _model(case, ds, mesh).eval()
    loss_fn = T.get_loss("l1_loss")
    loss, csum, outs = spmd.eval_batch(
        model, loss_fn, spmd.local_batch(data, case["ids"], spec, mesh), mesh,
        out=True)
    b = case["batch"]
    err, preds, _ = T.evaluate(model, "l1_loss", spec, data, case["indices"],
                               b * mesh.dp, out=True, mesh=mesh)
    err1, preds1, _ = T.evaluate(model, "l1_loss", spec, data,
                                 case["indices"], b, out=True)
    return {"loss": loss.numpy(), "count": csum.numpy(), "outs": outs.numpy(),
            "evaluate": np.asarray([err, err1]), "preds": preds,
            "preds_single": preds1}


def run_train_regular(case, ds, mesh):
    """jobs.train_regular on the mesh: its epoch lines (lr, train, val) and
    split errors; loads case["job"]["model_path"] when the job says so. With
    case["shards"], on that disk-streaming dataset instead of `ds`."""
    if case.get("shards"):
        ds = StreamingGraphDataset(case["shards"], 0, 2)
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(case["cwd"])
    try:
        with contextlib.redirect_stdout(buf):
            errs = jobs.train_regular(ds, case["job"], case["training"],
                                      case["hp"], device="cpu", mesh=mesh)
    finally:
        os.chdir(cwd)
    text = buf.getvalue()
    rows = [[float(v) for v in m.groups()[1:]]
            for m in EPOCH_LINE.finditer(text)]
    return {"epochs": np.asarray(rows),
            "errors": np.asarray([errs["train"], errs["val"], errs["test"]]),
            "resolved": np.asarray([line for line in text.splitlines()
                                    if line.startswith("resolved:")])}


RUNNERS = {"step": run_step, "eval": run_eval,
           "train_regular": run_train_regular}


def main(job_path: str, rank: int):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group(
        "gloo", store=dist.FileStore(job["store"], job["world"]), rank=rank,
        world_size=job["world"])
    try:
        mesh = make_mesh(ep=job["ep"], device="cpu")
        ds = GraphDataset.load(job["dataset"])
        results = {}
        for case in job["cases"]:
            for k, v in RUNNERS[case["kind"]](case, ds, mesh).items():
                results[f"{case['name']}|{k}"] = v
        np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
