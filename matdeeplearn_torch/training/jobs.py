"""Run-mode jobs: Training and Predict. The other run modes wait for ROADMAP
queue 1, item 13.

Reference counterparts: train_regular (training/training.py:377-539) and
predict (:543-583); the reference package's training/jobs.py
(_resolve_kernel, setup_run, run_fused_training, _final_outputs,
train_regular, predict), for in-memory datasets and padded (also windowed)
batches.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from matdeeplearn_torch.data import dataset as D
from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                              WindowedDeviceData)
from matdeeplearn_torch.models import MODEL_FIELDS, build_model
from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training.checkpoint import load_checkpoint, save_checkpoint
from matdeeplearn_torch.training.optimizers import (build_optimizer,
                                                    load_optimizer_state,
                                                    optimizer_state)
from matdeeplearn_torch.training.scheduler import build_scheduler
from matdeeplearn_torch.training.trainer import fused_trainer
from matdeeplearn_torch.utils.device import resolve_device
from matdeeplearn_torch.utils.results import write_results
from matdeeplearn_torch.utils.summary import model_summary

KERNELS = ("auto", "xla", "csr", "fused", "pallas")


@dataclass(frozen=True)
class KernelPlan:
    """What one run's convolutions run on (see resolve_kernel)."""

    name: str               # fused | csr | pallas | xla
    edge_order: str | None  # "dst" for fused and csr, None: reference order
    fused: bool             # the conv on its fused kernel
    windowed: bool = False  # windowed batches, the windowed kernels (pallas)


TRAINABLE = ("CGCNN", "SchNet", "MPNN", "GCN")  # models whose Training is ported
# models with a fused kernel of their own (GCN has none)
FUSED_MODELS = ("CGCNN", "SchNet", "MPNN")


def resolve_kernel(model_name: str, kernel: str, batching: str,
                   device: torch.device, kernel_precision: str = "f32",
                   csr_order: str | None = None) -> KernelPlan:
    """The kernel request of a model config → what the port runs, for
    in-memory padded batches (the reference package's _resolve_kernel,
    training/jobs.py:80-199):

      fused  — the model's conv on its fused kernel, dst-sorted batches
               (CGConv: ops/fused_cgconv.py; SchNet's cfconv:
               ops/fused_cfconv.py; MPNN's NNConv message:
               ops/fused_bilinear.py); the x_j gather stays in torch. GCN
               has no fused kernel: as in the reference, it runs the pallas
               plan, with the reference's note. kernel_precision "bf16" is
               refused for CGCNN and SchNet (the fused kernels sum in f32;
               the reference runs its single-pass arm there); MPNN's
               bilinear kernel never reads it, as in the reference;
      csr    — the unfused conv with the CSR kernels (ops/csr.py) on its
               dst-side gathers and aggregation, dst-sorted batches (GCN:
               the edge weights folded into the messages before the sum).
               MPNN's message runs on the bilinear kernel here too, as the
               reference composes it with csr (jobs.py:145-146): for MPNN,
               fused differs from csr only in the batches' kernel_fused
               flag, which MPNN does not read. csr_order other than "dst"
               is refused (the src order comes with MEGNet); the other
               kernels ignore the key, as the reference reads it only for
               csr;
      pallas — windowed batches (data/batching.py:assemble_batch_windowed)
               and every edge aggregation on the windowed kernels
               (ops/windowed.py): the SpMM where the sum is weighted (GCN),
               the segment-sum otherwise, the gather as their backward. The
               convs run unfused (MPNN: the einsum over the formed per-edge
               weights, as the reference turns its bilinear kernel off
               under pallas). kernel_precision "bf16" is refused;
      xla    — masked plain segment ops on the reference edge order (MPNN:
               the einsum over the formed per-edge weights);
      auto   — on a CUDA device fused for CGCNN, SchNet and MPNN and csr for
               GCN; xla elsewhere (where the kernels' plain versions would
               run, as the reference keeps auto on XLA off its
               accelerator). This is the port's choice, not the TPU's
               verdict carried over (the reference's auto never picks its
               fused cfconv, measured slower on its TPU): chip_smoke.py
               times warm training epochs under the other kernels for each
               model, and PERF.md records what it found. On a CUDA device a
               kernel_precision other than "f32" is ignored with a note:
               the kernels auto picks sum in f32.

    A request the port cannot honour raises NotImplementedError naming its
    ROADMAP item; nothing falls back quietly.
    """
    f32 = str(kernel_precision).lower() == "f32"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel '{kernel}' — expected one of "
                         "auto|xla|csr|fused|pallas")
    if model_name not in TRAINABLE:
        raise NotImplementedError(
            f"training {model_name} is not ported yet (ROADMAP queue 1, "
            "items 10 and 12)")
    if batching != "padded":
        raise NotImplementedError(
            f"batching={batching!r} is not ported yet (ROADMAP queue 1, "
            "item 3)")
    if kernel == "fused" and model_name not in FUSED_MODELS:
        print("kernel=fused applies to CGCNN, SchNet and MPNN; other models "
              "run the windowed aggregation kernel (kernel=pallas behavior)")
        kernel = "pallas"
    if not f32 and (kernel == "pallas"
                    or kernel == "fused" and model_name != "MPNN"):
        which = "windowed" if kernel == "pallas" else "fused"
        raise NotImplementedError(
            f"kernel_precision={kernel_precision!r}: the single-pass bf16 "
            f"arm of the {which} kernels is not ported (ROADMAP queue 1, "
            f"item 5); the {which} kernels sum in f32")
    if kernel == "pallas":
        return KernelPlan("pallas", None, False, True)
    if kernel == "auto":
        kernel = ("xla" if device.type != "cuda"
                  else "fused" if model_name in FUSED_MODELS else "csr")
        if device.type == "cuda" and not f32:
            print(f"kernel_precision={kernel_precision!r} is ignored: kernel "
                  f"auto runs {kernel}, whose kernels sum in f32")
    if kernel == "csr" and str(csr_order or "dst").lower() != "dst":
        raise NotImplementedError(
            f"csr_order={csr_order!r}: only the dst order is ported; the src "
            "order comes with MEGNet (ROADMAP queue 1, item 10)")
    return KernelPlan(kernel, None if kernel == "xla" else "dst",
                      kernel == "fused")


@dataclass
class Run:
    """Everything needed to train and evaluate one model on one dataset."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    spec: BatchSpec
    data: DeviceDataset
    model_name: str
    model_config: dict
    batch_size: int
    lr: float
    loss: str
    scheduler_name: str
    scheduler_args: dict


def setup_run(dataset, model_parameters: dict, loss: str, seed: int = 0,
              batch_size: int | None = None, print_model: bool = False,
              device: str | torch.device | None = None) -> Run:
    """Model, optimizer, scheduler, batch geometry and device-resident data
    (the reference package's setup_run, in-memory padded and windowed
    branches). Initial weights come from torch.Generator(seed) on the CPU,
    so every device starts from the same weights; dropout masks from the
    model's generator seeded with `seed`."""
    dev = resolve_device(device)
    model_name = model_parameters.get("model", "CGCNN")
    bs = int(batch_size or model_parameters.get("batch_size", 100))
    plan = resolve_kernel(
        model_name, str(model_parameters.get("kernel", "auto")).lower(),
        str(model_parameters.get("batching", "padded")).lower(), dev,
        str(model_parameters.get("kernel_precision", "f32")),
        model_parameters.get("csr_order"))
    model = build_model(model_name, dataset, model_parameters,
                        generator=torch.Generator().manual_seed(int(seed)),
                        dropout_seed=int(seed), device="cpu").to(dev)
    if plan.windowed:
        # kernel_tw / kernel_te: the window and tile sizes of the layout
        layout = D.windowed_layout(
            dataset,
            tw=(int(model_parameters["kernel_tw"])
                if model_parameters.get("kernel_tw") else None),
            te=int(model_parameters.get("kernel_te", 128) or 128))
        spec = BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                     bs, align=max(8, layout.tw),
                                     align_edges=layout.te)
        data = DeviceDataset.from_graph_dataset(
            dataset, dev, windowed=WindowedDeviceData.from_layout(layout, dev))
    else:
        spec = BatchSpec.for_dataset(dataset.node_counts(),
                                     dataset.edge_counts(), bs)
        data = DeviceDataset.from_graph_dataset(
            dataset, dev, edge_order=plan.edge_order, kernel_fused=plan.fused)
    lr = float(model_parameters.get("lr", 1e-3))
    optimizer = build_optimizer(model_parameters.get("optimizer", "AdamW"),
                                model.parameters(), lr,
                                model_parameters.get("optimizer_args") or {},
                                device=dev)
    scheduler_name = model_parameters.get("scheduler", "ReduceLROnPlateau")
    scheduler_args = dict(model_parameters.get("scheduler_args") or {})
    scheduler = build_scheduler(scheduler_name, lr, scheduler_args)
    print(
        "resolved: model={} kernel={} batching={} mesh=dp{}xep{} stream={} "
        "spec=(B={},N={},E={})".format(
            model_name,
            f"{plan.name}({plan.edge_order})" if plan.name == "csr" else plan.name,
            "padded", 1, 1, "n",
            spec.num_graphs, spec.num_nodes, spec.num_edges,
        )
    )
    if print_model:
        model_summary(model, model_name)
    cfg = {k: v for k, v in model_parameters.items()
           if k in MODEL_FIELDS.get(model_name, set())}
    cfg["num_features"] = dataset.num_features
    cfg["output_dim"] = dataset.output_dim
    cfg["edge_resolution"] = dataset.num_edge_features
    return Run(model=model, optimizer=optimizer, scheduler=scheduler,
               spec=spec, data=data, model_name=model_name,
               model_config=cfg, batch_size=bs, lr=lr, loss=loss,
               scheduler_name=scheduler_name, scheduler_args=scheduler_args)


def _save(path: str, run: Run, state_dict: dict):
    save_checkpoint(path, state_dict, run.model_name, run.model_config,
                    run.scheduler,
                    optimizer_state=optimizer_state(run.optimizer))


def run_fused_training(run: Run, *, train_idx, val_idx, epochs: int,
                       verbosity: int, seed: int,
                       checkpoint_path: str | None = None):
    """Train `run` (the reference package's run_fused_training). Returns
    (best state_dict, final PlateauState, per-epoch history); the model
    holds the last state."""
    sa = run.scheduler_args
    scheduler_kwargs = dict(
        factor=float(sa.get("factor", 0.1)),
        patience=int(sa.get("patience", 10)),
        threshold=float(sa.get("threshold", 1e-4)),
        min_lr=float(sa.get("min_lr", 0.0)),
        cooldown=int(sa.get("cooldown", 0)),
        threshold_mode=str(sa.get("threshold_mode", "rel")),
    )
    last_saved_val = [float("inf")]

    def checkpoint_fn(best, best_val, sched):
        # Save only when the best val improved since the last save
        # (reference checkpoints per improvement, training.py:143-155; here
        # once per chunk, as the reference package does).
        if checkpoint_path is None:
            return
        if np.isfinite(last_saved_val[0]) and best_val >= last_saved_val[0]:
            return
        last_saved_val[0] = best_val
        _sync_scheduler(run, sched)
        _save(checkpoint_path, run, best)

    return fused_trainer(
        model=run.model, optimizer=run.optimizer,
        loss_fn=T.get_loss(run.loss), spec=run.spec, data=run.data,
        train_idx=train_idx, val_idx=val_idx, batch_size=run.batch_size,
        epochs=epochs, verbosity=verbosity, lr=run.lr,
        scheduler_kwargs=scheduler_kwargs,
        scheduler_enabled=run.scheduler_name == "ReduceLROnPlateau",
        checkpoint_fn=checkpoint_fn, shuffle_seed_base=seed,
    )


def _sync_scheduler(run: Run, sched):
    """Write the device plateau state into the host scheduler object."""
    run.scheduler.lr = float(sched.lr)
    if hasattr(run.scheduler, "num_bad_epochs"):
        best = float(sched.best)
        run.scheduler.best = best if np.isfinite(best) else None
        run.scheduler.num_bad_epochs = int(sched.num_bad)
        run.scheduler.cooldown_counter = int(sched.cooldown)


def _final_outputs(run: Run, dataset, idx):
    loss, preds, targs = T.evaluate(run.model, run.loss, run.spec, run.data,
                                    idx, run.batch_size, out=True)
    ids = [dataset.structure_ids[i] for i in idx]
    return loss, ids, targs, preds


def train_regular(dataset, job_parameters: dict, training_parameters: dict,
                  model_parameters: dict,
                  device: str | torch.device | None = None) -> dict:
    """The Training run mode (reference train_regular, training.py:377-539):
    split, train with the best-val model kept, evaluate each split, save
    the model, write `<job>_{train,val,test}_outputs.csv` and, with
    write_error, `<job>_errorvalues.csv`. Runs on CUDA unless `device`
    names another device."""
    job_name = str(job_parameters.get("job_name", "train_job"))
    seed = int(job_parameters.get("seed") or np.random.randint(1, 1_000_000))
    loss = training_parameters.get("loss", "l1_loss")

    train_idx, val_idx, test_idx = D.split_data(
        dataset,
        training_parameters.get("train_ratio", 0.8),
        training_parameters.get("val_ratio", 0.05),
        training_parameters.get("test_ratio", 0.15),
        seed=seed,
    )
    run = setup_run(dataset, model_parameters, loss, seed=seed,
                    print_model=bool(model_parameters.get("print_model", True)),
                    device=device)

    if str(job_parameters.get("load_model")) == "True":
        _, state_dict, opt_state = load_checkpoint(job_parameters["model_path"],
                                                   with_optimizer=True)
        run.model.load_state_dict(state_dict)
        if opt_state is not None:
            load_optimizer_state(run.optimizer, opt_state)

    temp_path = job_parameters.get("temp_checkpoint_path", "my_model_temp.ckpt")
    t0 = time.time()
    best, sched, _ = run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx,
        epochs=int(model_parameters.get("epochs", 250)),
        verbosity=int(training_parameters.get("verbosity", 5)),
        seed=seed,
        checkpoint_path=(temp_path
                         if str(job_parameters.get("save_model", "True")) == "True"
                         else None),
    )
    print("Training time (s): {:.5f}".format(time.time() - t0))
    _sync_scheduler(run, sched)
    run.model.load_state_dict(best)

    errors, outputs = {}, {}
    for split, idx in (("train", train_idx), ("val", val_idx), ("test", test_idx)):
        if len(idx) == 0:
            errors[split] = float("nan")
            continue
        err, ids, targs, preds = _final_outputs(run, dataset, idx)
        errors[split] = err
        outputs[split] = (ids, targs, preds)
        print("{} Error: {:.5f}".format(split.capitalize(), err))

    if str(job_parameters.get("save_model", "True")) == "True":
        _save(job_parameters.get("model_path", "my_model.ckpt"), run,
              run.model.state_dict())

    if str(job_parameters.get("write_output", "True")) == "True":
        for split, (ids, targs, preds) in outputs.items():
            write_results(ids, targs, preds, f"{job_name}_{split}_outputs.csv")

    if str(job_parameters.get("write_error")) == "True":
        np.savetxt(
            f"{job_name}_errorvalues.csv",
            np.array([[errors["train"], errors["val"], errors["test"]]]),
            delimiter=",",
        )
    return errors


def predict(dataset, loss: str, job_parameters: dict,
            device: str | torch.device | None = None) -> float:
    """The Predict run mode: rebuild the model from the checkpoint header,
    batch-128 inference on dst-sorted batches, whatever kernel the model
    trained with (the CSR kernels carry every CGConv x_i gather and mean,
    every SchNet cfconv sum, every NNConv mean and every GCN sum; the
    bilinear kernel every NNConv message), write
    `<job>_predicted_outputs.csv`, report the error. Runs on CUDA unless
    `device` names another device."""
    dev = resolve_device(device)
    model_path = job_parameters["model_path"]
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Saved model not found: {model_path}")
    job_name = str(job_parameters.get("job_name", "predict_job"))

    meta, state_dict = load_checkpoint(model_path)
    # the initial draw is overwritten by the checkpoint, but comes from an
    # explicit generator all the same
    model = build_model(meta["model_name"], dataset, dict(meta["model_config"]),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu").to(dev)
    model.load_state_dict(state_dict)

    batch_size = int(job_parameters.get("batch_size", 128))
    spec = BatchSpec.for_dataset(
        dataset.node_counts(), dataset.edge_counts(), batch_size
    )
    data = DeviceDataset.from_graph_dataset(dataset, dev, edge_order="dst")
    idx = np.arange(len(dataset))
    t0 = time.time()
    err, preds, targs = T.evaluate(model, loss, spec, data, idx, batch_size,
                                   out=True)
    elapsed = time.time() - t0
    print("Evaluation time (s): {:.5f}".format(elapsed))

    if str(job_parameters.get("write_output", "True")) == "True":
        write_results(
            dataset.structure_ids, targs, preds,
            f"{job_name}_predicted_outputs.csv",
        )
    print("Test Error: {:.5f}".format(err))
    return err
