"""Run-mode jobs: Training, Predict, CV, Repeat, Ensemble and Analysis
(the Hyperparameter mode is training/hyper.py).

Reference counterparts: train_regular (training/training.py:377-539),
predict (:543-583), train_CV (:587-715), train_repeat (:719-843),
train_ensemble (:1069-1196) and analysis (:1199-1290); the reference
package's training/jobs.py (_resolve_kernel, setup_run, reset_run,
run_fused_training, _final_outputs, train_regular, predict, train_CV,
train_repeat, train_ensemble, analysis), for in-memory datasets, padded
and packed batches, flat or windowed. CV folds and Repeat trials share one
Run: `reset_run` writes fresh values into its tensors, so the trainer's
CUDA graphs are captured once and replayed by every later fold or trial.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from matdeeplearn_torch.data import dataset as D
from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                              WindowedDeviceData, assemble,
                                              packed_id_matrix)
from matdeeplearn_torch.models import (DESCRIPTOR_MODELS, MODEL_FIELDS,
                                       build_model, descriptor_width)
from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training import optimizers
from matdeeplearn_torch.training.checkpoint import load_checkpoint, save_checkpoint
from matdeeplearn_torch.training.graphs import capture_plan
from matdeeplearn_torch.training.optimizers import (build_optimizer,
                                                    optimizer_state,
                                                    set_learning_rate)
from matdeeplearn_torch.training.scheduler import build_scheduler
from matdeeplearn_torch.training.trainer import fused_trainer
from matdeeplearn_torch.utils.device import resolve_device
from matdeeplearn_torch.utils.profiling import (attach_analytic_flops,
                                                meter_for_training, trace)
from matdeeplearn_torch.utils.results import write_results
from matdeeplearn_torch.utils.summary import model_summary

KERNELS = ("auto", "xla", "csr", "fused", "pallas")
BATCHINGS = ("padded", "packed")


@dataclass(frozen=True)
class KernelPlan:
    """What one run's convolutions run on (see resolve_kernel)."""

    name: str               # fused | csr | pallas | xla
    # "dst" for fused, the csr order ("dst" or "src") for csr, None: the
    # reference order
    edge_order: str | None
    fused: bool             # the conv on its fused kernel
    windowed: bool = False  # windowed batches, the windowed kernels (pallas)


# the models the trainer takes: all seven
TRAINABLE = ("CGCNN", "SchNet", "MPNN", "GCN", "MEGNet", "SM", "SOAP")
# models with a fused kernel of their own (GCN and MEGNet have none)
FUSED_MODELS = ("CGCNN", "SchNet", "MPNN")


def csr_side(model_name: str) -> str:
    """The edge order of a model's csr plan: MEGNet aggregates at the
    source node (x[src] gathers, u broadcast at node_graph[src], edge→node
    means), so its batches sort by src; every other model aggregates at
    dst (the reference package's training/jobs.py:187-193)."""
    return "src" if model_name == "MEGNet" else "dst"


def resolve_kernel(model_name: str, kernel: str, batching: str,
                   device: torch.device, kernel_precision: str = "f32",
                   csr_order: str | None = None) -> KernelPlan:
    """The kernel request of a model config → what the port runs, for
    in-memory batches, padded or packed alike (the reference package's
    _resolve_kernel, training/jobs.py:80-199):

      fused  — the model's conv on its fused kernel, dst-sorted batches
               (CGConv: ops/fused_cgconv.py; SchNet's cfconv:
               ops/fused_cfconv.py; MPNN's NNConv message:
               ops/fused_bilinear.py); the x_j gather stays in torch. GCN
               has no fused kernel, nor has MEGNet: as in the reference,
               they run the pallas plan, with the reference's note.
               kernel_precision "bf16" is refused for CGCNN and SchNet
               (the fused kernels sum in f32; the reference runs its
               single-pass arm there); MPNN's bilinear kernel never reads
               it, as in the reference;
      csr    — the unfused conv with the CSR kernels (ops/csr.py) on the
               gathers and aggregations of the sorted side: csr_order "dst"
               or "src", by default "src" for MEGNet and "dst" otherwise
               (csr_side); an unknown order raises. The other kernels
               ignore the key, as the reference reads it only for csr. On
               dst-sorted batches GCN folds the edge weights into the
               messages before the sum, and MPNN's message runs on the
               bilinear kernel, as the reference composes it with csr
               (jobs.py:145-146): for MPNN, fused differs from csr only in
               the batches' kernel_fused flag, which MPNN does not read;
      pallas — windowed batches (data/batching.py:assemble_batch_windowed)
               and every edge aggregation on the windowed kernels
               (ops/windowed.py): the SpMM where the sum is weighted (GCN),
               the segment-sum otherwise, the gather as their backward. The
               convs run unfused (MPNN: the einsum over the formed per-edge
               weights, as the reference turns its bilinear kernel off
               under pallas). kernel_precision "bf16" is refused;
      xla    — masked plain segment ops on the reference edge order (MPNN:
               the einsum over the formed per-edge weights);
      SM, SOAP — xla whatever the request: the descriptor models have no
               edge aggregation (a request for a kernel says so);
      auto   — on a CUDA device fused for CGCNN, SchNet and MPNN and csr for
               GCN and MEGNet, under either batching (the reference picks
               csr for every packed GNN, a TPU verdict); xla elsewhere
               (where the kernels' plain versions would run, as the
               reference keeps auto on XLA off its accelerator). This is the port's choice, not the TPU's
               verdict carried over (the reference's auto never picks its
               fused cfconv, measured slower on its TPU): chip_smoke.py
               times warm training epochs under the other kernels for each
               model, and PERF.md records what it found. On a CUDA device a
               kernel_precision other than "f32" is ignored with a note:
               the kernels auto picks sum in f32.

    `batching` ("padded" or "packed") changes the batch geometry, not the
    plan. A request the port cannot honour raises NotImplementedError
    naming its ROADMAP item; nothing falls back quietly.
    """
    f32 = str(kernel_precision).lower() == "f32"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel '{kernel}' — expected one of "
                         "auto|xla|csr|fused|pallas")
    if batching not in BATCHINGS:
        raise ValueError(f"unknown batching {batching!r}: expected padded "
                         "or packed")
    if model_name not in TRAINABLE:
        raise ValueError(f"unknown model {model_name!r}: expected one of "
                         f"{', '.join(TRAINABLE)}")
    if model_name in DESCRIPTOR_MODELS:
        if kernel in ("pallas", "fused", "csr"):
            print(f"kernel={kernel} requested but unavailable (descriptor "
                  "models have no edge aggregation); using the XLA scatter "
                  "path")
        return KernelPlan("xla", None, False)
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
    if kernel == "csr":
        order = str(csr_order or csr_side(model_name)).lower()
        if order not in ("dst", "src"):
            raise ValueError(f"unknown csr_order {csr_order!r}: expected "
                             "dst or src")
        return KernelPlan("csr", order, False)
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
    kernel: str             # the resolved plan's name (KernelPlan.name)
    edge_order: str | None  # the resolved plan's edge order
    batch_size: int
    lr: float
    loss: str
    scheduler_name: str
    scheduler_args: dict
    # (indices, shuffle, seed) -> the id matrix of packed bins; None: padded
    # batches (train.epoch_id_matrix)
    id_matrix_fn: object = None
    # the trainer's CUDA graphs and their static state, kept across
    # run_fused_training calls (the reference package's run.fused_fns): they
    # hold the addresses of the parameters and of the optimizer's state
    graphs: dict = field(default_factory=dict)
    # seed -> the model's initial draw on the CPU (torch.Generator(seed)),
    # and the optimizer's name and arguments: reset_run's fresh values
    init_fn: object = None
    optimizer_name: str = "AdamW"
    optimizer_args: dict = field(default_factory=dict)

    @property
    def fused_kernel(self) -> bool:
        """The conv keeps its edge intermediates on chip: kernel fused, and
        MPNN's message on the bilinear kernel under csr on dst-sorted
        batches (the reference's csr+fused plan)."""
        return self.kernel == "fused" or (self.model_name == "MPNN"
                                          and self.kernel == "csr"
                                          and self.edge_order == "dst")

    def load_optimizer_state(self, sd: dict):
        """optimizers.load_optimizer_state, which replaces the optimizer's
        state tensors: the cached graphs go with the old ones."""
        optimizers.load_optimizer_state(self.optimizer, sd)
        self.graphs.clear()

    def id_matrix(self, indices, shuffle: bool, seed) -> np.ndarray:
        """The (steps, slots) id matrix of one epoch over `indices`."""
        if self.id_matrix_fn is not None:
            return self.id_matrix_fn(indices, shuffle, seed)
        return T.epoch_id_matrix(indices, self.batch_size, shuffle, seed)


def setup_run(dataset, model_parameters: dict, loss: str, seed: int = 0,
              batch_size: int | None = None, print_model: bool = False,
              device: str | torch.device | None = None) -> Run:
    """Model, optimizer, scheduler, batch geometry and device-resident data
    (the reference package's setup_run, its in-memory branches: padded or
    packed, flat or windowed). Initial weights come from
    torch.Generator(seed) on the CPU, so every device starts from the same
    weights; dropout masks from the model's generator seeded with `seed`.

    Packed batching budgets its bins by the counts of the batches' layout:
    the windowed counts under pallas (align max(8, tw), edges te, so every
    bin is a windowed batch), the flat counts otherwise, fused included
    (the port's fused plan runs on flat dst-sorted batches, unlike the
    reference's windowed fused kernels)."""
    dev = resolve_device(device)
    model_name = model_parameters.get("model", "CGCNN")
    bs = int(batch_size or model_parameters.get("batch_size", 100))
    batching = str(model_parameters.get("batching", "padded")).lower()
    plan = resolve_kernel(
        model_name, str(model_parameters.get("kernel", "auto")).lower(),
        batching, dev, str(model_parameters.get("kernel_precision", "f32")),
        model_parameters.get("csr_order"))
    packed = batching == "packed"

    def init_fn(seed):
        return build_model(model_name, dataset, model_parameters,
                           generator=torch.Generator().manual_seed(int(seed)),
                           dropout_seed=int(seed), device="cpu")

    model = init_fn(seed).to(dev)
    if plan.windowed:
        # kernel_tw / kernel_te: the window and tile sizes of the layout
        layout = D.windowed_layout(
            dataset,
            tw=(int(model_parameters["kernel_tw"])
                if model_parameters.get("kernel_tw") else None),
            te=int(model_parameters.get("kernel_te", 128) or 128))
        counts = (np.asarray(layout.node_counts_w),
                  np.asarray(layout.wedge_counts))
        align = dict(align=max(8, layout.tw), align_edges=layout.te)
        data = DeviceDataset.from_graph_dataset(
            dataset, dev, windowed=WindowedDeviceData.from_layout(layout, dev))
    else:
        counts = (dataset.node_counts(), dataset.edge_counts())
        align = {}
        data = DeviceDataset.from_graph_dataset(
            dataset, dev, edge_order=plan.edge_order, kernel_fused=plan.fused)
    id_matrix_fn = None
    if packed:
        spec = BatchSpec.packed_for_dataset(*counts, bs, **align)

        def id_matrix_fn(indices, shuffle, seed):
            return packed_id_matrix(indices, *counts, spec, bs, shuffle, seed)
    else:
        spec = BatchSpec.for_dataset(*counts, bs, **align)
    lr = float(model_parameters.get("lr", 1e-3))
    optimizer_name = model_parameters.get("optimizer", "AdamW")
    optimizer_args = dict(model_parameters.get("optimizer_args") or {})
    optimizer = build_optimizer(optimizer_name, model.parameters(), lr,
                                optimizer_args, device=dev)
    scheduler_name = model_parameters.get("scheduler", "ReduceLROnPlateau")
    scheduler_args = dict(model_parameters.get("scheduler_args") or {})
    scheduler = build_scheduler(scheduler_name, lr, scheduler_args)
    print(
        "resolved: model={} kernel={} batching={} precision={} mesh=dp{}xep{} "
        "stream={} spec=(B={},N={},E={}) capture={}".format(
            model_name,
            f"{plan.name}({plan.edge_order})" if plan.name == "csr" else plan.name,
            batching, model.precision, 1, 1, "n",
            spec.num_graphs, spec.num_nodes, spec.num_edges,
            capture_plan(dev, optimizer, model),
        )
    )
    if print_model:
        model_summary(model, model_name)
    cfg = {k: v for k, v in model_parameters.items()
           if k in MODEL_FIELDS.get(model_name, set())}
    cfg["num_features"] = dataset.num_features
    cfg["output_dim"] = dataset.output_dim
    cfg["edge_resolution"] = dataset.num_edge_features
    if model_name in DESCRIPTOR_MODELS:
        # the input width, for the analytic FLOP count (utils/profiling.py)
        cfg["in_dim"] = descriptor_width(dataset)
    return Run(model=model, optimizer=optimizer, scheduler=scheduler,
               spec=spec, data=data, model_name=model_name,
               model_config=cfg, kernel=plan.name,
               edge_order=plan.edge_order, batch_size=bs, lr=lr, loss=loss,
               scheduler_name=scheduler_name, scheduler_args=scheduler_args,
               id_matrix_fn=id_matrix_fn, init_fn=init_fn,
               optimizer_name=optimizer_name, optimizer_args=optimizer_args)


# Adam's and AdamW's state: all tensors, zero on a fresh optimizer's first
# step (its step count increments from 0)
_ZEROED_STATE = ("AdamW", "Adam")


def reset_run(run: Run, seed: int) -> Run:
    """Fresh parameters, optimizer and scheduler for a new CV fold or Repeat
    trial on an existing Run (the reference package's reset_run), written
    into the tensors that are already there, so the trainer's CUDA graphs
    (run.graphs) stay valid and a fold after the first captures nothing:

      * parameters and BatchNorm statistics copy_ the initial draw of
        torch.Generator(seed), and the dropout generators are reseeded;
      * Adam's and AdamW's state (exp_avg, exp_avg_sq, step) is zeroed in
        place, which is where a fresh optimizer's first step starts; any
        other optimizer (eager: its rate is a float) is built anew;
      * every group's rate is set back to the configured one (in place
        for a tensor rate); the trainer resets its own device state (the
        plateau state and its rate) at the start of every call;
      * the scheduler is built anew.

    The result equals setup_run(..., seed=seed) bit for bit, which
    tests/test_torch_jobs.py and chip_smoke.py hold."""
    fresh = run.init_fn(seed).state_dict()
    with torch.no_grad():
        for k, v in run.model.state_dict().items():
            v.copy_(fresh[k])
    if hasattr(run.model, "reseed_dropout"):  # the GNNs (SM, SOAP: none)
        run.model.reseed_dropout(seed)
    if run.optimizer_name in _ZEROED_STATE:
        for state in run.optimizer.state.values():
            for t in state.values():
                if torch.is_tensor(t):
                    t.zero_()
        set_learning_rate(run.optimizer, run.lr)
    else:
        run.optimizer = build_optimizer(
            run.optimizer_name, run.model.parameters(), run.lr,
            run.optimizer_args, device=run.data.device)
        run.graphs.clear()
    run.scheduler = build_scheduler(run.scheduler_name, run.lr,
                                    run.scheduler_args)
    return run


def _save(path: str, run: Run, state_dict: dict):
    save_checkpoint(path, state_dict, run.model_name, run.model_config,
                    run.scheduler,
                    optimizer_state=optimizer_state(run.optimizer))


def run_fused_training(run: Run, *, train_idx, val_idx, epochs: int,
                       verbosity: int, seed: int,
                       checkpoint_path: str | None = None, meter=None,
                       capture: bool | None = None, **resume):
    """Train `run` (the reference package's run_fused_training). Returns
    (best state_dict, final PlateauState, per-epoch history); the model
    holds the last state. `meter` (a ThroughputMeter) takes every chunk.
    `capture` (trainer.fused_trainer): None runs CUDA graphs where the
    capture plan allows (the `resolved:` line prints it), False eagerly;
    the graphs stay on `run.graphs`, so a later call replays them. `resume`
    (start_epoch, plateau_start, chunk_fn) goes to the trainer, for a run
    resumed mid-training (training/hyper.py)."""
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
        train_idx=train_idx, val_idx=val_idx, id_matrix_fn=run.id_matrix,
        epochs=epochs, verbosity=verbosity, lr=run.lr,
        scheduler_kwargs=scheduler_kwargs,
        scheduler_enabled=run.scheduler_name == "ReduceLROnPlateau",
        checkpoint_fn=checkpoint_fn, shuffle_seed_base=seed, meter=meter,
        capture=capture, graph_cache=run.graphs, **resume,
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
                                    idx, run.batch_size, out=True,
                                    id_matrix_fn=run.id_matrix)
    ids = [dataset.structure_ids[i] for i in idx]
    return loss, ids, targs, preds


def train_regular(dataset, job_parameters: dict, training_parameters: dict,
                  model_parameters: dict,
                  device: str | torch.device | None = None,
                  run: Run | None = None) -> dict:
    """The Training run mode (reference train_regular, training.py:377-539):
    split, train with the best-val model kept, evaluate each split, save
    the model, write `<job>_{train,val,test}_outputs.csv` and, with
    write_error, `<job>_errorvalues.csv`; print the throughput meter's
    report after training (utils/profiling.py). With `profile: "True"` the
    training runs under a torch.profiler trace written to `profile_dir`
    (default `<job>_profile`). Runs on CUDA unless `device` names another
    device. A `run` (Repeat's) is reused: reset_run reseeds it, and its
    graphs replay."""
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
    if run is None:
        run = setup_run(
            dataset, model_parameters, loss, seed=seed,
            print_model=bool(model_parameters.get("print_model", True)),
            device=device)
    else:
        reset_run(run, seed)

    if str(job_parameters.get("load_model")) == "True":
        _, state_dict, opt_state = load_checkpoint(job_parameters["model_path"],
                                                   with_optimizer=True)
        run.model.load_state_dict(state_dict)
        if opt_state is not None:
            run.load_optimizer_state(opt_state)
        else:
            print("load_model: the checkpoint holds no optimizer state (a "
                  "reference package checkpoint); resuming the parameters "
                  "and statistics only")

    temp_path = job_parameters.get("temp_checkpoint_path", "my_model_temp.ckpt")
    meter = meter_for_training(dataset, train_idx,
                               precision=run.model.precision).start()
    attach_analytic_flops(meter, run.model_name, run.model_config, run.spec,
                          len(train_idx), len(val_idx), run.batch_size,
                          fused_kernel=run.fused_kernel,
                          steps_per_epoch=run.id_matrix(train_idx, True,
                                                        seed).shape[0])
    t0 = time.time()
    with trace(job_parameters.get("profile_dir", f"{job_name}_profile"),
               enabled=str(job_parameters.get("profile")) == "True"):
        best, sched, _ = run_fused_training(
            run, train_idx=train_idx, val_idx=val_idx,
            epochs=int(model_parameters.get("epochs", 250)),
            verbosity=int(training_parameters.get("verbosity", 5)),
            seed=seed,
            checkpoint_path=(
                temp_path
                if str(job_parameters.get("save_model", "True")) == "True"
                else None),
            meter=meter,
        )
    print("Training time (s): {:.5f}".format(time.time() - t0))
    print(meter.report())
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
    batch-128 inference on padded batches sorted at the model's csr side
    (csr_side: dst, src for MEGNet), whatever kernel the model trained with
    (the CSR kernels carry every CGConv x_i gather and mean, every SchNet
    cfconv sum, every NNConv mean, every GCN sum and MEGNet's x[src]
    gathers, u broadcasts and edge→node means; the bilinear kernel every
    NNConv message), write
    `<job>_predicted_outputs.csv`, report the error. Runs on CUDA unless
    `device` names another device."""
    dev = resolve_device(device)
    model_path = job_parameters["model_path"]
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Saved model not found: {model_path}")
    job_name = str(job_parameters.get("job_name", "predict_job"))

    meta, model = load_model_for_inference(dataset, model_path, dev)

    batch_size = int(job_parameters.get("batch_size", 128))
    spec = BatchSpec.for_dataset(
        dataset.node_counts(), dataset.edge_counts(), batch_size
    )
    data = DeviceDataset.from_graph_dataset(
        dataset, dev, edge_order=csr_side(meta["model_name"]))
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


def train_CV(dataset, job_parameters: dict, training_parameters: dict,
             model_parameters: dict,
             device: str | torch.device | None = None) -> float:
    """The CV run mode (reference train_CV, training.py:587-715): n folds,
    each trained on the other n-1 with no val split (the final epoch's
    model) and tested on its own; `<job>_CV_outputs.csv` holds every
    fold's test outputs. One Run serves every fold (reset_run with seed +
    k), so its CUDA graphs are captured in fold 0 and replayed after."""
    job_name = str(job_parameters.get("job_name", "CV_job"))
    seed = int(job_parameters.get("seed") or np.random.randint(1, 1_000_000))
    folds = int(job_parameters.get("cv_folds", 5))
    loss = training_parameters.get("loss", "l1_loss")

    cv_idx = D.split_data_CV(dataset, num_folds=folds, seed=seed)
    run = setup_run(dataset, model_parameters, loss, seed=seed,
                    print_model=bool(model_parameters.get("print_model", True)),
                    device=device)
    cv_error = 0.0
    all_ids, all_targs, all_preds = [], [], []
    for k in range(folds):
        test_idx = cv_idx[k]
        train_idx = np.concatenate([cv_idx[j] for j in range(folds) if j != k])
        reset_run(run, seed + k)
        # no val split: the model keeps the final epoch's state
        run_fused_training(
            run, train_idx=train_idx, val_idx=np.array([], np.int64),
            epochs=int(model_parameters.get("epochs", 250)),
            verbosity=int(training_parameters.get("verbosity", 5)),
            seed=seed + k)
        err, ids, targs, preds = _final_outputs(run, dataset, test_idx)
        print("Fold {} test error: {:.5f}".format(k, err))
        cv_error += err
        all_ids += ids
        all_targs.append(targs)
        all_preds.append(preds)
    cv_error /= folds
    print("CV Error: {:.5f}".format(cv_error))
    if str(job_parameters.get("write_output", "True")) == "True":
        write_results(all_ids, np.concatenate(all_targs),
                      np.concatenate(all_preds), f"{job_name}_CV_outputs.csv")
    return cv_error


def train_repeat(dataset, job_parameters: dict, training_parameters: dict,
                 model_parameters: dict,
                 device: str | torch.device | None = None) -> np.ndarray:
    """The Repeat run mode (reference train_repeat, training.py:719-843):
    `repeat_trials` Training runs, each with a seed drawn from numpy's
    global generator, on one Run (reset_run per trial); prints the mean
    and standard deviation of each split's error and writes
    `<job>_all_errorvalues.csv`. Returns the (trials, 3) errors."""
    job_name = str(job_parameters.get("job_name", "repeat_job"))
    trials = int(job_parameters.get("repeat_trials", 5))
    model_path = job_parameters.get("model_path", "my_model.ckpt")
    write_output = str(job_parameters.get("write_output", "False"))

    run = setup_run(dataset, model_parameters,
                    training_parameters.get("loss", "l1_loss"), seed=0,
                    print_model=bool(model_parameters.get("print_model", True)),
                    device=device)
    errs = []
    for t in range(trials):
        jp = dict(job_parameters)
        jp["seed"] = np.random.randint(1, 1_000_000)
        jp["job_name"] = f"{job_name}_{t}"
        jp["model_path"] = f"{t}_{model_path}"
        jp["write_error"] = "True"
        jp["write_output"] = "True" if write_output != "False" else "False"
        e = train_regular(dataset, jp, training_parameters, model_parameters,
                          device=device, run=run)
        errs.append([e["train"], e["val"], e["test"]])
        if write_output == "False":
            for p in (jp["model_path"], "my_model_temp.ckpt"):
                if os.path.exists(p):
                    os.remove(p)
    errs = np.array(errs)
    mean, std = errs.mean(axis=0), errs.std(axis=0)
    for label, i in (("Training", 0), ("Val", 1), ("Test", 2)):
        print("{} Error Avg: {:.3f}, {} Standard Dev: {:.3f}".format(
            label, mean[i], label, std[i]))
    with open(f"{job_name}_all_errorvalues.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "Training", "Validation", "Test"])
        for t, row in enumerate(errs):
            w.writerow([f"Trial {t}"] + [f"{v:.8g}" for v in row])
        w.writerow(["Mean"] + [f"{v:.8g}" for v in mean])
        w.writerow(["Std"] + [f"{v:.8g}" for v in std])
    return errs


def ensemble_outputs(member_rows: list, names: list, loss_name: str,
                     path: str) -> float:
    """Average the members' test outputs and write the ensemble's CSV.

    member_rows: each member's `<job>_test_outputs.csv` rows without the
    header, [id, target × n, prediction × n] (utils/results.py). Every
    prediction column is averaged, so multi-target ensembles work. The CSV
    is the reference's layout (training.py:1174-1189): ids, target, one
    prediction column a member, ensemble; n columns each for n targets.
    Returns the ensemble's error under `loss_name`."""
    ids = [r[0] for r in member_rows[0]]
    n_out = (len(member_rows[0][0]) - 1) // 2
    targets = np.array([[float(v) for v in r[1:1 + n_out]]
                        for r in member_rows[0]])
    preds = np.stack([np.array([[float(v) for v in r[1 + n_out:]]
                                for r in rows])
                      for rows in member_rows])  # (members, samples, n)
    ens_pred = preds.mean(axis=0)
    err = float(T.get_loss(loss_name)(torch.as_tensor(ens_pred),
                                      torch.as_tensor(targets),
                                      torch.ones(len(ids), dtype=torch.float64)))

    def cols(name):
        return [name] if n_out == 1 else [f"{name}_{j}" for j in range(n_out)]

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ids"] + cols("target")
                   + [c for name in names for c in cols(name)]
                   + cols("ensemble"))
        for i, sid in enumerate(ids):
            w.writerow([sid] + list(targets[i]) + [p for m in preds for p in m[i]]
                       + list(ens_pred[i]))
    return err


def train_ensemble(dataset, job_parameters: dict, training_parameters: dict,
                   models_parameters: dict,
                   device: str | torch.device | None = None) -> float:
    """The Ensemble run mode (reference train_ensemble,
    training.py:1069-1196): train each model of `ensemble_list` (a Models
    section each) on one split, average their test predictions
    (ensemble_outputs) and write `<job>_test_ensemble_outputs.csv`. Under
    write_output Partial or False the members' CSVs, and their
    checkpoints unless save_model is True, are removed."""
    job_name = str(job_parameters.get("job_name", "ensemble_job"))
    ensemble_list = job_parameters["ensemble_list"]
    if isinstance(ensemble_list, str):
        ensemble_list = ensemble_list.split(",")
    write_output = str(job_parameters.get("write_output", "Partial"))
    loss_name = training_parameters.get("loss", "l1_loss")
    seed = int(job_parameters.get("seed") or np.random.randint(1, 1_000_000))

    outputs, errors = [], []
    for i, mname in enumerate(ensemble_list):
        jp = dict(job_parameters)
        jp["job_name"] = f"{job_name}_{i}_{mname}"
        jp["model_path"] = (f"{i}_{mname}_"
                            f"{job_parameters.get('model_path', 'my_model.ckpt')}")
        jp["seed"] = seed
        jp["write_output"] = "True"
        e = train_regular(dataset, jp, training_parameters,
                          dict(models_parameters[mname]), device=device)
        errors.append(e["test"])
        with open(f"{jp['job_name']}_test_outputs.csv") as f:
            outputs.append(list(csv.reader(f))[1:])
        if write_output in ("Partial", "False"):
            for split in ("train", "val", "test"):
                p = f"{jp['job_name']}_{split}_outputs.csv"
                if os.path.exists(p):
                    os.remove(p)
            if (str(job_parameters.get("save_model", "False")) != "True"
                    and os.path.exists(jp["model_path"])):
                os.remove(jp["model_path"])
    for mname, err in zip(ensemble_list, errors):
        print("Test Error, {}: {:.5f}".format(mname, err))
    ens_err = ensemble_outputs(outputs, ensemble_list, loss_name,
                               f"{job_name}_test_ensemble_outputs.csv")
    print("Test Error, Ensemble: {:.5f}".format(ens_err))
    return ens_err


def load_model_for_inference(dataset, model_path: str, dev):
    """(meta, model in eval mode on `dev`) from a checkpoint of either
    package (training/checkpoint.py)."""
    meta, state_dict = load_checkpoint(model_path)
    # the initial draw is overwritten by the checkpoint, but comes from an
    # explicit generator all the same
    model = build_model(meta["model_name"], dataset, dict(meta["model_config"]),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu").to(dev)
    model.load_state_dict(state_dict)
    return meta, model.eval()


@torch.no_grad()
def graph_embeddings(model, model_name: str, dataset, dev,
                     batch_size: int = 512) -> np.ndarray:
    """The Analysis mode's embeddings: each batch's input of the first
    post-FC layer (model(batch, embed=True)), on Predict's batches and
    edge order (csr_side: the CSR kernels carry the convs' gathers and
    sums on a card), over the dataset in order, sequential batches of
    `batch_size`. As the reference package, each batch keeps its first k
    rows, k its count of real graphs: the graph rows after an early pool
    (a late pool's embedding is the node features)."""
    if model_name in DESCRIPTOR_MODELS:
        raise ValueError(f"Analysis reads a GNN's post-pool embedding; "
                         f"{model_name} has none")
    spec = BatchSpec.for_dataset(dataset.node_counts(), dataset.edge_counts(),
                                 batch_size)
    data = DeviceDataset.from_graph_dataset(dataset, dev,
                                            edge_order=csr_side(model_name))
    ids = T.epoch_id_matrix(np.arange(len(dataset)), batch_size, shuffle=False,
                            seed=None)
    embs = []
    for row in ids:
        emb = model(assemble(data, row, spec), embed=True)
        embs.append(emb[:int((row >= 0).sum())].float().cpu().numpy())
    return np.concatenate(embs)


def analysis(dataset, model_path: str, tsne_args: dict | None = None,
             batch_size: int = 512, output_prefix: str = "tsne",
             device: str | torch.device | None = None) -> np.ndarray:
    """The Analysis run mode (reference analysis, training.py:1199-1290):
    the graph embeddings of a trained model (graph_embeddings, on the
    device), then sklearn's t-SNE of them (`n_iter` is sklearn's
    `max_iter`; a perplexity not below the sample count, which sklearn
    refuses, becomes min(30, max(2, n/4))), `<prefix>_output.csv` (id, target, the two t-SNE
    coordinates) and, with matplotlib, `<prefix>_output.png`. sklearn and
    matplotlib are imported here only; without sklearn this raises."""
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Saved model not found: {model_path}")
    dev = resolve_device(device)
    meta, model = load_model_for_inference(dataset, model_path, dev)
    model_summary(model, meta["model_name"])
    embeddings = graph_embeddings(model, meta["model_name"], dataset, dev,
                                  batch_size)
    print("Number of samples: ", embeddings.shape[0])
    print("Number of features: ", embeddings.shape[1])
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError("the Analysis run mode needs scikit-learn "
                          "(sklearn.manifold.TSNE), which is not "
                          "installed") from e

    targets = dataset.targets
    if targets.ndim > 1:
        targets = targets[:, 0]
    targs = dict(tsne_args or {})
    if "n_iter" in targs:  # the reference's sklearn name (main.py:531)
        targs["max_iter"] = targs.pop("n_iter")
    fallback = min(30.0, max(2.0, len(dataset) / 4))
    if targs.setdefault("perplexity", fallback) >= len(embeddings):
        # sklearn needs a perplexity below the sample count
        print(f"perplexity {targs['perplexity']} >= {len(embeddings)} "
              f"samples; using {fallback}")
        targs["perplexity"] = fallback
    tsne_out = TSNE(**targs).fit_transform(embeddings)
    with open(f"{output_prefix}_output.csv", "w", newline="") as f:
        w = csv.writer(f)
        for sid, y, a, b in zip(dataset.structure_ids, targets,
                                tsne_out[:, 0], tsne_out[:, 1]):
            w.writerow([sid, y, a, b])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        main = plt.scatter(tsne_out[:, 1], tsne_out[:, 0], c=targets, s=3)
        ax.set_xticks([])
        ax.set_yticks([])
        cbar = plt.colorbar(main, ax=ax)
        cbar.mappable.set_clim(targets.mean() - 2 * targets.std(),
                               targets.mean() + 2 * targets.std())
        plt.savefig(f"{output_prefix}_output.png", format="png", dpi=600)
        plt.close(fig)
    except ImportError:
        print("matplotlib unavailable; skipping tsne_output.png")
    return tsne_out
