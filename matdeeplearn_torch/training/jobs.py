"""Run-mode jobs. Predict is ported; the training modes wait for the
training slice (ROADMAP queue 1, items 6, 7 and 13).

Reference counterpart: predict (training/training.py:543-583).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from matdeeplearn_torch.data.batching import BatchSpec, DeviceDataset
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.training import train as T
from matdeeplearn_torch.training.checkpoint import load_checkpoint
from matdeeplearn_torch.utils.device import resolve_device
from matdeeplearn_torch.utils.results import write_results


def predict(dataset, loss: str, job_parameters: dict,
            device: str | torch.device | None = None) -> float:
    """The Predict run mode: rebuild the model from the checkpoint header,
    batch-128 inference on dst-sorted batches (the CSR kernels carry every
    CGConv gather and mean), write `<job>_predicted_outputs.csv`, report
    the error. Runs on CUDA unless `device` names another device."""
    dev = resolve_device(device)
    model_path = job_parameters["model_path"]
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Saved model not found: {model_path}")
    job_name = str(job_parameters.get("job_name", "predict_job"))

    meta, state_dict = load_checkpoint(model_path)
    model = build_model(meta["model_name"], dataset, dict(meta["model_config"]),
                        device=dev)
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
