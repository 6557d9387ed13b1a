"""Kernels the device ran in the traced Predict window, per batch, from
torch.profiler's CUDA events."""


def read(record):
    if record.get("kind") != "predict" or "trace" not in record:
        return None
    b = record["batches"]
    return record["trace"]["kernels"] / b if b else None
