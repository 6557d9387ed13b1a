"""The gc_count message-passing layers' least time over their device time,
on the traced window's last batch: work.conv_flops on its real nodes and
edges (3 forwards for the training step's forward and backward, 1 for
Predict) over the card's dense BF16 peak, or work.conv_bytes over its HBM
rate, the larger, over the layers' CUDA-event time through the model's own
modules (layer_time.py)."""

from mdl_bench import work


def read(record):
    if record.get("kind") != "predict" or "conv" not in record:
        return None
    peaks = work.PEAKS.get(record["device_name"])
    conv = record["conv"]
    if peaks is None or conv["seconds"] <= 0:
        return None
    n, e = conv["counts"]
    passes = 3.0 if conv["backward"] else 1.0
    flops = passes * work.conv_flops(record["model"], record["config"],
                                     record["num_features"], n, e)
    nbytes = work.conv_bytes(record["config"], record["num_features"], n, e,
                             backward=conv["backward"])
    return 100.0 * work.least_seconds(flops, nbytes, peaks) / conv["seconds"]
