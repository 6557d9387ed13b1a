"""The traced training window's analytic FLOPs (work.step_flops on the real
nodes, edges and graphs of every batch: 3 forwards a train step, 1 a val
step) over its host-clock seconds and the card's dense BF16 peak."""

from mdl_bench import work


def read(record):
    if record.get("kind") != "train" or "trace" not in record:
        return None
    peaks = work.PEAKS.get(record["device_name"])
    if peaks is None:
        return None
    args = (record["model"], record["config"], record["num_features"])
    flops = (3.0 * work.step_flops(*args, *record["train_counts"])
             + work.step_flops(*args, *record["val_counts"]))
    return 100.0 * flops / record["trace"]["window_s"] / peaks[0]
