"""The traced Predict window's analytic FLOPs (work.step_flops on the real
nodes, edges and graphs of every request, one forward) over its
host-clock seconds and the card's dense BF16 peak."""

from mdl_bench import work


def read(record):
    if record.get("kind") != "predict" or "trace" not in record:
        return None
    peaks = work.PEAKS.get(record["device_name"])
    if peaks is None:
        return None
    flops = work.step_flops(record["model"], record["config"],
                            record["num_features"], *record["predict_counts"])
    return 100.0 * flops / record["trace"]["window_s"] / peaks[0]
