"""The share of the traced window in which no operation ran on the device:
1 - the union of the device's activity intervals (torch.profiler) over
the window's host-clock span."""


def read(record):
    if record.get("kind") != "predict" or "trace" not in record:
        return None
    t = record["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
