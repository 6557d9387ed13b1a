"""The traced run's reading of torch.profiler: the device's activity
(kernels, copies, fills) inside the span named `bench.window`, and what
the host was doing in the device's idle gaps.

summarize() returns {"window_s", "busy_s", "kernels", "device_ops",
"idle_gaps"}: the window's host-clock length, the union of the device's
activity intervals in it, the count of kernels launched in it, and the
ten device operations and the ten host activities (the innermost host
event over an idle gap's midpoint) that took most time, in seconds."""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """torch.profiler over the block (CPU and, on a card, CUDA activity);
    yields a holder whose `prof` is the profiler, None when disabled."""
    holder = type("Holder", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
    holder.prof = prof


def window_span():
    """The span that marks the traced window (record_function)."""
    from torch.profiler import record_function

    return record_function(WINDOW)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _top(totals: dict, k: int = 10) -> list:
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def summarize(prof) -> dict:
    events = list(prof.events())
    cpu, dev, annotations = [], [], set()
    for e in events:
        rng = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CPU"):
            cpu.append((rng[0], rng[1], e.name))
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                annotations.add(e.name)
        else:
            dev.append((rng[0], rng[1], e.name))
    windows = [c for c in cpu if c[2] == WINDOW]
    if not windows:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = windows[0][0], windows[0][1]
    dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                 if n not in annotations and t > w0 and s < w1)
    ops, merged = {}, []
    kernels = 0
    for s, t, n in dev:
        ops[n[:160]] = ops.get(n[:160], 0.0) + (t - s) * 1e-6
        kernels += not _is_copy(n)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    cpu = sorted(c for c in cpu if c[2] != WINDOW and c[1] > w0 and c[0] < w1)
    starts = [c[0] for c in cpu]
    idle = {}
    for s, t in gaps:
        mid, name = 0.5 * (s + t), "(none)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
        idle[name[:160]] = idle.get(name[:160], 0.0) + (t - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels, "device_ops": _top(ops),
            "idle_gaps": _top(idle)}
