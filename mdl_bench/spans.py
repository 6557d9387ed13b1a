"""The program's spans in a traced run of one cell.

    python -m mdl_bench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python -m mdl_bench.run ... --trace 1` does and prints
run.py's result line, then one JSON line of the program's spans (the
ranges named `mdl.<module>.<phase>` that matdeeplearn_torch/utils/
profiling.py:span opens while a profiler records) in the traced window:

  * "spans": for each name, its "count", its host "seconds" clipped to the
    window, and "idle_s", the device's idle time inside it: the exact
    intersection of the span's intervals with the gaps between the
    device's activity (kernels, copies, fills; the annotations' device-side
    copies left out, as trace.py's summary leaves them out);
  * "window_s", "idle_s" (every gap) and "idle_outside_spans_s" (the gaps'
    time under no program span);
  * "readings": the per-epoch, per-batch and per-request figures a change
    to the host's share starts from, each None where its span is missing
    (a program without spans):
      pack_ms_per_epoch.train     mdl.trainer.pack's seconds over its
                                  count × the mix's verbosity
      idle_in_pack_pct.train      its idle_s over window_s
      launch_ms_per_epoch.train   mdl.trainer.launch's seconds over the
                                  epochs it launched (count × verbosity)
      enqueue_ms_per_batch.predict     mdl.evaluate.assemble's and
                                  .forward's seconds over the batches
      idle_in_enqueue_pct.predict the two spans' idle_s over window_s
      readback_ms_per_request.predict  mdl.evaluate.readback's seconds
                                  over its count (the requests)
    Under the harness's CPU test switch each is named cpu_test.<name>.

The run's own line is run.py's, unchanged: this module reads the profiler
that the cell's driver hands to trace.summarize.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mdl_bench import run, trace as TR

PREFIX = "mdl."


def _merge(intervals) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_table(prof) -> dict:
    """{"window_s", "idle_s", "idle_outside_spans_s", "spans"} of a
    profiler's events inside trace.WINDOW (module docstring)."""
    cpu, dev, annotations = [], [], set()
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CPU"):
            cpu.append((rng[0], rng[1], e.name))
            if getattr(e, "is_user_annotation", False) or e.name.startswith(
                    ("bench.", PREFIX)):
                annotations.add(e.name)
        else:
            dev.append((rng[0], rng[1], e.name))
    windows = [c for c in cpu if c[2] == TR.WINDOW]
    if not windows:
        raise RuntimeError(f"no {TR.WINDOW} span in the trace")
    w0, w1 = windows[0][0], windows[0][1]
    busy = _merge((max(s, w0), min(t, w1)) for s, t, n in dev
                  if n not in annotations and t > w0 and s < w1)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append([prev, s])
        prev = max(prev, t)
    if w1 > prev:
        gaps.append([prev, w1])
    by_name = {}
    for s, t, n in cpu:
        if n.startswith(PREFIX) and t > w0 and s < w1:
            by_name.setdefault(n, []).append((max(s, w0), min(t, w1)))
    spans = {n: {"count": len(iv),
                 "seconds": sum(t - s for s, t in iv) * 1e-6,
                 "idle_s": _overlap(_merge(iv), gaps) * 1e-6}
             for n, iv in sorted(by_name.items())}
    idle = sum(t - s for s, t in gaps)
    inside = _overlap(_merge(iv for ivs in by_name.values() for iv in ivs),
                      gaps)
    return {"window_s": (w1 - w0) * 1e-6, "idle_s": idle * 1e-6,
            "idle_outside_spans_s": (idle - inside) * 1e-6, "spans": spans}


def readings(kind: str, table: dict, verbosity: int = 1) -> dict:
    """The module docstring's readings of one span_table, for a `train` or
    `predict` mix."""
    spans, window = table.get("spans", {}), table["window_s"]
    get = spans.get
    if kind == "train":
        pack, launch = get("mdl.trainer.pack"), get("mdl.trainer.launch")
        return {
            "pack_ms_per_epoch.train":
                None if pack is None
                else 1e3 * pack["seconds"] / (pack["count"] * verbosity),
            "idle_in_pack_pct.train":
                None if pack is None else 100.0 * pack["idle_s"] / window,
            "launch_ms_per_epoch.train":
                None if launch is None
                else 1e3 * launch["seconds"] / (launch["count"] * verbosity),
        }
    asm, fwd = get("mdl.evaluate.assemble"), get("mdl.evaluate.forward")
    back = get("mdl.evaluate.readback")
    both = asm is not None and fwd is not None
    return {
        "enqueue_ms_per_batch.predict":
            1e3 * (asm["seconds"] + fwd["seconds"]) / asm["count"]
            if both else None,
        "idle_in_enqueue_pct.predict":
            100.0 * (asm["idle_s"] + fwd["idle_s"]) / window
            if both else None,
        "readback_ms_per_request.predict":
            None if back is None else 1e3 * back["seconds"] / back["count"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(1,), default=1)
    args = ap.parse_args(argv)
    held = {}
    summarize = TR.summarize

    def summarize_and_hold(prof):
        held["table"] = span_table(prof)
        return summarize(prof)

    TR.summarize = summarize_and_hold
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        TR.summarize = summarize
    if rc != 0:
        return rc
    if "table" not in held:
        print("mdl_bench.spans: the run traced nothing", file=sys.stderr)
        return 1
    bench = run._json(os.path.join(run.ROOT, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    mix = run._json(os.path.join(run.HERE, "traffic",
                                 f"{entry['traffic']}.json"))
    table = held["table"]
    prefix = "cpu_test." if os.environ.get(run.CPU_SWITCH) == "1" else ""
    table["readings"] = {
        prefix + k: v for k, v in readings(
            mix["kind"], table, int(mix.get("verbosity", 1))).items()}
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
