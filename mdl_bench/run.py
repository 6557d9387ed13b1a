"""One run of one cell of the benchmark (BENCHMARK.json at the repository
root):

    python -m mdl_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (mdl_bench/configs/<config>.json: the
model section as it runs, with its source, cuts and assumptions) and a
traffic mix (mdl_bench/traffic/<traffic>.json, whose "kind" picks the
general driver mdl_bench/kinds/<kind>.py); its limits are in
mdl_bench/limits/<cell>.json, and each per-layer metric is read by
mdl_bench/metrics/<metric>.py. No file of code lists them: a cell, a
configuration, a mix or a metric is added as a file.

The run makes its inputs and weights from --seed, warms up the shapes its
traffic uses (set-up: imports, the kernel libraries, the corpus, the
model, the warm-up), measures for --seconds on the host clock, checks what
the timed path produced against the plain reference (mdl_bench/reference),
and prints one JSON line last on standard output: correct, attempted,
failed, metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer ones, from torch.profiler over a window of at most the mix's
trace_seconds), device, with --trace 1 a breakdown, and last `checks`:
each number compared with its limit, also printed as the last lines of
standard error. It runs on a CUDA card and fails without one; the
environment switch MDL_BENCH_CPU_TEST=1 runs it on the CPU for the
benchmark's own tests, and then names every metric `cpu_test.<name>`,
never a device metric's name. A run that holds JAX, jaxlib, flax or the
JAX package at its end fails (guards.py).
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# one process with few threads: the host's share of a run (the eager
# Predict loop, the packer) waits on no thread pool of its own
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from mdl_bench.guards import forbidden_modules  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CPU_SWITCH = "MDL_BENCH_CPU_TEST"
DOC_KEYS = ("source", "reduced", "assumed", "notes")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """What a driver (mdl_bench/kinds) needs of one run."""

    name: str
    model: dict       # the configuration's model section, as it runs
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object    # torch.device
    calibrate: bool = False  # readings only: no warm-up, a short window

    def reference(self):
        """The configuration's plain reference, mdl_bench/reference/<model>."""
        return importlib.import_module(
            f"mdl_bench.reference.{str(self.model['model']).lower()}")

    def convs(self):
        """The conv layers' adapter, mdl_bench/convs/<model>."""
        return importlib.import_module(
            f"mdl_bench.convs.{str(self.model['model']).lower()}")

    @property
    def window_seconds(self) -> float:
        if self.trace:
            return min(self.seconds, float(self.traffic["trace_seconds"]))
        return self.seconds


def load_cell(bench: dict, name: str, seed: int, seconds: float,
              trace: bool, device) -> tuple[Cell, dict]:
    """(the Cell, its BENCHMARK.json entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: BENCHMARK.json has "
                         f"{', '.join(cells)}")
    entry = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    model = {k: v for k, v in _json(os.path.join(ROOT, cfg["file"])).items()
             if k not in DOC_KEYS}
    traffic = _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{name}.json"))
    return Cell(name, model, traffic, limits, seed, seconds, trace,
                device), entry


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, record: dict):
    """mdl_bench/metrics/<name>.py's read(record): a number or None."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"mdl_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_for(chips: int):
    """The CUDA device of the run; without enough cards, SystemExit
    (unless the CPU test switch is on)."""
    import torch

    torch.set_num_threads(1)
    if os.environ.get(CPU_SWITCH) == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(
            f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " (MDL_BENCH_CPU_TEST=1 runs the benchmark's own tests on the CPU)")
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the kernel and compiler caches of the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    stdout = sys.stdout
    try:
        # the program's progress lines go to stderr: stdout holds the result
        with contextlib.redirect_stdout(sys.stderr):
            entry = {w["name"]: w for w in bench["workloads"]}.get(
                args.workload, {"chips": 1})
            device = device_for(int(entry["chips"]))
            cell, entry = load_cell(bench, args.workload, args.seed,
                                    args.seconds, bool(args.trace), device)
            line, checks = run_cell(bench, cell, entry)
    except SystemExit as e:
        log(f"mdl_bench: {e}")
        return 2
    except Exception:  # noqa: BLE001 - the run's one boundary: no result
        log(traceback.format_exc())
        return 1
    found = forbidden_modules()
    if found:
        log(f"mdl_bench: the run loaded {', '.join(found)}: no result")
        return 3
    print(json.dumps(line), file=stdout, flush=True)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}"
            f" {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    return 0


def run_cell(bench: dict, cell: Cell, entry: dict) -> tuple[dict, dict]:
    """(the result line, the checks) of one run."""
    import torch

    kind = importlib.import_module(f"mdl_bench.kinds.{cell.traffic['kind']}")
    dev = cell.device
    on_card = dev.type == "cuda"
    if on_card:
        log(f"card: {power_limit()}")
    out = kind.run(cell, T_START, log)
    # the cell's limits file names the numbers it compares; the others are
    # readings, printed
    for k, v in out["checks"].items():
        if k not in cell.limits:
            log(f"reading {k} {v!r} (not compared in this cell)")
    checks = {k: {"value": out["checks"][k], "limit": float(lim)}
              for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    unit = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not cell.trace:
        for m in bench["end_to_end"]:
            if applies(m, cell.name):
                metrics[m["name"]] = out["metrics"][m["name"]]
    else:
        for m in bench["per_layer"]:
            if applies(m, cell.name):
                value = read_metric(m["name"], out["record"])
                if value is not None:
                    metrics[m["name"]] = value
    prefix = "" if on_card else "cpu_test."
    line = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": {prefix + k: {"value": v, "unit": unit[k]}
                    for k, v in metrics.items()},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": int(entry["chips"]) if on_card else 0,
            "memory_peak_bytes": int(out["memory_peak_bytes"]),
        },
    }
    if cell.trace and "trace" in out["record"]:
        tr = out["record"]["trace"]
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line, checks


if __name__ == "__main__":
    sys.exit(main())
