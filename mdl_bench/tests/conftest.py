"""Fixtures of the benchmark's own tests: a throwaway checkout holding the
harness, the program and a BENCHMARK.json of tiny cells, run on the CPU
under the harness's test switch. These tests import neither JAX nor the
JAX package:

    JAX_PLATFORMS=cpu python -m pytest mdl_bench/tests -q

Tests marked `card` need a CUDA card and skip without one (the decision
is made inside the test's fixture)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = dict(dim1=12, dim2=10, dim3=6, gc_count=2, post_fc_count=1)
# the tiny cells' own limits: a model of width 12 on the CPU reads other
# gaps than the cells' (the faults the tests plant read 1e-2 and more)
TINY_LIMITS = {"train": {"loss_gap": 1e-3, "forward_gap": 1e-5,
                         "grad_gap": 0.03, "delta_gap": 0.12,
                         "out_grad_gap": 1e-4, "grad_median_gap": 1e-4},
               "predict": {"answer_gap": 1e-4}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    return torch.device("cuda", 0)


def make_checkout(root: str, with_program: bool = True) -> str:
    """A copy of the harness in `root` with tiny cells tiny-<model>-<kind>
    beside the real ones."""
    shutil.copytree(os.path.join(REPO, "mdl_bench"),
                    os.path.join(root, "mdl_bench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    if with_program:
        os.symlink(os.path.join(REPO, "matdeeplearn_torch"),
                   os.path.join(root, "matdeeplearn_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    h = os.path.join(root, "mdl_bench")
    kinds = {}
    for w in bench["workloads"]:
        with open(os.path.join(h, "traffic", f"{w['traffic']}.json")) as f:
            kinds[w["name"]] = json.load(f)["kind"]
    for model in ("cgcnn", "mpnn"):
        with open(os.path.join(h, "configs", f"{model}_demo.json")) as f:
            cfg = {**json.load(f), **TINY}
        with open(os.path.join(h, "configs", f"tiny_{model}.json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": f"tiny_{model}", "source": "test",
                                 "file": f"mdl_bench/configs/tiny_{model}.json",
                                 "reduced": [], "why": "test"})
    for kind, base, kw in (("train", "train-mp-b256", dict(batch_size=16)),
                           ("predict", "predict-mp-r512",
                            dict(batch_size=4, request_size=8))):
        with open(os.path.join(h, "traffic", f"{base}.json")) as f:
            mix = {**json.load(f), "trace_seconds": 1, **kw}
        mix["corpus"] = {**mix["corpus"], "n": 96}
        with open(os.path.join(h, "traffic", f"tiny-{kind}.json"), "w") as f:
            json.dump(mix, f)
        for model in ("cgcnn", "mpnn"):
            cell = f"tiny-{model}-{kind}"
            bench["workloads"].append({"name": cell, "config": f"tiny_{model}",
                                       "traffic": f"tiny-{kind}", "chips": 1,
                                       "why": "test"})
            with open(os.path.join(h, "limits", f"{cell}.json"), "w") as f:
                json.dump(TINY_LIMITS[kind], f)
            # the tiny cell reports what the real cells of its kind report
            for m in bench["end_to_end"] + bench["per_layer"]:
                if any(kinds.get(w) == kind for w in m.get("workloads", ())):
                    m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root: str, cell: str, seed: int = 11, seconds: float = 1.0,
             trace: int = 0, cpu: bool = True, module: str = "mdl_bench.run",
             extra=(), visible: str | None = ""):
    """(exit code, stdout, stderr) of one run in the checkout `root`; the
    run sees the cards CUDA_VISIBLE_DEVICES=`visible` names (None: this
    process's)."""
    env = {k: v for k, v in os.environ.items() if k != "MDL_BENCH_CPU_TEST"}
    if cpu:
        env["MDL_BENCH_CPU_TEST"] = "1"
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    p = subprocess.run(
        [sys.executable, "-m", module, *extra, "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    return p.returncode, p.stdout, p.stderr


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
