"""The harness end to end on the CPU at tiny sizes: a cell added as data
alone, the result line's shape, the runs that must fail, and the faults
that `correct` must catch."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from mdl_bench.guards import forbidden_modules
from mdl_bench.tests.conftest import make_checkout, result, run_cell

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("names, found", [
    (["jax.numpy", "os"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["matdeeplearn_tpu.models.cgcnn"], ["matdeeplearn_tpu"]),
    (["matdeeplearn_torch", "matdeeplearn_torch.ops.csr"], []),
    (["jaxtyping", "flaxy", "matdeeplearn_tpu_extra"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert forbidden_modules(names) == found


@pytest.mark.parametrize("cell, trace", [
    ("tiny-cgcnn-train", 0), ("tiny-mpnn-train", 1),
    ("tiny-cgcnn-predict", 1), ("tiny-mpnn-predict", 0)])
def test_result_line(checkout, cell, trace):
    rc, out, err = run_cell(checkout, cell, seed=2 ** 31 + 7, trace=trace)
    assert rc == 0, err[-3000:]
    line = result(out)
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys[5:-1]) <= {"breakdown"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    # a CPU run writes no number under a device metric's name
    assert line["metrics"] and all(k.startswith("cpu_test.")
                                   for k in line["metrics"])
    assert line["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_without_a_card_the_run_fails(checkout):
    rc, out, err = run_cell(checkout, "tiny-cgcnn-train", cpu=False)
    assert rc != 0 and out.strip() == ""
    assert "CUDA card" in err


def test_without_the_program_the_run_fails(tmp_path):
    root = str(tmp_path)
    make_checkout(root, with_program=False)
    for name in os.listdir(root):
        assert name in ("mdl_bench", "BENCHMARK.json")
    rc, out, _ = run_cell(root, "tiny-cgcnn-train")
    assert rc != 0 and out.strip() == ""


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a limit file, a
    per-layer metric and entries in BENCHMARK.json, and edits no file."""
    root = make_checkout(str(tmp_path))
    h = os.path.join(root, "mdl_bench")
    with open(os.path.join(h, "configs", "tiny_cgcnn.json")) as f:
        cfg = {**json.load(f), "dim1": 8, "gc_count": 1}
    with open(os.path.join(h, "configs", "added.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(h, "traffic", "tiny-train.json")) as f:
        mix = {**json.load(f), "batch_size": 8}
    mix["corpus"] = {**mix["corpus"], "n": 64}
    with open(os.path.join(h, "traffic", "added-mix.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(h, "limits", "tiny-cgcnn-train.json"),
                os.path.join(h, "limits", "added-cell.json"))  # its limits
    with open(os.path.join(h, "metrics", "added_epochs.train.py"), "w") as f:
        f.write("def read(record):\n    return record.get('epochs')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "added", "source": "test", "why": "t",
                             "file": "mdl_bench/configs/added.json",
                             "reduced": []})
    bench["workloads"].append({"name": "added-cell", "config": "added",
                               "traffic": "added-mix", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "added_epochs.train", "unit": "epochs",
                               "better": "higher", "source": "program_counter",
                               "layer": "trainer", "moves": "train_graphs_per_s",
                               "workloads": ["added-cell"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-cgcnn-train" in m["workloads"]:
            m["workloads"].append("added-cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, out, err = run_cell(root, "added-cell", trace=1)
    assert rc == 0, err[-3000:]
    line = result(out)
    assert line["correct"] is True
    assert line["metrics"]["cpu_test.added_epochs.train"]["value"] >= 1
    assert line["metrics"]["cpu_test.added_epochs.train"]["unit"] == "epochs"


@pytest.mark.parametrize("cell, fault", [
    ("tiny-cgcnn-train", "unchanged_state"),
    ("tiny-mpnn-train", "half_batch"),
    ("tiny-cgcnn-predict", "altered_answer"),
    ("tiny-mpnn-predict", "half_answers"),
    ("tiny-cgcnn-train", "control"), ("tiny-mpnn-train", "control"),
    ("tiny-cgcnn-predict", "control"), ("tiny-mpnn-predict", "control")])
def test_a_planted_fault_is_not_correct(checkout, cell, fault):
    rc, out, err = run_cell(checkout, cell, module="mdl_bench.tests.fault_run",
                            extra=(fault,))
    assert rc == 0, err[-3000:]
    line = result(out)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    assert "FAILED" in err
