"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, lengths and bounds, and a file for every configuration, mix,
limit and per-layer metric it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from mdl_bench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(^dim\d*$|_dim$|_rank$|hidden|intermediate|latent|"
                   r"head|expansion|experts_per_token)")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(text: str):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        _line(word)
        assert not word.startswith("/") and ".." not in word
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_are_unique_and_well_formed(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        _line(c["source"])
        _line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"])
        _line(w["why"])
        h = os.path.join(REPO, "mdl_bench")
        assert os.path.exists(os.path.join(h, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(h, "limits", f"{w['name']}.json"))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        _line(m["layer"])
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
        assert os.path.exists(os.path.join(REPO, "mdl_bench", "metrics",
                                           f"{m['name']}.py"))
        if "roofline" in m["name"]:
            assert re.match(r"^[A-Za-z0-9]+_roofline(\.|$)", m["name"])
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
