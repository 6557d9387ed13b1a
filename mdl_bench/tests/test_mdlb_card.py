"""On a card, at the cells' own size (some minutes on an H100): on three
seeds the program passes each cell's limits, and the control (the
reference with TF32 products in the program's place) and, in the training
cells, the planted fault (half of each training batch left out) fail them;
and a whole run with the control in the program's place (fault_run.py
control) reads `correct: false`:

    python -m pytest mdl_bench/tests/test_mdlb_card.py -q

mdl_bench/calibrate.py reads the same numbers at the cells' own size."""

from __future__ import annotations

import json
import os

import pytest

from mdl_bench import calibrate, run as R
from mdl_bench.tests.conftest import REPO, result, run_cell


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in _bench()["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > float(lim) for k, lim in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 977])
def test_the_control_fails_and_the_program_passes(card, cell, seed):
    c, _ = R.load_cell(_bench(), cell, seed, 2.0, False, card)
    c.calibrate = True
    rec = calibrate.readings(c, control=True)
    assert not _fails(rec["program"], c.limits), rec
    assert _fails(rec["control_tf32"], c.limits), rec
    if "fault_half_batch" in rec:
        assert _fails(rec["fault_half_batch"], c.limits), rec


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_the_control_in_place_is_not_correct(card, cell):
    rc, out, err = run_cell(REPO, cell, seed=2 ** 31 + 41, seconds=2.0,
                            cpu=False, module="mdl_bench.tests.fault_run",
                            extra=("control",), visible=None)
    assert rc == 0, err[-3000:]
    line = result(out)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
