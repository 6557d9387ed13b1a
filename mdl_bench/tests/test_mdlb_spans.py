"""The program's spans as the benchmark reads them: trace.summarize over a
synthetic event list with and without `mdl.*` spans (their device-side
copies included), spans.span_table's exact idle intersection and its
readings, and mdl_bench.spans over the tiny cells on the CPU."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from mdl_bench import spans as S, trace as TR
from mdl_bench.tests.conftest import result, run_cell


def _event(name, start, end, device="CPU", annotation=False):
    return SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}",
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


# a window of 100 us: kernels at 0-10, 30-40 and 90-100, so the device is
# idle over 10-30 and 40-90; the host packs at 5-35 (numpy: no event of
# its own), launches at 35-50 (a launch call inside) and syncs at 50-95
BASE = [
    _event(TR.WINDOW, 0, 100, annotation=True),
    _event("k_fwd", 0, 10, "CUDA"), _event("k_bwd", 30, 40, "CUDA"),
    _event("Memcpy HtoD", 90, 92, "CUDA"), _event("k_fwd", 92, 100, "CUDA"),
    _event(TR.WINDOW, 0, 100, "CUDA"),
    _event("cudaGraphLaunch", 36, 38),
    _event("aten::copy_", 52, 94),
]
SPANS = [
    _event("mdl.trainer.pack", 5, 35, annotation=True),
    _event("mdl.trainer.launch", 35, 50, annotation=True),
    _event("mdl.trainer.sync", 50, 95, annotation=True),
    _event("mdl.trainer.pack", 95, 130, annotation=True),
    # the device-side copies of the annotations span the kernels they
    # enclose and are no device work
    _event("mdl.trainer.launch", 30, 100, "CUDA"),
    _event("mdl.trainer.sync", 50, 100, "CUDA"),
]


def _totals(summary):
    return (summary["window_s"], summary["busy_s"], summary["kernels"],
            sum(s for _, s in summary["idle_gaps"]), summary["device_ops"])


def test_summarize_totals_are_the_same_with_program_spans():
    plain = TR.summarize(_Prof(BASE))
    spanned = TR.summarize(_Prof(BASE + SPANS))
    assert _totals(spanned) == pytest.approx(_totals(plain))
    assert plain["kernels"] == 3
    # the gap over 10-30 (midpoint 20) goes from no host event to the pack
    assert dict(plain["idle_gaps"])["(none)"] == pytest.approx(20e-6)
    assert dict(spanned["idle_gaps"])["mdl.trainer.pack"] == pytest.approx(
        20e-6)


def test_span_table_is_the_exact_intersection():
    table = S.span_table(_Prof(BASE + SPANS))
    spans = table["spans"]
    assert table["window_s"] == pytest.approx(100e-6)
    assert table["idle_s"] == pytest.approx(70e-6)
    # pack: 5-35 holds 10-30 of the gaps; its second interval is clipped
    # to 95-100, all busy
    assert spans["mdl.trainer.pack"]["count"] == 2
    assert spans["mdl.trainer.pack"]["seconds"] == pytest.approx(35e-6)
    assert spans["mdl.trainer.pack"]["idle_s"] == pytest.approx(20e-6)
    assert spans["mdl.trainer.launch"]["idle_s"] == pytest.approx(10e-6)
    assert spans["mdl.trainer.sync"]["idle_s"] == pytest.approx(40e-6)
    assert table["idle_outside_spans_s"] == pytest.approx(0.0)
    bare = S.span_table(_Prof(BASE))
    assert bare["spans"] == {} and bare["idle_s"] == pytest.approx(70e-6)
    assert bare["idle_outside_spans_s"] == pytest.approx(70e-6)


def test_readings_of_the_spans_or_none_without_them():
    train = S.readings("train", S.span_table(_Prof(BASE + SPANS)),
                       verbosity=2)
    assert train == pytest.approx({
        "pack_ms_per_epoch.train": 1e3 * 35e-6 / 4,
        "idle_in_pack_pct.train": 20.0,
        "launch_ms_per_epoch.train": 1e3 * 15e-6 / 2})
    predict = S.readings("predict", {"window_s": 2.0, "spans": {
        "mdl.evaluate.assemble": {"count": 8, "seconds": 0.04, "idle_s": 0.5},
        "mdl.evaluate.forward": {"count": 8, "seconds": 0.02, "idle_s": 0.1},
        "mdl.evaluate.readback": {"count": 2, "seconds": 0.01,
                                  "idle_s": 0.0}}})
    assert predict == pytest.approx({
        "enqueue_ms_per_batch.predict": 7.5,
        "idle_in_enqueue_pct.predict": 30.0,
        "readback_ms_per_request.predict": 5.0})
    for kind in ("train", "predict"):
        bare = S.readings(kind, S.span_table(_Prof(BASE)))
        assert bare and all(v is None for v in bare.values())


@pytest.mark.parametrize("cell", ["tiny-cgcnn-train", "tiny-mpnn-predict"])
def test_spans_of_a_tiny_cell(checkout, cell):
    rc, out, err = run_cell(checkout, cell, seed=2 ** 31 + 3, trace=1,
                            module="mdl_bench.spans")
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    line = json.loads(lines[-2])
    assert line["correct"] is True and "breakdown" in line
    table = result(out)
    spans = table["spans"]
    if cell.endswith("train"):
        launch = spans["mdl.trainer.launch"]["count"]
        # the first chunk's pack comes before the loop
        assert spans["mdl.trainer.pack"]["count"] == launch + 1
        assert (spans["mdl.trainer.sync"]["count"]
                == spans["mdl.trainer.report"]["count"] == launch)
    else:
        requests = spans["mdl.evaluate"]["count"]
        assert spans["mdl.evaluate.readback"]["count"] == requests
        assert (spans["mdl.evaluate.assemble"]["count"]
                == spans["mdl.evaluate.forward"]["count"] == 2 * requests)
    # the CPU runs no device events: the whole window is idle
    for s in spans.values():
        assert s["idle_s"] == pytest.approx(s["seconds"])
    readings = table["readings"]
    assert readings and all(k.startswith("cpu_test.") and v > 0
                            for k, v in readings.items())
