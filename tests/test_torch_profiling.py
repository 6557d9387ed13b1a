"""The port's utils/profiling.py against the reference package's, on the CPU.

* ThroughputMeter: rates, chunk warmup (by count and by chunk-shape key),
  the explicit warmup flag, report suppression below MIN_REPORT_STEPS, and
  MFU / HBM shares with monkeypatched peaks; the same text as the
  reference's meter for the same chunks.
* device_peaks: None on the CPU and for a card the table does not hold; an
  H100 SXM's datasheet figures.
* meter_for_training equal to the reference's on toy_dataset;
  analytic_step_flops / analytic_step_bytes / attach_analytic_flops equal
  to the reference's exactly for config.yml's seven model configs, with
  and without the fused kernel.
* trace writes a Chrome trace and is a no-op when disabled; train_regular
  prints a Throughput line; the CLI's --profile True writes a trace.
"""

import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import matdeeplearn_tpu.utils.profiling as JP
import matdeeplearn_torch.utils.profiling as P
from matdeeplearn_torch.data.batching import BatchSpec
from matdeeplearn_torch.data.dataset import get_dataset
from matdeeplearn_torch.training import jobs as TJ

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THROUGHPUT = re.compile(r"Throughput: [0-9,]+ edges/s/chip \([0-9,]+ edges/s\), "
                        r"[0-9,]+ graphs/s, [0-9,.]+ epochs/hr over \d+ "
                        r"epochs, [0-9.]+ ms/step")
with open(os.path.join(REPO, "config.yml")) as _f:
    CONFIG = yaml.safe_load(_f)
# config.yml's seven model configs, by the model each builds
DEMOS = {m["model"]: m for m in CONFIG["Models"].values()}


def test_meter_rates():
    m = P.ThroughputMeter(num_devices=4, edges_per_epoch=1000.0,
                          graphs_per_epoch=10.0).start()
    time.sleep(0.05)
    m.tick(5)
    r = m.rates()
    assert r["epochs"] == 5
    assert r["edges_per_s"] > 0
    np.testing.assert_allclose(r["edges_per_s_per_chip"], r["edges_per_s"] / 4,
                               rtol=0.01)
    assert "edges/s/chip" in m.report()


def test_meter_chunk_accounting_excludes_warmup():
    m = P.ThroughputMeter(num_devices=1, edges_per_epoch=100.0,
                          graphs_per_epoch=10.0)
    m.add_chunk(5, 10, 100.0)           # the build chunk: excluded from rates
    m.add_chunk(5, 10, 1.0)
    m.add_chunk(5, 10, 1.0)
    r = m.rates()
    assert r["epochs"] == 15            # all epochs counted
    assert r["warmup_s"] == 100.0
    assert abs(r["wall_s"] - 2.0) < 1e-6  # but only steady-state time rated
    assert abs(r["epochs_per_hr"] - 10 / 2.0 * 3600) < 1.0
    assert abs(r["step_ms"] - 100.0) < 1e-6  # 20 steps / 2 s


def test_meter_key_first_occurrence_is_warmup():
    """A chunk shape's first chunk is warmup even with warmup_chunks=0, and
    later chunks of that shape are steady state (the trainer's key)."""
    m = P.ThroughputMeter(warmup_chunks=0, edges_per_epoch=1.0)
    m.add_chunk(1, 8, 30.0, key=("fused", 1, 8))
    m.add_chunk(1, 8, 1.0, key=("fused", 1, 8))
    m.add_chunk(2, 16, 40.0, key=("fused", 2, 8))
    m.add_chunk(1, 8, 1.0, key=("fused", 1, 8))
    r = m.rates()
    assert r["warmup_s"] == 70.0 and r["wall_s"] == 2.0


def test_meter_explicit_warmup_flag():
    m = P.ThroughputMeter(warmup_chunks=0, edges_per_epoch=1.0)
    m.add_chunk(1, 1, 50.0, warmup=True)   # new chunk shape mid-run
    m.add_chunk(1, 1, 1.0, warmup=False)
    assert m.rates()["wall_s"] == 1.0


def test_meter_report_suppresses_tiny_runs():
    m = P.ThroughputMeter(num_devices=1, edges_per_epoch=100.0,
                          graphs_per_epoch=7.0)
    m.add_chunk(2, 4, 0.01, warmup=False)
    assert "too short" in m.report()
    assert "epochs/hr" not in m.report()
    assert P.ThroughputMeter.MIN_REPORT_STEPS == JP.ThroughputMeter.MIN_REPORT_STEPS


def test_meter_report_text_matches_jax(monkeypatch):
    """The same chunks give the same rates and the same report text."""
    monkeypatch.setattr(P, "device_peaks", lambda device=None: (1e12, 1e11))
    monkeypatch.setattr(JP, "device_peaks", lambda device=None: (1e12, 1e11))
    meters = []
    for mod in (P, JP):
        m = mod.ThroughputMeter(num_devices=1, edges_per_epoch=12345.0,
                                graphs_per_epoch=800.0, flops_per_epoch=3e11,
                                bytes_per_epoch=2e10)
        for k, steps, s in ((5, 40, 9.0), (5, 40, 0.8), (5, 40, 0.7)):
            m.add_chunk(k, steps, s, key=("fused", k, 8))
        meters.append(m)
    assert meters[0].rates() == meters[1].rates()
    assert meters[0].report() == meters[1].report()
    assert "MFU" in meters[0].report()


def test_device_peaks_cpu_is_none():
    assert P.device_peaks() is None
    assert P.device_peaks("cpu") is None


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989.4e12, 3.35e12)),
    ("NVIDIA A100-SXM4-80GB", None),  # not in the table: no guess
])
def test_device_peaks_reads_the_card_table(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert P.device_peaks() == peaks


def test_meter_mfu_fields_with_fake_peaks(monkeypatch):
    monkeypatch.setattr(P, "device_peaks", lambda device=None: (1e12, 1e11))
    m = P.ThroughputMeter(num_devices=2, edges_per_epoch=10.0,
                          flops_per_epoch=1e12, bytes_per_epoch=1e11)
    m.add_chunk(1, 25, 1.0, warmup=False)
    r = m.rates()
    # 1e12 flops/s over 2 cards of 1e12 peak = 50% MFU; HBM likewise
    assert abs(r["mfu_pct"] - 50.0) < 0.5
    assert abs(r["hbm_util_pct"] - 50.0) < 0.5
    assert "MFU" in m.report()


def test_meter_without_peaks_prints_no_mfu():
    m = P.ThroughputMeter(edges_per_epoch=10.0, flops_per_epoch=1e12)
    m.add_chunk(1, 25, 1.0, warmup=False)
    assert "mfu_pct" not in m.rates() and "MFU" not in m.report()
    assert m.rates()["model_flops_per_s"] == 1e12


def test_meter_for_training(toy_dataset, toy_data_dir):
    port_ds = get_dataset(toy_data_dir, 0, "False", dict(TOY_PROCESSING_ARGS))
    idx = np.array([0, 2, 4])
    m = P.meter_for_training(port_ds, idx)
    ref = JP.meter_for_training(toy_dataset, idx)
    assert m.edges_per_epoch == ref.edges_per_epoch
    assert m.edges_per_epoch == port_ds.edge_counts()[idx].sum()
    assert m.graphs_per_epoch == ref.graphs_per_epoch == 3
    assert m.num_devices == ref.num_devices == 1


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", sorted(DEMOS))
def test_analytic_model_equals_jax(model, fused):
    cfg = {**DEMOS[model], "num_features": 114, "output_dim": 1,
           "edge_resolution": 50}
    n, e, b = 6168, 80176, 100
    assert P.analytic_step_flops(model, cfg, n, e, b) == \
        JP.analytic_step_flops(model, cfg, n, e, b)
    assert P.analytic_step_bytes(model, cfg, n, e, b, fused_kernel=fused) == \
        JP.analytic_step_bytes(model, cfg, n, e, b, fused_kernel=fused)
    spec = BatchSpec(b, n, e)
    m, ref = P.ThroughputMeter(), JP.ThroughputMeter()
    P.attach_analytic_flops(m, model, cfg, spec, 800, 50, 100,
                            fused_kernel=fused)
    JP.attach_analytic_flops(ref, model, cfg, spec, 800, 50, 100,
                             fused_kernel=fused)
    assert m.flops_per_epoch == ref.flops_per_epoch > 0
    assert m.bytes_per_epoch == ref.bytes_per_epoch > 0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with P.trace(d, enabled=True):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(ev.get("name", "")) for ev in events)


def test_trace_noop_when_disabled(tmp_path):
    d = str(tmp_path / "off")
    with P.trace(d, enabled=False):
        pass
    assert not os.path.exists(d)
    with P.trace(None, enabled=True):
        pass


def test_train_regular_prints_throughput(toy_data_dir, tmp_path, monkeypatch,
                                         capsys):
    """10 epochs of 3 steps in chunks of 1 epoch: the first chunk is warmup,
    27 steady-state steps follow, so the meter reports rates (no MFU on the
    CPU: no peaks)."""
    monkeypatch.chdir(tmp_path)
    ds = get_dataset(toy_data_dir, 0, "False", dict(TOY_PROCESSING_ARGS))
    model = {"model": "CGCNN", "dim1": 8, "dim2": 8, "gc_count": 1,
             "post_fc_count": 1, "batch_size": 4, "epochs": 10, "lr": 0.01,
             "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
             "print_model": False}
    TJ.train_regular(ds, {"seed": 1, "save_model": "False",
                          "write_output": "False"},
                     {"loss": "l1_loss", "verbosity": 1}, model, device="cpu")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("Throughput:")]
    assert len(line) == 1 and THROUGHPUT.fullmatch(line[0]), line
    assert "over 10 epochs" in line[0] and "MFU" not in line[0]
    assert not os.path.exists("train_job_profile")  # profile off


def test_cli_profile_sets_the_job_flag():
    from matdeeplearn_torch import cli

    args = cli.build_parser().parse_args(
        ["--config_path", os.path.join(REPO, "config.yml"),
         "--run_mode=Training", "--profile", "True"])
    assert cli.load_config(args)["Job"]["profile"] == "True"


def test_cli_profile_writes_a_trace(toy_data_dir, tmp_path):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg["Models"]["CGCNN_demo"].update(
        {"dim1": 8, "dim2": 8, "gc_count": 1, "post_fc_count": 1,
         "batch_size": 4, "epochs": 2})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
         str(path), "--run_mode=Training", "--profile", "True",
         "--device", "cpu", "--seed=2", "--job_name=prof"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Throughput:" in proc.stdout
    trace_file = tmp_path / "prof_profile" / "trace.json"
    assert trace_file.exists()
    with open(trace_file) as f:
        names = {str(ev.get("name", "")) for ev in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
