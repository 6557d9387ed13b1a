"""The port's bench (matdeeplearn_torch/bench.py), its corpus and its gate.

* The port's cluster generator gives the same structures and targets as
  the reference package's datasets/synthetic.py (n 20, seed 0), exactly;
  its in-memory bulk dataset equals __graft_entry__._synthetic_dataset.
* The gate says pass inside the band, FAIL outside it (exit 1), and
  skipped at other epochs or on another corpus; the committed band leaves
  the mean predictor's MAE outside.
* A CPU bench at --n 40 and a few epochs prints one JSON line with the
  bench's keys; the bulk segment, on the CPU at a tiny size, gives every
  arm's key (the padded arms, CGCNN csr on packed batches, MPNN's packed
  csr and xla) and raises when an arm fails.
* The band (bench_band.json) is made here: `slow` reruns the bench's
  procedure with the JAX package on the CPU for each seed of the file and
  compares. To write the file anew:

      JAX_PLATFORMS=cpu python tests/test_torch_bench.py --write

  Each seed varies the model init and the shuffle (setup_run seed s,
  trainer seeds s, s+1, s+2, as bench.py's 123/124/125); the split stays at
  seed 123, so every run is scored on the same 150 test graphs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from matdeeplearn_torch import bench as B  # noqa: E402

BAND_SEEDS = (123, 1, 2, 3, 4)
# 250 epochs of training amplify rounding differences between hosts and
# library versions; on one host the runs repeat exactly
REBUILD_RTOL = 0.02
BENCH_KEYS = {"metric", "value", "unit", "device", "kernel", "warmup_s",
              "edges_per_s", "mae_gate"}


def _jax_dataset(data_dir):
    from matdeeplearn_tpu.data import get_dataset

    return get_dataset(data_dir, target_index=0,
                       processing_args={"verbose": "False"})


def jax_bench_mae(data_dir: str, seed: int, epochs: int = B.EPOCHS) -> float:
    """The bench's procedure with the JAX package (bench.py:58-114 on the
    synthetic corpus): K warmup epochs, the timed epochs, the rest of the
    budget; the best-val model's test MAE."""
    from matdeeplearn_tpu.data import dataset as JD
    from matdeeplearn_tpu.training import jobs as JJ
    from matdeeplearn_tpu.training import train as JT

    ds = _jax_dataset(data_dir)
    run = JJ.setup_run(ds, B.BENCH_MODEL, "l1_loss", seed=seed,
                       print_model=False)
    tr, va, te = JD.split_data(ds, *B.SPLIT, seed=B.SPLIT_SEED)
    kw = dict(train_idx=tr, val_idx=va, verbosity=B.K)
    timed = min(B.TIMED_EPOCHS, epochs - B.K)
    best = None
    for n_ep, s in ((B.K, seed), (timed, seed + 1),
                    (epochs - B.K - timed, seed + 2)):
        if n_ep > 0:
            best, last, _ = JJ.run_fused_training(run, epochs=n_ep, seed=s,
                                                  **kw)
            run.state = last
    run.state = best
    return float(JT.evaluate_scan(run.eval_epoch_fn, run.state, run.data, te,
                                  run.global_batch))


def mean_predictor_mae(data_dir: str) -> float:
    """Test MAE of always predicting the train targets' mean."""
    from matdeeplearn_tpu.data import dataset as JD

    ds = _jax_dataset(data_dir)
    tr, _, te = JD.split_data(ds, *B.SPLIT, seed=B.SPLIT_SEED)
    y = np.asarray(ds.y)[:, 0]
    return float(np.mean(np.abs(y[te] - y[tr].mean())))


def _write_reference_corpus(out: str, n: int, seed: int = 0):
    subprocess.run([sys.executable, os.path.join(REPO, "datasets",
                                                 "synthetic.py"),
                    "--out", out, "--n", str(n), "--seed", str(seed)],
                   check=True, capture_output=True)


def build_band(work: str, seeds=BAND_SEEDS) -> dict:
    """The band file's content: the corpus written by datasets/synthetic.py,
    featurized once, then one process a seed, all at once."""
    import jax

    data_dir = os.path.join(work, "corpus")
    _write_reference_corpus(data_dir, B.N_CORPUS, B.CORPUS_SEED)
    _jax_dataset(data_dir)  # the processed cache, before the workers read it
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(s),
         "--data", data_dir], stdout=subprocess.PIPE, text=True, env=env)
        for s in seeds]
    runs = []
    for s, p in zip(seeds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"JAX bench run at seed {s} failed")
        runs.append({"seed": s, "test_mae": json.loads(
            out.strip().splitlines()[-1])["test_mae"]})
    return {
        "made_by": "tests/test_torch_bench.py (JAX_PLATFORMS=cpu python "
                   "tests/test_torch_bench.py --write; checked by its slow "
                   "test)",
        "procedure": ("the bench's procedure with the JAX package on the "
                      "CPU (kernel auto: xla): CGCNN_demo parameters of "
                      "bench.py:61-69, 5 warmup epochs, 50 timed, the rest "
                      "of 250; the best-val model's test MAE. Seed s: "
                      "setup_run seed s, trainer seeds s, s+1, s+2; split "
                      "0.8/0.05/0.15 at seed 123 for every run"),
        "formula": "mean ± max(4σ, 0.15·mean) (bench.py:187-190)",
        "epochs": B.EPOCHS,
        "corpus": {"generator": "datasets/synthetic.py (matdeeplearn_torch/"
                                "data/synthetic.py:write_clusters)",
                   "n": B.N_CORPUS, "seed": B.CORPUS_SEED, "atoms": 10,
                   "element": 78, "box": 20.0},
        "split_seed": B.SPLIT_SEED,
        "jax_version": jax.__version__,
        "runs": runs,
        "mean_predictor_mae": round(mean_predictor_mae(data_dir), 6),
    }


def _band_limits(band: dict) -> tuple[float, float]:
    maes = [r["test_mae"] for r in band["runs"]]
    mean, std = float(np.mean(maes)), float(np.std(maes))
    half = max(4 * std, 0.15 * mean)
    return mean - half, mean + half


def _read_corpus(root, n):
    from matdeeplearn_torch.data.structures import read_ase_json

    structs = [read_ase_json(os.path.join(root, f"{i}.json"), str(i))
               for i in range(n)]
    with open(os.path.join(root, "targets.csv")) as f:
        return structs, f.read()


def test_generator_matches_the_reference_script(tmp_path):
    from matdeeplearn_torch.data.synthetic import write_clusters

    write_clusters(str(tmp_path / "port"), n=20, seed=0)
    _write_reference_corpus(str(tmp_path / "ref"), 20, 0)
    port, port_targets = _read_corpus(str(tmp_path / "port"), 20)
    ref, ref_targets = _read_corpus(str(tmp_path / "ref"), 20)
    assert port_targets == ref_targets
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numbers, b.numbers)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.cell, b.cell)
        np.testing.assert_array_equal(a.pbc, b.pbc)


def test_in_memory_dataset_matches_graft_entry():
    from __graft_entry__ import _synthetic_dataset
    from matdeeplearn_torch.data.synthetic import synthetic_dataset

    kw = dict(num_graphs=6, seed=7, min_atoms=24, max_atoms=40,
              max_neighbors=12)
    port, ref = synthetic_dataset(**kw), _synthetic_dataset(**kw)
    for f in ("node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
              "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert port.structure_ids == ref.structure_ids


def _committed_band():
    with open(B.BAND_PATH) as f:
        return json.load(f)


def test_gate_pass_fail_and_skipped(capsys):
    band = _committed_band()
    lo, hi = _band_limits(band)
    n, epochs = band["corpus"]["n"], band["epochs"]
    assert B.mae_gate((lo + hi) / 2, epochs, n)["mae_gate"] == "pass"
    assert B.mae_gate(lo * 0.99, epochs, n)["mae_gate"] == "FAIL"
    assert B.mae_gate(hi * 1.01, epochs, n)["mae_gate"] == "FAIL"
    assert B.mae_gate(hi * 10, epochs - 1, n)["mae_gate"] == \
        "skipped (epochs differ from the band's)"
    assert B.mae_gate(hi * 10, epochs, n + 1)["mae_gate"].startswith("skipped")
    assert B.finish({"metric": B.METRIC}, hi * 1.01, epochs, n) == 1
    line = json.loads(capsys.readouterr().out)
    assert line["mae_gate"] == "FAIL" and "mae_gate_band" in line
    assert B.finish({"metric": B.METRIC}, (lo + hi) / 2, epochs, n) == 0


def test_committed_band_leaves_the_mean_predictor_out():
    band = _committed_band()
    lo, hi = _band_limits(band)
    assert len(band["runs"]) >= 5 and band["epochs"] == B.EPOCHS == 250
    assert band["corpus"]["n"] == B.N_CORPUS and band["split_seed"] == 123
    assert sorted(r["seed"] for r in band["runs"]) == sorted(BAND_SEEDS)
    assert not lo <= band["mean_predictor_mae"] <= hi
    assert hi < band["mean_predictor_mae"] / 4  # a dead model fails by far


def test_bench_on_the_cpu_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "matdeeplearn_torch.bench", "--device", "cpu",
         "--n", "40", "--epochs", "8"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert BENCH_KEYS <= set(out) and "test_mae_8_epochs" in out
    assert out["metric"] == "epoch_time_synthetic_cgcnn"
    assert out["unit"] == "s/epoch" and out["value"] > 0
    assert out["device"] == "cpu" and out["kernel"] == "xla"
    assert out["mae_gate"] == "skipped (epochs differ from the band's)"
    assert np.isfinite(out["test_mae_8_epochs"])
    assert "mfu" not in out  # no peaks off the card
    assert "meter: Throughput:" in proc.stderr


def test_bulk_segment_reports_every_arm(monkeypatch):
    """The bulk segment's arms on the CPU at a tiny size (the bench runs it
    on the card only): the padded arms, CGCNN's csr arm on packed batches,
    MPNN's packed csr and xla arms, and the precision bf16 arms (CGCNN xla
    padded and packed, fused packed; MPNN fused packed), each run twice
    (captured, the default, then the eager loop), each give their key and
    their `_eager` key; an arm that fails raises, so no line goes out
    without it."""
    import torch

    from matdeeplearn_torch.training import jobs as J

    monkeypatch.setattr(B, "BULK", {**B.BULK, "n_graphs": 20, "batch": 8,
                                    "epochs": 1})
    monkeypatch.setattr(B, "BENCH_MODEL", {**B.BENCH_MODEL, "dim1": 8,
                                           "dim2": 8, "gc_count": 1})
    monkeypatch.setattr(B, "BULK_MPNN", {**B.BULK_MPNN, "dim1": 4, "dim2": 4,
                                         "dim3": 4, "gc_count": 1,
                                         "batch_size": 4})
    seen = []
    setup = J.setup_run

    def spy(ds, mp, *a, **k):
        seen.append((mp["model"], mp["kernel"], mp.get("batching"),
                     mp.get("precision", "f32"),
                     mp.get("kernel_precision", "f32")))
        return setup(ds, mp, *a, **k)

    monkeypatch.setattr(J, "setup_run", spy)
    out = B._bulk_epoch_times(torch.device("cpu"))
    arms = [("CGCNN", "fused", "padded", "f32", "f32"),
            ("CGCNN", "pallas", "padded", "f32", "f32"),
            ("CGCNN", "xla", "padded", "f32", "f32"),
            ("CGCNN", "csr", "packed", "f32", "f32"),
            ("MPNN", "csr", "packed", "f32", "f32"),
            ("MPNN", "xla", "packed", "f32", "f32"),
            ("CGCNN", "xla", "padded", "bf16", "f32"),
            ("CGCNN", "xla", "packed", "bf16", "f32"),
            ("CGCNN", "fused", "packed", "bf16", "f32"),
            ("MPNN", "fused", "packed", "bf16", "f32"),
            # bench_bulk.py's bf16-packed-csr: kernel_precision bf16 too
            ("CGCNN", "csr", "packed", "bf16", "bf16")]
    assert seen == [arm for arm in arms for _ in ("captured", "eager")]
    for key in ("bulk_epoch_s_csr_packed", "bulk_csr_packed_speedup",
                "bulk_mpnn_epoch_s_csr_fused", "bulk_mpnn_epoch_s_xla",
                "bulk_mpnn_csr_fused_speedup", "bulk_epoch_s_fused",
                "bulk_epoch_s_fused_eager", "bulk_epoch_s_pallas_eager",
                "bulk_epoch_s_xla_eager", "bulk_epoch_s_csr_packed_eager",
                "bulk_mpnn_epoch_s_csr_fused_eager",
                "bulk_mpnn_epoch_s_xla_eager", "bulk_epoch_s_bf16",
                "bulk_epoch_s_bf16_packed", "bulk_epoch_s_bf16_packed_fused",
                "bulk_mpnn_epoch_s_packed_fused_bf16",
                "bulk_epoch_s_bf16_eager", "bulk_epoch_s_bf16_packed_eager",
                "bulk_epoch_s_bf16_packed_fused_eager",
                "bulk_mpnn_epoch_s_packed_fused_bf16_eager",
                "bulk_epoch_s_bf16_packed_csr",
                "bulk_epoch_s_bf16_packed_csr_eager"):
        assert out[key] > 0, key

    def fail(ds, mp, *a, **k):
        if mp["model"] == "MPNN":
            raise RuntimeError("arm failed")
        return setup(ds, mp, *a, **k)

    monkeypatch.setattr(J, "setup_run", fail)
    with pytest.raises(RuntimeError, match="arm failed"):
        B._bulk_epoch_times(torch.device("cpu"))


def test_bench_cuda_request_without_cuda_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--n", "40", "--epochs", "8"])


@pytest.mark.slow
def test_band_rebuilds_from_the_jax_package(tmp_path):
    """Reruns every seed of bench_band.json with the JAX package (about
    150 s a seed on one CPU core-set, the seeds in parallel) and compares."""
    band = _committed_band()
    new = build_band(str(tmp_path), [r["seed"] for r in band["runs"]])
    for a, b in zip(new["runs"], band["runs"]):
        assert a["seed"] == b["seed"]
        np.testing.assert_allclose(a["test_mae"], b["test_mae"],
                                   rtol=REBUILD_RTOL)
    np.testing.assert_allclose(_band_limits(new), _band_limits(band),
                               rtol=REBUILD_RTOL)
    np.testing.assert_allclose(new["mean_predictor_mae"],
                               band["mean_predictor_mae"], rtol=1e-6)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--seed" in sys.argv:
        a = sys.argv
        mae = jax_bench_mae(a[a.index("--data") + 1], int(a[a.index("--seed") + 1]))
        print(json.dumps({"test_mae": mae}))
    elif "--write" in sys.argv:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            band = build_band(td)
        with open(B.BAND_PATH, "w") as f:
            json.dump(band, f, indent=1)
            f.write("\n")
        print(json.dumps(band))
    sys.exit(0)
