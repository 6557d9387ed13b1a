"""PyTorch port Predict vs the JAX package's Predict on the CPU, the port's
CLI, and chip_smoke.py's config held to config.yml.

A JAX CGCNN (random parameters and BatchNorm running statistics) is saved
with the JAX checkpoint writer; its parameters go through the converter
into a port checkpoint. Both Predicts run on toy_data_dir: same CSV ids
and targets, predictions within 1e-4, test error within 1e-5.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.models import MODEL_FIELDS as J_MODEL_FIELDS
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import (load_checkpoint as j_load,
                                                  params_from_raw,
                                                  save_checkpoint as j_save)
from matdeeplearn_tpu.training.train import TrainState
from matdeeplearn_torch.convert import params_from_jax
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import save_checkpoint

from conftest import TOY_PROCESSING_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"model": "CGCNN", "dim1": 24, "dim2": 16, "pre_fc_count": 1,
         "gc_count": 3, "post_fc_count": 2, "batch_norm": "True"}


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    body = rows[1:]
    return (rows[0], [r[0] for r in body],
            np.array([float(r[1]) for r in body]),
            np.array([float(r[2]) for r in body]))


@pytest.fixture(scope="module")
def checkpoints(toy_dataset, tmp_path_factory):
    """A JAX checkpoint and the port checkpoint converted from it."""
    ds = toy_dataset
    root = tmp_path_factory.mktemp("predict")
    model = j_build_model("CGCNN", ds, MODEL)
    spec = JB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 4)
    batch = JB.assemble_batch(JB.DeviceDataset.from_graph_dataset(ds),
                              jnp.arange(4, dtype=jnp.int32), spec)
    variables = model.init(jax.random.PRNGKey(3), batch, training=False)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for bn in stats.values():
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    state = TrainState(params=variables["params"], batch_stats=stats,
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    cfg = {k: v for k, v in MODEL.items() if k in J_MODEL_FIELDS["CGCNN"]}
    cfg.update(num_features=ds.num_features, output_dim=ds.output_dim,
               edge_resolution=ds.num_edge_features)
    jpath = str(root / "jax.ckpt")
    j_save(jpath, state, None, "CGCNN", cfg)

    meta, raw = j_load(jpath)
    params, batch_stats = params_from_raw(raw)
    tpath = str(root / "port.ckpt")
    save_checkpoint(tpath, params_from_jax(jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, batch_stats)),
                    meta["model_name"], meta["model_config"])
    return jpath, tpath


def test_predict_matches_jax(toy_dataset, checkpoints, tmp_path, monkeypatch,
                             capsys):
    jpath, tpath = checkpoints
    monkeypatch.chdir(tmp_path)
    jerr = JJ.predict(toy_dataset, "l1_loss",
                      {"model_path": jpath, "job_name": "jax"})
    terr = TJ.predict(toy_dataset, "l1_loss",
                      {"model_path": tpath, "job_name": "port"}, device="cpu")
    out = capsys.readouterr().out
    assert out.count("Evaluation time (s):") == 2 and out.count("Test Error:") == 2
    jh, jids, jt, jp = _read_csv("jax_predicted_outputs.csv")
    th, tids, tt, tp = _read_csv("port_predicted_outputs.csv")
    assert th == jh == ["ids", "target", "prediction"]
    assert tids == jids == toy_dataset.structure_ids
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-4)
    assert abs(terr - jerr) <= 1e-5


def test_cli_predict_on_cpu(toy_data_dir, checkpoints, tmp_path):
    """`python -m matdeeplearn_torch --run_mode=Predict --device=cpu` against
    a copy of config.yml pointed at the toy data."""
    _, tpath = checkpoints
    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Processing"].update(TOY_PROCESSING_ARGS, data_path=toy_data_dir)
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "matdeeplearn_torch", "--config_path",
         str(cfg_path), "--run_mode=Predict", "--device=cpu",
         "--model_path", tpath],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Test Error:" in proc.stdout
    _, ids, _, preds = _read_csv(tmp_path / "my_predict_job_predicted_outputs.csv")
    assert len(ids) == 16 and np.isfinite(preds).all()


def test_predict_on_cuda_without_cuda_raises(toy_dataset, checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, tpath = checkpoints
    with pytest.raises(RuntimeError, match="cuda"):
        TJ.predict(toy_dataset, "l1_loss", {"model_path": tpath})


def test_chip_smoke_config_matches_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.PROCESSING == cfg["Processing"]
    assert chip_smoke.TRAINING == cfg["Training"]
    assert chip_smoke.PREDICT_JOB == cfg["Job"]["Predict"]
    assert chip_smoke.CGCNN_DEMO == cfg["Models"]["CGCNN_demo"]
