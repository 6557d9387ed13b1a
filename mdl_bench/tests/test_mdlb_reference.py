"""The plain reference against the program's CPU path at tiny sizes, and
its independence from the program."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mdl_bench import corpus as CORPUS, port, weights as W
from mdl_bench.reference import cgcnn, common as RC, graphs as RG, mpnn
from mdl_bench.tests.conftest import REPO, TINY

SPEC = {"n": 48, "seed": 0, "radius": 8.0, "max_neighbors": 12,
        "edge_resolution": 50}


@pytest.fixture(scope="module")
def small_corpus():
    arrays = RG.build_corpus(SPEC["n"], SPEC["seed"], SPEC["radius"],
                             SPEC["max_neighbors"])
    arrays["node_x"] = RG.node_features(arrays["node_z"], arrays["node_ptr"],
                                        arrays["edge_src"], arrays["edge_ptr"],
                                        12)
    arrays["edge_weight"] = arrays["edge_dist"].astype(np.float32)
    arrays["edge_dist_norm"] = RG.normalized_distances(arrays["edge_dist"])
    arrays["n"], arrays["edge_resolution"] = SPEC["n"], 50
    return arrays


def test_corpus_equals_the_programs_bulk_corpus(small_corpus, tmp_path,
                                                monkeypatch):
    from matdeeplearn_torch import bench_bulk

    monkeypatch.setattr(bench_bulk, "CACHE", str(tmp_path))
    ds = bench_bulk.build_corpus(SPEC["n"], SPEC["seed"])
    c = small_corpus
    for mine, theirs in (("edge_src", "edge_src"), ("edge_dst", "edge_dst"),
                         ("node_ptr", "node_ptr"), ("edge_ptr", "edge_ptr"),
                         ("edge_weight", "edge_weight"),
                         ("edge_dist_norm", "edge_dist_norm"), ("y", "y"),
                         ("node_x", "node_x"), ("node_z", "node_z")):
        np.testing.assert_array_equal(c[mine], getattr(ds, theirs), mine)


def test_the_corpus_cache_reads_back_what_it_wrote(tmp_path, monkeypatch):
    monkeypatch.setattr(CORPUS, "CACHE", str(tmp_path))
    first = CORPUS.load(SPEC, log=lambda *a: None)
    second = CORPUS.load(SPEC, log=lambda *a: None)
    assert len(os.listdir(tmp_path)) == 1
    for k in ("node_x", "edge_src", "edge_dist_norm", "y"):
        np.testing.assert_array_equal(first[k], second[k])


@pytest.mark.parametrize("model, ref", [("CGCNN", cgcnn), ("MPNN", mpnn)])
@pytest.mark.parametrize("train", [False, True])
def test_reference_forward_matches_the_program(small_corpus, model, ref,
                                               train):
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble)
    from matdeeplearn_torch.models import build_model

    c = small_corpus
    cfg = {"model": model, "pre_fc_count": 1, "pool": "global_mean_pool",
           "batch_norm": "True", "act": "relu", "edge_resolution": 50, **TINY}
    ds = port.graph_dataset(c)
    prog = build_model(model, ds, cfg, generator=torch.Generator().manual_seed(0))
    w = W.make(ref.param_table(cfg, ds.num_features), 123, "cpu")
    W.load_into(prog, w)
    prog.train(train)
    ids = np.arange(0, 40, 3)
    data = DeviceDataset.from_graph_dataset(ds, "cpu", edge_order="dst")
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(ids))
    got = prog(assemble(data, torch.as_tensor(ids), spec)).detach()
    stats = {}
    want = ref.forward(w, RC.batch_of(c, ids, "cpu"), cfg, train, stats)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k, v in stats.items():  # BatchNorm's running update in training
        np.testing.assert_allclose(prog.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert len(stats) == (2 * TINY["gc_count"] if train else 0)


def test_adamw_is_torchs():
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(5, 7, generator=g)
    grads = [torch.randn(5, 7, generator=g) for _ in range(3)]
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.AdamW([p], lr=2e-3)
    w, state = {"p": p0.clone()}, {}
    for step, gr in enumerate(grads, start=1):
        p.grad = gr.clone()
        opt.step()
        RC.adamw_step(w, {"p": gr}, state, step, 2e-3)
    np.testing.assert_allclose(w["p"].numpy(), p.detach().numpy(), rtol=1e-6,
                               atol=1e-7)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import mdl_bench.reference.cgcnn, "
            "mdl_bench.reference.mpnn, mdl_bench.reference.graphs; "
            "bad = [m for m in sys.modules if m.split('.')[0].startswith("
            "'matdeeplearn')]; print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stdout + p.stderr
    folder = os.path.join(REPO, "mdl_bench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                text = f.read()
            assert "import matdeeplearn" not in text
            assert "from matdeeplearn" not in text


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11),
                      1 + 2 ** -10])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, -(1 + 2 ** -9), 1 + 2 ** -10])
    assert torch.equal(RC.round_tf32(x), want)


@pytest.mark.parametrize("spec, sa, sb", [("nd,od->no", (6, 5), (4, 5)),
                                          ("ed,edk->ek", (7, 3), (7, 3, 4))])
def test_the_control_rounds_every_product_forward_and_backward(spec, sa, sb):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(sa, generator=g, requires_grad=True)
    b = torch.randn(sb, generator=g, requires_grad=True)
    r = RC.round_tf32
    with RC.matmul_precision(tf32=True):
        y = RC.product(spec, a, b)
    cot = torch.randn(y.shape, generator=g)
    y.backward(cot)
    ins, out = spec.split("->")
    s_a, s_b = ins.split(",")
    assert torch.allclose(y, torch.einsum(spec, r(a), r(b)))
    assert torch.allclose(a.grad, torch.einsum(f"{out},{s_b}->{s_a}", r(cot), r(b)))
    assert torch.allclose(b.grad, torch.einsum(f"{s_a},{out}->{s_b}", r(a), r(cot)))
    with RC.matmul_precision(tf32=False):
        plain = RC.product(spec, a, b)
    assert not torch.equal(plain, y)
