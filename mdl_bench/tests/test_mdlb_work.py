"""The frozen work model counts real nodes, edges and graphs, and the
shares built on it cannot pass 100% while the measured time is at least
the least time."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from mdl_bench import port, work
from mdl_bench.reference import graphs as RG
from mdl_bench.tests.conftest import REPO

CFG = {"model": "CGCNN", "dim1": 100, "dim2": 150, "pre_fc_count": 1,
       "gc_count": 4, "post_fc_count": 3, "edge_resolution": 50}


def _reader(name):
    path = os.path.join(REPO, "mdl_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_padded_and_packed_batches_of_the_same_graphs_do_the_same_work():
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble)

    c = RG.build_corpus(40, 1, 8.0, 12)
    c["node_x"] = RG.node_features(c["node_z"], c["node_ptr"], c["edge_src"],
                                   c["edge_ptr"], 12)
    c["edge_weight"] = c["edge_dist"].astype(np.float32)
    c["edge_dist_norm"] = RG.normalized_distances(c["edge_dist"])
    c["n"], c["edge_resolution"] = 40, 50
    ds = port.graph_dataset(c)
    data = DeviceDataset.from_graph_dataset(ds, "cpu", edge_order="dst")
    ids = torch.arange(0, 24)
    counts = []
    for spec in (BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 24),
                 BatchSpec.packed_for_dataset(ds.node_counts(),
                                              ds.edge_counts(), 24)):
        ids_padded = torch.full((spec.num_graphs,), -1)
        ids_padded[:24] = ids
        b = assemble(data, ids_padded, spec)
        counts.append((spec.num_edges, float(b.node_mask.sum()),
                       float(b.edge_mask.sum()), float(b.graph_mask.sum())))
    (slots_a, *real_a), (slots_b, *real_b) = counts
    assert slots_a != slots_b and real_a == real_b
    f = [work.step_flops("CGCNN", CFG, 114, *r) for r in (real_a, real_b)]
    assert f[0] == f[1] == work.step_flops(
        "CGCNN", CFG, 114, ds.node_counts()[:24].sum(),
        ds.edge_counts()[:24].sum(), 24)


@pytest.mark.parametrize("model", ["CGCNN", "MPNN"])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("slack", [1.0, 1.7, 40.0])
def test_conv_roofline_cannot_pass_100(model, backward, slack):
    kind = "train" if backward else "predict"
    read = _reader(f"conv_roofline.{kind}")
    cfg = {**CFG, "model": model, "dim3": 100}
    for n, e in ((1e3, 1.3e4), (9e3, 1.2e5), (10.0, 10.0)):
        flops = (3.0 if backward else 1.0) * work.conv_flops(model, cfg, 114, n, e)
        least = work.least_seconds(flops, work.conv_bytes(cfg, 114, n, e,
                                                          backward),
                                   work.PEAKS["NVIDIA H100 80GB HBM3"])
        rec = {"kind": kind, "model": model, "config": cfg,
               "num_features": 114, "device_name": "NVIDIA H100 80GB HBM3",
               "conv": {"counts": [n, e], "seconds": least * slack,
                        "backward": backward}}
        share = read(rec)
        assert share == pytest.approx(100.0 / slack) and share <= 100.0


@pytest.mark.parametrize("slack", [1.0, 3.0])
def test_mfu_cannot_pass_100(slack):
    read = _reader("mfu_pct.predict")
    counts = [9e3, 1.2e5, 300.0]
    flops = work.step_flops("CGCNN", CFG, 114, *counts)
    window = flops / 989.4e12 * slack
    rec = {"kind": "predict", "model": "CGCNN", "config": CFG,
           "num_features": 114, "device_name": "NVIDIA H100 80GB HBM3",
           "predict_counts": counts, "trace": {"window_s": window}}
    assert read(rec) == pytest.approx(100.0 / slack)


def test_an_unknown_card_reads_no_share():
    read = _reader("mfu_pct.predict")
    rec = {"kind": "predict", "model": "CGCNN", "config": CFG,
           "num_features": 114, "device_name": "cpu",
           "predict_counts": [1, 1, 1], "trace": {"window_s": 1.0}}
    assert read(rec) is None
