"""PyTorch port data path vs the JAX package on the CPU: readers, graph
building, processing (every array exactly equal) and batch assembly
(every field equal, masked rows where pad contents may differ)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.data import graphs as JG
from matdeeplearn_tpu.data import structures as JS
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.data import graphs as TG
from matdeeplearn_torch.data import structures as TS

from conftest import TOY_PROCESSING_ARGS, _make_structures


def _write_formats(s, root):
    """One structure as ase-json, extended xyz and POSCAR files."""
    TS.write_ase_json(s, os.path.join(root, "s.json"))
    lat = " ".join(f"{v:.10f}" for v in s.cell.ravel())
    lines = [str(len(s)), f'Lattice="{lat}" pbc="T T T"']
    lines += [f"{TS.CHEMICAL_SYMBOLS[z]} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}"
              for z, p in zip(s.numbers, s.positions)]
    with open(os.path.join(root, "s.xyz"), "w") as f:
        f.write("\n".join(lines) + "\n")
    order = np.argsort(s.numbers, kind="stable")
    zs, counts = np.unique(s.numbers[order], return_counts=True)
    frac = s.positions[order] @ np.linalg.inv(s.cell)
    lines = ["toy", "1.0"] + [" ".join(f"{v:.10f}" for v in row) for row in s.cell]
    lines += [" ".join(TS.CHEMICAL_SYMBOLS[z] for z in zs),
              " ".join(str(c) for c in counts), "Direct"]
    lines += [" ".join(f"{v:.12f}" for v in row) for row in frac]
    with open(os.path.join(root, "s.poscar"), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("fmt", ["json", "xyz", "poscar"])
def test_readers_match(tmp_path, fmt):
    s = _make_structures(np.random.default_rng(3), n=1)[0]
    _write_formats(s, str(tmp_path))
    path = str(tmp_path / f"s.{fmt}")
    a = JS.read_structure(path, fmt, "7")
    b = TS.read_structure(path, fmt, "7")
    for field in ("numbers", "positions", "cell", "pbc"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
    assert b.structure_id == a.structure_id == "7"


@pytest.mark.parametrize("periodic", [True, False])
def test_build_graph_matches(periodic):
    for s in _make_structures(np.random.default_rng(11), n=6, periodic=periodic):
        j = JG.build_graph(s, 5.0, 6)
        t = TG.build_graph(s, 5.0, 6)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(
            TG.one_hot_degree(t[0], len(s), 7), JG.one_hot_degree(j[0], len(s), 7))


@pytest.fixture(scope="module")
def both_datasets(toy_data_dir):
    """The toy set processed independently by each package (separate caches;
    the JAX one through its numpy featurizer, the port's only path)."""
    import matdeeplearn_tpu.data.native as native

    saved = native.featurize_structures
    native.featurize_structures = lambda *a, **k: None
    try:
        jds = JD.process_data(toy_data_dir, "processed_cmp_jax",
                              dict(TOY_PROCESSING_ARGS))
    finally:
        native.featurize_structures = saved
    tds = TD.process_data(toy_data_dir, "processed_cmp_port",
                          dict(TOY_PROCESSING_ARGS))
    return jds, tds


def test_process_data_matches(both_datasets, toy_data_dir):
    jds, tds = both_datasets
    for k in ("node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
              "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u"):
        a, b = getattr(jds, k), getattr(tds, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tds.structure_ids == jds.structure_ids
    assert tds.species == jds.species
    # the port reads the cache it wrote back identically
    again = TD.get_dataset(toy_data_dir, 0, "False",
                           {**TOY_PROCESSING_ARGS,
                            "processed_path": "processed_cmp_port"})
    np.testing.assert_array_equal(again.edge_dist_norm, tds.edge_dist_norm)
    assert again.structure_ids == tds.structure_ids


def test_slot_to_graph_matches():
    cum = np.array([3, 3, 7, 12, 12, 40], np.int32)  # last > num_slots
    ref = np.asarray(JB._slot_to_graph(jnp.asarray(cum), 20))
    out = TB._slot_to_graph(torch.as_tensor(cum, dtype=torch.int64), 20).numpy()
    np.testing.assert_array_equal(out, ref)


def test_batch_spec_matches(both_datasets):
    jds, _ = both_datasets
    for bs in (3, 8, 128):
        a = JB.BatchSpec.for_dataset(jds.node_counts(), jds.edge_counts(), bs)
        b = TB.BatchSpec.for_dataset(jds.node_counts(), jds.edge_counts(), bs)
        assert (a.num_graphs, a.num_nodes, a.num_edges) == (
            b.num_graphs, b.num_nodes, b.num_edges)


@pytest.mark.parametrize("edge_order", [None, "dst"])
def test_assemble_batch_matches(both_datasets, edge_order):
    jds, _ = both_datasets
    jdd = JB.DeviceDataset.from_graph_dataset(jds, edge_order=edge_order)
    tdd = TB.DeviceDataset.from_graph_dataset(jds, "cpu", edge_order=edge_order)
    if edge_order == "dst":
        np.testing.assert_array_equal(tdd.node_indeg.numpy(),
                                      np.asarray(jdd.node_indeg))
    spec = TB.BatchSpec.for_dataset(jds.node_counts(), jds.edge_counts(), 6)
    jspec = JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges)
    for ids in ([4, 0, 9, 13, -1, -1], [15, 2, 7, 1, 11, 3]):
        ids = np.asarray(ids, np.int32)
        jb = JB.assemble_batch(jdd, jnp.asarray(ids), jspec)
        tb = TB.assemble_batch(tdd, ids, spec)
        nm = np.asarray(jb.node_mask) > 0
        em = np.asarray(jb.edge_mask) > 0
        for k in ("node_mask", "edge_mask", "graph_mask", "node_graph", "y",
                  "u", "n_node"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)), err_msg=k)
        np.testing.assert_array_equal(tb.x.numpy()[nm], np.asarray(jb.x)[nm])
        for k in ("edge_src", "edge_dst", "edge_weight", "edge_dist_norm"):
            np.testing.assert_array_equal(getattr(tb, k).numpy()[em],
                                          np.asarray(getattr(jb, k))[em],
                                          err_msg=k)
        assert tb.dst_sorted == jb.dst_sorted
        if edge_order == "dst":
            np.testing.assert_array_equal(tb.in_degree.numpy(),
                                          np.asarray(jb.in_degree))
            real = tb.edge_dst.numpy()[em]
            assert np.all(np.diff(real) >= 0)
        else:
            assert tb.in_degree is None and jb.in_degree is None
