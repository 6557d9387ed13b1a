"""The port's C++ featurizer (csrc/featurize.cpp through data/native.py)
against the JAX package's native featurizer and the port's numpy
build_graph on the CPU: edge indices exact, distances to 1e-12, on
periodic, non-periodic and triclinic cells (the cases of
tests/test_native.py); process_data prints which path ran and gives the
same dataset either way; the CUDA kernels' build ignores the host
source."""

import os

import numpy as np
import pytest

from matdeeplearn_tpu.data import native as JN
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.data import graphs as TG
from matdeeplearn_torch.data import native as TN
from matdeeplearn_torch.data.structures import Structure
from matdeeplearn_torch.ops import _build

from conftest import TOY_PROCESSING_ARGS


@pytest.fixture(scope="module")
def libs():
    if TN.get_library() is None or JN.get_library() is None:
        pytest.fail("the native featurizer did not build (g++ is installed "
                    "on this host)")


def _periodic(rng):
    out = []
    for i in range(6):
        na = int(rng.integers(3, 10))
        cell = np.eye(3) * (6.0 + rng.random() * 2)
        out.append(Structure(rng.integers(1, 30, na), rng.random((na, 3)) @ cell,
                             cell, np.ones(3, bool), str(i)))
    return out


def _clusters(rng):
    return [Structure(rng.integers(1, 20, 7), rng.random((7, 3)) * 6,
                      np.zeros((3, 3)), np.zeros(3, bool), str(i))
            for i in range(5)]


def _triclinic(rng):
    cell = np.array([[6.0, 0, 0], [2.0, 5.0, 0], [1.0, 1.5, 7.0]])
    return [Structure(rng.integers(1, 20, 6), rng.random((6, 3)) @ cell, cell,
                      np.ones(3, bool), str(i)) for i in range(4)]


CASES = {"periodic": (_periodic, 5.0, 6), "clusters": (_clusters, 4.0, 3),
         "triclinic": (_triclinic, 5.0, 4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_edges_match_jax_and_numpy(libs, case):
    make, radius, k = CASES[case]
    structs = make(np.random.default_rng(11))
    got = TN.featurize_structures(structs, radius, k)
    ref = JN.featurize_structures(structs, radius, k)
    assert got is not None and ref is not None
    for i, s in enumerate(structs):
        src, dst, dist = TG.build_graph(s, radius, k)
        for a, b in ((got[0][i], src), (got[1][i], dst),
                     (got[0][i], ref[0][i]), (got[1][i], ref[1][i])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[2][i], dist, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[2][i], ref[2][i], rtol=0, atol=1e-12)


def test_library_builds_under_build_native(libs):
    path = TN.build_library()
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "native")
    assert path.startswith(root + os.sep) and os.path.exists(path)
    assert TN.get_library().featurize_abi_version() == TN.ABI_VERSION


def test_the_cuda_build_ignores_the_host_source():
    assert all(p.endswith(".cu") for p in _build.sources())
    assert TN.SOURCE.startswith(_build.CSRC)


def test_process_data_prints_its_path_and_gives_one_dataset(
        libs, toy_data_dir, monkeypatch, capsys):
    args = {**TOY_PROCESSING_ARGS, "verbose": "True"}
    native = TD.get_dataset(toy_data_dir, 0, "True",
                            {**args, "processed_path": "port_native"})
    assert "Data processed (native): 16 out of 16" in capsys.readouterr().out
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_lib_tried", False)
    monkeypatch.setattr(TN, "build_library", lambda: None)
    plain = TD.get_dataset(toy_data_dir, 0, "True",
                           {**args, "processed_path": "port_numpy"})
    out = capsys.readouterr().out
    assert "Data processed: 16 out of 16" in out and "(native)" not in out
    for key in ("edge_src", "edge_dst", "edge_ptr", "node_x"):
        np.testing.assert_array_equal(getattr(native, key), getattr(plain, key))
    np.testing.assert_allclose(native.edge_weight, plain.edge_weight, rtol=0,
                               atol=1e-6)
