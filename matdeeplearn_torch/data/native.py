"""ctypes bindings for the port's C++ graph featurizer (csrc/featurize.cpp).

The reference spends preprocessing in python-level ase.get_all_distances +
scipy rankdata per structure (process/process.py:284-297); the native path
runs the same math in C++ with OpenMP over structures. The shared library
is built at first use with g++ into build/native/<source hash>/ at the
repository root, so a source edit rebuilds and a checkout never loads a
stale library. csrc/featurize.cpp is host code: the CUDA kernels' build
(ops/_build.py, csrc/*.cu) neither compiles it nor hashes it.

Where no g++ exists (or the build fails) `featurize_structures` returns
None and data/dataset.py:process_data runs the numpy featurizer
(data/graphs.py:build_graph), which gives the same edges; this is a host
fallback, and process_data prints which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "featurize.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
ABI_VERSION = 3
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]

_lib = None
_lib_tried = False


def build_library() -> str | None:
    """Compile featurize.cpp into build/native/<hash>/featurize.so (once
    per source); the path, or None without a working g++. A toolchain
    without OpenMP builds it single-threaded."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, tag)
    so_path = os.path.join(out_dir, "featurize.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    for flags in (CXX_FLAGS, [f for f in CXX_FLAGS if f != "-fopenmp"]):
        try:
            subprocess.run(["g++", *flags, SOURCE, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, so_path)
        return so_path
    return None


def get_library():
    """The loaded featurizer (built at first use), or None."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    so_path = build_library()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    f64, i64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.featurize_graphs.restype = ctypes.c_int
    lib.featurize_graphs.argtypes = [
        f64,                              # positions (N_total, 3)
        f64,                              # cells (G, 9)
        ctypes.POINTER(ctypes.c_uint8),   # pbcs (G, 3)
        i64,                              # atom_ptr (G+1,)
        ctypes.c_int64,                   # n_structs
        ctypes.c_double,                  # radius
        ctypes.c_int,                     # max_neighbors
        i32, i32, f64,                    # edge_src, edge_dst, edge_dist out
        i64,                              # edge_ptr (G+1,) out
    ]
    lib.featurize_abi_version.restype = ctypes.c_int
    if lib.featurize_abi_version() != ABI_VERSION:
        return None
    _lib = lib
    return _lib


def featurize_structures(structures, radius: float, max_neighbors: int):
    """(srcs, dsts, dists): per-structure edge arrays with the order and
    values of graphs.build_graph, from the native featurizer; None when it
    is unavailable or fails."""
    lib = get_library()
    if lib is None or not structures:
        return None
    n = len(structures)
    atom_ptr = np.concatenate(
        [[0], np.cumsum([len(s) for s in structures])]).astype(np.int64)
    positions = np.ascontiguousarray(
        np.concatenate([s.positions for s in structures]), np.float64)
    cells = np.ascontiguousarray(
        np.stack([s.cell for s in structures]).reshape(n, 9), np.float64)
    pbcs = np.ascontiguousarray(
        np.stack([s.pbc for s in structures]).reshape(n, 3), np.uint8)
    cap = int(atom_ptr[-1]) * (max_neighbors + 2)
    edge_src = np.zeros(cap, np.int32)
    edge_dst = np.zeros(cap, np.int32)
    edge_dist = np.zeros(cap, np.float64)
    edge_ptr = np.zeros(n + 1, np.int64)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    rc = lib.featurize_graphs(
        ptr(positions, ctypes.c_double), ptr(cells, ctypes.c_double),
        ptr(pbcs, ctypes.c_uint8), ptr(atom_ptr, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_double(radius), ctypes.c_int(max_neighbors),
        ptr(edge_src, ctypes.c_int32), ptr(edge_dst, ctypes.c_int32),
        ptr(edge_dist, ctypes.c_double), ptr(edge_ptr, ctypes.c_int64))
    if rc != 0:
        return None
    bounds = list(zip(edge_ptr[:-1], edge_ptr[1:]))
    return ([edge_src[a:b].copy() for a, b in bounds],
            [edge_dst[a:b].copy() for a, b in bounds],
            [edge_dist[a:b].copy() for a, b in bounds])
