"""The corpus a traffic mix names, built once by the frozen generator
(reference/graphs.py) and cached under mdl_bench/cache/ as its indices and
distances; node features, normalised distances and the split are worked
out again at every load."""

from __future__ import annotations

import hashlib
import inspect
import json
import os

import numpy as np

from mdl_bench.reference import graphs as RG

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache")
_STORED = ("node_z", "node_ptr", "edge_src", "edge_dst", "edge_dist",
           "edge_ptr", "y")


def _cache_path(spec: dict) -> str:
    """A fixed name per corpus spec and generator source."""
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    h.update(inspect.getsource(RG).encode())
    return os.path.join(CACHE, f"corpus_{spec['n']}_{h.hexdigest()[:12]}.npz")


def load(spec: dict, log=print) -> dict:
    """{"node_x", "node_z", "node_ptr", "edge_src", "edge_dst",
    "edge_dist", "edge_weight", "edge_dist_norm", "edge_ptr", "y", "n"}
    of the corpus spec {"n", "seed", "radius", "max_neighbors",
    "edge_resolution"} (the Gaussian basis's width, the config.yml's
    graph_edge_length)."""
    path = _cache_path(spec)
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as f:
            arrays = {k: f[k] for k in _STORED}
    else:
        log(f"building the corpus {spec} (cached at {path})")
        arrays = RG.build_corpus(int(spec["n"]), int(spec["seed"]),
                                 float(spec["radius"]),
                                 int(spec["max_neighbors"]))
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    arrays["node_x"] = RG.node_features(arrays["node_z"], arrays["node_ptr"],
                                        arrays["edge_src"], arrays["edge_ptr"],
                                        int(spec["max_neighbors"]))
    arrays["edge_weight"] = arrays["edge_dist"].astype(np.float32)
    arrays["edge_dist_norm"] = RG.normalized_distances(arrays["edge_dist"])
    arrays["n"] = len(arrays["node_ptr"]) - 1
    arrays["edge_resolution"] = int(spec["edge_resolution"])
    return arrays


def split(n: int, spec: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, val, held-out) ids: contiguous int(n·ratio) slices of one
    permutation by numpy's default_rng(spec["seed"]), whatever the run's
    seed, so every seed runs the same graphs."""
    perm = np.random.default_rng(int(spec["seed"])).permutation(n)
    a = int(n * float(spec["train"]))
    b = a + int(n * float(spec["val"]))
    c = b + int(n * float(spec["test"]))
    return perm[:a], perm[a:b], perm[b:c]


def node_counts(c: dict) -> np.ndarray:
    return np.diff(c["node_ptr"])


def edge_counts(c: dict) -> np.ndarray:
    return np.diff(c["edge_ptr"])


def subset(c: dict, ids) -> dict:
    """The corpus arrays of the graphs `ids`, in that order."""
    ids = np.asarray(ids, np.int64)
    nptr, eptr = c["node_ptr"], c["edge_ptr"]
    nodes = np.concatenate([np.arange(nptr[i], nptr[i + 1]) for i in ids])
    edges = np.concatenate([np.arange(eptr[i], eptr[i + 1]) for i in ids])
    out = {k: c[k][nodes] for k in ("node_x", "node_z")}
    out.update({k: c[k][edges] for k in ("edge_src", "edge_dst", "edge_dist",
                                          "edge_weight", "edge_dist_norm")})
    out["node_ptr"] = np.concatenate([[0], np.cumsum(nptr[ids + 1] - nptr[ids])])
    out["edge_ptr"] = np.concatenate([[0], np.cumsum(eptr[ids + 1] - eptr[ids])])
    out["y"] = c["y"][ids]
    out["n"] = len(ids)
    out["edge_resolution"] = c["edge_resolution"]
    return out
