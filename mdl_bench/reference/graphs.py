"""The benchmark's corpus and crystal graphs, in numpy: a frozen copy.

The corpus is the Materials Project's size skew (the bulk corpus of
MatDeepLearn's bench_bulk): n periodic structures whose atom counts are
lognormal (median 28, sigma 0.55) clipped to [8, 250], species 1-89,
positions uniform in a cubic cell of side max(7, 2.2·n^(1/3)·1.6), and one
standard-normal target each, all drawn from numpy's default_rng(seed) in
that order. Each structure becomes a crystal graph as MatDeepLearn's
process.py builds it: the minimum-image distance matrix, per atom the
max_neighbors nearest atoms within the radius (ties by index), edges in
row-major order, then one self-loop per atom with distance 0. Node
features: the default atom dictionary's one-hot of Z (100 columns) and the
one-hot out-degree, self-loop included (max_neighbors + 2 columns).
Distances are normalised min-max over the whole corpus.

Nothing here imports the program: the benchmark hands the same arrays to
the program and to the plain reference.
"""

from __future__ import annotations

import numpy as np


def draw_structures(n: int, seed: int, median: float = 28.0,
                    sigma: float = 0.55, lo: int = 8, hi: int = 250):
    """(sizes, [(numbers, positions, side)], y) of the n-structure corpus."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(np.exp(rng.normal(np.log(median), sigma, n))),
                    lo, hi).astype(int)
    structures = []
    for na in sizes:
        side = max(7.0, 2.2 * na ** (1.0 / 3.0) * 1.6)
        cell = np.eye(3) * side
        numbers = rng.integers(1, 90, na)
        positions = rng.random((na, 3)) @ cell
        structures.append((numbers, positions, side))
    y = rng.standard_normal((n, 1)).astype(np.float32)
    return sizes, structures, y


def mic_distances(positions: np.ndarray, side: float) -> np.ndarray:
    """All-pairs minimum-image distances in a periodic cubic cell."""
    cell = np.eye(3) * side
    delta = positions[None, :, :] - positions[:, None, :]
    frac = delta @ np.linalg.inv(cell)
    wrap = frac - np.round(frac)
    shifts = np.array(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                  indexing="ij")).reshape(3, -1).T
    cand = (wrap[:, :, None, :] + shifts[None, None, :, :]) @ cell
    return np.sqrt(np.sum(cand * cand, axis=-1)).min(axis=2)


def graph_edges(positions: np.ndarray, side: float, radius: float,
                max_neighbors: int):
    """(src, dst, dist) of one structure, self-loops last."""
    dm = mic_distances(positions, side)
    invalid = dm > radius
    order = np.argsort(np.where(invalid, np.inf, dm), axis=1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order,
                      np.broadcast_to(np.arange(1, dm.shape[1] + 1),
                                      order.shape), axis=1)
    trimmed = np.where((~invalid) & (ranks <= max_neighbors + 1), dm, 0.0)
    src, dst = np.nonzero(trimmed)
    loops = np.arange(len(positions))
    return (np.concatenate([src, loops]), np.concatenate([dst, loops]),
            np.concatenate([trimmed[src, dst], np.zeros(len(positions))]))


def build_corpus(n: int, seed: int, radius: float, max_neighbors: int
                 ) -> dict:
    """The corpus as flat arrays: node_z, node_ptr, edge_src, edge_dst
    (graph-local, uint8: a structure holds at most 250 atoms), edge_dist
    (raw, f64), edge_ptr, y."""
    sizes, structures, y = draw_structures(n, seed)
    if sizes.max() > 256:
        raise ValueError("the corpus keeps local node ids in uint8")
    srcs, dsts, dists = [], [], []
    for numbers, positions, side in structures:
        s, d, w = graph_edges(positions, side, radius, max_neighbors)
        srcs.append(s)
        dsts.append(d)
        dists.append(w)
    return dict(
        node_z=np.concatenate([s[0] for s in structures]).astype(np.int32),
        node_ptr=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        edge_src=np.concatenate(srcs).astype(np.uint8),
        edge_dst=np.concatenate(dsts).astype(np.uint8),
        edge_dist=np.concatenate(dists),
        edge_ptr=np.concatenate([[0], np.cumsum([len(s) for s in srcs])]
                                ).astype(np.int64),
        y=y)


def node_features(node_z: np.ndarray, node_ptr: np.ndarray,
                  edge_src: np.ndarray, edge_ptr: np.ndarray,
                  max_neighbors: int) -> np.ndarray:
    """(N, 100 + max_neighbors + 2) f32: one-hot Z, one-hot out-degree."""
    n_nodes = len(node_z)
    gid = np.repeat(np.arange(len(edge_ptr) - 1), np.diff(edge_ptr))
    node = edge_src.astype(np.int64) + node_ptr[gid]
    deg = np.bincount(node, minlength=n_nodes)
    classes = max_neighbors + 2
    if deg.max(initial=0) >= classes:
        raise ValueError(f"degree {deg.max()} exceeds {classes - 1}")
    x = np.zeros((n_nodes, 100 + classes), np.float32)
    x[np.arange(n_nodes), node_z.astype(np.int64) - 1] = 1.0
    x[np.arange(n_nodes), 100 + deg] = 1.0
    return x


def normalized_distances(edge_dist: np.ndarray) -> np.ndarray:
    """Min-max over every edge of the corpus (self-loops make the min 0)."""
    lo, hi = float(edge_dist.min()), float(edge_dist.max())
    return ((edge_dist - lo) / (hi - lo)).astype(np.float32)
