"""Structure → crystal-graph featurization (host-side, pure numpy).

Re-derives the reference pipeline (matdeeplearn/process/process.py:197-533)
with identical numerics:

  1. MIC all-pairs distance matrix            (process.py:284)
  2. radius + k-nearest-neighbor trim          (threshold_sort, process.py:540-576)
  3. dense→sparse edges + self-loops (w=0)     (process.py:295-302)
  4. atom-dictionary node features ⊕ one-hot out-degree  (process.py:363-388,594-605)
  5. dataset-wide min-max distance normalization          (process.py:626-653)
  6. Gaussian basis expansion, width 0.2 over [0,1]       (process.py:580-590)

The Gaussian edge expansion (step 6) is *not* materialized on the host: the
dataset stores the normalized scalar distance and the model expands it to
`graph_edge_length` channels on the device (ops/edge_basis.py). This cuts
processed-dataset size and host→device transfer by ~50x.

A copy of the reference package's data/graphs.py: the PyTorch port imports
nothing of that package, and the processed arrays must stay identical.
"""

from __future__ import annotations

import numpy as np

from matdeeplearn_torch.data.structures import Structure, mic_distance_matrix


def ordinal_rank_rows(matrix: np.ndarray, invalid: np.ndarray) -> np.ndarray:
    """Per-row ordinal ranking (1-based) with `invalid` entries ranked last.

    Matches scipy.stats.rankdata(np.ma.array(m, mask=invalid), method="ordinal",
    axis=1) as used by the reference's threshold_sort (process.py:544-546):
    ties broken by column index, masked entries pushed after all valid ones.
    """
    key = np.where(invalid, np.inf, matrix)
    order = np.argsort(key, axis=1, kind="stable")
    ranks = np.empty_like(order)
    cols = np.arange(1, matrix.shape[1] + 1)
    np.put_along_axis(ranks, order, np.broadcast_to(cols, order.shape), axis=1)
    return ranks


def threshold_sort(matrix: np.ndarray, radius: float, max_neighbors: int) -> np.ndarray:
    """Keep, per row, the `max_neighbors + 1` nearest entries within `radius`.

    Returns the trimmed distance matrix with dropped entries zeroed
    (reference: process.py:540-560, adj=False path). The +1 accounts for the
    zero self-distance, which always ranks first and sits on the diagonal,
    so each atom keeps up to `max_neighbors` true neighbors.
    """
    invalid = matrix > radius
    ranks = ordinal_rank_rows(matrix, invalid)
    keep = (~invalid) & (ranks <= max_neighbors + 1)
    return np.where(keep, matrix, 0.0)


def dense_to_edges(trimmed: np.ndarray):
    """Row-major nonzero entries of a trimmed distance matrix.

    Equivalent to torch_geometric.utils.dense_to_sparse (process.py:295-297):
    edge (i → j) for every nonzero [i, j], ordered by (i, j). The zero
    diagonal (self distance) is naturally excluded here.
    """
    src, dst = np.nonzero(trimmed)
    return src.astype(np.int32), dst.astype(np.int32), trimmed[src, dst]


def add_self_loops(src, dst, dist, num_nodes: int):
    """Append (i, i) edges with weight 0 for every node (process.py:301-302)."""
    loops = np.arange(num_nodes, dtype=np.int32)
    return (
        np.concatenate([src, loops]),
        np.concatenate([dst, loops]),
        np.concatenate([dist, np.zeros(num_nodes, dist.dtype)]),
    )


def build_graph(structure: Structure, radius: float, max_neighbors: int):
    """Structure → (src, dst, dist) edge lists, reference-identical."""
    dm = mic_distance_matrix(structure)
    trimmed = threshold_sort(dm, radius, max_neighbors)
    src, dst, dist = dense_to_edges(trimmed)
    return add_self_loops(src, dst, dist, len(structure))


def one_hot_degree(src: np.ndarray, num_nodes: int, max_degree: int) -> np.ndarray:
    """One-hot out-degree feature, `max_degree + 1` classes.

    The reference calls OneHotDegree(data, graph_max_neighbors + 1)
    (process.py:385-388), i.e. classes = max_neighbors + 2, and counts degree
    on edge_index[0] (out-degree, self-loop included) (process.py:595-596).
    """
    deg = np.bincount(src, minlength=num_nodes).astype(np.int64)
    if deg.max(initial=0) > max_degree:
        raise ValueError(
            f"node degree {deg.max()} exceeds one-hot size {max_degree + 1}"
        )
    out = np.zeros((num_nodes, max_degree + 1), dtype=np.float32)
    out[np.arange(num_nodes), deg] = 1.0
    return out


def default_atom_dictionary() -> dict[int, np.ndarray]:
    """The reference's dictionary_default.json: Z ∈ 1..100 → 100-dim one-hot
    (row Z-1). Generated rather than shipped as a data file."""
    eye = np.eye(100, dtype=np.float32)
    return {z: eye[z - 1] for z in range(1, 101)}


def blank_atom_dictionary() -> dict[int, np.ndarray]:
    """The reference's dictionary_blank.json: Z ∈ 1..100 → 100-dim zeros."""
    zeros = np.zeros(100, dtype=np.float32)
    return {z: zeros for z in range(1, 101)}


def load_atom_dictionary(path: str) -> dict[int, np.ndarray]:
    """Load a user-provided atom dictionary JSON {"Z": [floats...]}
    (reference "provided" source, process.py:222-231)."""
    import json

    with open(path) as f:
        raw = json.load(f)
    return {int(k): np.asarray(v, dtype=np.float32) for k, v in raw.items()}


def generated_atom_dictionary(species: list[int]) -> dict[int, np.ndarray]:
    """One-hot over the species present in the dataset (reference "generated"
    source via sklearn LabelBinarizer, process.py:373-382). Species sorted
    ascending by atomic number; a single species yields a 1-dim feature,
    matching LabelBinarizer's binary-case behavior."""
    species = sorted(set(int(s) for s in species))
    k = len(species)
    if k == 1:
        return {species[0]: np.zeros(1, dtype=np.float32)}
    if k == 2:
        # LabelBinarizer emits a single binary column for 2 classes.
        return {
            species[0]: np.zeros(1, dtype=np.float32),
            species[1]: np.ones(1, dtype=np.float32),
        }
    eye = np.eye(k, dtype=np.float32)
    return {z: eye[i] for i, z in enumerate(species)}


def node_features(
    numbers: np.ndarray, atom_dictionary: dict[int, np.ndarray]
) -> np.ndarray:
    """Per-atom feature lookup (process.py:363-372)."""
    return np.stack([atom_dictionary[int(z)] for z in numbers]).astype(np.float32)


def normalize_edges(dists: list[np.ndarray]):
    """Dataset-wide min-max normalization of edge distances.

    Reference NormalizeEdge/GetRanges (process.py:626-653): min/max over all
    edges of all structures (self-loop zeros included, so min is 0 in
    practice). Returns (normalized list, min, max).
    """
    mins = [d.min() for d in dists if len(d)]
    maxs = [d.max() for d in dists if len(d)]
    lo, hi = float(min(mins)), float(max(maxs))
    scale = hi - lo
    return [(d - lo) / scale for d in dists], lo, hi


def gaussian_basis(
    dist: np.ndarray, start: float = 0.0, stop: float = 1.0,
    resolution: int = 50, width: float = 0.2,
) -> np.ndarray:
    """Gaussian smearing of scalar distances to `resolution` channels.

    Matches the reference GaussianSmearing (process.py:580-590):
    coeff = -0.5 / ((stop - start) * width)^2, offsets = linspace(start, stop).
    Numpy reference implementation — the on-device twin lives in
    ops/edge_basis.py and is tested against this.
    """
    offsets = np.linspace(start, stop, resolution)
    coeff = -0.5 / ((stop - start) * width) ** 2
    diff = dist[:, None] - offsets[None, :]
    return np.exp(coeff * diff * diff).astype(np.float32)
