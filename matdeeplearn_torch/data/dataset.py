"""Processed graph dataset: flat CSR arrays + the .npz cache.

The same structure-of-arrays layout and on-disk cache as the reference
package's data/dataset.py (the cache format and CACHE_VERSION are shared, so
either package can read a cache the other wrote):

  node arrays  (N_total, ...)   concatenated over graphs
  edge arrays  (E_total, ...)   concatenated over graphs, graph-local indices
  graph arrays (G, ...)
  ptr arrays   (G+1,)           CSR offsets into node/edge arrays

Graphs are built with the numpy featurizer (data/graphs.py:build_graph).
The train/val/test and CV splits cut one seeded torch.randperm, as the
reference does. Not yet ported: the C++ featurizer loader, the "large"
streaming dataset and the SOAP/SM descriptors (ROADMAP queue 1).
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from matdeeplearn_torch.data import graphs as G
from matdeeplearn_torch.data.structures import Structure, read_ase_db, read_structure

PROCESSED_DIR_DEFAULT = "processed_tpu"
CACHE_VERSION = 3


@dataclass
class GraphDataset:
    """Featurized dataset in CSR structure-of-arrays form."""

    node_x: np.ndarray        # (N, F) float32 node features
    node_z: np.ndarray        # (N,) int32 atomic numbers
    edge_src: np.ndarray      # (E,) int32 graph-local source index
    edge_dst: np.ndarray      # (E,) int32 graph-local destination index
    edge_weight: np.ndarray   # (E,) float32 raw distances
    edge_dist_norm: np.ndarray  # (E,) float32 min-max normalized distances
    node_ptr: np.ndarray      # (G+1,) int64 node offsets
    edge_ptr: np.ndarray      # (G+1,) int64 edge offsets
    y: np.ndarray             # (G, T) float32 targets
    u: np.ndarray             # (G, 3) float32 graph state vector (zeros)
    structure_ids: list[str]
    # Gaussian basis config for on-device edge_attr expansion.
    edge_resolution: int = 50
    edge_width: float = 0.2
    target_index: int = 0     # -1 = all columns (multi-output)
    extra_features: dict[str, np.ndarray] = field(default_factory=dict)
    species: list[int] = field(default_factory=list)
    cache_dir: str | None = None

    @property
    def num_graphs(self) -> int:
        return len(self.node_ptr) - 1

    def __len__(self) -> int:
        return self.num_graphs

    @property
    def num_features(self) -> int:
        return self.node_x.shape[1]

    @property
    def num_edge_features(self) -> int:
        return self.edge_resolution

    @property
    def output_dim(self) -> int:
        return self.y.shape[1] if self.target_index == -1 else 1

    @property
    def targets(self) -> np.ndarray:
        """Per-graph target after GetY column selection (process.py:695-703)."""
        if self.target_index == -1:
            return self.y
        return self.y[:, self.target_index]

    def node_counts(self) -> np.ndarray:
        return np.diff(self.node_ptr)

    def edge_counts(self) -> np.ndarray:
        return np.diff(self.edge_ptr)

    def with_target_index(self, index: int) -> "GraphDataset":
        return replace(self, target_index=index)

    # ------------------------------------------------------------------ cache

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        arrays = {
            k: getattr(self, k)
            for k in (
                "node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
                "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u",
            )
        }
        for k, v in self.extra_features.items():
            arrays[f"extra_{k}"] = v
        np.savez_compressed(os.path.join(path, "data.npz"), **arrays)
        meta = {
            "version": CACHE_VERSION,
            "structure_ids": self.structure_ids,
            "edge_resolution": self.edge_resolution,
            "edge_width": self.edge_width,
            "species": self.species,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        self.cache_dir = path

    @classmethod
    def load(cls, path: str, target_index: int = 0) -> "GraphDataset":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != CACHE_VERSION:
            raise ValueError("stale cache version")
        z = np.load(os.path.join(path, "data.npz"))
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        return cls(
            node_x=z["node_x"], node_z=z["node_z"],
            edge_src=z["edge_src"], edge_dst=z["edge_dst"],
            edge_weight=z["edge_weight"], edge_dist_norm=z["edge_dist_norm"],
            node_ptr=z["node_ptr"], edge_ptr=z["edge_ptr"],
            y=z["y"], u=z["u"],
            structure_ids=list(meta["structure_ids"]),
            edge_resolution=meta["edge_resolution"],
            edge_width=meta["edge_width"],
            target_index=target_index,
            extra_features=extra,
            species=list(meta.get("species", [])),
            cache_dir=path,
        )


DEFAULT_PROCESSING_ARGS = {
    "dataset_type": "inmemory",
    "target_path": "targets.csv",
    "dictionary_source": "default",
    "dictionary_path": "atom_dict.json",
    "data_format": "json",
    "verbose": "True",
    "graph_max_radius": 8.0,
    "graph_max_neighbors": 12,
    "edge_features": "True",
    "graph_edge_length": 50,
    "SM_descriptor": "False",
    "SOAP_descriptor": "False",
    "SOAP_rcut": 8.0,
    "SOAP_nmax": 6,
    "SOAP_lmax": 4,
    "SOAP_sigma": 0.3,
    "processed_path": PROCESSED_DIR_DEFAULT,
}


def process_data(data_path: str, processed_path: str, processing_args: dict) -> GraphDataset:
    """Full featurization pipeline (reference process_data, process.py:197-533)."""
    args = {**DEFAULT_PROCESSING_ARGS, **(processing_args or {})}
    if "True" in (str(args.get("SOAP_descriptor")), str(args.get("SM_descriptor"))):
        raise NotImplementedError(
            "SOAP/SM descriptors are not ported yet (ROADMAP queue 1, item 12)"
        )
    verbose = str(args.get("verbose", "True")) == "True"
    radius = float(args["graph_max_radius"])
    max_neighbors = int(args["graph_max_neighbors"])

    target_file = os.path.join(data_path, args["target_path"])
    if not os.path.exists(target_file):
        raise FileNotFoundError(f"targets not found in {target_file}")
    with open(target_file) as f:
        target_data = [row for row in csv.reader(f) if row]

    structures: list[Structure] = []
    if args["data_format"] == "db":
        db_structs = read_ase_db(os.path.join(data_path, "data.db"))
        for i, row in enumerate(target_data):
            s = db_structs[i]
            s.structure_id = row[0]
            structures.append(s)
    else:
        for row in target_data:
            sid = row[0]
            path = os.path.join(data_path, f"{sid}.{args['data_format']}")
            structures.append(read_structure(path, args["data_format"], sid))

    ys = np.array(
        [[float(v) for v in row[1:]] for row in target_data], dtype=np.float32
    )

    all_src, all_dst, all_dist = [], [], []
    for i, s in enumerate(structures):
        src, dst, dist = G.build_graph(s, radius, max_neighbors)
        all_src.append(src)
        all_dst.append(dst)
        all_dist.append(dist)
        if verbose and ((i + 1) % 500 == 0 or (i + 1) == len(structures)):
            print(f"Data processed: {i + 1} out of {len(structures)}")

    species = sorted({int(z) for s in structures for z in s.numbers})
    if verbose:
        n_max = max(len(s) for s in structures)
        print(f"Max structure size: {n_max} Max number of elements: {len(species)}")

    # Node features: atom dictionary ⊕ one-hot degree.
    source = args["dictionary_source"]
    if source == "default":
        atom_dict = G.default_atom_dictionary()
    elif source == "blank":
        atom_dict = G.blank_atom_dictionary()
    elif source == "generated":
        atom_dict = G.generated_atom_dictionary(species)
    else:  # provided
        atom_dict = G.load_atom_dictionary(
            os.path.join(data_path, args["dictionary_path"])
        )

    xs = []
    for s, src in zip(structures, all_src):
        base = G.node_features(s.numbers, atom_dict)
        deg = G.one_hot_degree(src, len(s), max_neighbors + 1)
        xs.append(np.concatenate([base, deg], axis=1))

    normed, _, _ = G.normalize_edges(all_dist)

    node_ptr = np.concatenate([[0], np.cumsum([len(s) for s in structures])]).astype(np.int64)
    edge_ptr = np.concatenate([[0], np.cumsum([len(e) for e in all_src])]).astype(np.int64)

    ds = GraphDataset(
        node_x=np.concatenate(xs).astype(np.float32),
        node_z=np.concatenate([s.numbers for s in structures]).astype(np.int32),
        edge_src=np.concatenate(all_src).astype(np.int32),
        edge_dst=np.concatenate(all_dst).astype(np.int32),
        edge_weight=np.concatenate(all_dist).astype(np.float32),
        edge_dist_norm=np.concatenate(normed).astype(np.float32),
        node_ptr=node_ptr,
        edge_ptr=edge_ptr,
        y=ys,
        u=np.zeros((len(structures), 3), dtype=np.float32),
        structure_ids=[s.structure_id for s in structures],
        edge_resolution=int(args["graph_edge_length"]),
        edge_width=0.2,
        species=species,
    )
    ds.save(os.path.join(data_path, processed_path))
    return ds


def get_dataset(
    data_path: str,
    target_index: int = 0,
    reprocess: str | bool = "False",
    processing_args: dict | None = None,
) -> GraphDataset:
    """Cached dataset fetch (reference get_dataset, process.py:87-129)."""
    args = {**DEFAULT_PROCESSING_ARGS, **(processing_args or {})}
    if str(args.get("dataset_type", "inmemory")).lower() == "large":
        raise NotImplementedError(
            "dataset_type 'large' (streaming) is not ported yet "
            "(ROADMAP queue 1, item 14)"
        )
    processed_path = args.get("processed_path", PROCESSED_DIR_DEFAULT)
    full = os.path.join(data_path, processed_path)
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"Data not found in: {data_path}")
    if str(reprocess) == "True" and os.path.exists(full):
        shutil.rmtree(full)
    ds = None
    if os.path.exists(os.path.join(full, "data.npz")):
        try:
            ds = GraphDataset.load(full, target_index)
        except (OSError, ValueError, KeyError):
            shutil.rmtree(full)
    if ds is None:
        ds = process_data(data_path, processed_path, args)
    return ds.with_target_index(target_index)


# ------------------------------------------------------------------ splitting


def _seeded_permutation(n: int, seed: int) -> np.ndarray:
    """torch.randperm with a manually seeded Generator, as the reference's
    random_split (process.py:46-50)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g).numpy()


def split_data(dataset, train_ratio: float, val_ratio: float,
               test_ratio: float, seed: int):
    """Seeded train/val/test split (reference split_data, process.py:27-63):
    sizes are int(n * ratio) each, the remainder unused; contiguous slices
    of one seeded permutation in train/val/test order."""
    n = len(dataset)
    if train_ratio + val_ratio + test_ratio > 1:
        raise ValueError("invalid ratios: their sum exceeds 1")
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    n_test = int(n * test_ratio)
    perm = _seeded_permutation(n, seed)
    train_idx = perm[:n_train]
    val_idx = perm[n_train:n_train + n_val]
    test_idx = perm[n_train + n_val:n_train + n_val + n_test]
    print(
        "train length:", n_train, "val length:", n_val,
        "test length:", n_test, "unused length:", n - n_train - n_val - n_test,
        "seed :", seed,
    )
    return train_idx, val_idx, test_idx


def split_data_CV(dataset, num_folds: int, seed: int):
    """Seeded equal-fold CV split (reference split_data_CV, process.py:69-79)."""
    n = len(dataset)
    fold_length = n // num_folds
    perm = _seeded_permutation(n, seed)
    print(
        "fold length :", fold_length,
        "unused length:", n - fold_length * num_folds, "seed", seed,
    )
    return [perm[i * fold_length:(i + 1) * fold_length] for i in range(num_folds)]
