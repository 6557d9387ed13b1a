"""Disk-streaming datasets: npz shards served through an LRU shard cache.

The port of the reference package's data/streaming.py, the counterpart of
the reference's StructureDataset_large (process/process.py:157-189,
`dataset_type: "large"`): a corpus too large for device memory is cut into
npz shards of `graphs_per_shard` graphs, and only its graph-level arrays
(targets, counts, ids) stay resident. The on-disk layout is the reference
package's byte for byte (`shards_meta.json`, `shards_meta.npz` and
`shard_{i}.npz` with the same keys), so either package reads a shard
directory the other wrote.

Batches are assembled on the host with the semantics of the device
assembler (data/batching.py:assemble_batch: -1 ids are pad slots, pad
nodes in the dummy segment B, pad edges at node 0 with mask 0), into
caller-owned CPU buffers (`batch_buffers`: pinned on a CUDA run, one set a
slot of training/stream.py's prefetch ring), never onto the device:

  * `fill` writes a full batch (f32 features, i32 edge indices, the masks);
  * `fill_wire` writes the compact wire batch (`WireBatch`): x,
    edge_weight and edge_dist_norm in f16, edge indices in 16 bits where
    the spec's node count fits, no masks or node→graph map (pads are
    suffix slots, so `expand_wire` derives them on the device from n_node
    and e_total). The reference's `assemble_wire`; it ships about half
    the bytes.

The 16-bit indices are the reference's uint16 values. torch's uint16 is a
storage dtype with few kernels, so the buffers hold those bytes as int16
and `expand_wire` widens them with `& 0xFFFF`, which is exact.
`assemble` and `assemble_wire` are fill and fill_wire into fresh buffers.

descriptor rows (`extra`) are zero on pad graph slots, as the device
assembler gives them.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from matdeeplearn_torch.data.batching import BatchSpec, GraphBatch, _slot_to_graph

META_JSON = "shards_meta.json"
META_NPZ = "shards_meta.npz"
U16_MAX = int(np.iinfo(np.uint16).max)


@dataclass
class WireBatch:
    """The compact host-to-device payload of one streamed batch
    (fill_wire); expand_wire rebuilds the full GraphBatch on the device."""

    x: torch.Tensor             # (N, F) f16
    edge_src: torch.Tensor      # (E,) int16 (uint16 bytes) | int32, 0 on pads
    edge_dst: torch.Tensor      # (E,) int16 (uint16 bytes) | int32
    edge_weight: torch.Tensor   # (E,) f16
    edge_dist_norm: torch.Tensor  # (E,) f16
    n_node: torch.Tensor        # (B,) int32 true node counts (0: pad slot)
    e_total: torch.Tensor       # (1,) int32 real edge count
    y: torch.Tensor             # (B, T) f32, zero on pad slots
    u: torch.Tensor             # (B, 3) f32
    extra: torch.Tensor | None = None  # (B, D) f32, zero on pad slots


def _widen(idx: torch.Tensor) -> torch.Tensor:
    """Wire edge indices as int32: 16-bit ones are uint16 bytes."""
    if idx.dtype == torch.int16:
        return idx.to(torch.int32) & U16_MAX
    return idx.to(torch.int32)


def expand_wire(w: WireBatch) -> GraphBatch:
    """WireBatch → GraphBatch on the wire's device, in plain torch (inside a
    captured step on a card: no host sync). Pads are suffix slots in every
    dimension, so the masks and the node→graph map are functions of n_node
    and e_total, which is how the device assembler derives them."""
    b, n, e = w.n_node.shape[0], w.x.shape[0], w.edge_src.shape[0]
    dev = w.x.device
    n_node = w.n_node.to(torch.int64)
    ncum = torch.cumsum(n_node, 0)
    node_valid = torch.arange(n, device=dev) < ncum[-1]
    node_graph = torch.where(node_valid, _slot_to_graph(ncum, n), b)
    edge_valid = torch.arange(e, device=dev) < w.e_total[0]
    return GraphBatch(
        x=torch.where(node_valid[:, None], w.x.float(), 0.0),
        edge_src=_widen(w.edge_src),
        edge_dst=_widen(w.edge_dst),
        edge_weight=torch.where(edge_valid, w.edge_weight.float(), 0.0),
        edge_dist_norm=torch.where(edge_valid, w.edge_dist_norm.float(), 0.0),
        node_graph=node_graph,
        node_mask=node_valid.to(torch.float32),
        edge_mask=edge_valid.to(torch.float32),
        graph_mask=(n_node > 0).to(torch.float32),
        y=w.y,
        u=w.u,
        n_node=n_node,
        extra=w.extra,
    )


def save_sharded(ds, path: str, graphs_per_shard: int = 2048) -> None:
    """Write a GraphDataset as npz shards and their metadata under `path`
    (the reference package's layout)."""
    os.makedirs(path, exist_ok=True)
    g = ds.num_graphs
    gps = int(graphs_per_shard)
    n_shards = max(1, -(-g // gps))
    node_ptr = np.asarray(ds.node_ptr, np.int64)
    edge_ptr = np.asarray(ds.edge_ptr, np.int64)
    for si in range(n_shards):
        g0, g1 = si * gps, min((si + 1) * gps, g)
        n0, n1 = node_ptr[g0], node_ptr[g1]
        e0, e1 = edge_ptr[g0], edge_ptr[g1]
        np.savez_compressed(
            os.path.join(path, f"shard_{si}.npz"),
            node_x=ds.node_x[n0:n1],
            node_z=ds.node_z[n0:n1],
            edge_src=ds.edge_src[e0:e1],
            edge_dst=ds.edge_dst[e0:e1],
            edge_weight=ds.edge_weight[e0:e1],
            edge_dist_norm=ds.edge_dist_norm[e0:e1],
            node_ptr=(node_ptr[g0:g1 + 1] - n0),
            edge_ptr=(edge_ptr[g0:g1 + 1] - e0),
        )
    arrays = {
        "y": np.asarray(ds.y, np.float32),
        "u": np.asarray(ds.u, np.float32),
        "node_counts": np.asarray(ds.node_counts(), np.int64),
        "edge_counts": np.asarray(ds.edge_counts(), np.int64),
    }
    for k, v in ds.extra_features.items():
        arrays[f"extra_{k}"] = np.asarray(v, np.float32)
    np.savez_compressed(os.path.join(path, META_NPZ), **arrays)
    meta = {
        "num_graphs": int(g),
        "graphs_per_shard": gps,
        "num_shards": int(n_shards),
        "num_features": int(ds.node_x.shape[1]),
        "edge_resolution": int(ds.edge_resolution),
        "edge_width": float(ds.edge_width),
        "structure_ids": list(ds.structure_ids),
        "species": list(getattr(ds, "species", [])),
    }
    with open(os.path.join(path, META_JSON), "w") as f:
        json.dump(meta, f)


def load_or_create_sharded(ds, shard_dir: str, target_index: int = 0,
                           graphs_per_shard: int = 2048):
    """Serve `ds` through the streaming interface, writing the shard
    directory on first use (data/dataset.py:get_dataset)."""
    if not os.path.exists(os.path.join(shard_dir, META_JSON)):
        save_sharded(ds, shard_dir, graphs_per_shard)
    return StreamingGraphDataset(shard_dir, target_index)


def batch_buffers(spec: BatchSpec, num_features: int, num_targets: int,
                  wire: bool, extra_dim: int | None = None,
                  pin: bool = False) -> dict:
    """One set of CPU tensors that fill (wire False) or fill_wire (True)
    writes a batch of `spec` into, by name; page-locked with `pin` (the
    prefetch ring's sets on a card). The wire's edge indices are 16 bits
    when the spec's node count fits in uint16, as the reference picks."""
    b, n, e = spec.num_graphs, spec.num_nodes, spec.num_edges
    f16, f32, i32 = torch.float16, torch.float32, torch.int32
    if wire:
        idx = torch.int16 if n <= U16_MAX else i32
        shapes = {"x": ((n, num_features), f16), "edge_src": ((e,), idx),
                  "edge_dst": ((e,), idx), "edge_weight": ((e,), f16),
                  "edge_dist_norm": ((e,), f16), "n_node": ((b,), i32),
                  "e_total": ((1,), i32)}
    else:
        shapes = {"x": ((n, num_features), f32), "edge_src": ((e,), i32),
                  "edge_dst": ((e,), i32), "edge_weight": ((e,), f32),
                  "edge_dist_norm": ((e,), f32),
                  "node_graph": ((n,), torch.int64), "node_mask": ((n,), f32),
                  "edge_mask": ((e,), f32), "graph_mask": ((b,), f32),
                  "n_node": ((b,), torch.int64)}
    shapes.update(y=((b, num_targets), f32), u=((b, 3), f32))
    if extra_dim is not None:
        shapes["extra"] = ((b, extra_dim), f32)
    return {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
            for k, (shape, dt) in shapes.items()}


def _starts(counts: np.ndarray) -> np.ndarray:
    """Exclusive prefix sums: where each of `counts`' runs starts."""
    return np.cumsum(counts) - counts


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The concatenated aranges [s, s + c) of each (start, count)."""
    return (np.repeat(starts - _starts(counts), counts)
            + np.arange(int(counts.sum())))


def _view(t: torch.Tensor) -> np.ndarray:
    """The numpy view of a CPU buffer; int16 wire indices as uint16."""
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


class StreamingGraphDataset:
    """Shard-backed dataset with the GraphDataset metadata surface.

    Only graph-level arrays are resident; node and edge arrays are read a
    shard at a time through a bounded LRU of `cache_shards` shards. The
    LRU is not locked: one reader at a time (training/stream.py's prefetch
    worker, or the caller while no worker runs)."""

    def __init__(self, path: str, target_index: int = 0, cache_shards: int = 8):
        self.path = path
        self.target_index = int(target_index)
        self.cache_shards = max(1, int(cache_shards))
        with open(os.path.join(path, META_JSON)) as f:
            meta = json.load(f)
        self._meta = meta
        self.graphs_per_shard = int(meta["graphs_per_shard"])
        self.num_features = int(meta["num_features"])
        self.edge_resolution = int(meta["edge_resolution"])
        self.edge_width = float(meta["edge_width"])
        self.structure_ids = list(meta["structure_ids"])
        self.species = list(meta.get("species", []))
        z = np.load(os.path.join(path, META_NPZ))
        self.y = z["y"]
        self.u = z["u"]
        self._node_counts = z["node_counts"]
        self._edge_counts = z["edge_counts"]
        self.extra_features = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        self._lru: OrderedDict[int, dict] = OrderedDict()

    # --------------------------------------------------- metadata surface

    def __len__(self) -> int:
        return int(self._meta["num_graphs"])

    @property
    def num_graphs(self) -> int:
        return len(self)

    @property
    def num_edge_features(self) -> int:
        return self.edge_resolution

    @property
    def output_dim(self) -> int:
        return self.y.shape[1] if self.target_index == -1 else 1

    @property
    def targets(self) -> np.ndarray:
        if self.target_index == -1:
            return self.y
        return self.y[:, self.target_index]

    def node_counts(self) -> np.ndarray:
        return self._node_counts

    def edge_counts(self) -> np.ndarray:
        return self._edge_counts

    def with_target_index(self, index: int) -> "StreamingGraphDataset":
        return StreamingGraphDataset(self.path, index, self.cache_shards)

    def shard_local_order(self, indices, seed) -> np.ndarray:
        """The epoch shuffle: the shards in a random order, then a uniform
        shuffle within each window of `cache_shards` of them. A global
        shuffle would touch every shard in every batch and decompress
        about every shard a batch through the LRU (the reference package
        measured an epoch of its 46k corpus go from minutes to hours);
        windows keep each batch within the LRU's capacity."""
        rng = np.random.default_rng(seed)
        indices = np.asarray(indices)
        shard_of = indices // self.graphs_per_shard
        shard_ids = np.unique(shard_of)
        rng.shuffle(shard_ids)
        window = max(1, self.cache_shards)
        out = []
        for w0 in range(0, len(shard_ids), window):
            win = shard_ids[w0:w0 + window]
            chunk = indices[np.isin(shard_of, win)].copy()
            rng.shuffle(chunk)
            out.append(chunk)
        return np.concatenate(out) if out else indices

    # ------------------------------------------------------ shard access

    def _shard(self, si: int) -> dict:
        if si in self._lru:
            self._lru.move_to_end(si)
            return self._lru[si]
        with np.load(os.path.join(self.path, f"shard_{si}.npz")) as z:
            shard = {k: z[k] for k in z.files}
        self._lru[si] = shard
        while len(self._lru) > self.cache_shards:
            self._lru.popitem(last=False)
        return shard

    def graph_arrays(self, gid: int):
        """(node_x, node_z, edge_src, edge_dst, edge_weight, edge_dist_norm)
        of one graph, its edge indices graph-local."""
        si, local = divmod(int(gid), self.graphs_per_shard)
        sh = self._shard(si)
        n0, n1 = sh["node_ptr"][local], sh["node_ptr"][local + 1]
        e0, e1 = sh["edge_ptr"][local], sh["edge_ptr"][local + 1]
        return (sh["node_x"][n0:n1], sh["node_z"][n0:n1],
                sh["edge_src"][e0:e1], sh["edge_dst"][e0:e1],
                sh["edge_weight"][e0:e1], sh["edge_dist_norm"][e0:e1])

    # -------------------------------------------------------- assembly

    def buffers(self, spec: BatchSpec, wire: bool, pin: bool = False) -> dict:
        """batch_buffers for this dataset's widths."""
        extra = (next(iter(self.extra_features.values())).shape[1]
                 if len(self.extra_features) == 1 else None)
        return batch_buffers(spec, self.num_features, self.output_dim, wire,
                             extra, pin)

    def _fill(self, ids, x, esrc, edst, ew, ed, ncounts, node_graph=None):
        """The fill of fill and fill_wire (the latter without node_graph):
        the batch's graphs in slot order, -1 slots skipped, node and edge
        rows packed from slot 0. It reads each shard the batch touches
        once, in the order of its last graph in the batch (the LRU then
        holds the recency of the reference's graph-by-graph loop), and
        moves every array of a shard with one gather. Returns (total
        nodes, total edges)."""
        slots = np.flatnonzero(ids >= 0)
        gids = ids[slots]
        nc, ec = self._node_counts[gids], self._edge_counts[gids]
        noff, eoff = _starts(nc), _starts(ec)
        ncounts[slots] = nc
        shard, local = np.divmod(gids, self.graphs_per_shard)
        last = {si: j for j, si in enumerate(shard)}
        for si in sorted(last, key=last.get):
            sel = np.flatnonzero(shard == si)
            sh = self._shard(int(si))
            n_src = _ranges(sh["node_ptr"][local[sel]], nc[sel])
            n_dst = _ranges(noff[sel], nc[sel])
            e_src = _ranges(sh["edge_ptr"][local[sel]], ec[sel])
            e_dst = _ranges(eoff[sel], ec[sel])
            shift = np.repeat(noff[sel], ec[sel])
            x[n_dst] = sh["node_x"][n_src]
            esrc[e_dst] = (sh["edge_src"][e_src] + shift).astype(esrc.dtype)
            edst[e_dst] = (sh["edge_dst"][e_src] + shift).astype(edst.dtype)
            ew[e_dst] = sh["edge_weight"][e_src]
            ed[e_dst] = sh["edge_dist_norm"][e_src]
            if node_graph is not None:
                node_graph[n_dst] = np.repeat(slots[sel], nc[sel])
        n_total, e_total = int(nc.sum()), int(ec.sum())
        # the buffers are reused: clear what the last batch left past ours
        x[n_total:] = 0
        for a in (esrc, edst, ew, ed):
            a[e_total:] = 0
        return n_total, e_total

    def _graph_rows(self, ids, gmask, out: dict):
        """y (masked), u and the descriptor rows of the batch, into out."""
        ids_safe = np.where(gmask, ids, 0)
        y2d = self.targets
        if y2d.ndim == 1:
            y2d = y2d[:, None]
        _view(out["y"])[:] = y2d[ids_safe] * gmask[:, None].astype(y2d.dtype)
        _view(out["u"])[:] = self.u[ids_safe]
        if "extra" in out:
            extra = next(iter(self.extra_features.values()))
            _view(out["extra"])[:] = np.where(gmask[:, None], extra[ids_safe],
                                              0.0)

    def fill(self, graph_ids, spec: BatchSpec, out: dict) -> dict:
        """The full batch of `graph_ids` into the buffers `out`
        (buffers(spec, wire=False)); returns out."""
        b = spec.num_graphs
        ids = np.asarray(graph_ids, np.int64)
        gmask = ids >= 0
        v = {k: _view(t) for k, t in out.items()}
        v["n_node"][:] = 0
        v["node_graph"][:] = b
        noff, eoff = self._fill(ids, v["x"], v["edge_src"], v["edge_dst"],
                                v["edge_weight"], v["edge_dist_norm"],
                                v["n_node"], node_graph=v["node_graph"])
        v["node_mask"][:] = np.arange(len(v["node_mask"])) < noff
        v["edge_mask"][:] = np.arange(len(v["edge_mask"])) < eoff
        v["graph_mask"][:] = gmask
        self._graph_rows(ids, gmask, out)
        return out

    def fill_wire(self, graph_ids, spec: BatchSpec, out: dict) -> dict:
        """The wire batch of `graph_ids` into the buffers `out`
        (buffers(spec, wire=True)); returns out."""
        ids = np.asarray(graph_ids, np.int64)
        gmask = ids >= 0
        v = {k: _view(t) for k, t in out.items()}
        v["n_node"][:] = 0
        _, eoff = self._fill(ids, v["x"], v["edge_src"], v["edge_dst"],
                             v["edge_weight"], v["edge_dist_norm"],
                             v["n_node"])
        v["e_total"][0] = eoff
        self._graph_rows(ids, gmask, out)
        return out

    def assemble(self, graph_ids, spec: BatchSpec) -> GraphBatch:
        """The full batch of `graph_ids` as CPU tensors, equal to
        batching.assemble_batch's over the same ids."""
        return GraphBatch(**self.fill(graph_ids, spec,
                                      self.buffers(spec, wire=False)))

    def assemble_wire(self, graph_ids, spec: BatchSpec) -> WireBatch:
        """The wire batch of `graph_ids` as CPU tensors."""
        return WireBatch(**self.fill_wire(graph_ids, spec,
                                          self.buffers(spec, wire=True)))
