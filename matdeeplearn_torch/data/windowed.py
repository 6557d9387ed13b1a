"""Per-graph windowed edge layout for the windowed aggregation kernels.

The windowed kernels (ops/windowed.py, csrc/windowed.cu) consume edges
bucketed into aligned destination-node *windows* of `tw` rows, each
window's edges padded to a multiple of the edge-tile size `te`, pad slots
carrying dst = -1. This module builds that layout per graph on the host,
once, so the batch assembler (data/batching.py:assemble_batch_windowed)
concatenates per-graph segments with gathers alone: every graph's node span
is padded to a multiple of `tw` and its edge span to a multiple of `te`, so
window and tile boundaries never straddle graphs, and graph-local window
ids become batch-global ones by an additive offset.

Layout invariants (tests/test_torch_windowed.py):
  * every real edge of graph g appears exactly once in its windowed span,
  * wdst[slot] equals the dst of the original edge worder[slot] points at,
  * each `te`-sized tile only holds edges of a single window
    (wdst // tw constant over the tile's real slots),
  * every window of the graph owns at least one tile.

A numpy copy of the reference package's data/windowed.py: the arrays are
equal, and the on-disk cache (data/dataset.py:windowed_layout) is shared.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class WindowedLayout:
    """Concatenated per-graph windowed edge layout (host arrays)."""

    tw: int                    # nodes per window
    te: int                    # edges per tile
    worder: np.ndarray         # (EW_tot,) int32 graph-local edge index (0 on pads)
    wvalid: np.ndarray         # (EW_tot,) float32 1 on real edge slots
    wdst: np.ndarray           # (EW_tot,) int32 graph-local dst, -1 on pads
    # per-edge data permuted into windowed order, so that batch assembly
    # gathers each through one hop (slot) rather than slot -> worder -> edge
    wsrc: np.ndarray           # (EW_tot,) int32 graph-local src, 0 on pads
    wweight: np.ndarray        # (EW_tot,) float32 edge weight, 0 on pads
    wdist: np.ndarray          # (EW_tot,) float32 normalized dist, 0 on pads
    wedge_ptr: np.ndarray      # (G+1,) int64 windowed-edge offsets per graph
    tile_window: np.ndarray    # (T_tot,) int32 graph-local window id per tile
    tile_first: np.ndarray     # (T_tot,) int32 1 = first tile of its window
    tile_ptr: np.ndarray       # (G+1,) int64 tile offsets per graph
    node_counts_w: np.ndarray  # (G,) int64 window-padded node counts
    in_degree: np.ndarray      # (N_tot,) float32 true in-degree per node

    @property
    def wedge_counts(self) -> np.ndarray:
        return np.diff(self.wedge_ptr)

    @property
    def tile_counts(self) -> np.ndarray:
        return np.diff(self.tile_ptr)


def build_windowed_layout(ds, tw: int, te: int) -> WindowedLayout:
    """Build the windowed layout for every graph of a GraphDataset (CSR
    arrays, graph-local edge indices)."""
    num_graphs = ds.num_graphs
    node_ptr = np.asarray(ds.node_ptr, np.int64)
    edge_ptr = np.asarray(ds.edge_ptr, np.int64)
    edge_dst = np.asarray(ds.edge_dst, np.int64)
    edge_src = np.asarray(ds.edge_src, np.int64)
    edge_w = np.asarray(ds.edge_weight, np.float32)
    edge_d = np.asarray(ds.edge_dist_norm, np.float32)

    parts = {k: [] for k in ("worder", "wvalid", "wdst", "wsrc", "wweight",
                             "wdist", "tile_window", "tile_first")}
    wedge_counts = np.zeros(num_graphs, np.int64)
    tile_counts = np.zeros(num_graphs, np.int64)
    node_counts_w = np.zeros(num_graphs, np.int64)
    in_degree = np.zeros(node_ptr[-1], np.float32)

    for g in range(num_graphs):
        n0, n1 = node_ptr[g], node_ptr[g + 1]
        e0, e1 = edge_ptr[g], edge_ptr[g + 1]
        n = int(n1 - n0)
        dst = edge_dst[e0:e1]
        in_degree[n0:n1] = np.bincount(dst, minlength=n)

        nw = max(1, -(-n // tw))
        node_counts_w[g] = nw * tw

        order = np.argsort(dst, kind="stable").astype(np.int32)
        w_of = (dst[order] // tw).astype(np.int64)
        counts = np.bincount(w_of, minlength=nw)
        # Tile-align each window's span; an empty window still gets one tile,
        # so that every window has a first tile.
        padded = np.maximum(((counts + te - 1) // te) * te, te)
        total = int(padded.sum())

        wd = np.full(total, -1, np.int32)
        wo = np.zeros(total, np.int32)
        wv = np.zeros(total, np.float32)
        ws = np.zeros(total, np.int32)
        ww = np.zeros(total, np.float32)
        wdist_g = np.zeros(total, np.float32)
        pad_off = np.concatenate([[0], np.cumsum(padded)[:-1]])
        real_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = pad_off[w_of] + (np.arange(len(order)) - real_off[w_of])
        wd[pos] = dst[order]
        wo[pos] = order
        wv[pos] = 1.0
        ws[pos] = edge_src[e0:e1][order]
        ww[pos] = edge_w[e0:e1][order]
        wdist_g[pos] = edge_d[e0:e1][order]

        tiles = padded // te
        t_total = int(tiles.sum())
        t_first = np.zeros(t_total, np.int32)
        t_first[np.concatenate([[0], np.cumsum(tiles)[:-1]])] = 1

        for key, arr in (("worder", wo), ("wvalid", wv), ("wdst", wd),
                         ("wsrc", ws), ("wweight", ww), ("wdist", wdist_g),
                         ("tile_window",
                          np.repeat(np.arange(nw, dtype=np.int32), tiles)),
                         ("tile_first", t_first)):
            parts[key].append(arr)
        wedge_counts[g] = total
        tile_counts[g] = t_total

    dtypes = {"wvalid": np.float32, "wweight": np.float32, "wdist": np.float32}
    arrays = {k: (np.concatenate(v) if v else np.zeros(0, dtypes.get(k, np.int32)))
              for k, v in parts.items()}
    return WindowedLayout(
        tw=tw, te=te, **arrays,
        wedge_ptr=np.concatenate([[0], np.cumsum(wedge_counts)]).astype(np.int64),
        tile_ptr=np.concatenate([[0], np.cumsum(tile_counts)]).astype(np.int64),
        node_counts_w=node_counts_w,
        in_degree=in_degree,
    )
