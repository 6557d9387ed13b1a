"""Static-shape padded graph batches, assembled on the device.

The featurized dataset lives on the device once (`DeviceDataset`); every
batch has the fixed shape of a `BatchSpec`, and per batch the host hands
over only a (B,) vector of graph ids. `assemble_batch` gathers nodes and
edges and builds the masks with tensor ops on the dataset's device:

  * pad nodes belong to a dummy segment (id = num_graphs), node_mask 0,
  * pad edges point at node 0 with edge_mask 0 and are masked out of every
    aggregation,
  * pad graph slots (id -1) have graph_mask 0.

Under edge_order="dst" each graph's edges are sorted by (local dst, local
src) once on the host, so the assembled batch's edge_dst is non-decreasing
over real edges: the layout of the CSR kernels (ops/csr.py). Under
edge_order="src" (MEGNet's csr layout) they are sorted by (local src,
local dst), so edge_src is non-decreasing over real edges, and so is
node_graph[edge_src]. A dataset made with kernel_fused=True (dst order
only) marks its batches for the fused conv kernels (ops/fused_cgconv.py,
ops/fused_cfconv.py); one made with kernel_bf16=True (kernel_precision
bf16 under the fused or pallas plan) marks them for those kernels' and the
windowed kernels' single-pass arm, as the reference's assembler sets
GraphBatch.kernel_bf16.

A dataset that carries the windowed layout (`WindowedDeviceData`, built from
data/windowed.py) assembles windowed batches (`assemble_batch_windowed`):
nodes in window-padded slots, edges in the per-graph windowed order with
dst = -1 on pad slots, and per-tile window ids for the windowed kernels
(ops/windowed.py). `assemble` picks the assembler the dataset calls for.

A dataset with one whole-structure descriptor (SOAP or SM, its
extra_features entry) gives every batch its rows as `extra` (B, D), zero
on pad graph slots: the input of the descriptor models.

Packed batching (`batching: packed`, the bulk setting) keeps the same
assemblers and changes only the geometry and the ids: a spec of about
mean·B + max nodes and edges with 1.5·B + 1 graph slots
(`BatchSpec.packed_for_dataset`), and an id matrix of balanced bins
(`packed_id_matrix`, numpy on the host) instead of fixed runs of B ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BatchSpec:
    """Static batch geometry."""

    num_graphs: int  # B graph slots (trailing slots may be padding)
    num_nodes: int   # padded node slots
    num_edges: int   # padded edge slots

    @classmethod
    def for_dataset(cls, node_counts, edge_counts, batch_size: int, align: int = 8,
                    align_edges: int | None = None):
        """Tight upper bound over any batch of `batch_size` graphs: the sum of
        the `batch_size` largest node/edge counts, nodes aligned to `align`
        and edges to `align_edges` (default `align`)."""
        b = min(batch_size, len(node_counts))
        n = int(np.sort(np.asarray(node_counts))[-b:].sum())
        e = int(np.sort(np.asarray(edge_counts))[-b:].sum())
        return cls(
            batch_size,
            round_up(max(n, 1), align),
            round_up(max(e, 1), align_edges or align),
        )

    @classmethod
    def packed_for_dataset(cls, node_counts, edge_counts, batch_size: int,
                           align: int = 8, align_edges: int | None = None,
                           slack: float = 1.08):
        """Budget-packed spec for size-skewed datasets (`batching: packed`):
        node and edge capacity ceil(slack·mean·B + max) instead of the sum
        of the B largest graphs, enough for the balanced greedy bins of
        packed_id_matrix; ceil(1.5·B) + 1 graph slots, so bins of many
        small graphs fit. The composition of a batch varies; the
        sample-weighted loss keeps the epoch objective."""
        nc = np.asarray(node_counts)
        ec = np.asarray(edge_counts)
        b = min(batch_size, len(nc))
        n = int(np.ceil(slack * float(nc.mean()) * b + nc.max()))
        e = int(np.ceil(slack * float(ec.mean()) * b + ec.max()))
        return cls(
            int(np.ceil(1.5 * batch_size)) + 1,
            round_up(max(n, 1), align),
            round_up(max(e, 1), align_edges or align),
        )


def packed_steps(indices, node_counts, edge_counts, spec: BatchSpec,
                 nominal_batch: int) -> int:
    """Steps of one packed epoch over `indices`: enough bins that balanced
    greedy packing (a bin's load stays within the mean load plus the
    largest graph) fits the spec's node, edge and graph-slot capacities for
    any shuffle, and never fewer than the padded epoch's."""
    nc = np.asarray(node_counts)[np.asarray(indices)]
    ec = np.asarray(edge_counts)[np.asarray(indices)]
    if len(nc) == 0:
        return 1
    n_bound = int(np.ceil(nc.sum() / max(spec.num_nodes - nc.max(), 1)))
    e_bound = int(np.ceil(ec.sum() / max(spec.num_edges - ec.max(), 1)))
    g_bound = int(np.ceil(len(nc) / spec.num_graphs))
    nominal = int(np.ceil(len(nc) / max(nominal_batch, 1)))
    return max(1, nominal, n_bound, e_bound, g_bound)


def packed_id_matrix(indices, node_counts, edge_counts, spec: BatchSpec,
                     nominal_batch: int, shuffle: bool, seed) -> np.ndarray:
    """(S, spec.num_graphs) int32 id matrix of packed bins, -1 on empty
    slots.

    shuffle=True (training): the ids in the order of
    np.random.default_rng(seed).shuffle go one by one to the eligible bin
    (free slot, node and edge room) with the least node load, among a fixed
    S = packed_steps bins, so every epoch has the same number of steps.
    shuffle=False (eval): a sequential fill in `indices` order, opening a
    bin where the next graph does not fit (and appending rows past S where
    the fill trails the bound); outputs read back in `indices` order after
    the -1 slots are dropped."""
    indices = np.asarray(indices, np.int64)
    nc_all = np.asarray(node_counts)
    ec_all = np.asarray(edge_counts)
    b_cap, cap_n, cap_e = spec.num_graphs, spec.num_nodes, spec.num_edges
    if len(indices) == 0:
        return np.full((1, b_cap), -1, np.int32)
    order = indices.copy()
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    steps = packed_steps(indices, node_counts, edge_counts, spec, nominal_batch)

    out = np.full((steps, b_cap), -1, np.int32)
    if not shuffle:
        j, ln, le, cnt = 0, 0, 0, 0
        for gid in order:
            n_i, e_i = int(nc_all[gid]), int(ec_all[gid])
            if cnt == b_cap or ln + n_i > cap_n or le + e_i > cap_e:
                j, ln, le, cnt = j + 1, 0, 0, 0
                if j >= steps:
                    out = np.vstack([out, np.full((1, b_cap), -1, np.int32)])
                    steps += 1
            out[j, cnt] = gid
            ln, le, cnt = ln + n_i, le + e_i, cnt + 1
        return out

    loads_n = np.zeros(steps, np.int64)
    loads_e = np.zeros(steps, np.int64)
    counts = np.zeros(steps, np.int64)
    for gid in order:
        n_i, e_i = int(nc_all[gid]), int(ec_all[gid])
        ok = (counts < b_cap) & (loads_n + n_i <= cap_n) & (loads_e + e_i <= cap_e)
        if not ok.any():
            raise ValueError(f"packed batching overflow: no bin fits graph "
                             f"{gid} (n={n_i}, e={e_i}); spec {spec} is too "
                             "tight for this split")
        j = int(np.argmin(np.where(ok, loads_n, np.iinfo(np.int64).max)))
        out[j, counts[j]] = gid
        loads_n[j] += n_i
        loads_e[j] += e_i
        counts[j] += 1
    return out


def packed_id_matrix_sharded(indices, node_counts, edge_counts,
                             spec: BatchSpec, nominal_batch: int, dp: int,
                             shuffle: bool, seed) -> np.ndarray:
    """(S, dp·B) id matrix of packed bins for dp replicas, each replica's
    B slots of a row one valid bin (the reference package's
    packed_id_matrix_sharded, bit for bit): the ids (shuffled by
    np.random.default_rng(seed) when shuffle) split contiguously into dp
    pieces (np.array_split, the DistributedSampler's role), each packed by
    packed_id_matrix against the same per-replica spec with seed + 1 + r
    (None for eval), the step counts equalised with all-pad rows and the
    pieces concatenated along the slot axis. dp 1 is packed_id_matrix.
    The count-weighted loss of the dp step makes uneven replica counts,
    all-pad rows included, exact."""
    indices = np.asarray(indices, np.int64)
    if dp <= 1:
        return packed_id_matrix(indices, node_counts, edge_counts, spec,
                                nominal_batch, shuffle, seed)
    order = indices.copy()
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    mats = [packed_id_matrix(s, node_counts, edge_counts, spec, nominal_batch,
                             shuffle, None if seed is None else seed + 1 + r)
            for r, s in enumerate(np.array_split(order, dp))]
    steps = max(m.shape[0] for m in mats)
    mats = [np.vstack([m, np.full((steps - m.shape[0], spec.num_graphs), -1,
                                  np.int32)]) for m in mats]
    return np.concatenate(mats, axis=1)


@dataclass
class DeviceDataset:
    """Featurized dataset resident on one device."""

    node_x: torch.Tensor        # (N, F) float32
    node_ptr: torch.Tensor      # (G+1,) int64
    edge_ptr: torch.Tensor      # (G+1,) int64
    node_counts: torch.Tensor   # (G,) int64
    edge_counts: torch.Tensor   # (G,) int64
    y: torch.Tensor             # (G, T) float32, after target-index selection
    u: torch.Tensor             # (G, 3) float32
    edge_src: torch.Tensor      # (E,) int32 graph-local
    edge_dst: torch.Tensor      # (E,) int32 graph-local
    edge_weight: torch.Tensor   # (E,) float32 raw distance
    edge_dist_norm: torch.Tensor  # (E,) float32
    # "dst": each graph's edges sorted by (local dst, local src); "src": by
    # (local src, local dst); None keeps the reference edge order.
    edge_order: str | None = None
    # (N,) float32 per-node degree at the sorted side (in-degree under
    # "dst", out-degree under "src"): a dataset constant that batches take
    # through the node gather.
    node_indeg: torch.Tensor | None = None
    # batches run the conv on its fused kernel (needs edge_order "dst")
    kernel_fused: bool = False
    # batches run the fused and windowed kernels' single-pass arm
    # (kernel_precision bf16; the reference's GraphBatch.kernel_bf16)
    kernel_bf16: bool = False
    # the windowed layout: batches are assembled windowed
    windowed: "WindowedDeviceData | None" = None
    # (G, D) float32 whole-structure descriptors (SOAP or SM), the
    # dataset's single extra_features entry; None without one
    extra: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.node_x.device

    @property
    def dst_sorted(self) -> bool:
        return self.edge_order == "dst"

    @property
    def src_sorted(self) -> bool:
        return self.edge_order == "src"

    @classmethod
    def from_graph_dataset(cls, ds, device: str | torch.device,
                           edge_order: str | None = None,
                           kernel_fused: bool = False,
                           windowed: "WindowedDeviceData | None" = None,
                           kernel_bf16: bool = False) -> "DeviceDataset":
        if windowed is not None and edge_order is not None:
            raise ValueError("a windowed dataset keeps the reference edge "
                             "order (the layout sorts each graph's edges)")
        if kernel_fused and edge_order != "dst":
            raise ValueError("kernel_fused needs edge_order='dst' (the "
                             "in-degree comes with the sorted order)")
        if edge_order not in (None, "dst", "src"):
            raise ValueError(f"edge_order={edge_order!r}: expected None, "
                             "'dst' or 'src'")
        y = ds.targets
        if y.ndim == 1:
            y = y[:, None]
        extras = ds.extra_features
        extra = (torch.as_tensor(np.asarray(next(iter(extras.values())),
                                            np.float32), device=device)
                 if len(extras) == 1 else None)
        esrc = np.asarray(ds.edge_src, np.int32)
        edst = np.asarray(ds.edge_dst, np.int32)
        ew = np.asarray(ds.edge_weight, np.float32)
        ed = np.asarray(ds.edge_dist_norm, np.float32)
        node_indeg = None
        if edge_order is not None:
            # One host-side lexsort per run: within each graph order edges
            # by the sorted side's local id, then the other side's. Node ids
            # are graph-local, so the graph id is the major key.
            gid = np.repeat(
                np.arange(len(ds.node_ptr) - 1, dtype=np.int64),
                np.diff(ds.edge_ptr),
            )
            major, minor = ((edst, esrc) if edge_order == "dst"
                            else (esrc, edst))
            perm = np.lexsort((minor, major, gid))
            esrc, edst, ew, ed = esrc[perm], edst[perm], ew[perm], ed[perm]
            side = edst if edge_order == "dst" else esrc
            nptr = np.asarray(ds.node_ptr, np.int64)
            indeg = np.zeros(int(nptr[-1]), np.float32)
            np.add.at(indeg, side.astype(np.int64) + nptr[gid[perm]], 1.0)
            node_indeg = torch.as_tensor(indeg, device=device)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return cls(
            node_x=t(ds.node_x, torch.float32),
            node_ptr=t(ds.node_ptr, torch.int64),
            edge_ptr=t(ds.edge_ptr, torch.int64),
            node_counts=t(np.diff(ds.node_ptr), torch.int64),
            edge_counts=t(np.diff(ds.edge_ptr), torch.int64),
            y=t(y, torch.float32),
            u=t(ds.u, torch.float32),
            edge_src=t(esrc, torch.int32),
            edge_dst=t(edst, torch.int32),
            edge_weight=t(ew, torch.float32),
            edge_dist_norm=t(ed, torch.float32),
            edge_order=edge_order,
            node_indeg=node_indeg,
            kernel_fused=kernel_fused,
            kernel_bf16=kernel_bf16,
            windowed=windowed,
            extra=extra,
        )


@dataclass
class WindowedDeviceData:
    """The per-graph windowed layout (data/windowed.py:WindowedLayout) on
    the device, with its window and tile sizes."""

    tw: int                    # nodes per window
    te: int                    # edges per tile
    wvalid: torch.Tensor       # (EW_tot,) float32
    wdst: torch.Tensor         # (EW_tot,) int32 graph-local dst, -1 pads
    wsrc: torch.Tensor         # (EW_tot,) int32 graph-local src
    wweight: torch.Tensor      # (EW_tot,) float32 edge weight
    wdist: torch.Tensor        # (EW_tot,) float32 normalized distance
    wedge_ptr: torch.Tensor    # (G+1,) int64
    wedge_counts: torch.Tensor  # (G,) int64
    tile_window: torch.Tensor  # (T_tot,) int32 graph-local window ids
    tile_first: torch.Tensor   # (T_tot,) int32
    tile_ptr: torch.Tensor     # (G+1,) int64
    tile_counts: torch.Tensor  # (G,) int64
    node_counts_w: torch.Tensor  # (G,) int64 window-padded node counts
    in_degree: torch.Tensor    # (N_tot,) float32

    @classmethod
    def from_layout(cls, layout, device: str | torch.device
                    ) -> "WindowedDeviceData":
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        return cls(
            tw=int(layout.tw), te=int(layout.te),
            wvalid=t(layout.wvalid, f32), wdst=t(layout.wdst, i32),
            wsrc=t(layout.wsrc, i32), wweight=t(layout.wweight, f32),
            wdist=t(layout.wdist, f32), wedge_ptr=t(layout.wedge_ptr, i64),
            wedge_counts=t(layout.wedge_counts, i64),
            tile_window=t(layout.tile_window, i32),
            tile_first=t(layout.tile_first, i32),
            tile_ptr=t(layout.tile_ptr, i64),
            tile_counts=t(layout.tile_counts, i64),
            node_counts_w=t(layout.node_counts_w, i64),
            in_degree=t(layout.in_degree, f32),
        )


@dataclass
class GraphBatch:
    """A static-shape padded batch of graphs (pad conventions in the module
    docstring)."""

    x: torch.Tensor            # (N_pad, F)
    edge_src: torch.Tensor     # (E_pad,) int32 batch-global node index
    edge_dst: torch.Tensor     # (E_pad,) int32
    edge_weight: torch.Tensor  # (E_pad,)
    edge_dist_norm: torch.Tensor  # (E_pad,)
    node_graph: torch.Tensor   # (N_pad,) int64 segment id in [0, B]
    node_mask: torch.Tensor    # (N_pad,) float32
    edge_mask: torch.Tensor    # (E_pad,) float32
    graph_mask: torch.Tensor   # (B,) float32
    y: torch.Tensor            # (B, T)
    u: torch.Tensor            # (B, 3)
    n_node: torch.Tensor       # (B,) int64 true node counts
    # (N_pad,) float32 degree of each node at the sorted side (0 on pads):
    # the in-degree under edge_order "dst", the out-degree under "src"; the
    # in-degree on windowed batches (1.0 on pad node slots).
    in_degree: torch.Tensor | None = None
    edge_order: str | None = None
    kernel_fused: bool = False
    # the single-pass arm of the fused and windowed kernels (the dataset's)
    kernel_bf16: bool = False
    # MPNN's message on the bilinear kernel over the reference edge order
    # (a streamed batch of the fused plan, training/stream.py): the kernel
    # reads the mask alone, so it needs no sorted order
    kernel_bilinear: bool = False
    # Windowed batches (assemble_batch_windowed): edge_dst is -1 on pad
    # slots (edge_dst_safe clamps it for index ops), and edges are ordered
    # by (window, dst) in tiles of num_edges / len(tile_window) slots.
    tile_window: torch.Tensor | None = None  # (T,) int32 window id per tile
    tile_first: torch.Tensor | None = None   # (T,) int32 1 = first tile
    window_size: int = 0                     # tw
    # (B, D) whole-structure descriptors (SOAP or SM), zero rows on pad
    # graph slots; None when the dataset has none
    extra: torch.Tensor | None = None
    # an edge shard of the batch under ep (parallel/spmd.py:
    # slice_edge_shard): its parallel/ring.py EdgeShard, whose exchanges
    # ops/aggregate.py runs; None on a whole batch
    ep: object = None

    @property
    def dst_sorted(self) -> bool:
        return self.edge_order == "dst"

    @property
    def src_sorted(self) -> bool:
        return self.edge_order == "src"

    @property
    def is_windowed(self) -> bool:
        return self.tile_window is not None

    @property
    def edge_dst_safe(self) -> torch.Tensor:
        """edge_dst with the pad marker -1 clamped to node 0."""
        return torch.clamp(self.edge_dst, min=0)

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]


def _slot_to_graph(cum: torch.Tensor, num_slots: int) -> torch.Tensor:
    """g[s] = #{j : cum[j] <= s} for s in [0, num_slots): the graph slot
    that padded slot s belongs to (B for slots past the last graph)."""
    slots = torch.arange(num_slots, device=cum.device, dtype=cum.dtype)
    return torch.searchsorted(cum, slots, right=True)


def _batch_extra(data: DeviceDataset, ids, gmask):
    """The batch's descriptor rows, zero on pad graph slots."""
    if data.extra is None:
        return None
    return torch.where(gmask[:, None], data.extra[ids], 0.0)


def assemble_batch(data: DeviceDataset, graph_ids, spec: BatchSpec) -> GraphBatch:
    """Gather a padded batch from the device-resident dataset.

    graph_ids: (B,) dataset indices; -1 marks a pad slot. Every shape comes
    from `spec`, and nothing here waits for the device.
    """
    dev = data.device
    B, N, E = spec.num_graphs, spec.num_nodes, spec.num_edges
    graph_ids = torch.as_tensor(graph_ids, dtype=torch.int64, device=dev)
    gmask = graph_ids >= 0
    ids = torch.where(gmask, graph_ids, 0)

    ncounts = torch.where(gmask, data.node_counts[ids], 0)   # (B,)
    ecounts = torch.where(gmask, data.edge_counts[ids], 0)
    ncum = torch.cumsum(ncounts, 0)                           # inclusive
    ecum = torch.cumsum(ecounts, 0)
    node_off = ncum - ncounts                                 # exclusive

    # --- nodes -------------------------------------------------------------
    slot = torch.arange(N, device=dev)
    g_of_node = _slot_to_graph(ncum, N)  # [0, B]
    node_valid = slot < ncum[-1]
    g_safe = torch.clamp(g_of_node, max=B - 1)
    local = slot - node_off[g_safe]
    src_index = torch.where(node_valid, data.node_ptr[ids[g_safe]] + local, 0)
    x = torch.where(node_valid[:, None], data.node_x[src_index], 0.0)
    node_graph = torch.where(node_valid, g_of_node, B)

    # --- edges -------------------------------------------------------------
    eslot = torch.arange(E, device=dev)
    g_of_edge = _slot_to_graph(ecum, E)
    edge_valid = eslot < ecum[-1]
    eg_safe = torch.clamp(g_of_edge, max=B - 1)
    elocal = eslot - (ecum - ecounts)[eg_safe]
    e_index = torch.where(edge_valid, data.edge_ptr[ids[eg_safe]] + elocal, 0)
    offset = node_off[eg_safe]
    esrc = torch.where(edge_valid, data.edge_src[e_index] + offset, 0)
    edst = torch.where(edge_valid, data.edge_dst[e_index] + offset, 0)
    ew = torch.where(edge_valid, data.edge_weight[e_index], 0.0)
    ed = torch.where(edge_valid, data.edge_dist_norm[e_index], 0.0)

    in_degree = None
    if data.node_indeg is not None:
        in_degree = torch.where(node_valid, data.node_indeg[src_index], 0.0)

    return GraphBatch(
        x=x,
        edge_src=esrc.to(torch.int32),
        edge_dst=edst.to(torch.int32),
        edge_weight=ew,
        edge_dist_norm=ed,
        node_graph=node_graph,
        node_mask=node_valid.to(torch.float32),
        edge_mask=edge_valid.to(torch.float32),
        graph_mask=gmask.to(torch.float32),
        y=data.y[ids] * gmask[:, None].to(data.y.dtype),
        u=data.u[ids],
        n_node=ncounts,
        in_degree=in_degree,
        edge_order=data.edge_order,
        kernel_fused=data.kernel_fused,
        kernel_bf16=data.kernel_bf16,
        extra=_batch_extra(data, ids, gmask),
    )


def assemble_batch_windowed(data: DeviceDataset, wdata: WindowedDeviceData,
                            graph_ids, spec: BatchSpec) -> GraphBatch:
    """Windowed-batch assembly: as assemble_batch, but nodes occupy
    window-padded slots (graph g starts at a multiple of tw) and edges come
    in the per-graph windowed order, with dst = -1 on pad slots and the
    window id and first-tile flag of every tile. Trailing capacity tiles
    are parked on the last used window with tile_first 0; pad node slots
    get in_degree 1.0. Gathers only."""
    dev = data.device
    tw, te = wdata.tw, wdata.te
    B, N, E = spec.num_graphs, spec.num_nodes, spec.num_edges
    if N % tw or E % te:
        raise ValueError(f"spec {spec} is not aligned to tw={tw}, te={te}")
    T, NW = E // te, N // tw
    graph_ids = torch.as_tensor(graph_ids, dtype=torch.int64, device=dev)
    gmask = graph_ids >= 0
    ids = torch.where(gmask, graph_ids, 0)

    ncounts = torch.where(gmask, data.node_counts[ids], 0)        # real
    ncounts_w = torch.where(gmask, wdata.node_counts_w[ids], 0)   # padded
    ncum_w = torch.cumsum(ncounts_w, 0)
    node_off_w = ncum_w - ncounts_w
    n_total_w = ncum_w[-1]

    # --- nodes (window-padded slots) --------------------------------------
    slot = torch.arange(N, device=dev)
    g_of_node = _slot_to_graph(ncum_w, N)
    g_safe = torch.clamp(g_of_node, max=B - 1)
    local = slot - node_off_w[g_safe]
    node_valid = (slot < n_total_w) & (local < ncounts[g_safe])
    src_index = torch.where(node_valid, data.node_ptr[ids[g_safe]] + local, 0)
    x = torch.where(node_valid[:, None], data.node_x[src_index], 0.0)
    node_graph = torch.where(node_valid, g_of_node, B)
    in_degree = torch.where(node_valid, wdata.in_degree[src_index], 1.0)

    # --- edges (windowed order) -------------------------------------------
    ecounts = torch.where(gmask, wdata.wedge_counts[ids], 0)
    ecum = torch.cumsum(ecounts, 0)
    edge_off = ecum - ecounts
    eslot = torch.arange(E, device=dev)
    g_of_edge = _slot_to_graph(ecum, E)
    e_in_range = eslot < ecum[-1]
    eg_safe = torch.clamp(g_of_edge, max=B - 1)
    wslot = torch.where(e_in_range,
                        wdata.wedge_ptr[ids[eg_safe]] + eslot - edge_off[eg_safe],
                        0)
    edge_valid = e_in_range & (wdata.wvalid[wslot] > 0)
    offset = node_off_w[eg_safe]
    esrc = torch.where(edge_valid, wdata.wsrc[wslot] + offset, 0)
    edst = torch.where(edge_valid, wdata.wdst[wslot] + offset, -1)
    ew = torch.where(edge_valid, wdata.wweight[wslot], 0.0)
    ed = torch.where(edge_valid, wdata.wdist[wslot], 0.0)

    # --- tiles -------------------------------------------------------------
    tcounts = torch.where(gmask, wdata.tile_counts[ids], 0)
    tcum = torch.cumsum(tcounts, 0)
    tslot = torch.arange(T, device=dev)
    g_of_tile = _slot_to_graph(tcum, T)
    t_in_range = tslot < tcum[-1]
    tg_safe = torch.clamp(g_of_tile, max=B - 1)
    tidx = torch.where(t_in_range,
                       wdata.tile_ptr[ids[tg_safe]] + tslot - (tcum - tcounts)[tg_safe],
                       0)
    wid = wdata.tile_window[tidx] + (node_off_w // tw)[tg_safe]
    # trailing capacity tiles: parked on the last used window (their dst=-1
    # slots add nothing)
    last_w = torch.clamp(n_total_w // tw - 1, min=0)
    wid = torch.clamp(torch.where(t_in_range, wid, last_w), max=NW - 1)
    tfirst = torch.where(t_in_range, wdata.tile_first[tidx], 0)

    return GraphBatch(
        x=x,
        edge_src=esrc.to(torch.int32),
        edge_dst=edst.to(torch.int32),
        edge_weight=ew,
        edge_dist_norm=ed,
        node_graph=node_graph,
        node_mask=node_valid.to(torch.float32),
        edge_mask=edge_valid.to(torch.float32),
        graph_mask=gmask.to(torch.float32),
        y=data.y[ids] * gmask[:, None].to(data.y.dtype),
        u=data.u[ids],
        n_node=ncounts,
        in_degree=in_degree,
        tile_window=wid.to(torch.int32),
        tile_first=tfirst.to(torch.int32),
        window_size=tw,
        kernel_bf16=data.kernel_bf16,
        extra=_batch_extra(data, ids, gmask),
    )


def assemble(data: DeviceDataset, graph_ids, spec: BatchSpec) -> GraphBatch:
    """The batch of `graph_ids`: windowed when the dataset carries the
    windowed layout, padded otherwise."""
    if data.windowed is not None:
        return assemble_batch_windowed(data, data.windowed, graph_ids, spec)
    return assemble_batch(data, graph_ids, spec)
