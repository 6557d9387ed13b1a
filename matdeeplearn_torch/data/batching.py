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
over real edges: the layout of the CSR kernels (ops/csr.py). A dataset
made with kernel_fused=True (dst order only) marks its batches for the
fused CGConv kernel (ops/fused_cgconv.py). Packed and windowed batches are
not ported yet (ROADMAP queue 1, items 3 and 15).
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
    def for_dataset(cls, node_counts, edge_counts, batch_size: int, align: int = 8):
        """Tight upper bound over any batch of `batch_size` graphs: the sum of
        the `batch_size` largest node/edge counts, aligned to `align`."""
        b = min(batch_size, len(node_counts))
        n = int(np.sort(np.asarray(node_counts))[-b:].sum())
        e = int(np.sort(np.asarray(edge_counts))[-b:].sum())
        return cls(
            batch_size,
            round_up(max(n, 1), align),
            round_up(max(e, 1), align),
        )


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
    # "dst": each graph's edges sorted by (local dst, local src); None keeps
    # the reference edge order.
    edge_order: str | None = None
    # (N,) float32 per-node in-degree under edge_order "dst": a dataset
    # constant that batches take through the node gather.
    node_indeg: torch.Tensor | None = None
    # batches run CGConv on the fused kernel (needs edge_order "dst")
    kernel_fused: bool = False

    @property
    def device(self) -> torch.device:
        return self.node_x.device

    @property
    def dst_sorted(self) -> bool:
        return self.edge_order == "dst"

    @classmethod
    def from_graph_dataset(cls, ds, device: str | torch.device,
                           edge_order: str | None = None,
                           kernel_fused: bool = False) -> "DeviceDataset":
        if kernel_fused and edge_order != "dst":
            raise ValueError("kernel_fused needs edge_order='dst' (the "
                             "in-degree comes with the sorted order)")
        if edge_order not in (None, "dst"):
            raise NotImplementedError(
                f"edge_order={edge_order!r}: only 'dst' is ported (the src "
                "order comes with MEGNet, ROADMAP queue 1, item 10)"
            )
        y = ds.targets
        if y.ndim == 1:
            y = y[:, None]
        esrc = np.asarray(ds.edge_src, np.int32)
        edst = np.asarray(ds.edge_dst, np.int32)
        ew = np.asarray(ds.edge_weight, np.float32)
        ed = np.asarray(ds.edge_dist_norm, np.float32)
        node_indeg = None
        if edge_order == "dst":
            # One host-side lexsort per run: within each graph order edges
            # by local dst, then local src. Node ids are graph-local, so the
            # graph id is the major key.
            gid = np.repeat(
                np.arange(len(ds.node_ptr) - 1, dtype=np.int64),
                np.diff(ds.edge_ptr),
            )
            perm = np.lexsort((esrc, edst, gid))
            esrc, edst, ew, ed = esrc[perm], edst[perm], ew[perm], ed[perm]
            nptr = np.asarray(ds.node_ptr, np.int64)
            indeg = np.zeros(int(nptr[-1]), np.float32)
            np.add.at(indeg, edst.astype(np.int64) + nptr[gid[perm]], 1.0)
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
    # (N_pad,) float32 in-degree of each node (0 on pads); set under
    # edge_order "dst".
    in_degree: torch.Tensor | None = None
    edge_order: str | None = None
    kernel_fused: bool = False

    @property
    def dst_sorted(self) -> bool:
        return self.edge_order == "dst"

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
    )
