"""Shared GNN skeleton: pre-FC → conv stack → pool → post-FC → output.

Every reference GNN follows the same frame (e.g. models/cgcnn.py:46-174):
`pre_fc_count` dense layers, `gc_count` conv blocks with optional
BatchNorm, early or late pooling, `post_fc_count` dense layers, a final
`lin_out`, and a squeeze to (B,) for single targets. Subclasses build the
conv stack. With `pool: set2set` an early pool doubles the width into the
head, and a late one runs Set2Set(output_dim) after lin_out, then
`lin_out_2` (the reference package's models/base.py:95-105). Every
model's forward takes `embed`: True returns the graph embedding, the input
of the first post-FC layer (apply_head), for the Analysis run mode. f32 only:
bf16 activations are not ported yet (ROADMAP queue 1, item 5).

Dropout masks come from the model's own torch.Generator, seeded with
`dropout_seed` (the job seed), one per device, never from torch's global
generator: the same seed gives the same masks, in a CUDA graph of a
training step too (the graph registers the generator and draws at the
offset an eager step would).

With `remat`, each conv block runs under torch.utils.checkpoint (the
reference wraps the same modules in nn.remat): its activations are not
kept for the backward but recomputed there, forward kernels included.
CGCNN's, SchNet's, MPNN's and GCN's BatchNorm, dropout and MPNN's GRU stay
outside; MEGNet's block holds its BatchNorms and dropouts, and its
recomputation replays the same dropout masks and updates no running
statistic. The parameter tree does not change.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from matdeeplearn_torch.nn.layers import (Linear, MaskedBatchNorm,
                                          get_activation)
from matdeeplearn_torch.nn.pool import Set2Set, get_pool
from matdeeplearn_torch.ops.edge_basis import gaussian_basis


class GNNBase(nn.Module):
    """Pre-FC and head layers; subclasses add the conv stack and forward."""

    def __init__(self, *, num_features: int, dim1: int, dim2: int,
                 pre_fc_count: int, post_fc_count: int, pool: str,
                 pool_order: str, act: str, output_dim: int,
                 edge_resolution: int, edge_width: float,
                 dropout_rate: float = 0.0, dropout_seed: int = 0,
                 remat: bool = False, head_width: int | None = None,
                 pooled_width: int | None = None,
                 set2set_name: str = "set2set",
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        """head_width: the node features' width into the head (default
        gc_dim). pooled_width: for a subclass that pools early by itself
        (MEGNet), the width of its graph vector; the head then builds no
        early pool. set2set_name: the Set2Set module's name."""
        super().__init__()
        self.remat = remat
        if pool_order not in ("early", "late"):
            raise ValueError(f"pool_order must be 'early' or 'late', got {pool_order!r}")
        self.num_features, self.dim1, self.dim2 = num_features, dim1, dim2
        self.pre_fc_count, self.post_fc_count = pre_fc_count, post_fc_count
        self.pool_order = pool_order
        self.pool = get_pool(pool)
        self.set2set_name = set2set_name if pool == "set2set" else None
        self.act = get_activation(act)
        self.edge_resolution, self.edge_width = edge_resolution, edge_width
        self.dropout_rate, self.dropout_seed = dropout_rate, dropout_seed
        self._dropout_gens: dict[torch.device, torch.Generator] = {}
        kw = dict(generator=generator, device=device)
        for i in range(pre_fc_count):
            fan_in = num_features if i == 0 else dim1
            self.add_module(f"pre_lin{i}", Linear(fan_in, dim1, **kw))
        # early pool: the head runs on the pooled node features (twice as
        # wide after Set2Set); late pool: on node features, pooled after
        # lin_out.
        width = head_width or self.gc_dim
        if pool_order == "early" and pooled_width is not None:
            width = pooled_width
        elif pool_order == "early" and self.set2set_name:
            self.add_module(self.set2set_name, Set2Set(width, **kw))
            width *= 2
        for i in range(post_fc_count):
            self.add_module(f"post_lin{i}", Linear(width, dim2, **kw))
            width = dim2
        self.lin_out = Linear(width, output_dim, **kw)
        if pool_order == "late" and self.set2set_name:
            self.add_module(self.set2set_name, Set2Set(output_dim, **kw))
            self.lin_out_2 = Linear(2 * output_dim, output_dim, **kw)

    @property
    def gc_dim(self) -> int:
        return self.num_features if self.pre_fc_count == 0 else self.dim1

    def run_conv(self, conv, *args):
        """conv(*args), recomputed in the backward under remat when
        gradients are on (non-reentrant: inputs that need no gradient, such
        as the batch's tensors, keep theirs). A block with BatchNorm or
        dropout inside (MEGNet's) recomputes the same values: the
        recomputation replays the dropout generators from where the forward
        started and leaves every running statistic alone."""
        if self.remat and torch.is_grad_enabled():
            # preserve_rng_state off: the forward draws from no global
            # generator (dropout draws from the model's, which
            # _remat_contexts rewinds), and the global CUDA generator's
            # state cannot be read inside a CUDA graph capture
            return checkpoint(conv, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=self._remat_contexts)
        return conv(*args)

    def _remat_contexts(self):
        """(forward, recomputation) contexts of one checkpointed call."""
        if self.training and self.dropout_rate > 0:
            self._dropout_gen(self.lin_out.weight.device)
        start = {d: g.get_state() for d, g in self._dropout_gens.items()}

        @contextlib.contextmanager
        def recompute():
            now = {d: g.get_state() for d, g in self._dropout_gens.items()}
            bns = [m for m in self.modules() if isinstance(m, MaskedBatchNorm)]
            for d, g in self._dropout_gens.items():
                if d in start:
                    g.set_state(start[d])
            for m in bns:
                m.update_stats = False
            try:
                yield
            finally:
                for m in bns:
                    m.update_stats = True
                for d, state in now.items():
                    self._dropout_gens[d].set_state(state)

        return contextlib.nullcontext(), recompute()

    def edge_features(self, batch):
        """On-device Gaussian expansion of stored normalized distances."""
        return gaussian_basis(batch.edge_dist_norm, 0.0, 1.0,
                              self.edge_resolution, self.edge_width)

    def dropout(self, x):
        """Inverted dropout with a mask drawn from the model's generator."""
        if not self.training or self.dropout_rate <= 0:
            return x
        gen = self._dropout_gen(x.device)
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.dropout_rate
        return x * keep / (1.0 - self.dropout_rate)

    def dropout_generators(self) -> list:
        """The model's CUDA dropout generators drawn from so far (a CUDA
        graph of a training step registers them: training/graphs.py)."""
        return [g for d, g in self._dropout_gens.items() if d.type == "cuda"]

    def reseed_dropout(self, seed: int):
        """Seed the dropout masks anew, in place: the generators a CUDA
        graph registered stay the same objects (jobs.reset_run)."""
        self.dropout_seed = int(seed)
        for gen in self._dropout_gens.values():
            gen.manual_seed(int(seed))

    def _dropout_gen(self, device) -> torch.Generator:
        gen = self._dropout_gens.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.dropout_seed)
            self._dropout_gens[device] = gen
        return gen

    def apply_pre_fc(self, x):
        for i in range(self.pre_fc_count):
            x = self.act(getattr(self, f"pre_lin{i}")(x))
        return x

    def _post_fc(self, out):
        for i in range(self.post_fc_count):
            out = self.act(getattr(self, f"post_lin{i}")(out))
        return self.lin_out(out)

    def _pool(self, out, batch):
        args = (batch.node_graph, batch.node_mask, batch.num_graphs)
        if self.set2set_name:
            return getattr(self, self.set2set_name)(out, *args)
        return self.pool(out, *args)

    def apply_head(self, out, batch, pooled: bool = False,
                   embed: bool = False):
        """Early/late pooling + post-FC stack + lin_out (+ squeeze).
        pooled: `out` is already the graph vector of an early pool.
        embed: return the input of the first post-FC layer instead (the
        graph embedding of the Analysis run mode: (B, width) after an
        early pool, the (N, width) node features before a late one, as the
        reference's hook on post_lin_list[0] reads it)."""
        if self.pool_order == "early":
            out = out if pooled else self._pool(out, batch)
            if embed:
                return out
            out = self._post_fc(out)
        elif embed:
            return out
        else:
            out = self._pool(self._post_fc(out), batch)
            if self.set2set_name:
                out = self.lin_out_2(out)
        if out.shape[-1] == 1:
            return out.reshape(-1)
        return out
