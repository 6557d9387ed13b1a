"""The CPU oracle of the single-pass kernel arms: the JAX package's Pallas
kernels with the TPU MXU's single pass emulated.

On the TPU, `hilo=False` feeds the data operand of each one-hot matmul to
the MXU once, which rounds it to bf16 (to nearest, ties to even; the
one-hot operand is exact and the sum is f32): about 2e-3 relative error
(ops/pallas_segment.py:132-140). On the CPU the package cannot show this:
interpret mode runs the single pass as an f32 dot (ops/pallas_csr.py:47-53,
:119-132), which is why tests/test_pallas_segment.py:208-226 accepts
1e-2·scale for the arm. `emulate_single_pass` therefore replaces, for one
test, the package's helpers that own each rounding point by versions that
round the non-one-hot operand to bf16 and then take the exact hi/lo path:

* pallas_fused._acc and _gather_win (the fused CGConv's x_i gather,
  message sum, g[dst] gather and d_x_i sum), under both names that hold
  them: pallas_fused_schnet imports them by name (the cfconv's message sum
  and g[dst] gather);
* pallas_segment._windowed_segment_sum_impl (rounds messages),
  _windowed_spmm_impl (rounds messages·weights, the f32 product, then
  sums) and _windowed_gather_impl (rounds x);
* pallas_csr._csr_sum_impl and _csr_gather_impl (round the data operand).

A call with hilo=True goes to the original unchanged. Nothing in the JAX
package is edited: the patches are pytest's monkeypatch, undone after the
test, and jax.clear_caches() runs on entry and on exit so that no trace
made with one set of helpers is reused with the other.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

from matdeeplearn_tpu.ops import pallas_csr as PC
from matdeeplearn_tpu.ops import pallas_fused as PF
from matdeeplearn_tpu.ops import pallas_fused_schnet as PFS
from matdeeplearn_tpu.ops import pallas_segment as PS


def bf16(v):
    """v rounded to bf16 and back to f32 (round to nearest, ties to even)."""
    return v.astype(jnp.bfloat16).astype(jnp.float32)


@contextlib.contextmanager
def emulate_single_pass(monkeypatch):
    """Within the block, the JAX package's hilo=False arms round their data
    operands to bf16 as the TPU's single MXU pass does (module docstring)."""
    acc, gather_win = PF._acc, PF._gather_win
    seg_sum = PS._windowed_segment_sum_impl
    spmm, wgather = PS._windowed_spmm_impl, PS._windowed_gather_impl
    csr_sum, csr_gather = PC._csr_sum_impl, PC._csr_gather_impl

    def sp_acc(out_ref, onehot, msg, hilo):
        return acc(out_ref, onehot, msg if hilo else bf16(msg), True)

    def sp_gather_win(onehot, win_ref, hilo):
        if hilo:
            return gather_win(onehot, win_ref, True)
        return gather_win(onehot, bf16(win_ref[:]), True)

    def sp_seg_sum(messages, we, num_nodes, tw, te, interpret, hilo=True):
        m = messages if hilo else bf16(messages)
        return seg_sum(m, we, num_nodes, tw, te, interpret, True)

    def sp_spmm(weights, messages, we, num_nodes, tw, te, interpret,
                hilo=True):
        if hilo:
            return spmm(weights, messages, we, num_nodes, tw, te, interpret,
                        True)
        return seg_sum(bf16(messages * weights[:, None]), we, num_nodes, tw,
                       te, interpret, True)

    def sp_wgather(x, we, tw, te, interpret, hilo=True):
        return wgather(x if hilo else bf16(x), we, tw, te, interpret, True)

    def sp_csr_sum(messages, dst_p, bases, ep, t, w, n_res, te, interpret,
                   hilo, nsub=PC.NSUB):
        m = messages if hilo else bf16(messages)
        return csr_sum(m, dst_p, bases, ep, t, w, n_res, te, interpret, True,
                       nsub)

    def sp_csr_gather(g, dst_p, bases, ep, t, w, n_res, te, interpret, hilo,
                      nsub=PC.NSUB):
        gv = g if hilo else bf16(g)
        return csr_gather(gv, dst_p, bases, ep, t, w, n_res, te, interpret,
                          True, nsub)

    jax.clear_caches()
    with monkeypatch.context() as m:
        for mod in (PF, PFS):
            m.setattr(mod, "_acc", sp_acc)
            m.setattr(mod, "_gather_win", sp_gather_win)
        m.setattr(PS, "_windowed_segment_sum_impl", sp_seg_sum)
        m.setattr(PS, "_windowed_spmm_impl", sp_spmm)
        m.setattr(PS, "_windowed_gather_impl", sp_wgather)
        m.setattr(PC, "_csr_sum_impl", sp_csr_sum)
        m.setattr(PC, "_csr_gather_impl", sp_csr_gather)
        try:
            yield
        finally:
            jax.clear_caches()
