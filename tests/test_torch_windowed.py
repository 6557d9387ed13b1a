"""The port's windowed layout and windowed ops against the JAX package on
the CPU.

* build_windowed_layout equals the JAX layout array for array, on the toy
  set and on a datasets/synthetic.py set, and keeps the layout's four
  invariants; the default window follows the JAX rule.
* The cache file windowed_v2_{tw}_{te}.npz one package writes, the other
  reads, both ways.
* windowize_edges equals the JAX windowize_edges; assemble_batch_windowed
  equals the JAX assembler field for field (exactly).
* The plain windowed segment-sum, SpMM and gather (what the autograd
  Functions run on the CPU) against ops/pallas_segment.py's
  windowed_segment_sum, windowed_spmm and windowed_gather in interpret mode,
  as the JAX package's own tests run them: values and VJPs (the SpMM's to
  both operands) to atol 1e-5, at D = 1, 8 and 32, with a masked tail and
  an empty window.
* A NaN in the message of a pad slot stays out of the sums.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import windowed as JW
from matdeeplearn_tpu.data.dataset import GraphDataset as JGraphDataset
from matdeeplearn_tpu.ops import pallas_segment as PS
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import dataset as TD
from matdeeplearn_torch.data import windowed as TW
from matdeeplearn_torch.ops import windowed as WO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("worder", "wvalid", "wdst", "wsrc", "wweight", "wdist", "wedge_ptr",
          "tile_window", "tile_first", "tile_ptr", "node_counts_w", "in_degree")
ATOL = 1e-5


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    """24 clusters of 12 atoms from datasets/synthetic.py, processed by the
    port."""
    root = str(tmp_path_factory.mktemp("synthetic"))
    subprocess.run([sys.executable, os.path.join(REPO, "datasets", "synthetic.py"),
                    "--out", root, "--n", "24", "--atoms", "12"],
                   check=True, capture_output=True, timeout=300)
    return TD.get_dataset(root, 0, "False",
                          {"graph_max_radius": 5.0, "graph_max_neighbors": 6,
                           "verbose": "False"})


def _check_invariants(layout, ds):
    tw, te = layout.tw, layout.te
    for g in range(ds.num_graphs):
        a, b = layout.wedge_ptr[g], layout.wedge_ptr[g + 1]
        wd, wv, wo = layout.wdst[a:b], layout.wvalid[a:b], layout.worder[a:b]
        e0, e1 = ds.edge_ptr[g], ds.edge_ptr[g + 1]
        # every real edge exactly once, with its own dst
        assert sorted(wo[wv > 0].tolist()) == list(range(e1 - e0))
        np.testing.assert_array_equal(wd[wv > 0], ds.edge_dst[e0:e1][wo[wv > 0]])
        # one window a tile; every window of the graph has a first tile
        t0, t1 = layout.tile_ptr[g], layout.tile_ptr[g + 1]
        for t in range(t1 - t0):
            seg = wd[t * te:(t + 1) * te]
            seg = seg[seg >= 0]
            assert (seg // tw == layout.tile_window[t0 + t]).all()
        first = layout.tile_window[t0:t1][layout.tile_first[t0:t1] > 0]
        np.testing.assert_array_equal(first, np.arange(layout.node_counts_w[g] // tw))


@pytest.mark.parametrize("which,tw,te", [("toy", 8, 16), ("toy", None, 128),
                                          ("synthetic", 8, 32)])
def test_layout_matches_jax(toy_dataset, synthetic_dataset, which, tw, te):
    ds = toy_dataset if which == "toy" else synthetic_dataset
    if tw is None:  # the default window (test_default_window_matches_jax)
        tw = TD.default_window(ds.node_counts())
    ref = JW.build_windowed_layout(ds, tw=tw, te=te)
    got = TW.build_windowed_layout(ds, tw=tw, te=te)
    assert (got.tw, got.te) == (ref.tw, ref.te)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    _check_invariants(got, ds)


def test_default_window_matches_jax(synthetic_dataset, tmp_path):
    """The default tw: JAX's windowed_layout() (no cache dir) against the
    port's rule."""
    ds = synthetic_dataset
    jds = JGraphDataset(**{f: getattr(ds, f) for f in (
        "node_x", "node_z", "edge_src", "edge_dst", "edge_weight",
        "edge_dist_norm", "node_ptr", "edge_ptr", "y", "u", "structure_ids")})
    assert TD.windowed_layout(ds, te=32).tw == jds.windowed_layout(te=32).tw
    for counts in ([3] * 20, list(range(1, 700)), [9, 17, 64, 65]):
        p95 = int(np.percentile(counts, 95))
        assert TD.default_window(counts) == min(512, max(8, -(-p95 // 8) * 8))


def _reload(cache_dir, package):
    """A fresh dataset object (no memo) reading `cache_dir`."""
    if package == "jax":
        return JGraphDataset.load(cache_dir)
    return TD.GraphDataset.load(cache_dir)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_layout_cache_is_shared(toy_data_dir, tmp_path, monkeypatch, writer):
    """One package writes windowed_v2_{tw}_{te}.npz; the other reads it
    without building (its build_windowed_layout is made to fail)."""
    import shutil

    from matdeeplearn_tpu.data import windowed as jw_mod

    src = TD.get_dataset(toy_data_dir, 0, "False",
                         {"graph_max_radius": 5.0, "graph_max_neighbors": 6,
                          "verbose": "False"}).cache_dir
    cache = str(tmp_path / "processed")
    shutil.copytree(src, cache)
    for f in os.listdir(cache):
        if f.startswith("windowed_"):
            os.remove(os.path.join(cache, f))
    reader = "jax" if writer == "port" else "port"
    written = _reload(cache, writer).windowed_layout(tw=8, te=16)
    assert os.path.exists(os.path.join(cache, "windowed_v2_8_16.npz"))

    def refuse(*args, **kwargs):
        raise AssertionError("the layout was built, not read")

    monkeypatch.setattr(jw_mod if reader == "jax" else TW,
                        "build_windowed_layout", refuse)
    read = _reload(cache, reader).windowed_layout(tw=8, te=16)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(read, k), getattr(written, k),
                                      err_msg=k)


def _sorted_edges(rng, e, n):
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst[:n] = np.arange(n)  # every node has an edge (the self-loops)
    return np.sort(dst)


def _port_edges(we) -> WO.WindowedEdges:
    return WO.WindowedEdges(
        order=torch.tensor(np.asarray(we.order), dtype=torch.int64),
        dst=torch.tensor(np.asarray(we.dst)),
        window_id=torch.tensor(np.asarray(we.window_id)),
        first_tile=torch.tensor(np.asarray(we.first_tile)),
        valid=torch.tensor(np.asarray(we.valid)))


@pytest.mark.parametrize("e,n", [(96, 40), (256, 100)])
def test_windowize_edges_matches_jax(rng, e, n):
    tw, te = 16, 32
    dst = _sorted_edges(rng, e, n)
    mask = np.ones(e, np.float32)
    mask[-5:] = 0
    dst[-5:] = n - 1
    ref = PS.windowize_edges(jnp.asarray(dst), jnp.asarray(mask), n, tw, te)
    got = WO.windowize_edges(torch.as_tensor(dst), torch.as_tensor(mask), n,
                             tw, te)
    valid = np.asarray(ref.valid) > 0
    for k in ("dst", "window_id", "first_tile", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_array_equal(got.order.numpy()[valid],
                                  np.asarray(ref.order)[valid])
    assert (got.num_tiles, got.dst.shape[0]) == (
        ref.num_tiles, WO.windowed_sizes(n, e, tw, te)[1])


@pytest.mark.parametrize("ids", [[2, 5, 0, 9, -1, -1], [15, 3, 7, 11, 1, 8]])
def test_assemble_batch_windowed_matches_jax(toy_dataset, ids):
    ds, tw, te = toy_dataset, 8, 16
    layout = TW.build_windowed_layout(ds, tw, te)
    jlayout = JW.build_windowed_layout(ds, tw, te)
    spec = TB.BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts,
                                    6, align=tw, align_edges=te)
    jspec = JB.BatchSpec.for_dataset(jlayout.node_counts_w, jlayout.wedge_counts,
                                     6, align=tw, align_edges=te)
    assert (spec.num_graphs, spec.num_nodes, spec.num_edges) == (
        jspec.num_graphs, jspec.num_nodes, jspec.num_edges)
    jdata = JB.DeviceDataset.from_graph_dataset(ds)
    jb = JB.assemble_batch_windowed(jdata, JB.WindowedDeviceData.from_layout(jlayout),
                                    jnp.asarray(ids, jnp.int32), jspec, tw, te)
    tdata = TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", windowed=TB.WindowedDeviceData.from_layout(layout, "cpu"))
    tb = TB.assemble(tdata, np.asarray(ids, np.int32), spec)
    assert tb.is_windowed and jb.is_windowed and not tb.dst_sorted
    assert tb.window_size == jb.window_size == tw
    for k in ("x", "edge_src", "edge_dst", "edge_weight", "edge_dist_norm",
              "node_graph", "node_mask", "edge_mask", "graph_mask", "y", "u",
              "n_node", "tile_window", "tile_first", "in_degree"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    np.testing.assert_array_equal(tb.edge_dst_safe.numpy(),
                                  np.asarray(jb.edge_dst_safe))
    em = tb.edge_mask.numpy() > 0
    assert (tb.edge_dst.numpy()[~em] == -1).all()
    assert (tb.in_degree.numpy()[tb.node_mask.numpy() == 0] == 1.0).all()


# ------------------------------------------------------------ the three ops


def _problem(rng, e, n, d, tw, te, empty_window=False):
    """A masked tail (7 pad edges) or, with empty_window, nodes 16..31
    without edges; random messages, weights and node rows."""
    if empty_window:
        dst = np.concatenate([np.sort(rng.integers(0, 16, e // 2)),
                              np.sort(rng.integers(32, n, e - e // 2))]
                             ).astype(np.int32)
        mask = np.ones(e, np.float32)
    else:
        dst = _sorted_edges(rng, e, n)
        mask = np.ones(e, np.float32)
        mask[-7:] = 0
        dst[-7:] = dst[-8]
    jwe = PS.windowize_edges(jnp.asarray(dst), jnp.asarray(mask), n, tw, te)
    ew = jwe.dst.shape[0]
    msg = rng.standard_normal((ew, d)).astype(np.float32)
    w = rng.standard_normal(ew).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot_n = rng.standard_normal((n, d)).astype(np.float32)
    cot_e = rng.standard_normal((ew, d)).astype(np.float32)
    return jwe, _port_edges(jwe), msg, w, x, cot_n, cot_e


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _close(got, ref, what, rows=None):
    got, ref = np.asarray(got), np.asarray(ref)
    if rows is not None:
        got, ref = got[rows], ref[rows]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("e,n,d,empty", [(128, 48, 8, False),
                                         (512, 200, 32, False),
                                         (96, 40, 1, False),
                                         (64, 48, 8, True)])
def test_plain_ops_match_jax_interpret(rng, e, n, d, empty):
    tw, te = 16, 32 if empty else 64
    jwe, we, msg, w, x, cot_n, cot_e = _problem(rng, e, n, d, tw, te, empty)
    args = (tw, te, True)  # interpret mode, the hi/lo split
    valid = np.asarray(jwe.valid) > 0

    # segment sum and its VJP (the gather)
    ref, vjp = jax.vjp(lambda m: PS.windowed_segment_sum(m, jwe, n, *args),
                       jnp.asarray(msg))
    m = _t(msg, True)
    out = WO.windowed_segment_sum(m, we, n, tw)
    (out * _t(cot_n)).sum().backward()
    _close(out.detach(), ref, "segment_sum")
    _close(m.grad, vjp(jnp.asarray(cot_n))[0], "segment_sum d_msg")
    if empty:
        assert float(out[16:32].abs().max()) == 0.0

    # SpMM and its VJP to both operands
    ref, vjp = jax.vjp(lambda wv, mv: PS.windowed_spmm(wv, mv, jwe, n, *args),
                       jnp.asarray(w), jnp.asarray(msg))
    wt, m = _t(w, True), _t(msg, True)
    out = WO.windowed_spmm(wt, m, we, n, tw)
    (out * _t(cot_n)).sum().backward()
    rw, rm = vjp(jnp.asarray(cot_n))
    _close(out.detach(), ref, "spmm")
    _close(wt.grad, rw, "spmm d_w", valid)
    _close(m.grad, rm, "spmm d_msg")

    # gather and its VJP (the segment sum)
    ref, vjp = jax.vjp(lambda xv: PS.windowed_gather(xv, jwe, *args),
                       jnp.asarray(x))
    xt = _t(x, True)
    out = WO.windowed_gather(xt, we, tw)
    (out * _t(cot_e)).sum().backward()
    _close(out.detach(), ref, "gather")
    assert float(out.detach()[~torch.as_tensor(valid)].abs().max()) == 0.0
    _close(xt.grad, vjp(jnp.asarray(cot_e))[0], "gather d_x")


def test_nan_on_pad_slots_stays_out(rng):
    """Pad slots are skipped, not multiplied by 0: NaN messages (and
    weights) there leave every sum finite and unchanged. The JAX kernel's
    one-hot matmul multiplies them by 0, so there the NaN spreads (a
    difference of the port, ROADMAP §3)."""
    n, d, tw, te = 48, 8, 16, 64
    jwe, we, msg, w, _, cot_n, _ = _problem(rng, 128, n, d, tw, te)
    pad = we.dst.numpy() < 0
    assert pad.any()
    bad_msg, bad_w = msg.copy(), w.copy()
    bad_msg[pad], bad_w[pad] = np.nan, np.nan
    ref = PS.windowed_segment_sum(jnp.asarray(bad_msg), jwe, n, tw, te, True)
    assert np.isnan(np.asarray(ref)).any()
    for fn in (lambda m, wv: WO.windowed_segment_sum(m, we, n, tw),
               lambda m, wv: WO.windowed_spmm(wv, m, we, n, tw)):
        clean = fn(_t(msg), _t(w))
        out = fn(_t(bad_msg), _t(bad_w))
        assert torch.isfinite(out).all()
        assert torch.equal(out, clean)
    # the gather's backward is the sum: a NaN cotangent on a pad slot
    x = _t(rng.standard_normal((n, d)).astype(np.float32), True)
    g = torch.zeros(we.dst.shape[0], d)
    g[torch.as_tensor(pad)] = float("nan")
    WO.windowed_gather(x, we, tw).backward(g)
    assert torch.isfinite(x.grad).all()
    assert float(x.grad.abs().max()) == 0.0
