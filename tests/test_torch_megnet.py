"""The port's MEGNet slice (with Set2Set) against the JAX package on the CPU.

* segment_softmax, LSTMCell and Set2Set: outputs (and Set2Set's gradients)
  to rtol 1e-5 and atol 1e-5·max|ref|.
* One MEGNetBlock on a plain and a src-sorted batch (the JAX side on the
  same kind of batch: XLA, and its CSR kernels in interpret mode, as
  tests/test_csr.py runs them): the three outputs and every gradient (x,
  e, u, each parameter), training-mode BatchNorm, to rtol 1e-5 and atol
  1e-5·max|ref| (gradients: of each MLP).
* The src-order dataset: edge_src sorted over real edges, the batch's
  in_degree the out-degree, the JAX dataset's node_indeg. The CSR plain
  versions drop out-of-range indices, as the kernels do.
* The converter carries a MEGNet tree with set2set_x and set2set_e (their
  LSTMs through the w_ih/w_hh mapping) both ways, exactly.
* MEGNet in eval mode (random BatchNorm statistics) and in training mode
  with every parameter gradient, under the port's xla, csr (src) and
  pallas batches, early and late, mean pool and set2set, against the JAX
  MEGNet on its plain batch: rtol 2e-4 and atol 2e-4·max|ref| (gradients:
  of each layer, a block with its three embeddings); training mode on all
  16 toy graphs (jax_megnets says why).
* Set2Set on CGCNN's head (early: doubled width; late: lin_out_2).
* Remat of MEGNet's blocks (BatchNorm and dropout inside) gives the plain
  gradients and running statistics.
* Three epochs of the port's trainer under kernels xla, csr, pallas and
  fused (which runs the pallas plan) against JAX setup_run +
  run_fused_training (kernel xla): per-epoch train and val errors to rtol
  2e-3 and atol 2e-3, the learning rate to 1e-6.
* resolve_kernel for MEGNet; Predict on a JAX-trained MEGNet checkpoint
  matches JAX Predict (ids equal, predictions to 1e-4) and runs on
  src-sorted batches; chip_smoke.py's MEGNet_demo is config.yml's.
"""

import contextlib
import csv
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matdeeplearn_tpu.data import batching as JB
from matdeeplearn_tpu.data import dataset as JD
from matdeeplearn_tpu.models import build_model as j_build_model
from matdeeplearn_tpu.nn.conv import MEGNetBlock as JMEGNetBlock
from matdeeplearn_tpu.nn.layers import LSTMCell as JLSTMCell
from matdeeplearn_tpu.nn.pool import Set2Set as JSet2Set
from matdeeplearn_tpu.ops import segment as JS
from matdeeplearn_tpu.training import jobs as JJ
from matdeeplearn_tpu.training.checkpoint import load_checkpoint as j_load
from matdeeplearn_tpu.training.checkpoint import params_from_raw
from matdeeplearn_torch.convert import params_from_jax, params_to_jax
from matdeeplearn_torch.data import batching as TB
from matdeeplearn_torch.data import windowed as TW
from matdeeplearn_torch.models import build_model
from matdeeplearn_torch.nn.conv import MEGNetBlock
from matdeeplearn_torch.nn.layers import LSTMCell
from matdeeplearn_torch.nn.pool import Set2Set, get_pool
from matdeeplearn_torch.ops import segment as TS
from matdeeplearn_torch.training import jobs as TJ
from matdeeplearn_torch.training.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = np.array([3, 0, 9, 14, 6, 1, -1, -1], np.int32)
ALL_IDS = np.array([*range(15, -1, -1), -1, -1], np.int32)
TW_, TE_ = 8, 16
HP = {"dim1": 12, "dim2": 10, "dim3": 8, "gc_count": 2, "gc_fc_count": 1,
      "post_fc_count": 1}
# trainer parity runs without BatchNorm (see the bias test below)
MODEL = {"model": "MEGNet", **HP, "batch_size": 4, "epochs": 3, "lr": 0.01,
         "optimizer": "AdamW", "optimizer_args": {},
         "scheduler": "ReduceLROnPlateau",
         "scheduler_args": {"mode": "min", "factor": 0.5, "patience": 0,
                            "min_lr": 1e-5, "threshold": 2e-4},
         "batch_norm": "False", "dropout_rate": 0.0, "print_model": False}
EPOCH_LINE = re.compile(r"Epoch: (\d+), Learning Rate: ([0-9.]+), Training "
                        r"Error: ([0-9.naN]+), Val Error: ([0-9.naN]+)")


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _close(a, b, tol, name, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


def _layer(key: str, depth: int = 1) -> str:
    """The key's first `depth` dotted parts; a MEGNet layer's embeddings
    (e/x/u_embed{i}) count with its block conv{i}."""
    head = ".".join(key.split(".")[:depth])
    m = re.fullmatch(r"[exu]_embed(\d+)", head)
    return f"conv{m.group(1)}" if m else head


def _close_grads(got: dict, ref: dict, tol, depth=1):
    """Each gradient to rtol `tol`, atol `tol`·(the largest gradient of its
    layer, _layer)."""
    assert set(got) == set(ref)
    scope = lambda k: _layer(k, depth)
    mx = {}
    for k, g in ref.items():
        mx[scope(k)] = max(mx.get(scope(k), 1e-30), float(np.abs(g).max()))
    for k, g in ref.items():
        _close(got[k], g, tol, k, mx[scope(k)])


def _port_batch(ds, kind, ids=IDS):
    """The port's batch of `ids`: the reference order (xla), src-sorted
    (csr) or windowed (pallas)."""
    if kind == "pallas":
        layout = TW.build_windowed_layout(ds, TW_, TE_)
        spec = TB.BatchSpec.for_dataset(layout.node_counts_w,
                                        layout.wedge_counts, len(ids),
                                        align=TW_, align_edges=TE_)
        tdata = TB.DeviceDataset.from_graph_dataset(
            ds, "cpu", windowed=TB.WindowedDeviceData.from_layout(layout, "cpu"))
        return TB.assemble(tdata, ids, spec)
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(ids))
    return TB.assemble_batch(TB.DeviceDataset.from_graph_dataset(
        ds, "cpu", edge_order="src" if kind == "csr" else None), ids, spec)


def _batches(ds, kind, ids=IDS):
    """The JAX batch and the port's batch of the same graphs (kinds as in
    _port_batch; JAX has no windowed kind here)."""
    order = "src" if kind == "csr" else None
    spec = TB.BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), len(ids))
    jb = JB.assemble_batch(
        JB.DeviceDataset.from_graph_dataset(ds, edge_order=order),
        jnp.asarray(ids),
        JB.BatchSpec(spec.num_graphs, spec.num_nodes, spec.num_edges))
    return jb, _port_batch(ds, kind, ids)


def _randomize(variables, seed):
    """Random BatchNorm scale/bias and running statistics (numpy trees)."""
    rng = np.random.default_rng(seed)
    params = _tree(variables["params"])
    stats = _tree(variables.get("batch_stats", {}))

    def walk(p, s):
        for name, sub in s.items():
            if "mean" in sub:
                d = sub["mean"].shape[0]
                sub["mean"] = rng.normal(0.0, 0.5, d).astype(np.float32)
                sub["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
                p[name]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
                p[name]["bias"] = rng.normal(0.0, 0.2, d).astype(np.float32)
            else:
                walk(p[name], sub)

    walk(params, stats)
    return params, stats


def _jax_model(ds, name, hp, seed=0):
    model = j_build_model(name, ds, hp)
    jb, _ = _batches(ds, "xla")
    variables = model.init(jax.random.PRNGKey(seed), jb, training=False)
    return model, _randomize(variables, seed)


def _port_model(ds, name, hp, params, stats):
    model = build_model(name, ds, hp, device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model


# ---------------------------------------------------- softmax, LSTM, Set2Set


def _graph_inputs(seed, n=23, b=4, d=6):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, b, n))
    seg[-3:] = b  # pad nodes: the dummy segment
    mask = (seg < b).astype(np.float32)
    mask[2] = 0.0
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    return x, seg, mask


def test_segment_softmax_matches_jax():
    x, seg, mask = _graph_inputs(1, d=1)
    for m in (mask, None):
        ref = JS.segment_softmax(jnp.asarray(x), jnp.asarray(seg), 5,
                                 None if m is None else jnp.asarray(m))
        got = TS.segment_softmax(torch.as_tensor(x), torch.as_tensor(seg), 5,
                                 None if m is None else torch.as_tensor(m))
        _close(got.numpy(), np.asarray(ref), 1e-5, "softmax")
    assert float(got[np.asarray(seg) == 0].sum()) == pytest.approx(1.0)


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal((5, k)).astype(np.float32) for k in (12, 6, 6))
    cell = JLSTMCell(6)
    params = _tree(cell.init(jax.random.PRNGKey(0), x, h, c)["params"])
    assert params["w_ih"].shape == (12, 24)
    jh, jc = cell.apply({"params": params}, x, h, c)
    tcell = LSTMCell(12, 6)
    tcell.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           params_from_jax({"lstm": params}).items()})
    th, tc = tcell(*(torch.as_tensor(a) for a in (x, h, c)))
    _close(th.detach().numpy(), np.asarray(jh), 1e-5, "h")
    _close(tc.detach().numpy(), np.asarray(jc), 1e-5, "c")


def test_set2set_matches_jax():
    x, seg, mask = _graph_inputs(3)
    s2s = JSet2Set(6, processing_steps=3)
    args = (jnp.asarray(seg), jnp.asarray(mask), 4)
    params = _tree(s2s.init(jax.random.PRNGKey(1), jnp.asarray(x), *args)
                   ["params"])
    cot = np.random.default_rng(4).standard_normal((4, 12)).astype(np.float32)

    def jloss(p, xv):
        return jnp.sum(s2s.apply({"params": p}, xv, *args) * cot)

    ref = s2s.apply({"params": params}, jnp.asarray(x), *args)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = Set2Set(6)
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          params_from_jax({"s": params}).items()})
    xt = torch.tensor(x, requires_grad=True)
    out = tmod(xt, torch.as_tensor(seg), torch.as_tensor(mask), 4)
    (out * torch.as_tensor(cot)).sum().backward()
    assert out.shape == (4, 12)
    _close(out.detach().numpy(), np.asarray(ref), 1e-5, "set2set")
    _close(xt.grad.numpy(), np.asarray(gx), 1e-5, "d_x")
    assert float(xt.grad[mask == 0].abs().max()) == 0.0  # pads stay out
    got = {f"s.{k}": p.grad.numpy() for k, p in tmod.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in
                       params_from_jax({"s": _tree(gp)}).items()}, 1e-5, 3)
    assert get_pool("set2set") is Set2Set


# ------------------------------------------------------------------- block


@pytest.mark.parametrize("kind", ["xla", "csr"])
def test_megnet_block_matches_jax(toy_dataset, kind):
    """One block in training mode: x', e', u' and the gradients of x, e, u
    and every parameter, each package on its own batch of that kind."""
    jb, tb = _batches(toy_dataset, kind)
    assert tb.src_sorted == (kind == "csr") == jb.src_sorted
    rng = np.random.default_rng(6)
    d = 8
    x = rng.standard_normal((jb.num_nodes, d)).astype(np.float32)
    e = rng.standard_normal((jb.num_edges, d)).astype(np.float32)
    u = rng.standard_normal((jb.num_graphs, d)).astype(np.float32)
    masks = (np.asarray(jb.node_mask), np.asarray(jb.edge_mask),
             np.asarray(jb.graph_mask))
    cots = [rng.standard_normal(a.shape).astype(np.float32) * m[:, None]
            for a, m in zip((x, e, u), masks)]
    block = JMEGNetBlock(d, 1)
    variables = block.init(jax.random.PRNGKey(2), x, e, u, jb, training=False)
    params, stats = _tree(variables["params"]), _tree(variables["batch_stats"])

    def jloss(p, xv, ev, uv):
        outs, _ = block.apply({"params": p, "batch_stats": stats}, xv, ev, uv,
                              jb, training=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(params, x, e, u)
    tblock = MEGNetBlock(d, 1).train()
    tblock.load_state_dict({k.split(".", 1)[1]: v for k, v in
                            params_from_jax({"b": params}, {"b": stats}).items()})
    ins = [torch.tensor(a, requires_grad=True) for a in (x, e, u)]
    outs = tblock(*ins, tb, lambda t: t)
    sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    for name, o, r, m in zip("xeu", outs, jouts, masks):
        sel = m > 0
        _close(o.detach().numpy()[sel], np.asarray(r)[sel], 1e-5, f"{name}'")
    for name, t, g in zip("xeu", ins, grads[1:]):
        _close(t.grad.numpy(), np.asarray(g), 1e-5, f"d_{name}")
    got = {f"b.{k}": p.grad.numpy() for k, p in tblock.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in
                       params_from_jax({"b": _tree(grads[0])}).items()},
                 1e-5, 2)


def test_csr_plain_versions_drop_out_of_range_indices():
    """The CSR kernels' contract, held by their plain versions too: an edge
    whose index lies outside [0, n) gathers a zero row and adds nothing."""
    from matdeeplearn_torch.ops import csr

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1.0
    idx = torch.tensor([0, 2, 3, -1, 1], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    out = csr.gather_plain(x, idx, mask)
    torch.testing.assert_close(out, torch.stack([x[0], x[2], torch.zeros(4),
                                                 torch.zeros(4),
                                                 torch.zeros(4)]))
    torch.testing.assert_close(csr.gather_plain(x, idx, None)[:3],
                               torch.stack([x[0], x[2], torch.zeros(4)]))
    msg = torch.ones(5, 4)
    torch.testing.assert_close(csr.segment_sum_plain(msg, idx, mask, 3),
                               torch.tensor([[1.0] * 4, [0.0] * 4, [1.0] * 4]))


def test_src_order_dataset_matches_jax(toy_dataset):
    ds = toy_dataset
    jdd = JB.DeviceDataset.from_graph_dataset(ds, edge_order="src")
    tdd = TB.DeviceDataset.from_graph_dataset(ds, "cpu", edge_order="src")
    assert tdd.src_sorted and not tdd.dst_sorted
    np.testing.assert_array_equal(tdd.node_indeg.numpy(),
                                  np.asarray(jdd.node_indeg))
    with pytest.raises(ValueError, match="kernel_fused"):
        TB.DeviceDataset.from_graph_dataset(ds, "cpu", edge_order="src",
                                            kernel_fused=True)
    tb = _port_batch(ds, "csr")
    em = tb.edge_mask.numpy() > 0
    src = tb.edge_src.numpy()[em]
    assert np.all(np.diff(src) >= 0)
    assert not np.all(np.diff(tb.edge_src.numpy()) >= 0)  # tail pads at 0
    assert np.all(np.diff(tb.node_graph.numpy()[src]) >= 0)
    outdeg = np.zeros(tb.num_nodes, np.float32)
    np.add.at(outdeg, src, 1.0)
    np.testing.assert_array_equal(tb.in_degree.numpy(), outdeg)


# --------------------------------------------------------------- converter


def test_converter_carries_a_megnet_tree_both_ways(toy_dataset, jax_megnets):
    hp, params, stats = jax_megnets("set2set", "early")[:3]
    assert {"set2set_x", "set2set_e", "e_embed0", "conv1"} <= set(params)
    assert set(params["set2set_x"]["lstm"]) == {"w_ih", "w_hh", "b_ih", "b_hh"}
    sd = params_from_jax(params, stats)
    assert sd["set2set_e.lstm.weight_ih"].shape == (32, 16)
    assert sd["conv0.edge_mlp.bn1.running_var"].shape == (8,)
    model = _port_model(toy_dataset, "MEGNet", hp, params, stats)
    p2, s2 = params_to_jax(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for (ka, a), (kb, b) in zip(flat(params), flat(p2)):
        assert ka == kb
        np.testing.assert_array_equal(b, a)
    for (_, a), (_, b) in zip(flat(stats), flat(s2)):
        np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------------ model


HEADS = [("global_mean_pool", "early"), ("global_mean_pool", "late"),
         ("set2set", "early"), ("set2set", "late")]


@pytest.fixture(scope="module")
def jax_megnets(toy_dataset):
    """(pool, order) -> the JAX MEGNet's parameters, its eval outputs on the
    plain IDS batch, and its training-mode outputs and gradients on the
    plain ALL_IDS batch (the cotangent `cot`), computed once for the three
    kinds of port batch. Training mode runs on all 16 toy graphs: u is
    zero in these datasets, so the u embeddings add the same row to every
    graph ahead of the blocks' BatchNorms and their gradients are sums
    that nearly cancel; at six graphs both packages' f32 gradients sit
    1-2.5e-4 of a layer's largest from an f64 run of the port."""
    cache = {}

    def get(pool, order):
        if (pool, order) not in cache:
            hp = {**HP, "pool": pool, "pool_order": order}
            model, (params, stats) = _jax_model(toy_dataset, "MEGNet", hp)
            jb, _ = _batches(toy_dataset, "xla")
            ref = model.apply({"params": params, "batch_stats": stats}, jb,
                              training=False)
            jb_all, _ = _batches(toy_dataset, "xla", ALL_IDS)
            gm = np.asarray(jb_all.graph_mask)
            cot = np.random.default_rng(4).standard_normal(gm.shape).astype(
                np.float32) * gm

            def jloss(p):
                o, _ = model.apply({"params": p, "batch_stats": stats}, jb_all,
                                   training=True, mutable=["batch_stats"])
                return jnp.sum(o * cot), o

            (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
            cache[pool, order] = (hp, params, stats, np.asarray(ref),
                                  np.asarray(jb.graph_mask) > 0, cot,
                                  np.asarray(jout), params_from_jax(
                                      _tree(jgrads)))
        return cache[pool, order]

    return get


@pytest.mark.parametrize("kind", ["xla", "csr", "pallas"])
@pytest.mark.parametrize("pool,order", HEADS)
def test_megnet_matches_jax(toy_dataset, jax_megnets, pool, order, kind):
    """Eval mode (random BatchNorm statistics), then training mode with every
    parameter gradient: the JAX MEGNet on its plain batch against the port
    on each of its kernels' batches."""
    ds = toy_dataset
    hp, params, stats, ref, gm, cot, jout, jgrads = jax_megnets(pool, order)
    tb = _port_batch(ds, kind)
    tmodel = _port_model(ds, "MEGNet", hp, params, stats).eval()
    with torch.no_grad():
        out = tmodel(tb)
    assert np.isfinite(out.numpy()).all()
    _close(out.numpy()[gm], ref[gm], 2e-4, "eval outputs")

    tb = _port_batch(ds, kind, ALL_IDS)
    g = cot != 0
    tmodel.train()
    out = tmodel(tb)
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy()[g], jout[g], 2e-4, "training outputs")
    # late pooling reads no u: the last block's global MLP gets no gradient
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in tmodel.named_parameters()}
    _close_grads(got, {k: v.numpy() for k, v in jgrads.items()}, 2e-4)


@pytest.mark.parametrize("order", ["early", "late"])
def test_set2set_on_the_cgcnn_head(toy_dataset, order):
    """Set2Set through models/base.py's head, for any model: early doubles
    the width into post_lin0, late runs Set2Set(output_dim) and lin_out_2."""
    ds = toy_dataset
    hp = {"dim1": 12, "dim2": 10, "gc_count": 2, "post_fc_count": 1,
          "pool": "set2set", "pool_order": order}
    model, (params, stats) = _jax_model(ds, "CGCNN", hp)
    jb, tb = _batches(ds, "xla")
    ref = model.apply({"params": params, "batch_stats": stats}, jb,
                      training=False)
    tmodel = _port_model(ds, "CGCNN", hp, params, stats).eval()
    if order == "early":
        assert tmodel.post_lin0.weight.shape == (10, 24)
    else:
        assert tmodel.lin_out_2.weight.shape == (1, 2)
    with torch.no_grad():
        out = tmodel(tb)
    gm = np.asarray(jb.graph_mask) > 0
    _close(out.numpy()[gm], np.asarray(ref)[gm], 2e-4, "outputs")


def test_remat_keeps_megnet_gradients_and_statistics(toy_dataset):
    """MEGNet's blocks hold BatchNorm and dropout: under remat the
    recomputation replays the same dropout masks and updates no running
    statistic a second time."""
    ds = toy_dataset
    tb = _port_batch(ds, "csr")
    hp = {**HP, "dropout_rate": 0.3}
    models = [build_model("MEGNet", ds, {**hp, "remat": r},
                          generator=torch.Generator().manual_seed(0),
                          dropout_seed=5, device="cpu").train()
              for r in (False, True)]
    for _ in range(2):
        outs = []
        for m in models:
            m.zero_grad()
            out = m(tb)
            (out * tb.graph_mask).sum().backward()
            outs.append(out.detach())
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
        for (k, a), (_, b) in zip(models[0].state_dict().items(),
                                  models[1].state_dict().items()):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
        for (k, a), (_, b) in zip(models[0].named_parameters(),
                                  models[1].named_parameters()):
            torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=1e-7,
                                       msg=k)


def test_bias_gradient_cancels_behind_batchnorm(toy_dataset, jax_megnets):
    """In a MEGNetMLP a Linear's bias feeds the activation, then a
    training-mode BatchNorm: on each feature where the ReLU passes every
    real row, the bias shifts all rows alike and the BatchNorm takes the
    shift out again, so its gradient is zero but for rounding, in JAX and
    in the port (why the trainer parity below runs without BatchNorm)."""
    ds = toy_dataset
    hp, params, stats, *_, jgrads = jax_megnets("global_mean_pool", "early")
    tb = _port_batch(ds, "xla", ALL_IDS)
    cot = jax_megnets("global_mean_pool", "early")[5]
    model = _port_model(ds, "MEGNet", hp, params, stats).train()
    pre, masks = {}, {}
    for name, mod in model.named_modules():
        if re.fullmatch(r"conv\d\.(edge|node|global)_mlp\.lin\d", name):
            mod.register_forward_hook(
                lambda m, i, o, name=name: pre.__setitem__(name, o.detach()))
            part = name.split(".")[1]
            masks[name] = {"edge_mlp": tb.edge_mask, "node_mlp": tb.node_mask,
                           "global_mlp": tb.graph_mask}[part] > 0
    (model(tb) * torch.as_tensor(cot)).sum().backward()
    checked, mixed = 0, []
    for name, z in pre.items():
        active = (z[masks[name]] > 0).numpy()
        passing, some = active.all(0), active.any(0) & ~active.all(0)
        scale = float(model.get_submodule(name).weight.grad.abs().max())
        assert scale > 1e-3
        for grads in ({k: v.numpy() for k, v in jgrads.items()},
                      {k: p.grad.numpy() for k, p in model.named_parameters()}):
            g = np.abs(grads[f"{name}.bias"])
            assert float(g[passing].max(initial=0.0)) < 1e-5 * scale, name
            mixed.append(float(g[some].max(initial=0.0)) / scale)
        checked += int(passing.sum())
    assert checked >= 8
    assert max(mixed) > 1e-2  # where the ReLU cuts some rows, it does not


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def jax_training(toy_dataset):
    """JAX setup_run + run_fused_training, three epochs, kernel xla."""
    ds = toy_dataset
    idx = JD.split_data(ds, 0.7, 0.15, 0.15, seed=9)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = JJ.setup_run(ds, {**MODEL, "kernel": "xla"}, "l1_loss", seed=9)
        init = params_from_jax(_tree(run.state.params),
                               _tree(run.state.batch_stats or {}))
        JJ.run_fused_training(run, train_idx=idx[0], val_idx=idx[1], epochs=3,
                              verbosity=1, seed=9)
    epochs = [tuple(float(v) for v in m.groups()[1:])
              for m in EPOCH_LINE.finditer(buf.getvalue())]
    return idx, init, epochs


@pytest.mark.parametrize("kernel", ["xla", "csr", "pallas", "fused"])
def test_megnet_trainer_matches_jax_three_epochs(toy_dataset, jax_training,
                                                 kernel):
    (train_idx, val_idx, _), init, jepochs = jax_training
    run = TJ.setup_run(toy_dataset, {**MODEL, "kernel": kernel}, "l1_loss",
                       seed=9, device="cpu")
    assert run.data.src_sorted == (kernel == "csr")
    assert (run.data.windowed is not None) == (kernel in ("pallas", "fused"))
    run.model.load_state_dict(init)
    _, _, history = TJ.run_fused_training(
        run, train_idx=train_idx, val_idx=val_idx, epochs=3, verbosity=1,
        seed=9)
    assert len(jepochs) == len(history) == 3
    for e, ((lr, tr, va), (ptr, pva, plr)) in enumerate(zip(jepochs, history)):
        assert np.isfinite([ptr, pva]).all()
        _close(ptr, tr, 2e-3, f"epoch {e + 1} train", 1.0)
        _close(pva, va, 2e-3, f"epoch {e + 1} val", 1.0)
        _close(plr, lr, 1e-6, f"epoch {e + 1} lr", 1.0)


# ------------------------------------------------------ jobs, CLI, Predict


def test_resolve_kernel_for_megnet(capsys):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    plan = lambda p: (p.name, p.edge_order, p.fused, p.windowed)
    want = {("auto", cpu): ("xla", None, False, False),
            ("auto", cuda): ("csr", "src", False, False),
            ("csr", cpu): ("csr", "src", False, False),
            ("pallas", cuda): ("pallas", None, False, True),
            ("xla", cuda): ("xla", None, False, False)}
    for batching in ("padded", "packed"):
        for (kernel, dev), p in want.items():
            assert plan(TJ.resolve_kernel("MEGNet", kernel, batching, dev)) == p
    assert TJ.resolve_kernel("MEGNet", "csr", "padded", cpu,
                             csr_order="dst").edge_order == "dst"
    capsys.readouterr()
    assert plan(TJ.resolve_kernel("MEGNet", "fused", "padded", cuda)) == (
        "pallas", None, False, True)
    assert "other models run the windowed aggregation kernel" in \
        capsys.readouterr().out
    assert TJ.csr_side("MEGNet") == "src" and TJ.csr_side("CGCNN") == "dst"


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return (rows[0], [r[0] for r in rows[1:]],
            np.array([float(r[2]) for r in rows[1:]]))


def test_predict_matches_jax_on_a_jax_trained_megnet(toy_dataset, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    JJ.train_regular(toy_dataset, {"job_name": "jt", "seed": 3,
                                   "model_path": "jax.ckpt",
                                   "write_output": "False"},
                     tp, {**MODEL, "epochs": 2, "kernel": "xla"})
    meta, raw = j_load("jax.ckpt")
    assert meta["model_name"] == "MEGNet"
    params, batch_stats = params_from_raw(raw)
    save_checkpoint("port.ckpt", params_from_jax(_tree(params),
                                                 _tree(batch_stats)),
                    meta["model_name"], meta["model_config"])
    jerr = JJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "jax.ckpt", "job_name": "jax"})
    seen = []
    real = TB.DeviceDataset.from_graph_dataset

    def spy(ds, device, edge_order=None, **kw):
        seen.append(edge_order)
        return real(ds, device, edge_order=edge_order, **kw)

    monkeypatch.setattr(TJ.DeviceDataset, "from_graph_dataset", spy)
    terr = TJ.predict(toy_dataset, "l1_loss",
                      {"model_path": "port.ckpt", "job_name": "port"},
                      device="cpu")
    assert seen == ["src"]
    jh, jids, jp = _read_csv("jax_predicted_outputs.csv")
    th, tids, tpred = _read_csv("port_predicted_outputs.csv")
    assert th == jh and tids == jids == toy_dataset.structure_ids
    np.testing.assert_allclose(tpred, jp, rtol=1e-4, atol=1e-4)
    assert abs(terr - jerr) <= 1e-4


def test_chip_smoke_megnet_demo_matches_config_yml():
    import chip_smoke

    with open(os.path.join(REPO, "config.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.MEGNET_DEMO == cfg["Models"]["MEGNet_demo"]
    tcfg = chip_smoke.training_config("d", "m.ckpt", "j", "cpu", 2,
                                      model=chip_smoke.MEGNET_DEMO)
    assert tcfg["Models"]["model"] == "MEGNet"
    assert tcfg["Models"]["gc_fc_count"] == 1
