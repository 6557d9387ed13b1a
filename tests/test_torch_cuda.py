"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where they are not
installed, without the repository's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: gather bit-exact; segment-sum rtol 1e-5 and atol
1e-5·max|ref|, because its atomics reorder the additions; the fused CGConv
and cfconv kernels and the bilinear NNConv kernels rtol 1e-4 and atol
1e-4·max|ref| (atomics, and sums over every edge or hidden unit in another
order than the plain version's GEMMs); whole-model outputs and gradients
1e-4 against the same model on the CPU; a short training run's errors 1e-3
against the CPU. The bilinear, CGConv and cfconv weight gradients are
bit-identical between two calls. The CGConv forward and the cfconv
forward and backward are also held to their plain versions at every width
bucket of their wgmma tiles (D and F 1 to 256) and at edge counts off
every tile size, an all-pad batch giving exact zeros. The windowed sums (fixed order) rtol 1e-5 and atol 1e-5·max|ref|
and bit-identical between two calls, also at edge counts off every tile,
with spare tiles on the last window and any dst order inside a tile, D 1
to 300 and tw 64 and 512; the windowed gather bit-exact.
"""

import numpy as np
import pytest
import torch

from matdeeplearn_torch.ops import csr
from matdeeplearn_torch.ops import fused_bilinear as FB
from matdeeplearn_torch.ops import fused_cfconv as FS
from matdeeplearn_torch.ops import fused_cgconv as FC


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(rng, case, n_real=1500, n=2048, pad_to=12000):
    """Hole-free dst runs + tail pads at dst 0 (mask 0)."""
    deg = rng.integers(1, 14, n_real)
    dst = np.repeat(np.arange(n_real), deg).astype(np.int32)
    e_real = len(dst)
    mask = np.zeros(pad_to, np.float32)
    mask[:e_real] = 1.0
    dst = np.concatenate([dst, np.zeros(pad_to - e_real, np.int32)])
    if case == "unsorted":
        perm = rng.permutation(pad_to)
        dst, mask = dst[perm], mask[perm]
    elif case == "scattered":
        mask *= (rng.random(pad_to) > 0.3).astype(np.float32)
    elif case == "nomask":
        mask = None
    return dst, mask, n


def _assert_sum_close(out, ref):
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("case", ["sorted", "unsorted", "scattered", "nomask"])
@pytest.mark.parametrize("d", [1, 3, 100, 150, 300])
def test_kernels_match_plain(cuda_device, case, d):
    rng = np.random.default_rng(d)
    dst, mask, n = _problem(rng, case)
    dv = torch.as_tensor(dst, device=cuda_device)
    mv = None if mask is None else torch.as_tensor(mask, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    msg = torch.randn(len(dst), d, device=cuda_device, generator=g,
                      requires_grad=True)
    x = torch.randn(n, d, device=cuda_device, generator=g, requires_grad=True)
    cot_n = torch.randn(n, d, device=cuda_device, generator=g)
    cot_e = torch.randn(len(dst), d, device=cuda_device, generator=g)

    out = csr.sorted_segment_sum(msg, dv, mv, n)
    _assert_sum_close(out, csr.segment_sum_plain(msg.detach(), dv, mv, n))
    (out * cot_n).sum().backward()
    assert torch.equal(msg.grad, csr.gather_plain(cot_n, dv, mv))

    gout = csr.sorted_gather(x, dv, mv)
    assert torch.equal(gout, csr.gather_plain(x.detach(), dv, mv))
    (gout * cot_e).sum().backward()
    _assert_sum_close(x.grad, csr.segment_sum_plain(cot_e, dv, mv, n))


def test_each_call_counts_one_launch(cuda_device):
    dst, mask, n = _problem(np.random.default_rng(0), "sorted")
    dv = torch.as_tensor(dst, device=cuda_device)
    mv = torch.as_tensor(mask, device=cuda_device)
    x = torch.randn(n, 8, device=cuda_device)
    before = dict(csr.LAUNCHES)
    e = csr.gather(x, dv, mv)
    csr.segment_sum(e, dv, mv, n)
    torch.cuda.synchronize()
    assert csr.LAUNCHES["gather"] == before["gather"] + 1
    assert csr.LAUNCHES["segment_sum"] == before["segment_sum"] + 1


def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    dst, mask, n = _problem(np.random.default_rng(1), "sorted")
    dv = torch.as_tensor(dst, device=cuda_device)
    mv = torch.as_tensor(mask, device=cuda_device)
    x = torch.randn(8, n, device=cuda_device).t()  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        csr.gather(x, dv, mv)
    with pytest.raises(ValueError, match="int32"):
        csr.segment_sum(torch.randn(len(dst), 4, device=cuda_device),
                        dv.long(), mv, n)


def test_cgcnn_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small CGCNN on dst-sorted batches: outputs and parameter gradients
    on the card (CSR kernels) against the CPU (plain versions)."""
    import chip_smoke
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.models import build_model

    chip_smoke.write_structures(str(tmp_path), n=24)
    ds = get_dataset(str(tmp_path), 0, "False",
                     {"graph_max_radius": 6.0, "graph_max_neighbors": 8,
                      "verbose": "False"})
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = {"dim1": 32, "dim2": 24, "gc_count": 3, "post_fc_count": 2}
    model = build_model("CGCNN", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("CGCNN", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.eval()
        batch = assemble_batch(
            DeviceDataset.from_graph_dataset(ds, dev, edge_order="dst"), ids, spec)
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * max(float(g.abs().max()), 1e-6),
                                   msg=lambda m, k=k: f"{k}: {m}")


def _fused_inputs(case, d, de=50, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    dst, mask, n = _problem(rng, case)
    e = len(dst)
    g = torch.Generator().manual_seed(seed)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(device)
    x, xj = t(n, d), t(e, d)
    dist = torch.rand(e, generator=g).to(device)
    ws = [t(d, d, s=0.1), t(d, d, s=0.1), t(de, d, s=0.1), t(d, s=0.1),
          t(d, d, s=0.1), t(d, d, s=0.1), t(de, d, s=0.1), t(d, s=0.1)]
    return (x, xj, dist, torch.as_tensor(dst, device=device),
            torch.as_tensor(mask, device=device), ws, n)


def _assert_fused_close(out, ref, name):
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * max(float(ref.abs().max()), 1e-30),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("case", ["sorted", "unsorted", "scattered"])
@pytest.mark.parametrize("d", [3, 100, 150, 256])
def test_fused_cgconv_kernels_match_plain(cuda_device, case, d):
    x, xj, dist, dst, mask, ws, n = _fused_inputs(case, d, device=cuda_device)
    out = FC.fused_cgconv(x, xj, dist, dst, mask, *ws, n, 0.2)
    _assert_fused_close(out, FC.fused_cgconv_plain(x, xj, dist, dst, mask, *ws,
                                                   n, 0.2), "forward")
    g = torch.randn(n, d, device=cuda_device)
    got = FC.fused_cgconv_bwd(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    ref = FC.fused_cgconv_bwd_plain(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    names = ["x", "xj", "wfi", "wfj", "wfe", "bf", "wsi", "wsj", "wse", "bs"]
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        _assert_fused_close(a, b, f"d_{name}")
    # pad edges get zero d_xj rows
    assert float(got[1][mask == 0].abs().max()) == 0.0


@pytest.mark.parametrize("d", [3, 100, 150, 256])
def test_fused_cgconv_backward_stages_match_plain(cuda_device, d):
    """Each kernel of the backward against its plain stage: the edge
    kernel's d_x, d_xj and the dA rows of real edges, and every slice of
    the weight-gradient kernel (scattered mask, so chunks mix real and
    masked edges)."""
    x, xj, dist, dst, mask, ws, n = _fused_inputs("scattered", d,
                                                  device=cuda_device)
    g = torch.randn(n, d, device=cuda_device)
    args = (x, xj, dist, dst, mask, *ws, n, 0.2)
    rows = FC.fused_cgconv_bwd_rows(g, *args)
    ref = FC.bwd_rows_plain(g, *args)
    real = mask != 0
    for name, a, b in zip(["d_x", "d_xj", "da"], rows[:2] + (rows[2][real],),
                          ref[:2] + (ref[2][real],)):
        _assert_fused_close(a, b, name)
    partial, slices = FC.fused_cgconv_wgrad(x, xj, dist, dst, mask, rows[2],
                                            n, 50, 0.2)
    want = FC.wgrad_partials_plain(x, xj, dist, dst, mask, ref[2], n, 50, 0.2,
                                   slices)
    k1 = 2 * d + 51
    _assert_fused_close(FC.from_partial_layout(partial, k1, 2 * d),
                        FC.from_partial_layout(want, k1, 2 * d), "slices")


def test_fused_cgconv_autograd_and_launch_counts(cuda_device):
    x, xj, dist, dst, mask, ws, n = _fused_inputs("sorted", 16,
                                                  device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in [x, xj] + ws]
    before = dict(FC.LAUNCHES)
    out = FC.FusedCGConv.apply(leaves[0], leaves[1], dist, dst, mask,
                             *leaves[2:], n, 0.2)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert set(FC.LAUNCHES) == {"fused_cgconv_fwd", "fused_cgconv_bwd",
                                "fused_cgconv_wgrad",
                                "fused_cgconv_wgrad_reduce"}
    for k in FC.LAUNCHES:
        assert FC.LAUNCHES[k] == before[k] + 1, k
    ref = FC.fused_cgconv_bwd_plain(cot, x, xj, dist, dst, mask, *ws, n, 0.2)
    for leaf, r in zip(leaves, ref):
        _assert_fused_close(leaf.grad, r, "autograd")


def test_fused_cgconv_wgrad_is_bit_identical(cuda_device):
    """No atomics touch the weight gradient: two calls give the same bits."""
    x, xj, dist, dst, mask, ws, n = _fused_inputs("unsorted", 100,
                                                  device=cuda_device)
    g = torch.randn(n, 100, device=cuda_device)
    first = FC.fused_cgconv_bwd(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    again = FC.fused_cgconv_bwd(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    for a, b in zip(first[2:], again[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,blocks", [(100, 7), (100, 66), (3, 264)])
def test_wgrad_reduce_matches_plain(cuda_device, d, blocks):
    de = 50
    floats = FC._load().mdl_fused_cgconv_partial_floats(d, de)
    partial = torch.randn(blocks * floats, device=cuda_device)
    _assert_fused_close(FC.wgrad_reduce(partial, blocks, d, de),
                        FC.wgrad_reduce_plain(partial, d, de), "reduce")


def test_fused_cgconv_raises_instead_of_falling_back(cuda_device):
    x, xj, dist, dst, mask, ws, n = _fused_inputs("sorted", 8,
                                                  device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        FC.fused_cgconv(x, xj, dist, dst.long(), mask, *ws, n, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        FC.fused_cgconv(x, xj.t().contiguous().t(), dist, dst, mask, *ws, n,
                        0.2)
    wide = _fused_inputs("sorted", 300, device=cuda_device)
    with pytest.raises(ValueError, match="wider"):
        FC.fused_cgconv(*wide[:5], *wide[5], wide[6], 0.2)


def _edge_problem(e, n, real, seed):
    """e edge slots over n nodes: sorted random dst for the first `real`,
    then pads at dst 0 with mask 0 (real = 0: an all-pad batch)."""
    rng = np.random.default_rng(seed)
    dst = np.zeros(e, np.int32)
    dst[:real] = np.sort(rng.integers(0, n, real))
    mask = np.zeros(e, np.float32)
    mask[:real] = 1.0
    return dst, mask


# widths across every n8-tile bucket and the warpgroup split at D = 128;
# edge counts off the 64- and 128-edge tiles and the 32-edge chunks
TILING_WIDTHS = [1, 3, 33, 100, 150, 152, 200, 256]
TILING_EDGES = [(1, 1), (97, 97), (200, 171), (333, 0)]


@pytest.mark.parametrize("e,real", TILING_EDGES)
@pytest.mark.parametrize("d", TILING_WIDTHS)
def test_fused_cgconv_fwd_matches_plain_at_tiling_edges(cuda_device, d, e,
                                                        real):
    dst, mask = _edge_problem(e, 40, real, d * 1000 + e)
    g = torch.Generator().manual_seed(d + e)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(
        cuda_device)
    x, xj = t(40, d), t(e, d)
    dist = torch.rand(e, generator=g).to(cuda_device)
    ws = [t(d, d, s=0.1), t(d, d, s=0.1), t(50, d, s=0.1), t(d, s=0.1),
          t(d, d, s=0.1), t(d, d, s=0.1), t(50, d, s=0.1), t(d, s=0.1)]
    args = (x, xj, dist, torch.as_tensor(dst, device=cuda_device),
            torch.as_tensor(mask, device=cuda_device), *ws, 40, 0.2)
    out = FC.fused_cgconv(*args)
    if real == 0:
        assert float(out.abs().max()) == 0.0
    else:
        _assert_fused_close(out, FC.fused_cgconv_plain(*args), "forward")


def _cfconv_tiling(f, e, real, device):
    dst, mask = _edge_problem(e, 40, real, f * 1000 + e)
    g = torch.Generator().manual_seed(f + e)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(device)
    xj = t(e, f)
    dist = torch.rand(e, generator=g).to(device)
    wraw = (8.0 * torch.rand(e, generator=g)).to(device)
    ws = [t(50, f, s=0.3), t(f, s=0.3), t(f, f, s=0.3), t(f, s=0.3)]
    return (xj, dist, wraw, torch.as_tensor(dst, device=device),
            torch.as_tensor(mask, device=device), *ws, 40, 0.2, 8.0)


@pytest.mark.parametrize("e,real", TILING_EDGES)
@pytest.mark.parametrize("f", TILING_WIDTHS)
def test_fused_cfconv_fwd_matches_plain_at_tiling_edges(cuda_device, f, e,
                                                        real):
    args = _cfconv_tiling(f, e, real, cuda_device)
    out = FS.fused_cfconv(*args)
    if real == 0:
        assert float(out.abs().max()) == 0.0
    else:
        _assert_fused_close(out, FS.fused_cfconv_plain(*args), "forward")


@pytest.mark.parametrize("e,real", TILING_EDGES)
@pytest.mark.parametrize("f", TILING_WIDTHS)
def test_fused_cfconv_bwd_matches_plain_at_tiling_edges(cuda_device, f, e,
                                                        real):
    args = _cfconv_tiling(f, e, real, cuda_device)
    cot = torch.randn(40, f, device=cuda_device)
    got = FS.fused_cfconv_bwd(cot, *args)
    ref = FS.fused_cfconv_bwd_plain(cot, *args)
    if real == 0:
        assert float(got[0].abs().max()) == 0.0
        for a in got[1:]:
            assert float(a.abs().max()) == 0.0
        return
    for name, a, b in zip(["xj", "w0", "b0", "w1", "b1"], got, ref):
        _assert_fused_close(a, b, f"d_{name}")
    assert not got[0][args[4] == 0].any()


@pytest.mark.parametrize("f", [3, 150, 256])
def test_fused_cfconv_backward_stages_match_plain(cuda_device, f):
    """Each kernel of the backward against its plain stage: the edge
    kernel's d_xj and its a, dw and dpre rows of real edges, and every
    slice of the weight-gradient kernel (scattered mask)."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("scattered", f,
                                                      device=cuda_device)
    g = torch.randn(n, f, device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    rows = FS.fused_cfconv_bwd_rows(g, *args)
    ref = FS.bwd_rows_plain(g, *args)
    real = FS.edge_scale(wraw, dst, mask, n, 8.0) != 0
    _assert_fused_close(rows[0], ref[0], "d_xj")
    for name, a, b in zip(["a", "dw", "dpre"], rows[1:], ref[1:]):
        _assert_fused_close(a[real], b[real], name)
    edges = (dist, wraw, dst, mask)
    partial, slices = FS.fused_cfconv_wgrad(*edges, *rows[1:], n, f, 50, 0.2,
                                            8.0)
    want = FS.wgrad_partials_plain(*edges, *ref[1:], n, f, 50, 0.2, 8.0,
                                   slices)
    _assert_fused_close(partial, want, "slices")


def test_fused_cfconv_wgrad_launch_is_bit_identical(cuda_device):
    """The weight-gradient kernel writes its slices without atomics: two
    calls give the same bits."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("unsorted", 150,
                                                      device=cuda_device)
    g = torch.randn(n, 150, device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    rows = FS.fused_cfconv_bwd_rows(g, *args)
    edges = (dist, wraw, dst, mask)
    first = FS.fused_cfconv_wgrad(*edges, *rows[1:], n, 150, 50, 0.2, 8.0)
    again = FS.fused_cfconv_wgrad(*edges, *rows[1:], n, 150, 50, 0.2, 8.0)
    assert first[1] == again[1]
    assert torch.equal(first[0], again[0])


def _toy(tmp_path, n=24):
    import chip_smoke
    from matdeeplearn_torch.data.dataset import get_dataset

    chip_smoke.write_structures(str(tmp_path), n=n)
    return get_dataset(str(tmp_path), 0, "False",
                       {"graph_max_radius": 6.0, "graph_max_neighbors": 8,
                        "verbose": "False"})


def test_fused_cgcnn_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small CGCNN on batches marked for the fused kernel, in training
    mode: outputs and parameter gradients on the card (fused kernels)
    against the CPU (plain versions)."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = {"dim1": 32, "dim2": 24, "gc_count": 3, "post_fc_count": 2}
    model = build_model("CGCNN", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("CGCNN", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        batch = assemble_batch(DeviceDataset.from_graph_dataset(
            ds, dev, edge_order="dst", kernel_fused=True), ids, spec)
        before = FC.LAUNCHES["fused_cgconv_bwd"]
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        if dev != "cpu":
            assert FC.LAUNCHES["fused_cgconv_bwd"] == before + 3
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * max(float(g.abs().max()), 1e-6),
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_training_on_cuda_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """train_regular on the card (fused kernels, capturable AdamW) and on
    the CPU (plain versions): the same errors, to 1e-3."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": "CGCNN", "dim1": 32, "dim2": 24, "gc_count": 2,
          "post_fc_count": 1, "batch_size": 8, "epochs": 3, "lr": 0.005,
          "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": "fused",
          "print_model": False}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"t_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=1e-3, atol=1e-3, err_msg=split)


def test_training_resumes_across_devices(cuda_device, tmp_path, monkeypatch):
    """A checkpoint Training saved on the CPU resumes on the card, and one
    saved on the card resumes on the CPU (load_model: "True")."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=30)
    monkeypatch.chdir(tmp_path)
    mp = {"model": "CGCNN", "dim1": 16, "dim2": 12, "gc_count": 2,
          "post_fc_count": 1, "batch_size": 8, "epochs": 1, "lr": 0.005,
          "kernel": "fused", "print_model": False}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    jp = {"seed": 5, "write_output": "False", "model_path": "m.ckpt"}
    jobs.train_regular(ds, {**jp, "job_name": "a"}, tp, mp, device="cpu")
    for dev in ("cuda", "cpu", "cuda"):
        errors = jobs.train_regular(ds, {**jp, "job_name": dev,
                                         "load_model": "True"}, tp, mp,
                                    device=dev)
        assert np.isfinite(list(errors.values())).all(), dev


def _cfconv_inputs(case, f, de=50, cutoff=8.0, seed=0, device="cuda"):
    """xj, dist, raw distances up to the cutoff, dst, mask and the four
    filter parameters of one cfconv at width f."""
    rng = np.random.default_rng(seed)
    dst, mask, n = _problem(rng, case)
    e = len(dst)
    g = torch.Generator().manual_seed(seed)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(device)
    xj = t(e, f)
    dist = torch.rand(e, generator=g).to(device)
    wraw = (cutoff * torch.rand(e, generator=g)).to(device)
    ws = [t(de, f, s=0.3), t(f, s=0.3), t(f, f, s=0.3), t(f, s=0.3)]
    return (xj, dist, wraw, torch.as_tensor(dst, device=device),
            torch.as_tensor(mask, device=device), ws, n)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "scattered"])
@pytest.mark.parametrize("f", [3, 100, 150, 256])
def test_fused_cfconv_kernels_match_plain(cuda_device, case, f):
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs(case, f,
                                                      device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    _assert_fused_close(FS.fused_cfconv(*args), FS.fused_cfconv_plain(*args),
                        "forward")
    g = torch.randn(n, f, device=cuda_device)
    got = FS.fused_cfconv_bwd(g, *args)
    ref = FS.fused_cfconv_bwd_plain(g, *args)
    for name, a, b in zip(["xj", "w0", "b0", "w1", "b1"], got, ref):
        assert a.shape == b.shape, name
        _assert_fused_close(a, b, f"d_{name}")
    assert float(got[0][mask == 0].abs().max()) == 0.0


def test_fused_cfconv_autograd_and_launch_counts(cuda_device):
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("sorted", 16,
                                                      device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in [xj] + ws]
    before = dict(FS.LAUNCHES)
    out = FS.FusedCFConv.apply(leaves[0], dist, wraw, dst, mask, *leaves[1:],
                               n, 0.2, 8.0)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    for k in FS.LAUNCHES:
        assert FS.LAUNCHES[k] == before[k] + 1, k
    ref = FS.fused_cfconv_bwd_plain(cot, xj, dist, wraw, dst, mask, *ws, n,
                                    0.2, 8.0)
    for leaf, r in zip(leaves, ref):
        _assert_fused_close(leaf.grad, r, "autograd")


@pytest.mark.parametrize("f,blocks", [(3, 7), (150, 7), (150, 264)])
def test_cfconv_wgrad_reduce_matches_plain(cuda_device, f, blocks):
    de = 50
    floats = FS._load().mdl_fused_cfconv_partial_floats(f, de)
    partial = torch.randn(blocks * floats, device=cuda_device)
    _assert_fused_close(FS.wgrad_reduce(partial, blocks, f, de),
                        FS.wgrad_reduce_plain(partial, f, de), "reduce")


def test_fused_cfconv_wgrad_is_bit_identical(cuda_device):
    """The cfconv weight gradients (per-block partials, then the fixed-order
    sum) give the same bits in two calls."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("unsorted", 150,
                                                      device=cuda_device)
    g = torch.randn(n, 150, device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    first, again = FS.fused_cfconv_bwd(g, *args), FS.fused_cfconv_bwd(g, *args)
    for a, b in zip(first[1:], again[1:]):
        assert torch.equal(a, b)


def test_fused_cfconv_raises_instead_of_falling_back(cuda_device):
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("sorted", 8,
                                                      device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        FS.fused_cfconv(xj, dist, wraw, dst.long(), mask, *ws, n, 0.2, 8.0)
    with pytest.raises(ValueError, match="contiguous"):
        FS.fused_cfconv(xj.t().contiguous().t(), dist, wraw, dst, mask, *ws,
                        n, 0.2, 8.0)
    wide = _cfconv_inputs("sorted", 300, device=cuda_device)
    with pytest.raises(ValueError, match="wider"):
        FS.fused_cfconv(*wide[:5], *wide[5], wide[6], 0.2, 8.0)


def test_fused_schnet_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small SchNet on batches marked for the fused kernel, in training
    mode: outputs and parameter gradients on the card (cfconv kernels)
    against the CPU (plain versions)."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = {"dim1": 32, "dim2": 24, "dim3": 40, "cutoff": 6, "gc_count": 3,
          "post_fc_count": 2}
    model = build_model("SchNet", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("SchNet", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        batch = assemble_batch(DeviceDataset.from_graph_dataset(
            ds, dev, edge_order="dst", kernel_fused=True), ids, spec)
        before = FS.LAUNCHES["fused_cfconv_bwd"]
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        if dev != "cpu":
            assert FS.LAUNCHES["fused_cfconv_bwd"] == before + 3
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    # atol from each layer's largest gradient: the bias of each block's
    # `lin` feeds a training-mode BatchNorm, so its gradient is a sum that
    # cancels to ~1e-8 and its own max says nothing of the f32 rounding
    layer_max = {}
    for k, g in g_cpu.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-6), float(g.abs().max()))
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * layer_max[k.rsplit(".", 1)[0]],
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("kernel", ["fused", "csr"])
def test_schnet_training_on_cuda_matches_cpu(cuda_device, tmp_path,
                                             monkeypatch, kernel):
    """train_regular of a small SchNet on the card and on the CPU (plain
    versions): the same errors, to 1e-3. Without BatchNorm: behind a
    training-mode BatchNorm the bias of each block's `lin` gets a gradient
    that cancels to ~1e-8, AdamW turns its rounding noise into steps of
    ±lr, and the eval-mode errors then follow the noise (ROADMAP §3)."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": "SchNet", "dim1": 32, "dim2": 24, "dim3": 40, "cutoff": 6,
          "batch_norm": "False",
          "gc_count": 2, "post_fc_count": 1, "batch_size": 8, "epochs": 3,
          "lr": 0.005, "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "print_model": False}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"s_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=1e-3, atol=1e-3, err_msg=split)


def _bilinear_inputs(case, d, h, k, seed=0, device="cuda"):
    """xj, a = relu(·) (zeros as the edge network gives them), w1, b1 and
    the mask of one NNConv message at widths (D, H, K)."""
    rng = np.random.default_rng(seed)
    _, mask, _ = _problem(rng, case)
    e = len(mask)
    g = torch.Generator().manual_seed(seed)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(device)
    return (t(e, d), torch.relu(t(e, h)), t(h, d * k, s=0.1), t(d * k, s=0.1),
            torch.as_tensor(mask, device=device))


@pytest.mark.parametrize("case", ["sorted", "unsorted", "scattered"])
@pytest.mark.parametrize("d,h,k", [(3, 7, 5), (100, 100, 100),
                                   (150, 100, 150), (256, 9, 256),
                                   (64, 20, 33)])
def test_fused_bilinear_kernels_match_plain(cuda_device, case, d, h, k):
    args = _bilinear_inputs(case, d, h, k, device=cuda_device)
    mask = args[-1]
    _assert_fused_close(FB.fused_bilinear(*args),
                        FB.fused_bilinear_plain(*args), "forward")
    g = torch.randn(len(mask), k, device=cuda_device)
    got = FB.fused_bilinear_bwd(g, *args)
    ref = FB.fused_bilinear_bwd_plain(g, *args)
    for name, a, b in zip(["xj", "a", "w1", "b1"], got, ref):
        assert a.shape == b.shape, name
        _assert_fused_close(a, b, f"d_{name}")
    off = mask == 0
    for a in (FB.fused_bilinear(*args), got[0], got[1]):
        assert float(a[off].abs().max()) == 0.0


# (150, 100, 150): K > 128, the weight gradient's two column blocks
@pytest.mark.parametrize("case,d,h,k", [("sorted", 100, 100, 100),
                                        ("scattered", 150, 100, 150)])
def test_fused_bilinear_wgrad_is_bit_identical(cuda_device, case, d, h, k):
    xj, a, _, _, mask = _bilinear_inputs(case, d, h, k, device=cuda_device)
    g = torch.randn(len(mask), k, device=cuda_device)
    first = FB.fused_bilinear_wgrad(g, xj, a, mask)
    assert torch.equal(FB.fused_bilinear_wgrad(g, xj, a, mask), first)


# (150, 100, 150): D > 104, two warps share a row's d_a
@pytest.mark.parametrize("case,d,h,k", [("sorted", 100, 100, 100),
                                        ("scattered", 150, 100, 150)])
def test_fused_bilinear_bwd_rows_is_bit_identical(cuda_device, case, d, h, k):
    args = _bilinear_inputs(case, d, h, k, device=cuda_device)
    g = torch.randn(len(args[-1]), k, device=cuda_device)
    d_xj, d_a = FB.fused_bilinear_bwd_rows(g, *args)
    again = FB.fused_bilinear_bwd_rows(g, *args)
    assert torch.equal(again[0], d_xj) and torch.equal(again[1], d_a)


# (E, D, H, K) at the edges of the tensor-core kernels' tiling: 32-row
# chunks of the flat reduction spanning several units (D 3, 33, 1), K not
# a multiple of 8, D > 128 (the forward's 64-edge tile; the backward to
# the rows' 64-edge tile past D 104, its 32-edge one past 208), H = 1, and
# edge counts that are not a multiple of the 128-edge tile or the 32-edge
# chunk
@pytest.mark.parametrize("e,d,h,k", [(1000, 3, 7, 5), (777, 33, 1, 9),
                                     (1001, 1, 3, 12), (515, 200, 12, 20),
                                     (129, 64, 1, 100), (4099, 100, 100, 100),
                                     (333, 130, 5, 129)])
def test_fused_bilinear_tiling_edges_match_plain(cuda_device, e, d, h, k):
    rng = np.random.default_rng(e + d + h + k)
    t = lambda *shape, s=1.0: torch.tensor(
        s * rng.standard_normal(shape), dtype=torch.float32, device=cuda_device)
    mask = torch.tensor((rng.random(e) > 0.3).astype(np.float32),
                        device=cuda_device)
    args = (t(e, d), torch.relu(t(e, h)), t(h, d * k, s=0.1), t(d * k, s=0.1),
            mask)
    _assert_fused_close(FB.fused_bilinear(*args),
                        FB.fused_bilinear_plain(*args), "forward")
    g = t(e, k)
    dw = FB.fused_bilinear_wgrad(g, *args[:2], mask)
    _assert_fused_close(dw, FB.wgrad_plain(g, *args[:2], mask, k), "dW")
    assert torch.equal(FB.fused_bilinear_wgrad(g, *args[:2], mask), dw)
    rows = FB.fused_bilinear_bwd_rows(g, *args)
    for name, got, ref in zip(["d_xj", "d_a"], rows,
                              FB.bwd_rows_plain(g, *args)):
        _assert_fused_close(got, ref, name)
    for t in (FB.fused_bilinear(*args), *rows):
        assert float(t[mask == 0].abs().max()) == 0.0


def test_fused_bilinear_all_pad_batch_gives_zeros(cuda_device):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 100, 100, 100,
                                           device=cuda_device)
    pad = torch.zeros_like(mask)
    g = torch.randn(len(mask), 100, device=cuda_device)
    assert not FB.fused_bilinear(xj, a, w1, b1, pad).any()
    assert not FB.fused_bilinear_wgrad(g, xj, a, pad).any()
    d_xj, d_a = FB.fused_bilinear_bwd_rows(g, xj, a, w1, b1, pad)
    assert not d_xj.any() and not d_a.any()


def test_fused_bilinear_autograd_and_launch_counts(cuda_device):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 16, 12, 8,
                                           device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (xj, a, w1, b1)]
    before = dict(FB.LAUNCHES)
    out = FB.FusedBilinear.apply(*leaves, mask)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    for key in FB.LAUNCHES:
        assert FB.LAUNCHES[key] == before[key] + 1, key
    ref = FB.fused_bilinear_bwd_plain(cot, xj, a, w1, b1, mask)
    for leaf, r in zip(leaves, ref):
        _assert_fused_close(leaf.grad, r, "autograd")


def test_fused_bilinear_raises_instead_of_falling_back(cuda_device):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 8, 4, 8,
                                           device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_bilinear(xj.t().contiguous().t(), a, w1, b1, mask)
    with pytest.raises(ValueError, match="float32"):
        FB.fused_bilinear(xj, a, w1, b1, mask.double())
    wide = _bilinear_inputs("sorted", 300, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="wider"):
        FB.fused_bilinear(*wide)


def _mpnn_hp(**kw):
    return {"dim1": 24, "dim2": 16, "dim3": 20, "gc_count": 3,
            "post_fc_count": 2, **kw}


def test_mpnn_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small MPNN on dst-sorted batches, in training mode: outputs and
    parameter gradients on the card (bilinear and CSR kernels) against the
    CPU (plain versions)."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    model = build_model("MPNN", ds, _mpnn_hp(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("MPNN", ds, _mpnn_hp(), device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        batch = assemble_batch(DeviceDataset.from_graph_dataset(
            ds, dev, edge_order="dst", kernel_fused=True), ids, spec)
        before = dict(FB.LAUNCHES)
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        if dev != "cpu":
            for key in FB.LAUNCHES:
                assert FB.LAUNCHES[key] == before[key] + 3, key
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    # atol from each layer's largest gradient: conv{i}.bias feeds a
    # training-mode BatchNorm, so its gradient cancels to rounding noise
    layer_max = {}
    for k, g in g_cpu.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-6), float(g.abs().max()))
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * layer_max[k.rsplit(".", 1)[0]],
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("kernel", ["fused", "csr"])
def test_mpnn_training_on_cuda_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                           kernel):
    """train_regular of a small MPNN on the card and on the CPU (plain
    versions): the same errors, to 1e-3. Without BatchNorm, for the reason
    the SchNet run above gives (conv{i}.bias behind BatchNorm)."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": "MPNN", **_mpnn_hp(gc_count=2, post_fc_count=1),
          "batch_norm": "False", "batch_size": 8, "epochs": 3, "lr": 0.005,
          "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "print_model": False}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"m_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=1e-3, atol=1e-3, err_msg=split)


# ------------------------------------------------------- windowed kernels


def _windowed_problem(rng, d, tw, n=700, e=6000, device="cuda"):
    """A random windowed layout (ops/windowed.py:windowize_edges, te 128):
    sorted dst with nodes [tw, 2·tw) left without edges (an empty window),
    a masked tail, the tail capacity tiles, NaN in the messages and weights
    of pad slots; random node rows and cotangents."""
    from matdeeplearn_torch.ops import windowed as WO

    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst[(dst >= tw) & (dst < 2 * tw)] = 0
    dst = np.sort(dst)
    mask = np.ones(e, np.float32)
    mask[-50:] = 0
    we = WO.windowize_edges(torch.as_tensor(dst), torch.as_tensor(mask), n,
                            tw, 128)
    we = WO.WindowedEdges(*(t.to(device) for t in we))
    ew = we.dst.shape[0]
    g = torch.Generator().manual_seed(d)
    pad = we.dst < 0
    msg = torch.randn(ew, d, generator=g).to(device)
    w = torch.randn(ew, generator=g).to(device)
    msg[pad], w[pad] = float("nan"), float("nan")
    x = torch.randn(n, d, generator=g).to(device)
    cot_n = torch.randn(n, d, generator=g).to(device)
    cot_e = torch.randn(ew, d, generator=g).to(device)
    return we, msg, w, x, cot_n, cot_e, n


@pytest.mark.parametrize("tw", [64, 512])
@pytest.mark.parametrize("d", [1, 3, 100, 150, 300])
def test_windowed_kernels_match_plain(cuda_device, d, tw):
    """The three windowed kernels and their autograd Functions against the
    plain versions: sums to rtol 1e-5, atol 1e-5·max|ref| (a fixed order,
    not index_add_'s), the gather bit-exact, no NaN from pad slots, an
    empty window exactly zero, two calls of the sum bit-identical."""
    from matdeeplearn_torch.ops import windowed as WO

    we, msg, w, x, cot_n, cot_e, n = _windowed_problem(
        np.random.default_rng(d + tw), d, tw)
    pwe = WO.WindowedEdges(*(v.cpu() for v in we))

    m = msg.clone().requires_grad_(True)
    out = WO.windowed_segment_sum(m, we, n, tw)
    ref = WO.segment_sum_plain(msg.cpu(), pwe.dst, pwe.window_id, n, tw)
    assert torch.isfinite(out).all()
    _assert_sum_close(out.detach().cpu(), ref)
    assert float(out.detach()[tw:2 * tw].abs().max()) == 0.0
    assert torch.equal(out.detach(), WO.segment_sum(msg, we, n, tw))
    (out * cot_n).sum().backward()
    assert torch.equal(m.grad.cpu(), WO.gather_plain(cot_n.cpu(), pwe.dst,
                                                     pwe.window_id, tw))

    wt = w.clone().requires_grad_(True)
    m = msg.clone().requires_grad_(True)
    out = WO.windowed_spmm(wt, m, we, n, tw)
    ref = WO.segment_sum_plain(msg.cpu(), pwe.dst, pwe.window_id, n, tw,
                               w.cpu())
    assert torch.isfinite(out).all()
    _assert_sum_close(out.detach().cpu(), ref)
    (out * cot_n).sum().backward()
    gg = WO.gather_plain(cot_n.cpu(), pwe.dst, pwe.window_id, tw)
    real = pwe.dst >= 0
    torch.testing.assert_close(m.grad.cpu()[real], (gg * w.cpu()[:, None])[real])
    torch.testing.assert_close(wt.grad.cpu()[real],
                               (msg.cpu() * gg).sum(-1)[real])

    xt = x.clone().requires_grad_(True)
    out = WO.windowed_gather(xt, we, tw)
    assert torch.equal(out.detach().cpu(),
                       WO.gather_plain(x.cpu(), pwe.dst, pwe.window_id, tw))
    (out * cot_e).sum().backward()
    _assert_sum_close(xt.grad.cpu(), WO.segment_sum_plain(
        cot_e.cpu(), pwe.dst, pwe.window_id, n, tw))


def _windowed_tiling(real, tw, d, order, device, n=600, te=128, spare=5):
    """`real` sorted random edges over n nodes in the windowed layout
    (windowize_edges, te 128), `spare` more pad tiles parked on the last
    window (the tail capacity tiles of a batch), the slots of every tile
    shuffled where order is "shuffled" (any dst order inside a window), NaN
    in the messages and weights of pad slots."""
    from matdeeplearn_torch.ops import windowed as WO

    rng = np.random.default_rng(real * 7 + tw + d)
    dst = np.sort(rng.integers(0, n, max(real, 1))).astype(np.int32)
    mask = np.zeros(len(dst), np.float32)
    mask[:real] = 1.0
    we = WO.windowize_edges(torch.as_tensor(dst), torch.as_tensor(mask), n,
                            tw, te)
    wdst = torch.cat([we.dst, torch.full((spare * te,), -1, dtype=torch.int32)])
    if order == "shuffled":
        perm = torch.as_tensor(np.argsort(rng.random((len(wdst) // te, te)), 1))
        wdst = wdst.view(-1, te).gather(1, perm).reshape(-1)
    we = WO.WindowedEdges(
        order=torch.zeros(len(wdst), dtype=torch.int64), dst=wdst,
        window_id=torch.cat([we.window_id, we.window_id[-1:].repeat(spare)]),
        first_tile=torch.cat([we.first_tile,
                              torch.zeros(spare, dtype=torch.int32)]),
        valid=(wdst >= 0).float())
    g = torch.Generator().manual_seed(d + tw)
    msg = torch.randn(len(wdst), d, generator=g)
    w = torch.randn(len(wdst), generator=g)
    msg[wdst < 0], w[wdst < 0] = float("nan"), float("nan")
    return WO.WindowedEdges(*(t.to(device) for t in we)), msg.to(device), \
        w.to(device), n


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("real", [0, 1, 127, 129, 5000])
@pytest.mark.parametrize("tw", [64, 512])
@pytest.mark.parametrize("d", [1, 3, 4, 32, 33, 100, 150, 300])
def test_windowed_sums_match_plain_at_tiling_edges(cuda_device, d, tw, real,
                                                   order):
    """The windowed sum and SpMM against their plain versions at edge counts
    off every tile (0: an all-pad batch), with spare tiles parked on the
    last window and, shuffled, any dst order inside a tile: rtol 1e-5, atol
    1e-5·max|ref|, finite, exactly zero on nodes without edges,
    bit-identical between two calls. 5,000 edges put more counted slots in
    one window than the kernel lists in one pass."""
    from matdeeplearn_torch.ops import windowed as WO

    we, msg, w, n = _windowed_tiling(real, tw, d, order, cuda_device)
    pwe = WO.WindowedEdges(*(v.cpu() for v in we))
    no_edge = torch.ones(n, dtype=torch.bool)
    no_edge[pwe.dst[pwe.dst >= 0].long()] = False
    for fn, wv in ((lambda: WO.segment_sum(msg, we, n, tw), None),
                   (lambda: WO.spmm(w, msg, we, n, tw), w)):
        out = fn()
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn())
        ref = WO.segment_sum_plain(msg.cpu(), pwe.dst, pwe.window_id, n, tw,
                                   None if wv is None else wv.cpu())
        if real == 0:
            assert float(out.abs().max()) == 0.0
        else:
            _assert_sum_close(out.cpu(), ref)
        assert (out.cpu()[no_edge] == 0).all()


def test_windowed_launch_counts_and_raises(cuda_device):
    from matdeeplearn_torch.ops import windowed as WO

    we, msg, w, x, _, _, n = _windowed_problem(np.random.default_rng(0), 8, 64)
    before = dict(WO.LAUNCHES)
    WO.segment_sum(msg, we, n, 64)
    WO.spmm(w, msg, we, n, 64)
    WO.gather(x, we, 64)
    torch.cuda.synchronize()
    for k in before:
        assert WO.LAUNCHES[k] == before[k] + 1, k
    with pytest.raises(ValueError, match="int32"):
        WO.segment_sum(msg, we._replace(dst=we.dst.long()), n, 64)
    with pytest.raises(ValueError, match="evenly"):
        WO.gather(x, we._replace(window_id=we.window_id[:-1].contiguous(),
                                 first_tile=we.first_tile[:-1].contiguous()),
                  64)


def _gcn_hp(**kw):
    return {"dim1": 24, "dim2": 16, "gc_count": 3, "post_fc_count": 2, **kw}


def test_windowed_gcn_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small GCN on windowed batches with pad graph slots (windows that
    own no tile) in training mode: outputs and parameter gradients on the
    card (windowed kernels) against the CPU (plain versions)."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  WindowedDeviceData, assemble)
    from matdeeplearn_torch.data.dataset import windowed_layout
    from matdeeplearn_torch.models import build_model
    from matdeeplearn_torch.ops import windowed as WO

    ds = _toy(tmp_path)
    layout = windowed_layout(ds)
    spec = BatchSpec.for_dataset(layout.node_counts_w, layout.wedge_counts, 10,
                                 align=layout.tw, align_edges=layout.te)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = _gcn_hp()
    model = build_model("GCN", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("GCN", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        data = DeviceDataset.from_graph_dataset(
            ds, dev, windowed=WindowedDeviceData.from_layout(layout, dev))
        batch = assemble(data, ids, spec)
        before = dict(WO.LAUNCHES)
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        if dev != "cpu":
            for k in WO.LAUNCHES:
                assert WO.LAUNCHES[k] == before[k] + 3, k
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    layer_max = {}
    for k, g in g_cpu.items():
        layer = k.split(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-6), float(g.abs().max()))
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * layer_max[k.split(".", 1)[0]],
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("kernel", ["pallas", "csr"])
def test_gcn_training_on_cuda_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                          kernel):
    """train_regular of a small GCN on the card and on the CPU (plain
    versions): the same errors, to 1e-3. Without BatchNorm: conv{i}.bias
    sits behind it (ROADMAP §3)."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": "GCN", **_gcn_hp(gc_count=2, post_fc_count=1),
          "batch_norm": "False", "batch_size": 8, "epochs": 3, "lr": 0.005,
          "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "print_model": False}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"g_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=1e-3, atol=1e-3, err_msg=split)
