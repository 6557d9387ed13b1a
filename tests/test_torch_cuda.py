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
to 300 and tw 64 and 512; the windowed gather bit-exact. The CSR kernels
are also held on a src-sorted batch's indices (edge_src, and
node_graph[edge_src] into the graph rows), under a small MEGNet against the
CPU, and packed training runs against the CPU. The bilinear kernels' bf16
arm (`precision: bf16`) is held to its plain versions at the f32 arm's
tolerance (the same rounded operands, exact products, f32 sums in another
order), also at the edges of its bf16 tensor-core kernels' tiling and on an
all-pad batch, its forward's weight image byte for byte, its rounding to
bf16 to nearest-even exactly, its backward to the rows' two kernels (d_xj
on the forward's tiles over the transposed weight image, d_a on its own)
each against its plain formula, and the f32 arm on the same inputs must
fall outside that tolerance; bf16 models and training runs
card against CPU to rtol 2^-6 (BF16_RTOL says why), and bf16 training on
CUDA graphs equals its eager loop bit for bit. The single-pass arms
(`kernel_precision: bf16`) are held to their plain twins (the windowed and
CSR arms at the f32 arms' tolerances, the fused arms by SP_MEDIAN and
SP_LARGEST, which say why), bit-identical twice on sorted edges, the f32
arm on the same inputs 10x outside; kernel_precision bf16 training runs
card against CPU to rtol 2^-6. Captured training under torch.profiler
gives the errors and launches of the same run without one, and the
trainer's spans, their device-side copies flagged as annotations.
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


def _draw(*shape, seed: int, device):
    """Standard normal draws from torch.Generator(seed) on the CPU, moved to
    `device`: every random input of these tests replays."""
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)
                       ).to(device)


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
    x = _draw(n, 8, seed=101, device=cuda_device)
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
    x = _draw(8, n, seed=102, device=cuda_device).t()  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        csr.gather(x, dv, mv)
    with pytest.raises(ValueError, match="int32"):
        csr.segment_sum(_draw(len(dst), 4, seed=103, device=cuda_device),
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
    g = _draw(n, d, seed=104, device=cuda_device)
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
    g = _draw(n, d, seed=105, device=cuda_device)
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
    cot = _draw(*out.shape, seed=106, device=out.device)
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
    g = _draw(n, 100, seed=107, device=cuda_device)
    first = FC.fused_cgconv_bwd(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    again = FC.fused_cgconv_bwd(g, x, xj, dist, dst, mask, *ws, n, 0.2)
    for a, b in zip(first[2:], again[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,blocks", [(100, 7), (100, 66), (3, 264)])
def test_wgrad_reduce_matches_plain(cuda_device, d, blocks):
    de = 50
    floats = FC._load().mdl_fused_cgconv_partial_floats(d, de)
    partial = _draw(blocks * floats, seed=108, device=cuda_device)
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


# the draws of the tiling cases: `sweep` 0 is the tests', and the sweep
# of sweep_cfconv_tiling.py runs the same cases over more
SWEEP_STRIDE = 7919


def _cfconv_tiling(f, e, real, device, sweep=0):
    dst, mask = _edge_problem(e, 40, real, f * 1000 + e + SWEEP_STRIDE * sweep)
    g = torch.Generator().manual_seed(f + e + SWEEP_STRIDE * sweep)
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


def cfconv_bwd_tiling(f, e, real, device, sweep=0):
    """(inputs, kernel gradients, plain gradients) of the cfconv backward's
    tiling case (f, e, real) under the draw `sweep`, its cotangent from a
    seeded generator."""
    args = _cfconv_tiling(f, e, real, device, sweep)
    cot = _draw(40, f, seed=f * 1000 + e + 1 + SWEEP_STRIDE * sweep,
                device=device)
    return (args, FS.fused_cfconv_bwd(cot, *args),
            FS.fused_cfconv_bwd_plain(cot, *args))


CFCONV_GRADS = ("xj", "w0", "b0", "w1", "b1")


@pytest.mark.parametrize("e,real", TILING_EDGES)
@pytest.mark.parametrize("f", TILING_WIDTHS)
def test_fused_cfconv_bwd_matches_plain_at_tiling_edges(cuda_device, f, e,
                                                        real):
    args, got, ref = cfconv_bwd_tiling(f, e, real, cuda_device)
    if real == 0:
        assert float(got[0].abs().max()) == 0.0
        for a in got[1:]:
            assert float(a.abs().max()) == 0.0
        return
    for name, a, b in zip(CFCONV_GRADS, got, ref):
        _assert_fused_close(a, b, f"d_{name}")
    assert not got[0][args[4] == 0].any()


@pytest.mark.parametrize("f", [3, 150, 256])
def test_fused_cfconv_backward_stages_match_plain(cuda_device, f):
    """Each kernel of the backward against its plain stage: the edge
    kernel's d_xj and its a, dw and dpre rows of real edges, and every
    slice of the weight-gradient kernel (scattered mask)."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("scattered", f,
                                                      device=cuda_device)
    g = _draw(n, f, seed=110, device=cuda_device)
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
    g = _draw(n, 150, seed=111, device=cuda_device)
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
    g = _draw(n, f, seed=112, device=cuda_device)
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
    cot = _draw(*out.shape, seed=113, device=out.device)
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
    partial = _draw(blocks * floats, seed=114, device=cuda_device)
    _assert_fused_close(FS.wgrad_reduce(partial, blocks, f, de),
                        FS.wgrad_reduce_plain(partial, f, de), "reduce")


def test_fused_cfconv_wgrad_is_bit_identical(cuda_device):
    """The cfconv weight gradients (per-block partials, then the fixed-order
    sum) give the same bits in two calls."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs("unsorted", 150,
                                                      device=cuda_device)
    g = _draw(n, 150, seed=115, device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    first, again = FS.fused_cfconv_bwd(g, *args), FS.fused_cfconv_bwd(g, *args)
    for a, b in zip(first[1:], again[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("run", [1, 16, 17, 40, 129])
def test_fused_cfconv_fwd_is_the_same_bits_on_sorted_runs(cuda_device, run):
    """dst-sorted runs of `run` edges a node (17 and more reach past a
    warp's 16-row slice; 129 past a 128-edge tile): the forward agrees with
    its plain version and gives the same bits in every call (each run meets
    at most two tiles, whose two adds onto zero commute)."""
    g = torch.Generator(device=cuda_device).manual_seed(run)
    n, f, de = 700, 150, 50
    e = n * run
    dst = torch.arange(n, device=cuda_device,
                       dtype=torch.int32).repeat_interleave(run)
    mask = torch.ones(e, device=cuda_device)
    xj = torch.randn(e, f, device=cuda_device, generator=g)
    dist = torch.rand(e, device=cuda_device, generator=g)
    wraw = dist * 8.0
    ws = [torch.randn(de, f, device=cuda_device, generator=g) * 0.2,
          torch.randn(f, device=cuda_device, generator=g) * 0.1,
          torch.randn(f, f, device=cuda_device, generator=g) * 0.1,
          torch.randn(f, device=cuda_device, generator=g) * 0.1]
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    out = FS.fused_cfconv(*args)
    _assert_fused_close(out, FS.fused_cfconv_plain(*args), "output")
    for _ in range(5):
        assert torch.equal(FS.fused_cfconv(*args), out)


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
    g = _draw(len(mask), k, seed=116, device=cuda_device)
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
    g = _draw(len(mask), k, seed=117, device=cuda_device)
    first = FB.fused_bilinear_wgrad(g, xj, a, mask)
    assert torch.equal(FB.fused_bilinear_wgrad(g, xj, a, mask), first)


# (150, 100, 150): D > 104, two warps share a row's d_a
@pytest.mark.parametrize("case,d,h,k", [("sorted", 100, 100, 100),
                                        ("scattered", 150, 100, 150)])
def test_fused_bilinear_bwd_rows_is_bit_identical(cuda_device, case, d, h, k):
    args = _bilinear_inputs(case, d, h, k, device=cuda_device)
    g = _draw(len(args[-1]), k, seed=118, device=cuda_device)
    d_xj, d_a = FB.fused_bilinear_bwd_rows(g, *args)
    again = FB.fused_bilinear_bwd_rows(g, *args)
    assert torch.equal(again[0], d_xj) and torch.equal(again[1], d_a)


# (E, D, H, K) at the edges of the tensor-core kernels' tiling: 32-row
# chunks of the flat reduction spanning several units (D 3, 33, 1), K not
# a multiple of 8, D > 128 (the forward's 64-edge tile; the backward to
# the rows' 64-edge tile past D 104, its 32-edge one past 208), H = 1, and
# edge counts that are not a multiple of the 128-edge tile or the 32-edge
# chunk. The bf16 arm's kernels (bf16): D and K not multiples of 16 (3 and
# 5, 33 and 9, 1 and 12), K > 128 (129: two warpgroups, batches of 4
# k16-steps), H = 1, E not a multiple of their 192-edge tile or 64-edge
# chunk, held to the bf16 plain versions at the same tolerance.
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("e,d,h,k", [(1000, 3, 7, 5), (777, 33, 1, 9),
                                     (1001, 1, 3, 12), (515, 200, 12, 20),
                                     (129, 64, 1, 100), (4099, 100, 100, 100),
                                     (333, 130, 5, 129)])
def test_fused_bilinear_tiling_edges_match_plain(cuda_device, e, d, h, k,
                                                 bf16):
    rng = np.random.default_rng(e + d + h + k)
    t = lambda *shape, s=1.0: torch.tensor(
        s * rng.standard_normal(shape), dtype=torch.float32, device=cuda_device)
    mask = torch.tensor((rng.random(e) > 0.3).astype(np.float32),
                        device=cuda_device)
    args = (t(e, d), torch.relu(t(e, h)), t(h, d * k, s=0.1), t(d * k, s=0.1),
            mask)
    out = FB.fused_bilinear(*args, bf16=bf16)
    _assert_fused_close(out, FB.fused_bilinear_plain(*args, bf16=bf16),
                        "forward")
    assert torch.equal(FB.fused_bilinear(*args, bf16=bf16), out)
    g = t(e, k)
    dw = FB.fused_bilinear_wgrad(g, *args[:2], mask, bf16=bf16)
    _assert_fused_close(dw, FB.wgrad_plain(g, *args[:2], mask, k, bf16=bf16),
                        "dW")
    assert torch.equal(FB.fused_bilinear_wgrad(g, *args[:2], mask, bf16=bf16),
                       dw)
    rows = FB.fused_bilinear_bwd_rows(g, *args, bf16=bf16)
    for name, got, ref in zip(["d_xj", "d_a"], rows,
                              FB.bwd_rows_plain(g, *args, bf16=bf16)):
        _assert_fused_close(got, ref, name)
    for t in (out, *rows):
        assert float(t[mask == 0].abs().max()) == 0.0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_bilinear_all_pad_batch_gives_zeros(cuda_device, bf16):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 100, 100, 100,
                                           device=cuda_device)
    pad = torch.zeros_like(mask)
    g = _draw(len(mask), 100, seed=119, device=cuda_device)
    assert not FB.fused_bilinear(xj, a, w1, b1, pad, bf16=bf16).any()
    assert not FB.fused_bilinear_wgrad(g, xj, a, pad, bf16=bf16).any()
    d_xj, d_a = FB.fused_bilinear_bwd_rows(g, xj, a, w1, b1, pad, bf16=bf16)
    assert not d_xj.any() and not d_a.any()


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["w1", "w1_transposed"])
@pytest.mark.parametrize("h,d,k", [(7, 3, 5), (100, 100, 100), (1, 33, 9),
                                   (100, 150, 150), (9, 256, 256),
                                   (4, 150, 40)])
def test_fused_bilinear_bf16_weight_image_matches_plain(cuda_device, h, d, k,
                                                        transposed):
    """The bf16 forward's layout kernels write weight_image_plain byte for
    byte, with the zero k16-steps that pad the image to whole ring stages;
    the TF32 words of b1 compared in their 19 bits (cvt.rna leaves the low
    13 unspecified). Transposed: the image of W1ᵀ and b1ᵀ that the
    backward's d_xj runs on, read from W1 and b1 in place."""
    g = torch.Generator().manual_seed(h + d + k)
    w1 = torch.randn(h, d * k, generator=g)
    b1 = torch.randn(d * k, generator=g)
    got = FB.weight_image(w1.to(cuda_device), b1.to(cuda_device), d,
                          transposed).cpu()
    wd, wk = (k, d) if transposed else (d, k)
    kd, np_ = -(-wd // 16), 8 * FB.wgmma_width(wk)
    steps = (got.numel() - kd * np_ * 128) // (np_ * 32)
    assert steps >= h * kd
    ref = FB.weight_image_plain(w1, b1, d, steps, transposed)
    assert got.numel() == ref.numel()
    nb = steps * np_ * 32
    assert torch.equal(got[:nb], ref[:nb])
    mask = ~0x1FFF
    assert torch.equal(got[nb:].view(torch.int32) & mask,
                       ref[nb:].view(torch.int32) & mask)


def test_fused_bilinear_autograd_and_launch_counts(cuda_device):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 16, 12, 8,
                                           device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (xj, a, w1, b1)]
    before = dict(FB.LAUNCHES)
    out = FB.FusedBilinear.apply(*leaves, mask)
    cot = _draw(*out.shape, seed=120, device=out.device)
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


# ------------------------------------- the bilinear kernels' bf16 arm


def _limit_share(out, ref) -> float:
    """The worst |out - ref| over what _assert_fused_close allows; below 1
    passes."""
    out, ref = out.double(), ref.double()
    allowed = 1e-4 * max(float(ref.abs().max()), 1e-30) + 1e-4 * ref.abs()
    return float(((out - ref).abs() / allowed).max())


def _bf16_arm(args, g, bf16=True):
    """(msg, d_xj, d_a, d_w1, d_b1) of the kernels' arm."""
    return (FB.fused_bilinear(*args, bf16=bf16),
            *FB.fused_bilinear_bwd(g, *args, bf16=bf16))


@pytest.mark.parametrize("case,d,h,k", [
    ("sorted", 100, 100, 100), ("scattered", 100, 100, 100),
    ("unsorted", 3, 7, 5), ("scattered", 150, 100, 150),
    ("sorted", 256, 9, 256), ("scattered", 64, 20, 33),
    ("sorted", 33, 1, 9)])
def test_fused_bilinear_bf16_arm_matches_plain(cuda_device, case, d, h, k):
    """The bf16 arm of the three kernels against its plain versions at the
    f32 kernels' tolerance (rtol 1e-4, atol 1e-4·max|ref|): both take the
    same rounded operands, whose products are exact, and differ only in
    the order of f32 sums. The f32 arm on the same inputs, the unrounded
    3xTF32 path, fails that check on the outputs that round: the forward,
    d_xj, d_a and the weight gradient."""
    args = _bilinear_inputs(case, d, h, k, device=cuda_device)
    mask = args[-1]
    g = _draw(len(mask), k, seed=121, device=cuda_device)
    got = _bf16_arm(args, g)
    ref = (FB.fused_bilinear_plain(*args, bf16=True),
           *FB.fused_bilinear_bwd_plain(g, *args, bf16=True))
    names = ["msg", "d_xj", "d_a", "d_w1", "d_b1"]
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        _assert_fused_close(a, b, name)
    off = mask == 0
    for a in got[:3]:
        assert float(a[off].abs().max()) == 0.0
    unrounded = _bf16_arm(args, g, bf16=False)
    for name, a, b in zip(names, unrounded, ref):
        if name in ("msg", "d_xj", "d_a", "d_w1"):
            assert _limit_share(a, b) > 1.0, name


@pytest.mark.parametrize("case,d,h,k", [("sorted", 100, 100, 100),
                                        ("scattered", 150, 100, 150)])
def test_fused_bilinear_bf16_arm_is_bit_identical(cuda_device, case, d, h, k):
    args = _bilinear_inputs(case, d, h, k, device=cuda_device)
    g = _draw(len(args[-1]), k, seed=122, device=cuda_device)
    first = _bf16_arm(args, g)
    for a, b in zip(_bf16_arm(args, g), first):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "scattered"])
@pytest.mark.parametrize("d,h,k", [(100, 100, 100), (3, 7, 5),
                                   (150, 100, 150)])
def test_fused_bilinear_bf16_bwd_rows_kernels_match_plain(cuda_device, case,
                                                          d, h, k):
    """The bf16 backward to the rows: d_xj (the forward's tiles over the
    transposed image) against fused_bilinear_plain over (mask·g, a, W1ᵀ,
    b1ᵀ) and d_a (its own kernel) against (bf16(xj) @ bf16(W_h))·(mask·g)
    summed over K, at the f32 kernels' tolerance; the same bits from two
    calls; masked rows exactly zero; one count of the backward, none of
    the forward."""
    xj, a, w1, b1, mask = _bilinear_inputs(case, d, h, k, device=cuda_device)
    g = _draw(len(mask), k, seed=123, device=cuda_device)
    before = dict(FB.LAUNCHES_BF16)
    d_xj, d_a = FB.fused_bilinear_bwd_rows(g, xj, a, w1, b1, mask, bf16=True)
    torch.cuda.synchronize()
    assert FB.LAUNCHES_BF16["fused_bilinear_bwd_bf16"] == (
        before["fused_bilinear_bwd_bf16"] + 1)
    assert FB.LAUNCHES_BF16["fused_bilinear_fwd_bf16"] == (
        before["fused_bilinear_fwd_bf16"])
    ge = g * mask[:, None]
    want_xj = FB.fused_bilinear_plain(ge, a, *FB.transposed_weight(w1, b1, d),
                                      mask, bf16=True)
    wr = FB.round_bf16(w1).view(h, d, k)
    want_a = torch.einsum("ehk,ek->eh", torch.einsum(
        "ed,hdk->ehk", FB.round_bf16(xj), wr), ge)
    _assert_fused_close(d_xj, want_xj, "d_xj")
    _assert_fused_close(d_a, want_a, "d_a")
    again = FB.fused_bilinear_bwd_rows(g, xj, a, w1, b1, mask, bf16=True)
    assert torch.equal(again[0], d_xj) and torch.equal(again[1], d_a)
    off = mask == 0
    assert off.any()
    assert float(d_xj[off].abs().max()) == 0.0
    assert float(d_a[off].abs().max()) == 0.0


def test_fused_bilinear_bf16_arm_rounds_to_nearest_even(cuda_device):
    """With H = 1, a = 1, W1 the identity and b1 = 0 the forward returns
    bf16(xj) itself: ties go to the even neighbour (torch's rounding), not
    away from zero as TF32's cvt.rna does."""
    d = 8
    one = 1.0 + 2.0 ** -7  # one bf16 unit above 1
    vals = [1.0 + 2.0 ** -8, one + 2.0 ** -8, -(1.0 + 2.0 ** -8),
            1.0 + 2.0 ** -9, 3.0 + 2.0 ** -6, 2.0 ** -100 * (1 + 2.0 ** -8),
            1e30, -7.25]
    xj = torch.tensor([vals] * 40, device=cuda_device)
    e = xj.shape[0]
    a = torch.ones(e, 1, device=cuda_device)
    w1 = torch.eye(d, device=cuda_device).reshape(1, d * d)
    b1 = torch.zeros(d * d, device=cuda_device)
    mask = torch.ones(e, device=cuda_device)
    out = FB.fused_bilinear(xj, a, w1, b1, mask, bf16=True)
    want = xj.to(torch.bfloat16).float()
    assert torch.equal(out, want)
    assert want[0, 0] == 1.0 and want[0, 1] == one + 2.0 ** -7
    assert want[0, 2] == -1.0


def test_fused_bilinear_bf16_autograd_and_launch_counts(cuda_device):
    xj, a, w1, b1, mask = _bilinear_inputs("sorted", 16, 12, 8,
                                           device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (xj, a, w1, b1)]
    before, before_bf16 = dict(FB.LAUNCHES), dict(FB.LAUNCHES_BF16)
    out = FB.FusedBilinear.apply(*leaves, mask, True)
    cot = _draw(*out.shape, seed=124, device=out.device)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before  # the f32 arm's counts stay
    for key in FB.LAUNCHES_BF16:
        assert FB.LAUNCHES_BF16[key] == before_bf16[key] + 1, key
    _assert_fused_close(out, FB.fused_bilinear_plain(xj, a, w1, b1, mask,
                                                     bf16=True), "msg")
    ref = FB.fused_bilinear_bwd_plain(cot, xj, a, w1, b1, mask, bf16=True)
    for leaf, r in zip(leaves, ref):
        _assert_fused_close(leaf.grad, r, "autograd")


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


# bf16 limit of the card/CPU comparisons under precision bf16: the same
# operations at the same rounding points, but an f32 sum taken in another
# order (cuBLAS's, the kernels') can tip a value to its bf16 neighbour,
# 2^-8 of it; 2^-6 allows a few such steps through the layers
BF16_RTOL = 2.0 ** -6


def test_mpnn_bf16_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small MPNN under precision bf16 on dst-sorted batches, training
    mode: outputs card (the bilinear kernels' bf16 arm, cuBLAS bf16 GEMMs)
    against the CPU (plain versions) to BF16_RTOL of the largest; every
    gradient f32 and finite on both; only the bf16 arm launches."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = _mpnn_hp(precision="bf16")
    model = build_model("MPNN", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    outs = {}
    for dev in ("cpu", cuda_device):
        m = build_model("MPNN", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        batch = assemble_batch(DeviceDataset.from_graph_dataset(
            ds, dev, edge_order="dst", kernel_fused=True), ids, spec)
        before, before16 = dict(FB.LAUNCHES), dict(FB.LAUNCHES_BF16)
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        assert out.dtype == torch.float32
        for k, p in m.named_parameters():
            assert p.grad.dtype == torch.float32 and torch.isfinite(
                p.grad).all(), k
        if dev != "cpu":
            assert FB.LAUNCHES == before
            for key in FB.LAUNCHES_BF16:
                assert FB.LAUNCHES_BF16[key] == before16[key] + 3, key
        outs[str(dev)] = out.detach().cpu()
    ref = outs["cpu"]
    torch.testing.assert_close(outs[str(cuda_device)], ref, rtol=0,
                               atol=BF16_RTOL * float(ref.abs().max()))


@pytest.mark.parametrize("model,kernel", [("MPNN", "fused"), ("CGCNN", "fused"),
                                          ("GCN", "csr")])
def test_bf16_training_on_cuda_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                           model, kernel):
    """train_regular under precision bf16 on the card and on the CPU (plain
    versions), without BatchNorm (see the SchNet run above): errors to
    rtol BF16_RTOL, and finite."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": model, **_mpnn_hp(gc_count=2, post_fc_count=1),
          "batch_norm": "False", "batch_size": 8, "epochs": 3, "lr": 0.005,
          "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "print_model": False, "precision": "bf16"}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"b_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=BF16_RTOL, err_msg=split)


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


@pytest.mark.parametrize("name,key", [("CGCNN", "fused_cgconv_fwd"),
                                      ("MPNN", "fused_bilinear_fwd")])
def test_remat_recomputes_on_the_kernels(cuda_device, tmp_path, name, key):
    """remat on the card, in training mode: the output and every parameter
    gradient as without it (rtol 1e-5, atol 1e-5·each layer's largest
    gradient: the kernels' run flushes and index_add_ add in another order
    from one run to the next), and the forward kernel launches twice a
    layer, once in the forward and once recomputed in the backward."""
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    hp = (_mpnn_hp() if name == "MPNN" else
          {"dim1": 32, "dim2": 24, "gc_count": 3, "post_fc_count": 2})
    counts = FB.LAUNCHES if name == "MPNN" else FC.LAUNCHES
    init = build_model(name, ds, hp, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    batch = assemble_batch(DeviceDataset.from_graph_dataset(
        ds, cuda_device, edge_order="dst", kernel_fused=True), ids, spec)
    res = {}
    for remat in (False, True):
        m = build_model(name, ds, {**hp, "remat": remat}, device=cuda_device)
        m.load_state_dict(init.state_dict())
        m.train()
        before = counts[key]
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        torch.cuda.synchronize()
        res[remat] = (counts[key] - before, out.detach().cpu(),
                      {k: p.grad.cpu() for k, p in m.named_parameters()})
    assert res[False][0] == hp["gc_count"]
    assert res[True][0] == 2 * hp["gc_count"]
    torch.testing.assert_close(res[True][1], res[False][1], rtol=1e-5,
                               atol=1e-5)
    grads_p, grads_r = res[False][2], res[True][2]
    layer_max = {}
    for k, g in grads_p.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1e-6), float(g.abs().max()))
    for k, g in grads_p.items():
        torch.testing.assert_close(grads_r[k], g, rtol=1e-5,
                                   atol=1e-5 * layer_max[k.rsplit(".", 1)[0]],
                                   msg=lambda m, k=k: f"{k}: {m}")


def _src_batch(ds, dev, bs=10):
    from matdeeplearn_torch.data.batching import (BatchSpec, DeviceDataset,
                                                  assemble_batch)

    spec = BatchSpec.for_dataset(ds.node_counts(), ds.edge_counts(), bs)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)[:bs]
    return assemble_batch(DeviceDataset.from_graph_dataset(
        ds, dev, edge_order="src"), ids, spec)


@pytest.mark.parametrize("d", [1, 8, 100, 150])
def test_csr_kernels_on_src_and_edge_graph_indices(cuda_device, tmp_path, d):
    """MEGNet's indices on a src-sorted batch with tail pads (index 0, mask
    0 after the last real edge): edge_src into the N nodes and
    node_graph[edge_src] into the B graph rows (runs of a graph's edges).
    Gather bit-exact, sum rtol 1e-5 and bit-identical between two calls,
    and the gradient of each autograd pair."""
    ds = _toy(tmp_path)
    b = _src_batch(ds, cuda_device)
    em = b.edge_mask > 0
    assert bool((b.edge_src[em][1:] >= b.edge_src[em][:-1]).all())
    assert int(b.edge_src[~em].abs().max()) == 0 and bool((~em).any())
    edge_graph = b.node_graph[b.edge_src.long()].to(torch.int32)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    for idx, n in ((b.edge_src, b.num_nodes), (edge_graph, b.num_graphs)):
        x = torch.randn(n, d, device=cuda_device, generator=g,
                        requires_grad=True)
        msg = torch.randn(len(idx), d, device=cuda_device, generator=g,
                          requires_grad=True)
        out = csr.sorted_gather(x, idx, b.edge_mask)
        assert torch.equal(out, csr.gather_plain(x.detach(), idx, b.edge_mask))
        cot = torch.randn(out.shape, device=cuda_device, generator=g)
        (out * cot).sum().backward()
        _assert_sum_close(x.grad, csr.segment_sum_plain(cot, idx, b.edge_mask,
                                                        n))
        s = csr.sorted_segment_sum(msg, idx, b.edge_mask, n)
        _assert_sum_close(s, csr.segment_sum_plain(msg.detach(), idx,
                                                   b.edge_mask, n))
        # sorted: each row summed in edge order by one warp, the same bits
        # every run, however long its run
        assert torch.equal(s, csr.segment_sum(msg.detach(), idx,
                                              b.edge_mask, n))
        cot_n = torch.randn(s.shape, device=cuda_device, generator=g)
        (s * cot_n).sum().backward()
        assert torch.equal(msg.grad, csr.gather_plain(cot_n, idx, b.edge_mask))


def test_megnet_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A small MEGNet on src-sorted batches in training mode: outputs and
    parameter gradients on the card (CSR kernels: x[src], u[g(src)], the
    edge means) against the CPU (plain versions), and the launches of one
    forward and backward."""
    from matdeeplearn_torch.models import build_model

    ds = _toy(tmp_path)
    hp = {"dim1": 32, "dim2": 24, "dim3": 16, "gc_count": 3,
          "gc_fc_count": 1, "post_fc_count": 2}
    model = build_model("MEGNet", ds, hp, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("MEGNet", ds, hp, device=dev)
        m.load_state_dict(model.state_dict())
        m.train()
        batch = _src_batch(ds, dev)
        before = dict(csr.LAUNCHES)
        out = m(batch)
        (out * batch.graph_mask).abs().sum().backward()
        launches = {k: csr.LAUNCHES[k] - before[k] for k in before}
        results[str(dev)] = (out.detach().cpu(),
                             {k: p.grad.cpu() for k, p in m.named_parameters()},
                             launches)
    (o_cpu, g_cpu, _), (o_gpu, g_gpu, n) = (results["cpu"],
                                            results[str(cuda_device)])
    # a block: 2 gathers and 1 sum forward, 1 gather and 2 sums backward;
    # the early pool's edge mean 1 sum and its backward 1 gather
    assert n == {"gather": 3 * 3 + 1, "segment_sum": 3 * 3 + 1}, n
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4,
                                   atol=1e-4 * max(float(g.abs().max()), 1e-6),
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("model,kernel", [("CGCNN", "fused"),
                                          ("MEGNet", "csr"),
                                          ("CGCNN", "pallas"),
                                          ("SchNet", "fused"),
                                          ("SchNet", "csr"),
                                          ("GCN", "csr"),
                                          ("MPNN", "fused"),
                                          ("MEGNet", "xla"),
                                          ("MEGNet", "csr-dst")])
def test_packed_training_on_cuda_matches_cpu(cuda_device, tmp_path,
                                             monkeypatch, model, kernel):
    """train_regular with batching packed on the card and on the CPU (plain
    versions): the same errors, to 1e-3. Every model but CGCNN runs
    without BatchNorm: behind it the conv biases' gradients are rounding
    noise that AdamW turns into steps of ±lr/2 (ROADMAP §3); training
    mode's batch statistics cancel them, eval mode's running statistics do
    not, so two summation orders give equal train errors and val errors
    about 1% apart (SchNet csr, card against CPU). `csr-dst`: csr on the
    dst order (MEGNet's
    src-side gathers and means on a dst-sorted batch), the bulk bench's
    megnet-packed-csr-dst."""
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    kernel, _, order = kernel.partition("-")
    mp = {"model": model, "dim1": 32, "dim2": 24, "dim3": 16, "gc_count": 2,
          "gc_fc_count": 1, "post_fc_count": 1, "batch_size": 8, "epochs": 3,
          "lr": 0.005, "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "batching": "packed", "print_model": False,
          "batch_norm": "True" if model == "CGCNN" else "False"}
    if order:
        mp["csr_order"] = order
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    errs = {}
    for dev in ("cpu", "cuda"):
        jp = {"job_name": f"p_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=1e-3, atol=1e-3, err_msg=split)


@pytest.mark.parametrize("run", [1, 13, 31, 32, 33, 64, 455, 2000])
@pytest.mark.parametrize("d", [1, 100, 150])
def test_segment_sum_is_the_same_bits_on_sorted_runs(cuda_device, run, d):
    """Sorted runs of every length around the 32-edge chunk, with tail pads
    (index 0, mask 0) and a masked edge inside one run: the sum equals the
    plain version (rtol 1e-5) and is bit-identical between calls, and a
    run split by a masked edge or by unsorted input still sums right."""
    rng = np.random.default_rng(run * 7 + d)
    rows = 300
    lens = rng.integers(max(run // 2, 1), run + 1, rows)
    dst = np.repeat(np.arange(rows), lens).astype(np.int32)
    e_real = len(dst)
    pad = 777
    mask = np.concatenate([np.ones(e_real, np.float32),
                           np.zeros(pad, np.float32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    mask[e_real // 2] = 0.0
    dv = torch.as_tensor(dst, device=cuda_device)
    mv = torch.as_tensor(mask, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(run)
    msg = torch.randn(len(dst), d, device=cuda_device, generator=g)
    ref = csr.segment_sum_plain(msg, dv, mv, rows)
    outs = [csr.segment_sum(msg, dv, mv, rows) for _ in range(3)]
    _assert_sum_close(outs[0], ref)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    perm = torch.randperm(len(dst), device=cuda_device, generator=g)
    _assert_sum_close(csr.segment_sum(msg[perm].contiguous(), dv[perm].contiguous(),
                                      mv[perm].contiguous(), rows), ref)


# ------------------------------------------------- CUDA graphs of the epoch

CAPTURE_CASES = [("CGCNN", "fused", "padded"), ("SchNet", "fused", "padded"),
                 ("MPNN", "fused", "padded"), ("GCN", "pallas", "padded"),
                 ("MEGNet", "csr", "padded"), ("CGCNN", "fused", "packed"),
                 ("MEGNet", "csr", "packed"), ("SchNet", "fused", "packed"),
                 ("GCN", "csr", "packed")]


def _capture_mp(model, kernel, batching, **kw):
    return {"model": model, "dim1": 32, "dim2": 24, "dim3": 16, "gc_count": 2,
            "gc_fc_count": 1, "post_fc_count": 1, "batch_size": 6,
            "lr": 0.005, "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
            "scheduler_args": {"factor": 0.8, "patience": 0},
            "kernel": kernel, "batching": batching, **kw}


def _all_launches():
    from matdeeplearn_torch.training.graphs import launch_counters

    return launch_counters()


def _train_run(ds, mp, capture, epochs=3, run=None, seed=4):
    """(run, history, launches of this call, resolved line) of a
    run_fused_training under deterministic algorithms, counters reset
    just before."""
    import contextlib
    import io

    from matdeeplearn_torch.training import jobs

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if run is None:
            run = jobs.setup_run(ds, mp, "l1_loss", seed=seed, device="cuda")
    counters = _all_launches()
    for c in counters:
        for k in c:
            c[k] = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, hist = jobs.run_fused_training(
            run, train_idx=np.arange(18), val_idx=np.arange(18, 24),
            epochs=epochs, verbosity=1, seed=seed, capture=capture)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return run, np.array(hist), [dict(c) for c in counters], out.getvalue()


@pytest.mark.parametrize("model,kernel,batching", CAPTURE_CASES)
def test_captured_training_matches_eager(cuda_device, tmp_path, model, kernel,
                                         batching):
    """The trainer's CUDA graphs against its eager loop on the card, under
    deterministic algorithms: per-epoch train and val errors to rtol 1e-6,
    the final parameters, BatchNorm statistics and AdamW state equal, the
    same kernel launches; the resolved line says capture=graphs; a second
    call on the same Run replays without capturing."""
    _check_captured_matches_eager(_toy(tmp_path),
                                  _capture_mp(model, kernel, batching), kernel)


@pytest.mark.parametrize("model,kernel", [("MPNN", "fused"),
                                          ("CGCNN", "fused"),
                                          ("MEGNet", "csr")])
def test_captured_bf16_training_matches_eager(cuda_device, tmp_path, model,
                                              kernel):
    """test_captured_training_matches_eager under precision bf16 (MPNN on
    the bilinear kernels' bf16 arm): the casts of the f32 masters inside
    the captured step read the live parameters, so every replay gives the
    eager loop's bits; the bf16 arm's launches counted alike."""
    _check_captured_matches_eager(
        _toy(tmp_path), _capture_mp(model, kernel, "padded",
                                    precision="bf16"), kernel)


def test_captured_training_is_the_same_under_a_profiler(cuda_device,
                                                        tmp_path):
    """Packed CGCNN on the fused kernels and CUDA graphs, captured and
    replayed under torch.profiler (CPU and CUDA) against the same run
    without one: the errors to rtol 1e-6 (the kernels' atomics), the same
    launches; the trainer's four spans once an epoch, each span's
    device-side copy flagged a user annotation (so the benchmark's trace
    reading counts it as no device work)."""
    from torch.profiler import ProfilerActivity, profile

    ds = _toy(tmp_path)
    mp = _capture_mp("CGCNN", "fused", "packed")
    _, h_off, l_off, _ = _train_run(ds, mp, None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, h_on, l_on, text = _train_run(ds, mp, None)
    assert "capture=graphs" in text
    np.testing.assert_allclose(h_on, h_off, rtol=1e-6)
    assert l_on == l_off
    spans = [e for e in prof.events() if e.name.startswith("mdl.")]
    host = [e.name for e in spans if str(e.device_type).endswith("CPU")]
    for name in ("mdl.trainer.pack", "mdl.trainer.launch", "mdl.trainer.sync",
                 "mdl.trainer.report"):
        assert host.count(name) == 3, name
    assert len(spans) > len(host)  # the device-side copies
    assert all(e.is_user_annotation for e in spans)


def _check_captured_matches_eager(ds, mp, kernel):
    from matdeeplearn_torch.training import graphs as G

    captures = []
    capture = G.CudaGraphs.capture

    def counting(self, fn):
        captures.append(fn)
        return capture(self, fn)

    G.CudaGraphs.capture = counting
    try:
        r_e, h_e, l_e, _ = _train_run(ds, mp, False)
        r_g, h_g, l_g, text = _train_run(ds, mp, None)
        assert "capture=graphs" in text
        assert len(captures) == 3
        np.testing.assert_allclose(h_g, h_e, rtol=1e-6)
        assert l_g == l_e
        assert sum(v for c in l_g for v in c.values()) > 0 or kernel == "xla"
        for k, v in r_e.model.state_dict().items():
            torch.testing.assert_close(r_g.model.state_dict()[k], v, rtol=1e-6,
                                       atol=0, msg=k)
        for p_e, p_g in zip(r_e.model.parameters(), r_g.model.parameters()):
            s_e, s_g = r_e.optimizer.state[p_e], r_g.optimizer.state[p_g]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(s_g[key], s_e[key], rtol=1e-6,
                                           atol=0)
        assert r_g.model.training == r_e.model.training
        # a second call on the same Run: replays, the eager loop's errors
        _, h_e2, l_e2, _ = _train_run(ds, mp, False, epochs=2, run=r_e,
                                      seed=5)
        _, h_g2, l_g2, _ = _train_run(ds, mp, None, epochs=2, run=r_g, seed=5)
        assert len(captures) == 3
        np.testing.assert_allclose(h_g2, h_e2, rtol=1e-6)
        assert l_g2 == l_e2
    finally:
        G.CudaGraphs.capture = capture
    return {k: v for c in l_g for k, v in c.items()}


def _toy_stream(tmp_path, n=24):
    """_toy's structures served from npz shards of 5 graphs through an LRU
    of 2 shards (dataset_type large)."""
    import chip_smoke
    from matdeeplearn_torch.data.dataset import get_dataset
    from matdeeplearn_torch.data.streaming import StreamingGraphDataset

    chip_smoke.write_structures(str(tmp_path), n=n)
    ds = get_dataset(str(tmp_path), 0, "False",
                     {"graph_max_radius": 6.0, "graph_max_neighbors": 8,
                      "verbose": "False", "dataset_type": "large",
                      "large_shard_graphs": 5})
    return StreamingGraphDataset(ds.path, 0, cache_shards=2)


@pytest.mark.parametrize("model,kernel,wire,precision", [
    ("MPNN", "auto", "True", "f32"), ("MPNN", "fused", "True", "bf16"),
    ("CGCNN", "auto", "False", "f32"), ("SchNet", "fused", "True", "f32")])
def test_streamed_captured_training_matches_eager(cuda_device, tmp_path, model,
                                                  kernel, wire, precision):
    """test_captured_training_matches_eager on a disk-streaming dataset: the
    captured steps read the feed's static batch, refilled from the pinned
    ring by non-blocking copies, and give the eager loop's errors (rtol
    1e-6), state and launches under deterministic algorithms. MPNN's
    messages run on the bilinear kernels (auto on the card: fused; the bf16
    arm under precision bf16); no streamed batch reaches the fused CGConv
    or cfconv kernels, nor the CSR or windowed ones (SchNet's fused
    request runs xla)."""
    launches = _check_captured_matches_eager(
        _toy_stream(tmp_path),
        _capture_mp(model, kernel, "padded", stream_wire=wire,
                    precision=precision), "xla" if model != "MPNN" else kernel)
    bilinear = {k: v for k, v in launches.items() if "bilinear" in k}
    others = {k: v for k, v in launches.items() if "bilinear" not in k}
    assert not any(others.values()), others
    if model == "MPNN":
        arm = "_bf16" if precision == "bf16" else ""
        for op in ("fwd", "bwd", "wgrad"):
            assert bilinear[f"fused_bilinear_{op}{arm}"] > 0, bilinear
    else:
        assert not any(bilinear.values()), bilinear


@pytest.mark.parametrize("fault", [None, "early_release", "side_stream"])
def test_pinned_ring_refills_no_set_before_its_copy(cuda_device, tmp_path,
                                                    fault):
    """A slow device (a sleep in every step) behind a fast host: each fill
    of a ring set finds the event of that set's last copy complete, and
    every step reads the batch its ids name (checksums of the integer
    arrays and of x's bits, exact). The check sees both faults a feed could
    have: a set handed back before its copy ran (early_release), and copies
    issued on another stream than the steps' (side_stream). Batches of 12
    graphs keep x above 64 KB, a size below which CUDA may copy a small
    pinned source as the copy is queued, which would hide the first
    fault."""
    from matdeeplearn_torch.data.batching import BatchSpec
    from matdeeplearn_torch.data.streaming import StreamingGraphDataset
    from matdeeplearn_torch.training.stream import StreamFeed

    # an LRU that holds every shard: fills of about a millisecond, far ahead
    # of the device (a fill that reads a shard takes about as long as a step)
    sds = StreamingGraphDataset(_toy_stream(tmp_path).path, 0, cache_shards=8)
    spec = BatchSpec.for_dataset(sds.node_counts(), sds.edge_counts(), 12)
    feed = StreamFeed(sds, spec, cuda_device, wire=False, depth=2)
    assert feed.static["x"].nbytes > 1 << 16
    ring, fill, release, early, events = (feed.ring, feed.fill,
                                          feed.ring.release, [], {})

    def recorded_release(i, event):  # the event of each set's last copy
        events[i] = event
        release(i, event)

    def checked_fill(ids, out):
        i = next(k for k, st in enumerate(ring.sets) if st is out)
        event = events.get(i)
        if event is not None and not event.query():
            early.append(i)
        fill(ids, out)

    feed.fill = checked_fill
    ring.release = recorded_release
    if fault == "early_release":
        ring.release = lambda i, event: ring.free.put(i)
    elif fault == "side_stream":
        side, load = torch.cuda.Stream(), feed.load

        def side_load(i):
            with torch.cuda.stream(side):
                load(i)

        feed.load = side_load
    rng = np.random.default_rng(0)
    rows = [rng.permutation(len(sds))[:12] for _ in range(40)]
    sums = []

    def step(static):  # about 20 ms of device time: the host runs ahead
        torch.cuda._sleep(40_000_000)
        sums.append(torch.stack([static["edge_src"].long().sum(),
                                 static["node_graph"].sum(),
                                 static["n_node"].sum(),
                                 static["x"].view(torch.int32).long().sum()]))

    feed.run((rows, step))
    torch.cuda.synchronize()
    want = []
    for ids in rows:
        b = sds.assemble(ids, spec)
        want.append([int(b.edge_src.long().sum()), int(b.node_graph.sum()),
                     int(b.n_node.sum()),
                     int(b.x.view(torch.int32).long().sum())])
    got = torch.stack(sums).cpu().numpy()
    wrong = int((got != np.array(want)).any(axis=1).sum())
    if fault is None:
        assert not early and wrong == 0, (early, wrong)
    else:
        assert wrong > 0, f"{fault}: the check saw no wrong batch"


@pytest.mark.parametrize("bf16", [False, True])
def test_bilinear_kernels_on_a_streamed_batch(cuda_device, tmp_path, bf16):
    """MPNN's bilinear kernels on a streamed batch (the reference edge
    order, dst unsorted, real edges a prefix): forward and backward against
    their plain versions at the bilinear tolerance (rtol 1e-4, atol
    1e-4·max|ref|), zero rows on pad edges; and a small MPNN on the
    streamed batch (GraphBatch.kernel_bilinear) on the card against the
    CPU, outputs and parameter gradients to 1e-4 (2^-6 under bf16)."""
    from matdeeplearn_torch.data.batching import BatchSpec
    from matdeeplearn_torch.data.streaming import expand_wire
    from matdeeplearn_torch.models import build_model

    sds = _toy_stream(tmp_path)
    spec = BatchSpec.for_dataset(sds.node_counts(), sds.edge_counts(), 10)
    ids = np.array([3, 0, 9, 14, 6, 1, 22, 7, -1, -1], np.int32)
    host = sds.assemble_wire(ids, spec)
    batch = expand_wire(type(host)(**{k: None if v is None else v.to(cuda_device)
                                      for k, v in vars(host).items()}))
    dst = batch.edge_dst[batch.edge_mask > 0].cpu().numpy()
    assert (np.diff(dst) < 0).any(), "the streamed batch is dst-sorted"
    mask = batch.edge_mask
    e, d, h, k = len(mask), 16, 12, 16
    g = torch.Generator().manual_seed(5)
    t = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(
        cuda_device)
    x = t(spec.num_nodes, d)
    args = (x[batch.edge_src.long()], torch.relu(t(e, h)), t(h, d * k, s=0.1),
            t(d * k, s=0.1), mask)
    _assert_fused_close(FB.fused_bilinear(*args, bf16=bf16),
                        FB.fused_bilinear_plain(*args, bf16=bf16), "forward")
    cot = _draw(e, k, seed=129, device=cuda_device)
    got = FB.fused_bilinear_bwd(cot, *args, bf16=bf16)
    ref = FB.fused_bilinear_bwd_plain(cot, *args, bf16=bf16)
    for name, a, b in zip(["xj", "a", "w1", "b1"], got, ref):
        _assert_fused_close(a, b, f"d_{name}")
    off = mask == 0
    for a in (FB.fused_bilinear(*args, bf16=bf16), got[0], got[1]):
        assert float(a[off].abs().max()) == 0.0

    hp = {"dim1": 16, "dim2": 12, "dim3": 8, "gc_count": 2,
          "post_fc_count": 1, "precision": "bf16" if bf16 else "f32"}
    init = build_model("MPNN", sds, hp, device="cpu",
                       generator=torch.Generator().manual_seed(0)).state_dict()
    results = {}
    for dev in ("cpu", cuda_device):
        m = build_model("MPNN", sds, hp, device=dev)
        m.load_state_dict(init)
        m.eval()
        b = expand_wire(type(host)(**{k: None if v is None else v.to(dev)
                                      for k, v in vars(host).items()}))
        b.kernel_bilinear = True
        out = m(b)
        (out.float() * b.graph_mask).abs().sum().backward()
        results[str(dev)] = (out.detach().float().cpu(),
                             {n: p.grad.cpu() for n, p in m.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(cuda_device)]
    tol = 2.0 ** -6 if bf16 else 1e-4
    torch.testing.assert_close(o_gpu, o_cpu, rtol=tol, atol=tol)
    for n, gr in g_cpu.items():
        torch.testing.assert_close(g_gpu[n], gr, rtol=tol,
                                   atol=tol * max(float(gr.abs().max()), 1e-6),
                                   msg=lambda m, n=n: f"{n}: {m}")


def test_captured_dropout_matches_eager_or_is_refused(cuda_device, tmp_path):
    """dropout_rate 0.1: the graph registers the model's generator and
    draws the eager run's masks (errors to rtol 1e-6), or, where this
    torch cannot, the plan says eager and capture=True raises."""
    from matdeeplearn_torch.training import graphs as G

    ds = _toy(tmp_path)
    mp = _capture_mp("CGCNN", "fused", "padded", dropout_rate=0.1)
    if not G.GENERATOR_API:
        _, _, _, text = _train_run(ds, mp, None, epochs=1)
        assert "register_generator_state" in text
        with pytest.raises(ValueError, match="register_generator_state"):
            _train_run(ds, mp, True, epochs=1)
        return
    _, h_e, _, _ = _train_run(ds, mp, False)
    _, h_g, _, text = _train_run(ds, mp, True)
    assert "capture=graphs" in text
    np.testing.assert_allclose(h_g, h_e, rtol=1e-6)
    # the masks do depend on the generator: another seed trains otherwise
    _, h_other, _, _ = _train_run(ds, mp, True, seed=5)
    assert not np.allclose(h_other, h_g, rtol=1e-6)


def test_load_optimizer_state_drops_the_graphs(cuda_device, tmp_path):
    """A graph holds the optimizer state's addresses: loading a state
    between two calls drops the cached graphs, and the next call captures
    anew and trains on the loaded state as the eager loop does."""
    import copy

    from matdeeplearn_torch.training.optimizers import optimizer_state

    ds = _toy(tmp_path)
    mp = _capture_mp("CGCNN", "fused", "padded")
    run, _, _, _ = _train_run(ds, mp, None, epochs=2)
    assert len(run.graphs) == 1
    # a copy: load_state_dict keeps the tensors it is given where their
    # device and dtype fit, and training then updates them in place
    saved = copy.deepcopy(optimizer_state(run.optimizer))
    init = {k: v.clone() for k, v in run.model.state_dict().items()}
    run.load_optimizer_state(copy.deepcopy(saved))
    assert run.graphs == {}
    _, h_g, _, _ = _train_run(ds, mp, None, epochs=2, run=run, seed=6)
    assert len(run.graphs) == 1
    eager, _, _, _ = _train_run(ds, mp, False, epochs=0)
    eager.model.load_state_dict(init)
    eager.load_optimizer_state(copy.deepcopy(saved))
    _, h_e, _, _ = _train_run(ds, mp, False, epochs=2, run=eager, seed=6)
    np.testing.assert_allclose(h_g, h_e, rtol=1e-6)


def test_reset_run_replays_the_graphs(cuda_device, tmp_path):
    """A CV fold on a reused Run (jobs.reset_run) replays fold 0's graphs,
    captures nothing, and gives a fresh Run's fold bit for bit under
    deterministic algorithms."""
    from matdeeplearn_torch.training import graphs, jobs

    ds = _toy(tmp_path)
    mp = _capture_mp("CGCNN", "fused", "padded")
    run, _, _, _ = _train_run(ds, mp, None, epochs=2, seed=4)
    before = graphs.CAPTURES["graphs"]
    jobs.reset_run(run, 5)
    _, h_reused, _, _ = _train_run(ds, mp, None, epochs=2, run=run, seed=5)
    assert graphs.CAPTURES["graphs"] == before
    _, h_fresh, _, _ = _train_run(ds, mp, None, epochs=2, seed=5)
    np.testing.assert_array_equal(h_reused, h_fresh)


def test_dropped_runs_leave_device_memory_flat(cuda_device, tmp_path):
    """Runs captured and dropped one after another (a sweep's trials) end
    with the same device memory allocated: nothing of a dropped run's
    graphs stays, and the warm-up stream (with its cuBLAS workspace) is
    shared."""
    import gc

    ds = _toy(tmp_path)
    mp = _capture_mp("CGCNN", "fused", "padded")
    after = []
    for seed in range(3):
        run, _, _, _ = _train_run(ds, {**mp, "dim1": 16 * (seed + 1)}, None,
                                  epochs=1, seed=seed)
        del run
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert abs(after[2] - after[1]) < 2**20, after  # a new stream: 32 MiB


# ------------------------------------------------ the single-pass arms

# The windowed and CSR arms round exactly the values their plain twins
# round (the inputs, or w·msg formed by one f32 multiply on both sides), so
# they keep the f32 arms' tolerances. The fused arms round a message (and,
# backward, d_x_i) that the kernel forms in 3xTF32 and its twin with f32
# GEMMs: an ulp apart, a value within an ulp of a bf16 midpoint rounds to
# neighbouring bf16 values on the two sides, 2⁻⁸ of it apart. So the fused
# arms are held by the median of |kernel - twin| over the median of |twin|
# (SP_MEDIAN; f32 order alone) and by the largest gap (SP_LARGEST of
# max|twin|: a few tipped roundings, not a missing arm).
SP_MEDIAN, SP_LARGEST, SP_MUTATION = 1e-5, 2.0 ** -7, 10.0


def _sp_median(out, ref) -> float:
    """median |out - ref| over median |ref|, both over the entries that are
    not zero on both sides (masked rows are exactly zero)."""
    out, ref = out.double(), ref.double()
    nz = (out != 0) | (ref != 0)
    if not bool(nz.any()):
        return 0.0
    return float((out - ref)[nz].abs().median()
                 / max(float(ref[nz].abs().median()), 1e-30))


def _assert_sp_close(out, ref, name):
    med = _sp_median(out, ref)
    big = float((out.double() - ref.double()).abs().max()
                / max(float(ref.abs().max()), 1e-30))
    assert med <= SP_MEDIAN and big <= SP_LARGEST, (
        f"{name}: median share {med:.3g}, largest {big:.3g} of max|ref|")


def _sum_share(out, ref) -> float:
    """|out - ref| over _assert_sum_close's allowance; below 1 passes."""
    out, ref = out.double(), ref.double()
    allowed = 1e-5 * max(float(ref.abs().max()), 1e-30) + 1e-5 * ref.abs()
    return float(((out - ref).abs() / allowed).max())


@pytest.mark.parametrize("d", [1, 3, 100, 150])
def test_windowed_single_pass_arm_matches_plain(cuda_device, d):
    """The windowed kernels' single-pass arm against its plain twins: the
    sum and SpMM to the f32 tolerance and bit-identical twice, the gather
    bit-exact, the autograd Functions' backwards in the same arm; the f32
    arm misses the twins by 10x the limit (the mutation check)."""
    from matdeeplearn_torch.ops import windowed as WO

    tw = 64
    we, msg, w, x, cot_n, _, n = _windowed_problem(np.random.default_rng(d),
                                                   d, tw)
    pwe = WO.WindowedEdges(*(v.cpu() for v in we))
    plain = lambda m, wt=None: WO.segment_sum_plain(
        m.cpu(), pwe.dst, pwe.window_id, n, tw, wt, True)
    before = dict(WO.LAUNCHES)
    for wt in (None, w):
        run = ((lambda sp: WO.segment_sum(msg, we, n, tw, sp)) if wt is None
               else (lambda sp, wt=wt: WO.spmm(wt, msg, we, n, tw, sp)))
        out = run(True)
        ref = plain(msg, None if wt is None else wt.cpu())
        _assert_sum_close(out.cpu(), ref)
        assert torch.equal(out, run(True))
        assert _sum_share(run(False).cpu(), ref) >= SP_MUTATION
    out = WO.gather(x, we, tw, True)
    assert torch.equal(out.cpu(), WO.gather_plain(x.cpu(), pwe.dst,
                                                  pwe.window_id, tw, True))
    assert not torch.equal(WO.gather(x, we, tw), out)
    xt = x.clone().requires_grad_(True)
    (WO.windowed_segment_sum(WO.windowed_gather(xt, we, tw, True), we, n, tw,
                             True) * cot_n).sum().backward()
    xr = x.cpu().clone().requires_grad_(True)
    (plain(WO.gather_plain(xr, pwe.dst, pwe.window_id, tw, True))
     * cot_n.cpu()).sum().backward()
    _assert_sum_close(xt.grad.cpu(), xr.grad)
    assert WO.LAUNCHES["windowed_gather"] == before["windowed_gather"] + 1


@pytest.mark.parametrize("d", [1, 24, 100, 150])
def test_csr_single_pass_arm_matches_plain(cuda_device, d):
    """The CSR kernels' single-pass arm (on no plan's path) against its
    plain twins: the sum to the f32 tolerance and bit-identical twice on a
    sorted index, the gather bit-exact; the f32 arm misses by 10x."""
    dst, mask, n = _problem(np.random.default_rng(d), "scattered")
    e = len(dst)
    dst_t = torch.as_tensor(dst, device=cuda_device)
    mask_t = torch.as_tensor(mask, device=cuda_device)
    msg = _draw(e, d, seed=125, device=cuda_device)
    x = _draw(n, d, seed=126, device=cuda_device)
    before = dict(csr.LAUNCHES_SP)
    out = csr.segment_sum(msg, dst_t, mask_t, n, True)
    ref = csr.segment_sum_plain(msg.cpu(), dst_t.cpu(), mask_t.cpu(), n, True)
    _assert_sum_close(out.cpu(), ref)
    assert torch.equal(out, csr.segment_sum(msg, dst_t, mask_t, n, True))
    assert _sum_share(csr.segment_sum(msg, dst_t, mask_t, n).cpu(),
                      ref) >= SP_MUTATION
    got = csr.gather(x, dst_t, mask_t, True)
    assert torch.equal(got.cpu(), csr.gather_plain(x.cpu(), dst_t.cpu(),
                                                   mask_t.cpu(), True))
    assert not torch.equal(csr.gather(x, dst_t, mask_t), got)
    assert csr.LAUNCHES_SP["segment_sum_sp"] == before["segment_sum_sp"] + 2
    assert csr.LAUNCHES_SP["gather_sp"] == before["gather_sp"] + 1


def _cgconv_sp(args, g, sp):
    return (FC.fused_cgconv(*args, single_pass=sp),
            *FC.fused_cgconv_bwd(g, *args, single_pass=sp))


@pytest.mark.parametrize("case", ["sorted", "scattered"])
@pytest.mark.parametrize("d", [3, 100, 150])
def test_fused_cgconv_single_pass_arm_matches_plain(cuda_device, case, d):
    """The CGConv kernels' single-pass arm (forward, edge rows, weight
    gradient) against the twins' autograd, to the fused arms' median and
    largest limits; bit-identical twice on sorted edges; the f32 arm misses
    the median limit by 10x on the forward, d_x and dW_fi, dW_si (the
    outputs a rounded x_i or message reaches most)."""
    x, xj, dist, dst, mask, ws, n = _fused_inputs(case, d, device=cuda_device)
    args = (x, xj, dist, dst, mask, *ws, n, 0.2)
    g = _draw(n, d, seed=127, device=cuda_device)
    before, before_sp = dict(FC.LAUNCHES), dict(FC.LAUNCHES_SP)
    got = _cgconv_sp(args, g, True)
    assert FC.LAUNCHES_SP == {k: v + 1 for k, v in before_sp.items()}
    assert all(FC.LAUNCHES[k] == before[k] for k in
               ("fused_cgconv_fwd", "fused_cgconv_bwd", "fused_cgconv_wgrad"))
    ref = (FC.fused_cgconv_plain(*args, single_pass=True),
           *FC.fused_cgconv_bwd_plain(g, *args, single_pass=True))
    names = ["out", "x", "xj", "wfi", "wfj", "wfe", "bf", "wsi", "wsj", "wse",
             "bs"]
    for name, a, b in zip(names, got, ref):
        _assert_sp_close(a, b, name)
    assert float(got[2][mask == 0].abs().max()) == 0.0
    if case == "sorted":
        for a, b in zip(_cgconv_sp(args, g, True), got):
            assert torch.equal(a, b)
    f32 = _cgconv_sp(args, g, False)
    for i in (0, 1, 3, 7):
        assert _sp_median(f32[i], ref[i]) >= SP_MUTATION * SP_MEDIAN, names[i]


def _cfconv_sp(args, g, sp):
    return (FS.fused_cfconv(*args, single_pass=sp),
            *FS.fused_cfconv_bwd(g, *args, single_pass=sp))


@pytest.mark.parametrize("case", ["sorted", "scattered"])
@pytest.mark.parametrize("f", [3, 150])
def test_fused_cfconv_single_pass_arm_matches_plain(cuda_device, case, f):
    """The cfconv kernels' single-pass arm (forward, edge rows; the weight
    gradient reads the rows) against the twins' autograd, to the fused
    arms' limits; bit-identical twice on sorted edges; the f32 arm misses
    the median limit by 10x on the forward and d_xj."""
    xj, dist, wraw, dst, mask, ws, n = _cfconv_inputs(case, f,
                                                      device=cuda_device)
    args = (xj, dist, wraw, dst, mask, *ws, n, 0.2, 8.0)
    g = _draw(n, f, seed=128, device=cuda_device)
    before_sp = dict(FS.LAUNCHES_SP)
    got = _cfconv_sp(args, g, True)
    assert FS.LAUNCHES_SP == {k: v + 1 for k, v in before_sp.items()}
    ref = (FS.fused_cfconv_plain(*args, single_pass=True),
           *FS.fused_cfconv_bwd_plain(g, *args, single_pass=True))
    for name, a, b in zip(["out", "xj", "w0", "b0", "w1", "b1"], got, ref):
        _assert_sp_close(a, b, name)
    if case == "sorted":
        for a, b in zip(_cfconv_sp(args, g, True), got):
            assert torch.equal(a, b)
    f32 = _cfconv_sp(args, g, False)
    for i, name in ((0, "out"), (1, "xj")):
        assert _sp_median(f32[i], ref[i]) >= SP_MUTATION * SP_MEDIAN, name


@pytest.mark.parametrize("model,kernel", [("CGCNN", "fused"),
                                          ("SchNet", "fused"),
                                          ("GCN", "pallas")])
def test_kernel_precision_training_on_cuda_matches_cpu(cuda_device, tmp_path,
                                                       monkeypatch, model,
                                                       kernel):
    """train_regular under kernel_precision bf16 on the card (the arms'
    kernels, counted by LAUNCHES_SP) and on the CPU (their twins), without
    BatchNorm: errors to rtol BF16_RTOL (tipped roundings, as above), and
    finite."""
    from matdeeplearn_torch.ops import windowed as WO
    from matdeeplearn_torch.training import jobs

    ds = _toy(tmp_path / "data", n=40)
    monkeypatch.chdir(tmp_path)
    mp = {"model": model, **_mpnn_hp(gc_count=2, post_fc_count=1),
          "batch_norm": "False", "batch_size": 8, "epochs": 3, "lr": 0.005,
          "optimizer": "AdamW", "scheduler": "ReduceLROnPlateau",
          "scheduler_args": {"factor": 0.8, "patience": 0}, "kernel": kernel,
          "print_model": False, "kernel_precision": "bf16"}
    tp = {"loss": "l1_loss", "train_ratio": 0.7, "val_ratio": 0.15,
          "test_ratio": 0.15, "verbosity": 1}
    counters = {"CGCNN": FC.LAUNCHES_SP, "SchNet": FS.LAUNCHES_SP,
                "GCN": WO.LAUNCHES_SP}[model]
    errs = {}
    for dev in ("cpu", "cuda"):
        before = sum(counters.values())
        jp = {"job_name": f"k_{dev}", "seed": 4, "save_model": "False",
              "write_output": "False"}
        errs[dev] = jobs.train_regular(ds, jp, tp, mp, device=dev)
        assert (sum(counters.values()) > before) == (dev == "cuda")
    for split in ("train", "val", "test"):
        assert np.isfinite(errs["cuda"][split])
        np.testing.assert_allclose(errs["cuda"][split], errs["cpu"][split],
                                   rtol=BF16_RTOL, err_msg=split)
