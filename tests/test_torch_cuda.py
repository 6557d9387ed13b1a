"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where they are not
installed, without the repository's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: gather bit-exact; segment-sum rtol 1e-5 and atol
1e-5·max|ref|, because its atomics reorder the additions; whole-model
outputs and gradients 1e-4 against the same model on the CPU.
"""

import numpy as np
import pytest
import torch

from matdeeplearn_torch.ops import csr


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CSR kernels run only there")
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
