"""Device time of the port's bilinear backward to the rows on one CUDA card.

    python bench_torch_bwd_rows.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in its
own process so that each loads its own `matdeeplearn_torch`, this builds
the kernels, checks `fused_bilinear_bwd_rows` against `bwd_rows_plain` and
times it three times with CUDA events (20 launches queued behind a sleep
kernel each) at the shapes of chip_smoke.py's MPNN_demo training batch:
80,176 edge slots, the first 45,509 real, D = H = K = 100, inputs from
torch.Generator seed 9. Give two roots in turns (A B B A) to compare two
versions on one card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

E, REAL, D, H, K = 80176, 45509, 100, 100, 100


def device_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from matdeeplearn_torch.ops import _build
    from matdeeplearn_torch.ops import fused_bilinear as FB

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    _build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    mask = torch.zeros(E, device=dev)
    mask[:REAL] = 1.0
    xj = torch.randn(E, D, device=dev, generator=g)
    a = torch.relu(torch.randn(E, H, device=dev, generator=g))
    w1 = 0.1 * torch.randn(H, D * K, device=dev, generator=g)
    b1 = 0.1 * torch.randn(D * K, device=dev, generator=g)
    cot = torch.randn(E, K, device=dev, generator=g)
    args = (xj, a, w1, b1, mask)
    got = FB.fused_bilinear_bwd_rows(cot, *args)
    ref = FB.bwd_rows_plain(cot, *args)
    rel = [float((x - r).abs().max() / r.abs().max()) for x, r in zip(got, ref)]
    ms = [device_ms(lambda: FB.fused_bilinear_bwd_rows(cot, *args))
          for _ in range(3)]
    print(f"{root}: {torch.cuda.get_device_name(0)}, build "
          f"{time.perf_counter() - t0:.1f} s; max|diff|/max|ref| d_xj "
          f"{rel[0]:.3e}, d_a {rel[1]:.3e}; fused_bilinear_bwd_rows ms "
          f"{', '.join(f'{m:.4f}' for m in ms)}", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(os.path.abspath(sys.argv[2]))
        return 0
    roots = sys.argv[1:] or [os.path.dirname(os.path.abspath(__file__))]
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
