"""The fused cfconv backward's tiling-edge card tests over many draws.

    python sweep_cfconv_tiling.py [--draws 100]

Runs the cases of tests/test_torch_cuda.py's
test_fused_cfconv_bwd_matches_plain_at_tiling_edges (every width of
TILING_WIDTHS, every (edge slots, real edges) of TILING_EDGES with real
edges) under the draws 0 to N - 1 (draw 0 is the test's) on one CUDA card,
and prints, for each case, the worst share of the test's limit (rtol 1e-4,
atol 1e-4·max|ref|; below 1 passes) over every gradient and draw, where it
falls, and the card's name and power limit. Exits 1 if any draw is over
the limit, 2 without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--draws", type=int, default=100)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_cfconv_tiling: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_cuda as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    worst_all, failed = (0.0, None), 0
    for e, real in C.TILING_EDGES:
        if real == 0:
            continue
        for f in C.TILING_WIDTHS:
            worst = (0.0, None, None)
            for draw in range(args.draws):
                _, got, ref = C.cfconv_bwd_tiling(f, e, real, dev, draw)
                for name, a, b in zip(C.CFCONV_GRADS, got, ref):
                    share = C._limit_share(a, b)
                    failed += share > 1.0
                    if share > worst[0]:
                        worst = (share, name, draw)
            print(f"cfconv bwd f={f} e={e} real={real}: worst share "
                  f"{worst[0]:.4f} (d_{worst[1]}, draw {worst[2]}) over "
                  f"{args.draws} draws")
            if worst[0] > worst_all[0]:
                worst_all = (worst[0], (f, e, real, worst[1], worst[2]))
    print(f"on {smi}: worst share of the limit {worst_all[0]:.4f} at "
          f"(f, e, real, gradient, draw) = {worst_all[1]}; {failed} "
          f"gradient checks over the limit")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
