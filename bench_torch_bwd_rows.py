"""Device time of one of the port's kernels on one CUDA card, for A/B
comparisons of designs.

    python bench_torch_bwd_rows.py [--op OP] [--bf16] [ROOT ...]

OP names what is timed (default bilinear_bwd_rows):

* bilinear_bwd_rows: `fused_bilinear_bwd_rows` (MPNN_demo's NNConv
  backward to the rows, d_xj and d_a) at D = H = K = 100; bilinear_fwd
  and bilinear_wgrad: its forward and weight gradient at the same shapes;
  with --bf16, the three time the bilinear kernels' bf16 arm (`precision:
  bf16`) against its plain versions;
* cgconv_fwd: `fused_cgconv` (the fused CGConv forward, CGCNN_demo width
  D 100, De 50), with its launch of the weight split where it has one;
  cgconv_bwd: `fused_cgconv_bwd`, its whole backward at the same shapes;
* cfconv_bwd: `fused_cfconv_bwd` (the whole SchNet cfconv backward: every
  launch and allocation, F 150, De 50, cutoff 8), and, where the tree has
  them, its edge-row and weight-gradient launches alone; cfconv_fwd:
  `fused_cfconv`, the forward at the same shapes, with its launch of the
  weight split where it has one;
* windowed_sum: the windowed `segment_sum` at D 1 (GCN_demo's degree) and
  D 100 and the windowed `spmm` at D 100, on a windowed batch shaped like
  chip_smoke's GCN_demo training batch (windowed_batch).

The shapes are those of chip_smoke.py's training batch: 80,176 edge slots,
the first 45,509 real, 6,168 node slots; the synthetic batch gives the
first 3,517 nodes 12 or 13 edges each (dst sorted), pads point at node 0.
Inputs come from torch.Generator seed 9. For each ROOT (a checkout of this
repository; default: this one), in its own process so that each loads its
own `matdeeplearn_torch`, this builds the kernels, checks the op against
its plain version (max |diff| / max |ref| of each output) and times it
three times with CUDA events (20 launches queued behind a sleep kernel
each). Give two roots in turns (A B B A) to compare two versions on one
card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

E, REAL, N, NODES = 80176, 45509, 6168, 3517
OPS = ("bilinear_bwd_rows", "bilinear_fwd", "bilinear_wgrad", "cgconv_fwd",
       "cgconv_bwd", "cfconv_bwd", "cfconv_fwd", "windowed_sum")
TW, TE, WTILES = 64, 128, 687  # chip_smoke's windowed training batch


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


def edges(dev, g):
    """dst (sorted, pads at 0), mask, normalized and raw distances."""
    import torch

    deg = torch.full((NODES,), REAL // NODES, dtype=torch.int64)
    deg[:REAL - int(deg.sum())] += 1
    dst = torch.zeros(E, dtype=torch.int32, device=dev)
    dst[:REAL] = torch.repeat_interleave(torch.arange(NODES), deg).to(dev)
    mask = torch.zeros(E, device=dev)
    mask[:REAL] = 1.0
    dist = torch.rand(E, device=dev, generator=g)
    wraw = 8.0 * torch.rand(E, device=dev, generator=g)
    return dst, mask, dist, wraw


def windowed_batch(dev, g):
    """(layout, node slots) of a windowed batch shaped like chip_smoke's
    GCN_demo training batch: 100 graphs of 8-64 nodes, each in its own
    window of TW node slots, 12 or 13 edges a node (dst sorted), the
    edges of each window in tiles of TE slots (windowize_edges), the tiles
    past the packed extent parked on the last window, WTILES tiles in
    all."""
    import torch
    from matdeeplearn_torch.ops import windowed as WO

    atoms = torch.randint(8, 65, (100,), generator=g)
    node = torch.cat([TW * i + torch.arange(int(a)) for i, a in enumerate(atoms)])
    deg = 12 + (torch.rand(len(node), generator=g) < 0.94).long()
    dst = torch.repeat_interleave(node, deg).to(torch.int32)
    n = TW * len(atoms)
    we = WO.windowize_edges(dst, torch.ones(len(dst)), n, TW, TE)
    extra = WTILES - we.window_id.shape[0]
    we = WO.WindowedEdges(
        order=torch.cat([we.order, torch.zeros(extra * TE, dtype=torch.int64)]),
        dst=torch.cat([we.dst, torch.full((extra * TE,), -1, dtype=torch.int32)]),
        window_id=torch.cat([we.window_id, we.window_id[-1:].repeat(extra)]),
        first_tile=torch.cat([we.first_tile,
                              torch.zeros(extra, dtype=torch.int32)]),
        valid=torch.cat([we.valid, torch.zeros(extra * TE)]))
    return WO.WindowedEdges(*(t.to(dev) for t in we)), n


def rel_err(got, ref) -> list:
    """max |got - ref| / max |ref| of each pair of outputs."""
    got = got if isinstance(got, (tuple, list)) else [got]
    ref = ref if isinstance(ref, (tuple, list)) else [ref]
    return [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
            for x, y in zip(got, ref)]


def cases(op, dev, bf16=False):
    """(what, timed fn, check) of `op`: check() gives rel_err of the
    kernel's outputs against the plain version's; bf16 takes the bilinear
    kernels' bf16 arm."""
    import torch

    g = torch.Generator(device=dev).manual_seed(9)
    r = lambda *s, k=1.0: k * torch.randn(*s, device=dev, generator=g)
    if op.startswith("bilinear"):
        from matdeeplearn_torch.ops import fused_bilinear as FB

        d = h = k = 100
        mask = torch.zeros(E, device=dev)
        mask[:REAL] = 1.0
        xj, a = r(E, d), torch.relu(r(E, h))
        args = (xj, a, r(h, d * k, k=0.1), r(d * k, k=0.1), mask)
        cot = r(E, k)
        if op == "bilinear_fwd":
            fn = lambda: FB.fused_bilinear(*args, bf16=bf16)
            plain = lambda: FB.fused_bilinear_plain(*args, bf16=bf16)
        elif op == "bilinear_wgrad":
            fn = lambda: FB.fused_bilinear_wgrad(cot, xj, a, mask, bf16=bf16)
            plain = lambda: FB.wgrad_plain(cot, xj, a, mask, k, bf16=bf16)
        else:
            fn = lambda: FB.fused_bilinear_bwd_rows(cot, *args, bf16=bf16)
            plain = lambda: FB.bwd_rows_plain(cot, *args, bf16=bf16)
        return [(f"fused_{op}{' (bf16 arm)' if bf16 else ''}", fn,
                 lambda: rel_err(fn(), plain()))]
    if op == "windowed_sum":
        from matdeeplearn_torch.ops import windowed as WO

        we, n = windowed_batch(dev, torch.Generator().manual_seed(9))
        out = []
        for what, d, w in (("segment_sum D 1", 1, None),
                           ("segment_sum D 100", 100, None),
                           ("spmm D 100", 100, r(we.dst.shape[0]))):
            msg = r(we.dst.shape[0], d)
            fn = (lambda m=msg: WO.segment_sum(m, we, n, TW)) if w is None \
                else (lambda m=msg, w=w: WO.spmm(w, m, we, n, TW))
            plain = lambda m=msg, w=w: WO.segment_sum_plain(
                m, we.dst, we.window_id, n, TW, w)
            out.append((f"windowed {what}", fn,
                        lambda fn=fn, plain=plain: rel_err(fn(), plain())))
        return out
    dst, mask, dist, wraw = edges(dev, g)
    if op.startswith("cgconv"):
        from matdeeplearn_torch.ops import fused_cgconv as FC

        d, de = 100, 50
        x = r(N, d)
        xj = x[torch.randint(0, N, (E,), device=dev, generator=g)]
        ws = [r(*s, k=0.1) for s in ((d, d), (d, d), (de, d), (d,),
                                     (d, d), (d, d), (de, d), (d,))]
        args = (x, xj, dist, dst, mask, *ws, N, 0.2)
        if op == "cgconv_bwd":
            cot = r(N, d)
            fn = lambda: FC.fused_cgconv_bwd(cot, *args)
            return [("fused_cgconv_bwd (whole backward)", fn,
                     lambda: rel_err(fn(), FC.fused_cgconv_bwd_plain(cot, *args)))]
        fn = lambda: FC.fused_cgconv(*args)
        return [("fused_cgconv (forward)", fn,
                 lambda: rel_err(fn(), FC.fused_cgconv_plain(*args)))]
    from matdeeplearn_torch.ops import fused_cfconv as FS

    f, de = 150, 50
    xj = r(E, f)
    ws = [r(de, f, k=0.1), r(f, k=0.1), r(f, f, k=0.1), r(f, k=0.1)]
    args = (xj, dist, wraw, dst, mask, *ws, N, 0.2, 8.0)
    if op == "cfconv_fwd":
        fn = lambda: FS.fused_cfconv(*args)
        return [("fused_cfconv (forward)", fn,
                 lambda: rel_err(fn(), FS.fused_cfconv_plain(*args)))]
    cot = r(N, f)
    whole = lambda: FS.fused_cfconv_bwd(cot, *args)
    out = [("fused_cfconv_bwd (whole backward)", whole,
            lambda: rel_err(whole(), FS.fused_cfconv_bwd_plain(cot, *args)))]
    if hasattr(FS, "fused_cfconv_bwd_rows"):  # the edge rows and the slices
        real = mask != 0
        rows_fn = lambda: FS.fused_cfconv_bwd_rows(cot, *args)
        rows = rows_fn()
        prow = FS.bwd_rows_plain(cot, *args)
        wg = (dist, wraw, dst, mask, *rows[1:], N, f, de, 0.2, 8.0)
        wg_fn = lambda: FS.fused_cfconv_wgrad(*wg)[0]
        slices = FS.fused_cfconv_wgrad(*wg)[1]
        out += [("fused_cfconv_bwd_rows (edge rows)", rows_fn,
                 lambda: rel_err([rows[0]] + [t[real] for t in rows[1:]],
                                 [prow[0]] + [t[real] for t in prow[1:]])),
                ("fused_cfconv_wgrad (weight-gradient slices)", wg_fn,
                 lambda: rel_err(wg_fn(), FS.wgrad_partials_plain(
                     *wg[:7], N, f, de, 0.2, 8.0, slices)))]
    return out


def run_one(op: str, root: str, bf16: bool) -> None:
    sys.path.insert(0, root)
    import torch
    from matdeeplearn_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    _build.build()
    dev = torch.device("cuda")
    for what, fn, check in cases(op, dev, bf16):
        rel = check()
        ms = [device_ms(fn) for _ in range(3)]
        print(f"{root}: {torch.cuda.get_device_name(0)}, build "
              f"{time.perf_counter() - t0:.1f} s; {what}: max|diff|/max|ref| "
              f"{', '.join(f'{v:.3e}' for v in rel)}; ms "
              f"{', '.join(f'{m:.4f}' for m in ms)}", flush=True)


def main() -> int:
    args = sys.argv[1:]
    bf16 = "--bf16" in args
    args = [v for v in args if v != "--bf16"]
    op = OPS[0]
    if len(args) >= 2 and args[0] == "--op":
        op, args = args[1], args[2:]
        if op not in OPS:
            raise SystemExit(f"--op must be one of {', '.join(OPS)}")
    if len(args) == 2 and args[0] == "--one":
        run_one(op, os.path.abspath(args[1]), bf16)
        return 0
    roots = args or [os.path.dirname(os.path.abspath(__file__))]
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--op", op,
                        *(["--bf16"] if bf16 else []), "--one", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
