"""Device seconds of the gc_count message-passing layers on one batch,
through the model's own modules (convs/<model>.py), by CUDA events over
repeats after a warm-up: the forward, and with `backward` the forward and
the backward to the layers' input and weights."""

from __future__ import annotations

import time

import torch


def conv_seconds(model, batch, layers, backward: bool, reps: int = 20,
                 warm: int = 3) -> float:
    x = model.apply_pre_fc(batch.x).detach()
    if backward:
        x.requires_grad_(True)
        gen = torch.Generator(device=x.device).manual_seed(0)
        cots = None

    def once():
        nonlocal cots
        if not backward:
            with torch.no_grad():
                layers(x)
            return
        outs = layers(x)
        if cots is None:
            cots = [torch.randn(o.shape, generator=gen, device=o.device,
                                dtype=o.dtype) for o in outs]
        torch.autograd.backward(outs, cots)

    for _ in range(warm):
        once()
    cuda = x.device.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(x.device)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3
    else:
        seconds = time.perf_counter() - t0
    model.zero_grad(set_to_none=True)
    return seconds / reps
