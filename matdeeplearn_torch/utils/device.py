"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another.

    A CUDA request on a host without CUDA raises: nothing moves to the CPU
    on its own. It also turns off cuBLAS's reduced-precision reductions
    of bf16 GEMMs (on by default in torch), so that a bf16 product
    accumulates in f32 as the reference package's `preferred_element_type`
    does (`precision: bf16`).
    """
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (CLI: --device=cpu) to run on the CPU"
        )
    return dev
