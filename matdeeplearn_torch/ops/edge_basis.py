"""On-device Gaussian edge-basis expansion.

The dataset stores one normalized scalar distance per edge; the model
expands it to `resolution` Gaussian channels on the device, with the
reference formula (process.py:580-590; data/graphs.py:gaussian_basis is the
numpy twin).
"""

from __future__ import annotations

import torch


def gaussian_basis(
    dist: torch.Tensor,
    start: float = 0.0,
    stop: float = 1.0,
    resolution: int = 50,
    width: float = 0.2,
) -> torch.Tensor:
    """(E,) scalar distances → (E, resolution) Gaussian features.

    coeff = -0.5 / ((stop - start) * width)^2, offsets linspace(start, stop).
    torch.linspace may place an offset one ulp away from numpy's or the
    reference package's linspace; the features then differ by ~1e-7
    relative, far inside every stated tolerance.
    """
    offsets = torch.linspace(start, stop, resolution, dtype=dist.dtype,
                             device=dist.device)
    coeff = -0.5 / ((stop - start) * width) ** 2
    diff = dist[..., None] - offsets
    return torch.exp(coeff * diff * diff)
