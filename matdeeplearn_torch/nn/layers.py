"""Core layers with reference-parity numerics.

  * torch.nn.Linear's default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, drawn from an explicit torch.Generator, or on request
    Xavier-uniform (Glorot) weights with zero biases, SchNet's init,
  * BatchNorm1d over masked (padded) rows: statistics over true rows only,
    biased variance to normalize, unbiased for the running update,
    momentum 0.1, and the track_running_stats switch (models/cgcnn.py:84-87),
  * the activation table behind the config's `act` strings
    (models/cgcnn.py:127 getattr(F, act)).

Parameter names follow the reference package's scopes through convert.py:
Linear `weight` (out, in) is its `kernel` (in, out) transposed; BatchNorm
`weight`/`bias`/`running_mean`/`running_var` are `scale`/`bias`/`mean`/`var`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def torch_linear_init(tensor: torch.Tensor, fan_in: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill `tensor` in place from U(-k, k), k = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def xavier_uniform_init(tensor: torch.Tensor, fan_in: int, fan_out: int,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """Fill `tensor` in place from U(-k, k), k = sqrt(6/(fan_in+fan_out)):
    the reference package's glorot_uniform on the (in, out) kernel."""
    bound = math.sqrt(6.0 / (fan_in + fan_out)) if fan_in + fan_out > 0 else 0.0
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def shifted_softplus(x):
    """softplus(x) - log(2) — PyG SchNet's ShiftedSoftplus."""
    return F.softplus(x) - 0.6931471805599453


# F.softplus returns x above x = 20, where log1p(exp(x)) differs from x by
# less than exp(-20) ≈ 2e-9: the same f32 value. F.gelu takes the tanh
# approximation, the reference package's default.
ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "celu": F.celu,
    "selu": F.selu,
    "hardtanh": F.hardtanh,
    "relu6": F.relu6,
    "shifted_softplus": shifted_softplus,
}


def get_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'")
    return ACTIVATIONS[name]


class Linear(nn.Module):
    """Dense layer y = x W^T + b. init "torch": torch.nn.Linear's default
    init; "xavier": Xavier-uniform weight, zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, init: str = "torch",
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        if init not in ("torch", "xavier"):
            raise ValueError(f"unknown init {init!r}: expected torch|xavier")
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)
        if init == "xavier":
            xavier_uniform_init(self.weight, in_features, out_features,
                                generator)
            if self.bias is not None:
                nn.init.zeros_(self.bias)
            return
        torch_linear_init(self.weight, in_features, generator)
        if self.bias is not None:
            torch_linear_init(self.bias, in_features, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over masked (padded) rows.

    * training: normalize with biased batch statistics over rows where
      mask = 1; update the running statistics (unbiased variance) when
      track_stats.
    * eval: running statistics if track_stats, else batch statistics
      (torch's track_running_stats=False behaviour).
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, track_stats: bool = True,
                 device: str | torch.device | None = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.track_stats = track_stats
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, mask=None, use_running_average: bool = False):
        if use_running_average and self.track_stats:
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
                 if mask is None else mask.to(x.dtype)[:, None])
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(0) / count
            var = (((x - mean) ** 2) * m).sum(0) / count
            if self.track_stats and not use_running_average:
                with torch.no_grad():
                    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.weight + self.bias
