"""Core layers with reference-parity numerics.

  * torch.nn.Linear's default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, drawn from an explicit torch.Generator, or on request
    Xavier-uniform (Glorot) weights with zero biases, SchNet's init,
  * BatchNorm1d over masked (padded) rows: statistics over true rows only,
    biased variance to normalize, unbiased for the running update,
    momentum 0.1, and the track_running_stats switch (models/cgcnn.py:84-87),
  * the activation table behind the config's `act` strings
    (models/cgcnn.py:127 getattr(F, act)),
  * a single-step GRU with torch.nn.GRU's gates and layout (MPNN), and a
    single-step LSTM with torch.nn.LSTM's (Set2Set),
  * the plain Linear(+activation) stack of MEGNet's embeddings (MLP).

Mixed precision (`precision: bf16`, models/base.py) follows the reference
package's nn/layers.py: parameters stay f32 masters and are cast to the
activations' dtype where they are used (Linear, GRUCell, LSTMCell), so
their gradients reach them as f32 through the cast; each product
accumulates in f32 and is rounded to the activation dtype once, and a bias
is added after that rounding, as a second rounding (`dense`); BatchNorm
computes in f32 and casts its output back. An f32 input runs the f32 code
of before, bit for bit.

Parameter names follow the reference package's scopes through convert.py:
Linear `weight` (out, in) is its `kernel` (in, out) transposed; BatchNorm
`weight`/`bias`/`running_mean`/`running_var` are `scale`/`bias`/`mean`/`var`;
GRUCell and LSTMCell `weight_ih`/`weight_hh` are `w_ih`/`w_hh` transposed
and `bias_ih`/`bias_hh` are `b_ih`/`b_hh`.
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


# Under bf16 activations the reference package's activations lower to
# chains of bf16 operations, each rounding to bf16: sigmoid as
# 1 / (1 + exp(-x)), softplus as max(x, 0) + log1p(exp(-|x|)), silu as
# x · sigmoid(x), and a Python constant is rounded to bf16 before it is
# used. torch's fused bf16 kernels compute in f32 and round once, which
# parts from those in about a third of the values by one bf16 unit, so for
# bf16 inputs these follow the reference's chains; f32 inputs take torch's
# functions.
LN2 = 0.6931471805599453
LN2_BF16 = 0.69140625  # LN2 rounded to bf16


def sigmoid(x):
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x):
    if x.dtype == torch.float32:
        return F.softplus(x)
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def silu(x):
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


def shifted_softplus(x):
    """softplus(x) - log(2) — PyG SchNet's ShiftedSoftplus."""
    return softplus(x) - (LN2 if x.dtype == torch.float32 else LN2_BF16)


# F.softplus returns x above x = 20, where log1p(exp(x)) differs from x by
# less than exp(-20) ≈ 2e-9: the same f32 value. F.gelu takes the tanh
# approximation, the reference package's default.
ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "silu": silu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "softplus": softplus,
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


def dense(x, weight, bias=None):
    """x @ weightᵀ + bias. For an f32 x, F.linear. For a bf16 x, weight and
    bias cast to bf16, the product rounded to bf16 once (f32 accumulation)
    and the bias added after it, each step rounding once, as the reference
    package's Linear does (nn/layers.py:109-113); F.linear would round the
    product and the bias sum together."""
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = torch.matmul(x, weight.to(x.dtype).t())
    return y if bias is None else y + bias.to(x.dtype)


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
        return dense(x, self.weight, self.bias)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over masked (padded) rows.

    * training: normalize with biased batch statistics over rows where
      mask = 1; update the running statistics (unbiased variance) when
      track_stats.
    * eval: running statistics if track_stats, else batch statistics
      (torch's track_running_stats=False behaviour).

    Statistics, running buffers and the normalisation are f32 whatever the
    input's dtype; the output takes the input's dtype (the reference
    package's nn/layers.py:155-187).
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
        # off while a remat recomputation repeats a training forward
        self.update_stats = True

    def forward(self, x, mask=None, use_running_average: bool = False):
        in_dtype = x.dtype
        x = x.float()
        if use_running_average and self.track_stats:
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
                 if mask is None else mask.to(x.dtype)[:, None])
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(0) / count
            var = (((x - mean) ** 2) * m).sum(0) / count
            if (self.track_stats and not use_running_average
                    and self.update_stats):
                with torch.no_grad():
                    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean) * inv * self.weight + self.bias).to(in_dtype)


class GRUCell(nn.Module):
    """One step of torch.nn.GRU (MPNN runs it on sequences of length one):
    gates r, z, n in torch's order, n = tanh(i_n + r·h_n), h' = (1-z)·n + z·h.
    Parameters in torch's layout, weight_ih (3H, in), weight_hh (3H, H),
    bias_ih and bias_hh (3H,), all drawn from U(-1/√H, 1/√H). Under bf16
    activations each product rounds before its bias add, and h is cast to
    x's dtype (the reference package's nn/layers.py:203-217)."""

    def __init__(self, input_size: int, hidden: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        shapes = {"weight_ih": (3 * hidden, input_size),
                  "weight_hh": (3 * hidden, hidden),
                  "bias_ih": (3 * hidden,), "bias_hh": (3 * hidden,)}
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape, device=device))
            torch_linear_init(p, hidden, generator)
            self.register_parameter(name, p)

    def forward(self, x, h):
        i_r, i_z, i_n = dense(x, self.weight_ih, self.bias_ih).chunk(3, -1)
        h_r, h_z, h_n = dense(h.to(x.dtype), self.weight_hh,
                              self.bias_hh).chunk(3, -1)
        r = sigmoid(i_r + h_r)
        z = sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class LSTMCell(nn.Module):
    """One step of torch.nn.LSTM (Set2Set runs it on sequences of length
    one): gates i, f, g, o in torch's order, c' = f·c + i·tanh(g),
    h' = o·tanh(c'). Parameters in torch's layout, weight_ih (4H, in),
    weight_hh (4H, H), bias_ih and bias_hh (4H,), all drawn from
    U(-1/√H, 1/√H). The gates sum as the reference package's do
    (nn/layers.py:234-240), left to right, each term rounded under bf16
    activations: ((x W_ihᵀ + b_ih) + h W_hhᵀ) + b_hh."""

    def __init__(self, input_size: int, hidden: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        shapes = {"weight_ih": (4 * hidden, input_size),
                  "weight_hh": (4 * hidden, hidden),
                  "bias_ih": (4 * hidden,), "bias_hh": (4 * hidden,)}
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape, device=device))
            torch_linear_init(p, hidden, generator)
            self.register_parameter(name, p)

    def forward(self, x, h, c):
        g = (dense(x, self.weight_ih, self.bias_ih)
             + dense(h.to(x.dtype), self.weight_hh)
             + self.bias_hh.to(x.dtype))
        i, f, gg, o = g.chunk(4, -1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(gg)
        return sigmoid(o) * torch.tanh(c_new), c_new


class MLP(nn.Module):
    """Linear layers `lin{i}` of widths `features`, each followed by the
    activation, the last one too when `act_last` (the reference's embed
    MLPs end in ReLU, models/megnet.py:222-230)."""

    def __init__(self, in_features: int, features, act: str = "relu",
                 act_last: bool = True, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.act, self.act_last = get_activation(act), act_last
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"lin{i}", Linear(in_features, f,
                                              generator=generator,
                                              device=device))
            in_features = f

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"lin{i}")(x)
            if i < self.depth - 1 or self.act_last:
                x = self.act(x)
        return x
