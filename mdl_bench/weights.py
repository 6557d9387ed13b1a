"""The weights of a run, made by the benchmark from --seed and handed to
the program and to the reference alike.

One torch.Generator on the run's device draws one uniform block for the
whole table of the configuration's reference (reference/<model>.py:
param_table), in one call; each leaf takes its slice: Linear-style leaves
U(-bound, bound), BatchNorm's scale 1 ± 0.1, shift, running mean ± 0.1 and
running variance 1 ± 0.1."""

from __future__ import annotations

import math

import torch

_AFFINE = {"bn_weight": (1.0, 0.1), "bn_bias": (0.0, 0.1),
           "bn_running_mean": (0.0, 0.1), "bn_running_var": (1.0, 0.1)}


def make(table: list, seed: int, device) -> dict:
    """{name: tensor} for `table` [(name, shape, kind, bound)]."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    sizes = [math.prod(shape) for _, shape, _, _ in table]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape, kind, bound), part in zip(table, u.split(sizes)):
        centre, scale = _AFFINE.get(kind, (0.0, bound))
        out[name] = (centre + scale * part).reshape(shape)
    return out


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the model's state; the names and shapes have to
    be the model's, every one."""
    state = model.state_dict()
    if set(state) != set(weights):
        raise ValueError("the program's state and the reference's table "
                         f"differ: only in the program {sorted(set(state) - set(weights))},"
                         f" only in the table {sorted(set(weights) - set(state))}")
    with torch.no_grad():
        for k, v in state.items():
            if tuple(v.shape) != tuple(weights[k].shape):
                raise ValueError(f"{k}: program {tuple(v.shape)}, table "
                                 f"{tuple(weights[k].shape)}")
            v.copy_(weights[k])
