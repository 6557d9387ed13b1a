"""Weight converter between the reference package's parameter trees and
the port's state_dicts.

  params_from_jax(params, batch_stats) -> state_dict
  params_to_jax(state_dict)            -> (params, batch_stats)

The reference trees are nested dicts of numpy arrays (or anything np.asarray
takes). Scope names carry over with "." for "/" (`pre_lin0`,
`conv{i}.lin_f`, `conv{i}.lin_s`, `bn{i}`, `post_lin{i}`, `lin_out`,
`edge_nn{i}.lin0`, `gru{i}`, ...):

  Linear     kernel (in, out) <-> weight (out, in), transposed;  bias <-> bias
  BatchNorm  scale <-> weight, bias <-> bias (params);
             mean <-> running_mean, var <-> running_var (batch_stats)
  GRUCell    w_ih (in, 3H) <-> weight_ih (3H, in), w_hh <-> weight_hh, both
             transposed; b_ih <-> bias_ih, b_hh <-> bias_hh
  NNConv     root (din, dim) <-> root, as it is
"""

from __future__ import annotations

import numpy as np
import torch

_STAT_TO_TORCH = {"mean": "running_mean", "var": "running_var"}
_STAT_FROM_TORCH = {v: k for k, v in _STAT_TO_TORCH.items()}
# parameters stored transposed, and as they are (the Linear kernel and the
# BatchNorm scale, which share the torch name `weight`, come apart by rank)
_TRANSPOSED = {"kernel": "weight", "w_ih": "weight_ih", "w_hh": "weight_hh"}
_AS_IS = {"scale": "weight", "bias": "bias", "b_ih": "bias_ih",
          "b_hh": "bias_hh", "root": "root"}
_FROM_TORCH_T = {v: k for k, v in _TRANSPOSED.items()}
_FROM_TORCH = {v: k for k, v in _AS_IS.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(params: dict, batch_stats: dict | None = None) -> dict:
    """Reference (params, batch_stats) trees → torch state_dict of float32 tensors."""
    out = {}
    for path, leaf in _leaves(params):
        scope, name = ".".join(path[:-1]), path[-1]
        if name in _TRANSPOSED:
            out[f"{scope}.{_TRANSPOSED[name]}"] = torch.tensor(leaf.T.copy())
        elif name in _AS_IS:
            out[f"{scope}.{_AS_IS[name]}"] = torch.tensor(leaf)
        else:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
    for path, leaf in _leaves(batch_stats or {}):
        scope, name = ".".join(path[:-1]), path[-1]
        if name not in _STAT_TO_TORCH:
            raise KeyError(f"unknown batch statistic {'/'.join(path)}")
        out[f"{scope}.{_STAT_TO_TORCH[name]}"] = torch.tensor(leaf)
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """Torch state_dict → reference (params, batch_stats) trees as nested numpy dicts."""
    params, batch_stats = {}, {}
    for key, t in state_dict.items():
        *scope, name = key.split(".")
        a = t.detach().cpu().numpy()
        if name in _FROM_TORCH_T and not (name == "weight" and a.ndim == 1):
            _put(params, scope + [_FROM_TORCH_T[name]], a.T.copy())
        elif name in _FROM_TORCH:
            _put(params, scope + [_FROM_TORCH[name]], a)
        elif name in _STAT_FROM_TORCH:
            _put(batch_stats, scope + [_STAT_FROM_TORCH[name]], a)
        else:
            raise KeyError(f"unknown state_dict entry {key}")
    return params, batch_stats
