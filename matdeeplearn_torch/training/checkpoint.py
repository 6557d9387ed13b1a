"""The port's checkpoint format: one torch.save file.

  {"meta": json string, "params": {name: tensor},
   "batch_stats": {name: tensor}, "optimizer": optimizer state_dict or None}

`meta` has the reference package's keys (model_name, model_config,
scheduler), so the model is rebuilt by registry name, and the scheduler's
state is recorded as the reference package records it. `params` and
`batch_stats` split the model's state_dict into parameters and running
statistics; `optimizer` (written by Training) holds the optimizer's state
with its learning rate, so `load_model: "True"` resumes parameters,
statistics and optimizer as the reference package's
load_checkpoint(path, run.state) does. Only tensors, numbers and strings
are stored: loading uses torch.load(weights_only=True) and runs no pickled
code. Reading the reference package's msgpack checkpoints goes through
convert.py (a test converts them; ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import json
import os

import torch

_STAT_NAMES = ("running_mean", "running_var")


def split_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """state_dict → (params, batch_stats), tensors detached on the CPU."""
    params, stats = {}, {}
    for k, v in state_dict.items():
        (stats if k.rsplit(".", 1)[-1] in _STAT_NAMES else params)[k] = (
            v.detach().cpu().clone())
    return params, stats


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: dict, model_name: str,
                    model_config: dict, scheduler=None,
                    extra_meta: dict | None = None,
                    optimizer_state: dict | None = None):
    meta = {
        "model_name": model_name,
        "model_config": model_config,
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        **(extra_meta or {}),
    }
    params, stats = split_state_dict(state_dict)
    tmp = path + ".tmp"
    torch.save({"meta": json.dumps(meta), "params": params,
                "batch_stats": stats,
                "optimizer": _to_cpu(optimizer_state)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, with_optimizer: bool = False):
    """Returns (meta dict, state_dict with params and batch_stats merged),
    and with `with_optimizer` also the optimizer state (None if absent)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = (json.loads(payload["meta"]), {**payload["params"],
                                          **payload["batch_stats"]})
    if with_optimizer:
        return out + (payload.get("optimizer"),)
    return out
