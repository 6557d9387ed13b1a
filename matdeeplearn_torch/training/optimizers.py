"""Optimizer registry: the reference's names on torch.optim, with torch's
default hyperparameters (AdamW weight_decay 0.01, and so on).

The reference resolves optimizers by name on torch.optim
(training/training.py:429-433); so does the port. Weight decay applies to
every parameter, biases and BatchNorm included, as optax's adamw does
without a mask.

Adam and AdamW on a CUDA device are built with `capturable=True` and the
learning rate as a device tensor: the trainer's plateau scheduler then sets
the rate on the device, and a training step never waits for the host.
Elsewhere the rate is a Python float.
"""

from __future__ import annotations

import torch

_OPTIMIZERS = {
    "AdamW": torch.optim.AdamW,
    "Adam": torch.optim.Adam,
    "SGD": torch.optim.SGD,
    "RMSprop": torch.optim.RMSprop,
    "Adagrad": torch.optim.Adagrad,
}
_CAPTURABLE = ("AdamW", "Adam")


def build_optimizer(name: str, params, lr: float, optimizer_args: dict | None,
                    device: str | torch.device = "cpu") -> torch.optim.Optimizer:
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{name}'; have {sorted(_OPTIMIZERS)}")
    args = dict(optimizer_args or {})
    if "betas" in args:
        args["betas"] = tuple(args["betas"])
    if name in _CAPTURABLE and torch.device(device).type == "cuda":
        args.setdefault("capturable", True)
        lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
    return _OPTIMIZERS[name](params, lr=lr if torch.is_tensor(lr) else float(lr),
                             **args)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Set every group's rate: in place on the device when the group holds
    a tensor rate (no host sync), else as a float."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]) and torch.is_tensor(lr):
            group["lr"].copy_(lr)
        elif torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """state_dict with every group's rate as a float, for checkpoints."""
    sd = optimizer.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = float(group["lr"])
    return sd


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """load_state_dict across devices: the optimizer keeps its own
    `capturable` setting (so a state saved on the card resumes on the CPU
    and back; torch then places each step count to match) and a tensor rate
    stays a tensor on its device."""
    rates = [g["lr"] for g in optimizer.param_groups]
    sd = {**sd, "param_groups": [
        {**saved, **{k: cur[k] for k in ("capturable",) if k in cur}}
        for saved, cur in zip(sd["param_groups"], optimizer.param_groups)]}
    optimizer.load_state_dict(sd)
    for group, old in zip(optimizer.param_groups, rates):
        if torch.is_tensor(old):
            old.fill_(float(group["lr"]))
            group["lr"] = old
