"""ReduceLROnPlateau with torch.optim.lr_scheduler semantics.

The reference steps its scheduler on the *training* error every epoch
(training/training.py:193 — a deliberate quirk we preserve) with config
{"mode": "min", "factor": 0.8, "patience": 10, "min_lr": 1e-5,
 "threshold": 2e-4} (config.yml:140). Host-side state, a copy of the
reference package's training/scheduler.py; the trainer runs the same
rule on the device (training/trainer.py:plateau_step) and writes its state
back here for the checkpoint.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0
    best: float | None = None
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            eps = self.threshold
            if self.mode == "min":
                return current < self.best * (1.0 - eps)
            return current > self.best * (1.0 + eps)
        if self.mode == "min":
            return current < self.best - self.threshold
        return current > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Record a metric; returns the (possibly reduced) learning rate."""
        current = float(metric)
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "ReduceLROnPlateau":
        return cls(**d)


class ConstantLR:
    """Fallback for scheduler: "None" or unknown names."""

    def __init__(self, lr: float, **_):
        self.lr = lr

    def step(self, metric: float) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    @classmethod
    def from_state_dict(cls, d: dict):
        return cls(**d)


SCHEDULERS = {
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "None": ConstantLR,
    "ConstantLR": ConstantLR,
}


def build_scheduler(name: str, lr: float, scheduler_args: dict | None):
    """Name-resolved scheduler construction (reference reflection on
    torch.optim.lr_scheduler, training/training.py:434-436)."""
    cls = SCHEDULERS.get(name, ConstantLR)
    args = dict(scheduler_args or {})
    args.pop("mode", None) if cls is ConstantLR else None
    try:
        return cls(lr=lr, **args)
    except TypeError:
        return ConstantLR(lr)
