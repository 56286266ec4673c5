"""Optimizer and learning-rate scheduling (counterpart:
``bpx/train/optim.py``).

* ``adam``: ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8 added to the
  square root of the bias-corrected second moment: ``optax.adam``'s
  update);
* ``adamw``: ``torch.optim.AdamW`` with decoupled weight decay 0.01 on every
  parameter (``optax.adamw(weight_decay=0.01)``);
* ``radam`` and ``plain_radam``: :class:`bpx_torch.train.radam.RAdam`, the
  JAX package's rectified Adam (the two names are one optimizer there);
* :class:`PlateauScheduler` (ReduceLROnPlateau) and :class:`EarlyStopping`,
  plain Python, the JAX package's copies.

The learning rate lives in the optimizer's param groups; the host-side
scheduler rewrites it between epochs with :func:`set_lr`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Optional

import torch

from bpx_torch.train.radam import RAdam


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   name: str = "adam") -> torch.optim.Optimizer:
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    if name in ("radam", "plain_radam"):
        return RAdam(params, lr=lr)
    raise KeyError(f"unknown optimizer {name!r}")


def get_current_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Rewrite the learning rate of every param group in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (torch semantics, relative threshold).

    ``mode='max'`` for classification/multilabel tasks, ``'min'`` for the
    cmu-mosi regression metric.
    """

    lr: float
    mode: str = "max"                # "min" | "max"
    factor: float = 0.5
    patience: int = 2
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: Optional[float] = None
    num_bad_epochs: int = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold) \
                if self.best > 0 else metric > self.best + self.threshold
        return metric < self.best * (1.0 - self.threshold) \
            if self.best > 0 else metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Update with the epoch metric; returns the (possibly reduced) lr."""
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict):
        for k, v in state.items():
            setattr(self, k, v)


@dataclass
class EarlyStopping:
    """Early stopping on the tuning metric; improvement uses >= / <=.

    ``mode='min'`` for cmu-mosi (metric is MAE), else ``'max'``.
    """

    patience: int = 10
    mode: str = "max"
    best: float = float("-inf")
    n_no_improve: int = 0

    def __post_init__(self):
        if self.mode == "min" and self.best == float("-inf"):
            self.best = float("inf")

    def update(self, metric: float) -> bool:
        """Returns True when this epoch is an improvement."""
        metric = float(metric)
        improved = (metric <= self.best if self.mode == "min"
                    else metric >= self.best)
        if improved:
            self.best = metric
            self.n_no_improve = 0
        else:
            self.n_no_improve += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.n_no_improve >= self.patience

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict):
        for k, v in state.items():
            setattr(self, k, v)
