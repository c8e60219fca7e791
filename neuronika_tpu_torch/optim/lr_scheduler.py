"""Learning-rate schedulers (counterpart of
`neuronika_tpu/optim/lr_scheduler.py`).

Each scheduler wraps an optimizer and tracks `(last_lr, current_lr,
current_epoch)`; `step()` advances the epoch, then sets the optimizer's lr.
All of it is host-side Python over `get_lr`/`set_lr`: the optimizers read
lr afresh at every update, so a schedule changes no cached step list."""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = [
    "LRScheduler", "ExponentialLR", "LambdaLR", "MultiplicativeLR",
    "MultiStepLR", "StepLR", "WarmupCosineLR",
]


class LRScheduler:
    """Base scheduler: epoch and lr bookkeeping."""

    def __init__(self, optimizer) -> None:
        self.optimizer = optimizer
        self.current_epoch = 0
        self.current_lr = optimizer.get_lr()
        self.last_lr = 0.0

    def _prepare_step(self) -> None:
        self.last_lr = self.current_lr
        self.current_epoch += 1

    def step(self) -> None:
        raise NotImplementedError

    def get_last_lr(self) -> float:
        return self.last_lr

    def get_current_lr(self) -> float:
        return self.current_lr

    def get_current_epoch(self) -> int:
        return self.current_epoch

    def set_current_epoch(self, epoch: int) -> None:
        self.current_epoch = int(epoch)

    def print_lr(self) -> None:
        print(
            f"epoch {self.current_epoch}: learning rate adjusted to "
            f"[{self.current_lr}]"
        )


class ExponentialLR(LRScheduler):
    """lr <- lr gamma every epoch."""

    def __init__(self, optimizer, gamma: float) -> None:
        super().__init__(optimizer)
        self.gamma = float(gamma)

    def set_gamma(self, gamma: float) -> None:
        self.gamma = float(gamma)

    def step(self) -> None:
        self._prepare_step()
        self.current_lr = self.last_lr * self.gamma
        self.optimizer.set_lr(self.current_lr)


class StepLR(LRScheduler):
    """lr <- lr gamma every `step_size` epochs."""

    def __init__(self, optimizer, step_size: int, gamma: float) -> None:
        super().__init__(optimizer)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def step(self) -> None:
        self._prepare_step()
        if self.current_epoch % self.step_size == 0:
            self.current_lr = self.last_lr * self.gamma
            self.optimizer.set_lr(self.current_lr)


class MultiStepLR(LRScheduler):
    """lr <- lr gamma at each milestone epoch."""

    def __init__(self, optimizer, milestones: Sequence[int], gamma: float) -> None:
        super().__init__(optimizer)
        self.milestones = [int(m) for m in milestones]
        self.gamma = float(gamma)

    def step(self) -> None:
        self._prepare_step()
        if self.current_epoch in self.milestones:
            self.current_lr = self.last_lr * self.gamma
            self.optimizer.set_lr(self.current_lr)


class LambdaLR(LRScheduler):
    """lr <- initial_lr fn(epoch)."""

    def __init__(self, optimizer, lr_fn: Callable[[int], float]) -> None:
        super().__init__(optimizer)
        self.initial_lr = optimizer.get_lr()
        self.lr_fn = lr_fn

    def step(self) -> None:
        self._prepare_step()
        self.current_lr = self.initial_lr * self.lr_fn(self.current_epoch)
        self.optimizer.set_lr(self.current_lr)


class MultiplicativeLR(LRScheduler):
    """lr <- lr fn(epoch)."""

    def __init__(self, optimizer, lr_fn: Callable[[int], float]) -> None:
        super().__init__(optimizer)
        self.lr_fn = lr_fn

    def step(self) -> None:
        self._prepare_step()
        self.current_lr = self.last_lr * self.lr_fn(self.current_epoch)
        self.optimizer.set_lr(self.current_lr)


class WarmupCosineLR(LRScheduler):
    """Linear warmup, then cosine decay to `min_lr` over `total_epochs`."""

    def __init__(self, optimizer, warmup_epochs: int, total_epochs: int,
                 min_lr: float = 0.0) -> None:
        super().__init__(optimizer)
        if warmup_epochs < 0 or total_epochs <= warmup_epochs:
            raise ValueError("need 0 <= warmup_epochs < total_epochs")
        self.peak_lr = optimizer.get_lr()
        self.warmup_epochs = int(warmup_epochs)
        self.total_epochs = int(total_epochs)
        self.min_lr = float(min_lr)

    def step(self) -> None:
        self._prepare_step()
        e = self.current_epoch
        if e <= self.warmup_epochs and self.warmup_epochs > 0:
            lr = self.peak_lr * e / self.warmup_epochs
        else:
            t = (e - self.warmup_epochs) / max(
                self.total_epochs - self.warmup_epochs, 1
            )
            t = min(t, 1.0)
            lr = self.min_lr + 0.5 * (self.peak_lr - self.min_lr) * (
                1.0 + math.cos(math.pi * t)
            )
        self.current_lr = lr
        self.optimizer.set_lr(lr)
