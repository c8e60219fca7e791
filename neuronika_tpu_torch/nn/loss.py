"""Free-function loss criteria (counterpart of `neuronika_tpu/nn/loss.py`):
wrappers over the `Var` methods, as the reference documents `nn::loss`."""

from __future__ import annotations

from ..variable import Reduction, Var

__all__ = [
    "Reduction", "mae_loss", "mse_loss", "bce_loss",
    "bce_with_logits_loss", "kldiv_loss", "nll_loss",
]


def mae_loss(input: Var, target: Var, reduction: str = Reduction.Mean):
    return input.mae(target, reduction)


def mse_loss(input: Var, target: Var, reduction: str = Reduction.Mean):
    return input.mse(target, reduction)


def bce_loss(input: Var, target: Var, reduction: str = Reduction.Mean):
    return input.bce(target, reduction)


def bce_with_logits_loss(input: Var, target: Var,
                         reduction: str = Reduction.Mean):
    return input.bce_with_logits(target, reduction)


def kldiv_loss(input: Var, target: Var, reduction: str = Reduction.Mean):
    return input.kldiv(target, reduction)


def nll_loss(input: Var, target: Var, reduction: str = Reduction.Mean):
    return input.nll(target, reduction)
