"""Parameter initialisation (counterpart of `neuronika_tpu/nn/init.py`).

Every function writes through the variable's buffer with `Var.assign`; they
take a `Var` or a `VarDiff`. The random draws come from a `torch.Generator`
seeded from the global stream (`config.next_seed()`), on the CPU and then
moved, as `rand` draws, so a seed gives the same values on every device.
JAX draws from `jax.random`, so the two packages' values differ; weights
are carried across with `nn.params_from_jax` or `utils.serde`.

`calculate_fan_in_fan_out` uses the *product* of the receptive-field dims,
as the JAX package does (the reference's snapshot sums them, a known bug).
"""

from __future__ import annotations

import math

import torch

from ..config import config

__all__ = [
    "calculate_gain", "calculate_fan_in_fan_out", "constant", "zeros",
    "ones", "eye", "dirac", "uniform", "normal", "xavier_uniform",
    "xavier_normal",
]


def calculate_gain(non_linearity: str) -> float:
    """Recommended gain for an activation."""
    if non_linearity in ("linear", "sigmoid", "conv"):
        return 1.0
    if non_linearity == "tanh":
        return 5.0 / 3.0
    if non_linearity == "relu":
        return math.sqrt(2.0)
    if non_linearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + 0.01 ** 2))
    raise ValueError(f"unsupported non-linearity: {non_linearity}")


def calculate_fan_in_fan_out(param) -> tuple:
    """(fan_in, fan_out) of a parameter of rank 2 or more."""
    shape = param.shape
    if len(shape) < 2:
        raise ValueError(
            "fan in and fan out can not be computed for tensor with fewer "
            "than 2 dimensions")
    receptive = math.prod(shape[2:])
    return float(shape[1] * receptive), float(shape[0] * receptive)


def constant(param, value: float) -> None:
    param.assign(torch.full(param.shape, float(value), dtype=torch.float32))


def zeros(param) -> None:
    constant(param, 0.0)


def ones(param) -> None:
    constant(param, 1.0)


def eye(param) -> None:
    if len(param.shape) != 2:
        raise ValueError("eye init requires a 2-dimensional parameter")
    param.assign(torch.eye(*param.shape, dtype=torch.float32))


def dirac(param, groups: int = 1) -> None:
    """Dirac delta init of a 1-d, 2-d or 3-d conv kernel (rank 3, 4 or 5),
    which preserves the identity of the inputs."""
    shape = param.shape
    if len(shape) not in (3, 4, 5):
        raise ValueError(
            "dirac init requires a 3, 4 or 5-dimensional parameter")
    out_ch, in_ch = shape[0], shape[1]
    if out_ch % groups != 0:
        raise ValueError("output channels must be divisible by groups")
    out_per_group = out_ch // groups
    arr = torch.zeros(shape, dtype=torch.float32)
    centers = tuple(d // 2 for d in shape[2:])
    for g in range(groups):
        for d in range(min(out_per_group, in_ch)):
            arr[(g * out_per_group + d, d) + centers] = 1.0
    param.assign(arr)


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(config.next_seed())


def uniform(param, low: float, high: float) -> None:
    t = torch.empty(param.shape, dtype=torch.float32)
    param.assign(t.uniform_(float(low), float(high), generator=_generator()))


def normal(param, mean: float, std: float) -> None:
    t = torch.randn(param.shape, generator=_generator(), dtype=torch.float32)
    param.assign(mean + std * t)


def xavier_uniform(param, gain: float = 1.0) -> None:
    fan_in, fan_out = calculate_fan_in_fan_out(param)
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    uniform(param, -a, a)


def xavier_normal(param, gain: float = 1.0) -> None:
    fan_in, fan_out = calculate_fan_in_fan_out(param)
    normal(param, 0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)))
