"""neuronika_tpu_torch: the PyTorch and CUDA port of neuronika_tpu.

The JAX package `neuronika_tpu` stays the reference; this package mirrors
its module names (`variable.py`, `_engine/`, `ops/functional.py`, `optim/`,
`models/transformer.py`, `serving.py`, `device.py`, `config.py`) so that
each function has a counterpart to be held against. It imports torch and
never jax. Hand-written CUDA kernels live in `csrc/` and are compiled with
nvcc at their first launch, never at import (see `_build.py`).

Quickstart, the define-by-run tier (as the JAX package's):

    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"          # default "cuda"
    x = nk.rand((16, 3))
    w = nk.rand((5, 3)).requires_grad()
    b = nk.zeros(5).requires_grad()
    y = x.mm_t(w) + b
    loss = y.relu().mse(nk.zeros((16, 5)), nk.Reduction.Mean)
    loss.forward()
    loss.backward(1.0)

`nk.enable_kernels()` routes `mm` and last-axis softmax to the CUDA kernels
(K3, K4) for tensors on the card.

Ported so far: the define-by-run tier (`Var`/`VarDiff`, the executor, the
op registry, the factories, the Var GPT builders) and its layer kit: `nn`
(layers, `init`, `loss`, the scan-node `LSTM`/`GRU`), `device` (`Device`,
`devices`, `default_device`), `optim` (SGD, Adam, AMSGrad, AdamW, Lion,
Adafactor, Muon, Adagrad, RMSProp, `lr_scheduler`), `data`, `utils`
(`serde`, `gradcheck`), the small Var models (`models.MLP`, `MnistCNN`,
`CharRNN`) and twins of the JAX package's quickstart, MNIST CNN and
char-RNN examples (`neuronika_tpu_torch.examples`); paged GPT serving (`serving.PagedBatcher`) with the
paged-attention decode kernel, and the functional GPT training step
(`models.transformer.make_train_step`, `optim.functional`) with the
packed-qkv flash-attention forward and backward kernels; and the
language-model loop around it: `train.Trainer` (schedule, clipping,
accumulation, JSONL metrics, checkpoints, resume, eval), the eval step
(`make_eval_step`, `evaluate`), dense KV-cache generation (`generate`,
`make_generate`, `make_beam_search`, `make_prefill`, `make_decode_step`),
all the functional optimizer rules, `utils.checkpoint`, `utils.metrics`,
`utils.save_pytree`/`load_pytree`, `data.BpeTokenizer`, and twins of the
text-pipeline and GPT examples.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config, enable_kernels, seed
from .ops.functional import as_dtype
from .variable import (Reduction, StatusCell, Var, VarDiff, _apply, _leaf,
                       _tensor, _to_operand)

__version__ = "0.1.0"

__all__ = [
    "Var", "VarDiff", "Reduction", "StatusCell", "seed", "config",
    "enable_kernels",
    "from_ndarray", "zeros", "ones", "full", "rand", "eye",
    "linspace", "logspace", "geomspace", "range", "cat", "stack",
    "Zero", "Constant", "Reflective", "Replicative",
    "nn", "optim", "data", "models", "utils", "device", "train",
    "Device", "devices", "default_device", "to_device", "device_of",
    "Param", "Learnable",
]


# --------------------------------------------------------------------------
# padding modes


class _PadMode:
    name = "zero"
    value = 0.0


class Zero(_PadMode):
    """Zero padding."""
    name = "zero"


class Constant(_PadMode):
    """Constant-value padding."""
    name = "constant"

    def __init__(self, value: float) -> None:
        self.value = float(value)


class Reflective(_PadMode):
    """Mirror padding (excluding the border element)."""
    name = "reflective"


class Replicative(_PadMode):
    """Edge-replication padding."""
    name = "replicative"


# --------------------------------------------------------------------------
# factory functions; `device=None` means `config.device`. The reference is
# f32-only; `dtype=` is the JAX package's extension.


def _shape_tuple(shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dev(device):
    from .device import resolve

    return resolve(config.device if device is None else device)


def _f32(t: torch.Tensor, device) -> Var:
    return _leaf(t.to(_dev(device)))


def from_ndarray(array, dtype=torch.float32, device=None) -> Var:
    """A leaf variable holding a copy of `array`."""
    return _leaf(_tensor(array, as_dtype(dtype), _dev(device)))


def zeros(shape, dtype=torch.float32, device=None) -> Var:
    return _leaf(torch.zeros(_shape_tuple(shape), dtype=as_dtype(dtype),
                             device=_dev(device)))


def ones(shape, dtype=torch.float32, device=None) -> Var:
    return _leaf(torch.ones(_shape_tuple(shape), dtype=as_dtype(dtype),
                            device=_dev(device)))


def full(shape, elem: float, dtype=torch.float32, device=None) -> Var:
    return _leaf(torch.full(_shape_tuple(shape), elem, dtype=as_dtype(dtype),
                            device=_dev(device)))


def rand(shape, dtype=torch.float32, device=None) -> Var:
    """Uniform [0, 1) leaf drawn from the global seed stream (on the CPU,
    then moved, so a seed gives the same values on every device)."""
    gen = torch.Generator().manual_seed(config.next_seed())
    t = torch.rand(_shape_tuple(shape), generator=gen, dtype=torch.float32)
    return _leaf(t.to(_dev(device), as_dtype(dtype)))


def eye(n: int, device=None) -> Var:
    return _f32(torch.eye(int(n), dtype=torch.float32), device)


def linspace(start: float, end: float, n: int, device=None) -> Var:
    return _f32(torch.linspace(start, end, int(n), dtype=torch.float32),
                device)


def logspace(base: float, start: float, end: float, n: int,
             device=None) -> Var:
    exps = torch.linspace(start, end, int(n), dtype=torch.float32)
    return _f32(torch.pow(torch.tensor(base, dtype=torch.float32), exps),
                device)


def geomspace(start: float, end: float, n: int, device=None) -> Var:
    """Geometric progression; both bounds must share a sign and be nonzero
    (returns None otherwise, as the reference does)."""
    if start == 0.0 or end == 0.0 or (start < 0.0) != (end < 0.0):
        return None
    return _f32(torch.from_numpy(
        np.geomspace(start, end, int(n)).astype(np.float32)), device)


def range(start: float, end: float, step: float, device=None) -> Var:  # noqa: A001
    return _f32(torch.arange(start, end, step, dtype=torch.float32), device)


# --------------------------------------------------------------------------
# free binary cat/stack


def _pair(lhs, rhs):
    dev = next((v.device for v in (lhs, rhs) if isinstance(v, Var)), None)
    return (_to_operand(lhs, device=dev or _dev(None)),
            _to_operand(rhs, device=dev or _dev(None)))


def cat(lhs, rhs, axis: int):
    return _apply("cat", _pair(lhs, rhs), (int(axis),))


def stack(lhs, rhs, axis: int):
    return _apply("stack", _pair(lhs, rhs), (int(axis),))


from . import nn, optim, data, models, utils, device, train  # noqa: E402
from .device import (Device, default_device, device_of, devices,  # noqa: E402
                     to_device)

# a learnable parameter IS a differentiable variable
Param = VarDiff
Learnable = VarDiff
