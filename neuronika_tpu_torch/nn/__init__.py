"""Neural-network layers (counterpart of `neuronika_tpu/nn/__init__.py`).

Layers are plain Python objects holding `VarDiff` parameters, as in JAX;
`forward` records the define-by-run graph with the JAX package's formulas.
They are not `torch.nn.Module`s: the tape they record is the port's own,
not autograd's. The reference's quirks are kept:
* the LSTM state is `(cell, hidden)`, cell first, and the second gate chunk
  goes through tanh;
* a conv layer pads, convolves VALID (the kernel is the receiver of
  `convolution`) and adds its bias unsqueezed once per spatial axis;
* `Dropout` reads the train/eval `StatusCell` that `ModelStatus.register`
  hands it, so `ModelStatus.train()`/`eval()` switch every registered
  dropout.

Parameters are drawn by `init` from the global seed stream; JAX's values
are carried into a port layer or model by `params_from_jax`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .. import zeros as _zeros
from ..variable import StatusCell, Var, VarDiff
from . import init, loss
from .recurrent import GRU, LSTM

__all__ = [
    "Linear", "LSTMCell", "GRUCell", "LSTM", "GRU",
    "Conv1d", "Conv2d", "Conv3d",
    "GroupedConv1d", "GroupedConv2d", "GroupedConv3d",
    "Dropout", "ModelStatus", "Learnable", "Param", "init", "loss",
    "params_from_jax",
]

# a learnable parameter IS a differentiable variable
Learnable = VarDiff
Param = VarDiff


def params_from_jax(model_or_layer, arrays: Sequence) -> None:
    """Write `arrays` (a JAX layer's or model's `parameters()`, as numpy
    arrays, in their order) into the port's `model_or_layer.parameters()`,
    checking the count and every shape."""
    params = model_or_layer.parameters()
    arrays = list(arrays)
    if len(arrays) != len(params):
        raise ValueError(f"{len(arrays)} arrays for {len(params)} "
                         f"parameters")
    for i, (p, a) in enumerate(zip(params, arrays)):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"parameter {i}: array of shape {a.shape} for "
                             f"a parameter of shape {p.shape}")
        p.assign(a)


class ModelStatus:
    """Train/eval switch and parameter registry. `register(layer)` records
    the layer's parameters and hands the shared status cell to layers with
    stochastic behaviour (`Dropout`)."""

    def __init__(self) -> None:
        self._cell = StatusCell(True)
        self._params: List[VarDiff] = []

    @classmethod
    def default(cls) -> "ModelStatus":
        return cls()

    @property
    def cell(self) -> StatusCell:
        return self._cell

    def register(self, layer):
        self._params.extend(layer.parameters())
        if hasattr(layer, "set_status"):
            layer.set_status(self._cell)
        return layer

    def parameters(self) -> List[VarDiff]:
        return list(self._params)

    def train(self) -> None:
        self._cell.set(True)

    def eval(self) -> None:
        self._cell.set(False)


class Linear:
    """y = x W^T + b; weight (out, in) and bias (out,), both U(-k, k) with
    k = sqrt(1/in)."""

    def __init__(self, in_features: int, out_features: int) -> None:
        self.weight = _zeros((out_features, in_features)).requires_grad()
        self.bias = _zeros(out_features).requires_grad()
        k = math.sqrt(1.0 / in_features)
        init.uniform(self.weight, -k, k)
        init.uniform(self.bias, -k, k)

    def parameters(self) -> List[VarDiff]:
        return [self.weight, self.bias]

    def forward(self, input: Var) -> VarDiff:
        return input.mm_t(self.weight) + self.bias


class LSTMCell:
    """One LSTM step. The state is `(cell_state, hidden)`, and the gate
    activations in chunk order are (sigmoid, tanh, sigmoid, sigmoid). All
    parameters U(-k, k), k = sqrt(1/hidden)."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        x4 = 4 * hidden_size
        self.weight_ih = _zeros((x4, input_size)).requires_grad()
        self.weight_hh = _zeros((x4, hidden_size)).requires_grad()
        self.bias_ih = _zeros(x4).requires_grad()
        self.bias_hh = _zeros(x4).requires_grad()
        k = math.sqrt(1.0 / hidden_size)
        for p in self.parameters():
            init.uniform(p, -k, k)

    def parameters(self) -> List[VarDiff]:
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]

    def forward(self, state: Tuple[Var, Var],
                input: Var) -> Tuple[VarDiff, VarDiff]:
        cell_state, hidden = state
        gates = (hidden.mm_t(self.weight_hh) + self.bias_hh
                 + input.mm_t(self.weight_ih) + self.bias_ih)
        batch, x4 = gates.shape
        g = gates.chunks((batch, x4 // 4))
        input_gate = g[0].sigmoid()
        forget_gate = g[1].tanh()
        cell_gate = g[2].sigmoid()
        output_gate = g[3].sigmoid()
        new_cell = forget_gate * cell_state + input_gate * cell_gate
        new_hidden = output_gate * new_cell.tanh()
        return new_cell, new_hidden


class GRUCell:
    """One GRU step."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        x3 = 3 * hidden_size
        self.weight_ih = _zeros((x3, input_size)).requires_grad()
        self.weight_hh = _zeros((x3, hidden_size)).requires_grad()
        self.bias_ih = _zeros(x3).requires_grad()
        self.bias_hh = _zeros(x3).requires_grad()
        k = math.sqrt(1.0 / hidden_size)
        for p in self.parameters():
            init.uniform(p, -k, k)

    def parameters(self) -> List[VarDiff]:
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]

    def forward(self, hidden: Var, input: Var) -> VarDiff:
        igates = input.mm_t(self.weight_ih) + self.bias_ih
        hgates = hidden.mm_t(self.weight_hh) + self.bias_hh
        batch, x3 = hgates.shape
        ig = igates.chunks((batch, x3 // 3))
        hg = hgates.chunks((batch, x3 // 3))
        reset_gate = (hg[0] + ig[0]).sigmoid()
        input_gate = (hg[1] + ig[1]).sigmoid()
        new_gate = (ig[2] + hg[2] * reset_gate).tanh()
        return (hidden - new_gate) * input_gate + new_gate


class _ConvNd:
    """The conv layers' shared machinery: weight (out, in/groups, *kernel)
    and bias (out,), U(-k, k) with k = sqrt(groups / (in prod(kernel)))."""

    _nd: int = 0

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 padding, padding_mode, stride, dilation,
                 groups: int = 1) -> None:
        ks = self._tuple(kernel_size)
        self.padding = self._tuple(padding)
        self.padding_mode = padding_mode
        self.stride = self._tuple(stride)
        self.dilation = self._tuple(dilation)
        self.groups = int(groups)
        if in_channels % self.groups or out_channels % self.groups:
            raise ValueError("in/out channels must be divisible by groups")
        self.weight = _zeros(
            (out_channels, in_channels // self.groups, *ks)).requires_grad()
        self.bias = _zeros(out_channels).requires_grad()
        k = math.sqrt(self.groups / (in_channels * math.prod(ks)))
        init.uniform(self.weight, -k, k)
        init.uniform(self.bias, -k, k)

    def _tuple(self, v) -> Tuple[int, ...]:
        if isinstance(v, (tuple, list)):
            if len(v) != self._nd:
                raise ValueError(f"expected {self._nd} values, got {len(v)}")
            return tuple(int(x) for x in v)
        return (int(v),) * self._nd

    def parameters(self) -> List[VarDiff]:
        return [self.weight, self.bias]

    def forward(self, input: Var) -> VarDiff:
        x = input
        if any(self.padding):
            x = x.pad(self.padding, self.padding_mode)
        out = self.weight.convolution(x, self.stride, self.dilation,
                                      self.groups)
        b = self.bias
        for _ in range(self._nd):
            b = b.unsqueeze(1)  # (out,) -> (out, 1, ...): broadcasts over N
        return out + b


class Conv1d(_ConvNd):
    _nd = 1


class Conv2d(_ConvNd):
    _nd = 2


class Conv3d(_ConvNd):
    _nd = 3


def _grouped(cls):
    class Grouped(cls):
        def __init__(self, in_channels, out_channels, kernel_size, padding,
                     padding_mode, stride, dilation, groups):
            super().__init__(in_channels, out_channels, kernel_size, padding,
                             padding_mode, stride, dilation, groups)

    Grouped.__name__ = Grouped.__qualname__ = "Grouped" + cls.__name__
    Grouped.__doc__ = f"{cls.__name__} with `groups` required."
    return Grouped


GroupedConv1d = _grouped(Conv1d)
GroupedConv2d = _grouped(Conv2d)
GroupedConv3d = _grouped(Conv3d)


class Dropout:
    """Dropout at rate `p`, scaled 1/(1-p) in training and the identity in
    eval, switched by a `ModelStatus`'s cell once registered."""

    def __init__(self, p: float) -> None:
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"dropout probability has to be between 0 and 1, but got {p}")
        self.p = float(p)
        self._status = StatusCell(True)

    def set_status(self, cell: StatusCell) -> None:
        self._status = cell

    def parameters(self) -> List[VarDiff]:
        return []

    def forward(self, input: Var) -> Var:
        return input.dropout(self.p, self._status)
