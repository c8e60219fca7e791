"""Whole-sequence recurrent layers (counterpart of
`neuronika_tpu/nn/recurrent.py`).

`LSTM` and `GRU` run a whole sequence as one graph node, the registry ops
`lstm_scan` and `gru_scan`, with the cells' gate formulas (the LSTM's
second gate chunk tanh'd, as the reference has it). JAX runs the sequence
as a `lax.scan` and derives the VJP by transposing the step; here the
forward is a loop over T in plain torch (XLA computes these products in
JAX, so they are no kernel's), and the VJP is backpropagation through time
by `torch.autograd.grad` over a forward recomputed on detached leaves: no
autograd history outlives the call.
"""

from __future__ import annotations

import math
from typing import List

import torch

from .. import zeros as _zeros
from ..ops.functional import _register
from ..variable import Var, VarDiff, _apply
from . import init

__all__ = ["LSTM", "GRU"]


def _promoted(*ts):
    """Every operand in their promoted dtype (JAX's promotion of the step's
    products and sums)."""
    ct = ts[0].dtype
    for t in ts[1:]:
        ct = torch.promote_types(ct, t.dtype)
    return [t.to(ct) for t in ts]


def _lstm_scan_fwd(e, x, w_ih, w_hh, b_ih, b_hh):
    """x (T, B, I) -> the hidden states (T, B, H); state starts at 0."""
    x, w_ih, w_hh, b_ih, b_hh = _promoted(x, w_ih, w_hh, b_ih, b_hh)
    shape = (x.shape[1], w_hh.shape[1])
    c = torch.zeros(shape, dtype=x.dtype, device=x.device)
    h = torch.zeros(shape, dtype=x.dtype, device=x.device)
    hs = []
    for xt in x:
        gates = h @ w_hh.T + b_hh + xt @ w_ih.T + b_ih
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.tanh(f) * c + torch.sigmoid(i) * torch.sigmoid(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def _gru_scan_fwd(e, x, w_ih, w_hh, b_ih, b_hh):
    x, w_ih, w_hh, b_ih, b_hh = _promoted(x, w_ih, w_hh, b_ih, b_hh)
    h = torch.zeros((x.shape[1], w_hh.shape[1]), dtype=x.dtype,
                    device=x.device)
    hs = []
    for xt in x:
        i0, i1, i2 = (xt @ w_ih.T + b_ih).chunk(3, dim=1)
        h0, h1, h2 = (h @ w_hh.T + b_hh).chunk(3, dim=1)
        reset = torch.sigmoid(h0 + i0)
        inp = torch.sigmoid(h1 + i1)
        new = torch.tanh(i2 + h2 * reset)
        h = (h - new) * inp + new
        hs.append(h)
    return torch.stack(hs)


def _scan_vjp(fwd):
    def vjp(e, p, o, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in p]
            return torch.autograd.grad(fwd(e, *leaves), leaves, g)

    return vjp


_register("lstm_scan", _lstm_scan_fwd, _scan_vjp(_lstm_scan_fwd))
_register("gru_scan", _gru_scan_fwd, _scan_vjp(_gru_scan_fwd))


class _RecurrentBase:
    _op = ""
    _gates = 0

    def __init__(self, input_size: int, hidden_size: int) -> None:
        xh = self._gates * hidden_size
        self.weight_ih = _zeros((xh, input_size)).requires_grad()
        self.weight_hh = _zeros((xh, hidden_size)).requires_grad()
        self.bias_ih = _zeros(xh).requires_grad()
        self.bias_hh = _zeros(xh).requires_grad()
        k = math.sqrt(1.0 / hidden_size)
        for p in self.parameters():
            init.uniform(p, -k, k)

    def parameters(self) -> List[VarDiff]:
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]

    def forward(self, x: Var) -> VarDiff:
        """x (T, B, input) -> hidden states (T, B, hidden) as one node."""
        return _apply(self._op, (x, self.weight_ih, self.weight_hh,
                                 self.bias_ih, self.bias_hh))


class LSTM(_RecurrentBase):
    """Whole-sequence LSTM as one node."""

    _op = "lstm_scan"
    _gates = 4


class GRU(_RecurrentBase):
    """Whole-sequence GRU as one node."""

    _op = "gru_scan"
    _gates = 3
