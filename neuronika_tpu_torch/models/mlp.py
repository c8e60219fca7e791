"""Quickstart MLP (counterpart of `neuronika_tpu/models/mlp.py`): the
reference quickstart's 3->5->5->1 network as a reusable model class."""

from __future__ import annotations

from typing import List, Sequence

from .. import nn
from ..variable import Var, VarDiff


class MLP:
    """Linear -> ReLU stack; the last layer linear."""

    def __init__(self, sizes: Sequence[int] = (3, 5, 5, 1)) -> None:
        self.status = nn.ModelStatus.default()
        self.layers: List[nn.Linear] = [
            self.status.register(nn.Linear(i, o))
            for i, o in zip(sizes[:-1], sizes[1:])]

    def parameters(self) -> List[VarDiff]:
        return self.status.parameters()

    def train(self) -> None:
        self.status.train()

    def eval(self) -> None:
        self.status.eval()

    def forward(self, x: Var) -> VarDiff:
        for layer in self.layers[:-1]:
            x = layer.forward(x).relu()
        return self.layers[-1].forward(x)
