"""MNIST-style CNN (counterpart of `neuronika_tpu/models/cnn.py`): Conv2d,
MaxPool and Linear with dropout, built from the define-by-run layer kit.
Under `enable_kernels()` on the card its convolutions can take K12
(`config.conv_route`), its products K3 and its loss's last-axis
log-softmax K4."""

from __future__ import annotations

from typing import List

from .. import Zero
from .. import nn
from ..variable import Var, VarDiff


class MnistCNN:
    """conv3x3(1 -> c) -> relu -> maxpool2 -> conv3x3(c -> 2c) -> relu ->
    maxpool2 -> flatten -> dropout(p) -> linear -> relu -> linear(10)."""

    def __init__(self, channels: int = 16, hidden: int = 64,
                 dropout: float = 0.25, image: int = 28) -> None:
        self.status = nn.ModelStatus.default()
        reg = self.status.register
        self.conv1 = reg(nn.Conv2d(1, channels, 3, 1, Zero(), 1, 1))
        self.conv2 = reg(nn.Conv2d(channels, 2 * channels, 3, 1, Zero(), 1,
                                   1))
        self.drop = reg(nn.Dropout(dropout))
        feat = 2 * channels * (image // 4) * (image // 4)
        self.fc1 = reg(nn.Linear(feat, hidden))
        self.fc2 = reg(nn.Linear(hidden, 10))

    def parameters(self) -> List[VarDiff]:
        return self.status.parameters()

    def train(self) -> None:
        self.status.train()

    def eval(self) -> None:
        self.status.eval()

    def forward(self, x: Var) -> VarDiff:
        """x: (N, 1, H, W) -> logits (N, 10)."""
        x = self.conv1.forward(x).relu().max_pool((2, 2))
        x = self.conv2.forward(x).relu().max_pool((2, 2))
        x = self.drop.forward(x.flatten())
        x = self.fc1.forward(x).relu()
        return self.fc2.forward(x)
