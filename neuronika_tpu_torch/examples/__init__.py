"""Twins of the JAX package's examples (`examples/quickstart.py`,
`mnist_cnn.py`, `char_rnn.py`, `text_pipeline.py`, `gpt_train.py`,
`resnet_cifar.py`): the same recipes on the port, each a
`main(device=..., ...)` that returns its losses (the last three a dict of
their results). Run one with

    python -m neuronika_tpu_torch.examples.quickstart

(on the card; `main(device="cpu")` runs it on the CPU)."""

from __future__ import annotations

import contextlib

from ..config import config


@contextlib.contextmanager
def on_device(device):
    """Set `config.device` to `device` (when not None) for the block."""
    old = config.device
    if device is not None:
        config.device = str(device)
    try:
        yield
    finally:
        config.device = old
