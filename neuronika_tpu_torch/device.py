"""Device placement for the port (counterpart of `neuronika_tpu/device.py`).

Under PyTorch placement is a `torch.device` carried by every tensor, so the
surface is small: turn what a caller asked for into a device and refuse
what this process cannot give (`resolve`), move a variable's buffer
(`to_device`) and ask where it lives (`device_of`). Asking for CUDA where
there is none raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve", "to_device", "device_of"]


def resolve(device: Union[str, torch.device]) -> torch.device:
    """`"cpu"`, `"cuda"`, `"cuda:N"` or a `torch.device` -> a
    `torch.device` with its index filled in for CUDA."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False")
    if d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if d.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r} out of range "
                           f"({torch.cuda.device_count()} present)")
    return d


def to_device(variable, device):
    """Move a leaf variable's buffer to `device` (in place; returns the
    variable). The reference builds a `CuVar` copy instead."""
    node = variable.node
    if not node.is_leaf():
        raise ValueError("to_device moves leaf variables; an op's result "
                         "follows its operands")
    dev = resolve(device)
    node.value = node.get_value().to(dev)
    node.device = dev
    node.computed = True
    return variable


def device_of(variable) -> torch.device:
    """The device a variable's buffer lives on."""
    return variable.node.device
