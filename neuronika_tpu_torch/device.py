"""Device placement for the port (counterpart of `neuronika_tpu/device.py`).

Under PyTorch placement is a `torch.device` carried by every tensor, so the
surface is small: enumerate the devices (`Device`, `devices`,
`default_device`), turn what a caller asked for into a device and refuse
what this process cannot give (`resolve`), move a variable's buffer
(`to_device`) and ask where it lives (`device_of`). Asking for CUDA where
there is none raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .config import config

__all__ = ["Device", "devices", "default_device", "resolve", "to_device",
           "device_of"]

# JAX names the CUDA backend "gpu"
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def _platform(platform: Optional[str]) -> str:
    if platform is None:
        platform = torch.device(config.device).type
    if platform not in _PLATFORMS:
        raise ValueError(f"unsupported platform {platform!r} (cpu, cuda or "
                         f"gpu)")
    return _PLATFORMS[platform]


def _count(platform: str) -> int:
    """Devices of a platform this process can use: the CPU is one device;
    asking for CUDA where there is none raises, as `resolve` does."""
    if platform == "cpu":
        return 1
    resolve("cuda")
    return torch.cuda.device_count()


class Device:
    """Handle to one device of a platform ("cpu" or "cuda", "gpu" read as
    "cuda"; `config.device`'s platform when None). It wraps a
    `torch.device`, as the JAX class wraps a jax.Device."""

    def __init__(self, index: int = 0, platform: Optional[str] = None) -> None:
        plat = _platform(platform)
        n = _count(plat)
        if not 0 <= index < n:
            raise ValueError(f"device index {index} out of range ({n} "
                             f"present)")
        self.torch_device = (torch.device("cpu") if plat == "cpu"
                             else torch.device("cuda", index))

    @property
    def platform(self) -> str:
        return self.torch_device.type

    @property
    def index(self) -> int:
        return self.torch_device.index or 0

    def __eq__(self, other) -> bool:
        return (isinstance(other, Device)
                and other.torch_device == self.torch_device)

    def __hash__(self) -> int:
        return hash(self.torch_device)

    def __repr__(self) -> str:
        return f"Device({self.torch_device})"


def devices(platform: Optional[str] = None) -> List[Device]:
    """Every device of a platform (`config.device`'s when None)."""
    plat = _platform(platform)
    return [Device(i, plat) for i in range(_count(plat))]


def default_device() -> Device:
    """The device the factories put new leaves on: `config.device`'s."""
    d = resolve(config.device)
    return Device(d.index or 0, d.type)


def resolve(device: Union[str, torch.device, Device]) -> torch.device:
    """`"cpu"`, `"cuda"`, `"cuda:N"`, a `torch.device` or a `Device` -> a
    `torch.device` with its index filled in for CUDA."""
    if isinstance(device, Device):
        device = device.torch_device
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
