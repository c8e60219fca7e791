"""Global configuration of the port (counterpart of `neuronika_tpu/config.py`).

Four switches, each with the JAX package's meaning:
* `use_kernels` (JAX `use_pallas`): route the define-by-run `mm` and
  last-axis `softmax`/`log_softmax` ops to the hand-written CUDA kernels
  (K3, K4) for CUDA tensors, and `convolution` to the direct-conv kernels
  (K12, K14, K15) where `conv_route` lets it. Opt-in, read from
  `NEURONIKA_TPU_TORCH_KERNELS`; `enable_kernels` toggles it and clears the
  executor caches, as `enable_pallas` does. The flash-attention op is gated
  by the device and shape alone, as the JAX op is gated by the backend.
* `conv_route` (JAX `pallas_conv_route`), read from
  `NEURONIKA_TPU_TORCH_CONV`: "auto" lets `ops.conv.route_conv2d`'s
  per-shape table pick the conv tier under `use_kernels`; "force" always
  takes the direct-conv kernels (their plain versions on the CPU). The
  table is the JAX package's, measured on a TPU v5e, with its on-card
  rank-2 row sent to the library by H100 timings (`ops.conv.route_conv2d`).
* `device`: where the factories put new leaves, "cuda" unless a caller sets
  "cpu" (JAX's default backend plays this part).
* the global seed stream used by `rand` and dropout: `seed(s)` and
  `next_seed()`, integers drawn from a `torch.Generator` (JAX: `next_key`).
"""

from __future__ import annotations

import os
import threading

import torch


class _Config(threading.local):
    def __init__(self) -> None:
        self.use_kernels: bool = (
            os.environ.get("NEURONIKA_TPU_TORCH_KERNELS", "0") == "1")
        self.conv_route: str = os.environ.get("NEURONIKA_TPU_TORCH_CONV",
                                              "auto")
        self.device: str = "cuda"
        self._gen = None

    # ------------------------------------------------------------------ rng
    def seed(self, seed: int) -> None:
        """Seed the global stream used by `rand` and dropout."""
        self._gen = torch.Generator().manual_seed(int(seed))

    def next_seed(self) -> int:
        """One fresh integer seed off the global stream."""
        if self._gen is None:
            self.seed(0x5EED ^ os.getpid())
        return int(torch.randint(0, 1 << 62, (1,), generator=self._gen))


config = _Config()


def seed(s: int) -> None:
    """Seed the framework-global random stream."""
    config.seed(s)


def enable_kernels(on: bool = True) -> None:
    """Toggle the CUDA kernel tier of the define-by-run ops and clear the
    executor caches (the JAX package bakes the choice into its compiled
    tapes; here the cache key carries it)."""
    config.use_kernels = bool(on)
    from ._engine import executor

    executor.clear_cache()
