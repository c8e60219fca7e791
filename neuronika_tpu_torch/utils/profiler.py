"""Tracing and step timing (counterpart of `neuronika_tpu/utils/profiler.py`).

`trace(logdir)` records the enclosed block with `torch.profiler` (host
activity, and the card's kernels where CUDA is available) and writes one
Chrome-trace JSON file into `logdir`, which `chrome://tracing`, Perfetto
or TensorBoard's profile plugin open. `StepTimer` times steps on the host
clock and, at the end of each, waits for the step's result on its device
(`observe`), as JAX's timer blocks on its result.
"""

from __future__ import annotations

import contextlib
import os
import time
import types
from typing import Dict, List, Optional

import torch

__all__ = ["trace", "StepTimer"]


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write
    `<logdir>/trace_<pid>_<ns>.json` (Chrome trace format). Yields a
    record whose `path` names that file once the block has ended
    (`prof` is the running `torch.profiler.profile`)."""
    os.makedirs(logdir, exist_ok=True)
    rec = types.SimpleNamespace(path=None,
                                prof=torch.profiler.profile(
                                    activities=_activities()))
    with rec.prof:
        yield rec
    rec.path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
    rec.prof.export_chrome_trace(rec.path)


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of `result` (a tensor
    or a tree of dicts, lists and tuples of them)."""
    devices = set()
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock step timer with device synchronisation.

    >>> timer = StepTimer()
    >>> for batch in data:
    ...     with timer:
    ...         out = step(batch)
    ...         timer.observe(out)   # exit waits for `out` on its device
    >>> timer.summary()
    """

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._result = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def observe(self, result) -> None:
        """Register the step's output so that exit waits for it."""
        self._result = result

    def __exit__(self, *exc) -> bool:
        if self._result is not None:
            _synchronize(self._result)
            self._result = None
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        ts = self.times[skip_first:] or self.times
        ts = sorted(ts)
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            "min_ms": ts[0] * 1e3,
            "max_ms": ts[-1] * 1e3,
        }
