"""The port's tracing and step timing (`neuronika_tpu_torch/utils/
profiler.py`) against the JAX package's (`neuronika_tpu/utils/
profiler.py`) on the CPU: the twin of tests/test_misc.py::test_step_timer
beside JAX's timer over the same steps (the same summary keys and step
counts), a result tree waited for on its devices, and `trace` writing a
Chrome trace that holds the block's ops."""

import json
import os

import numpy as np
import torch

from neuronika_tpu_torch.utils import profiler
from neuronika_tpu_torch.utils.profiler import StepTimer


def test_step_timer():
    t = StepTimer()
    for i in range(3):
        with t:
            t.observe(torch.ones((8, 8)) * i)
    s = t.summary(skip_first=1)
    assert s["steps"] == 2
    assert s["mean_ms"] > 0
    assert s["min_ms"] <= s["p50_ms"] <= s["max_ms"]


def test_summary_matches_jax_timers_layout():
    """Both timers over the same number of steps: the same keys, the same
    step counts with and without skipping, every time positive."""
    import jax.numpy as jnp

    from neuronika_tpu.utils.profiler import StepTimer as JTimer

    jt, pt = JTimer(), StepTimer()
    for i in range(4):
        with jt:
            jt.observe(jnp.ones((8, 8)) * i)
        with pt:
            pt.observe({"loss": torch.ones(()) * i,
                        "parts": [torch.zeros(3), (torch.ones(2),)]})
    for skip in (0, 1, 3):
        js, ps = jt.summary(skip_first=skip), pt.summary(skip_first=skip)
        assert js.keys() == ps.keys()
        assert js["steps"] == ps["steps"]
        assert ps["min_ms"] > 0
    assert len(pt.times) == len(jt.times) == 4
    # a step without a result is timed all the same
    with pt:
        pass
    assert len(pt.times) == 5 and pt._result is None


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiler.trace(logdir) as rec:
        a = torch.randn(64, 64)
        (a @ a).relu().sum()
    assert os.path.dirname(rec.path) == logdir and os.path.exists(rec.path)
    with open(rec.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
    with profiler.trace(logdir) as again:
        np.ones(3)
    assert again.path != rec.path
    assert len(os.listdir(logdir)) == 2
