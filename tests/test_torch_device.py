"""The port's device module (neuronika_tpu_torch/device.py) beside the JAX
package's: `Device`, `devices` and `default_device` on the CPU (JAX's
"gpu" read as "cuda"), moving a leaf and computing where it lives, and
CUDA refused, never replaced by the CPU, where there is no card."""

import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu_torch import device as D


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def test_cpu_devices_match_jax():
    """JAX's test mesh is CPU devices; the port's CPU is one device."""
    ds = nk.devices("cpu")
    assert len(ds) == 1 and ds[0].platform == "cpu" and ds[0].index == 0
    assert jk.devices()[0].platform == ds[0].platform
    assert nk.devices() == ds
    assert nk.default_device() == nk.Device(0, "cpu") == ds[0]
    assert nk.default_device().torch_device == torch.device("cpu")
    assert "cpu" in repr(ds[0])


def test_device_index_validation():
    with pytest.raises(ValueError, match="out of range"):
        nk.Device(1, "cpu")
    with pytest.raises(ValueError, match="out of range"):
        nk.Device(-1)
    with pytest.raises(ValueError, match="platform"):
        nk.Device(0, "tpu")


def test_to_device_takes_a_device():
    v = nk.from_ndarray(np.arange(4.0))
    assert nk.to_device(v, nk.default_device()) is v
    assert nk.device_of(v) == torch.device("cpu")
    np.testing.assert_array_equal(v.data().numpy(), np.arange(4.0))
    assert D.resolve(nk.Device(0, "cpu")) == torch.device("cpu")


def test_compute_follows_placement():
    v = nk.to_device(nk.ones((2, 2)), nk.default_device()).requires_grad()
    y = (v * 2.0).sum()
    y.forward()
    y.backward(1.0)
    np.testing.assert_array_equal(v.grad().numpy(), np.full((2, 2), 2.0))


@pytest.mark.parametrize("platform", ["cuda", "gpu"])
def test_cuda_without_a_card_raises(monkeypatch, platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        nk.Device(0, platform)
    with pytest.raises(RuntimeError, match="is_available"):
        nk.devices(platform)
    nk.config.device = "cuda"
    for call in (nk.default_device, nk.devices, lambda: nk.zeros(2)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()

