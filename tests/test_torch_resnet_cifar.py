"""The twin of the JAX package's `examples/resnet_cifar.py`
(neuronika_tpu_torch/examples/resnet_cifar.py) on the CPU with fewer
steps: it runs from start to end and its loss falls, and its synthetic
data keeps the JAX example's contract (the class is the position of a
bright 8x8 patch: pixels inside it >= 0.5, outside < 0.5)."""

import importlib.util
import os

import jax
import numpy as np
import torch

from neuronika_tpu.models import resnet as JR
from neuronika_tpu_torch.examples import resnet_cifar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _patch_mask(y):
    """(B, 32, 32) bool: the 8x8 block at row (y % 4) 8, column (y // 4) 8."""
    rr = np.arange(32)[None, :, None]
    cc = np.arange(32)[None, None, :]
    row, col = (y % 4)[:, None, None] * 8, (y // 4)[:, None, None] * 8
    return (rr >= row) & (rr < row + 8) & (cc >= col) & (cc < col + 8)


def test_synthetic_data_keeps_the_jax_examples_contract():
    spec = importlib.util.spec_from_file_location(
        "jax_example_resnet_cifar",
        os.path.join(ROOT, "examples", "resnet_cifar.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    jx, jy = (np.asarray(a) for a in jex.synthetic_batch(
        jax.random.key(0), 64, 10))
    x, y = resnet_cifar.synthetic_batch(torch.Generator().manual_seed(0),
                                        64, 10)
    x, y = x.numpy(), y.numpy()
    for imgs, labels in ((jx, jy), (x, y)):
        assert imgs.shape == (64, 32, 32, 3) and labels.shape == (64,)
        assert 0 <= labels.min() and labels.max() < 10
        assert imgs.min() >= 0.0 and imgs.max() <= 1.0
        np.testing.assert_array_equal((imgs >= 0.5).all(-1),
                                      _patch_mask(labels))
        np.testing.assert_array_equal((imgs >= 0.5).any(-1),
                                      _patch_mask(labels))


def test_twin_runs_and_its_loss_falls():
    out = resnet_cifar.main(device="cpu", steps=24, batch=16, verbose=False)
    losses = out["losses"]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0], losses
    assert 0.0 <= out["accuracy"] <= 1.0
    jp = JR.init_params(jax.random.key(0), JR.ResNetConfig(
        stages=(2, 2, 2), width=32, num_classes=10))
    assert out["n_params"] == sum(a.size for a in jax.tree.leaves(jp))
