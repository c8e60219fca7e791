"""The reference's configs[3] on the port (neuronika_tpu_torch/utils/
gradcheck.py and the conv train step): the port's finite-difference
`gradcheck` over test_gradcheck_sweep.py's conv cases and dense chain, and
a conv kernel trained 8 steps by each of the ten optimizers against the
JAX package. The conv cases: the JAX file's Conv1d (stride 2, dilation 2,
groups 2; the library convolution on every route), and a stride-1 Conv1d
and Conv3d, which take K14 and K15 under `enable_kernels()` with
`conv_route="force"` (their plain versions on the CPU; `chip_smoke.py`
phase 15 runs the same sweep on the card). The loss must fall under each
optimizer, and the losses and the kernel after every step must match
JAX's within TOL (1e-5) relative and TOL of the largest entry (at least
1) absolute."""

import numpy as np
import pytest

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu import optim as joptim
from neuronika_tpu_torch import optim as toptim
from neuronika_tpu_torch.ops.functional import OPS, _register
from neuronika_tpu_torch.utils import gradcheck
from neuronika_tpu_torch.variable import _apply
from tests.conftest import TOL


@pytest.fixture(autouse=True)
def _cpu():
    old, route = nk.config.device, nk.config.conv_route
    nk.config.device = "cpu"
    yield
    nk.config.device = old
    nk.config.conv_route = route
    nk.enable_kernels(False)


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CONV_CASES = [
    # (input shape, kernel shape, stride, dilation, groups)
    ((1, 2, 8), (3, 2, 3), (1,), (1,), 1),
    ((1, 2, 9), (2, 2, 3), (2,), (1,), 1),
    ((1, 2, 9), (2, 2, 2), (1,), (2,), 1),
    ((1, 4, 7), (4, 2, 3), (1,), (1,), 2),
    ((1, 2, 5, 5), (2, 2, 2, 2), (1, 1), (1, 1), 1),
    ((1, 1, 4, 4, 4), (1, 1, 2, 2, 2), (1, 1, 1), (1, 1, 1), 1),
]


@pytest.mark.parametrize("xs,ks,stride,dil,groups", CONV_CASES)
def test_conv_gradcheck(xs, ks, stride, dil, groups):
    x, k = rnd(*xs), rnd(*ks, seed=1) * 0.5
    assert gradcheck(lambda kern, inp: kern.convolution(
        inp, stride, dil, groups).sum(), [k, x])


def test_dense_chain_gradcheck():
    assert gradcheck(lambda xv, wv: xv.mm_t(wv).tanh().mse(
        nk.zeros((3, 2)), nk.Reduction.Mean), [rnd(3, 4), rnd(2, 4) * 0.5])


def test_gradcheck_catches_a_wrong_vjp():
    """A VJP off by a factor of 2 must fail the check. The op is taken out
    of the registry again, which other tests hold to JAX's."""
    name = "_test_square_bad_vjp"
    _register(name, lambda e, a: a * a, lambda e, p, o, g: (g * p[0],))
    try:
        with pytest.raises(AssertionError, match="gradcheck failed"):
            gradcheck(lambda v: _apply(name, (v,)).sum(), [rnd(3)])
    finally:
        del OPS[name]


OPTIMIZERS = {
    "sgd": lambda m: m.StochasticGD(0.01),
    "sgd_nesterov": lambda m: m.StochasticGD(0.01, momentum=0.9,
                                             nesterov=True),
    "adam": lambda m: m.Adam(0.01),
    "amsgrad": lambda m: m.AMSGrad(0.01),
    "adamw": lambda m: m.AdamW(0.01),
    "lion": lambda m: m.Lion(0.01),
    "adafactor": lambda m: m.Adafactor(0.01),
    "muon": lambda m: m.Muon(0.01),
    "adagrad": lambda m: m.Adagrad(0.01),
    "rmsprop": lambda m: m.RMSProp(0.01, alpha=0.9, momentum=0.5,
                                   centered=True),
}
# (name, kernel shape, input shape, stride, dilation, groups)
SWEEP_CASES = [
    ("conv1d_grouped", (4, 2, 3), (2, 4, 12), (2,), (2,), 2),
    ("conv1d", (4, 4, 3), (2, 4, 12), (1,), (1,), 1),
    ("conv3d", (4, 2, 2, 2, 2), (2, 2, 5, 5, 5), (1, 1, 1), (1, 1, 1), 1),
]


def _sweep(pkg, optmod, make, case, steps=8):
    """The JAX file's conv train step: loss = mean(conv(x)^2), step-wise
    forward, backward, step, zero_grad. Returns the losses and the kernel
    after every step."""
    _, ks, xs, stride, dil, groups = case
    kernel = pkg.from_ndarray(rnd(*ks, seed=2) * 0.3).requires_grad()
    x = pkg.from_ndarray(rnd(*xs, seed=3))
    opt = make(optmod)
    opt.register(kernel)
    losses, kernels = [], []
    for _ in range(steps):
        loss = kernel.convolution(x, stride, dil, groups).pow(2).mean()
        loss.forward()
        loss.backward(1.0)
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        kernels.append(np.asarray(kernel.data()))
    return losses, kernels


def close(a, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(a, np.float64), ref, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(ref).max(initial=0.0))))


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in
                                                   SWEEP_CASES])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_conv_train_step_each_optimizer(name, case):
    jl, jw = _sweep(jk, joptim, OPTIMIZERS[name], case)
    nk.enable_kernels(True)
    nk.config.conv_route = "force"
    tl, tw = _sweep(nk, toptim, OPTIMIZERS[name], case)
    assert tl[-1] < tl[0], tl
    close(tl, jl)
    for a, b in zip(tw, jw):
        close(a, b)
