"""The port's optimizers (neuronika_tpu_torch/optim/) and learning-rate
schedulers against the JAX package's on the CPU.

Every optimizer (SGD plain and Nesterov, Adam, AMSGrad, AdamW, Lion,
Adafactor, Muon, Adagrad, RMSProp centered with momentum) under each
penalty (none, L1, L2, ElasticNet), in f32 and in bf16, over 5 steps on a
matrix, a vector and a rank-3 tensor (Adafactor's factored state over a
leading axis, Muon's batched Newton-Schulz). Both packages get the same
gradients through loss = sum(p * G_t), a fresh G each step, and the state
dtypes must be JAX's.
* f32: the parameters after every step and the state after the last
  within TOL (1e-5) relative and TOL of the largest entry (at least 1)
  absolute.
* bf16: each step starts from JAX's parameters and state, and its result
  must lie within one bf16 ulp of JAX's (f32 state within the f32 bound).
  Run apart, the two drift: XLA contracts a*b + c into one fused
  multiply-add, so an f32 sum now and then rounds to the other bf16
  neighbour, and momentum carries that ulp into later steps, where it may
  be more than one ulp of a smaller value.
Lion steps by sign(.), which flips for an argument within rounding of 0
and then moves an entry by 2 lr; the normal draws keep every argument far
from 0, so Lion is held to the same bounds. Muon's Newton-Schulz products
are f32 matmuls in both packages on the CPU. Then the fused `train_step`
against `step()` for every optimizer, and each scheduler's lr over 20
epochs equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu import optim as joptim
from neuronika_tpu_torch import optim as toptim
from neuronika_tpu_torch.ops.functional import dtype_name
from neuronika_tpu_torch.variable import _to_numpy
from tests.conftest import TOL

OPTIMIZERS = {
    "sgd": lambda m, pen: m.SGD(0.05, pen),
    "sgd_nesterov": lambda m, pen: m.SGD(0.05, pen, momentum=0.9,
                                         nesterov=True),
    "adam": lambda m, pen: m.Adam(0.01, penalty=pen),
    "amsgrad": lambda m, pen: m.AMSGrad(0.01, penalty=pen),
    "adamw": lambda m, pen: m.AdamW(0.01, weight_decay=0.1, penalty=pen),
    "lion": lambda m, pen: m.Lion(0.01, weight_decay=0.1, penalty=pen),
    "adafactor": lambda m, pen: m.Adafactor(0.05, weight_decay=0.01,
                                            penalty=pen),
    "muon": lambda m, pen: m.Muon(0.02, penalty=pen),
    "adagrad": lambda m, pen: m.Adagrad(0.05, lr_decay=0.1, penalty=pen),
    "rmsprop": lambda m, pen: m.RMSProp(0.01, pen, alpha=0.9, momentum=0.5,
                                        centered=True),
}
PENALTIES = {
    "none": lambda m: None,
    "l1": lambda m: m.L1(0.01),
    "l2": lambda m: m.L2(0.01),
    "elastic": lambda m: m.ElasticNet(0.01, 0.02),
}
SHAPES = [(4, 6), (6,), (2, 3, 5)]
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def _np(x):
    return _to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def close_f32(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(a), ref, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(ref).max(initial=0.0))))


def close_bf16(a, ref):
    """|a - ref| <= one bf16 ulp of |ref| (bf16 keeps 8 significant
    bits; the smallest normal's ulp for 0)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - ref) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} entries beyond one "
                           f"bf16 ulp: {a[bad][:5]} vs {ref[bad][:5]}")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return init, grads


def _train(pkg, optmod, make, pen, dtype, init, grads):
    """Register the parameters, then STEPS steps of loss = sum(p * G_t)
    with forward, backward, step, zero_grad; returns the parameters after
    each step and the optimizer."""
    params = [pkg.from_ndarray(a, dtype=dtype).requires_grad()
              for a in init]
    opt = make(optmod, pen(optmod))
    opt.register_all(params)
    history = []
    for gs in grads:
        loss = _loss(pkg, params, gs, dtype)
        loss.forward()
        loss.backward(1.0)
        opt.step()
        opt.zero_grad()
        history.append([_np(p.data()) for p in params])
    return history, opt


def _loss(pkg, params, gs, dtype):
    loss = None
    for p, g in zip(params, gs):
        term = (p * pkg.from_ndarray(g, dtype=dtype)).sum()
        loss = term if loss is None else loss + term
    return loss


def _check_state(topt, jopt, close):
    assert topt._step_count == jopt._step_count
    for ts, js in zip(topt._state, jopt._state):
        assert sorted(ts) == sorted(js)
        for k in js:
            assert dtype_name(ts[k].dtype) == str(js[k].dtype), k
            (close_f32 if js[k].dtype == jnp.float32 else close)(
                _np(ts[k]), _np(js[k]))


@pytest.mark.parametrize("penalty", list(PENALTIES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax_f32(name, penalty):
    init, grads = _arrays(list(OPTIMIZERS).index(name) * 4
                          + list(PENALTIES).index(penalty))
    make, pen = OPTIMIZERS[name], PENALTIES[penalty]
    jh, jopt = _train(jk, joptim, make, pen, jnp.float32, init, grads)
    th, topt = _train(nk, toptim, make, pen, torch.float32, init, grads)
    for a, b in zip(th, jh):
        for x, y in zip(a, b):
            close_f32(x, y)
    assert topt._step_count == STEPS
    _check_state(topt, jopt, close_f32)


@pytest.mark.parametrize("penalty", list(PENALTIES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax_bf16(name, penalty):
    init, grads = _arrays(list(OPTIMIZERS).index(name) * 4
                          + list(PENALTIES).index(penalty))
    make, pen = OPTIMIZERS[name], PENALTIES[penalty]
    jp = [jk.from_ndarray(a, dtype=jnp.bfloat16).requires_grad()
          for a in init]
    tp = [nk.from_ndarray(a, dtype=torch.bfloat16).requires_grad()
          for a in init]
    jopt, topt = make(joptim, pen(joptim)), make(toptim, pen(toptim))
    jopt.register_all(jp)
    topt.register_all(tp)
    for gs in grads:
        for p, q in zip(tp, jp):
            p.assign(np.asarray(q.data()))
        topt._state = [{k: torch.tensor(_np(js[k])).to(ts[k].dtype)
                        for k in ts}
                       for ts, js in zip(topt._state, jopt._state)]
        for pkg, params, opt, dt in ((jk, jp, jopt, jnp.bfloat16),
                                     (nk, tp, topt, torch.bfloat16)):
            loss = _loss(pkg, params, gs, dt)
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
        for p, q in zip(tp, jp):
            assert p.dtype == torch.bfloat16
            close_bf16(_np(p.data()), _np(q.data()))
        _check_state(topt, jopt, close_bf16)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_step_matches_step(name):
    """The fused step (forward, backward, in-place update) against
    forward/backward/step()/zero_grad(), f32 with an L2 penalty: the
    losses and the parameters after each of 5 steps within TOL."""
    init, grads = _arrays(7)
    runs = []
    for fused in (False, True):
        params = [nk.from_ndarray(a).requires_grad() for a in init]
        opt = OPTIMIZERS[name](toptim, toptim.L2(0.01))
        opt.register_all(params)
        losses, history = [], []
        for gs in grads:
            loss = None
            for p, g in zip(params, gs):
                term = (p * p * nk.from_ndarray(g)).sum()
                loss = term if loss is None else loss + term
            if fused:
                losses.append(opt.train_step(loss))
            else:
                loss.forward()
                loss.backward(1.0)
                opt.step()
                opt.zero_grad()
                losses.append(loss.item())
            history.append([_np(p.data()) for p in params])
        runs.append((losses, history))
    (l0, h0), (l1, h1) = runs
    close_f32(l1, l0)
    for a, b in zip(h1, h0):
        for x, y in zip(a, b):
            close_f32(x, y)


def test_state_dtypes():
    """bf16 parameters: Adam's state in the parameter's dtype or
    `state_dtype`; AMSGrad's in the parameter's; Adafactor's and Muon's
    f32, factored for rank 2 and up."""
    w = nk.zeros((3, 4), dtype=torch.bfloat16).requires_grad()
    b = nk.zeros(4, dtype=torch.bfloat16).requires_grad()
    cases = [(toptim.Adam(0.1), torch.bfloat16),
             (toptim.Adam(0.1, state_dtype="float32"), torch.float32),
             (toptim.AMSGrad(0.1, state_dtype="float32"), torch.bfloat16),
             (toptim.Lion(0.1, state_dtype=torch.float32), torch.float32),
             (toptim.Adafactor(0.1), torch.float32),
             (toptim.Muon(0.1), torch.float32)]
    for opt, dt in cases:
        opt.register_all([w, b])
        assert all(t.dtype == dt for s in opt._state for t in s.values())
    fac = cases[4][0]._state
    assert fac[0]["vr"].shape == (3,) and fac[0]["vc"].shape == (4,)
    assert fac[1]["v"].shape == (4,)


def test_newton_schulz_orthogonalises():
    """Muon's helper drives the singular values toward 1 (into the band
    the quintic's coefficients aim at), for tall and wide matrices."""
    from neuronika_tpu_torch.optim._newton_schulz import newton_schulz5

    g = torch.Generator().manual_seed(0)
    for shape in ((8, 32), (32, 8)):
        s = torch.linalg.svdvals(newton_schulz5(torch.randn(shape,
                                                            generator=g)))
        assert float(s.min()) > 0.5 and float(s.max()) < 1.3


SCHEDULERS = {
    "exponential": lambda S, o: S.ExponentialLR(o, 0.9),
    "step": lambda S, o: S.StepLR(o, 3, 0.5),
    "multistep": lambda S, o: S.MultiStepLR(o, [2, 5, 11], 0.3),
    "lambda": lambda S, o: S.LambdaLR(o, lambda e: 1.0 / (1.0 + e)),
    "multiplicative": lambda S, o: S.MultiplicativeLR(o, lambda e: 0.95),
    "warmup_cosine": lambda S, o: S.WarmupCosineLR(o, 4, 15, 1e-4),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax(name):
    """20 epochs: the epoch, the last and current lr and the optimizer's
    lr equal JAX's exactly (the same host arithmetic)."""
    seen = []
    for optmod in (joptim, toptim):
        opt = optmod.SGD(0.1)
        sched = SCHEDULERS[name](optmod.lr_scheduler, opt)
        trace = []
        for _ in range(20):
            sched.step()
            trace.append((sched.get_current_epoch(), sched.get_last_lr(),
                          sched.get_current_lr(), opt.get_lr()))
        seen.append(trace)
    assert seen[0] == seen[1]


def test_scheduler_bookkeeping(capsys):
    opt = toptim.Adam(0.1)
    sched = toptim.lr_scheduler.ExponentialLR(opt, 0.5)
    sched.set_current_epoch(3)
    sched.step()
    sched.print_lr()
    assert "epoch 4" in capsys.readouterr().out
    assert opt.get_lr() == 0.05
    with pytest.raises(ValueError):
        toptim.lr_scheduler.WarmupCosineLR(opt, 5, 5)
    with pytest.raises(ValueError):
        opt.set_lr(-1.0)
