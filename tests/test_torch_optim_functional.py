"""The port's functional optimizer rules (neuronika_tpu_torch/optim/
functional.py) against the JAX package's on the CPU.

Each of the nine rules (SGD plain and with Nesterov momentum, Adam,
AMSGrad, Adagrad, RMSProp centered with momentum, AdamW, Lion, Muon,
Adafactor) on a params tree of a matrix, a vector and a rank-3 leaf
(Adafactor's factored state and Muon's batched Newton-Schulz over its
leading axis), with a fresh gradient tree each step.
* f32: 5 steps from the same start, JAX's rule under `jax.jit`, as in its
  train step; the params after every step and the state after the last
  within TOL relative and TOL of the largest entry (at least 1) absolute.
* bf16: each step starts from JAX's params and state, JAX's rule runs op
  by op, as it is written, and the port's result must lie within one bf16
  ulp of JAX's (f32 state within the f32 bound). Under `jax.jit` XLA keeps
  f32 across some of the fused ops of the rules written in the leaves'
  dtype (SGD, AMSGrad, Adagrad, RMSProp) and rounds others, which after
  cancellation near 0 moves a parameter by more than an ulp of itself.
The port updates in place: the returned trees are the ones passed in.
Then EMA and `warmup_cosine_schedule` (f32 cos: within TOL) against
JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.optim import functional as JF
from neuronika_tpu_torch._tree import tree_leaves
from neuronika_tpu_torch.models.transformer import params_from_jax
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL

# name -> (rule, init kwargs, update kwargs, lr)
RULES = {
    "sgd": ("sgd", {}, {}, 0.05),
    "sgd_nesterov": ("sgd", dict(momentum=0.9),
                     dict(momentum=0.9, dampening=0.1, nesterov=True), 0.05),
    "adam": ("adam", {}, {}, 0.01),
    "amsgrad": ("amsgrad", {}, {}, 0.01),
    "adagrad": ("adagrad", {}, dict(lr_decay=0.1), 0.05),
    "rmsprop": ("rmsprop", dict(momentum=0.5, centered=True),
                dict(alpha=0.9, momentum=0.5, centered=True), 0.01),
    "adamw": ("adamw", {}, dict(weight_decay=0.1), 0.01),
    "lion": ("lion", {}, dict(weight_decay=0.1), 0.01),
    "muon": ("muon", {}, {}, 0.02),
    "adafactor": ("adafactor", {}, dict(weight_decay=0.01), 0.05),
}
# insertion order differs from JAX's sorted order on purpose
SHAPES = {"w": (4, 6), "b": (6,), "blocks": {"k": (2, 3, 5)}}
STEPS = 5


def _tree(rng, shapes=SHAPES):
    return {k: _tree(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return _tree(rng), [_tree(rng) for _ in range(STEPS)]


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    """Copies (JAX's CPU arrays may share the numpy buffers, and the port
    updates in place)."""
    return {k: _torch(v, dtype) if isinstance(v, dict)
            else torch.tensor(v, dtype=dtype) for k, v in tree.items()}


def _from_jax(tree):
    """A JAX tree as the port's, each leaf in its own dtype."""
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _pairs(t, j, path=""):
    """(path, port leaf as f64 numpy, JAX leaf as f64 numpy, JAX dtype)
    over the JAX tree's leaves; the keys must agree."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), path
        for k in j:
            yield from _pairs(t[k], j[k], f"{path}/{k}")
        return
    jd = jnp.asarray(j).dtype
    yield (path, t.detach().double().numpy(),
           np.asarray(jnp.asarray(j, jnp.float32), np.float64), jd)


def close_f32(a, ref, path=""):
    np.testing.assert_allclose(
        a, ref, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=path)


def close_bf16(a, ref, path=""):
    """|a - ref| <= one bf16 ulp of |ref| (the smallest normal's ulp for
    0)."""
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - ref) > ulp
    assert not bad.any(), (f"{path}: {bad.sum()} of {bad.size} entries "
                           f"beyond one bf16 ulp: {a[bad][:5]} vs "
                           f"{ref[bad][:5]}")


def _check(t, j, close):
    for path, a, ref, jd in _pairs(t, j):
        (close_f32 if jd == jnp.float32 else close)(a, ref, path)


def _rules(name, jit=True):
    rule, init_kw, upd_kw, lr = RULES[name]
    jinit = getattr(JF, f"{rule}_init")
    jupd = functools.partial(getattr(JF, f"{rule}_update"), lr=lr, **upd_kw)
    if jit:
        jupd = jax.jit(jupd)
    tinit = getattr(TF, f"{rule}_init")
    tupd = functools.partial(getattr(TF, f"{rule}_update"), lr=lr, **upd_kw)
    return (functools.partial(jinit, **init_kw), jupd,
            functools.partial(tinit, **init_kw), tupd)


@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_jax_f32(name):
    jinit, jupd, tinit, tupd = _rules(name)
    init, grads = _arrays()
    jp, tp = _jax(init, jnp.float32), _torch(init, torch.float32)
    js, ts = jinit(jp), tinit(tp)
    assert sorted(ts) == sorted(js)
    for g in grads:
        jp, js = jupd(jp, _jax(g, jnp.float32), js)
        out_p, ts = tupd(tp, _torch(g, torch.float32), ts)
        # in place: the same tensors come back, holding the new values
        assert all(a is b for a, b in zip(tree_leaves(out_p),
                                          tree_leaves(tp)))
        _check(tp, jp, close_f32)
    _check(ts, js, close_f32)


@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_jax_bf16_step_by_step(name):
    jinit, jupd, tinit, tupd = _rules(name, jit=False)
    init, grads = _arrays(1)
    jp = _jax(init, jnp.bfloat16)
    js = jinit(jp)
    for g in grads:
        # the port starts each step from JAX's params and state
        tp, ts = _from_jax(jp), _from_jax(js)
        jg = _jax(g, jnp.bfloat16)
        jp, js = jupd(jp, jg, js)
        tp, ts = tupd(tp, _from_jax(jg), ts)
        _check(tp, jp, close_bf16)
        _check(ts, js, close_bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dtypes_match_jax(dtype):
    init, _ = _arrays()
    jp = _jax(init, getattr(jnp, dtype))
    tp = _torch(init, getattr(torch, dtype))
    for name in RULES:
        jinit, _, tinit, _ = _rules(name)
        js, ts = jinit(jp), tinit(tp)

        def dtypes(t, j, path=""):
            if isinstance(j, dict):
                for k in j:
                    dtypes(t[k], j[k], f"{path}/{k}")
                return
            assert str(t.dtype).replace("torch.", "") == str(
                jnp.asarray(j).dtype), (name, path)
            assert tuple(t.shape) == jnp.asarray(j).shape, (name, path)

        dtypes(ts, js)


def test_ema_matches_jax():
    init, grads = _arrays(2)
    jp, tp = _jax(init, jnp.bfloat16), _torch(init, torch.bfloat16)
    je, te = JF.ema_init(jp), TF.ema_init(tp)
    for g in grads:
        jp = jax.tree.map(lambda p, d: (p.astype(jnp.float32) + 0.1 * d
                                        ).astype(p.dtype), jp, _jax(g, jnp.float32))
        tp = _from_jax(jp)
        je = JF.ema_update(je, jp, decay=0.9)
        assert TF.ema_update(te, tp, decay=0.9) is te
        _check(te, je, close_f32)
    jv, tv = JF.ema_params(je, jp), TF.ema_params(te, tp)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tv))
    _check(tv, jv, close_bf16)


@pytest.mark.parametrize("warmup,total,final", [(3, 10, 0.1), (0, 5, 0.0),
                                                (4, 4, 0.5)])
def test_warmup_cosine_schedule_matches_jax(warmup, total, final):
    jl = JF.warmup_cosine_schedule(1e-3, warmup, total, final)
    tl = TF.warmup_cosine_schedule(1e-3, warmup, total, final)
    for step in range(total + 3):
        got = tl(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jl(step)), rtol=TOL,
                                   err_msg=str(step))
