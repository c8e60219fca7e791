"""Every op of the port's define-by-run registry
(neuronika_tpu_torch/ops/functional.py) against the JAX package's
`OPS[name].fwd` / `.vjp` on the CPU: the same numpy inputs from a seed go
through both, forward within TOL (1e-5) and every VJP within 1e-4 (as
tests/test_var_attention.py bounds them). The conv tier (`convolution`,
`max_pool`, `avg_pool`) is held the same way, and `convolution` again with
the kernels on: the port's direct-conv route (their plain versions on the
CPU) against JAX's Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.functional import OPS as JOPS
from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.ops.functional import OPS as TOPS
from tests.conftest import TOL, assert_close

VJP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


def _r(*shape, lo=None, hi=None):
    rng = _r.rng
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _ids(n, *shape):
    return _r.rng.integers(0, n, size=shape).astype(np.float32)


def _cases():
    """(case id, op name, extra, operand arrays, rng kwargs or None)."""
    _r.rng = np.random.default_rng(0)
    pos = dict(lo=0.5, hi=2.0)
    c = [
        ("add", "add", (), [_r(3, 4), _r(4)]),
        ("sub", "sub", (), [_r(2, 3, 4), _r(3, 1)]),
        ("mul", "mul", (), [_r(3, 4), _r(1, 4)]),
        ("div", "div", (), [_r(3, 4), _r(3, 4, **pos)]),
        ("neg", "neg", (), [_r(3, 4)]),
        ("pow", "pow", (3,), [_r(3, 4)]),
        ("sqrt", "sqrt", (), [_r(3, 4, **pos)]),
        ("exp", "exp", (), [_r(3, 4)]),
        ("ln", "ln", (), [_r(3, 4, **pos)]),
        ("relu", "relu", (), [_r(3, 4)]),
        ("leaky_relu", "leaky_relu", (), [_r(3, 4)]),
        ("sigmoid", "sigmoid", (), [_r(3, 4)]),
        ("tanh", "tanh", (), [_r(3, 4)]),
        ("softplus", "softplus", (), [_r(3, 4)]),
        ("softmax-last", "softmax", (1,), [3 * _r(3, 5)]),
        ("softmax-first", "softmax", (0,), [3 * _r(3, 5)]),
        ("log_softmax-last", "log_softmax", (-1,), [3 * _r(2, 3, 5)]),
        ("log_softmax-first", "log_softmax", (0,), [3 * _r(3, 5)]),
        ("sum", "sum", (), [_r(3, 4)]),
        ("mean", "mean", (), [_r(3, 4)]),
        ("sum_axis", "sum_axis", (1,), [_r(3, 4)]),
        ("mean_axis", "mean_axis", (0,), [_r(3, 4)]),
        ("t", "t", (), [_r(2, 3, 4)]),
        ("unsqueeze", "unsqueeze", (1,), [_r(3, 4)]),
        ("chunk", "chunk", ((2, 3), (2, 3)), [_r(4, 6)]),
        ("cat", "cat", (0,), [_r(2, 3), _r(4, 3)]),
        ("multi_cat", "multi_cat", (1,), [_r(2, 3), _r(2, 1), _r(2, 4)]),
        ("stack", "stack", (0,), [_r(2, 3), _r(2, 3)]),
        ("multi_stack", "multi_stack", (1,), [_r(2, 3), _r(2, 3), _r(2, 3)]),
        ("mm", "mm", (), [_r(5, 4), _r(4, 3)]),
        ("mm_t", "mm_t", (), [_r(5, 4), _r(3, 4)]),
        ("mv", "mv", (), [_r(5, 4), _r(4)]),
        ("vm", "vm", (), [_r(5), _r(5, 3)]),
        ("vv", "vv", (), [_r(4), _r(4)]),
        ("matmul", "matmul", (), [_r(2, 3, 4), _r(4, 5)]),
        ("astype", "astype", ("float32",), [_r(3, 4)]),
        ("reshape", "reshape", ((2, 6),), [_r(3, 4)]),
        ("embedding", "embedding", (), [_r(6, 3), _ids(6, 2, 4)]),
        ("pad-zero", "pad", ((1, 2), "zero", 0.0), [_r(2, 3, 5)]),
        ("pad-constant", "pad", ((2,), "constant", 1.5), [_r(2, 3, 5)]),
        ("pad-reflective", "pad", ((1, 2), "reflective", 0.0),
         [_r(2, 3, 5)]),
        ("pad-replicative", "pad", ((2, 1), "replicative", 0.0),
         [_r(2, 3, 5)]),
        ("mae-mean", "mae", ("mean",), [_r(3, 4), _r(3, 4)]),
        ("mae-sum", "mae", ("sum",), [_r(3, 4), _r(3, 4)]),
        ("mse-mean", "mse", ("mean",), [_r(3, 4), _r(3, 4)]),
        ("mse-sum", "mse", ("sum",), [_r(3, 4), _r(3, 4)]),
        ("bce-mean", "bce", ("mean",),
         [_r(3, 4, lo=0.05, hi=0.95), _r(3, 4, lo=0.0, hi=1.0)]),
        ("bce_with_logits-sum", "bce_with_logits", ("sum",),
         [_r(3, 4), _r(3, 4, lo=0.0, hi=1.0)]),
        ("kldiv-mean", "kldiv", ("mean",),
         [np.log(_r(3, 4, lo=0.1, hi=1.0)),
          np.where(_r(3, 4) > 0.5, 0.0, _r(3, 4, lo=0.0, hi=1.0))]),
        ("nll-mean", "nll", ("mean",), [3 * _r(5, 4), _ids(5, 4)]),
        ("nll-sum", "nll", ("sum",), [3 * _r(5, 2, 3), _ids(5, 2, 3)]),
        # the conv tier: operands (kernel (Co, Ci/groups, *k), input (N, Ci,
        # *spatial)); extra (stride, dilation, groups) / (window, stride)
        ("convolution", "convolution", ((1, 1), (1, 1), 1),
         [_r(4, 3, 3, 3), _r(2, 3, 8, 7)]),
        ("convolution-1d-s2-d2", "convolution", ((2,), (2,), 1),
         [_r(5, 3, 3), _r(2, 3, 17)]),
        ("convolution-2d-s2x3", "convolution", ((2, 3), (1, 1), 1),
         [_r(6, 4, 3, 2), _r(2, 4, 11, 10)]),
        ("convolution-2d-d2-g2", "convolution", ((1, 1), (2, 2), 2),
         [_r(6, 2, 3, 3), _r(2, 4, 10, 9)]),
        ("convolution-3d-d2", "convolution", ((1, 1, 1), (2, 1, 2), 1),
         [_r(4, 3, 2, 2, 2), _r(2, 3, 6, 5, 7)]),
        ("max_pool", "max_pool", ((2, 2), (2, 2)), [_r(2, 3, 6, 7)]),
        ("max_pool-1d-overlap", "max_pool", ((3,), (1,)), [_r(2, 3, 9)]),
        ("max_pool-3d", "max_pool", ((2, 2, 3), (2, 1, 2)),
         [_r(2, 2, 5, 4, 7)]),
        ("avg_pool", "avg_pool", ((2, 2), (2, 2)), [_r(2, 3, 6, 7)]),
        ("avg_pool-overlap", "avg_pool", ((3, 2), (2, 1)), [_r(2, 3, 7, 6)]),
        ("avg_pool-1d", "avg_pool", ((4,), (3,)), [_r(2, 3, 13)]),
        # the recurrent scans: operands (x (T, B, I), w_ih, w_hh, b_ih,
        # b_hh), gates x hidden 4 (LSTM) and 3 (GRU) x 4
        ("lstm_scan", "lstm_scan", (),
         [_r(5, 2, 3), _r(16, 3), _r(16, 4), _r(16), _r(16)]),
        ("gru_scan", "gru_scan", (),
         [_r(5, 2, 3), _r(12, 3), _r(12, 4), _r(12), _r(12)]),
    ]
    out = [(cid, name, extra, xs, None) for cid, name, extra, xs in c]
    # stochastic ops, at the settings where both packages are exact: eval
    # mode and p = 1 (masks from a seed differ between the packages; the
    # engine tests check the masks by property)
    out += [
        ("dropout-eval", "dropout", (0.5,), [_r(3, 4)], False),
        ("dropout-p1", "dropout", (1.0,), [_r(3, 4)], True),
        ("flash_attention-mha", "flash_attention", (2, 0, True, 0.0, 128),
         [_r(2, 8, 24)], True),
        ("flash_attention-gqa-full", "flash_attention",
         (4, 2, False, 0.0, 128), [_r(1, 8, 32)], True),
    ]
    return out


CASES = _cases()


def _jax_call(op, extra, xs, train, *rest):
    if train is None:
        return op(extra, *xs, *rest) if not rest else op(extra, xs, *rest)
    kw = dict(key=jax.random.key(0), train=train)
    return op(extra, *xs, **kw) if not rest else op(extra, xs, *rest, **kw)


def _torch_call(op, extra, xs, train, *rest):
    if train is None:
        return op(extra, *xs, *rest) if not rest else op(extra, xs, *rest)
    kw = dict(key=0, train=train)
    return op(extra, *xs, **kw) if not rest else op(extra, xs, *rest, **kw)


@pytest.mark.parametrize("cid,name,extra,xs,train", CASES,
                         ids=[c[0] for c in CASES])
def test_op_forward_and_vjp_match_jax(cid, name, extra, xs, train):
    jxs = [jnp.asarray(x) for x in xs]
    txs = [torch.from_numpy(x.copy()) for x in xs]
    jout = _jax_call(JOPS[name].fwd, extra, jxs, train)
    tout = _torch_call(TOPS[name].fwd, extra, txs, train)
    assert tuple(tout.shape) == tuple(jout.shape)
    assert str(tout.dtype).removeprefix("torch.") == jnp.dtype(jout.dtype).name
    assert_close(tout.numpy(), jout, tol=TOL)

    g = np.random.default_rng(1).standard_normal(jout.shape).astype(
        np.float32)
    jg = _jax_call(JOPS[name].vjp, extra, jxs, train, jout, jnp.asarray(g))
    tg = _torch_call(TOPS[name].vjp, extra, txs, train, tout,
                     torch.from_numpy(g))
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert (a is None) == (b is None), f"operand {i}"
        if b is not None:
            assert tuple(a.shape) == tuple(b.shape), f"operand {i}"
            assert_close(a.numpy(), b, tol=VJP_TOL)


def test_every_registered_op_has_a_case():
    covered = {c[1] for c in CASES}
    assert covered == set(TOPS)
    # the nn tier's scan ops included: the two registries hold the same ops
    assert set(TOPS) == set(JOPS)


def test_astype_to_bf16_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    jout = JOPS["astype"].fwd(("bfloat16",), jnp.asarray(x))
    tout = TOPS["astype"].fwd(("bfloat16",), torch.from_numpy(x))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))


# the kernel route of `convolution`: K12 (2-d, stride 1 or dilation 1, any
# groups), K14 (1-d; strided on K12), K15 (3-d, stride 1); (kernel shape,
# input shape, stride, dilation, groups)
KERNEL_CONVS = [
    ((4, 3, 3, 3), (2, 3, 9, 8), (1, 1), (1, 1), 1),
    ((6, 4, 3, 3), (2, 4, 11, 10), (2, 2), (1, 1), 1),
    ((6, 2, 3, 2), (2, 4, 10, 9), (1, 1), (2, 1), 2),
    ((8, 1, 3, 3), (1, 4, 9, 9), (1, 1), (1, 1), 4),
    ((5, 3, 3), (2, 3, 17), (1,), (2,), 1),
    ((5, 3, 3), (2, 3, 17), (2,), (1,), 1),
    ((4, 3, 2, 2, 2), (2, 3, 6, 5, 7), (1, 1, 1), (2, 1, 2), 1),
]


@pytest.mark.parametrize("kernels", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("case", KERNEL_CONVS,
                         ids=["2d", "2d-s2", "2d-d2-g2", "2d-depthwise",
                              "1d-d2", "1d-s2", "3d-d2"])
def test_convolution_with_kernels_on_and_off_matches_jax(case, kernels):
    """"on": the port's kernel route with conv_route "force" (the kernels'
    plain versions here) against JAX's `enable_pallas(True,
    interpret=True)`, whose Pallas kernels run in interpret mode."""
    from neuronika_tpu.config import enable_pallas
    from neuronika_tpu_torch import enable_kernels

    kshape, xshape, stride, dilation, groups = case
    rng = np.random.default_rng(7)
    k = rng.standard_normal(kshape).astype(np.float32)
    x = rng.standard_normal(xshape).astype(np.float32)
    e = (stride, dilation, groups)
    old_route = config.conv_route
    try:
        enable_pallas(kernels, interpret=True)
        enable_kernels(kernels)
        config.conv_route = "force"
        jout = JOPS["convolution"].fwd(e, jnp.asarray(k), jnp.asarray(x))
        tout = TOPS["convolution"].fwd(e, torch.from_numpy(k),
                                       torch.from_numpy(x))
        g = rng.standard_normal(jout.shape).astype(np.float32)
        jg = JOPS["convolution"].vjp(e, (jnp.asarray(k), jnp.asarray(x)),
                                     jout, jnp.asarray(g))
        tg = TOPS["convolution"].vjp(e, (torch.from_numpy(k),
                                         torch.from_numpy(x)), tout,
                                     torch.from_numpy(g))
    finally:
        enable_pallas(False)
        enable_kernels(False)
        config.conv_route = old_route
    assert tuple(tout.shape) == tuple(jout.shape)
    assert_close(tout.numpy(), jout, tol=TOL)
    for a, b in zip(tg, jg):
        assert tuple(a.shape) == tuple(b.shape)
        assert_close(a.numpy(), b, tol=VJP_TOL)


def test_conv_tier_through_the_var_surface_matches_jax():
    """kernel.convolution(input) -> max_pool -> avg_pool -> sum, forward
    and backward, as a user writes it in both packages."""
    import neuronika_tpu as jk
    import neuronika_tpu_torch as nk

    rng = np.random.default_rng(8)
    kv = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    xv = rng.standard_normal((2, 3, 14, 13)).astype(np.float32)
    res = []
    for pkg in (nk, jk):
        k = pkg.from_ndarray(kv).requires_grad()
        x = pkg.from_ndarray(xv).requires_grad()
        y = k.convolution(x, 1, 1).max_pool((2, 2)).avg_pool(2, 1).sum()
        y.forward()
        y.backward(1.0)
        res.append([np.asarray(v) for v in (y.data(), k.grad(), x.grad())])
    for a, b in zip(*res):
        assert_close(a, b, tol=VJP_TOL)


def test_conv_arguments_are_checked():
    import neuronika_tpu_torch as nk

    with pytest.raises(ValueError, match="groups"):
        nk.zeros((2, 3, 3, 3)).convolution(nk.zeros((1, 4, 8, 8)), 1, 1, 2)
