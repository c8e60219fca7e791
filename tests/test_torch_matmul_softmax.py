"""K3 (neuronika_tpu_torch/ops/matmul.py) and K4 (ops/softmax.py): the
plain versions against JAX's Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them on the CPU), the `mm`/`softmax` Var ops
with the kernels on and off, and, on the card, each CUDA kernel against
its plain version. Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu.ops.pallas.matmul import matmul as jax_matmul
from neuronika_tpu.ops.pallas.softmax import softmax_last_axis as jax_softmax
from neuronika_tpu_torch.ops import matmul as MM
from neuronika_tpu_torch.ops import softmax as SM
from tests.conftest import TOL, assert_close

# f32 GEMM: sums of up to 512 products of N(0, 1) terms in another order;
# the bound tests/test_pallas.py holds the JAX kernel to against numpy
MM_TOL = 1e-4
MM_CASES = [(128, 128, 128), (300, 200, 150), (64, 512, 256), (8, 128, 128),
            (100, 70, 130), (1, 96, 33)]
SM_CASES = [(16, 64), (3, 5, 40), (300, 128), (4, 1000)]


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old
    nk.enable_kernels(False)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_ulp(x_max):
    """One bf16 ulp at |x| = x_max (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(x_max)) - 7)


@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_plain_matmul_matches_jax_kernel(m, k, n):
    a, b = _randn(m, k), _randn(k, n, seed=1)
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    out = MM.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    assert_close(out.numpy(), ref, tol=MM_TOL)


@pytest.mark.parametrize("trans", ["a", "b", "both"])
def test_plain_matmul_on_transposed_views(trans):
    """The VJPs hand K3 transposed views; the plain version takes them as
    they are."""
    m, k, n = 70, 90, 50
    a, b = _randn(m, k), _randn(k, n, seed=1)
    ta = torch.from_numpy(a.T.copy()).T if trans in ("a", "both") \
        else torch.from_numpy(a)
    tb = torch.from_numpy(b.T.copy()).T if trans in ("b", "both") \
        else torch.from_numpy(b)
    assert not (ta.is_contiguous() and tb.is_contiguous())
    assert_close(MM.matmul(ta, tb).numpy(), a @ b, tol=MM_TOL)


def test_plain_matmul_bf16_and_mixed_match_jax():
    a, b = _randn(128, 256), _randn(256, 130, seed=1)
    ref = jax_matmul(jnp.asarray(a, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16), interpret=True)
    out = MM.matmul(torch.from_numpy(a).bfloat16(),
                    torch.from_numpy(b).bfloat16())
    assert out.dtype == torch.bfloat16
    ref32 = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref32).max()
    # both sum exact bf16 products in f32 and round once; another summation
    # order may flip one rounding
    assert err <= _bf16_ulp(np.abs(ref32).max())
    # mixed operands are promoted; the result takes a's dtype
    mixed = MM.matmul(torch.from_numpy(a).bfloat16(), torch.from_numpy(b))
    assert mixed.dtype == torch.bfloat16


def test_matmul_refuses_bad_operands():
    with pytest.raises(ValueError, match="2-d"):
        MM.matmul(torch.zeros(2, 3, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="contraction"):
        MM.matmul(torch.zeros(2, 3), torch.zeros(4, 5))


@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log"])
@pytest.mark.parametrize("shape", SM_CASES, ids=str)
def test_plain_softmax_matches_jax_kernel(shape, log):
    x = 3 * _randn(*shape)
    ref = jax_softmax(jnp.asarray(x), log=log, interpret=True)
    out = SM.softmax_last_axis(torch.from_numpy(x), log=log)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert_close(out.numpy(), ref, tol=TOL)


def test_plain_softmax_bf16_matches_jax():
    x = 3 * _randn(8, 300)
    for log in (False, True):
        ref = np.asarray(jax_softmax(jnp.asarray(x, jnp.bfloat16), log=log,
                                     interpret=True), np.float32)
        out = SM.softmax_last_axis(torch.from_numpy(x).bfloat16(), log=log)
        assert out.dtype == torch.bfloat16
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= _bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("kernels", [False, True], ids=["off", "on"])
def test_mm_softmax_var_ops_with_kernels_on_and_off(kernels):
    """`config.use_kernels` routes mm and softmax through K3/K4 (their
    plain versions on the CPU): the same numbers, forward and backward, as
    the plain torch route and as the JAX package."""
    import neuronika_tpu as jk

    a, b = _randn(64, 32), _randn(32, 48, seed=1)
    nk.enable_kernels(kernels)
    x = nk.from_ndarray(a).requires_grad()
    w = nk.from_ndarray(b).requires_grad()
    y = x.mm(w).softmax(1).log_softmax(-1).sum()
    y.forward()
    y.backward(1.0)
    jx = jk.from_ndarray(a).requires_grad()
    jw = jk.from_ndarray(b).requires_grad()
    jy = jx.mm(jw).softmax(1).log_softmax(-1).sum()
    jy.forward()
    jy.backward(1.0)
    assert_close(y.data(), jy.data(), tol=TOL)
    assert_close(x.grad(), jx.grad(), tol=MM_TOL)
    assert_close(w.grad(), jw.grad(), tol=MM_TOL)


def test_kernel_counters_do_not_move_on_the_cpu():
    before = MM.matmul.launches, SM.softmax_last_axis.launches
    nk.enable_kernels(True)
    y = nk.from_ndarray(_randn(4, 4)).mm(nk.ones((4, 4))).softmax(1)
    y.forward()
    assert (MM.matmul.launches, SM.softmax_last_axis.launches) == before


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_mm(cuda, m, k, n, dtype, trans):
    a = torch.from_numpy(_randn(m, k)).to(cuda, dtype)
    b = torch.from_numpy(_randn(k, n, seed=1)).to(cuda, dtype)
    if trans in ("a", "both"):
        a = a.T.contiguous().T
    if trans in ("b", "both"):
        b = b.T.contiguous().T
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("trans", ["none", "a", "b", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (1000, 760, 1030),
                                   (1, 96, 33), (257, 8, 3)])
def test_matmul_kernel_matches_plain_on_gpu(cuda, m, k, n, dtype, trans):
    """f32: 1e-5 of the largest entry (FFMA in another order); bf16: one
    bf16 ulp of the largest entry (one rounding of an f32 sum)."""
    a, b = _card_mm(cuda, m, k, n, dtype, trans)
    before = MM.matmul.launches
    out = MM.matmul(a, b)
    ref = MM.matmul_reference(a, b)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    top = float(ref.float().abs().max())
    tol = 1e-5 * top if dtype == torch.float32 else _bf16_ulp(top)
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log"])
@pytest.mark.parametrize("shape", [(7, 1000), (3, 16384), (2, 20000),
                                   (5, 3, 33)], ids=str)
def test_softmax_kernel_matches_plain_on_gpu(cuda, shape, log, dtype):
    x = (3 * torch.from_numpy(_randn(*shape))).to(cuda, dtype)
    before = SM.softmax_last_axis.launches
    out = SM.softmax_last_axis(x, log=log)
    ref = SM.softmax_last_axis_reference(x, log=log)
    torch.cuda.synchronize()
    assert SM.softmax_last_axis.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    top = float(ref.float().abs().max())
    tol = 1e-5 * top if dtype == torch.float32 else _bf16_ulp(top)
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_run(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        MM.matmul(x.half(), x.T.half())
    with pytest.raises(ValueError, match="operands on"):
        MM.matmul(x, x.T.cpu())
    with pytest.raises(TypeError):
        SM.softmax_last_axis(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        SM.softmax_last_axis(x.T)


@pytest.mark.cuda
def test_var_ops_launch_the_kernels_on_gpu(cuda):
    nk.config.device = "cuda"
    nk.enable_kernels(True)
    a, b = _randn(64, 32), _randn(32, 48, seed=1)
    x = nk.from_ndarray(a).requires_grad()
    y = x.mm(nk.from_ndarray(b)).softmax(1).sum()
    before = MM.matmul.launches, SM.softmax_last_axis.launches
    y.forward()
    y.backward(1.0)
    torch.cuda.synchronize()
    # mm forward, its two VJP products; one softmax forward
    assert MM.matmul.launches - before[0] == 3
    assert SM.softmax_last_axis.launches - before[1] == 1
    nk.enable_kernels(False)
    x2 = nk.from_ndarray(a).requires_grad()
    y2 = x2.mm(nk.from_ndarray(b)).softmax(1).sum()
    y2.forward()
    y2.backward(1.0)
    assert_close(y.data().cpu(), y2.data().cpu(), tol=TOL)
    assert_close(x.grad().cpu(), x2.grad().cpu(), tol=MM_TOL)
