"""The port's define-by-run engine (neuronika_tpu_torch/variable.py and
_engine/) against the semantics tests/test_engine.py holds the JAX package
to: laziness, sticky differentiability, seeded and accumulated backward,
backward before forward, no_grad/with_grad, interior gradients, dedup, the
step-list cache, assign/data_mut, the root fill, dropout by property and
global-seed determinism. Where a value can be computed by both packages it
is held against the JAX package's."""

import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu_torch._engine import executor as ex
from tests.conftest import assert_close


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def test_forward_is_lazy():
    x = nk.ones((2, 2))
    y = x + x
    assert_close(y.data(), np.zeros((2, 2)))
    y.forward()
    assert_close(y.data(), np.full((2, 2), 2.0))
    assert isinstance(y.data(), torch.Tensor)


def test_sticky_differentiability():
    x = nk.ones((2, 2))
    w = nk.ones((2, 2)).requires_grad()
    assert isinstance(x + x, nk.Var)
    assert not isinstance(x + x, nk.VarDiff)
    assert isinstance(x + w, nk.VarDiff)
    assert isinstance(w + x, nk.VarDiff)
    assert isinstance(w + w, nk.VarDiff)


def test_backward_seed_and_accumulation():
    w = nk.full((3,), 2.0).requires_grad()
    y = (w * w).sum()
    y.forward()
    y.backward(1.0)
    assert_close(w.grad(), np.full((3,), 4.0))
    y.backward(1.0)
    assert_close(w.grad(), np.full((3,), 8.0))
    w.zero_grad()
    y.backward(0.5)
    assert_close(w.grad(), np.full((3,), 2.0))


def test_backward_requires_forward():
    w = nk.ones((2,)).requires_grad()
    y = (w + w).sum()
    with pytest.raises(RuntimeError, match="forgot to call .forward"):
        y.backward(1.0)


def test_no_grad_with_grad():
    w = nk.ones((2,)).requires_grad()
    y = (w * 3.0).sum()
    y.forward()
    y.no_grad()
    with pytest.raises(RuntimeError, match="deallocated"):
        y.backward(1.0)
    y.with_grad()
    y.backward(1.0)
    assert_close(w.grad(), np.full((2,), 3.0))


def test_interior_gradients():
    w = nk.full((2,), 3.0).requires_grad()
    mid = w * w
    y = mid.sum()
    y.forward()
    y.backward(1.0)
    assert_close(mid.grad(), np.ones((2,)))
    assert_close(w.grad(), np.full((2,), 6.0))


def test_shared_tape_merge_dedup():
    x = nk.full((2,), 2.0).requires_grad()
    m = x * x
    z = (m + m).sum()
    z.forward()
    assert_close(z.data(), 16.0)
    z.backward(1.0)
    assert_close(x.grad(), np.full((2,), 8.0))


def test_step_list_cache_reuse():
    ex.clear_cache()
    for _ in range(3):
        x = nk.ones((4, 4)).requires_grad()
        y = (x * 2.0).sum()
        y.forward()
        y.backward(1.0)
    assert ex.cache_stats() == (1, 1)
    nk.enable_kernels(False)         # toggling the kernels clears the cache
    assert ex.cache_stats() == (0, 0)


def test_lru_cache_bound():
    c = ex.LRUCache(2)
    c["a"], c["b"] = 1, 2
    assert c.get("a") == 1           # "a" is now the most recent
    c["c"] = 3
    assert list(c) == ["a", "c"]


def test_data_mut_and_assign():
    x = nk.zeros((2, 2))
    x.assign(np.arange(4.0).reshape(2, 2))
    assert_close(x.data(), np.arange(4.0).reshape(2, 2))
    with x.data_mut() as arr:
        arr[0, 0] = 42.0
    assert x.item() == 42.0
    with pytest.raises(ValueError, match="shape"):
        x.assign(np.zeros(3))


def test_assign_copies_the_callers_array():
    src = np.ones(3, np.float32)
    x = nk.from_ndarray(src)
    src[0] = 5.0
    assert x.item() == 1.0


def test_requires_grad_shares_buffer():
    x = nk.full((2,), 7.0)
    d = x.requires_grad()
    assert_close(d.data(), x.data())
    x.assign(np.full((2,), 3.0))
    assert_close(d.data(), np.full((2,), 3.0))


def test_repeated_forward_recomputes():
    x = nk.ones((2,))
    y = x * 2.0
    y.forward()
    assert_close(y.data(), np.full((2,), 2.0))
    x.assign(np.full((2,), 5.0))
    y.forward()
    assert_close(y.data(), np.full((2,), 10.0))


def test_dropout_status_cell():
    nk.seed(1)
    status = nk.StatusCell(True)
    x = nk.ones((64, 64)).requires_grad()
    y = x.dropout(0.5, status)
    y.forward()
    data_train = y.data().numpy()
    assert (data_train == 0.0).any()
    assert_close(data_train[data_train != 0.0], 2.0)
    # the rate, by property: 4096 draws of Bernoulli(0.5)
    assert abs((data_train == 0.0).mean() - 0.5) < 0.05
    s = y.sum()
    s.forward()
    s.backward(1.0)
    g = x.grad().numpy()
    assert ((g == 0.0) == (y.data().numpy() == 0.0)).all()
    status.set(False)
    y.forward()
    assert_close(y.data(), np.ones((64, 64)))


def test_dropout_p_validation():
    with pytest.raises(ValueError):
        nk.ones((2,)).dropout(1.5, nk.StatusCell())


def test_chunks():
    x = nk.from_ndarray(np.arange(16.0).reshape(4, 4))
    cs = x.chunks((2, 2))
    assert len(cs) == 4
    cs[3].forward()
    assert_close(cs[3].data(), np.array([[10.0, 11.0], [14.0, 15.0]]))
    xd = nk.from_ndarray(np.arange(16.0).reshape(4, 4)).requires_grad()
    s = xd.chunks((2, 2))[1].sum()
    s.forward()
    s.backward(1.0)
    expected = np.zeros((4, 4))
    expected[0:2, 2:4] = 1.0
    assert_close(xd.grad(), expected)


def test_item():
    assert nk.full((1,), 3.5).item() == pytest.approx(3.5)


def test_root_gradient_filled_not_accumulated():
    w = nk.full((2,), 3.0).requires_grad()
    y = (w * w).sum()
    y.forward()
    y.backward(1.0)
    y.backward(1.0)
    assert_close(y.grad(), 1.0)
    assert_close(w.grad(), np.full((2,), 12.0))
    leaf = nk.ones((3,)).requires_grad()
    leaf.backward(2.0)
    leaf.backward(2.0)
    assert_close(leaf.grad(), np.full((3,), 2.0))


def test_global_seed_determinism():
    """nk.seed makes rand and dropout reproducible; the values differ from
    JAX's (other generators), so the property is checked: same seed, same
    draws; another seed, other draws; uniform in [0, 1)."""
    def draw(s):
        nk.seed(s)
        a = nk.rand((4, 4)).data().numpy()
        d = nk.ones((32, 32)).dropout(0.5, nk.StatusCell(True))
        d.forward()
        return a, d.data().numpy()

    a1, m1 = draw(123)
    a2, m2 = draw(123)
    a3, m3 = draw(124)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(m1, m2)
    assert not np.array_equal(a1, a3) and not np.array_equal(m1, m3)
    assert (a1 >= 0.0).all() and (a1 < 1.0).all()


def test_operands_on_different_devices_are_refused():
    x, y = nk.ones((2,)), nk.ones((2,))
    y.node.device = torch.device("meta")     # a second device, without one
    with pytest.raises(ValueError, match="different devices"):
        x + y


def test_cuda_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nk.config.device = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        nk.zeros(3)
    with pytest.raises(RuntimeError, match="is_available"):
        nk.from_ndarray(np.ones(2), device="cuda")


def test_quickstart_matches_jax():
    """The package docstring's quickstart on the same inputs in both."""
    rng = np.random.default_rng(0)
    xs, ws = rng.random((16, 3)), rng.random((5, 3))
    out = {}
    for name, mod in (("jax", jk), ("torch", nk)):
        x = mod.from_ndarray(xs)
        w = mod.from_ndarray(ws).requires_grad()
        b = mod.zeros(5).requires_grad()
        loss = (x.mm_t(w) + b).relu().mse(mod.zeros((16, 5)),
                                           mod.Reduction.Mean)
        loss.forward()
        loss.backward(1.0)
        out[name] = [np.asarray(v) for v in (loss.data(), w.grad(),
                                             b.grad())]
    for a, b in zip(out["torch"], out["jax"]):
        assert_close(a, b)


@pytest.mark.parametrize("fname,args", [
    ("eye", (3,)), ("linspace", (0.0, 1.0, 7)),
    ("logspace", (10.0, 0.0, 2.0, 5)), ("geomspace", (1.0, 1000.0, 4)),
    ("range", (0.0, 2.0, 0.25)), ("full", ((2, 3), 1.5)),
    ("ones", ((2, 2),)), ("zeros", (4,)),
])
def test_factories_match_jax(fname, args):
    a = getattr(nk, fname)(*args).data().numpy()
    b = np.asarray(getattr(jk, fname)(*args).data())
    assert a.shape == b.shape and a.dtype == b.dtype
    assert_close(a, b)


def test_free_cat_and_stack_match_jax():
    a, b = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    for fn in ("cat", "stack"):
        t = getattr(nk, fn)(nk.from_ndarray(a), b, 1)
        j = getattr(jk, fn)(jk.from_ndarray(a), b, 1)
        t.forward()
        j.forward()
        assert_close(t.data(), j.data())


def test_to_device_and_device_of():
    x = nk.ones((2,))
    assert nk.device_of(x) == torch.device("cpu")
    assert nk.to_device(x, "cpu") is x
    with pytest.raises(ValueError, match="leaf"):
        nk.to_device(x + x, "cpu")
