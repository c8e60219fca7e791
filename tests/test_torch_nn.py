"""The port's layer kit (neuronika_tpu_torch/nn/) against the JAX package's
on the CPU in f32: every layer's forward and its input and parameter
gradients with JAX's weights carried across by `nn.params_from_jax`
(Linear, LSTMCell, GRUCell, the scan-node LSTM and GRU at T 1, 5 and 17,
Conv1d/2d/3d and GroupedConv* over every padding mode and over
test_gradcheck_sweep.py's stride/dilation/groups cases), bound TOL
(tests/conftest.py, 1e-5) relative, and TOL of the array's largest entry
(at least 1) absolute: a conv weight gradient sums hundreds of products,
in another order in each package; `init` exactly where it is deterministic (fans,
gains, constants, eye, dirac) and by range and moments where it draws;
`Dropout` and `ModelStatus` by property, since the port's masks come from
a torch.Generator and JAX's from jax.random."""

import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu import nn as jnn
from neuronika_tpu_torch import nn
from neuronika_tpu_torch.variable import _to_numpy
from tests.conftest import TOL, assert_close


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    nk.seed(0)
    yield
    nk.config.device = old


def close(a, ref):
    """Within TOL relative and TOL x max(1, max |ref|) absolute."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(a), ref, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(ref).max(initial=0.0))))


def _np(x):
    """A JAX or torch array as numpy."""
    return _to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry(jlayer, layer):
    nn.params_from_jax(layer, [np.asarray(p.data())
                               for p in jlayer.parameters()])


def _run_both(jlayer, layer, inputs, call, seed=1):
    """`call(pkg, layer, leaves)` -> list of outputs, in each package, on
    the same inputs (differentiable leaves); the loss sum(out_i * G_i)
    hands both backwards the same output gradients. Checks the outputs and
    every input and parameter gradient within TOL."""
    _carry(jlayer, layer)
    res = {}
    for pkg, lay in ((jk, jlayer), (nk, layer)):
        leaves = [pkg.from_ndarray(a).requires_grad() for a in inputs]
        outs = call(pkg, lay, leaves)
        loss = None
        gens = np.random.default_rng(seed)
        for o in outs:
            g = gens.standard_normal(o.shape).astype(np.float32)
            term = (o * pkg.from_ndarray(g)).sum()
            loss = term if loss is None else loss + term
        loss.forward()
        loss.backward(1.0)
        res[pkg] = ([_np(o.data()) for o in outs],
                    [_np(v.grad()) for v in leaves],
                    [_np(p.grad()) for p in lay.parameters()])
    for a, b in zip(res[jk], res[nk]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape
            close(y, x)


def _rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------------ layers


def test_linear_matches_jax():
    _run_both(jnn.Linear(5, 3), nn.Linear(5, 3), [_rnd(4, 5)],
              lambda pkg, lay, xs: [lay.forward(xs[0])])


def test_lstm_cell_matches_jax():
    """The state is (cell, hidden), the second gate chunk tanh'd; both new
    states and the gradients of the old ones and of the input."""
    _run_both(jnn.LSTMCell(3, 4), nn.LSTMCell(3, 4),
              [_rnd(2, 4, seed=1), _rnd(2, 4, seed=2), _rnd(2, 3, seed=3)],
              lambda pkg, lay, xs: list(lay.forward((xs[0], xs[1]), xs[2])))


def test_gru_cell_matches_jax():
    _run_both(jnn.GRUCell(3, 4), nn.GRUCell(3, 4),
              [_rnd(2, 4, seed=1), _rnd(2, 3, seed=2)],
              lambda pkg, lay, xs: [lay.forward(xs[0], xs[1])])


@pytest.mark.parametrize("T", [1, 5, 17])
@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_scan_layers_match_jax(kind, T):
    """One node over the whole sequence: the hidden states and
    backpropagation through time to the inputs and every weight."""
    _run_both(getattr(jnn, kind)(3, 4), getattr(nn, kind)(3, 4),
              [_rnd(T, 2, 3, seed=T)],
              lambda pkg, lay, xs: [lay.forward(xs[0])])


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_scan_matches_cell_loop(kind):
    """nn.LSTM/GRU's one node equals its cell stepped in Python."""
    seq = getattr(nn, kind)(3, 4)
    cell = getattr(nn, kind + "Cell")(3, 4)
    nn.params_from_jax(cell, [_to_numpy(p.data()) for p in seq.parameters()])
    xs = _rnd(5, 2, 3)
    out = seq.forward(nk.from_ndarray(xs))
    out.forward()
    h, c = nk.zeros((2, 4)), nk.zeros((2, 4))
    for t in range(5):
        x = nk.from_ndarray(xs[t])
        if kind == "LSTM":
            c, h = cell.forward((c, h), x)
        else:
            h = cell.forward(h, x)
    h.forward()
    assert_close(out.data()[-1], h.data())


def test_scan_vjp_leaves_no_autograd_history():
    """The VJP recomputes under enable_grad on detached leaves: the
    gradients carry no graph, and grad mode is as it was."""
    lstm = nn.LSTM(3, 4)
    x = nk.from_ndarray(_rnd(6, 2, 3)).requires_grad()
    loss = lstm.forward(x).sum()
    with torch.no_grad():
        loss.forward()
        loss.backward(1.0)
        assert not torch.is_grad_enabled()
    for g in [x.grad()] + [p.grad() for p in lstm.parameters()]:
        assert g.grad_fn is None and not g.requires_grad
        assert float(g.abs().sum()) > 0


PADDINGS = [("zero", lambda pkg: pkg.Zero()),
            ("constant", lambda pkg: pkg.Constant(0.5)),
            ("reflective", lambda pkg: pkg.Reflective()),
            ("replicative", lambda pkg: pkg.Replicative())]

# test_gradcheck_sweep.py's CONV_CASES: (input shape, kernel shape, stride,
# dilation, groups)
CONV_CASES = [
    ((1, 2, 8), (3, 2, 3), (1,), (1,), 1),
    ((1, 2, 9), (2, 2, 3), (2,), (1,), 1),
    ((1, 2, 9), (2, 2, 2), (1,), (2,), 1),
    ((1, 4, 7), (4, 2, 3), (1,), (1,), 2),
    ((1, 2, 5, 5), (2, 2, 2, 2), (1, 1), (1, 1), 1),
    ((1, 1, 4, 4, 4), (1, 1, 2, 2, 2), (1, 1, 1), (1, 1, 1), 1),
]
# every padding mode at every rank, with padding 2 on the first axis and 1
# on the others; then the sweep's cases, padded by 1 (zero)
CONV_LAYER_CASES = [
    (mode, ((2, 3, 7, 6, 5)[:2 + nd], (4, 3, 3, 2, 3)[:2 + nd],
            (1,) * nd, (1,) * nd, 1), (2, 1, 1)[:nd])
    for nd in (1, 2, 3) for mode, _ in PADDINGS
] + [("zero", case, (1,) * len(case[2])) for case in CONV_CASES]


@pytest.mark.parametrize(
    "mode,case,padding", CONV_LAYER_CASES,
    ids=[f"{m}-{len(c[2])}d-s{c[2][0]}d{c[3][0]}g{c[4]}-{i}"
         for i, (m, c, _) in enumerate(CONV_LAYER_CASES)])
def test_conv_layers_match_jax(mode, case, padding):
    """Conv1d/2d/3d (GroupedConv* where groups > 1): pad, VALID conv and
    the bias unsqueezed per spatial axis, forward and every gradient."""
    xs, ks, stride, dil, groups = case
    nd = len(stride)
    name = f"{'Grouped' if groups > 1 else ''}Conv{nd}d"
    layers = [getattr(pkg, name)(xs[1], ks[0], ks[2:], padding,
                                 dict(PADDINGS)[mode](top), stride, dil,
                                 groups)
              for pkg, top in ((jnn, jk), (nn, nk))]
    assert layers[1].weight.shape == (ks[0], xs[1] // groups, *ks[2:])
    _run_both(*layers, [_rnd(*xs)],
              lambda pkg, lay, v: [lay.forward(v[0])])


def test_conv_layer_checks_its_arguments():
    with pytest.raises(ValueError, match="divisible"):
        nn.Conv2d(3, 4, 3, 1, nk.Zero(), 1, 1, groups=2)
    with pytest.raises(ValueError, match="expected 2 values"):
        nn.Conv2d(2, 4, (3, 3, 3), 1, nk.Zero(), 1, 1)


def test_params_from_jax_checks_count_and_shapes():
    lin = nn.Linear(3, 2)
    with pytest.raises(ValueError, match="2 parameters"):
        nn.params_from_jax(lin, [np.zeros((2, 3))])
    with pytest.raises(ValueError, match="shape"):
        nn.params_from_jax(lin, [np.zeros((3, 2)), np.zeros(2)])


def test_layers_live_on_config_device():
    """Parameters go where the factories put leaves: config.device, which
    is "cuda" unless the caller asks for the CPU; no card means an error,
    never a silent CPU."""
    assert nn.Linear(3, 2).weight.device == torch.device("cpu")
    nk.config.device = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            nn.Linear(3, 2)


def test_loss_wrappers_match_methods():
    x = nk.from_ndarray(np.array([[0.2, 0.7], [0.9, 0.4]], np.float32))
    t = nk.from_ndarray(np.array([[0.0, 1.0], [1.0, 0.0]], np.float32))
    for name in ("mae", "mse", "bce", "bce_with_logits", "kldiv"):
        for red in (nn.loss.Reduction.Mean, nn.loss.Reduction.Sum):
            a = getattr(nn.loss, f"{name}_loss")(x, t, red)
            b = getattr(x, name)(t, red)
            a.forward()
            b.forward()
            assert float(a.data()) == float(b.data())
    logp = x.log_softmax(0)
    tgt = nk.from_ndarray(np.array([1.0, 0.0], np.float32))
    a, b = nn.loss.nll_loss(logp, tgt), logp.nll(tgt)
    a.forward()
    b.forward()
    assert float(a.data()) == float(b.data())


# -------------------------------------------------------------------- init


@pytest.mark.parametrize("shape", [(8, 4), (8, 4, 3), (8, 4, 3, 3),
                                   (6, 5, 2, 3, 4)])
def test_fan_in_fan_out_matches_jax(shape):
    """The receptive field's product, as JAX computes it."""
    a = nn.init.calculate_fan_in_fan_out(nk.zeros(shape))
    b = jnn.init.calculate_fan_in_fan_out(jk.zeros(shape))
    assert a == b
    with pytest.raises(ValueError):
        nn.init.calculate_fan_in_fan_out(nk.zeros(4))


def test_calculate_gain_matches_jax():
    for act in ("linear", "sigmoid", "conv", "tanh", "relu", "leaky_relu"):
        assert nn.init.calculate_gain(act) == jnn.init.calculate_gain(act)
    with pytest.raises(ValueError):
        nn.init.calculate_gain("swish")


@pytest.mark.parametrize("shape,groups", [((3, 3), 1), ((2, 5), 1),
                                          ((4, 4, 3), 1), ((6, 3, 3, 5), 2),
                                          ((4, 2, 3, 3, 3), 2)])
def test_deterministic_inits_match_jax_exactly(shape, groups):
    """constant, zeros, ones, eye (2-d) and dirac (3-5-d) write JAX's
    values bit for bit."""
    calls = [("constant", (2.5,)), ("zeros", ()), ("ones", ())]
    calls.append(("eye", ()) if len(shape) == 2 else ("dirac", (groups,)))
    for name, args in calls:
        w, jw = nk.zeros(shape).requires_grad(), jk.zeros(shape)
        getattr(nn.init, name)(w, *args)
        getattr(jnn.init, name)(jw, *args)
        np.testing.assert_array_equal(_to_numpy(w.data()),
                                      np.asarray(jw.data()))


def test_init_shape_checks():
    with pytest.raises(ValueError):
        nn.init.eye(nk.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        nn.init.dirac(nk.zeros((2, 2)))
    with pytest.raises(ValueError, match="divisible"):
        nn.init.dirac(nk.zeros((3, 2, 3)), groups=2)


N_DRAW = (300, 400)     # 120000 draws: 4 standard errors of a mean of
SE = 4 / np.sqrt(N_DRAW[0] * N_DRAW[1])  # unit variance are 0.0115


@pytest.mark.parametrize("name", ["uniform", "normal", "xavier_uniform",
                                  "xavier_normal"])
def test_random_inits_by_range_and_moments(name):
    """The draws' range and first two moments: the mean within 4 standard
    errors, the variance within 2%, and a fresh draw differs while the
    same seed repeats itself."""
    fan = 700.0
    a = np.sqrt(6.0 / fan)                     # xavier_uniform's bound
    spec = {"uniform": ((-0.3, 0.5), 0.1, 0.8 ** 2 / 12, (-0.3, 0.5)),
            "normal": ((1.5, 2.0), 1.5, 4.0, None),
            "xavier_uniform": ((), 0.0, a * a / 3, (-a, a)),
            "xavier_normal": ((), 0.0, 2.0 / fan, None)}[name]
    args, mean, var, rng = spec
    w = nk.zeros(N_DRAW).requires_grad()
    nk.seed(3)
    getattr(nn.init, name)(w, *args)
    d = _to_numpy(w.data()).astype(np.float64)
    if rng is not None:
        assert d.min() >= rng[0] and d.max() <= rng[1]
    assert abs(d.mean() - mean) <= SE * np.sqrt(var)
    assert abs(d.var() / var - 1.0) <= 0.02
    first = d.copy()
    getattr(nn.init, name)(w, *args)
    assert not np.array_equal(_to_numpy(w.data()), first)
    nk.seed(3)
    getattr(nn.init, name)(w, *args)
    np.testing.assert_array_equal(_to_numpy(w.data()), first)


def test_layer_init_bounds():
    """Linear and the cells draw U(-k, k) with JAX's k."""
    lin = nn.Linear(8, 4)
    assert float(lin.weight.data().abs().max()) <= np.sqrt(1 / 8)
    conv = nn.Conv2d(4, 6, 3, 0, nk.Zero(), 1, 1, groups=2)
    assert float(conv.weight.data().abs().max()) <= np.sqrt(2 / (4 * 9))
    cell = nn.LSTMCell(3, 16)
    assert all(float(p.data().abs().max()) <= 0.25
               for p in cell.parameters())


# ---------------------------------------------------------------- dropout


def test_dropout_and_model_status_by_property():
    """Rate p zeroes about p of the entries and scales the rest by
    1/(1-p); eval is the identity; ModelStatus hands every registered
    Dropout its one cell, so train()/eval() switch them all."""
    status = nn.ModelStatus.default()
    d1 = status.register(nn.Dropout(0.25))
    d2 = status.register(nn.Dropout(0.5))
    lin = status.register(nn.Linear(4, 4))
    assert d1._status is status.cell and d2._status is status.cell
    assert status.parameters() == lin.parameters()
    x = nk.ones((200, 100))
    for drop, p in ((d1, 0.25), (d2, 0.5)):
        y = drop.forward(x)
        y.forward()
        v = _to_numpy(y.data())
        kept = v != 0
        assert abs(1.0 - kept.mean() - p) <= 4 * np.sqrt(p * (1 - p) / v.size)
        np.testing.assert_allclose(v[kept], 1.0 / (1.0 - p), rtol=1e-6)
    status.eval()
    for drop in (d1, d2):
        y = drop.forward(x)
        y.forward()
        np.testing.assert_array_equal(_to_numpy(y.data()), 1.0)
    status.train()
    y = d1.forward(x)
    y.forward()
    assert (_to_numpy(y.data()) == 0).any()


def test_dropout_gradient_uses_the_forward_mask():
    drop = nn.Dropout(0.5)
    x = nk.from_ndarray(np.full((64, 8), 2.0, np.float32)).requires_grad()
    y = drop.forward(x)
    loss = y.sum()
    loss.forward()
    loss.backward(1.0)
    np.testing.assert_array_equal(_to_numpy(x.grad()) != 0,
                                  _to_numpy(y.data()) != 0)
    with pytest.raises(ValueError):
        nn.Dropout(1.5)
