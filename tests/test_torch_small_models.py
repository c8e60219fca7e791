"""The port's small Var models (neuronika_tpu_torch/models/mlp.py, cnn.py,
rnn.py), the twins of the JAX package's examples
(neuronika_tpu_torch/examples/) and `utils.serde`, against the JAX package
on the CPU in f32.

Each twin runs at a small width with JAX's initial weights carried across
(the quickstart's through JAX's JSON `state_dict`, the others through
`nn.params_from_jax`) beside the same recipe written against the JAX
package, on the same data. The loss sequences must agree within TOL
(1e-5) relative and TOL of the largest loss (at least 1) absolute; they
read 1e-7 apart here. The same twin under `enable_kernels()` with `conv_route="force"` (on the
CPU: K3's, K4's and K12's plain versions) must give the plain route's
numbers within TOL, as two f32 routes that differ in summation order
only."""

import json

import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu import data as jdata
from neuronika_tpu import models as jmodels
from neuronika_tpu import nn as jnn
from neuronika_tpu import optim as joptim
from neuronika_tpu import utils as jutils
from neuronika_tpu_torch import models, nn, optim, utils
from neuronika_tpu_torch.examples import char_rnn, mnist_cnn, quickstart
from neuronika_tpu_torch.variable import _to_numpy
from tests.conftest import TOL

@pytest.fixture(autouse=True)
def _cpu():
    old, route = nk.config.device, nk.config.conv_route
    nk.config.device = "cpu"
    yield
    nk.config.device = old
    nk.config.conv_route = route
    nk.enable_kernels(False)


def close(a, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(a, np.float64), ref, rtol=tol,
        atol=tol * max(1.0, float(np.abs(ref).max(initial=0.0))))


def _weights(jmodel):
    return [np.asarray(p.data()) for p in jmodel.parameters()]


def _kernel_route(run):
    """`run()` under enable_kernels() with conv_route "force"."""
    nk.enable_kernels(True)
    nk.config.conv_route = "force"
    try:
        return run()
    finally:
        nk.enable_kernels(False)


# --------------------------------------------------------------- quickstart


class _JaxNet:
    def __init__(self):
        self.status = jnn.ModelStatus.default()
        self.lin1 = self.status.register(jnn.Linear(3, 5))
        self.lin2 = self.status.register(jnn.Linear(5, 5))
        self.lin3 = self.status.register(jnn.Linear(5, 1))

    def layers(self):
        return {"lin1": self.lin1, "lin2": self.lin2, "lin3": self.lin3}

    def forward(self, x):
        out = self.lin2.forward(self.lin1.forward(x).relu()).relu()
        return self.lin3.forward(out)


def _jax_quickstart(state, steps, seed):
    """examples/quickstart.py's recipe on the JAX package, with the twin's
    seeded shuffles."""
    dataset = jdata.DataLoader.default().with_labels([3]).from_reader_fn(
        quickstart.CSV, 3, 1,
        lambda p: (p[0], [{"Dog": 1.0, "Cat": 2.0}.get(p[1], 3.0)]))
    model = _JaxNet()
    jutils.load_state_dict(model.layers(), state)
    opt = joptim.SGD(0.01, joptim.L2(0.0))
    opt.register_all(model.status.parameters())
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        total = 0.0
        dataset.shuffle_with_seed(int(rng.integers(2 ** 63)))
        for x, y in dataset.batch(2).drop_last():
            loss = model.forward(jk.from_ndarray(x)).mse(
                jk.from_ndarray(y), jk.Reduction.Mean)
            loss.forward()
            total += loss.item()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
        losses.append(total)
    return losses


def test_quickstart_twin_matches_jax():
    """JAX's model JSON loads into the twin; five epochs' losses agree,
    and the K3 route gives the same."""
    state = json.loads(json.dumps(jutils.state_dict(_JaxNet().layers())))
    ref = _jax_quickstart(state, 5, seed=3)
    got = quickstart.main(device="cpu", steps=5, seed=3, state=state,
                          verbose=False)
    close(got, ref)
    assert got[-1] < got[0]
    close(_kernel_route(lambda: quickstart.main(
        device="cpu", steps=5, seed=3, state=state, verbose=False)), got)


def test_quickstart_twin_runs_on_its_own():
    losses = quickstart.main(device="cpu", verbose=False)
    assert len(losses) == 5 and np.isfinite(losses).all()


def test_mlp_matches_jax():
    jm, m = jmodels.MLP((3, 7, 5, 2)), models.MLP((3, 7, 5, 2))
    nn.params_from_jax(m, _weights(jm))
    x = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    ys = []
    for pkg, model in ((jk, jm), (nk, m)):
        model.eval()
        y = model.forward(pkg.from_ndarray(x))
        y.forward()
        ys.append(np.asarray(y.data()))
    close(ys[1], ys[0])
    assert len(m.parameters()) == 6


# ---------------------------------------------------------------- MNIST CNN

CNN = dict(channels=4, hidden=16, image=12)


def _jax_mnist(weights, steps, n, batch, seed):
    """examples/mnist_cnn.py's recipe on the JAX package, in eval mode."""
    rng = np.random.default_rng(seed)
    X, Y = mnist_cnn.synthetic_digits(n, rng, CNN["image"])
    cnn = jmodels.MnistCNN(**CNN)
    for p, w in zip(cnn.parameters(), weights):
        p.assign(w)
    cnn.eval()
    opt = joptim.Adam(1e-3, penalty=joptim.L2(1e-4))
    opt.register_all(cnn.parameters())
    losses = []
    for _ in range(steps):
        perm = rng.permutation(len(X))
        for i in range(0, len(X), batch):
            idx = perm[i:i + batch]
            loss = cnn.forward(jk.from_ndarray(X[idx])).log_softmax(1).t() \
                .nll(jk.from_ndarray(Y[idx]), jk.Reduction.Mean)
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
            losses.append(loss.item())
    return losses


def test_mnist_twin_matches_jax():
    """MnistCNN(4, 16, image 12) in eval: 2 epochs of 32 images in batches
    of 16, Adam(1e-3, L2(1e-4)); and the K3/K4/K12 route."""
    weights = _weights(jmodels.MnistCNN(**CNN))
    ref = _jax_mnist(weights, 2, 32, 16, seed=1)
    kw = dict(device="cpu", steps=2, n=32, batch=16, seed=1, train=False,
              weights=weights, verbose=False, **CNN)
    got = mnist_cnn.main(**kw)
    assert len(got) == 4
    close(got, ref)
    close(_kernel_route(lambda: mnist_cnn.main(**kw)), got)


def test_synthetic_digits_at_28_is_the_examples():
    """At 28 x 28 the generator draws what examples/mnist_cnn.py draws."""
    a = mnist_cnn.synthetic_digits(20, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    ys = rng.integers(0, 10, 20)
    xs = np.zeros((20, 1, 28, 28), np.float32)
    for i, y in enumerate(ys):
        r0, c0 = 4 + (y % 5) * 4, 4 + (y // 5) * 8
        xs[i, 0, r0:r0 + 3, c0:c0 + 12] = 1.0
        xs[i, 0] += rng.normal(0, 0.1, (28, 28))
    np.testing.assert_array_equal(a[0], xs)
    np.testing.assert_array_equal(a[1], ys.astype(np.float32))


def test_jax_state_dict_loads_into_the_port():
    """JAX's MnistCNN JSON state loads into the port's, layer by layer;
    the eval-mode logits then agree."""
    jm, m = jmodels.MnistCNN(**CNN), models.MnistCNN(**CNN)
    names = ("conv1", "conv2", "drop", "fc1", "fc2")
    state = json.loads(json.dumps(jutils.state_dict(
        {k: getattr(jm, k) for k in names})))
    assert state["drop"] == {}
    utils.load_state_dict({k: getattr(m, k) for k in names}, state)
    x = mnist_cnn.synthetic_digits(3, np.random.default_rng(2), 12)[0]
    out = []
    for pkg, model in ((jk, jm), (nk, m)):
        model.eval()
        y = model.forward(pkg.from_ndarray(x))
        y.forward()
        out.append(np.asarray(y.data()))
    close(out[1], out[0])
    assert utils.state_dict({k: getattr(m, k) for k in names}) == state


# ----------------------------------------------------------------- char-RNN

RNN = dict(hidden=8, batch=4, lengths=(3, 5), lr=1e-2, seed=0)


def _jax_char_rnn(weights, steps, cell):
    text = char_rnn.TEXT
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.array([stoi[c] for c in text], dtype=np.int64)
    rnn = jmodels.CharRNN(vocab=len(chars), hidden=RNN["hidden"], cell=cell)
    for p, w in zip(rnn.parameters(), weights):
        p.assign(w)
    opt = joptim.Adam(RNN["lr"])
    opt.register_all(rnn.parameters())
    rng = np.random.default_rng(RNN["seed"])
    losses = []
    for step in range(steps):
        T = RNN["lengths"][step % len(RNN["lengths"])]
        starts = rng.integers(0, len(ids) - T - 1, size=RNN["batch"])
        batch = np.stack([ids[s:s + T] for s in starts])
        target = np.stack([ids[s + 1:s + T + 1] for s in starts])
        loss = rnn.loss(batch, target)
        loss.forward()
        loss.backward(1.0)
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_char_rnn_twin_matches_jax(cell):
    """6 Adam(1e-2) steps over windows of 3 and 5, hidden 8, batch 4; and
    the K3/K4 route."""
    vocab = len(set(char_rnn.TEXT))
    weights = _weights(jmodels.CharRNN(vocab, RNN["hidden"], cell))
    ref = _jax_char_rnn(weights, 6, cell)
    kw = dict(device="cpu", steps=6, cell=cell, weights=weights,
              verbose=False, **RNN)
    got = char_rnn.main(**kw)
    close(got, ref)
    close(_kernel_route(lambda: char_rnn.main(**kw)), got)


def test_char_rnn_samples(capsys):
    char_rnn.main(device="cpu", steps=2, hidden=8, sample=5)
    assert "sample: t" in capsys.readouterr().out


def test_char_rnn_rejects_unknown_cell():
    with pytest.raises(ValueError, match="lstm"):
        models.CharRNN(5, 4, cell="rnn")


# -------------------------------------------------------------------- serde


def test_var_json_is_jax_layout():
    """The JSON of a variable is JAX's, key for key and value for value;
    loads rebuilds a leaf on config.device."""
    a = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    d = utils.var_to_dict(nk.from_ndarray(a))
    assert d == jutils.var_to_dict(jk.from_ndarray(a))
    assert d["v"] == 1 and d["dim"] == [2, 3]
    v = utils.loads(utils.dumps(nk.from_ndarray(a)), requires_grad=True)
    assert isinstance(v, nk.VarDiff) and v.device == torch.device("cpu")
    np.testing.assert_array_equal(_to_numpy(v.data()), a)
    b = nk.from_ndarray(a, dtype=torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(utils.var_to_dict(b)["data"]),
                                  _to_numpy(b.data()).reshape(-1))


def test_npz_round_trip(tmp_path):
    lin = nn.Linear(3, 2)
    path = str(tmp_path / "ckpt")
    utils.save_npz(path, {"w": lin.weight, "b": lin.bias})
    other = nn.Linear(3, 2)
    utils.load_npz(path, {"w": other.weight, "b": other.bias})
    for p, q in zip(lin.parameters(), other.parameters()):
        np.testing.assert_array_equal(_to_numpy(p.data()),
                                      _to_numpy(q.data()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_optimizer_round_trip(tmp_path, dtype):
    """save_optimizer/load_optimizer carry the slots (in their dtypes) and
    the step count, so a resumed run takes the same next step."""
    g = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)

    def run(opt, p, n):
        for _ in range(n):
            loss = (p * nk.from_ndarray(g, dtype=dtype)).sum()
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()

    p = nk.from_ndarray(np.ones((4, 3)), dtype=dtype).requires_grad()
    opt = optim.Adam(0.1)
    opt.register(p)
    run(opt, p, 2)
    utils.save_optimizer(str(tmp_path / "opt"), opt)
    q = nk.from_ndarray(_to_numpy(p.data()), dtype=dtype).requires_grad()
    resumed = optim.Adam(0.1)
    resumed.register(q)
    utils.load_optimizer(str(tmp_path / "opt"), resumed)
    assert resumed._step_count == 2
    assert resumed._state[0]["exp_avg"].dtype == dtype
    run(opt, p, 1)
    run(resumed, q, 1)
    np.testing.assert_array_equal(_to_numpy(p.data()), _to_numpy(q.data()))
