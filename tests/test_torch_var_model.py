"""The port's define-by-run GPTs (`build_var_model_batched`,
`build_var_model` in neuronika_tpu_torch/models/transformer.py) and its
`optim.Adam` against the JAX package on the CPU in f32: the seeded weight
draw, the logits, three fused `Adam.train_step`s (losses and parameters),
the step-by-step loop against the fused step, and the `flash_attention` op
against JAX's packed Pallas kernel in interpret mode. On the card (`cuda`
marker): the kernel route against the plain route and its launch counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronika_tpu as jk
import neuronika_tpu_torch as nk
from neuronika_tpu import optim as joptim
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import optim as toptim
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.ops import flash_attention as FA
from neuronika_tpu_torch.ops import matmul as MM
from neuronika_tpu_torch.ops import softmax as SM
from tests.conftest import TOL, assert_close

SMALL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
             max_seq=16)
B, S = 2, 16
LR = 1e-3
# parameters after 3 Adam steps: Adam divides each gradient element by its
# own running RMS, so a small element's rounding difference is magnified up
# to lr-sized moves (ROADMAP.md section 3); no element here is rounding
# noise, and the difference stays under 3e-6. Bound: the repo's f32
# gradient bound, 2e-5 (tests/test_torch_train.py)
ADAM_PARAM_TOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old
    nk.enable_kernels(False)


def _build(batched, seed=0, jdtype=jnp.float32, tdtype=torch.float32,
           device=None, **kw):
    cfg = dict(SMALL, **kw)
    jcfg = JT.GPTConfig(dtype=jdtype, dropout=0.0, **cfg)
    tcfg = TT.GPTConfig(dtype=tdtype, dropout=0.0, **cfg)
    out = []
    for mod, c in ((JT, jcfg), (TT, tcfg)):
        np.random.seed(seed)
        if batched:
            kw = {} if mod is JT else {"device": device}
            out.append(mod.build_var_model_batched(c, batch=B, seq=S, **kw))
        else:
            kw = {} if mod is JT else {"device": device}
            out.append(mod.build_var_model(c, batch=1, seq=S, **kw))
    (jp, jfwd), (tp, tfwd) = out
    return jp, jfwd, tp, tfwd


def _ids(batched, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, S) if batched else (S,)
    ids = rng.integers(0, SMALL["vocab_size"], size=shape).astype(np.float32)
    return ids, np.roll(ids, -1, axis=-1).reshape(-1)


def _loss(mod, fwd, ids, tgt, batched):
    x, t = mod.from_ndarray(ids), mod.from_ndarray(tgt)
    logits = fwd(x)
    if batched:
        logits = logits.reshape((B * S, SMALL["vocab_size"]))
    return logits.log_softmax(1).t().nll(t, mod.Reduction.Mean)


def _np(v):
    t = v.data()
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "2d"])
def test_seeded_weights_and_logits_match_jax(batched):
    jp, jfwd, tp, tfwd = _build(batched)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(_np(b), _np(a))
    TT.load_var_params(tp, [np.asarray(p.data()) for p in jp])
    ids, _ = _ids(batched)
    jl, tl = jfwd(jk.from_ndarray(ids)), tfwd(nk.from_ndarray(ids))
    jl.forward()
    tl.forward()
    assert tl.dtype == torch.float32
    assert_close(tl.data().numpy(), jl.data(), tol=TOL)


def test_bf16_weights_match_jax_bit_for_bit():
    """Same draw, same cast: the bf16 parameters are identical."""
    jp, _, tp, _ = _build(True, jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    for a, b in zip(jp, tp):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b), _np(a))
    TT.load_var_params(tp, [np.asarray(p.data()) for p in jp])


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "2d"])
def test_adam_train_steps_match_jax(batched):
    jp, jfwd, tp, tfwd = _build(batched)
    TT.load_var_params(tp, [np.asarray(p.data()) for p in jp])
    ids, tgt = _ids(batched)
    jopt, topt = joptim.Adam(LR), toptim.Adam(LR)
    jopt.register_all(jp)
    topt.register_all(tp)
    jloss = _loss(jk, jfwd, ids, tgt, batched)
    tloss = _loss(nk, tfwd, ids, tgt, batched)
    jl = [jopt.train_step(jloss) for _ in range(3)]
    tl = [topt.train_step(tloss) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    err = max(np.abs(_np(b) - _np(a)).max() for a, b in zip(jp, tp))
    assert err <= ADAM_PARAM_TOL


def test_step_by_step_matches_fused_step():
    """forward; backward; step; zero_grad gives the fused step's losses and
    parameters (the same update math, the same order)."""
    runs = []
    for fused in (False, True):
        _, _, tp, tfwd = _build(True)
        opt = toptim.Adam(LR)
        opt.register_all(tp)
        ids, tgt = _ids(True)
        loss = _loss(nk, tfwd, ids, tgt, True)
        losses = []
        for _ in range(2):
            if fused:
                losses.append(opt.train_step(loss))
            else:
                loss.forward()
                losses.append(loss.item())
                loss.backward(1.0)
                opt.step()
                opt.zero_grad()
        runs.append((losses, [_np(p) for p in tp]))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_allclose(l1, l0, rtol=TOL, atol=TOL)
    for a, b in zip(p0, p1):
        assert_close(b, a, tol=TOL)


def test_fused_step_leaves_interior_cells_empty():
    _, _, tp, tfwd = _build(True)
    opt = toptim.Adam(LR)
    opt.register_all(tp)
    ids, tgt = _ids(True)
    x = nk.from_ndarray(ids)
    logits = tfwd(x)
    loss = logits.reshape((B * S, SMALL["vocab_size"])).log_softmax(1).t() \
        .nll(nk.from_ndarray(tgt), nk.Reduction.Mean)
    assert opt.train_step(loss, block=False) is None
    assert np.isfinite(loss.item())
    assert logits.node.value is None and not logits.node.computed
    assert tp[0].node.grad is None


def test_sgd_and_penalties_match_jax():
    rng = np.random.default_rng(3)
    w0, x0 = rng.standard_normal((4, 3)), rng.standard_normal((5, 4))
    out = {}
    for name, mod, opt_mod in (("jax", jk, joptim), ("torch", nk, toptim)):
        w = mod.from_ndarray(w0).requires_grad()
        loss = mod.from_ndarray(x0).mm(w).relu().sum()
        opt = opt_mod.SGD(0.1, penalty=opt_mod.ElasticNet(0.01, 0.02),
                          momentum=0.9, dampening=0.1, nesterov=True)
        opt.register(w)
        for _ in range(3):
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
        out[name] = _np(w)
    assert_close(out["torch"], out["jax"], tol=TOL)


def test_clip_grad_norm_matches_jax():
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((4, 3))
    res = {}
    for name, mod, opt_mod in (("jax", jk, joptim), ("torch", nk, toptim)):
        w = mod.from_ndarray(w0).requires_grad()
        y = (w * 10.0).sum()
        y.forward()
        y.backward(1.0)
        res[name] = (opt_mod.clip_grad_norm([w], 1.0), np.asarray(w.grad()))
    assert res["torch"][0] == pytest.approx(res["jax"][0], rel=1e-6)
    assert_close(res["torch"][1], res["jax"][1], tol=TOL)


def test_load_var_params_checks_shape_and_dtype():
    _, _, tp, _ = _build(True)
    arrays = [_np(p) for p in tp]
    with pytest.raises(ValueError, match="arrays for"):
        TT.load_var_params(tp, arrays[:-1])
    bad = list(arrays)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="shape"):
        TT.load_var_params(tp, bad)
    bad[0] = arrays[0].astype(np.float64)
    with pytest.raises(TypeError, match="dtype"):
        TT.load_var_params(tp, bad)


def test_flash_op_matches_jax_interpret_kernel():
    """hd 128, S 128: JAX runs its packed Pallas kernel (interpret mode,
    fast softmax, fused backward); the port on the CPU runs the composite.
    Exact math on both sides, f32: TOL forward, 1e-4 for the gradient."""
    H, hd = 2, 128
    x = (0.1 * np.random.default_rng(5).standard_normal(
        (1, 128, 3 * H * hd))).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((1, 128, H * hd)).astype(
        np.float32)
    jk.enable_pallas(True, interpret=True)
    try:
        jv = jk.from_ndarray(x).requires_grad()
        jout = jv.flash_attention(H)
        jloss = (jout * jk.from_ndarray(w)).sum()
        jloss.forward()
        jloss.backward(1.0)
        jdata, jgrad = np.asarray(jout.data()), np.asarray(jv.grad())
    finally:
        jk.enable_pallas(False)
    tv = nk.from_ndarray(x).requires_grad()
    tout = tv.flash_attention(H)
    tloss = (tout * nk.from_ndarray(w)).sum()
    tloss.forward()
    tloss.backward(1.0)
    assert_close(tout.data().numpy(), jdata, tol=TOL)
    assert_close(tv.grad().numpy(), jgrad, tol=1e-4)


def test_flash_op_dropout_runs_on_the_cpu():
    status = nk.StatusCell(True)
    x = nk.from_ndarray(np.random.default_rng(7).standard_normal(
        (1, 16, 24)).astype(np.float32)).requires_grad()
    y = x.flash_attention(2, dropout=0.5, status=status).sum()
    y.forward()
    y.backward(1.0)
    assert np.isfinite(y.item()) and np.isfinite(x.grad().numpy()).all()


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (FA.flash_fwd_qkv.launches, FA.flash_bwd_fused_qkv.launches,
            MM.matmul.launches, SM.softmax_last_axis.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "2d"])
def test_kernel_route_matches_plain_route_on_gpu(cuda, batched):
    """hd 128 so the flash op takes K1/K2; with kernels on, mm runs K3 and
    softmax K4. Loss and every parameter gradient on the card against the
    same graph on the CPU (all plain versions), f32: TOL for the loss and
    2e-5 for the gradients (another summation order). The parameters after
    one Adam step within 2 lr: Adam's first step moves every element by
    lr g / (|g| + eps), so a gradient element near eps that rounds to
    another sign or size moves by up to lr either way (ROADMAP.md section
    3 records the one such element this test met at 2e-5)."""
    H, L = 2, SMALL["n_layer"]
    kw = dict(n_head=H, d_model=256, d_ff=256)
    res = {}
    for dev in ("cpu", "cuda"):
        nk.enable_kernels(dev == "cuda")
        _, _, tp, tfwd = _build(batched, device=dev, **kw)
        nk.config.device = dev
        ids, tgt = _ids(batched)
        loss = _loss(nk, tfwd, ids, tgt, batched)
        before = _counts()
        loss.forward()
        loss.backward(1.0)
        torch.cuda.synchronize()
        used = [a - b for a, b in zip(_counts(), before)]
        grads = [p.grad().float().cpu().numpy() for p in tp]
        opt = toptim.Adam(LR)
        opt.register_all(tp)
        opt.step()
        res[dev] = (loss.item(), grads, used,
                    [p.data().float().cpu().numpy() for p in tp])
    assert abs(res["cuda"][0] - res["cpu"][0]) <= TOL
    if batched:
        # K1 forward and again in the VJP for its lse; fused K2; one K4
        assert res["cuda"][2] == [2 * L, L, 0, 1]
    else:
        # per layer 3 + 2 H + 1 + 3 products and the head, each with 2 VJP
        # products; H attention softmaxes a layer and the log-softmax
        assert res["cuda"][2] == [0, 0, 3 * (L * (7 + 2 * H) + 1),
                                  H * L + 1]
    assert res["cpu"][2] == [0, 0, 0, 0]
    for a, b in zip(res["cpu"][1], res["cuda"][1]):
        assert_close(b, a, tol=2e-5)
    for a, b in zip(res["cpu"][3], res["cuda"][3]):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR)


@pytest.mark.cuda
def test_flash_dropout_on_the_card_is_refused(cuda):
    """Attention dropout on the card is no longer refused: K1 and the fused
    K2 drop inside the kernels, keyed by the executor's seed, and the
    output and gradient equal the CPU composite's, which draws the same
    mask from the same seed (the global stream seeded alike)."""
    data = np.random.default_rng(0).standard_normal((2, 64, 3 * 2 * 64))
    g = np.random.default_rng(1).standard_normal((2, 64, 2 * 64))
    res = {}
    for dev in ("cpu", "cuda"):
        nk.config.device = dev
        nk.seed(123)
        x = nk.from_ndarray(data).requires_grad()
        w = nk.from_ndarray(g)
        before = FA.flash_fwd_qkv.launches
        y = x.flash_attention(2, dropout=0.1, status=nk.StatusCell(True))
        loss = (y * w).sum()
        loss.forward()
        loss.backward(1.0)
        torch.cuda.synchronize()
        res[dev] = (y.data().float().cpu().numpy(),
                    x.grad().float().cpu().numpy(),
                    FA.flash_fwd_qkv.launches - before)
    assert res["cuda"][2] == 2 and res["cpu"][2] == 0
    assert_close(res["cuda"][0], res["cpu"][0], tol=TOL)
    assert_close(res["cuda"][1], res["cpu"][1], tol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width, n_kv, dtype", [
    (3 * 2 * 256, 0, torch.float32),       # head dim 256
    (3 * 2 * 64, 0, torch.float16),        # f16
    ((16 + 2) * 64, 1, torch.float32),     # 16 query heads per kv head
], ids=["hd256", "f16", "g16"])
def test_flash_shapes_the_kernels_cannot_take_are_refused(cuda, width, n_kv,
                                                          dtype):
    """On the card the op runs K1/K2 where they take the shape and, as
    JAX's op where its kernel does not qualify, the composite elsewhere:
    these shapes launch no kernel and give the CPU composite's output."""
    n_head = 2 if n_kv == 0 else 16
    data = np.random.default_rng(0).standard_normal((1, 16, width))
    out = {}
    for dev in ("cpu", "cuda"):
        nk.config.device = dev
        x = nk.from_ndarray(data, dtype=dtype)
        y = x.flash_attention(n_head, n_kv)
        before = FA.flash_fwd_qkv.launches
        y.forward()
        assert FA.flash_fwd_qkv.launches == before
        out[dev] = y.data().float().cpu().numpy()
        assert np.isfinite(out[dev]).all()
    assert_close(out["cuda"], out["cpu"],
                 tol=TOL if dtype == torch.float32 else 1e-2)
