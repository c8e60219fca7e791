"""K12-K15 (neuronika_tpu_torch/ops/conv.py): the plain versions against
JAX's Pallas kernels run in interpret mode (as tests/test_pallas.py runs
them on the CPU), the NCHW facade and the composed stride-1 gradients,
`conv2d_pallas_nhwc` with its gradients against `jax.vjp` of JAX's, the
stacked K12's decomposition at Ci < 8 (`stack_plan`, the pre-pass's and
the weights' plain versions, the (kq x 1) conv) against JAX's K12, the
route table, the kernel route of every ResNet-18 conv, the Hopper K13's
split plan and SAME padding; and, on the card, each CUDA kernel against
its plain version (the Hopper K12 and K13 at ResNet-18's stage shapes and
ragged ones too). Inputs come from numpy seeds; sizes stay small (H, W <=
16, channels <= 16) so that JAX's interpret mode stays quick. f32 bounds:
TOL (1e-5) of the largest |entry| of the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas import conv as JC
from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.models import resnet as TR
from neuronika_tpu_torch.ops import conv as TC
from tests.conftest import TOL

# gradients sum more products (dw over the batch and every pixel)
GRAD_TOL = 1e-4


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(out, ref, tol=TOL):
    """max |out - ref| <= tol * max |ref| (at least tol)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


# (x shape NHWC, kernel (kh, kw, Ci/groups, Co), stride, dilation, groups)
K12_CASES = {
    "s1": ((2, 13, 12, 8), (3, 3, 8, 16), (1, 1), (1, 1), 1),
    "s2": ((2, 13, 12, 8), (3, 3, 8, 16), (2, 2), (1, 1), 1),
    "s3x2": ((2, 13, 12, 8), (3, 3, 8, 16), (3, 2), (1, 1), 1),
    "s3": ((1, 16, 15, 4), (3, 3, 4, 8), (3, 3), (1, 1), 1),
    "dil2": ((1, 14, 14, 8), (3, 3, 8, 12), (1, 1), (2, 2), 1),
    "dil2x1-k3x2": ((2, 11, 9, 5), (3, 2, 5, 7), (1, 1), (2, 1), 1),
    "g2": ((2, 10, 10, 8), (3, 3, 4, 12), (1, 1), (1, 1), 2),
    "g4": ((2, 10, 9, 16), (3, 3, 4, 8), (1, 1), (1, 1), 4),
    "g2-s2": ((2, 10, 10, 8), (3, 3, 4, 12), (2, 2), (1, 1), 2),
    "ci3-7x7-s2": ((2, 16, 16, 3), (7, 7, 3, 8), (2, 2), (1, 1), 1),
    "1x1-s2": ((2, 9, 8, 16), (1, 1, 16, 8), (2, 2), (1, 1), 1),
}


@pytest.mark.parametrize("name", list(K12_CASES))
def test_plain_conv2d_matches_jax_kernel(name):
    xs, ws, stride, dil, groups = K12_CASES[name]
    x, w = _randn(*xs), _randn(*ws, seed=1, scale=0.3)
    ref = JC.conv2d_direct_nhwc(jnp.asarray(x), jnp.asarray(w), dil, stride,
                                groups=groups, interpret=True)
    out = TC.conv2d_direct_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                                dil, stride, groups=groups)
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("d,s", [((2, 2), (2, 2)), ((2, 1), (3, 2))])
def test_plain_conv2d_strided_and_dilated_matches_lax(d, s):
    """K12 takes a stride and a dilation at once (JAX's phase decomposition
    refuses the pair): against lax's conv."""
    x, w = _randn(2, 15, 14, 6), _randn(3, 3, 6, 8, seed=1, scale=0.3)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), s, "VALID", rhs_dilation=d,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _close(TC.conv2d_direct_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                                 d, s), ref)


# K12 at Ci < 8 on the card: the horizontal taps stacked into channels,
# then a (kh x 1) conv (conv_route "sm90_stacked"); (x shape, kernel,
# stride, dilation): the ImageNet stem's 7x7/2 and the CIFAR stem's 3x3/1
# at 3 channels, 1, 5 and 7 channels, dilation (2, 2), stride (3, 2)
STACK_CASES = {
    "imagenet-7x7-s2": ((2, 16, 16, 3), (7, 7, 3, 8), (2, 2), (1, 1)),
    "cifar-3x3": ((2, 10, 10, 3), (3, 3, 3, 16), (1, 1), (1, 1)),
    "ci1": ((2, 9, 10, 1), (3, 3, 1, 8), (1, 1), (1, 1)),
    "ci5": ((1, 9, 11, 5), (2, 3, 5, 8), (1, 1), (1, 1)),
    "ci7": ((1, 11, 12, 7), (3, 3, 7, 8), (1, 1), (1, 1)),
    "dil2": ((1, 14, 13, 3), (3, 3, 3, 8), (1, 1), (2, 2)),
    "s3x2": ((1, 16, 15, 3), (3, 3, 3, 8), (3, 2), (1, 1)),
}


def _stacked(x, w, stride, dil):
    """The stacked route's function in plain torch: the (ceil(kh / rows) x
    1) conv of stack_taps_reference's xs by stack_weights(w), rows, h2 and
    cs from stack_plan (the extra channels zero on both sides; h2 rows of
    xs give exactly the conv's Ho output rows)."""
    kh, kw, ci, co = w.shape
    rows, h2, cs = TC.stack_plan(x.shape[1], ci, (kh, kw), stride, dil)
    assert rows == (stride[0] if dil[0] == 1 and kh > 1 else 1)
    xs = TC.stack_taps_reference(x, kw, stride[1], dil[1], cs, rows, h2)
    assert xs.shape[-1] == cs and not xs[..., rows * kw * ci:].any()
    return TC.conv_nd_reference(xs, TC.stack_weights(w, rows, cs),
                                (stride[0] // rows, 1), (dil[0], 1))


@pytest.mark.parametrize("name,dtype", [
    *((n, "f32") for n in STACK_CASES),
    *((n, "bf16") for n, c in STACK_CASES.items() if c[2] == (1, 1))])
def test_stacked_conv2d_matches_jax_kernel(name, dtype):
    """The stacked decomposition against JAX's K12 in interpret mode: f32
    within TOL; bf16 within one bf16 ulp of the largest entry (both round
    one f32 sum), at stride 1 only: JAX splits a strided conv into phases,
    each rounded to bf16 and summed in bf16."""
    xs, ws, stride, dil = STACK_CASES[name]
    x, w = _randn(*xs), _randn(*ws, seed=1, scale=0.3)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(JC.conv2d_direct_nhwc(
        jnp.asarray(x, jd), jnp.asarray(w, jd), dil, stride,
        interpret=True), np.float32)
    out = _stacked(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                   stride, dil)
    assert out.dtype == td
    if td == torch.float32:
        _close(out, ref)
    else:
        top = np.abs(ref).max()
        assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** (
            np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("kw,sw,dw,ci,rows", [
    (7, 2, 1, 3, 2), (7, 2, 1, 3, 1), (3, 1, 1, 3, 1), (3, 2, 2, 1, 3),
    (2, 3, 1, 7, 1)])
def test_stack_taps_reference_gathers_the_taps(kw, sw, dw, ci, rows):
    """xs[n, r, ow, (i kw + tw) Ci + c] = x[n, r rows + i, ow sw + tw dw, c],
    zero past row H and past rows kw Ci, against a loop over every
    entry."""
    x = torch.from_numpy(_randn(2, 5, 17, ci))
    cs = -(-rows * kw * ci // 8) * 8
    xs = TC.stack_taps_reference(x, kw, sw, dw, cs, rows).numpy()
    wo, h2 = (17 - dw * (kw - 1) - 1) // sw + 1, -(-5 // rows)
    want = np.zeros((2, h2, wo, cs), np.float32)
    for r in range(h2):
        for i in range(rows):
            if r * rows + i >= 5:
                continue
            for ow in range(wo):
                for tw in range(kw):
                    j = (i * kw + tw) * ci
                    want[:, r, ow, j:j + ci] = \
                        x.numpy()[:, r * rows + i, ow * sw + tw * dw]
    assert np.array_equal(xs, want)
    # the wrapper on a CPU tensor takes it and counts nothing
    before = TC.stack_taps_nhwc.launches
    assert np.array_equal(TC.stack_taps_nhwc(x, kw, sw, dw, cs, rows).numpy(),
                          want)
    assert TC.stack_taps_nhwc.launches == before


def test_stack_weights_regroup_the_taps():
    """stack_weights' tap row q, channel (i kw + tw) Ci + c is w[q rows + i,
    tw, c], zero past row kh and past channel rows kw Ci."""
    w = torch.from_numpy(_randn(7, 7, 3, 8))
    ws = TC.stack_weights(w, 2, 48)
    assert tuple(ws.shape) == (4, 1, 48, 8)
    for q in range(4):
        for i in range(2):
            for tw in range(7):
                j = (i * 7 + tw) * 3
                want = w[q * 2 + i, tw] if q * 2 + i < 7 else 0 * w[0, 0]
                assert torch.equal(ws[q, 0, j:j + 3], want)
    assert not ws[:, :, 42:].any()


def test_plain_conv2d_bf16_matches_jax_kernel():
    """bf16 at stride 1: both round one f32 sum of exact products, so one
    bf16 ulp of the largest entry bounds them."""
    x, w = _randn(2, 10, 9, 8), _randn(3, 3, 8, 16, seed=1, scale=0.3)
    ref = np.asarray(JC.conv2d_direct_nhwc(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        interpret=True), np.float32)
    out = TC.conv2d_direct_nhwc(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w).bfloat16())
    assert out.dtype == torch.bfloat16
    top = np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** (
        np.floor(np.log2(top)) - 7)


# (x NHWC, g NHWC, kh, kw, dilation)
K13_CASES = {
    "k3": ((3, 10, 10, 12), (3, 8, 8, 16), 3, 3, (1, 1)),
    "k3-ragged": ((2, 13, 11, 5), (2, 11, 9, 7), 3, 3, (1, 1)),
    "k1": ((2, 7, 6, 8), (2, 7, 6, 4), 1, 1, (1, 1)),
    "k3x2-dil2": ((2, 12, 11, 8), (2, 8, 9, 16), 3, 2, (2, 2)),
}


@pytest.mark.parametrize("name", list(K13_CASES))
def test_plain_conv_dw_matches_jax_kernel(name):
    xs, gs, kh, kw, dil = K13_CASES[name]
    x, g = _randn(*xs), _randn(*gs, seed=1)
    ref = JC.conv2d_dw_nhwc(jnp.asarray(x), jnp.asarray(g), kh, kw, dil,
                            interpret=True)
    out = TC.conv2d_dw_nhwc(torch.from_numpy(x), torch.from_numpy(g), kh, kw,
                            dil)
    assert out.dtype == torch.float32 and tuple(out.shape) == (kh, kw, xs[3],
                                                               gs[3])
    _close(out, ref)


@pytest.mark.parametrize("d,s,ncw", [(1, 1, False), (2, 1, False),
                                     (1, 2, False), (1, 3, False),
                                     (1, 1, True), (1, 2, True)])
def test_plain_conv1d_matches_jax_kernel(d, s, ncw):
    x, w = _randn(2, 33, 8), _randn(3, 8, 16, seed=1, scale=0.3)
    ref = JC.conv1d_direct_nwc(jnp.asarray(x), jnp.asarray(w), d, s,
                               out_ncw=ncw, interpret=True)
    out = TC.conv1d_direct_nwc(torch.from_numpy(x), torch.from_numpy(w), d, s,
                               out_ncw=ncw)
    _close(out.contiguous(), ref)


@pytest.mark.parametrize("k,dil,xs", [
    ((3, 3, 3), (1, 1, 1), (2, 6, 7, 9, 8)),
    ((2, 3, 2), (1, 1, 1), (1, 5, 6, 7, 4)),
    ((2, 2, 2), (2, 2, 2), (2, 6, 7, 9, 8)),
    ((3, 1, 2), (1, 2, 3), (1, 7, 5, 11, 3))])
def test_plain_conv3d_matches_jax_kernel(k, dil, xs):
    x, w = _randn(*xs), _randn(*k, xs[-1], 12, seed=1, scale=0.3)
    ref = JC.conv3d_direct_ndhwc(jnp.asarray(x), jnp.asarray(w), dil,
                                 interpret=True)
    out = TC.conv3d_direct_ndhwc(torch.from_numpy(x), torch.from_numpy(w),
                                 dil)
    _close(out, ref)


def test_nchw_facade_and_composed_gradients_match_jax():
    """conv2d_direct (NCHW), conv2d_direct_input_grad (K12 on the padded
    gradient) and conv2d_direct_kernel_grad (K13)."""
    x, w = _randn(2, 6, 11, 10), _randn(8, 6, 3, 3, seed=1, scale=0.3)
    g = _randn(2, 8, 9, 8, seed=2)
    jx, jw, jg = map(jnp.asarray, (x, w, g))
    tx, tw, tg = map(torch.from_numpy, (x, w, g))
    _close(TC.conv2d_direct(tx, tw), JC.conv2d_direct(jx, jw, interpret=True))
    _close(TC.conv2d_direct_input_grad(tg, tw),
           JC.conv2d_direct_input_grad(jg, jw, interpret=True))
    _close(TC.conv2d_direct_kernel_grad(tx, tg),
           JC.conv2d_direct_kernel_grad(jx, jg, interpret=True))
    # dilated input gradient
    g2 = _randn(2, 8, 7, 6, seed=3)
    _close(TC.conv2d_direct_input_grad(torch.from_numpy(g2), tw, (2, 2)),
           JC.conv2d_direct_input_grad(jnp.asarray(g2), jw, (2, 2),
                                       interpret=True))


@pytest.mark.parametrize("stride,pad", [((1, 1), "SAME"), ((1, 1), "VALID"),
                                        ((2, 2), "SAME"), ((2, 2), "VALID"),
                                        ((2, 1), "SAME")])
def test_conv2d_pallas_nhwc_and_gradients_match_jax(stride, pad):
    """The forward and torch.autograd's dx, dw against `jax.vjp` of JAX's
    custom-VJP entry (interpret mode) on one numpy cotangent. Stride 1
    runs K12/K13 compositions on both sides; a strided backward is the
    library's transposed conv here and XLA's there."""
    x, w = _randn(2, 11, 10, 8), _randn(3, 3, 8, 16, seed=1, scale=0.3)
    jout, vjp = jax.vjp(
        lambda a, b: JC.conv2d_pallas_nhwc(a, b, stride, pad, True),
        jnp.asarray(x), jnp.asarray(w))
    g = _randn(*jout.shape, seed=2)
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = TC.conv2d_pallas_nhwc(tx, tw, stride, pad)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    _close(out, jout)
    _close(dx, jdx, GRAD_TOL)
    _close(dw, jdw, GRAD_TOL)


def test_same_pads_match_jax():
    """Smaller half first: 7x7/2 on 224 pads (2, 3), 3x3/2 on 56 (0, 1)."""
    for size in range(1, 40):
        for k in (1, 2, 3, 7):
            for s in (1, 2, 3):
                assert TC._same_pads(size, k, s) == JC._same_pads(size, k, s)
    assert TC._same_pads(224, 7, 2) == (2, 3)
    assert TC._same_pads(56, 3, 2) == (0, 1)
    assert TC._same_pads(112, 3, 2) == (0, 1)


ROUTES = [  # (nd, stride, dilation, groups, kwargs)
    (2, (1, 1), (1, 1), 1, dict(batch=4, ksize=3, sample_bytes=1e6,
                                weight_bytes=1e6)),
    (2, (1, 1), (1, 1), 1, dict(batch=8, ksize=3, sample_bytes=1e6,
                                weight_bytes=1e6)),
    (2, (2, 2), (1, 1), 1, dict(batch=2, ksize=3, sample_bytes=1e6,
                                weight_bytes=1e6)),
    (2, (1, 1), (1, 1), 2, dict(batch=2, ksize=3, sample_bytes=1e6,
                                weight_bytes=1e6)),
    (2, (1, 1), (1, 1), 1, dict(batch=2, ksize=3, sample_bytes=5e6,
                                weight_bytes=1e6)),
    (1, (1,), (1,), 1, dict(batch=1, ksize=3, sample_bytes=1e6,
                            weight_bytes=1e6)),
    (1, (1,), (2,), 1, dict(batch=1, ksize=3, sample_bytes=1e6,
                            weight_bytes=1e6)),
    (3, (1, 1, 1), (1, 1, 1), 1, dict(batch=1)),
    (2, (1, 1), (1, 1), 1, {}),
]


@pytest.mark.parametrize("route", ROUTES, ids=range(len(ROUTES)))
def test_route_table_is_jaxs(route, monkeypatch):
    """On the card, the H100 table: JAX's answer on a TPU for rank 1 (K14
    beat F.conv1d at batch 1-4) and the library for rank 2 (K12 lost to
    F.conv2d at every ResNet-18 stage shape at batch 1-4). Off the card,
    JAX's answer off a TPU ("xla"). "force" picks the kernels."""
    import importlib

    nd, stride, dil, groups, kw = route
    jcfg = importlib.import_module("neuronika_tpu.config")
    monkeypatch.setattr(jcfg, "on_tpu", lambda: False)
    off = JC.route_conv2d(nd, stride, dil, groups, **kw)
    monkeypatch.setattr(jcfg, "on_tpu", lambda: True)
    want = "xla" if nd == 2 else JC.route_conv2d(nd, stride, dil, groups,
                                                 **kw)
    assert TC.route_conv2d(nd, stride, dil, groups, on_card=True, **kw) == want
    assert TC.route_conv2d(nd, stride, dil, groups, on_card=False,
                           **kw) == off == "xla"
    old = config.conv_route
    try:
        config.conv_route = "force"
        assert TC.route_conv2d(nd, stride, dil, groups, **kw) == "pallas"
    finally:
        config.conv_route = old


@pytest.mark.parametrize("call,match", [
    (lambda: TC.conv2d_direct_nhwc(torch.zeros(1, 5, 5, 4),
                                   torch.zeros(3, 3, 3, 8)), "channel"),
    (lambda: TC.conv2d_direct_nhwc(torch.zeros(1, 5, 5, 4),
                                   torch.zeros(3, 3, 2, 6), groups=4),
     "channel"),
    (lambda: TC.conv2d_direct_nhwc(torch.zeros(1, 2, 5, 4),
                                   torch.zeros(3, 3, 4, 8)), "larger"),
    (lambda: TC.conv2d_direct_nhwc(torch.zeros(5, 5, 4),
                                   torch.zeros(3, 3, 4, 8)), "rank-2"),
    (lambda: TC.conv1d_direct_nwc(torch.zeros(1, 9, 4),
                                  torch.zeros(3, 2, 8)), "channel"),
    (lambda: TC.conv3d_direct_ndhwc(torch.zeros(1, 4, 4, 4, 4),
                                    torch.zeros(2, 2, 2, 2, 8)), "channel"),
    (lambda: TC.conv2d_dw_nhwc(torch.zeros(1, 5, 5, 4),
                               torch.zeros(1, 4, 3, 8), 3, 3), "no output"),
    (lambda: TC.conv2d_pallas_nhwc(torch.zeros(1, 5, 5, 4),
                                   torch.zeros(3, 3, 4, 8), 1, "FULL"),
     "padding"),
    (lambda: TC.stack_taps_nhwc(torch.zeros(1, 5, 5, 3), 3, 1, 1, 16, 2),
     "channels"),
    (lambda: TC.stack_taps_nhwc(torch.zeros(1, 5, 5, 3), 3, 1, 3, 16),
     "row"),
], ids=["ci", "groups", "small", "rank", "1d-ci", "3d-ci", "dw-shape",
        "padding", "stack-cs", "stack-row"])
def test_wrappers_refuse_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _resnet18_convs():
    """(name, Ci, Co, k, stride) of every conv of ResNet-18's forward
    (ImageNet stem), in `conv_strides` order."""
    cfg = TR.ResNetConfig(stem="imagenet")
    convs, c_in = [("stem", 3, cfg.width, 7, 2)], cfg.width
    for si, n_blocks in enumerate(cfg.stages):
        c_out = cfg.width * 2 ** si
        for bi in range(n_blocks):
            s = 2 if (bi == 0 and si > 0) else 1
            convs += [(f"s{si}b{bi}w1", c_in, c_out, 3, s),
                      (f"s{si}b{bi}w2", c_out, c_out, 3, 1)]
            if s != 1 or c_in != c_out:
                convs.append((f"s{si}b{bi}proj", c_in, c_out, 1, s))
            c_in = c_out
    assert [c[-1] for c in convs] == TR.conv_strides(cfg)
    return convs


@pytest.mark.parametrize("conv", _resnet18_convs(), ids=lambda c: c[0])
def test_conv_route_of_resnet18(conv):
    """bf16: every conv on the Hopper kernel, the stem (Ci = 3) after
    stacking its horizontal taps into channels, and every stride-1 conv's
    dx (K12 on the flipped, io-swapped kernel) and dw (K13); f32 on the
    FFMA kernel."""
    _, ci, co, k, s = conv
    bf = torch.bfloat16
    want = "sm90_stacked" if ci == 3 else "sm90"
    assert TC.conv_route("fwd", bf, ci, co, 1, (s, s), (1, 1),
                         (k, k)) == want
    assert TC.conv_route("fwd", torch.float32, ci, co, 1, (s, s), (1, 1),
                         (k, k)) == "conv_ffma"
    if s == 1:
        assert TC.conv_route("fwd", bf, co, ci, 1, (1, 1), (1, 1),
                             (k, k)) == "sm90"
        assert TC.conv_route("dw", bf, ci, co, ksize=(k, k)) == "sm90"


@pytest.mark.parametrize("args,want", [
    (("fwd", torch.bfloat16, 64, 64, 2), "conv_mma"),           # groups
    (("fwd", torch.bfloat16, 12, 64), "conv_mma"),              # Ci % 8
    (("fwd", torch.bfloat16, 64, 20), "conv_mma"),              # Co % 8
    (("fwd", torch.bfloat16, 200, 72), "sm90"),                 # tails
    (("dw", torch.bfloat16, 200, 72), "sm90"),
    (("dw", torch.bfloat16, 3, 64), "conv_mma"),
    (("dw", torch.float32, 64, 64), "conv_ffma"),
    (("fwd", torch.bfloat16, 64, 64, 1, (1, 1), (2, 2), (3, 3)), "sm90"),
    (("fwd", torch.bfloat16, 64, 64, 1, (3, 2)), "sm90"),
    (("fwd", torch.bfloat16, 64, 64, 1, (9, 1)), "conv_mma"),   # stride > 8
    (("fwd", torch.bfloat16, 64, 64, 1, (1, 1), (65, 1), (3, 1)),
     "conv_mma"),                                               # corner
    (("dw", torch.bfloat16, 64, 64, 1, (2, 2)), "conv_mma"),
    (("fwd", torch.float16, 64, 64), "conv_mma"),
    # Ci < 8: the Hopper K12 on the stacked taps ("fwd" of a 2-d conv only)
    (("fwd", torch.bfloat16, 3, 64, 1, (2, 2), (1, 1), (7, 7)),
     "sm90_stacked"),                                           # ImageNet
    (("fwd", torch.bfloat16, 3, 32, 1, (1, 1), (1, 1), (3, 3)),
     "sm90_stacked"),                                           # CIFAR
    *((("fwd", torch.bfloat16, ci, 16, 1, (1, 1), (2, 2), (3, 3)),
       "sm90_stacked") for ci in (1, 2, 4, 5, 6, 7)),
    (("fwd", torch.bfloat16, 3, 16, 1, (3, 2)), "sm90_stacked"),
    (("fwd", torch.bfloat16, 3, 20), "conv_mma"),               # Co % 8
    (("fwd", torch.bfloat16, 4, 16, 2), "conv_mma"),            # groups
    (("fwd", torch.float16, 3, 64), "conv_mma"),
    (("fwd", torch.float32, 3, 64), "conv_ffma"),
    (("fwd", torch.bfloat16, 3, 64, 1, (9, 1)), "conv_mma"),    # stride > 8
    (("fwd", torch.bfloat16, 3, 64, 1, (1, 1), (65, 1), (3, 1)),
     "conv_mma"),                                               # corner
    (("dw", torch.bfloat16, 3, 32, 1, (1, 1), (1, 1), (3, 3)), "conv_mma"),
    (("dw", torch.bfloat16, 1, 64), "conv_mma"),
], ids=["groups", "ci12", "co20", "tails", "dw-tails", "dw-ci3", "dw-f32",
        "dil2", "s3x2", "s9", "dil65", "dw-s2", "f16", "stack-imagenet",
        "stack-cifar", "stack-ci1", "stack-ci2", "stack-ci4", "stack-ci5",
        "stack-ci6", "stack-ci7", "stack-s3x2", "ci3-co20", "ci4-g2",
        "ci3-f16", "ci3-f32", "ci3-s9", "ci3-dil65", "dw-cifar-stem",
        "dw-ci1"])
def test_conv_route_by_shape(args, want):
    """The route of a K12 or K13 call; Ci 1-7 take the stacked Hopper K12,
    except a grouped conv, Co not a multiple of 8, f16, or past the stride
    and corner limits, and every "dw" (K13 has no stacked form)."""
    assert TC.conv_route(*args) == want


@pytest.mark.parametrize("args,want", [
    ((torch.bfloat16, 128, 128), "sm90"),                       # table
    ((torch.bfloat16, 16, 24, 1, (2, 1, 2), (3, 2, 3)), "sm90"),
    ((torch.bfloat16, 8, 8, 1, (16, 1, 1), (2, 1, 1)), "sm90"),  # corner
    ((torch.bfloat16, 8, 8, 1, (1, 1, 1), (17, 1, 1)), "sm90"),
    ((torch.float32, 128, 128), "conv_ffma"),
    ((torch.bfloat16, 3, 64), "conv_mma"),                      # Ci = 3
    ((torch.bfloat16, 64, 20), "conv_mma"),                     # Co % 8
    ((torch.bfloat16, 64, 64, 2), "conv_mma"),                  # groups
    ((torch.bfloat16, 8, 8, 1, (17, 1, 1), (2, 1, 1)), "conv_mma"),
    ((torch.bfloat16, 8, 8, 1, (1, 3, 1), (1, 7, 1)), "conv_mma"),
    ((torch.bfloat16, 8, 8, 1, (1, 1, 9), (1, 1, 3)), "conv_mma"),
], ids=["table", "dil2", "d16", "k17", "f32", "ci3", "co20", "groups",
        "d17", "d3k7", "d9k3"])
def test_conv_route_rank3(args, want):
    """K15: bf16, groups 1, channels multiples of 8 and (k - 1) d <= 16 on
    every axis (the rank-5 im2col corner range) on the Hopper kernel."""
    dtype, ci, co, *rest = args
    groups, dil, k = rest + [1, (1, 1, 1), (3, 3, 3)][len(rest):]
    assert TC.conv_route("fwd", dtype, ci, co, groups, (1, 1, 1), dil,
                         k) == want


@pytest.mark.parametrize("args,want", [
    ((torch.bfloat16, 256, 256), "sm90"),                       # table
    ((torch.bfloat16, 256, 256, 1, (16384,)), "sm90"),          # corner
    ((torch.bfloat16, 8, 8, 1, (32768,), (2,)), "sm90"),
    ((torch.bfloat16, 72, 136, 1, (2,)), "sm90"),               # tails
    ((torch.bfloat16, 24, 40, 1, (1,), (1,)), "sm90"),          # k1
    ((torch.float32, 256, 256), "conv_ffma"),
    ((torch.bfloat16, 4, 12), "conv_mma"),                      # phase 14's
    ((torch.bfloat16, 64, 64, 2), "conv_mma"),                  # groups
    ((torch.bfloat16, 256, 256, 1, (16385,)), "conv_mma"),      # past it
    ((torch.bfloat16, 8, 8, 1, (32769,), (2,)), "conv_mma"),
    ((torch.bfloat16, 64, 64, 1, (1,), (3,), (2,)), "conv_mma"),  # stride
], ids=["table", "d16384", "k2-d32768", "tails", "k1", "f32", "ci4-co12",
        "groups", "d16385", "k2-d32769", "s2"])
def test_conv_route_rank1(args, want):
    """K14: bf16, groups 1, stride 1, channels multiples of 8 and (k - 1) d
    <= 32768 (the rank-3 im2col corner range) on the Hopper kernel."""
    dtype, ci, co, *rest = args
    groups, dil, k, stride = rest + [1, (1,), (3,), (1,)][len(rest):]
    assert TC.conv_route("fwd", dtype, ci, co, groups, stride, dil,
                         k) == want


@pytest.mark.parametrize("args", [
    ("dw", torch.bfloat16, 8, 8, 1, (1, 1, 1), (1, 1, 1), (3, 3, 3)),
    ("fwd", torch.bfloat16, 8, 8, 1, (1, 1), (1, 1), (3, 3, 3)),
    ("dw", torch.bfloat16, 8, 8, 1, (1,), (1,), (3,)),
], ids=["dw-3d", "mismatch", "rank1"])
def test_conv_route_refuses_what_no_kernel_takes(args):
    with pytest.raises(ValueError):
        TC.conv_route(*args)


@pytest.mark.parametrize("taps,ci,co,pixels", [
    (9, 64, 64, 64 * 56 * 56), (9, 128, 128, 64 * 28 * 28),
    (9, 256, 256, 64 * 14 * 14), (9, 512, 512, 64 * 7 * 7),
    (9, 256, 256, 64 * 56 * 56), (1, 64, 128, 4 * 28 * 28),
    (9, 8, 16, 2 * 9 * 8), (6, 200, 72, 3 * 11 * 13), (9, 16, 24, 1),
    (1, 8, 8, 100_003)])
def test_dw_plan_covers_every_pixel_once(taps, ci, co, pixels):
    """The Hopper K13's splits: runs of whole 64-pixel k steps, every one
    non-empty, that cover the pixels once and in order; tiles x splits at
    most one wave of 132 SMs, unless the tiles alone exceed it."""
    splits, chunk = TC._dw_plan_sm90(taps, ci, co, pixels)
    assert chunk % 64 == 0 and splits >= 1
    runs = [(s * chunk, min(pixels, (s + 1) * chunk)) for s in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == pixels
    assert all(a < b for a, b in runs)
    assert all(b == a2 for (_, b), (a2, _) in zip(runs, runs[1:]))
    tiles = -(-(taps * -(-ci // 64)) // 2) * -(-co // (
        64 if co <= 64 else 128 if co <= 128 else 256))
    assert tiles * splits <= 132 or splits == 1
    assert TC.dw_plan(3, 3, ci, co, pixels, torch.bfloat16)[0] == "sm90"


def test_counters_do_not_move_on_the_cpu():
    before = [k.launches for k in TC.KERNELS]
    x = torch.from_numpy(_randn(1, 8, 8, 4))
    TC.conv2d_direct_nhwc(x, torch.from_numpy(_randn(3, 3, 4, 4)))
    TC.conv2d_dw_nhwc(x, torch.from_numpy(_randn(1, 6, 6, 4)), 3, 3)
    TC.conv1d_direct_nwc(x[0], torch.from_numpy(_randn(3, 4, 4)))
    TC.conv3d_direct_ndhwc(x[None], torch.from_numpy(_randn(1, 3, 3, 4, 4)))
    assert [k.launches for k in TC.KERNELS] == before
    # a shape conv_route sends to the Hopper K14 on the card
    TC.conv1d_direct_nwc(torch.from_numpy(_randn(1, 64, 8)).bfloat16(),
                         torch.from_numpy(_randn(3, 8, 8)).bfloat16())
    # and one it sends to the stacked K12 (the CIFAR stem)
    TC.conv2d_direct_nhwc(torch.from_numpy(_randn(1, 8, 8, 3)).bfloat16(),
                          torch.from_numpy(_randn(3, 3, 3, 8)).bfloat16())
    assert [k.launches for k in TC.KERNELS] == before
    assert TC.conv2d_direct_nhwc.sm90_launches == 0
    assert TC.conv2d_dw_nhwc.sm90_launches == 0
    assert TC.conv1d_direct_nwc.sm90_launches == 0
    assert TC.conv3d_direct_ndhwc.sm90_launches == 0


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_close(out, ref, dtype):
    """f32: 1e-5 of the largest entry (FFMA in another order); bf16: the
    norm rule of chip_smoke.py, ||out - ref|| <= 1e-2 ||ref|| + 2^-15
    sqrt(numel) (one rounding of an f32 sum on both sides)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    d = (out.double() - ref.double())
    if dtype == torch.float32:
        top = float(ref.abs().max())
        assert float(d.abs().max()) <= 1e-5 * max(1.0, top)
    else:
        assert float(d.norm()) <= 1e-2 * float(ref.double().norm()) \
            + 2 ** -15 * d.numel() ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(K12_CASES))
def test_conv2d_kernel_matches_plain_on_gpu(cuda, name, dtype):
    xs, ws, stride, dil, groups = K12_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, dtype)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=0.3)).to(cuda, dtype)
    before = TC.conv2d_direct_nhwc.launches
    out = TC.conv2d_direct_nhwc(x, w, dil, stride, groups=groups)
    ref = TC.conv_nd_reference(x, w, stride, dil, groups)
    torch.cuda.synchronize()
    assert TC.conv2d_direct_nhwc.launches == before + 1
    _card_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(K13_CASES) + ["large"])
def test_conv_dw_kernel_matches_plain_on_gpu(cuda, name, dtype):
    """"large" splits the pixel reduction over many CTAs."""
    xs, gs, kh, kw, dil = K13_CASES.get(
        name, ((8, 30, 30, 16), (8, 28, 28, 24), 3, 3, (1, 1)))
    x = torch.from_numpy(_randn(*xs)).to(cuda, dtype)
    g = torch.from_numpy(_randn(*gs, seed=1)).to(cuda, dtype)
    before = TC.conv2d_dw_nhwc.launches
    out = TC.conv2d_dw_nhwc(x, g, kh, kw, dil)
    ref = TC.conv_dw_reference(x, g, (kh, kw), dil)
    torch.cuda.synchronize()
    assert TC.conv2d_dw_nhwc.launches == before + 1
    assert out.dtype == torch.float32
    top = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * max(1.0, top) * (
        1 if dtype == torch.float32 else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv1d_and_conv3d_kernels_match_plain_on_gpu(cuda, dtype):
    x = torch.from_numpy(_randn(2, 33, 8)).to(cuda, dtype)
    w = torch.from_numpy(_randn(3, 8, 16, seed=1)).to(cuda, dtype)
    before = TC.conv1d_direct_nwc.launches, TC.conv2d_direct_nhwc.launches
    for d, s in ((1, 1), (2, 1), (1, 2)):
        _card_close(TC.conv1d_direct_nwc(x, w, d, s),
                    TC.conv_nd_reference(x, w, (s,), (d,)), dtype)
    # stride 1 on K14 twice, stride 2 on K12 once
    assert (TC.conv1d_direct_nwc.launches - before[0],
            TC.conv2d_direct_nhwc.launches - before[1]) == (2, 1)
    x = torch.from_numpy(_randn(2, 6, 7, 9, 8)).to(cuda, dtype)
    w = torch.from_numpy(_randn(2, 2, 2, 8, 16, seed=1)).to(cuda, dtype)
    before = TC.conv3d_direct_ndhwc.launches
    _card_close(TC.conv3d_direct_ndhwc(x, w, (2, 1, 2)),
                TC.conv_nd_reference(x, w, (1, 1, 1), (2, 1, 2)), dtype)
    assert TC.conv3d_direct_ndhwc.launches == before + 1


@pytest.mark.cuda
def test_conv2d_pallas_nhwc_on_gpu_matches_the_cpu(cuda):
    x, w = _randn(2, 11, 10, 8), _randn(3, 3, 8, 16, seed=1, scale=0.3)
    g = _randn(2, 11, 10, 16, seed=2)
    res = []
    for dev in ("cpu", cuda):
        tx = torch.from_numpy(x).to(dev).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        out = TC.conv2d_pallas_nhwc(tx, tw)
        res.append([t.detach().cpu() for t in (out, *torch.autograd.grad(
            out, (tx, tw), torch.from_numpy(g).to(dev)))])
    for a, b in zip(*res):
        _close(a, b.numpy(), GRAD_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_run(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        TC.conv2d_direct_nhwc(x.half(), torch.zeros(3, 3, 4, 4, device=cuda,
                                                    dtype=torch.half))
    with pytest.raises(ValueError, match="operands on"):
        TC.conv2d_direct_nhwc(x, torch.zeros(3, 3, 4, 4))


# the Hopper K12 (bf16): (x shape, w shape, stride, dilation); ResNet-18's
# four stride-1 stage convs at batch 2 (padded input), stage 1's dx (the
# padded gradient), dilation 2, M not a multiple of 128 with tiles that
# span samples (5 x 5 outputs), Ci and Co tails, non-square taps with
# dilation (2, 1), ResNet's strided 3x3 and 1x1 convs and stride (3, 2)
SM90_K12_CASES = {
    "stage1": ((2, 58, 58, 64), (3, 3, 64, 64), (1, 1), (1, 1)),
    "stage2": ((2, 30, 30, 128), (3, 3, 128, 128), (1, 1), (1, 1)),
    "stage3": ((2, 16, 16, 256), (3, 3, 256, 256), (1, 1), (1, 1)),
    "stage4": ((2, 9, 9, 512), (3, 3, 512, 512), (1, 1), (1, 1)),
    "stage1-dx": ((2, 60, 60, 64), (3, 3, 64, 64), (1, 1), (1, 1)),
    "dil2": ((2, 14, 15, 64), (3, 3, 64, 128), (1, 1), (2, 2)),
    "samples": ((7, 7, 7, 32), (3, 3, 32, 64), (1, 1), (1, 1)),
    "tails": ((3, 11, 13, 200), (3, 3, 200, 200), (1, 1), (1, 1)),
    "k3x2-dil2x1": ((2, 13, 11, 24), (3, 2, 24, 136), (1, 1), (2, 1)),
    "s2": ((2, 57, 57, 64), (3, 3, 64, 128), (2, 2), (1, 1)),
    "1x1-s2": ((2, 56, 56, 64), (1, 1, 64, 128), (2, 2), (1, 1)),
    "s3x2": ((2, 16, 15, 16), (3, 3, 16, 8), (3, 2), (1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SM90_K12_CASES))
def test_sm90_conv2d_matches_plain_on_gpu(cuda, name):
    xs, ws, stride, dil = SM90_K12_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=(ws[0] * ws[1] * ws[2])
                                ** -0.5)).to(cuda, torch.bfloat16)
    assert TC.conv_route("fwd", torch.bfloat16, xs[-1], ws[-1], 1, stride,
                         dil, ws[:2]) == "sm90"
    before = (TC.conv2d_direct_nhwc.launches,
              TC.conv2d_direct_nhwc.sm90_launches)
    out = TC.conv2d_direct_nhwc(x, w, dil, stride)
    ref = TC.conv_nd_reference(x, w, stride, dil)
    torch.cuda.synchronize()
    assert (TC.conv2d_direct_nhwc.launches,
            TC.conv2d_direct_nhwc.sm90_launches) == (before[0] + 1,
                                                     before[1] + 1)
    _card_close(out, ref, torch.bfloat16)
    # one bf16 ulp of the largest entry, as both round one f32 sum
    top = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** (
        np.floor(np.log2(top)) - 7)


# the Hopper K13: (x shape, g shape, kh, kw, dilation)
SM90_K13_CASES = {
    "stage1": ((2, 58, 58, 64), (2, 56, 56, 64), 3, 3, (1, 1)),
    "stage2": ((2, 30, 30, 128), (2, 28, 28, 128), 3, 3, (1, 1)),
    "stage3": ((2, 16, 16, 256), (2, 14, 14, 256), 3, 3, (1, 1)),
    "stage4": ((2, 9, 9, 512), (2, 7, 7, 512), 3, 3, (1, 1)),
    "dil2": ((2, 14, 15, 64), (2, 10, 11, 128), 3, 3, (2, 2)),
    "samples": ((7, 7, 7, 32), (7, 5, 5, 64), 3, 3, (1, 1)),
    "tails": ((3, 11, 13, 200), (3, 9, 11, 72), 3, 3, (1, 1)),
    "k3x2-dil2x1": ((2, 13, 11, 24), (2, 9, 10, 136), 3, 2, (2, 1)),
    "1x1": ((4, 28, 28, 64), (4, 28, 28, 128), 1, 1, (1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SM90_K13_CASES))
def test_sm90_conv_dw_matches_plain_on_gpu(cuda, name):
    """f32 out of bf16 operands: the tensor cores' f32 sums against the
    plain f32 product, within 4e-5 of the largest entry (phase 3's K13
    bound) and in norm within 1e-5 of ||ref||."""
    xs, gs, kh, kw, dil = SM90_K13_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(_randn(*gs, seed=1)).to(cuda, torch.bfloat16)
    assert TC.dw_plan(kh, kw, xs[-1], gs[-1], gs[0] * gs[1] * gs[2],
                      torch.bfloat16, dil)[0] == "sm90"
    before = TC.conv2d_dw_nhwc.launches, TC.conv2d_dw_nhwc.sm90_launches
    out = TC.conv2d_dw_nhwc(x, g, kh, kw, dil)
    ref = TC.conv_dw_reference(x, g, (kh, kw), dil)
    torch.cuda.synchronize()
    assert (TC.conv2d_dw_nhwc.launches,
            TC.conv2d_dw_nhwc.sm90_launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.float32
    d = (out.double() - ref.double())
    assert float(d.abs().max()) <= 4e-5 * max(1.0, float(ref.abs().max()))
    assert float(d.norm()) <= 1e-5 * float(ref.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("xs,gs", [
    ((16, 58, 58, 64), (16, 56, 56, 64)),
    ((16, 9, 9, 512), (16, 7, 7, 512))], ids=["stage1", "stage4"])
def test_sm90_conv_dw_gives_the_same_bits_twice(cuda, xs, gs):
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(_randn(*gs, seed=1)).to(cuda, torch.bfloat16)
    a = TC.conv2d_dw_nhwc(x, g, 3, 3)
    b = TC.conv2d_dw_nhwc(x, g, 3, 3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the Hopper K15 (bf16): (x shape, w shape, dilation); dilation on some
# axes, a ragged box on every axis, Ci and Co tails, (k - 1) d = 16 (the
# rank-5 corner range) and the table's widths at batch 2
SM90_K15_CASES = {
    "k2-dil2x1x2": ((2, 6, 7, 9, 8), (2, 2, 2, 8, 16), (2, 1, 2)),
    "ragged": ((2, 9, 10, 11, 16), (3, 2, 3, 16, 24), (2, 1, 2)),
    "k3-c64": ((3, 5, 6, 7, 64), (3, 3, 3, 64, 64), (1, 1, 1)),
    "tails": ((2, 12, 12, 12, 72), (3, 3, 3, 72, 136), (2, 2, 1)),
    "corner16": ((1, 20, 6, 6, 8), (3, 1, 1, 8, 8), (8, 1, 1)),
    "table-B2": ((2, 16, 16, 16, 128), (3, 3, 3, 128, 128), (1, 1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SM90_K15_CASES))
def test_sm90_conv3d_matches_plain_on_gpu(cuda, name):
    """In norm as _card_close, and each entry within one bf16 ulp of the
    largest: both round one f32 sum."""
    xs, ws, dil = SM90_K15_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=(
        ws[0] * ws[1] * ws[2] * ws[3]) ** -0.5)).to(cuda, torch.bfloat16)
    assert TC.conv_route("fwd", torch.bfloat16, xs[-1], ws[-1], 1,
                         (1, 1, 1), dil, ws[:3]) == "sm90"
    k15 = TC.conv3d_direct_ndhwc
    before = k15.launches, k15.sm90_launches
    out = k15(x, w, dil)
    ref = TC.conv_nd_reference(x, w, (1, 1, 1), dil)
    torch.cuda.synchronize()
    assert (k15.launches, k15.sm90_launches) == (before[0] + 1,
                                                 before[1] + 1)
    _card_close(out, ref, torch.bfloat16)
    top = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** (
        np.floor(np.log2(top)) - 7)


# the Hopper K14 (bf16): (x shape, w shape, dilation); output positions
# ragged across samples (M not a multiple of 128), Ci and Co tails, Co <=
# 64 and <= 128 (narrower tiles), one tap, dilation 2, a large dilation,
# (k - 1) d = 32768 (the rank-3 corner range) and the table's widths at
# batch 2
SM90_K14_CASES = {
    "ragged": ((3, 301, 64), (3, 64, 192), 1),
    "tails-d2": ((2, 333, 72), (3, 72, 136), 2),
    "co64-d2": ((2, 200, 16), (3, 16, 64), 2),
    "co128-k5": ((2, 517, 128), (5, 128, 128), 3),
    "k1-co40": ((2, 100, 24), (1, 24, 40), 1),
    "dil1000": ((1, 3000, 8), (3, 8, 24), 1000),
    "corner32768": ((1, 32833, 8), (3, 8, 16), 16384),
    "table-B2": ((2, 3138, 256), (3, 256, 256), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SM90_K14_CASES))
def test_sm90_conv1d_matches_plain_on_gpu(cuda, name):
    """In norm as _card_close, and each entry within one bf16 ulp of the
    largest: both round one f32 sum."""
    xs, ws, dil = SM90_K14_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=(ws[0] * ws[1])
                                ** -0.5)).to(cuda, torch.bfloat16)
    assert TC.conv_route("fwd", torch.bfloat16, xs[-1], ws[-1], 1, (1,),
                         (dil,), ws[:1]) == "sm90"
    k14 = TC.conv1d_direct_nwc
    before = k14.launches, k14.sm90_launches
    out = k14(x, w, dil)
    ref = TC.conv_nd_reference(x, w, (1,), (dil,))
    torch.cuda.synchronize()
    assert (k14.launches, k14.sm90_launches) == (before[0] + 1,
                                                 before[1] + 1)
    _card_close(out, ref, torch.bfloat16)
    top = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** (
        np.floor(np.log2(top)) - 7)


@pytest.mark.cuda
def test_sm90_conv1d_gives_the_same_bits_twice(cuda):
    x = torch.from_numpy(_randn(4, 3138, 256)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_randn(3, 256, 256, seed=1, scale=0.04)).to(
        cuda, torch.bfloat16)
    a = TC.conv1d_direct_nwc(x, w)
    b = TC.conv1d_direct_nwc(x, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xs,ws,dil", [
    (torch.float32, (2, 300, 64), (3, 64, 64), 1),
    (torch.bfloat16, (1, 32835, 8), (2, 8, 8), 32769),
    (torch.bfloat16, (2, 300, 12), (3, 12, 16), 2),
], ids=["f32", "corner32769", "ci12"])
def test_conv1d_route_falls_to_conv_cu_on_gpu(cuda, dtype, xs, ws, dil):
    """What the Hopper K14 does not take runs csrc/conv.cu's kernel."""
    x = torch.from_numpy(_randn(*xs)).to(cuda, dtype)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=0.3)).to(cuda, dtype)
    assert TC.conv_route("fwd", dtype, xs[-1], ws[-1], 1, (1,), (dil,),
                         ws[:1]) != "sm90"
    k14 = TC.conv1d_direct_nwc
    before = k14.launches, k14.sm90_launches
    out = k14(x, w, dil)
    ref = TC.conv_nd_reference(x, w, (1,), (dil,))
    torch.cuda.synchronize()
    assert (k14.launches, k14.sm90_launches) == (before[0] + 1, before[1])
    _card_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xs,ws,dil", [
    (torch.float32, (2, 6, 7, 9, 8), (3, 3, 3, 8, 16), (1, 1, 1)),
    (torch.bfloat16, (1, 22, 6, 6, 8), (3, 1, 1, 8, 8), (9, 1, 1)),
    (torch.bfloat16, (2, 6, 7, 9, 12), (3, 3, 3, 12, 16), (1, 1, 1)),
], ids=["f32", "corner18", "ci12"])
def test_conv3d_route_falls_to_conv_cu_on_gpu(cuda, dtype, xs, ws, dil):
    """What the Hopper K15 does not take runs csrc/conv.cu's kernel."""
    x = torch.from_numpy(_randn(*xs)).to(cuda, dtype)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=0.3)).to(cuda, dtype)
    assert TC.conv_route("fwd", dtype, xs[-1], ws[-1], 1, (1, 1, 1), dil,
                         ws[:3]) != "sm90"
    k15 = TC.conv3d_direct_ndhwc
    before = k15.launches, k15.sm90_launches
    out = k15(x, w, dil)
    ref = TC.conv_nd_reference(x, w, (1, 1, 1), dil)
    torch.cuda.synchronize()
    assert (k15.launches, k15.sm90_launches) == (before[0] + 1, before[1])
    _card_close(out, ref, dtype)
