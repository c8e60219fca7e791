"""The stacked K12 on the card (`cuda` marker; skips without a CUDA GPU
and nvcc): a bf16 2-d conv of fewer than 8 input channels (both ResNet
stems) runs the pre-pass that stacks its horizontal taps (and the rows of
a vertical stride) into channels, then the Hopper K12 on a (kq x 1) conv;
each case against its plain version, its launches counted, the same bits
twice, the pre-pass equal to `stack_taps_reference`. This file imports no
JAX (tests/test_torch_conv.py holds the decomposition against JAX's
kernel on the CPU)."""

import numpy as np
import pytest
import torch

from neuronika_tpu_torch.ops import conv as TC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _card_close(out, ref):
    """bf16: the norm rule of chip_smoke.py, ||out - ref|| <= 1e-2 ||ref||
    + 2^-15 sqrt(numel), and one bf16 ulp of the largest entry (both round
    one f32 sum)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    d = out.double() - ref.double()
    assert float(d.norm()) <= 1e-2 * float(ref.double().norm()) \
        + 2 ** -15 * d.numel() ** 0.5
    top = float(ref.float().abs().max())
    assert float(d.abs().max()) <= 2.0 ** (np.floor(np.log2(top)) - 7)


# the stacked K12 (bf16, Ci < 8): (x shape, w shape, stride, dilation);
# both ResNet stems at B2 (the padded input), 1, 5 and 7 channels, dilation
# (2, 2), stride (3, 2) (three rows in a stacked pixel, one k step, an
# input row that no output reads), 7x7 and 2x2 taps at strides 3 and 2
# (rows grouped, 3 and 1 k steps), M and Co tails, two panels of stacked
# channels
SM90_STACK_CASES = {
    "imagenet-stem": ((2, 229, 229, 3), (7, 7, 3, 64), (2, 2), (1, 1)),
    "cifar-stem": ((2, 34, 34, 3), (3, 3, 3, 32), (1, 1), (1, 1)),
    "ci1": ((2, 20, 21, 1), (3, 3, 1, 16), (1, 1), (1, 1)),
    "ci5": ((2, 19, 18, 5), (3, 3, 5, 24), (1, 1), (1, 1)),
    "ci7-k5": ((2, 20, 22, 7), (5, 5, 7, 8), (1, 1), (1, 1)),
    "dil2": ((2, 21, 23, 3), (3, 3, 3, 16), (1, 1), (2, 2)),
    "s3x2": ((2, 25, 24, 3), (3, 3, 3, 16), (3, 2), (1, 1)),
    "k7-s3": ((2, 40, 30, 3), (7, 7, 3, 8), (3, 2), (1, 1)),
    "k2-s2": ((2, 20, 20, 3), (2, 2, 3, 8), (2, 2), (1, 1)),
    "tails": ((3, 13, 11, 3), (3, 3, 3, 72), (1, 1), (1, 1)),
    "two-panels": ((2, 16, 30, 6), (3, 11, 6, 136), (1, 1), (1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SM90_STACK_CASES))
def test_stacked_conv2d_matches_plain_on_gpu(cuda, name):
    """One K12 launch on the Hopper kernel after one stacking pre-pass,
    within one bf16 ulp of the largest entry and the norm rule of the plain
    version, the same bits twice; the pre-pass equal to its plain
    version."""
    xs, ws, stride, dil = SM90_STACK_CASES[name]
    x = torch.from_numpy(_randn(*xs)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_randn(*ws, seed=1, scale=(ws[0] * ws[1] * ws[2])
                                ** -0.5)).to(cuda, torch.bfloat16)
    assert TC.conv_route("fwd", torch.bfloat16, xs[-1], ws[-1], 1, stride,
                         dil, ws[:2]) == "sm90_stacked"
    k12, pre = TC.conv2d_direct_nhwc, TC.stack_taps_nhwc
    before = k12.launches, k12.sm90_launches, pre.launches
    out = k12(x, w, dil, stride)
    ref = TC.conv_nd_reference(x, w, stride, dil)
    torch.cuda.synchronize()
    assert (k12.launches, k12.sm90_launches, pre.launches) == tuple(
        b + 1 for b in before)
    _card_close(out, ref)
    assert torch.equal(k12(x, w, dil, stride), out)
    rows, h2, cs = TC.stack_plan(xs[1], xs[-1], ws[:2], stride, dil)
    assert torch.equal(pre(x, ws[1], stride[1], dil[1], cs, rows, h2),
                       TC.stack_taps_reference(x, ws[1], stride[1], dil[1],
                                               cs, rows, h2))


@pytest.mark.cuda
def test_stack_taps_refuses_what_it_cannot_run(cuda):
    x = torch.zeros(1, 8, 8, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        TC.stack_taps_nhwc(x.float(), 3, 1, 1, 16)
    with pytest.raises(TypeError):
        TC.stack_taps_nhwc(x, 3, 1, 1, 12)
    with pytest.raises(ValueError):
        TC.stack_taps_nhwc(x, 3, 1, 1, 8)
    with pytest.raises(ValueError):
        TC.stack_taps_nhwc(x, 3, 1, 1, 16, 2)
