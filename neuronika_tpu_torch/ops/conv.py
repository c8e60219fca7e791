"""K12-K15: direct convolutions (counterpart of
`neuronika_tpu/ops/pallas/conv.py`).

Layouts are the JAX package's: channels last, kernels (*taps, Ci/groups,
Co), VALID (a caller pads first). The kernel wrappers:
  `conv2d_direct_nhwc`  K12: x (N, H, W, Ci) * w (kh, kw, Ci/g, Co), any
                        stride, dilation and groups, taken natively in one
                        launch (JAX decomposes strides into phases);
  `conv2d_dw_nhwc`      K13: the weight gradient of a stride-1 2-d conv,
                        (kh, kw, Ci, Co) in f32;
  `conv1d_direct_nwc`   K14 at stride 1: x (N, L, Ci) * w (k, Ci, Co), any
                        dilation; a strided 1-d conv runs on K12 as a
                        (1, L) image;
  `conv3d_direct_ndhwc` K15: x (N, D, H, W, Ci) * w (kd, kh, kw, Ci, Co),
                        stride 1;
  `stack_taps_nhwc`     the pre-pass of K12 at Ci < 8: x's horizontal taps
                        (and the rows of a vertical stride) stacked into
                        channels (replaces no TPU kernel).
For CUDA tensors each launches a kernel and adds one to its `launches`;
other tensors take the plain version beside it, an im2col built from
strided views and one f32 product, rounded once. `conv_route` picks the
kernel of a K12, K13, K14 or K15 call by its shape: the Hopper kernels of
`csrc/conv_sm90.cu` (wgmma fed by TMA im2col loads of rank 3, 4 or 5;
bf16, groups 1, channels multiples of 8, or for K12 Ci < 8 by stacking
the taps), which also add one to the wrapper's `sm90_launches`, or
`csrc/conv.cu`'s (FFMA for f32, mma.sync for bf16), which run every other
call. Both accumulate in f32 and give the output in x's dtype. The
block-size and `interpret`
arguments of the JAX functions size the TPU's VMEM blocks and are
accepted and ignored.

Around them: `conv2d_input_grad_nhwc`, the stride-1 input gradient on
K12; the NCHW facade and gradients (`conv2d_direct`,
`conv2d_direct_input_grad`, `conv2d_direct_kernel_grad`), permutes
around the NHWC functions; `conv2d_pallas_nhwc`, the differentiable NHWC
conv of the ResNet model (stride-1 backward on K12 and K13, strided
backward by the library's transposed convolution, as JAX leaves it to
XLA); `route_conv2d`, the JAX package's per-shape tier table (measured on
a TPU v5e) with its on-card rows re-decided by H100 timings; and
`_same_pads`, TF/lax SAME padding.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..config import config

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# K13: split the pixel reduction so that the CTAs fill the 132 SMs, two
# each, in ONE wave (a second, nearly empty wave costs as much as the
# first), each reducing at least _SPLIT_MIN pixels
_SPLIT_MIN = 1024
_TARGET_CTAS = 264
_TILE = 128
# the Hopper K13: pixels a k step, and at least _SM90_MIN_STEPS steps a
# split, the splits filling at most one wave of the card's SMs
_SMS = 132
_SM90_STEP = 64
_SM90_MIN_STEPS = 8
# the Hopper kernels' im2col corner range, by the rank of the input: the
# largest (k - 1) * dilation an axis may have (TMA's rank-3 corners are 16
# bits, its rank-4 corners 8, its rank-5 corners 5)
_SM90_CORNER = {3: 2 ** 15, 4: 128, 5: 16}


def _out_len(n, k, s, d):
    return (n - d * (k - 1) - 1) // s + 1


def _as_tuple(v, r):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * r


def _check(x, w, stride, dilation, groups):
    """Output spatial sizes of x (N, *S, Ci) * w (*k, Ci/groups, Co);
    raises ValueError on a mismatch."""
    r = len(stride)
    if x.dim() != r + 2 or w.dim() != r + 2:
        raise ValueError(f"a rank-{r} conv takes x (N, *{r} dims, Ci) and w "
                         f"(*{r} taps, Ci/groups, Co), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if min(stride) < 1 or min(dilation) < 1 or groups < 1:
        raise ValueError("stride, dilation and groups must be positive")
    ci, (cig, co) = x.shape[-1], w.shape[-2:]
    if cig * groups != ci or co % groups:
        raise ValueError(f"channel/group mismatch: Ci {ci}, kernel "
                         f"{tuple(w.shape)}, groups {groups}")
    out = tuple(_out_len(n, k, s, d) for n, k, s, d in
                zip(x.shape[1:-1], w.shape[:r], stride, dilation))
    if min(out) <= 0:
        raise ValueError("kernel larger than input")
    return out


def _patches(x, ksize, out, stride, dilation):
    """The im2col of x (N, *S, Ci) in f32: (N * prod(out), prod(ksize),
    Ci), a copy built from one strided view."""
    xf = x.float().contiguous()
    st = xf.stride()
    r = len(ksize)
    view = xf.as_strided(
        (x.shape[0], *out, *ksize, x.shape[-1]),
        (st[0], *(s * st[1 + i] for i, s in enumerate(stride)),
         *(d * st[1 + i] for i, d in enumerate(dilation)), st[-1]))
    return view.reshape(x.shape[0] * math.prod(out), math.prod(ksize),
                        x.shape[-1])


def conv_nd_reference(x, w, stride, dilation, groups=1):
    """Plain version of K12, K14 and K15 (and of K12 on a strided 1-d
    conv): x (N, *S, Ci) * w (*k, Ci/groups, Co), VALID, any rank: the
    im2col of x times w per group, in f32, rounded once to x's dtype. Runs
    on any device."""
    stride, dilation = tuple(stride), tuple(dilation)
    out = _check(x, w, stride, dilation, groups)
    r, co = len(stride), w.shape[-1]
    p = _patches(x, w.shape[:r], out, stride, dilation)
    p = p.reshape(p.shape[0], p.shape[1], groups, -1)
    wm = w.float().reshape(p.shape[1], w.shape[-2], groups, co // groups)
    y = torch.einsum("mtgc,tcgo->mgo", p, wm)
    return y.reshape(x.shape[0], *out, co).to(x.dtype)


def conv_dw_reference(x, g, ksize, dilation):
    """Plain version of K13 at any rank: the weight gradient of the
    stride-1 VALID conv of x (N, *S, Ci) whose output gradient is g (N,
    *O, Co): the im2col of x, transposed, times g, in f32 -> (*ksize, Ci,
    Co) f32."""
    out, ci, co = tuple(g.shape[1:-1]), x.shape[-1], g.shape[-1]
    r = len(ksize)
    p = _patches(x, ksize, out, (1,) * r, dilation)
    dw = p.reshape(p.shape[0], -1).T @ g.float().reshape(-1, co)
    return dw.reshape(*ksize, ci, co)


def stack_plan(h, ci, ksize, stride, dilation):
    """(rows, h2, cs) of the stacked K12 for an input of h rows and ci
    channels, taps ksize (kh, kw) at stride (sh, sw) and dilation (dh, dw):
    the pre-pass stacks `rows` input rows (sh where dh is 1 and kh > 1,
    else 1) of kw taps each into the channels of one pixel of xs, cs = rows
    kw ci rounded up to a multiple of 8 (a legal TMA row), and writes h2
    rows of such pixels: h where rows is 1, else exactly the Ho +
    ceil(kh / rows) - 1 that the stride-1 conv of xs reads (the kernel's
    im2col walk takes every row of its input as a base row)."""
    kh, kw = ksize
    rows = stride[0] if dilation[0] == 1 and kh > 1 else 1
    h2 = h if rows == 1 else (
        _out_len(h, kh, stride[0], 1) + -(-kh // rows) - 1)
    return rows, h2, -(-rows * kw * ci // 8) * 8


def stack_taps_reference(x, kw, sw, dw, cs, rows=1, h2=None):
    """Plain version of the stacked K12's pre-pass: x (N, H, W, Ci) -> xs
    (N, h2, Wo, cs) (h2 by default ceil(H / rows)), xs[n, r, ow, (i kw +
    tw) Ci + c] = x[n, r rows + i, ow sw + tw dw, c] for i < rows, tw < kw
    (zero past row H), zeros in channels rows kw Ci .. cs - 1. Then the
    VALID conv of x by w (kh, kw, Ci, Co) at stride (sh, sw) and dilation
    (dh, dw), with rows and h2 from `stack_plan`, is the (ceil(kh / rows)
    x 1) conv of xs by `stack_weights(w, rows, cs)` at stride (sh / rows,
    1) and dilation (dh, 1). Runs on any device."""
    n, h, w, ci = x.shape
    wo = _out_len(w, kw, sw, dw)
    h2 = -(-h // rows) if h2 is None else h2
    if wo <= 0 or h2 <= 0 or cs < rows * kw * ci:
        raise ValueError(f"stack_taps: {kw} taps of dilation {dw} do not "
                         f"fit a row of {w}, or {cs} < {rows} x {kw} x {ci} "
                         f"channels, or {h2} rows")
    xc = F.pad(x[:, :h2 * rows], (0, 0, 0, 0, 0, max(0, h2 * rows - h)))
    xc = xc.contiguous()
    st = xc.stride()
    xs = xc.as_strided((n, h2, wo, rows, kw, ci),
                       (st[0], rows * st[1], sw * st[2], st[1], dw * st[2],
                        st[3]))
    return F.pad(xs.reshape(n, h2, wo, rows * kw * ci),
                 (0, cs - rows * kw * ci))


def stack_weights(w, rows, cs):
    """w (kh, kw, Ci, Co) as the stacked K12's (ceil(kh / rows), 1, cs, Co)
    weights: tap row q, channel (i kw + tw) Ci + c holds w[q rows + i, tw,
    c], zero past row kh and past channel rows kw Ci."""
    kh, kw, ci, co = w.shape
    kq = -(-kh // rows)
    wq = F.pad(w, (0, 0, 0, 0, 0, 0, 0, kq * rows - kh))
    return F.pad(wq.reshape(kq, 1, rows * kw * ci, co),
                 (0, 0, 0, cs - rows * kw * ci))


def stack_taps_nhwc(x, kw: int, sw: int, dw: int, cs: int, rows: int = 1,
                    h2=None):
    """The stacked K12's pre-pass (`stack_taps_reference`'s function).
    CUDA tensors: `csrc/conv_sm90.cu`'s kernel, bf16 only, cs a multiple of
    8, adding one to `stack_taps_nhwc.launches`; others: the plain
    version."""
    if x.dim() != 4:
        raise ValueError(f"stack_taps takes x (N, H, W, Ci), got "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        return stack_taps_reference(x, kw, sw, dw, cs, rows, h2)
    if x.dtype != torch.bfloat16 or cs % 8:
        raise TypeError(f"stack_taps_nhwc takes bf16 and cs a multiple of "
                        f"8, got {x.dtype}, cs {cs}")
    n, h, w, ci = x.shape
    wo = _out_len(w, kw, sw, dw)
    h2 = -(-h // rows) if h2 is None else h2
    if (wo <= 0 or rows < 1 or h2 < 1 or cs < rows * kw * ci
            or n * h2 * wo * cs // 8 > _INT_MAX - 2 ** 28):
        raise ValueError(f"stack_taps: {rows} rows of {kw} taps of dilation "
                         f"{dw} over a row of {w} into {cs} channels, "
                         f"{n * h2 * wo} pixels")
    xc = x.contiguous()
    xs = torch.empty((n, h2, wo, cs), dtype=x.dtype, device=x.device)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = load_library().nk_conv_stack_taps(
            xc.data_ptr(), xs.data_ptr(), n, h, w, ci, h2, wo, rows, kw, sw,
            dw, cs, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"stack_taps_nhwc kernel launch failed: cudaError "
                           f"{err}")
    stack_taps_nhwc.launches += 1
    return xs


def conv_route(kind: str, dtype, ci: int, co: int, groups: int = 1,
               stride=(1, 1), dilation=(1, 1), ksize=(1, 1)) -> str:
    """The kernel that runs, on the card, a K14 call ("fwd" with 1-d taps: a
    stride-1 1-d conv), a K12 call ("fwd" with 2-d taps: a 2-d conv, or the
    stride-1 input gradient, which is one), a K15 call ("fwd" with 3-d
    taps: a stride-1 3-d conv) or a K13 call ("dw": the weight gradient of
    a stride-1 2-d conv), by shape alone, before launch:
      "sm90"      `csrc/conv_sm90.cu`, the Hopper kernels: bf16, groups 1,
                  Ci and Co multiples of 8 (TMA's rows are multiples of 16
                  bytes), strides at most 8 (the im2col map's traversal
                  strides; K14 and K15 take stride 1 only), (k - 1) *
                  dilation at most 32768 for a 1-d conv, 128 on each axis
                  of a 2-d conv and 16 of a 3-d one (the corner range of
                  TMA's rank-3, rank-4 and rank-5 im2col maps); any
                  dilation. Every stride-1 conv, dx and dw of ResNet-18,
                  its strided 3x3 and 1x1 convs, k3 1-d convs up to
                  dilation 16384 and k3 3-d convs up to dilation 8;
      "sm90_stacked"
                  the same Hopper K12 after a pre-pass that stacks the
                  horizontal taps, and at dilation 1 the sh rows of a
                  vertical stride, into channels (`stack_plan`,
                  `stack_taps_nhwc`; a (ceil(kh / rows) x 1) conv of rows kw
                  Ci channels, padded to a multiple of 8):
                  "fwd" of a 2-d conv in bf16, groups 1, Ci < 8, Co a
                  multiple of 8, with "sm90"'s stride and corner limits.
                  Both ResNet stems (7x7/2 and 3x3/1, Ci = 3);
      "conv_mma"  `csrc/conv.cu`'s mma.sync kernel: every other bf16 call
                  (groups; Ci >= 8 or Co not multiples of 8; "dw" at any
                  Ci < 8, the CIFAR stem's; wider taps);
      "conv_ffma" `csrc/conv.cu`'s FFMA kernel: f32.
    Not a fallback: a failure of the chosen kernel raises."""
    if kind not in ("fwd", "dw"):
        raise ValueError(f"kind {kind!r}: fwd or dw")
    rank = len(ksize) + 2
    if rank not in _SM90_CORNER or (kind == "dw" and rank != 4) or not (
            len(stride) == len(dilation) == len(ksize)):
        raise ValueError(f"conv_route takes 1-d, 2-d or 3-d taps (fwd) or "
                         f"2-d taps (dw) with matching strides and "
                         f"dilations, got {kind} {ksize}, {stride}, "
                         f"{dilation}")
    if dtype == torch.float32:
        return "conv_ffma"
    corner = _SM90_CORNER[rank]
    sm90 = (dtype == torch.bfloat16 and groups == 1 and co % 8 == 0
            and max(stride) <= (8 if rank == 4 else 1)
            and (kind == "fwd" or tuple(stride) == (1, 1))
            and all((k - 1) * d <= corner for k, d in zip(ksize, dilation)))
    if sm90 and ci % 8 == 0:
        return "sm90"
    if sm90 and ci < 8 and kind == "fwd" and rank == 4:
        return "sm90_stacked"
    return "conv_mma"


def _dw_plan_sm90(taps, ci, co, pixels):
    """(splits, pixels a split) for the Hopper K13: its tiles are two
    64-channel row blocks of one tap each by 64 (Co <= 64), 128 (Co <=
    128) or 256 columns;
    the pixels are cut into runs of whole 64-pixel k steps, at least
    _SM90_MIN_STEPS each, so that tiles x splits fill at most one wave of
    the _SMS SMs (one split when the tiles alone fill it)."""
    bn = 64 if co <= 64 else 128 if co <= 128 else 256
    tiles = -(-(taps * -(-ci // 64)) // 2) * -(-co // bn)
    steps = -(-pixels // _SM90_STEP)
    splits = max(1, min(_SMS // tiles, steps // _SM90_MIN_STEPS))
    per = -(-steps // splits)
    return -(-steps // per), per * _SM90_STEP


def dw_plan(kh, kw, ci, co, pixels, dtype, dilation=(1, 1)):
    """(route, splits, pixels a split) of a K13 call: `conv_route`'s choice
    and that kernel's cut of the pixel reduction."""
    route = conv_route("dw", dtype, ci, co, dilation=dilation,
                       ksize=(kh, kw))
    if route == "sm90":
        return (route, *_dw_plan_sm90(kh * kw, ci, co, pixels))
    return (route, *_dw_splits(kh * kw * ci, co, pixels))


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _c_geo(x, w_taps, out, co, stride, dilation, groups):
    """The C entry points' geometry (rank 3, unit leading dims padded in)."""
    lead = 3 - len(out)
    dims = (1,) * lead
    g = (x.shape[0], *dims, *x.shape[1:-1], x.shape[-1], *dims, *out, co,
         *dims, *w_taps, *dims, *stride, *dims, *dilation, groups)
    return (ctypes.c_int * 19)(*g)


def _card_operands(x, w, what):
    """x and w as contiguous tensors of their promoted dtype on x's card;
    raises on what the kernels cannot take."""
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    ct = torch.promote_types(x.dtype, w.dtype)
    if ct not in _DTYPES:
        raise TypeError(f"{what} takes {', '.join(map(str, _DTYPES))}, not "
                        f"{ct}")
    return x.to(ct).contiguous(), w.to(ct).contiguous(), ct


def _launch(fn, cname, x, w, stride, dilation, groups, out):
    """Launch forward kernel `cname` of x * w into a new (N, *out, Co)
    tensor; adds one to fn.launches (and to fn.sm90_launches for the
    Hopper K12, K14 and K15)."""
    xc, wc, ct = _card_operands(x, w, fn.__name__)
    xc, wc = _aligned(xc), _aligned(wc)
    co = w.shape[-1]
    m = x.shape[0] * math.prod(out)
    if m > _INT_MAX - _TILE or math.prod(w.shape[:-1]) * groups > _INT_MAX:
        raise ValueError(f"{fn.__name__}: {m} output pixels exceed the "
                         f"kernel's int32 indexing")
    y = torch.empty((x.shape[0], *out, co), dtype=ct, device=x.device)
    from .._build import load_library

    r = len(out)
    with torch.cuda.device(x.device):
        err = getattr(load_library(), cname)(
            _DTYPES[ct], xc.data_ptr(), wc.data_ptr(), y.data_ptr(),
            _c_geo(x, w.shape[:r], out, co, stride, dilation, groups),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch ({cname}) failed: "
                           f"cudaError {err}")
    fn.launches += 1
    fn.sm90_launches += cname.endswith("_sm90")
    return y if ct == x.dtype else y.to(x.dtype)


def conv2d_direct_nhwc(x, w, dilation=(1, 1), stride=(1, 1), *,
                       groups: int = 1, block_h: int = 0,
                       block_co: int = 256, interpret: bool = False):
    """K12: x (N, H, W, Ci) * w (kh, kw, Ci/groups, Co), VALID -> (N, Ho,
    Wo, Co) in x's dtype, f32 accumulation. Strided and dilated at once,
    in one launch. CUDA tensors: the kernel `conv_route` picks; others:
    `conv_nd_reference`."""
    del block_h, block_co, interpret
    stride, dilation = _as_tuple(stride, 2), _as_tuple(dilation, 2)
    out = _check(x, w, stride, dilation, groups)
    if x.device.type != "cuda":
        return conv_nd_reference(x, w, stride, dilation, groups)
    route = conv_route("fwd", torch.promote_types(x.dtype, w.dtype),
                       x.shape[-1], w.shape[-1], groups, stride, dilation,
                       w.shape[:2])
    if route == "sm90_stacked":
        # the (ceil(kh / rows) x 1) conv of the stacked taps
        # (stack_taps_reference)
        rows, h2, cs = stack_plan(x.shape[1], x.shape[-1], w.shape[:2],
                                  stride, dilation)
        xs = stack_taps_nhwc(x, w.shape[1], stride[1], dilation[1], cs, rows,
                             h2)
        return _launch(conv2d_direct_nhwc, "nk_conv2d_stacked_sm90", xs,
                       stack_weights(w, rows, cs), (stride[0] // rows, 1),
                       (dilation[0], 1), 1, out)
    return _launch(conv2d_direct_nhwc,
                   "nk_conv2d_sm90" if route == "sm90" else "nk_conv2d", x,
                   w, stride, dilation, groups, out)


def conv1d_direct_nwc(x, w, dilation=1, stride=1, *, out_ncw=False,
                      interpret=False):
    """x (N, L, Ci) * w (k, Ci, Co), VALID -> (N, Lout, Co), or (N, Co,
    Lout) when `out_ncw` (a transpose after the kernel). Stride 1: K14,
    the kernel `conv_route` picks, adding one to
    `conv1d_direct_nwc.launches` (and to `sm90_launches` on the Hopper
    kernel); strided: K12 on the (1, L) image with (1, k) taps, as JAX
    lowers it. CPU tensors: the plain versions."""
    del interpret
    if w.dim() == 3 and w.shape[1] != x.shape[-1]:
        raise ValueError("channel mismatch (grouped conv1d: use the library "
                         "convolution)")
    if stride != 1:
        a = conv2d_direct_nhwc(x[:, None], w[None], (1, dilation),
                               (1, stride))[:, 0]
    else:
        out = _check(x, w, (1,), (dilation,), 1)
        if x.device.type != "cuda":
            a = conv_nd_reference(x, w, (1,), (dilation,))
        else:
            sm90 = conv_route("fwd", torch.promote_types(x.dtype, w.dtype),
                              x.shape[-1], w.shape[-1], 1, (1,),
                              (dilation,), w.shape[:1]) == "sm90"
            a = _launch(conv1d_direct_nwc,
                        "nk_conv1d_sm90" if sm90 else "nk_conv1d", x, w,
                        (1,), (dilation,), 1, out)
    return a.transpose(1, 2) if out_ncw else a


def conv3d_direct_ndhwc(x, w, dilation=(1, 1, 1), *, block_d: int = 0,
                        block_co: int = 256, interpret: bool = False):
    """K15: x (N, D, H, W, Ci) * w (kd, kh, kw, Ci, Co), stride 1, VALID ->
    NDHWC in x's dtype, f32 accumulation. CUDA tensors: the kernel
    `conv_route` picks (adding one to `conv3d_direct_ndhwc.launches`, and
    to `sm90_launches` on the Hopper kernel); others:
    `conv_nd_reference`."""
    del block_d, block_co, interpret
    dilation = _as_tuple(dilation, 3)
    if w.dim() == 5 and w.shape[3] != x.shape[-1]:
        raise ValueError("channel mismatch (groups != 1 not supported here)")
    out = _check(x, w, (1, 1, 1), dilation, 1)
    if x.device.type != "cuda":
        return conv_nd_reference(x, w, (1, 1, 1), dilation)
    sm90 = conv_route("fwd", torch.promote_types(x.dtype, w.dtype),
                      x.shape[-1], w.shape[-1], 1, (1, 1, 1), dilation,
                      w.shape[:3]) == "sm90"
    return _launch(conv3d_direct_ndhwc,
                   "nk_conv3d_sm90" if sm90 else "nk_conv3d", x, w,
                   (1, 1, 1), dilation, 1, out)


def _dw_splits(rows, co, pixels):
    """(splits, pixels a split) for K13: at most _TARGET_CTAS CTAs, each
    reducing at least _SPLIT_MIN pixels, in multiples of 32."""
    tiles = -(-rows // _TILE) * -(-co // _TILE)
    splits = max(1, min(_TARGET_CTAS // tiles, pixels // _SPLIT_MIN))
    chunk = -(-pixels // splits)
    chunk = -(-chunk // 32) * 32
    return -(-pixels // chunk), chunk


def conv2d_dw_nhwc(x, g, kh: int, kw: int, dilation=(1, 1), *,
                   block_ci: int = 128, block_co: int = 128,
                   interpret: bool = False):
    """K13: d(kernel) of the stride-1 VALID NHWC conv, x (N, H, W, Ci) and
    the output gradient g (N, Ho, Wo, Co) -> (kh, kw, Ci, Co) f32. CUDA
    tensors: the kernel `conv_route` picks (split over the pixels as
    `dw_plan` says, partials summed in a fixed order), adding one to
    `conv2d_dw_nhwc.launches` (and to `sm90_launches` on the Hopper
    kernel); others: `conv_dw_reference`."""
    del block_ci, block_co, interpret
    dh, dw_ = _as_tuple(dilation, 2)
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         f"(N, H, W, C) of one batch")
    N, H, W, Ci = x.shape
    _, Ho, Wo, Co = g.shape
    if (min(kh, kw, dh, dw_, Ho, Wo) < 1 or Ho + dh * (kh - 1) > H
            or Wo + dw_ * (kw - 1) > W):
        raise ValueError(f"g {tuple(g.shape)} is no output of a {kh}x{kw} "
                         f"conv (dilation {dh, dw_}) of x {tuple(x.shape)}")
    if x.device.type != "cuda":
        return conv_dw_reference(x, g, (kh, kw), (dh, dw_))
    fn = conv2d_dw_nhwc
    xc, gc, ct = _card_operands(x, g, fn.__name__)
    pixels, rows = N * Ho * Wo, kh * kw * Ci
    if pixels > _INT_MAX - _TILE or rows > _INT_MAX:
        raise ValueError("conv2d_dw_nhwc: sizes exceed the kernel's int32 "
                         "indexing")
    route, splits, chunk = dw_plan(kh, kw, Ci, Co, pixels, ct,
                                   (dh, dw_))
    out = torch.empty((kh, kw, Ci, Co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, rows, Co), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    geo = _c_geo(x, (kh, kw), (Ho, Wo), Co, (1, 1), (dh, dw_), 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    from .._build import load_library

    xc, gc = _aligned(xc), _aligned(gc)
    with torch.cuda.device(x.device):
        err = getattr(load_library(),
                      "nk_conv_dw_sm90" if route == "sm90" else "nk_conv_dw")(
            _DTYPES[ct], xc.data_ptr(), gc.data_ptr(), ws.data_ptr(),
            out.data_ptr(), geo, splits, chunk, stream)
    if err:
        raise RuntimeError(f"conv2d_dw_nhwc ({route}) kernel launch failed: "
                           f"cudaError {err}")
    fn.launches += 1
    fn.sm90_launches += route == "sm90"
    return out


for _fn in (conv2d_direct_nhwc, conv2d_dw_nhwc, conv1d_direct_nwc,
            conv3d_direct_ndhwc):
    _fn.launches = 0
    # the calls that ran the Hopper kernels (conv_route "sm90" and
    # "sm90_stacked")
    _fn.sm90_launches = 0
stack_taps_nhwc.launches = 0

KERNELS = (conv2d_direct_nhwc, conv2d_dw_nhwc, conv1d_direct_nwc,
           conv3d_direct_ndhwc, stack_taps_nhwc)


# --------------------------------------------------------------------------
# NCHW facade and the stride-1 gradients by composition


def conv2d_direct(x, w, dilation=(1, 1), stride=(1, 1), *, groups: int = 1,
                  block_h: int = 0, interpret: bool = False):
    """NCHW facade over K12: x (N, Ci, H, W) * w (Co, Ci/groups, kh, kw) ->
    (N, Co, Ho, Wo), VALID."""
    del block_h, interpret
    out = conv2d_direct_nhwc(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                             dilation, stride, groups=groups)
    return out.permute(0, 3, 1, 2)


def conv2d_input_grad_nhwc(g, w, dilation=(1, 1)):
    """d(input) of a stride-1 VALID NHWC conv of kernel w (kh, kw, Ci, Co):
    the full correlation of g (N, Ho, Wo, Co) with the spatially flipped,
    io-swapped kernel, on K12 -> (N, H, W, Ci)."""
    dh, dw_ = _as_tuple(dilation, 2)
    kh, kw = w.shape[0], w.shape[1]
    gpad = _pad_nhwc(g, (dh * (kh - 1),) * 2, (dw_ * (kw - 1),) * 2)
    return conv2d_direct_nhwc(gpad, w.flip(0, 1).transpose(2, 3), (dh, dw_))


def conv2d_direct_input_grad(g, w, dilation=(1, 1), *, interpret=False):
    """d(input) of a stride-1 VALID conv (NCHW): `conv2d_input_grad_nhwc`
    on permuted views."""
    del interpret
    dx = conv2d_input_grad_nhwc(g.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                                dilation)
    return dx.permute(0, 3, 1, 2)


def conv2d_direct_kernel_grad(x, g, *, interpret=False):
    """d(kernel) of a stride-1, dilation-1 VALID conv (NCHW), on K13."""
    del interpret
    kh = x.shape[2] - g.shape[2] + 1
    kw = x.shape[3] - g.shape[3] + 1
    dw = conv2d_dw_nhwc(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1), kh, kw)
    return dw.permute(3, 2, 0, 1).to(x.dtype)


# --------------------------------------------------------------------------
# the per-shape tier table


def route_conv2d(nd: int, stride, dilation, groups: int,
                 training: bool = True, batch: int = 0, ksize: int = 0,
                 sample_bytes: int = 0, weight_bytes: int = 0, *,
                 on_card: bool = False) -> str:
    """The per-shape tier choice for the direct conv kernels, "pallas" or
    "xla" (the library convolution). `config.conv_route == "force"` always
    picks the kernels. Otherwise the JAX package's table, measured on a
    TPU v5e, sends stride-1, unit-dilation, ungrouped k3 convs of rank 1 or
    2 at batch <= 4 whose padded sample fits 2 MB and kernel 6 MB to the
    kernels; on the card (`on_card`) its rank-1 row stands, since K14 beat
    F.conv1d there at batch 1-4, and its rank-2 row goes to the library,
    since K12 lost to F.conv2d at all twelve ResNet-18 stage shapes at
    batch 1-4 (H100 timings, `chip_smoke.py` phase 3; PERF.md). Off the
    card it is "xla", as JAX's table off a TPU."""
    del training
    if config.conv_route == "force":
        return "pallas"
    small = (0 < batch <= 4 and groups == 1 and ksize == 3
             and 0 < sample_bytes <= 2e6 and 0 < weight_bytes <= 6e6
             and on_card)
    if nd == 1 and small and tuple(stride) == (1,) \
            and tuple(dilation) == (1,):
        return "pallas"
    return "xla"


# --------------------------------------------------------------------------
# the differentiable NHWC conv of models/resnet.py


def _same_pads(size, k, s):
    """lax/TF SAME: out = ceil(size / s); the padding split with the smaller
    half first."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    lo = pad // 2
    return lo, pad - lo


def _pads(x, w, stride, padding):
    if padding == "SAME":
        return (_same_pads(x.shape[1], w.shape[0], stride[0]),
                _same_pads(x.shape[2], w.shape[1], stride[1]))
    if padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return (0, 0), (0, 0)


def _pad_nhwc(x, ph, pw, value=0.0):
    if not any(ph + pw):
        return x
    return F.pad(x, (0, 0, *pw, *ph), value=value)


class _ConvNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ph, pw = _pads(x, w, stride, padding)
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, ph, pw
        return conv2d_direct_nhwc(_pad_nhwc(x, ph, pw), w, (1, 1), stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, ph, pw = ctx.geometry
        need_x, need_w = ctx.needs_input_grad[:2]
        kh, kw = w.shape[0], w.shape[1]
        xp = _pad_nhwc(x, ph, pw)
        dx = dw = None
        if stride == (1, 1):
            g = g.contiguous()
            if need_x:
                # dx of the padded input, its padding border cropped
                dx = conv2d_input_grad_nhwc(g, w)
                dx = dx[:, ph[0]:dx.shape[1] - ph[1],
                        pw[0]:dx.shape[2] - pw[1]]
            if need_w:
                dw = conv2d_dw_nhwc(xp, g, kh, kw).to(w.dtype)
            return dx, dw, None, None
        # strided: the library's transposed convolution of the padded VALID
        # conv (JAX leaves this to XLA's transpose of the lax conv), on
        # contiguous NCHW copies: on the CPU, both transposes of channels-last
        # views corrupt the heap (seen with PyTorch 2.13, 1x1/2 kernels)
        xn = xp.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        gn = g.permute(0, 3, 1, 2).contiguous()
        if need_x:
            dxp = torch.nn.grad.conv2d_input(xn.shape, wn, gn, stride)
            dx = dxp[:, :, ph[0]:dxp.shape[2] - ph[1],
                     pw[0]:dxp.shape[3] - pw[1]].permute(0, 2, 3, 1)
        if need_w:
            dw = torch.nn.grad.conv2d_weight(xn, wn.shape, gn,
                                             stride).permute(2, 3, 1, 0)
        return dx, dw, None, None


def conv2d_pallas_nhwc(x, w, stride=(1, 1), padding="SAME",
                       interpret: bool = False):
    """NHWC * HWIO conv on the kernel tier, SAME or VALID, any stride;
    differentiable. The forward runs K12 on the padded input. At stride 1
    the backward runs K12 for dx (on the padded gradient, with the flipped,
    io-swapped kernel) and K13 for dw; a strided backward is the library's
    transposed convolution."""
    del interpret
    return _ConvNHWC.apply(x, w, _as_tuple(stride, 2), padding)
