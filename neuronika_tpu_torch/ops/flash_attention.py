"""Flash attention, forward and backward (counterpart of
`neuronika_tpu/ops/pallas/attention.py`), in two layouts.

The packed qkv projection (`flash_attention_qkv`), kv-group-major as
`_unpack_qkv` in the models:
  qkv    (B, S, W), W = H*hd + 2*KV*hd: KV groups of (G+2) hd-wide chunks,
         group g = [q_{gG} ... q_{gG+G-1} | k_g | v_g], G = H // KV
  out    (B, S, H*hd) head-major, in qkv's dtype
  lse    (B, H, S) f32, base 2 (m + log2(l); m = 0 in "fast" mode), with
         no lane padding
  d_qkv  (B, S, W) in the packed layout
Its forward launches K1 and its backward the K2 kernels of
`csrc/flash_attention_qkv.cu`: the split pair (dq, then dk/dv) or, with
`fused_bwd`, the fused kernel that stands for both of the TPU's fused
backwards.

The split layout (`flash_attention`): q (B, H, Sq, hd), k and v (B, H,
Skv, hd), any strides with a unit last axis; out (B, H, Sq, hd) in q's
dtype; lse (B, H, Sq) f32 base 2. Causal (Sq == Skv), sliding-window
(causal only) or full with Sq != Skv. Its forward launches K5 and its
backward K6 (dq) and K7 (dk, dv) of `csrc/flash_attention.cu`, which take
lse and delta = rowsum(dO.O) as inputs (ring attention feeds its own).

Both ops are differentiable. CUDA tensors launch the kernels or raise:
head dims 64 and 128, f32 and bf16; other head dims and f16 raise
`NotImplementedError` (ROADMAP.md queue 1 item 6). CPU tensors take the
plain versions below, which use the kernels' own math (exp2 domain, `p`
and `ds` rounded to the input dtype before their products) and keep every
sum in f32. There is no in-kernel dropout yet; the model refuses dropout
on both flash paths.
"""

from __future__ import annotations

import ctypes
import math

import torch

LOG2E = 1.4426950408889634
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_G = 8


def _qkv_geometry(qkv, n_head, n_kv_head):
    """(B, S, W, KV, hd) of a packed qkv tensor; raises when W does not
    factor into the heads."""
    B, S, W = qkv.shape
    KV = n_kv_head or n_head
    hd = W // (n_head + 2 * KV)
    if hd * (n_head + 2 * KV) != W:
        raise ValueError(f"packed width {W} does not factor into "
                         f"H={n_head}, KV={KV} heads")
    return B, S, W, KV, hd


def _scale(scale, hd):
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def reference_attention(q, k, v, causal: bool = True, scale=None,
                        window: int = 0):
    """Composite oracle on (B, H, S, hd) q/k/v: f32 scores, softmax cast to
    q's dtype, f32 PV, result in q's dtype (JAX's `reference_attention`)."""
    s = _scale(scale, q.shape[-1])
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * s
    if causal:
        S = q.shape[2]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        if window:
            mask &= ~torch.ones(S, S, dtype=torch.bool,
                                device=q.device).tril(-window)
        att = att.masked_fill(~mask, NEG_INF)
    att = torch.softmax(att, -1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att.float(),
                        v.float()).to(q.dtype)


def _unpack(qkv, n_head, n_kv_head):
    """q (B, KV, G, S, hd), k/v (B, KV, S, hd): views of the packed
    tensor."""
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    G = n_head // KV
    parts = qkv.reshape(B, S, KV, G + 2, hd)
    return (parts[:, :, :, :G].permute(0, 2, 3, 1, 4),
            parts[:, :, :, G].permute(0, 2, 1, 3),
            parts[:, :, :, G + 1].permute(0, 2, 1, 3))


def _scores(q, k, scale, causal):
    """Masked exp2-domain scores (B, KV, G, S, S) in f32."""
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float())
    s = s * (scale * LOG2E)
    if causal:
        S = q.shape[3]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_qkv_fwd_reference(qkv, n_head: int, n_kv_head: int = 0,
                                      causal: bool = True, scale=None,
                                      fast_softmax: bool = False):
    """Plain version of K1: (out (B, S, H*hd) in qkv's dtype, lse (B, H, S)
    f32 base 2). Runs on any device."""
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    q, k, v = _unpack(qkv, n_head, n_kv_head)
    s = _scores(q, k, _scale(scale, hd), causal)
    if fast_softmax:
        m = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    else:
        m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(qkv.dtype).float(), v.float())
    o = o / l[..., None]
    out = o.to(qkv.dtype).permute(0, 3, 1, 2, 4).reshape(B, S, n_head * hd)
    lse = (m + torch.log2(l)).reshape(B, n_head, S)
    return out, lse


def flash_attention_qkv_bwd_reference(qkv, out, lse, do, n_head: int,
                                      n_kv_head: int = 0, causal: bool = True,
                                      scale=None):
    """Plain version of K2: d_qkv (B, S, W) in qkv's dtype, with the
    kernels' math: delta = rowsum(dO.O), p = exp2(s - lse),
    ds = p (dp - delta) scale. Runs on any device."""
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    G = n_head // KV
    sc = _scale(scale, hd)
    q, k, v = _unpack(qkv, n_head, n_kv_head)
    dt = qkv.dtype
    # head-major (B, S, H*hd) -> (B, KV, G, S, hd)
    def heads(t):
        return t.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)

    do_h, o_h = heads(do).float(), heads(out).float()
    delta = (do_h * o_h).sum(-1)                              # (B,KV,G,S)
    p = torch.exp2(_scores(q, k, sc, causal)
                   - lse.reshape(B, KV, G, S)[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", do_h, v.float())
    ds = (p * (dp - delta[..., None]) * sc).to(dt).float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(dt).float(), do_h)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.float())
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    d_qkv = torch.cat([dq.permute(0, 3, 1, 2, 4),
                       dk.permute(0, 2, 1, 3)[:, :, :, None],
                       dv.permute(0, 2, 1, 3)[:, :, :, None]], dim=3)
    return d_qkv.reshape(B, S, W).to(dt)


def _split_geometry(q, k, v, causal, window):
    """(B, H, Sq, Skv, hd) of split-layout q (B, H, Sq, hd), k and v (B, H,
    Skv, hd); raises the JAX wrapper's errors on what the kernels do not
    compute."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"want q (B, H, Sq, hd) and k, v (B, H, Skv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    if causal and Skv != Sq:
        raise ValueError("causal attention requires matching q/kv lengths")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    return B, H, Sq, Skv, hd


def _band_scores(q, k, scale, causal, window):
    """Masked exp2-domain scores (B, H, Sq, Skv) in f32: keys col <= row
    and row - col < window."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (scale * LOG2E)
    if causal:
        Sq, Skv = s.shape[2:]
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        keep = cols <= rows
        if window:
            keep &= rows - cols < window
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_fwd_reference(q, k, v, causal: bool = True, scale=None,
                                  window: int = 0):
    """Plain version of K5: (out (B, H, Sq, hd) in q's dtype, lse (B, H,
    Sq) f32 base 2). Runs on any device."""
    _split_geometry(q, k, v, causal, window)
    s = _band_scores(q, k, _scale(scale, q.shape[-1]), causal, window)
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return (o / l[..., None]).to(q.dtype), m + torch.log2(l)


def flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                  causal: bool = True, scale=None,
                                  window: int = 0):
    """Plain version of K6 and K7: (dq, dk, dv) in q's dtype from the
    saved lse and delta = rowsum(dO.O), both (B, H, Sq) f32, with the
    kernels' math: p = exp2(min(s - lse, 0)), ds = p (dp - delta) scale.
    Runs on any device."""
    _split_geometry(q, k, v, causal, window)
    sc = _scale(scale, q.shape[-1])
    dt = q.dtype
    s = _band_scores(q, k, sc, causal, window)
    p = torch.exp2(torch.clamp(s - lse[..., None], max=0.0))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * sc).to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# --------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)


def _check(qkv, n_head, n_kv_head, *others):
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors; qkv is on {dev}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        f"({', '.join(map(str, _DTYPES))})")
    if qkv.dim() != 3:
        raise ValueError(f"want qkv (B, S, W), got {tuple(qkv.shape)}")
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    if n_head % KV:
        raise ValueError(f"kv heads {KV} do not divide heads {n_head}")
    G = n_head // KV
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernels "
                         f"{_HEAD_DIMS}")
    if not 1 <= G <= _MAX_G:
        raise ValueError(f"query group size {G} outside 1..{_MAX_G}")
    if not 1 <= B <= 65535 or S < 1:
        raise ValueError(f"batch {B} outside 1..65535 or empty sequence")
    for name, t, dtype, shape in others:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qkv on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {shape}")
    for name, t, *_ in (("qkv", qkv), *others):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, W, KV, hd


def _launch(fn, name, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_operands(qkv, out, lse, do, n_head, n_kv_head):
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    o_shape = (B, S, n_head * hd)
    return _check(qkv, n_head, n_kv_head,
                  ("out", out, qkv.dtype, o_shape),
                  ("lse", lse, torch.float32, (B, n_head, S)),
                  ("do", do, qkv.dtype, o_shape))


def flash_fwd_qkv(qkv, n_head, n_kv_head=0, causal=True, scale=None,
                  fast_softmax=False):
    """K1 on the card: (out, lse). Adds one to `flash_fwd_qkv.launches`."""
    B, S, W, KV, hd = _check(qkv, n_head, n_kv_head)
    from .._build import load_library

    lib = load_library()
    out = torch.empty((B, S, n_head * hd), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((B, n_head, S), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch(lib.nk_flash_fwd_qkv, "flash_fwd_qkv", _DTYPES[qkv.dtype],
                qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S, n_head,
                KV, hd, _scale(scale, hd), int(causal), int(fast_softmax),
                _stream(qkv))
    flash_fwd_qkv.launches += 1
    return out, lse


def _bwd_stats(qkv, n_head):
    """bf16: the backward's (lse, delta) scratch, (B, H, S padded to 64, 2)
    f32, which its pre-pass fills; f32 needs none (None)."""
    if qkv.dtype != torch.bfloat16:
        return None
    B, S = qkv.shape[:2]
    return torch.empty((B, n_head, -(-S // 64) * 64, 2), dtype=torch.float32,
                       device=qkv.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_bwd_stats_qkv(qkv, out, lse, do, n_head, n_kv_head=0):
    """The bf16 backward's pre-pass, (lse, rowsum(dO.O)) per row into a
    new (B, H, S padded to 64, 2) f32 tensor, which K2a and K2b take as
    `stats` so that a split backward runs it once; None in f32, whose
    kernels compute their own."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    stats = _bwd_stats(qkv, n_head)
    if stats is not None:
        from .._build import load_library

        with torch.cuda.device(qkv.device):
            _launch(load_library().nk_flash_bwd_stats_qkv,
                    "flash_bwd_stats_qkv", _DTYPES[qkv.dtype], out.data_ptr(),
                    lse.data_ptr(), do.data_ptr(), stats.data_ptr(), B, S,
                    n_head, hd, _stream(qkv))
    return stats


def _split_bwd(entry, name, qkv, out, lse, do, d_qkv, n_head, n_kv_head,
               causal, scale, stats):
    """Launch K2a or K2b (`entry`) into `d_qkv`; bf16 runs the pre-pass
    itself unless given `stats` from `flash_bwd_stats_qkv`."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    _check(qkv, n_head, n_kv_head, ("d_qkv", d_qkv, qkv.dtype, (B, S, W)))
    have = stats is not None
    if have:
        _check(qkv, n_head, n_kv_head,
               ("stats", stats, torch.float32,
                (B, n_head, -(-S // 64) * 64, 2)))
    else:
        stats = _bwd_stats(qkv, n_head)
    from .._build import load_library

    with torch.cuda.device(qkv.device):
        _launch(getattr(load_library(), entry), name, _DTYPES[qkv.dtype],
                qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                _ptr(stats), int(have), d_qkv.data_ptr(), B, S, n_head, KV,
                hd, _scale(scale, hd), int(causal), _stream(qkv))
    return d_qkv


def flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                     causal=True, scale=None, stats=None):
    """K2a on the card: writes the q chunks of `d_qkv` (B, S, W). `stats`:
    the pre-pass's result (bf16), or None to run it here. Adds one to
    `flash_bwd_dq_qkv.launches`."""
    _split_bwd("nk_flash_bwd_dq_qkv", "flash_bwd_dq_qkv", qkv, out, lse, do,
               d_qkv, n_head, n_kv_head, causal, scale, stats)
    flash_bwd_dq_qkv.launches += 1
    return d_qkv


def flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                      causal=True, scale=None, stats=None):
    """K2b on the card: writes the k and v chunks of `d_qkv`. `stats` as
    for `flash_bwd_dq_qkv`. Adds one to `flash_bwd_dkv_qkv.launches`."""
    _split_bwd("nk_flash_bwd_dkv_qkv", "flash_bwd_dkv_qkv", qkv, out, lse,
               do, d_qkv, n_head, n_kv_head, causal, scale, stats)
    flash_bwd_dkv_qkv.launches += 1
    return d_qkv


def flash_bwd_fused_qkv(qkv, out, lse, do, n_head, n_kv_head=0, causal=True,
                        scale=None):
    """K2c/K2d on the card: all of d_qkv (B, S, W) from one walk. The k
    tiles add their dq terms in a fixed order (turn counters), so the
    result is the same bits from run to run, in f32 and in bf16. Adds one
    to `flash_bwd_fused_qkv.launches`."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    from .._build import load_library

    d_qkv = torch.empty_like(qkv)
    stats = _bwd_stats(qkv, n_head)
    if stats is None:   # f32: 32-row q tiles, dq rows as in d_qkv
        dq_acc = torch.empty((B, S, n_head * hd), dtype=torch.float32,
                             device=qkv.device)
        n_qt = -(-S // 32)
    else:   # q-tile-major, rows padded by 8 (csrc/flash_attention_qkv.cu)
        n_qt = -(-S // 64)
        dq_acc = torch.empty((B, n_head, n_qt, 64, hd + 8),
                             dtype=torch.float32, device=qkv.device)
    turn = torch.zeros((B, n_head, n_qt), dtype=torch.int32,
                       device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch(load_library().nk_flash_bwd_fused_qkv,
                "flash_bwd_fused_qkv", _DTYPES[qkv.dtype], qkv.data_ptr(),
                out.data_ptr(), lse.data_ptr(), do.data_ptr(), _ptr(stats),
                dq_acc.data_ptr(), _ptr(turn), d_qkv.data_ptr(), B, S,
                n_head, KV, hd, _scale(scale, hd), int(causal), _stream(qkv))
    flash_bwd_fused_qkv.launches += 1
    return d_qkv


for _fn in (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
            flash_bwd_fused_qkv):
    _fn.launches = 0

KERNELS = (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
           flash_bwd_fused_qkv)


def _split_operands(q, k, v, causal, window, *grads):
    """Checks of the split-layout kernels. Returns (B, H, Sq, Skv, hd) and
    q, k, v (then do) with their last axis unit-strided and their base and
    strides 16-byte aligned (a copy of any that is not)."""
    B, H, Sq, Skv, hd = _split_geometry(q, k, v, causal, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors; q is on {dev}")
    _kernel_dtype_and_hd(q.dtype, hd)
    if not 1 <= B <= 65535 or not 1 <= H <= 65535 or min(Sq, Skv) < 1:
        raise ValueError(f"batch {B} or heads {H} outside 1..65535, or an "
                         f"empty sequence")
    ts = (q, k, v) + grads
    for t in ts[1:]:
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"operands on {t.device} {t.dtype}, q on {dev} "
                             f"{q.dtype}")
    return (B, H, Sq, Skv, hd), tuple(_aligned(t) for t in ts)


def _kernel_dtype_and_hd(dtype, hd):
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"{dtype} on the split flash kernels is not ported (f32 and "
            f"bf16 only; ROADMAP.md queue 1 item 6)")
    if hd not in _HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {hd} on the split flash kernels is not ported "
            f"({_HEAD_DIMS}; ROADMAP.md queue 1 item 6)")


def _aligned(t):
    """t itself if the kernels can read it through its strides, else a
    contiguous copy."""
    unit = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % unit == 0 for st in t.stride()[:-1]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(*ts):
    """(batch, head, row) strides of each tensor, as one C array."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows(name, t, shape, dev):
    """lse or delta: f32 (B, H, Sq), contiguous, on `dev`."""
    if t.device != dev or t.dtype != torch.float32 \
            or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want f32 {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def flash_fwd(q, k, v, causal=True, scale=None, window=0):
    """K5 on the card: (out (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) f32
    base 2). Adds one to `flash_fwd.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v) = _split_operands(q, k, v, causal,
                                                     window)
    from .._build import load_library

    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_fwd, "flash_fwd", _DTYPES[q.dtype],
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _strides(q, k, v), B, H, Sq, Skv, hd,
                _scale(scale, hd), int(causal), int(window), _stream(q))
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=None,
                 window=0):
    """K6 on the card: dq (B, H, Sq, hd) from the saved lse and delta (B,
    H, Sq) f32. Adds one to `flash_bwd_dq.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v, do) = _split_operands(
        q, k, v, causal, window, do)
    lse, delta = (_rows(n, t, (B, H, Sq), q.device)
                  for n, t in (("lse", lse), ("delta", delta)))
    from .._build import load_library

    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_bwd_dq, "flash_bwd_dq",
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), _strides(q, k, v, do), B, H, Sq, Skv, hd,
                _scale(scale, hd), int(causal), int(window), _stream(q))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=None,
                  window=0):
    """K7 on the card: (dk, dv), each (B, H, Skv, hd), from the saved lse
    and delta (B, H, Sq) f32. Adds one to `flash_bwd_dkv.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v, do) = _split_operands(
        q, k, v, causal, window, do)
    lse, delta = (_rows(n, t, (B, H, Sq), q.device)
                  for n, t in (("lse", lse), ("delta", delta)))
    from .._build import load_library

    dk = torch.empty((B, H, Skv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_bwd_dkv, "flash_bwd_dkv",
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do), B, H,
                Sq, Skv, hd, _scale(scale, hd), int(causal), int(window),
                _stream(q))
    flash_bwd_dkv.launches += 1
    return dk, dv


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = 0

SPLIT_KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


# --------------------------------------------------------------------------
# the differentiable op


def _on_cpu(*ts):
    if all(t.device.type == "cpu" for t in ts):
        return True
    if any(t.device.type == "cpu" for t in ts):
        raise ValueError("flash attention operands are split between the "
                         "CPU and another device")
    return False


class FlashAttentionQKV(torch.autograd.Function):
    """out = attention(qkv); saves (qkv, out, lse). Forward: K1 on CUDA
    tensors, the plain forward on CPU tensors. Backward: the split K2a +
    K2b pair, or the fused kernel with `fused_bwd`; the plain backward on
    CPU tensors."""

    @staticmethod
    def forward(ctx, qkv, n_head, n_kv_head, causal, scale, fast_softmax,
                fused_bwd):
        if _on_cpu(qkv):
            out, lse = flash_attention_qkv_fwd_reference(
                qkv, n_head, n_kv_head, causal, scale, fast_softmax)
        else:
            out, lse = flash_fwd_qkv(qkv, n_head, n_kv_head, causal, scale,
                                     fast_softmax)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (n_head, n_kv_head, causal, scale, fused_bwd)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        n_head, n_kv_head, causal, scale, fused_bwd = ctx.args
        do = do.contiguous()
        if _on_cpu(qkv, do):
            d_qkv = flash_attention_qkv_bwd_reference(
                qkv, out, lse, do, n_head, n_kv_head, causal, scale)
        elif fused_bwd:
            d_qkv = flash_bwd_fused_qkv(qkv, out, lse, do, n_head,
                                        n_kv_head, causal, scale)
        else:   # one pre-pass for both kernels
            d_qkv = torch.empty_like(qkv)
            stats = flash_bwd_stats_qkv(qkv, out, lse, do, n_head, n_kv_head)
            flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                             causal, scale, stats)
            flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                              causal, scale, stats)
        return d_qkv, None, None, None, None, None, None


def flash_attention_qkv(qkv, n_head: int, n_kv_head: int = 0,
                        causal: bool = True, scale=None, block_q: int = 256,
                        block_k: int = 256, fast_softmax: bool = False,
                        fused_bwd: bool = False):
    """Layout-native flash attention on the packed qkv projection (see the
    module docstring): (B, S, W) -> (B, S, H*hd) head-major, differentiable.

    `block_q`/`block_k` are accepted for signature parity with the JAX
    function, where they size the TPU's VMEM tiles; the CUDA kernels choose
    their own tiles and mask any ragged S, so both are ignored."""
    del block_q, block_k
    _qkv_geometry(qkv, n_head, n_kv_head)
    return FlashAttentionQKV.apply(qkv, n_head, n_kv_head, causal, scale,
                                   fast_softmax, fused_bwd)


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) in the split layout; saves (q, k, v, out,
    lse). Forward: K5 on CUDA tensors, the plain forward on CPU tensors.
    Backward: delta = rowsum(dO.O) in f32 by a plain reduction, then K6 and
    K7; the plain backward on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        if _on_cpu(q, k, v):
            out, lse = flash_attention_fwd_reference(q, k, v, causal, scale,
                                                     window)
        else:
            out, lse = flash_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window = ctx.args
        delta = (do.float() * out.float()).sum(-1)
        if _on_cpu(q, do):
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, do, lse, delta, causal, scale, window)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, window)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                   window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    block_q: int = 256, block_k: int = 256, window: int = 0):
    """q (B, H, Sq, hd), k and v (B, H, Skv, hd) -> (B, H, Sq, hd),
    differentiable: softmax(q.k^T scale) v with an optional causal mask and
    sliding `window` (each query sees its last `window` keys, itself
    included; causal only); the kernels skip tiles outside the band.

    `block_q`/`block_k` are accepted for signature parity with the JAX
    function, where they size the TPU's VMEM tiles; the CUDA kernels choose
    their own tiles and mask any ragged S, so both are ignored. A CUDA
    tensor the kernels cannot take raises `NotImplementedError`."""
    del block_q, block_k
    return FlashAttention.apply(q, k, v, causal, scale, window)
