"""Flash attention on the packed qkv projection, forward and backward
(counterpart of `flash_attention_qkv` in
`neuronika_tpu/ops/pallas/attention.py`).

Layout contract (kv-group-major, as `_unpack_qkv` in the models):
  qkv    (B, S, W), W = H*hd + 2*KV*hd: KV groups of (G+2) hd-wide chunks,
         group g = [q_{gG} ... q_{gG+G-1} | k_g | v_g], G = H // KV
  out    (B, S, H*hd) head-major, in qkv's dtype
  lse    (B, H, S) f32, base 2 (m + log2(l); m = 0 in "fast" mode), with
         no lane padding
  d_qkv  (B, S, W) in the packed layout

`flash_attention_qkv` is differentiable (`FlashAttentionQKV`). For CUDA
tensors its forward launches the K1 kernel and its backward the K2
kernels of `csrc/flash_attention_qkv.cu`: the split pair (dq, then dk/dv)
or, with `fused_bwd`, the fused kernel that stands for both of the TPU's
fused backwards. CPU tensors take the plain versions below, which use the
kernels' own math (exp2 domain, `p` and `ds` rounded to the input dtype
before their products) and keep every sum in f32.

There is no in-kernel dropout yet; the model refuses dropout on this path.
"""

from __future__ import annotations

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


def flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                     causal=True, scale=None):
    """K2a on the card: writes the q chunks of `d_qkv` (B, S, W). Adds one
    to `flash_bwd_dq_qkv.launches`."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    _check(qkv, n_head, n_kv_head, ("d_qkv", d_qkv, qkv.dtype, (B, S, W)))
    from .._build import load_library

    with torch.cuda.device(qkv.device):
        _launch(load_library().nk_flash_bwd_dq_qkv, "flash_bwd_dq_qkv",
                _DTYPES[qkv.dtype], qkv.data_ptr(), out.data_ptr(),
                lse.data_ptr(), do.data_ptr(), d_qkv.data_ptr(), B, S,
                n_head, KV, hd, _scale(scale, hd), int(causal), _stream(qkv))
    flash_bwd_dq_qkv.launches += 1
    return d_qkv


def flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                      causal=True, scale=None):
    """K2b on the card: writes the k and v chunks of `d_qkv`. Adds one to
    `flash_bwd_dkv_qkv.launches`."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    _check(qkv, n_head, n_kv_head, ("d_qkv", d_qkv, qkv.dtype, (B, S, W)))
    from .._build import load_library

    with torch.cuda.device(qkv.device):
        _launch(load_library().nk_flash_bwd_dkv_qkv, "flash_bwd_dkv_qkv",
                _DTYPES[qkv.dtype], qkv.data_ptr(), out.data_ptr(),
                lse.data_ptr(), do.data_ptr(), d_qkv.data_ptr(), B, S,
                n_head, KV, hd, _scale(scale, hd), int(causal), _stream(qkv))
    flash_bwd_dkv_qkv.launches += 1
    return d_qkv


def flash_bwd_fused_qkv(qkv, out, lse, do, n_head, n_kv_head=0, causal=True,
                        scale=None):
    """K2c/K2d on the card: all of d_qkv (B, S, W) from one walk. dq is
    summed with f32 atomics in a scratch buffer, so its last bits may
    change from run to run. Adds one to `flash_bwd_fused_qkv.launches`."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    from .._build import load_library

    d_qkv = torch.empty_like(qkv)
    dq_acc = torch.zeros((B, S, n_head * hd), dtype=torch.float32,
                         device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch(load_library().nk_flash_bwd_fused_qkv,
                "flash_bwd_fused_qkv", _DTYPES[qkv.dtype], qkv.data_ptr(),
                out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                dq_acc.data_ptr(), d_qkv.data_ptr(), B, S, n_head, KV, hd,
                _scale(scale, hd), int(causal), _stream(qkv))
    flash_bwd_fused_qkv.launches += 1
    return d_qkv


for _fn in (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
            flash_bwd_fused_qkv):
    _fn.launches = 0

KERNELS = (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
           flash_bwd_fused_qkv)


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
        else:
            d_qkv = torch.empty_like(qkv)
            flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                             causal, scale)
            flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                              causal, scale)
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
