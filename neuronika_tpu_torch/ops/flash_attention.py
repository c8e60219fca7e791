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

The split layout (`flash_attention`, and `flash_attention_dropout`): q (B,
H, Sq, hd), k and v (B, H, Skv, hd), any strides with a unit last axis;
out (B, H, Sq, hd) in q's dtype; lse (B, H, Sq) f32 base 2. Causal (Sq ==
Skv), sliding-window (causal only) or full with Sq != Skv. Its forward
launches K5 and its backward K6 (dq) and K7 (dk, dv) of
`csrc/flash_attention.cu`, which take lse and delta = rowsum(dO.O) as
inputs (ring attention feeds its own).

Attention dropout runs inside every kernel (`csrc/dropout.cuh`): the keep
bit of (seed, batch, query head, row, col) is a word of Philox4x32-10 at
the absolute position, so the forward and every backward kernel
regenerate the same mask whatever their tiles; `keep_mask` is its plain
twin, bit for bit. As in the TPU kernels, the softmax statistics stay
unmasked, the dropped p are zeroed before P V and the output is scaled by
1 / (1 - rate); the backward drops dp and the p of dV the same way.

Both ops are differentiable. CUDA tensors launch the kernels or raise:
f32 and bf16, every head dim from 1 to 256 and any number of query heads
per kv head, as JAX's kernels take them; f16 and head dims above 256
raise `NotImplementedError` (ROADMAP.md queue 1 item 3). Two routes
(`_sm90_route`): bf16 at hd 64 or 128 runs the Hopper kernels (wgmma,
TMA) at any group size; past 8 query heads per kv head, K2b and the
fused backward split each group over a cluster of CTAs (`dkv_plan`,
`fused_plan`). Every other shape runs the mma.sync/FFMA kernels,
instantiated at head-dim tiers that mask the runtime hd. CPU tensors take
the plain versions below, which use the kernels' own math (exp2 domain,
`p` and `ds` rounded to the input dtype before their products) and keep
every sum in f32.

The forward launches go through two custom ops, `neuronika_tpu_torch::
flash_fwd_qkv` and `::flash_fwd` (`FWD_OPS`), which also take the plain
forward on CPU tensors: a selective-checkpoint policy sees them as ops, so
remat_policy "flash" can keep their (out, lse) and the backward does not
rerun K1 or K5 (models/transformer.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# the Hopper kernels' head dims (csrc/flash_attention_qkv.cu::sm90_takes)
_SM90_HEAD_DIMS = (64, 128)
# the cluster plans of K2b and the fused K2 (csrc/flash_sm90.cuh::kv_walk,
# CLUSTER): the most query heads per kv head an item runs on one CTA, k
# and q rows a tile, the cluster sizes the walk takes (the portable limit
# is 8) and the SMs of an H100 SXM, the plans' default card
DKV_ONE_CTA_MAX_G = 8
DKV_BN = 128
DKV_BQ = 64
DKV_CLUSTERS = (2, 4, 8)
H100_SMS = 132


def kernels_take(dtype, hd: int) -> bool:
    """True where the CUDA kernels take the dtype and head dim (any group
    size with H % KV == 0 and any S)."""
    return dtype in _DTYPES and 1 <= hd <= MAX_HEAD_DIM


def _sm90_route(dtype, hd: int) -> bool:
    """True where the Hopper kernels run (bf16, hd 64 or 128, any group
    size); else the mma.sync/FFMA kernels. The one place the route is
    chosen: it decides the scratch layouts and operand copies here and is
    passed to every launch as `sm90`, which the CUDA side dispatches on
    (and refuses where the Hopper kernels are not built)."""
    return dtype == torch.bfloat16 and hd in _SM90_HEAD_DIMS


def dkv_cluster(B: int, KV: int, S: int, G: int, sms: int = H100_SMS) -> int:
    """K2b's CTAs an item on the Hopper route: 1 up to 8 query heads per kv
    head; past that the least of 2 and 4 whose CTAs (items x C, an item
    being a 128-row k tile of one batch and kv head) fill two waves of
    `sms` SMs, else 8."""
    if G <= DKV_ONE_CTA_MAX_G:
        return 1
    items = -(-S // DKV_BN) * B * KV
    return next((c for c in DKV_CLUSTERS[:-1] if items * c >= 2 * sms),
                DKV_CLUSTERS[-1])


def dkv_plan(B: int, KV: int, S: int, G: int, sms: int = H100_SMS):
    """K2b's work on the Hopper route, as `kv_walk` takes it: (C, items),
    the items in the order the persistent grid starts them (k-tile-major,
    the longest causal walks first), each (kt, b, g, heads) with heads[r]
    = (h0, h1), the group's query heads [h0, h1) that CTA r of the item's
    cluster walks (relative to the group's first)."""
    C = dkv_cluster(B, KV, S, G, sms)
    heads = tuple((r * G // C, (r + 1) * G // C) for r in range(C))
    items = [(i // (B * KV), i % (B * KV) // KV, i % KV, heads)
             for i in range(-(-S // DKV_BN) * B * KV)]
    return C, items


def fused_cluster(B: int, KV: int, S: int, G: int,
                  sms: int = H100_SMS) -> int:
    """The fused K2's CTAs an item on the Hopper route: K2b's rule
    (`dkv_cluster`), as its items are K2b's."""
    return dkv_cluster(B, KV, S, G, sms)


def fused_plan(B: int, KV: int, S: int, G: int, causal: bool = True,
               sms: int = H100_SMS, clusters: Optional[int] = None):
    """The fused K2's work on the Hopper route, as `kv_walk` (FUSED) takes
    it: (C, items, deal). `items` in the kernel's item order ((b, g)-major,
    k tiles ascending), each (kt, b, g, walks): walks[r] the (head of the
    group, 64-row q tile) steps of CTA r of the item's cluster, in order.
    C 1 (up to 8 query heads a kv head): one walk, head-major, each head's
    q tiles from the last down. C > 1: CTA r takes the heads [r G / C, (r
    + 1) G / C), q-tile-major (every head of its share at the last q tile,
    then at the one before). `deal[c]`: the item indices persistent CTA
    (C 1) or cluster c takes, in order, when `clusters` of them are
    resident (default: `sms` // C, the most a card of `sms` SMs holds):
    round robin at C 1, item i on i % clusters; past that forth and back,
    the n-th row of `clusters` items dealt to clusters 0, 1, .. for even n
    and in reverse for odd n."""
    C = fused_cluster(B, KV, S, G, sms)
    R = clusters or sms // C
    n_kt, n_qt = -(-S // DKV_BN), -(-S // DKV_BQ)
    shares = [range(r * G // C, (r + 1) * G // C) for r in range(C)]
    items = []
    for b in range(B):
        for g in range(KV):
            for kt in range(n_kt):
                qts = range(n_qt - 1, kt * DKV_BN // DKV_BQ - 1 if causal
                            else -1, -1)
                walks = tuple(
                    tuple((m, qt) for m in heads for qt in qts) if C == 1
                    else tuple((m, qt) for qt in qts for m in heads)
                    for heads in shares)
                items.append((kt, b, g, walks))
    deal = [[] for _ in range(R)]
    for n in range(-(-len(items) // R)):
        for x in range(R):
            i = n * R + x
            if i < len(items):
                deal[R - 1 - x if C > 1 and n % 2 else x].append(i)
    return C, items, deal


def _route(fn, sm90: bool, cluster: int = 1) -> None:
    """Record the route of `fn`'s launch as `fn.route`: "sm90" (with its
    cluster size past 1) or "mma.sync"."""
    fn.route = ("sm90" if sm90 else "mma.sync") + \
        (f" cluster {cluster}" if cluster > 1 else "")


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


# --------------------------------------------------------------------------
# the dropout keep mask (csrc/dropout.cuh), bit for bit

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x):
    """(hi, lo) words of m * x for a u32 constant m and u32 values x in an
    int64 tensor, from 16-bit limbs of m so that no product leaves int64."""
    t = (m & 0xFFFF) * x                    # < 2^48
    u = (m >> 16) * x + (t >> 16)           # < 2^49; m x = 2^16 u + t % 2^16
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters (c0, c1, c2, c3), u32 values in int64
    tensors (broadcast together), under key (k0, k1): the four words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """An entry is dropped when its word is below this (`_tile_keep_mask`'s
    threshold: keep with probability 1 - rate)."""
    return min(int(rate * 4294967296.0), _M32)


def keep_mask(seed: int, B: int, H: int, Sq: int, Skv: int, rate: float,
              device="cpu"):
    """bool (B, H, Sq, Skv): True where attention dropout at `rate` keeps
    the probability of (batch b, query head h, row, col) under `seed`, the
    same bits as the kernels draw. The word of (row, col) is word 2 (row %
    2) + col % 2 of Philox4x32-10 at counter (col // 2, row // 2, h, b),
    keyed by the seed's low and high 32 bits; keep <=> word >=
    `dropout_threshold(rate)`. A "meta" device needs no draws."""
    if torch.device(device).type == "meta":
        return torch.ones((B, H, Sq, Skv), dtype=torch.bool, device=device)
    if rate >= 1.0:
        return torch.zeros((B, H, Sq, Skv), dtype=torch.bool, device=device)
    seed = int(seed) & ((1 << 64) - 1)
    k0, k1 = seed & _M32, seed >> 32
    thr = dropout_threshold(rate)
    R, C = -(-Sq // 2), -(-Skv // 2)
    i64 = dict(dtype=torch.int64, device=device)
    cols = torch.arange(C, **i64)
    heads = torch.arange(H, **i64)[:, None, None]
    out = torch.empty((B, H, 2 * R, 2 * C), dtype=torch.bool, device=device)
    step = max(1, (1 << 22) // (H * C))     # block rows a chunk
    for b in range(B):
        for r0 in range(0, R, step):
            rows = torch.arange(r0, min(R, r0 + step), **i64)[:, None]
            w = philox4x32_10(cols, rows, heads, torch.tensor(b, **i64), k0,
                              k1)
            w = [t.expand(H, rows.shape[0], C) >= thr for t in w]
            out[b, :, 2 * r0:2 * r0 + 2 * rows.shape[0]] = torch.stack(
                [torch.stack(w[:2], -1), torch.stack(w[2:], -1)], 2
            ).reshape(H, 2 * rows.shape[0], 2 * C)
    return out[:, :, :Sq, :Skv]


def _inv_keep(rate: float) -> float:
    """1 / (1 - rate) as the kernels take it (an f32)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _dropped(t, keep, rate):
    """keep ? t / (1 - rate) : 0, as the kernels drop p and dp."""
    return torch.where(keep, t * _inv_keep(rate), 0.0)


def _normalised(o, l, rate):
    """The forward's o / l, scaled by 1 / (1 - rate) under dropout."""
    if rate == 0.0:
        return o / l[..., None]
    return o * (_inv_keep(rate) / l[..., None])


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


def _check_rate(rate):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")


def flash_attention_qkv_fwd_reference(qkv, n_head: int, n_kv_head: int = 0,
                                      causal: bool = True, scale=None,
                                      fast_softmax: bool = False,
                                      seed: int = 0, rate: float = 0.0):
    """Plain version of K1: (out (B, S, H*hd) in qkv's dtype, lse (B, H, S)
    f32 base 2). With `rate` > 0, attention dropout by `keep_mask(seed,
    ...)`: l and lse unmasked, the dropped p zeroed before P V, the output
    scaled by 1 / (1 - rate). Runs on any device."""
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    _check_rate(rate)
    q, k, v = _unpack(qkv, n_head, n_kv_head)
    s = _scores(q, k, _scale(scale, hd), causal)
    if fast_softmax:
        m = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    else:
        m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    if rate > 0.0:
        keep = keep_mask(seed, B, n_head, S, S, rate, qkv.device)
        p = p.masked_fill(~keep.view(B, KV, n_head // KV, S, S), 0.0)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(qkv.dtype).float(), v.float())
    o = _normalised(o, l, rate)
    out = o.to(qkv.dtype).permute(0, 3, 1, 2, 4).reshape(B, S, n_head * hd)
    lse = (m + torch.log2(l)).reshape(B, n_head, S)
    return out, lse


def flash_attention_qkv_bwd_reference(qkv, out, lse, do, n_head: int,
                                      n_kv_head: int = 0, causal: bool = True,
                                      scale=None, seed: int = 0,
                                      rate: float = 0.0):
    """Plain version of K2: d_qkv (B, S, W) in qkv's dtype, with the
    kernels' math: delta = rowsum(dO.O), p = exp2(s - lse),
    ds = p (dp - delta) scale; with `rate` > 0, dp and the p of dV dropped
    by `keep_mask(seed, ...)` and scaled by 1 / (1 - rate). Runs on any
    device."""
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    _check_rate(rate)
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
    pv = p      # the p of dV
    if rate > 0.0:
        keep = keep_mask(seed, B, n_head, S, S, rate, qkv.device).view(
            B, KV, G, S, S)
        pv, dp = _dropped(p, keep, rate), _dropped(dp, keep, rate)
    ds = (p * (dp - delta[..., None]) * sc).to(dt).float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", pv.to(dt).float(), do_h)
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
                                  window: int = 0, seed: int = 0,
                                  rate: float = 0.0):
    """Plain version of K5: (out (B, H, Sq, hd) in q's dtype, lse (B, H,
    Sq) f32 base 2); dropout as in `flash_attention_qkv_fwd_reference`.
    Runs on any device."""
    B, H, Sq, Skv, _ = _split_geometry(q, k, v, causal, window)
    _check_rate(rate)
    s = _band_scores(q, k, _scale(scale, q.shape[-1]), causal, window)
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    if rate > 0.0:
        p = p.masked_fill(~keep_mask(seed, B, H, Sq, Skv, rate, q.device),
                          0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return _normalised(o, l, rate).to(q.dtype), m + torch.log2(l)


def flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                  causal: bool = True, scale=None,
                                  window: int = 0, seed: int = 0,
                                  rate: float = 0.0):
    """Plain version of K6 and K7: (dq, dk, dv) in q's dtype from the
    saved lse and delta = rowsum(dO.O), both (B, H, Sq) f32, with the
    kernels' math: p = exp2(min(s - lse, 0)), ds = p (dp - delta) scale;
    dropout as in `flash_attention_qkv_bwd_reference`. Runs on any
    device."""
    B, H, Sq, Skv, _ = _split_geometry(q, k, v, causal, window)
    _check_rate(rate)
    sc = _scale(scale, q.shape[-1])
    dt = q.dtype
    s = _band_scores(q, k, sc, causal, window)
    p = torch.exp2(torch.clamp(s - lse[..., None], max=0.0))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    pv = p      # the p of dV
    if rate > 0.0:
        keep = keep_mask(seed, B, H, Sq, Skv, rate, q.device)
        pv, dp = _dropped(p, keep, rate), _dropped(dp, keep, rate)
    ds = (p * (dp - delta[..., None]) * sc).to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", pv.to(dt).float(), do.float())
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernels' 1.."
                         f"{MAX_HEAD_DIM}")
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


def _drop(seed, rate):
    """The dropout arguments of every flash entry point: (seed as a u64,
    threshold, inv_keep); threshold 0 runs the kernels without dropout."""
    _check_rate(rate)
    if rate == 0.0:
        return 0, 0, 1.0
    return int(seed) & ((1 << 64) - 1), dropout_threshold(rate), \
        _inv_keep(rate)


def _bwd_operands(qkv, out, lse, do, n_head, n_kv_head):
    B, S, W, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    o_shape = (B, S, n_head * hd)
    return _check(qkv, n_head, n_kv_head,
                  ("out", out, qkv.dtype, o_shape),
                  ("lse", lse, torch.float32, (B, n_head, S)),
                  ("do", do, qkv.dtype, o_shape))


def flash_fwd_qkv(qkv, n_head, n_kv_head=0, causal=True, scale=None,
                  fast_softmax=False, seed=0, rate=0.0):
    """K1 on the card: (out, lse), with attention dropout at `rate` drawn
    from `seed` (`keep_mask`). Adds one to `flash_fwd_qkv.launches`."""
    B, S, W, KV, hd = _check(qkv, n_head, n_kv_head)
    drop = _drop(seed, rate)
    from .._build import load_library

    lib = load_library()
    out = torch.empty((B, S, n_head * hd), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((B, n_head, S), dtype=torch.float32, device=qkv.device)
    sm90 = _sm90_route(qkv.dtype, hd)
    with torch.cuda.device(qkv.device):
        _launch(lib.nk_flash_fwd_qkv, "flash_fwd_qkv", _DTYPES[qkv.dtype],
                int(sm90), qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B, S, n_head, KV, hd, _scale(scale, hd), int(causal),
                int(fast_softmax), *drop, _stream(qkv))
    flash_fwd_qkv.launches += 1
    _route(flash_fwd_qkv, sm90)
    return out, lse


def _bwd_stats(qkv, n_head, n_kv_head):
    """The Hopper route's backward (lse, delta) scratch, (B, H, S padded to
    64, 2) f32, which its pre-pass fills; the other route needs none
    (None)."""
    B, S, _, KV, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    if not _sm90_route(qkv.dtype, hd):
        return None
    return torch.empty((B, n_head, -(-S // 64) * 64, 2), dtype=torch.float32,
                       device=qkv.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_bwd_stats_qkv(qkv, out, lse, do, n_head, n_kv_head=0):
    """The Hopper route's backward pre-pass, (lse, rowsum(dO.O)) per row
    into a new (B, H, S padded to 64, 2) f32 tensor, which K2a and K2b take
    as `stats` so that a split backward runs it once; None on the other
    route, whose kernels compute their own."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    stats = _bwd_stats(qkv, n_head, n_kv_head)
    if stats is not None:
        from .._build import load_library

        with torch.cuda.device(qkv.device):
            _launch(load_library().nk_flash_bwd_stats_qkv,
                    "flash_bwd_stats_qkv", _DTYPES[qkv.dtype], out.data_ptr(),
                    lse.data_ptr(), do.data_ptr(), stats.data_ptr(), B, S,
                    n_head, hd, _stream(qkv))
    return stats


def _split_bwd(fn, qkv, out, lse, do, d_qkv, n_head, n_kv_head, causal,
               scale, stats, seed, rate):
    """Launch K2a or K2b (the C entry `nk_` + the name of wrapper `fn`)
    into `d_qkv`; the Hopper route runs the pre-pass itself unless given
    `stats` from `flash_bwd_stats_qkv`. K2b passes its cluster size
    (`dkv_cluster`; 1 off the Hopper route). Records the route."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    drop = _drop(seed, rate)
    _check(qkv, n_head, n_kv_head, ("d_qkv", d_qkv, qkv.dtype, (B, S, W)))
    have = stats is not None
    if have:
        _check(qkv, n_head, n_kv_head,
               ("stats", stats, torch.float32,
                (B, n_head, -(-S // 64) * 64, 2)))
    else:
        stats = _bwd_stats(qkv, n_head, n_kv_head)
    from .._build import load_library

    G = n_head // KV
    sm90 = _sm90_route(qkv.dtype, hd)
    cluster = []
    if fn is flash_bwd_dkv_qkv:
        sms = torch.cuda.get_device_properties(
            qkv.device).multi_processor_count
        cluster = [dkv_cluster(B, KV, S, G, sms) if sm90 else 1]
    with torch.cuda.device(qkv.device):
        _launch(getattr(load_library(), f"nk_{fn.__name__}"), fn.__name__,
                _DTYPES[qkv.dtype], int(sm90), qkv.data_ptr(),
                out.data_ptr(), lse.data_ptr(), do.data_ptr(), _ptr(stats),
                int(have), d_qkv.data_ptr(), B, S, n_head, KV, hd,
                _scale(scale, hd), int(causal), *drop, *cluster,
                _stream(qkv))
    _route(fn, sm90, *cluster)
    return d_qkv


def flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                     causal=True, scale=None, stats=None, seed=0, rate=0.0):
    """K2a on the card: writes the q chunks of `d_qkv` (B, S, W). `stats`:
    the pre-pass's result (the Hopper route), or None to run it here (or
    where the route needs none); `seed`, `rate`:
    the forward's dropout. Adds one to `flash_bwd_dq_qkv.launches`."""
    _split_bwd(flash_bwd_dq_qkv, qkv, out, lse, do, d_qkv, n_head, n_kv_head,
               causal, scale, stats, seed, rate)
    flash_bwd_dq_qkv.launches += 1
    return d_qkv


def flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head=0,
                      causal=True, scale=None, stats=None, seed=0, rate=0.0):
    """K2b on the card: writes the k and v chunks of `d_qkv`. `stats`,
    `seed` and `rate` as for `flash_bwd_dq_qkv`. Adds one to
    `flash_bwd_dkv_qkv.launches`."""
    _split_bwd(flash_bwd_dkv_qkv, qkv, out, lse, do, d_qkv, n_head,
               n_kv_head, causal, scale, stats, seed, rate)
    flash_bwd_dkv_qkv.launches += 1
    return d_qkv


def flash_bwd_fused_qkv(qkv, out, lse, do, n_head, n_kv_head=0, causal=True,
                        scale=None, seed=0, rate=0.0):
    """K2c/K2d on the card: all of d_qkv (B, S, W) from one walk, with the
    forward's dropout (`seed`, `rate`); on the Hopper route past 8 query
    heads a kv head each item runs on a cluster (`fused_plan`). The k
    tiles add their dq terms in a fixed order (turn counters), so the
    result is the same bits from run to run, in f32 and in bf16. Adds one
    to `flash_bwd_fused_qkv.launches`; records the route."""
    B, S, W, KV, hd = _bwd_operands(qkv, out, lse, do, n_head, n_kv_head)
    drop = _drop(seed, rate)
    from .._build import load_library

    d_qkv = torch.empty_like(qkv)
    stats = _bwd_stats(qkv, n_head, n_kv_head)
    if stats is None:   # mma.sync/FFMA: 32-row q tiles, dq rows as in d_qkv
        dq_acc = torch.empty((B, S, n_head * hd), dtype=torch.float32,
                             device=qkv.device)
        n_qt = -(-S // 32)
    else:   # q-tile-major, rows padded by 8 (csrc/flash_attention_qkv.cu)
        n_qt = -(-S // 64)
        dq_acc = torch.empty((B, n_head, n_qt, 64, hd + 8),
                             dtype=torch.float32, device=qkv.device)
    turn = torch.zeros((B, n_head, n_qt), dtype=torch.int32,
                       device=qkv.device)
    sm90 = stats is not None
    cluster = 1
    if sm90:
        cluster = fused_cluster(B, KV, S, n_head // KV,
                                torch.cuda.get_device_properties(
                                    qkv.device).multi_processor_count)
    with torch.cuda.device(qkv.device):
        _launch(load_library().nk_flash_bwd_fused_qkv,
                "flash_bwd_fused_qkv", _DTYPES[qkv.dtype], int(sm90),
                qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                do.data_ptr(), _ptr(stats), dq_acc.data_ptr(), _ptr(turn),
                d_qkv.data_ptr(), B, S, n_head, KV, hd, _scale(scale, hd),
                int(causal), *drop, cluster, _stream(qkv))
    flash_bwd_fused_qkv.launches += 1
    _route(flash_bwd_fused_qkv, sm90, cluster)
    return d_qkv


for _fn in (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
            flash_bwd_fused_qkv):
    _fn.launches = 0
    _fn.route = None

KERNELS = (flash_fwd_qkv, flash_bwd_dq_qkv, flash_bwd_dkv_qkv,
           flash_bwd_fused_qkv)


def _split_operands(q, k, v, causal, window, *grads):
    """Checks of the split-layout kernels. Returns (B, H, Sq, Skv, hd) and
    q, k, v (then do) as the route reads them (`_aligned`: a copy of any
    that it cannot)."""
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
    sm90 = _sm90_route(q.dtype, hd)
    return (B, H, Sq, Skv, hd), tuple(_aligned(t, sm90) for t in ts)


def _kernel_dtype_and_hd(dtype, hd):
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"{dtype} on the split flash kernels is not ported (f32 and "
            f"bf16 only; ROADMAP.md queue 1 item 3)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head dim {hd} on the split flash kernels is not ported "
            f"(1..{MAX_HEAD_DIM}; ROADMAP.md queue 1 item 3)")


def _aligned(t, sm90=True):
    """t itself if the kernels can read it through its strides, else a
    contiguous copy. Every route wants a unit last axis and no stride 0 on
    an axis longer than 1; the Hopper route (`sm90`) also a 16-byte base
    and strides, which its TMA maps need (the other route reads elements
    where rows are not aligned)."""
    unit = 16 // t.element_size() if sm90 else 1
    ok = (t.stride(-1) == 1 and t.data_ptr() % (16 if sm90 else 1) == 0
          and all(st % unit == 0 and (st or n == 1)
                  for st, n in zip(t.stride()[:-1], t.shape[:-1])))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


# the bf16 K5-K7 walks (csrc/flash_sm90.cuh): a CTA holds 128 rows of one
# side as two warpgroups of 64 and steps over the other side in 64-row
# tiles (K6, K7) or 128-row tiles (K5)
_CTA_ROWS, _STEP_ROWS = 128, 64


def _band_none(Sq, Skv, causal, window, i0, ni, j0, nj):
    """`Band::none`: rows [i0, i0 + ni) x keys [j0, j0 + nj) hold no key of
    the band."""
    return i0 >= Sq or j0 >= Skv or (causal and (
        j0 > i0 + ni - 1 or (window > 0 and i0 - (j0 + nj - 1) >= window)))


def split_walk(Sq, Skv, causal=True, window=0):
    """The tiles the bf16 K6 and K7 visit, as the device code walks them
    (`Band::k_tiles`, `Band::q_tiles` and `Band::none` in
    csrc/flash_sm90.cuh), for checking on the host that the band is covered
    once. Returns {"dq": [...], "dkv": [...]}: for each warpgroup step that
    computes, its (row0, rows, key0, keys) rectangle. K6's grid is ceil(Sq /
    128) q tiles a (batch, head); K7's items are ceil(Skv / 128) k tiles a
    (batch, head), on a persistent grid of at most one CTA an SM."""
    C, T = _CTA_ROWS, _STEP_ROWS
    n_k, n_q = -(-Skv // T), -(-Sq // T)
    dq, dkv = [], []
    for i0 in range(0, Sq, C):          # K6: k tiles of the CTA's band
        kt0, kt1 = 0, n_k
        if causal:
            kt1 = min(kt1, (min(i0 + C, Sq) - 1) // T + 1)
            if window:
                kt0 = max(0, i0 - window + 1) // T
        for r0 in (i0, i0 + T):
            dq += [(r0, T, kt * T, T) for kt in range(kt0, kt1)
                   if not _band_none(Sq, Skv, causal, window, r0, T, kt * T,
                                     T)]
    for j0 in range(0, Skv, C):         # K7: q tiles of the CTA's band
        it0, it1 = 0, n_q
        if causal:
            it0 = j0 // T
            if window:
                it1 = min(it1, (j0 + C + window - 2) // T + 1)
        for jw in (j0, j0 + T):
            dkv += [(it * T, T, jw, T) for it in range(it0, it1)
                    if not _band_none(Sq, Skv, causal, window, it * T, T,
                                      jw, T)]
    return {"dq": dq, "dkv": dkv}


def fwd_walk(Sq, Skv, causal=True, window=0):
    """The tiles the bf16 K5 visits, as the device code walks them
    (`fwd_walk` in csrc/flash_sm90.cuh: `Band::k_tiles` over 128-row k
    tiles a 128-row CTA, minus the tiles a warpgroup's 64 rows skip by
    `Band::none`), for checking on the host that the band is covered once.
    Returns, for each warpgroup step that computes, its (row0, rows, key0,
    keys) rectangle. K5's grid is ceil(Sq / 128) q tiles a (batch,
    head)."""
    C, T = _CTA_ROWS, _STEP_ROWS
    steps = []
    for i0 in range(0, Sq, C):
        kt0, kt1 = 0, -(-Skv // C)
        if causal:
            kt1 = min(kt1, (min(i0 + C, Sq) - 1) // C + 1)
            if window:
                kt0 = max(0, i0 - window + 1) // C
        for r0 in (i0, i0 + T):
            steps += [(r0, T, kt * C, C) for kt in range(kt0, kt1)
                      if not _band_none(Sq, Skv, causal, window, r0, T,
                                        kt * C, C)]
    return steps


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


def flash_fwd(q, k, v, causal=True, scale=None, window=0, seed=0, rate=0.0):
    """K5 on the card: (out (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) f32
    base 2), with attention dropout at `rate` drawn from `seed`. Adds one
    to `flash_fwd.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v) = _split_operands(q, k, v, causal,
                                                     window)
    drop = _drop(seed, rate)
    from .._build import load_library

    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_fwd, "flash_fwd", _DTYPES[q.dtype],
                int(_sm90_route(q.dtype, hd)), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                _strides(q, k, v), B, H, Sq, Skv, hd, _scale(scale, hd),
                int(causal), int(window), *drop, _stream(q))
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=None,
                 window=0, seed=0, rate=0.0):
    """K6 on the card: dq (B, H, Sq, hd) from the saved lse and delta (B,
    H, Sq) f32, with the forward's dropout (`seed`, `rate`). Adds one to
    `flash_bwd_dq.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v, do) = _split_operands(
        q, k, v, causal, window, do)
    drop = _drop(seed, rate)
    lse, delta = (_rows(n, t, (B, H, Sq), q.device)
                  for n, t in (("lse", lse), ("delta", delta)))
    from .._build import load_library

    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_bwd_dq, "flash_bwd_dq",
                _DTYPES[q.dtype], int(_sm90_route(q.dtype, hd)),
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), _strides(q, k, v, do), B, H, Sq, Skv, hd,
                _scale(scale, hd), int(causal), int(window), *drop,
                _stream(q))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=None,
                  window=0, seed=0, rate=0.0):
    """K7 on the card: (dk, dv), each (B, H, Skv, hd), from the saved lse
    and delta (B, H, Sq) f32, with the forward's dropout (`seed`, `rate`).
    Adds one to `flash_bwd_dkv.launches`."""
    (B, H, Sq, Skv, hd), (q, k, v, do) = _split_operands(
        q, k, v, causal, window, do)
    drop = _drop(seed, rate)
    lse, delta = (_rows(n, t, (B, H, Sq), q.device)
                  for n, t in (("lse", lse), ("delta", delta)))
    from .._build import load_library

    dk = torch.empty((B, H, Skv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _launch(load_library().nk_flash_bwd_dkv, "flash_bwd_dkv",
                _DTYPES[q.dtype], int(_sm90_route(q.dtype, hd)),
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do), B, H,
                Sq, Skv, hd, _scale(scale, hd), int(causal), int(window),
                *drop, _stream(q))
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


# The forward launches as custom ops (see the module docstring). A seed is
# a u64; the schema's int is signed, so it travels as its two's complement.


def _i64(seed: int) -> int:
    seed = int(seed) & ((1 << 64) - 1)
    return seed - (1 << 64) if seed >> 63 else seed


@torch.library.custom_op("neuronika_tpu_torch::flash_fwd_qkv",
                         mutates_args=())
def _fwd_qkv_op(qkv: torch.Tensor, n_head: int, n_kv_head: int,
                causal: bool, scale: Optional[float], fast_softmax: bool,
                seed: int, rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of K1 on CUDA tensors, of the plain forward on CPU
    tensors."""
    drop = dict(seed=seed & ((1 << 64) - 1), rate=rate)
    if _on_cpu(qkv):
        return flash_attention_qkv_fwd_reference(
            qkv, n_head, n_kv_head, causal, scale, fast_softmax, **drop)
    return flash_fwd_qkv(qkv, n_head, n_kv_head, causal, scale,
                         fast_softmax, **drop)


@_fwd_qkv_op.register_fake
def _(qkv, n_head, n_kv_head, causal, scale, fast_softmax, seed, rate):
    B, S, _, _, hd = _qkv_geometry(qkv, n_head, n_kv_head)
    return (qkv.new_empty((B, S, n_head * hd)),
            qkv.new_empty((B, n_head, S), dtype=torch.float32))


@torch.library.custom_op("neuronika_tpu_torch::flash_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float], window: int, seed: int,
            rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of K5 on CUDA tensors, of the plain forward on CPU
    tensors."""
    drop = dict(seed=seed & ((1 << 64) - 1), rate=rate)
    if _on_cpu(q, k, v):
        return flash_attention_fwd_reference(q, k, v, causal, scale, window,
                                             **drop)
    return flash_fwd(q, k, v, causal, scale, window, **drop)


@_fwd_op.register_fake
def _(q, k, v, causal, scale, window, seed, rate):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=torch.float32)


# the ops whose outputs remat_policy "flash" keeps
FWD_OPS = (torch.ops.neuronika_tpu_torch.flash_fwd_qkv.default,
           torch.ops.neuronika_tpu_torch.flash_fwd.default)


class FlashAttentionQKV(torch.autograd.Function):
    """out = attention(qkv); saves (qkv, out, lse) and the dropout seed.
    Forward: K1 on CUDA tensors, the plain forward on CPU tensors (both
    through the custom op `flash_fwd_qkv`).
    Backward: the split K2a + K2b pair, or the fused kernel with
    `fused_bwd`; the plain backward on CPU tensors. Every one regenerates
    the forward's dropout mask from the seed."""

    @staticmethod
    def forward(ctx, qkv, n_head, n_kv_head, causal, scale, fast_softmax,
                fused_bwd, seed, rate):
        drop = dict(seed=seed, rate=rate)
        out, lse = _fwd_qkv_op(qkv, n_head, n_kv_head, causal, scale,
                               fast_softmax, _i64(seed), rate)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (n_head, n_kv_head, causal, scale, fused_bwd, drop)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        n_head, n_kv_head, causal, scale, fused_bwd, drop = ctx.args
        do = do.contiguous()
        if _on_cpu(qkv, do):
            d_qkv = flash_attention_qkv_bwd_reference(
                qkv, out, lse, do, n_head, n_kv_head, causal, scale, **drop)
        elif fused_bwd:
            d_qkv = flash_bwd_fused_qkv(qkv, out, lse, do, n_head,
                                        n_kv_head, causal, scale, **drop)
        else:   # one pre-pass for both kernels
            d_qkv = torch.empty_like(qkv)
            stats = flash_bwd_stats_qkv(qkv, out, lse, do, n_head, n_kv_head)
            flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                             causal, scale, stats, **drop)
            flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, n_head, n_kv_head,
                              causal, scale, stats, **drop)
        return d_qkv, None, None, None, None, None, None, None, None


def flash_attention_qkv(qkv, n_head: int, n_kv_head: int = 0,
                        causal: bool = True, scale=None, block_q: int = 256,
                        block_k: int = 256, fast_softmax: bool = False,
                        fused_bwd: bool = False, dropout: float = 0.0,
                        seed: int = 0):
    """Layout-native flash attention on the packed qkv projection (see the
    module docstring): (B, S, W) -> (B, S, H*hd) head-major, differentiable.
    `dropout` > 0 drops attention probabilities inside the kernels with
    the mask `keep_mask(seed, ...)` (an int seed; JAX's f32 seed array
    becomes its value).

    `block_q`/`block_k` are accepted for signature parity with the JAX
    function, where they size the TPU's VMEM tiles; the CUDA kernels choose
    their own tiles and mask any ragged S, so both are ignored."""
    del block_q, block_k
    _qkv_geometry(qkv, n_head, n_kv_head)
    _check_rate(dropout)
    return FlashAttentionQKV.apply(qkv, n_head, n_kv_head, causal, scale,
                                   fast_softmax, fused_bwd, int(seed),
                                   float(dropout))


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) in the split layout; saves (q, k, v, out,
    lse) and the dropout seed. Forward: K5 on CUDA tensors, the plain
    forward on CPU tensors (both through the custom op `flash_fwd`).
    Backward: delta = rowsum(dO.O) in f32 by a
    plain reduction, then K6 and K7; the plain backward on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, seed, rate):
        drop = dict(seed=seed, rate=rate)
        out, lse = _fwd_op(q, k, v, causal, scale, window, _i64(seed), rate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window, drop)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window, drop = ctx.args
        delta = (do.float() * out.float()).sum(-1)
        if _on_cpu(q, do):
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, do, lse, delta, causal, scale, window, **drop)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, window,
                              **drop)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                   window, **drop)
        return dq, dk, dv, None, None, None, None, None


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
    return FlashAttention.apply(q, k, v, causal, scale, window, 0, 0.0)


def flash_attention_dropout(q, k, v, seed, causal: bool = True, scale=None,
                            block_q: int = 256, block_k: int = 256,
                            rate: float = 0.1, window: int = 0):
    """`flash_attention` with attention dropout at `rate` inside the
    kernels (JAX's `flash_attention_dropout`, its argument order without
    `interpret`): the mask `keep_mask(seed, ...)` is regenerated from the
    integer `seed` by the forward and both backward kernels, so no mask
    tensor exists. Block sizes are accepted and ignored."""
    del block_q, block_k
    _check_rate(rate)
    return FlashAttention.apply(q, k, v, causal, scale, window, int(seed),
                                float(rate))
