"""Paged-attention decode: the block-table K/V lookup fused into the
attention over one layer's KV pool (counterpart of
`neuronika_tpu/ops/pallas/paged_attention.py`).

Layout contract (matches `init_paged_cache` / `_decode_qkv`):
  q        (B, KV, G, hd)   one new token per sequence, GQA folded into the
                            query side (G = n_head // kv_heads)
  pk/pv    (NB, KV, BS, hd) ONE layer's slice of the block pool
  table    (B, MB) int32    pool block id per logical block
  pos      (B,) int32       current write position (attends 0..pos)
Returns (B, KV, G, hd) in q's dtype.

`paged_attention` launches the CUDA kernel (`csrc/paged_attention.cu`) for
CUDA tensors and takes `paged_attention_reference`, the plain PyTorch
version, only for CPU tensors. The reference keeps the softmax weights in
f32 for the PV product where the TPU kernel casts them to v's dtype first;
in f32 the two agree to 1e-5.

The kernel splits each sequence's logical blocks over CTAs
(flash-decoding): `paged_split_plan` picks the cut from the shapes alone,
and `paged_attention_split_reference` is the plain twin of its math, each
split's partial softmax merged in split order. It takes every head dim
from 1 to 256 and any group size, as JAX's kernel does, through two
bodies, which `paged_route` picks: "chunked" runs a group larger than 8
query heads as chunks of 8 (`group_chunks`), each chunk a CTA of its own
over the same kv head, with its own splits and merge, on CUDA cores;
"mma" (bf16 past 8 query heads a kv head at hd 64 and 128) holds up to 16
of a group's heads as one tensor-core tile, with its own plan
(`paged_mma_plan`). The wrapper records its last launch's route in
`paged_attention.route`.
"""

from __future__ import annotations

import functools
import math

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
CHUNK_G = 8     # query heads a CTA (csrc/paged_attention.cu: kMaxG)
# the tensor-core body (csrc/paged_attention.cu::paged_attention_mma_kernel):
# query heads a CTA (kMmaRows), its head dims, and its plan: CTAs wanted an
# SM (128 threads and ~70 KB of shared memory each) and the fewest
# logical blocks a split walks
MMA_G = 16
MMA_HEAD_DIMS = (64, 128)
MMA_CTAS_PER_SM = 1
MMA_MIN_BLOCKS = 8
ROUTES = {"chunked": 0, "mma": 1}
LOG2E = 1.4426950408889634
# the split plan: CTAs wanted a card SM (256 threads each), the fewest
# logical blocks a split walks (a split's fixed cost, its q load and its
# partial, against the blocks it reads), and the most splits the kernel's
# merge takes (csrc/paged_attention.cu: kMaxSplits)
SPLIT_CTAS_PER_SM = 4
SPLIT_MIN_BLOCKS = 4
SPLIT_MAX = 256
H100_SMS = 132


def _gather(pk, pv, table):
    """pk[table], pv[table] as contiguous (B, KV, MB BS, hd) caches."""
    B, MB = table.shape
    _, KV, BS, hd = pk.shape
    t = table.long()
    return (p[t].permute(0, 2, 1, 3, 4).reshape(B, KV, MB * BS, hd)
            for p in (pk, pv))


def paged_route(dtype, G: int, hd: int) -> str:
    """The body that runs a launch: "mma" (the tensor-core body) for bf16
    past CHUNK_G query heads a kv head at the head dims MMA_HEAD_DIMS, else
    "chunked". The one place the body is picked: the wrapper passes it to
    the kernel, which launches that body or refuses."""
    if dtype == torch.bfloat16 and G > CHUNK_G and hd in MMA_HEAD_DIMS:
        return "mma"
    return "chunked"


def group_chunks(G: int, route: str = "chunked") -> int:
    """The CTAs that share a kv head: ceil(G / CHUNK_G) chunks of at most
    CHUNK_G query heads on the chunked body, ceil(G / MMA_G) on "mma"."""
    return -(-G // (MMA_G if route == "mma" else CHUNK_G))


def paged_split_plan(B: int, KV: int, MB: int, sms: int = H100_SMS):
    """(splits, bps): each (sequence, kv head) runs `splits` CTAs, split z
    walking the logical blocks [z bps, min(MB, (z + 1) bps)) that meet its
    attended range. From B KV, MB and the card's SM count only, never from
    pos (reading pos to the host would wait on every decode step): enough
    CTAs for SPLIT_CTAS_PER_SM a SM, no split under SPLIT_MIN_BLOCKS
    blocks, at most SPLIT_MAX splits, and no empty split at the end
    (splits = ceil(MB / bps))."""
    want = -(-SPLIT_CTAS_PER_SM * sms // (B * KV))
    splits = max(1, min(want, MB // SPLIT_MIN_BLOCKS, SPLIT_MAX))
    bps = -(-MB // splits)
    return -(-MB // bps), bps


def paged_mma_plan(B: int, KV: int, G: int, MB: int, sms: int = H100_SMS):
    """(splits, bps) of the tensor-core body: each (sequence, kv head, chunk
    of MMA_G query heads) runs `splits` CTAs, split z walking the logical
    blocks [z bps, min(MB, (z + 1) bps)). From the shapes and the card's
    SM count only, never from pos: one wave of MMA_CTAS_PER_SM CTAs an SM,
    no split under MMA_MIN_BLOCKS blocks, at most SPLIT_MAX splits, and no
    empty split at the end."""
    items = B * KV * group_chunks(G, "mma")
    want = -(-MMA_CTAS_PER_SM * sms // items)
    splits = max(1, min(want, MB // MMA_MIN_BLOCKS, SPLIT_MAX))
    bps = -(-MB // splits)
    return -(-MB // bps), bps


def paged_plan(route: str, B: int, KV: int, G: int, MB: int,
               sms: int = H100_SMS):
    """(splits, bps) of a launch on `route`'s body."""
    if route == "mma":
        return paged_mma_plan(B, KV, G, MB, sms)
    return paged_split_plan(B, KV * group_chunks(G), MB, sms)


def _split_partials(q, pk, pv, table, pos, window, bps):
    """Each split's partial softmax, as the kernel forms it, in f32 and
    the exp2 domain: m (B, KV, G, splits), the max of the split's scores
    (-inf where it meets no attended key), l the sum of exp2(s - m) there
    (0), acc (B, KV, G, splits, hd) the p-weighted sum of its v rows (0)."""
    B, KV, G, hd = q.shape
    MB = table.shape[1]
    BS = pk.shape[2]
    splits = -(-MB // bps)
    lk, lv = _gather(pk, pv, table)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), lk.float())
    s = s * (LOG2E / math.sqrt(hd))
    idx = torch.arange(MB * BS, device=q.device)
    p_b = pos.long().view(B, 1, 1, 1)
    keep = idx <= p_b
    if window:
        keep &= p_b - idx < window
    pad = splits * bps * BS - MB * BS      # the last split's missing keys
    s = torch.nn.functional.pad(s.masked_fill(~keep, -math.inf), (0, pad),
                                value=-math.inf)
    v = torch.nn.functional.pad(lv.float(), (0, 0, 0, pad))
    s = s.view(B, KV, G, splits, bps * BS)
    m = s.amax(-1)
    p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)[..., None])
    acc = torch.einsum("bkgzs,bkzsd->bkgzd", p,
                       v.view(B, KV, splits, bps * BS, hd))
    return m, p.sum(-1), acc


def _merge_splits(m, l, acc):
    """The splits' partials merged in f32 in split order, as the kernel's
    last CTA merges them; an empty split (m = -inf) adds nothing."""
    top = m.amax(-1)
    mu = torch.where(top == -math.inf, 0.0, top)
    tot_l = torch.zeros_like(mu)
    tot = torch.zeros_like(acc[..., 0, :])
    for z in range(m.shape[-1]):
        w = torch.exp2(m[..., z] - mu)
        tot_l = tot_l + l[..., z] * w
        tot = tot + acc[..., z, :] * w[..., None]
    return tot / tot_l[..., None]


def paged_attention_split_reference(q, pk, pv, table, pos, *,
                                    window: int = 0, bps: int | None = None):
    """Plain twin of the kernel's split-and-merge math: the keys cut into
    splits of `bps` logical blocks (by default the plan of the body
    `paged_route` picks for q, for an H100: `paged_split_plan` over the
    chunked body's (kv head, group chunk) CTAs, or `paged_mma_plan`), each
    split's partial softmax, merged in f32 in split order. Result in q's
    dtype. Runs on any device."""
    B, KV, G, hd = q.shape
    if bps is None:
        bps = paged_plan(paged_route(q.dtype, G, hd), B, KV, G,
                         table.shape[1])[1]
    out = _merge_splits(*_split_partials(q, pk, pv, table, pos, window,
                                         bps))
    return out.to(q.dtype)


def paged_attention_reference(q, pk, pv, table, pos, *, window: int = 0):
    """Plain PyTorch version: gather `pk[table]` into a contiguous
    (B, KV, MB*BS, hd) cache, masked softmax, PV. Math in f32, result in
    q's dtype. Runs on any device."""
    B, KV, G, hd = q.shape
    MB = table.shape[1]
    BS = pk.shape[2]
    lk, lv = _gather(pk, pv, table)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), lk.float())
    s = s / math.sqrt(hd)
    idx = torch.arange(MB * BS, device=q.device)
    p_b = pos.long().view(B, 1, 1, 1)
    keep = idx <= p_b
    if window:
        keep &= p_b - idx < window
    s = s.masked_fill(~keep, -1e30)
    o = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, -1), lv.float())
    return o.to(q.dtype)


def _check(q, pk, pv, table, pos, window):
    dev = q.device
    for name, t in (("pk", pk), ("pv", pv), ("table", table), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported "
                        f"({', '.join(map(str, _DTYPES))})")
    if pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise TypeError(f"q/pk/pv dtypes differ: {q.dtype}, {pk.dtype}, "
                        f"{pv.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if q.dim() != 4 or pk.dim() != 4 or pk.shape != pv.shape:
        raise ValueError(f"want q (B,KV,G,hd), pk/pv (NB,KV,BS,hd); got "
                         f"{tuple(q.shape)}, {tuple(pk.shape)}, "
                         f"{tuple(pv.shape)}")
    B, KV, G, hd = q.shape
    if pk.shape[1] != KV or pk.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and pool {tuple(pk.shape)} "
                         f"disagree on KV or hd")
    if table.dim() != 2 or table.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"want table (B, MB), pos (B,) with B={B}; got "
                         f"{tuple(table.shape)}, {tuple(pos.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1.."
                         f"{MAX_HEAD_DIM}; use the gather path "
                         f"(kernel='off')")
    if G < 1:
        raise ValueError(f"query group size {G} < 1")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} outside 1..65535")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("table", table),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("pk", pk), ("pv", pv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q, pk, pv, table, pos, *, window: int = 0):
    """One decode step of attention over a paged KV pool (see the module
    docstring for the layout). CUDA tensors launch the kernel on the body
    `paged_route` picks, add one to `paged_attention.launches` (and to
    `paged_attention.mma_launches` on "mma") and record the route in
    `paged_attention.route`; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (pk, pv, table, pos)):
            raise ValueError("q is on the CPU but the pool is not")
        return paged_attention_reference(q, pk, pv, table, pos,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, pk, pv, table, pos, window)
    from .._build import load_library

    lib = load_library()
    B, KV, G, hd = q.shape
    NB, _, BS, _ = pk.shape
    MB = table.shape[1]
    route = paged_route(q.dtype, G, hd)
    NC = group_chunks(G, route)
    splits, bps = _plan(route, B, KV, G, MB, q.device)
    rows = MMA_G if route == "mma" else min(G, CHUNK_G)
    out = torch.empty_like(q)
    part_ptr = count_ptr = None
    if splits > 1:
        part, count = _scratch(
            q.device, B * KV * NC * splits * rows * (hd + 2), B * KV * NC)
        part_ptr, count_ptr = part.data_ptr(), count.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.nk_paged_attention(
            _DTYPES[q.dtype], ROUTES[route], q.data_ptr(), pk.data_ptr(),
            pv.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, KV, G, hd, NB, BS, MB, window, 1.0 / math.sqrt(hd), splits,
            bps, part_ptr, count_ptr, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(route {route}): cudaError {err}")
    paged_attention.launches += 1
    paged_attention.mma_launches += route == "mma"
    paged_attention.route = route
    return out


paged_attention.launches = 0
paged_attention.mma_launches = 0   # those of the launches on route "mma"
paged_attention.route = None


# A decode loop calls the wrapper every layer of every host-bound step, so
# the plan is worked out once a shape and the scratch is kept between
# launches (launches on one stream run in turn; each leaves the counters
# at 0 again)


@functools.cache
def _plan(route: str, B: int, KV: int, G: int, MB: int, device):
    """paged_plan for `device`'s SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return paged_plan(route, B, KV, G, MB, sms)


_SCRATCH: dict = {}


def _scratch(device, n_part: int, n_count: int):
    """At least n_part f32 for the splits' partials and n_count int32
    split counters at 0, on `device`."""
    part, count = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < n_part or count.numel() < n_count:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
        count = torch.zeros(max(n_count, 1024), dtype=torch.int32,
                            device=device)
        _SCRATCH[device] = part, count
    return part, count
