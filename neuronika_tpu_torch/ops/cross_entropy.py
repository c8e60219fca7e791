"""K8, K9, K10: the fused linear cross-entropy (counterpart of
`neuronika_tpu/ops/pallas/cross_entropy.py`).

`fused_linear_cross_entropy(x, w, targets)` is the mean over rows of
CE(softmax(x . w^T), targets) for x (N, D), w (V, D) in one dtype (f32 or
bf16) and integer targets (N,), with a custom backward; the (N, V) logits
are never materialised by the kernels. Three wrappers carry it:
  `ce_fwd`  K8: per-row loss = lse - target logit, and lse, both f32;
  `ce_dx`   K9: dx = sum_j cast(p g) w_j in x's dtype;
  `ce_dw`   K10: dW = sum_i cast(p g)^T x_i in w's dtype;
with p = exp(logit - lse) - onehot(target), g the row weights (N,) f32 and
cast() the rounding of p g to x's dtype before the second product, as the
TPU kernels round it. For CUDA tensors each launches its kernel and adds
one to its `launches`: `csrc/cross_entropy.cu` (mma.sync for bf16, FFMA
for f32, f32 accumulation) or, for bf16, the kernel of
`csrc/cross_entropy_sm90.cu` (wgmma, TMA, thread block clusters) that
`ce_fwd_route` (K8: a cluster of vocabulary ranges sharing an x block) or
`ce_grad_route` (K9, K10: a cluster of D slices sharing the logits) picks
by shape; a launch of that kernel also adds one to the wrapper's
`sm90_launches`.
Any other tensor takes the plain version beside it, the same math in f32
from the operands widened exactly. A target outside [0, V) matches no
column: its target logit is 0 and it subtracts no onehot, as in the TPU
kernels.

The block sizes of the JAX function size the TPU's VMEM blocks: its check
that they divide rows and vocabulary is kept (the "divisible" error), and
they are otherwise ignored, as are the VMEM caps and `interpret`.
`reference_linear_cross_entropy` is the composite oracle.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# the Hopper K8-K10's tiles (csrc/cross_entropy_sm90.cu: kOwn, kStream,
# kSlice, kMaxCluster, kFwdStream): own rows a CTA (x for K8 and K9, W for
# K10), stream rows a K9/K10 tile, D columns a CTA's accumulator, CTAs a
# cluster (the portable cluster size), W rows a K8 vocabulary tile
SM90_OWN, SM90_STREAM, SM90_SLICE, SM90_MAX_CLUSTER = 128, 128, 192, 8
SM90_FWD_STREAM = 256


def _shapes(x, w, targets):
    """(N, V, D); raises on operands the function does not take."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x (N, D) and w (V, D) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if targets.shape != (x.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} for {x.shape[0]} "
                         f"rows")
    if x.dtype != w.dtype:
        raise TypeError(f"x and w in one dtype, got {x.dtype} and {w.dtype}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"integer targets expected, got {targets.dtype}")
    return x.shape[0], w.shape[0], x.shape[1]


def reference_linear_cross_entropy(x, w, targets):
    """The composite oracle: f32 logits, logsumexp minus the gathered
    target logit, mean over rows."""
    logits = x.float() @ w.float().T
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, targets.long()[:, None])[:, 0]
    return (lse - tgt).mean()


def _target_mask(targets, V):
    """(targets clamped into [0, V) as int64, which of them are in it)."""
    t = targets.long()
    return t.clamp(0, V - 1), (t >= 0) & (t < V)


def ce_fwd_reference(x, w, targets):
    """Plain version of K8: (loss, lse), (N,) f32 each."""
    _, V, _ = _shapes(x, w, targets)
    logits = x.float() @ w.float().T
    lse = torch.logsumexp(logits, -1)
    t, ok = _target_mask(targets, V)
    hit = logits.gather(-1, t[:, None])[:, 0] * ok
    return lse - hit, lse


def _pg(x, w, targets, lse, g_rows):
    """cast((exp(logits - lse) - onehot) g) in x's dtype, (N, V)."""
    _, V, _ = _shapes(x, w, targets)
    p = torch.exp(x.float() @ w.float().T - lse.float()[:, None])
    t, ok = _target_mask(targets, V)
    p.scatter_add_(1, t[:, None], -ok.float()[:, None])
    return (p * g_rows.float()[:, None]).to(x.dtype)


def ce_dx_reference(x, w, targets, lse, g_rows):
    """Plain version of K9: dx (N, D) in x's dtype."""
    return (_pg(x, w, targets, lse, g_rows).float() @ w.float()).to(x.dtype)


def ce_dw_reference(x, w, targets, lse, g_rows):
    """Plain version of K10: dW (V, D) in w's dtype."""
    pg = _pg(x, w, targets, lse, g_rows)
    return (pg.float().T @ x.float()).to(w.dtype)


def _card(fn, x, w, targets, *rows):
    """The operands of a kernel launch: x and w contiguous, targets int32,
    the (N,) f32 row vectors `rows` contiguous; raises on what the kernels
    cannot take."""
    N, V, D = _shapes(x, w, targets)
    devs = {t.device for t in (x, w, targets, *rows)}
    if len(devs) != 1:
        raise ValueError(f"{fn.__name__}: operands on {sorted(map(str, devs))}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn.__name__} takes "
                        f"{', '.join(map(str, _DTYPES))}, not {x.dtype}")
    if min(N, V, D) < 1 or max(N, V, D) > _INT_MAX:
        raise ValueError(f"{fn.__name__}: N {N}, V {V}, D {D} out of the "
                         f"kernel's range")
    for r in rows:
        if r.shape != (N,):
            raise ValueError(f"{fn.__name__}: row vector {tuple(r.shape)} "
                             f"for {N} rows")
    return (x.contiguous(), w.contiguous(),
            targets.to(torch.int32).contiguous(),
            *(r.float().contiguous() for r in rows))


def ce_fwd_route(dtype, D: int) -> str:
    """The kernel that runs a K8 call on the card, by shape alone, before
    launch: "sm90", `csrc/cross_entropy_sm90.cu`'s Hopper kernel, for bf16
    with D a multiple of 8 (TMA's rows are multiples of 16 bytes), at any D
    (it holds no D-wide accumulator); "ce_fwd", `csrc/cross_entropy.cu`'s
    template, otherwise (f32; D not a multiple of 8). Not a fallback: a
    failure of the chosen kernel raises."""
    return "sm90" if dtype == torch.bfloat16 and D % 8 == 0 else "ce_fwd"


def ce_fwd_plan_sm90(N: int, V: int, D: int):
    """The Hopper K8 launch, as `nk_ce_fwd_sm90` cuts it: (cluster size,
    grid (cluster size, x blocks), the vocabulary rows [v0, v1) of each
    cluster rank). The cs CTAs of a cluster share one block of SM90_OWN x
    rows; of the T = ceil(V / SM90_FWD_STREAM) vocabulary tiles rank r
    takes [r T // cs, (r + 1) T // cs), cs = min(SM90_MAX_CLUSTER, T). D
    does not enter the cut."""
    del D
    tiles = -(-V // SM90_FWD_STREAM)
    cs = min(SM90_MAX_CLUSTER, tiles)
    ranges = [(r * tiles // cs * SM90_FWD_STREAM,
               min(V, (r + 1) * tiles // cs * SM90_FWD_STREAM))
              for r in range(cs)]
    return cs, (cs, -(-N // SM90_OWN)), ranges


def _aligned16(*ts):
    """The tensors, each cloned unless its base is 16-byte aligned (TMA
    reads from such bases)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def ce_grad_route(kind: str, dtype, D: int) -> str:
    """The kernel that runs a K9 ("dx") or K10 ("dw") call on the card, by
    shape alone, before launch: "sm90", `csrc/cross_entropy_sm90.cu`'s
    Hopper kernel, for bf16 with D a multiple of 8 (TMA's rows are
    multiples of 16 bytes) cut into at most SM90_MAX_CLUSTER slices of
    SM90_SLICE columns (D <= 1536: one cluster holds an own block's
    slices); "ce_grad", `csrc/cross_entropy.cu`'s template, otherwise (f32;
    wider D; D not a multiple of 8). Not a fallback: a failure of the
    chosen kernel raises."""
    if kind not in ("dx", "dw"):
        raise ValueError(f"kind {kind!r}: dx or dw")
    sm90 = (dtype == torch.bfloat16 and D % 8 == 0
            and -(-D // SM90_SLICE) <= SM90_MAX_CLUSTER)
    return "sm90" if sm90 else "ce_grad"


def ce_grad_plan_sm90(kind: str, N: int, V: int, D: int):
    """The Hopper K9 ("dx") or K10 ("dw") launch, as `nk_ce_dx_sm90` and
    `nk_ce_dw_sm90` cut it: (cluster size, grid (slices, own blocks), the
    D columns [d0, d1) of each slice, rounds of the stream walk). K9 owns
    x rows and streams W, K10 the reverse. Slice s holds columns s
    SM90_SLICE .. up to D; a round takes one stream tile of SM90_STREAM
    rows a CTA of the cluster."""
    if kind not in ("dx", "dw"):
        raise ValueError(f"kind {kind!r}: dx or dw")
    own, stream = (N, V) if kind == "dx" else (V, N)
    cs = -(-D // SM90_SLICE)
    slices = [(s * SM90_SLICE, min(D, (s + 1) * SM90_SLICE))
              for s in range(cs)]
    tiles = -(-stream // SM90_STREAM)
    return cs, (cs, -(-own // SM90_OWN)), slices, -(-tiles // cs)


def _launched(fn, err):
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    fn.launches += 1


def ce_fwd(x, w, targets):
    """K8: (loss, lse), (N,) f32 each. CUDA tensors: the kernel
    `ce_fwd_route` picks, adding one to `ce_fwd.launches` (and to
    `ce_fwd.sm90_launches` on the Hopper kernel); others:
    `ce_fwd_reference`."""
    if x.device.type != "cuda":
        return ce_fwd_reference(x, w, targets)
    xc, wc, tc = _card(ce_fwd, x, w, targets)
    N, V, D = x.shape[0], w.shape[0], x.shape[1]
    sm90 = ce_fwd_route(x.dtype, D) == "sm90"
    if sm90:
        xc, wc = _aligned16(xc, wc)
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = getattr(load_library(), f"nk_ce_fwd{'_sm90' * sm90}")(
            _DTYPES[x.dtype], xc.data_ptr(), wc.data_ptr(), tc.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), N, V, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(ce_fwd, err)
    ce_fwd.sm90_launches += sm90
    return loss, lse


def _grad(fn, kind, x, w, targets, lse, g_rows):
    """Launch the K9 ("dx") or K10 ("dw") kernel `ce_grad_route` picks."""
    xc, wc, tc, lc, gc = _card(fn, x, w, targets, lse, g_rows)
    N, V, D = x.shape[0], w.shape[0], x.shape[1]
    sm90 = ce_grad_route(kind, x.dtype, D) == "sm90"
    if sm90:
        xc, wc = _aligned16(xc, wc)
    out = torch.empty((N if kind == "dx" else V, D), dtype=x.dtype,
                      device=x.device)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = getattr(load_library(), f"nk_ce_{kind}{'_sm90' * sm90}")(
            _DTYPES[x.dtype], xc.data_ptr(), wc.data_ptr(), tc.data_ptr(),
            lc.data_ptr(), gc.data_ptr(), out.data_ptr(), N, V, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(fn, err)
    fn.sm90_launches += sm90
    return out


def ce_dx(x, w, targets, lse, g_rows):
    """K9: dx (N, D) in x's dtype, deterministic (each CTA sums its rows'
    terms in order). CUDA tensors: the kernel `ce_grad_route` picks, adding
    one to `ce_dx.launches` (and to `ce_dx.sm90_launches` on the Hopper
    kernel); others: `ce_dx_reference`."""
    if x.device.type != "cuda":
        return ce_dx_reference(x, w, targets, lse, g_rows)
    return _grad(ce_dx, "dx", x, w, targets, lse, g_rows)


def ce_dw(x, w, targets, lse, g_rows):
    """K10: dW (V, D) in w's dtype, deterministic (each CTA sums its rows'
    terms in order). CUDA tensors: the kernel `ce_grad_route` picks, adding
    one to `ce_dw.launches` (and to `ce_dw.sm90_launches` on the Hopper
    kernel); others: `ce_dw_reference`."""
    if x.device.type != "cuda":
        return ce_dw_reference(x, w, targets, lse, g_rows)
    return _grad(ce_dw, "dw", x, w, targets, lse, g_rows)


# launches, and those that ran the Hopper kernel (ce_fwd_route,
# ce_grad_route "sm90")
for _fn in (ce_fwd, ce_dx, ce_dw):
    _fn.launches = 0
    _fn.sm90_launches = 0

KERNELS = (ce_fwd, ce_dx, ce_dw)


def _auto_bm(n, cap):
    """The JAX function's row block: the largest listed size <= cap that
    divides n, else n."""
    for bm in (cap, 1536, 1024, 768, 512, 384, 256, 128, 64, 32, 16, 8):
        if bm <= cap and n % bm == 0:
            return bm
    return n


def _check_blocks(N, V, block_m, block_v):
    bm = _auto_bm(N, block_m or 1024)
    bv = min(block_v, V)
    if N % bm or V % bv:
        raise ValueError("rows/vocab must be divisible by the block sizes")


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets):
        loss, lse = ce_fwd(x, w, targets)
        ctx.save_for_backward(x, w, targets, lse)
        return loss.mean()

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        N = x.shape[0]
        g_rows = torch.full((N,), 1.0 / N, dtype=torch.float32,
                            device=x.device) * g.float()
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = ce_dx(x, w, targets, lse, g_rows) if need_x else None
        dw = ce_dw(x, w, targets, lse, g_rows) if need_w else None
        return dx, dw, None


def fused_linear_cross_entropy(x, w, targets, block_m: int | None = None,
                               block_v: int = 1024, interpret: bool = False):
    """Mean over rows of CE(softmax(x . w^T), targets): K8 forward, K9 and
    K10 backward (each gradient computed when it is needed). x (N, D) and
    w (V, D) in one dtype, targets (N,) integer. Raises ValueError, as the
    JAX function does, unless the rows and the vocabulary divide the given
    block sizes."""
    del interpret
    N, V, _ = _shapes(x, w, targets)
    _check_blocks(N, V, block_m, block_v)
    return _FusedLinearCrossEntropy.apply(x, w, targets)
