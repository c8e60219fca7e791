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
TPU kernels round it. For CUDA tensors each launches its kernel of
`csrc/cross_entropy.cu` (mma.sync for bf16, FFMA for f32, f32
accumulation) and adds one to its `launches`; any other tensor takes the
plain version beside it, the same math in f32 from the operands widened
exactly. A target outside [0, V) matches no column: its target logit is 0
and it subtracts no onehot, as in the TPU kernels.

The block sizes of the JAX function size the TPU's VMEM blocks: its check
that they divide rows and vocabulary is kept (the "divisible" error), and
they are otherwise ignored, as are the VMEM caps and `interpret`.
`reference_linear_cross_entropy` is the composite oracle.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


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


def _launched(fn, err):
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    fn.launches += 1


def ce_fwd(x, w, targets):
    """K8: (loss, lse), (N,) f32 each. CUDA tensors: the kernel, adding one
    to `ce_fwd.launches`; others: `ce_fwd_reference`."""
    if x.device.type != "cuda":
        return ce_fwd_reference(x, w, targets)
    xc, wc, tc = _card(ce_fwd, x, w, targets)
    N, V, D = x.shape[0], w.shape[0], x.shape[1]
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = load_library().nk_ce_fwd(
            _DTYPES[x.dtype], xc.data_ptr(), wc.data_ptr(), tc.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), N, V, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(ce_fwd, err)
    return loss, lse


def _grad(fn, cname, out_rows, x, w, targets, lse, g_rows):
    xc, wc, tc, lc, gc = _card(fn, x, w, targets, lse, g_rows)
    N, V, D = x.shape[0], w.shape[0], x.shape[1]
    out = torch.empty((out_rows, D), dtype=x.dtype, device=x.device)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = getattr(load_library(), cname)(
            _DTYPES[x.dtype], xc.data_ptr(), wc.data_ptr(), tc.data_ptr(),
            lc.data_ptr(), gc.data_ptr(), out.data_ptr(), N, V, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(fn, err)
    return out


def ce_dx(x, w, targets, lse, g_rows):
    """K9: dx (N, D) in x's dtype. CUDA tensors: the kernel, adding one to
    `ce_dx.launches`; others: `ce_dx_reference`."""
    if x.device.type != "cuda":
        return ce_dx_reference(x, w, targets, lse, g_rows)
    return _grad(ce_dx, "nk_ce_dx", x.shape[0], x, w, targets, lse, g_rows)


def ce_dw(x, w, targets, lse, g_rows):
    """K10: dW (V, D) in w's dtype, deterministic (each CTA sums its rows'
    terms in order). CUDA tensors: the kernel, adding one to
    `ce_dw.launches`; others: `ce_dw_reference`."""
    if x.device.type != "cuda":
        return ce_dw_reference(x, w, targets, lse, g_rows)
    return _grad(ce_dw, "nk_ce_dw", w.shape[0], x, w, targets, lse, g_rows)


for _fn in (ce_fwd, ce_dx, ce_dw):
    _fn.launches = 0

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
