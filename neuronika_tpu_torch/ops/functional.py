"""Op definitions: forward functions and hand-written VJPs (counterpart of
`neuronika_tpu/ops/functional.py`).

Every op is a pair of functions over tensors:

``fwd(extra, *operand_values) -> value``
``vjp(extra, operand_values, out_value, out_grad) -> per-operand grads``

`extra` is a hashable tuple of static parameters (axis, exponent, ...) that
is part of the executor's cache signature. Stochastic ops (dropout, flash
attention) also take ``key``/``train`` keywords: `key` is the integer seed
the executor drew at forward, and the VJP regenerates the same mask from it
on the tensor's device.

The VJPs are the JAX package's, quirks included:
* broadcast un-reduction sums the out-grad over leading and size-1 axes
  (`unbroadcast`);
* losses: MAE/MSE/BCE/BCEWithLogits `mean` divide by the element count;
  KLDiv `mean` divides by the batch (axis 0) length, "batchmean"; NLL
  `mean` divides by C forward but by ``target.numel()`` backward;
* NLL expects the class axis FIRST: input (C, ...), target (...) holding
  class indices as floats;
* BCE clamps its logs at -100;
* pad's backward only slices the interior, so reflective and replicative
  modes drop the border contributions;
* `t` reverses all axes.

Kernel routes, for CUDA tensors:
* `mm`, `mm_t`, `mv`, `vm` and their VJPs run K3 (`ops/matmul.py`) for
  2-d operands when `config.use_kernels` is on;
* last-axis `softmax`/`log_softmax` run K4 (`ops/softmax.py`) under the
  same flag; their VJPs stay plain torch, as they are plain XLA in JAX;
* `flash_attention` runs the packed flash kernels (K1 forward, the fused K2
  backward, attention dropout inside both) whenever the tensor is on the
  card and K1 takes its shape, as the JAX op runs its Pallas kernel
  whenever the backend is a TPU and the shape qualifies; other shapes take
  the composite, which draws the kernels' dropout mask;
* `convolution` runs the direct-conv kernels (K12 for 2-d, K14 for 1-d,
  K15 for 3-d; `ops/conv.py`) under the same flag where
  `config.conv_route` and JAX's shape gates send it there; its VJP and
  every other shape are the library convolution, as they are XLA's in JAX.
Everything else is plain torch, and so is every op on the CPU apart from
the kernels' plain versions that the routes above reach there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import config
from .conv import (conv1d_direct_nwc, conv2d_direct, conv3d_direct_ndhwc,
                   route_conv2d)
from . import sharded
from .flash_attention import (flash_bwd_fused_qkv, flash_fwd_qkv, keep_mask,
                              kernels_take)
from .matmul import matmul as kernel_matmul
from .softmax import softmax_last_axis


class Op(NamedTuple):
    name: str
    fwd: Callable
    vjp: Optional[Callable]
    rng: bool = False


OPS: Dict[str, Op] = {}


def _register(name: str, fwd: Callable, vjp: Optional[Callable],
              rng: bool = False) -> Op:
    op = Op(name, fwd, vjp, rng)
    OPS[name] = op
    return op


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("float32", "bfloat16", as
    the JAX package's `astype` records them) or a numpy dtype."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {d!r}")
    return dt


def dtype_name(dt: torch.dtype) -> str:
    """torch.float32 -> "float32" (the JAX dtype name)."""
    return str(dt).removeprefix("torch.")


# --------------------------------------------------------------------------
# broadcasting helpers


def unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast out-gradient back to an operand's shape by summing
    over prepended axes and broadcast (size-1) axes."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    keep = tuple(i for i, (gs, s) in enumerate(zip(g.shape, shape))
                 if s == 1 and gs != 1)
    if keep:
        g = g.sum(dim=keep, keepdim=True)
    return g


def _promote(a, b):
    """Both operands in their promoted dtype, by dtype alone (JAX's rule
    for arrays; torch would let a 0-d tensor defer to the other)."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return a.to(ct), b.to(ct)


# --------------------------------------------------------------------------
# broadcast arithmetic


def _binary(fn):
    return lambda e, a, b: fn(*_promote(a, b))


_register(
    "add", _binary(torch.add),
    lambda e, p, o, g: (unbroadcast(g, p[0].shape),
                        unbroadcast(g, p[1].shape)),
)
_register(
    "sub", _binary(torch.sub),
    lambda e, p, o, g: (unbroadcast(g, p[0].shape),
                        unbroadcast(-g, p[1].shape)),
)
_register(
    "mul", _binary(torch.mul),
    lambda e, p, o, g: (unbroadcast(g * p[1], p[0].shape),
                        unbroadcast(g * p[0], p[1].shape)),
)
_register(
    "div", _binary(torch.div),
    lambda e, p, o, g: (unbroadcast(g / p[1], p[0].shape),
                        unbroadcast(-g * p[0] / (p[1] * p[1]), p[1].shape)),
)
_register("neg", lambda e, a: -a, lambda e, p, o, g: (-g,))

# --------------------------------------------------------------------------
# elementwise unary

_register("pow", lambda e, a: a ** e[0],
          lambda e, p, o, g: (g * e[0] * p[0] ** (e[0] - 1),))
_register("sqrt", lambda e, a: torch.sqrt(a),
          lambda e, p, o, g: (g / (2.0 * o),))
_register("exp", lambda e, a: torch.exp(a), lambda e, p, o, g: (g * o,))
_register("ln", lambda e, a: torch.log(a), lambda e, p, o, g: (g / p[0],))
_register("relu", lambda e, a: torch.clamp_min(a, 0.0),
          lambda e, p, o, g: (g * (p[0] > 0.0).to(g.dtype),))
_register(
    "leaky_relu",
    lambda e, a: torch.where(a > 0.0, a, 0.01 * a),
    lambda e, p, o, g: (g * torch.where(p[0] > 0.0, 1.0, 0.01).to(g.dtype),),
)
_register("sigmoid", lambda e, a: torch.sigmoid(a),
          lambda e, p, o, g: (g * o * (1.0 - o),))
_register("tanh", lambda e, a: torch.tanh(a),
          lambda e, p, o, g: (g * (1.0 - o * o),))
_register(
    "softplus",
    lambda e, a: torch.logaddexp(a, torch.zeros_like(a)),
    lambda e, p, o, g: (g * torch.sigmoid(p[0]),),
)

# --------------------------------------------------------------------------
# softmax family; extra = (axis,)


def _softmax_vjp(e, p, o, g):
    return (o * (g - (g * o).sum(dim=e[0], keepdim=True)),)


def _log_softmax_vjp(e, p, o, g):
    return (g - torch.exp(o) * g.sum(dim=e[0], keepdim=True),)


def _softmax_last(a, log):
    return softmax_last_axis(a.contiguous(), log=log)


def _softmax_fwd(e, a, *, log=False):
    axis = e[0]
    if config.use_kernels and axis in (-1, a.dim() - 1):
        if sharded.is_dtensor(a):       # K4 on each rank's rows
            p = sharded.rows_placements(a, range(a.dim() - 1))
            return sharded.run_local(lambda x: _softmax_last(x, log), (a,),
                                     (p,), p)
        return _softmax_last(a, log)
    return torch.log_softmax(a, axis) if log else torch.softmax(a, axis)


_register("softmax", lambda e, a: _softmax_fwd(e, a), _softmax_vjp)
_register("log_softmax", lambda e, a: _softmax_fwd(e, a, log=True),
          _log_softmax_vjp)

# --------------------------------------------------------------------------
# reductions: full reductions to a 0-d scalar, and keepdims per-axis ones
# (extra = (axis,))

_register("sum", lambda e, a: a.sum(),
          lambda e, p, o, g: (g.expand(p[0].shape),))
_register("mean", lambda e, a: a.mean(),
          lambda e, p, o, g: ((g / p[0].numel()).expand(p[0].shape),))


def _axis_red_vjp(scale_by_n):
    def vjp(e, p, o, g):
        axis = e[0]
        if g.dim() < p[0].dim():
            g = g.unsqueeze(axis)
        g = g.expand(p[0].shape)
        if scale_by_n:
            g = g / p[0].shape[axis]
        return (g,)

    return vjp


_register("sum_axis", lambda e, a: a.sum(dim=e[0], keepdim=True),
          _axis_red_vjp(False))
_register("mean_axis", lambda e, a: a.mean(dim=e[0], keepdim=True),
          _axis_red_vjp(True))

# --------------------------------------------------------------------------
# shape ops


def _reverse_axes(a):
    return a.permute(*range(a.dim() - 1, -1, -1))


_register("t", lambda e, a: _reverse_axes(a),
          lambda e, p, o, g: (_reverse_axes(g),))
_register("unsqueeze", lambda e, a: a.unsqueeze(e[0]),
          lambda e, p, o, g: (g.squeeze(e[0]),))


def _chunk_index(starts, sizes):
    return tuple(slice(s, s + z) for s, z in zip(starts, sizes))


def _chunk_vjp(e, p, o, g):
    out = torch.zeros(p[0].shape, dtype=g.dtype, device=g.device)
    out[_chunk_index(e[0], g.shape)] = g
    return (out,)


_register("chunk", lambda e, a: a[_chunk_index(*e)], _chunk_vjp)


def _cat_vjp(e, p, o, g):
    axis = e[0]
    split = p[0].shape[axis]
    return (g.narrow(axis, 0, split),
            g.narrow(axis, split, g.shape[axis] - split))


_register("cat", lambda e, a, b: torch.cat((a, b), dim=e[0]), _cat_vjp)


def _multi_cat_vjp(e, p, o, g):
    axis = e[0]
    grads, off = [], 0
    for x in p:
        grads.append(g.narrow(axis, off, x.shape[axis]))
        off += x.shape[axis]
    return tuple(grads)


_register("multi_cat", lambda e, *xs: torch.cat(xs, dim=e[0]),
          _multi_cat_vjp)


def _stack_vjp(e, p, o, g):
    return tuple(g.select(e[0], i) for i in range(len(p)))


_register("stack", lambda e, a, b: torch.stack((a, b), dim=e[0]), _stack_vjp)
_register("multi_stack", lambda e, *xs: torch.stack(xs, dim=e[0]),
          _stack_vjp)

# --------------------------------------------------------------------------
# linear algebra; f32 accumulation, output in the left operand's dtype


def _mm(e, a, b):
    if config.use_kernels and a.dim() == 2 and b.dim() == 2:
        if sharded.is_dtensor(a) or sharded.is_dtensor(b):
            pa, pb, out = sharded.matmul_placements(a, b)   # K3 a rank
            return sharded.run_local(kernel_matmul, (a, b), (pa, pb), out)
        return kernel_matmul(a, b)
    x, y = _promote(a, b)
    return torch.matmul(x, y).to(a.dtype)


_register(
    "mm", _mm,
    # bwd-left g.R^T, bwd-right L^T.g
    lambda e, p, o, g: (_mm(e, g, p[1].T), _mm(e, p[0].T, g)),
)
_register(
    "mm_t", lambda e, a, b: _mm(e, a, b.T),
    # bwd-left g.R, bwd-right g^T.L
    lambda e, p, o, g: (_mm(e, g, p[1]), _mm(e, g.T, p[0])),
)
_register(
    "mv", lambda e, a, v: _mm(e, a, v[:, None])[:, 0],
    lambda e, p, o, g: (g[:, None] * p[1][None, :],
                        _mm(e, p[0].T, g[:, None])[:, 0]),
)
_register(
    "vm", lambda e, v, a: _mm(e, v[None, :], a)[0],
    lambda e, p, o, g: (_mm(e, p[1], g[:, None])[:, 0],
                        p[0][:, None] * g[None, :]),
)


def _vv_fwd(e, a, b):
    x, y = _promote(a, b)
    return torch.dot(x.float(), y.float()).to(a.dtype)


_register("vv", _vv_fwd, lambda e, p, o, g: (g * p[1], g * p[0]))


# batched matmul: lhs (..., K) @ rhs (K, N), f32 accumulation, output in
# lhs's dtype (plain torch, as it is plain XLA in JAX)
def _dot(x, y, out_dtype):
    x, y = _promote(x, y)
    return torch.matmul(x, y).to(out_dtype)


def _matmul_vjp(e, p, o, g):
    a, b = p
    da = _dot(g, b.T, a.dtype)
    K, N = b.shape
    db = _dot(a.reshape(-1, K).T, g.reshape(-1, N), b.dtype)
    return da, db


_register("matmul", lambda e, a, b: _dot(a, b, a.dtype), _matmul_vjp)

# dtype cast; extra = (dtype name,). The VJP casts the cotangent back.
_register("astype", lambda e, a: a.to(as_dtype(e[0])),
          lambda e, p, o, g: (g.to(p[0].dtype),))

# --------------------------------------------------------------------------
# dropout: Bernoulli(1-p) mask scaled 1/(1-p); identity when eval or p == 0;
# zeros when p == 1. The mask is regenerated from the recorded seed.


def _keep_mask(seed, shape, keep, device):
    """Bernoulli(keep) draws from `seed` on `device`. A "meta" tensor (shape
    inference) needs no draws."""
    if device.type == "meta":
        return torch.ones(shape, dtype=torch.bool, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) < keep


def _dropout_fwd(e, a, *, key, train):
    (p,) = e
    if not train or p == 0.0:
        return a
    if p == 1.0:
        return torch.zeros_like(a)
    mask = _keep_mask(key, a.shape, 1.0 - p, a.device)
    return torch.where(mask, a / (1.0 - p), 0.0)


def _dropout_vjp(e, prim, o, g, *, key, train):
    (p,) = e
    if not train or p == 0.0:
        return (g,)
    if p == 1.0:
        return (torch.zeros_like(g),)
    mask = _keep_mask(key, prim[0].shape, 1.0 - p, g.device)
    return (torch.where(mask, g / (1.0 - p), 0.0),)


_register("dropout", _dropout_fwd, _dropout_vjp, rng=True)

# --------------------------------------------------------------------------
# fused attention on the packed kv-group-major qkv projection
# (B, S, (H + 2 KV) hd) -> (B, S, H hd) head-major. extra = (n_head,
# n_kv_head, causal, rate, block). Dropout is status-gated like `dropout`.


def _attn_geometry(n_head, n_kv_head, width):
    kv = n_kv_head or n_head
    hd = width // (n_head + 2 * kv)
    if hd * (n_head + 2 * kv) != width:
        raise ValueError(f"packed qkv width {width} does not factor into "
                         f"H={n_head}, KV={kv} heads")
    return kv, hd


def _attn_xla(qkv, n_head, n_kv_head, causal, rate, key):
    """The composite (JAX's `_attn_xla`): the kernel's group-major unpack,
    f32 scores, softmax, optional dropout with the kernels' mask
    (`keep_mask` keyed by `key`), PV in f32, result in qkv's dtype."""
    b, s, w = qkv.shape
    kv, hd = _attn_geometry(n_head, n_kv_head, w)
    g_sz = n_head // kv
    parts = qkv.reshape(b, s, kv, g_sz + 2, hd)
    q = parts[:, :, :, :g_sz].reshape(b, s, n_head, hd).permute(0, 2, 1, 3)
    k = parts[:, :, :, g_sz].permute(0, 2, 1, 3)
    v = parts[:, :, :, g_sz + 1].permute(0, 2, 1, 3)
    if kv != n_head:
        k = k.repeat_interleave(g_sz, dim=1)
        v = v.repeat_interleave(g_sz, dim=1)
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = keep_mask(key, b, n_head, s, s, rate, qkv.device)
        weights = torch.where(keep, weights / (1.0 - rate), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype).float(),
                       v.float()).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, n_head * hd)


def _attn_use_kernel(qkv, n_head, n_kv_head, rate):
    """True on the card where the kernels take the shape, and the op runs
    K1/K2: f32 or bf16, head dim 1 to 256, any number of query heads per kv
    head, a dropout rate below 1. False elsewhere, and for CPU and meta
    tensors: those run the composite, as JAX's op takes its composite where
    the backend is no TPU or the shape does not qualify (JAX gates on the
    TPU's S % 128 and hd % 128 tiling; the CUDA kernels mask any S)."""
    if qkv.device.type != "cuda" or rate >= 1.0:
        return False
    kv, hd = _attn_geometry(n_head, n_kv_head, qkv.shape[-1])
    return kernels_take(qkv.dtype, hd) and n_head % kv == 0


def _attn_local(qkv, n_head, n_kv_head, causal, rate, key):
    if _attn_use_kernel(qkv, n_head, n_kv_head, rate):
        # `block` sizes the TPU's tiles; the CUDA kernels choose their own.
        # The mask is keyed by the executor's seed, as the composite's.
        out, _ = flash_fwd_qkv(qkv.contiguous(), n_head, n_kv_head, causal,
                               fast_softmax=True, seed=key, rate=rate)
        return out
    return _attn_xla(qkv, n_head, n_kv_head, causal, rate, key)


def _attn_vjp_local(qkv, o, g, n_head, n_kv_head, causal, rate, key):
    if _attn_use_kernel(qkv, n_head, n_kv_head, rate):
        # The tape keeps the op's output but not K1's lse, so K1 runs again
        # for it (JAX's `jax.vjp` re-traces the forward the same way): each
        # step launches K1 twice per attention op, then the fused K2, both
        # with the forward's seed.
        qkv = qkv.contiguous()
        _, lse = flash_fwd_qkv(qkv, n_head, n_kv_head, causal,
                               fast_softmax=True, seed=key, rate=rate)
        return flash_bwd_fused_qkv(qkv, o.contiguous(), lse,
                                   g.to(qkv.dtype).contiguous(), n_head,
                                   n_kv_head, causal, seed=key, rate=rate)
    with torch.enable_grad():
        q = qkv.detach().requires_grad_()
        out = _attn_xla(q, n_head, n_kv_head, causal, rate, key)
        (dq,) = torch.autograd.grad(out, q, g)
    return dq


def _attn_rows(qkv, rate):
    """A sharded qkv's placements for the per-rank kernels: the batch
    split kept, any other split gathered. The dropout mask counts the
    batch row from 0 in every launch, so a split batch would draw other
    rows than the unsharded run's: refused."""
    p = sharded.rows_placements(qkv, (0,))
    if rate > 0.0 and any(x.is_shard(0) for x in p):
        raise NotImplementedError(
            "flash_attention with dropout on a batch split over ranks: the "
            "kernels' mask counts the batch from 0 on each rank; train the "
            "sharded tape at dropout 0 or with whole leaves (ROADMAP.md "
            "queue 1 item 5)")
    return p


def _attn_fwd(e, qkv, *, key, train):
    n_head, n_kv_head, causal, rate, _ = e
    rate = float(rate) if train else 0.0
    if sharded.is_dtensor(qkv):         # K1 on each rank's rows
        p = _attn_rows(qkv, rate)
        return sharded.run_local(
            lambda t: _attn_local(t, n_head, n_kv_head, causal, rate, key),
            (qkv,), (p,), p)
    return _attn_local(qkv, n_head, n_kv_head, causal, rate, key)


def _attn_vjp(e, p, o, g, *, key, train):
    n_head, n_kv_head, causal, rate, _ = e
    qkv = p[0]
    rate = float(rate) if train else 0.0
    if sharded.is_dtensor(qkv):         # K1 and the fused K2 a rank
        pl = _attn_rows(qkv, rate)
        return (sharded.run_local(
            lambda q, out, dout: _attn_vjp_local(
                q, out, dout, n_head, n_kv_head, causal, rate, key),
            (qkv, o, g), (pl, pl, pl), pl),)
    return (_attn_vjp_local(qkv, o, g, n_head, n_kv_head, causal, rate,
                            key),)


_register("flash_attention", _attn_fwd, _attn_vjp, rng=True)

# --------------------------------------------------------------------------
# padding; extra = (padding per trailing axis, mode, value). Padding applies
# symmetrically to the LAST len(padding) axes.


def _pad_index(n, w, mode, device):
    """Source indices of a length-n axis padded by w on each side."""
    i = torch.arange(-w, n + w, device=device)
    if mode == "replicative":
        return i.clamp(0, n - 1)
    i = i.abs()                                   # reflect at 0
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)   # and at n - 1


def _pad_fwd(e, a):
    padding, mode, value = e
    lead = a.dim() - len(padding)
    if mode in ("zero", "constant"):
        flat = [w for w in reversed(padding) for _ in (0, 1)]
        return F.pad(a, flat, value=value if mode == "constant" else 0.0)
    if mode not in ("reflective", "replicative"):
        raise ValueError(f"unknown padding mode: {mode}")
    for ax, w in enumerate(padding, start=lead):
        if w:
            a = a.index_select(ax, _pad_index(a.shape[ax], w, mode,
                                              a.device))
    return a


def _pad_vjp(e, p, o, g):
    padding, _, _ = e
    lead = g.dim() - len(padding)
    sl = (slice(None),) * lead + tuple(
        slice(w, dim - w) for w, dim in zip(padding, g.shape[lead:]))
    return (g[sl],)


_register("pad", _pad_fwd, _pad_vjp)

# --------------------------------------------------------------------------
# convolution: input (N, Ci, *spatial), kernel (Co, Ci/groups, *k), VALID
# (padding composes through `pad`); extra = (stride, dilation, groups). The
# operand order is (kernel, input): the reference's receiver is the kernel.

_LIB_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_LIB_CONV_INPUT = {1: torch.nn.grad.conv1d_input,
                   2: torch.nn.grad.conv2d_input,
                   3: torch.nn.grad.conv3d_input}
_LIB_CONV_WEIGHT = {1: torch.nn.grad.conv1d_weight,
                    2: torch.nn.grad.conv2d_weight,
                    3: torch.nn.grad.conv3d_weight}


def _conv_lib(e, kernel, inp):
    """The library convolution (JAX's lax conv): promoted operands, f32
    accumulation, the result in the input's dtype."""
    stride, dilation, groups = e
    k, x = _promote(kernel, inp)
    return _LIB_CONV[len(stride)](x, k, stride=stride, dilation=dilation,
                                  groups=groups).to(inp.dtype)


def _conv_use_kernels(e, kernel, inp) -> bool:
    """Whether `convolution` takes the direct-conv kernels: under
    `use_kernels`, when `conv_route` is "force" or the per-shape table picks
    them for tensors on the card (JAX's route, with `on_tpu()` read as
    "the tensors are on the card"; the table was measured on a TPU v5e,
    and `route_conv2d` sends its rank-2 row to the library on the card,
    where K12 lost to it at batch 1-4)."""
    if not config.use_kernels:
        return False
    stride, dilation, groups = e
    nd = len(stride)
    kw = {"batch": inp.shape[0]}
    if nd in (1, 2):
        k = kernel.shape[2:]
        # the padded sample and the kernel the TPU kernel holds in VMEM
        sample = (((inp.shape[2] + 2) * inp.shape[3]) if nd == 2
                  else inp.shape[2] + k[0])
        kw.update(ksize=k[0] if len(set(k)) == 1 else 0,
                  sample_bytes=sample * inp.shape[1] * inp.element_size(),
                  weight_bytes=kernel.numel() * kernel.element_size())
    return route_conv2d(nd, stride, dilation, groups,
                        on_card=inp.device.type == "cuda",
                        **kw) == "pallas"


def _conv_fwd(e, kernel, inp):
    """Under the kernel route, JAX's shape gates: 2-d with stride 1 or
    dilation 1 -> K12 (any groups: the TPU's lane-alignment gate on groups
    does not apply); 1-d with groups 1 -> K14 (K12 when strided); 3-d with
    stride 1 and groups 1 -> K15. Everything else is the library
    convolution, as JAX sends it to XLA."""
    stride, dilation, groups = e
    nd = len(stride)
    if _conv_use_kernels(e, kernel, inp):
        if nd == 2 and (stride == (1, 1) or dilation == (1, 1)):
            return conv2d_direct(inp, kernel, dilation, stride, groups=groups)
        if nd == 1 and groups == 1:
            return conv1d_direct_nwc(inp.transpose(1, 2),
                                     kernel.permute(2, 1, 0), dilation[0],
                                     stride[0]).transpose(1, 2)
        if nd == 3 and groups == 1 and stride == (1, 1, 1):
            out = conv3d_direct_ndhwc(inp.permute(0, 2, 3, 4, 1),
                                      kernel.permute(2, 3, 4, 1, 0), dilation)
            return out.permute(0, 4, 1, 2, 3)
    return _conv_lib(e, kernel, inp)


def _conv_vjp(e, p, o, g):
    # the transposed library convolutions, whichever route ran forward (JAX
    # transposes the lax conv)
    stride, dilation, groups = e
    kernel, inp = p
    # contiguous operands: see ops/conv.py on channels-last views
    k, x = (t.contiguous() for t in _promote(kernel, inp))
    g = g.to(x.dtype).contiguous()
    nd = len(stride)
    dk = _LIB_CONV_WEIGHT[nd](x, k.shape, g, stride, dilation=dilation,
                              groups=groups)
    dx = _LIB_CONV_INPUT[nd](x.shape, k, g, stride, dilation=dilation,
                             groups=groups)
    return dk.to(kernel.dtype), dx.to(inp.dtype)


_register("convolution", _conv_fwd, _conv_vjp)

# --------------------------------------------------------------------------
# pooling: VALID windows over the trailing len(window) axes; extra =
# (window, stride). Plain torch, as it is plain XLA in JAX.


def _windows(a, window, stride):
    """A view of `a` with every window: (*lead, *out, *window)."""
    lead = a.dim() - len(window)
    for i, (w, s) in enumerate(zip(window, stride)):
        a = a.unfold(lead + i, w, s)
    return a


def _max_pool_fwd(e, a):
    window, stride = e
    return _windows(a, window, stride).flatten(-len(window)).amax(-1)


def _max_pool_vjp(e, p, o, g):
    # the gradient goes to the first maximum of each window (XLA's
    # select-and-scatter), summed where windows overlap
    window, stride = e
    (x,) = p
    win = _windows(x, window, stride).flatten(-len(window))
    pos = _windows(torch.arange(x.numel(), device=x.device).reshape(x.shape),
                   window, stride).flatten(-len(window))
    src = pos.gather(-1, win.argmax(-1, keepdim=True))
    dx = torch.zeros(x.numel(), dtype=g.dtype, device=g.device)
    return (dx.index_add_(0, src.reshape(-1), g.reshape(-1)).reshape(
        x.shape),)


def _avg_pool_fwd(e, a):
    window, stride = e
    return _windows(a, window, stride).sum(
        tuple(range(-len(window), 0))) / math.prod(window)


def _avg_pool_vjp(e, p, o, g):
    (x,) = p
    with torch.enable_grad():
        t = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(_avg_pool_fwd(e, t), t, g)
    return (dx,)


_register("max_pool", _max_pool_fwd, _max_pool_vjp)
_register("avg_pool", _avg_pool_fwd, _avg_pool_vjp)

# --------------------------------------------------------------------------
# losses: scalar criteria with reduction "sum" or "mean"; extra =
# (reduction,). Operands (input, target); the target gets no gradient.


def _mean_or_sum(e, total, n):
    return total / n if e[0] == "mean" else total


def _mae_fwd(e, inp, tgt):
    return _mean_or_sum(e, (inp - tgt).abs().sum(), inp.numel())


def _mae_vjp(e, p, o, g):
    inp, tgt = p
    return (_mean_or_sum(e, torch.sign(inp - tgt) * g, inp.numel()), None)


_register("mae", _mae_fwd, _mae_vjp)


def _mse_fwd(e, inp, tgt):
    return _mean_or_sum(e, ((inp - tgt) ** 2).sum(), inp.numel())


def _mse_vjp(e, p, o, g):
    inp, tgt = p
    return (_mean_or_sum(e, 2.0 * (inp - tgt) * g, inp.numel()), None)


_register("mse", _mse_fwd, _mse_vjp)


def _clamped_log(x):
    return torch.clamp_min(torch.log(x), -100.0)


def _bce_fwd(e, inp, tgt):
    total = -(tgt * _clamped_log(inp)
              + (1.0 - tgt) * _clamped_log(1.0 - inp)).sum()
    return _mean_or_sum(e, total, inp.numel())


def _bce_vjp(e, p, o, g):
    inp, tgt = p
    eps = torch.finfo(inp.dtype).tiny
    d = (inp - tgt) / torch.clamp_min(inp * (1.0 - inp), eps) * g
    return (_mean_or_sum(e, d, inp.numel()), None)


_register("bce", _bce_fwd, _bce_vjp)


def _bce_logits_fwd(e, inp, tgt):
    m = torch.clamp_min(-inp, 0.0)
    total = ((1.0 - tgt) * inp + m
             + torch.log(torch.exp(-m) + torch.exp(-inp - m))).sum()
    return _mean_or_sum(e, total, inp.numel())


def _bce_logits_vjp(e, p, o, g):
    inp, tgt = p
    return (_mean_or_sum(e, (torch.sigmoid(inp) - tgt) * g, inp.numel()),
            None)


_register("bce_with_logits", _bce_logits_fwd, _bce_logits_vjp)


def _kldiv_fwd(e, inp, tgt):
    # input = log-probabilities; masked where target == 0
    pos = tgt > 0.0
    elt = torch.where(pos, tgt * (torch.log(torch.where(pos, tgt, 1.0))
                                  - inp), 0.0)
    return _mean_or_sum(e, elt.sum(), inp.shape[0])


def _kldiv_vjp(e, p, o, g):
    inp, tgt = p
    return (_mean_or_sum(e, -tgt * g, tgt.shape[0]), None)


_register("kldiv", _kldiv_fwd, _kldiv_vjp)


def _class_index(tgt):
    """(1, ...) int64 class indices from float targets (truncating, as
    JAX's astype(int32))."""
    return tgt.to(torch.int64).unsqueeze(0)


def _nll_picked(inp, tgt):
    return inp.gather(0, _class_index(tgt)).sum()


def _nll_onehot(inp, tgt, val):
    idx = _class_index(tgt)
    return torch.zeros_like(inp).scatter_(0, idx,
                                          val.to(inp.dtype).expand(idx.shape))


def _nll_fwd(e, inp, tgt):
    # class axis FIRST: input (C, ...), target (...); total = sum over j of
    # input[target[j], j]; `mean` divides by C, as the reference does
    if sharded.is_dtensor(inp) or sharded.is_dtensor(tgt):
        # each rank picks its own columns: a partial sum
        pi, pt, out = sharded.class_axis_placements(inp, tgt, partial=True)
        total = sharded.run_local(_nll_picked, (inp, tgt), (pi, pt), out)
    else:
        total = _nll_picked(inp, tgt)
    return -total / inp.shape[0] if e[0] == "mean" else -total


def _nll_vjp(e, p, o, g):
    inp, tgt = p
    # -onehot * g, divided by target.numel() (not C) for `mean`; the
    # one-hot is a scatter into zeros in the input's dtype
    val = -g / tgt.numel() if e[0] == "mean" else -g
    if sharded.is_dtensor(inp) or sharded.is_dtensor(tgt):
        # each rank scatters into its own columns
        pi, pt, out = sharded.class_axis_placements(inp, tgt)
        mesh = sharded.leaf_mesh((inp, tgt))
        d = sharded.run_local(_nll_onehot, (inp, tgt, val),
                              (pi, pt, sharded.replicate(mesh)), out)
    else:
        d = _nll_onehot(inp, tgt, val)
    return (d, None)


_register("nll", _nll_fwd, _nll_vjp)

# --------------------------------------------------------------------------
# reshape; extra = (new_shape,)
_register("reshape", lambda e, a: a.reshape(e[0]),
          lambda e, p, o, g: (g.reshape(p[0].shape),))


# embedding: operands (weight (V, D), float ids (...)); the VJP scatter-adds
# into the table
def _embedding_grad(w, ids, g):
    return torch.zeros_like(w).index_put_((ids.to(torch.int64),),
                                          g.to(w.dtype), accumulate=True)


def _embedding_vjp(e, p, o, g):
    w, ids = p
    if sharded.is_dtensor(ids) or sharded.is_dtensor(g):
        # each rank scatters its own rows: the table's gradient is the
        # sum of the ranks' (a partial sum over each split mesh dim)
        pi, pw, pg, out = sharded.embedding_placements(w, ids, g)
        return (sharded.run_local(_embedding_grad, (w, ids, g),
                                  (pw, pi, pg), out), None)
    return (_embedding_grad(w, ids, g), None)


_register("embedding", lambda e, w, ids: w[ids.to(torch.int64)],
          _embedding_vjp)
