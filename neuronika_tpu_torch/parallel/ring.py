"""Ring attention: context parallelism over a process group (counterpart
of `neuronika_tpu/parallel/ring.py`).

The sequence axis of attention is sharded over the ranks of a group (a
mesh's `cp` axis). Each rank keeps its query block; the key/value blocks
travel around the ring one hop a step (`collectives.ring_shift`, one
`batch_isend_irecv` to the next rank), so the full sequence never
gathers on any rank.

* Each hop runs the split flash kernels (`ops/flash_attention.py`): K5
  forward, K6 and K7 backward on CUDA tensors, their plain versions on
  CPU tensors. The ring adds only the block rotation and the combine.
* Partial outputs merge with the base-2 log-sum-exp K5 emits:
  out = sum_j 2^(lse_j - M) o_j / sum_j 2^(lse_j - M). The combine is
  exact.
* Causality across blocks: with query block i and the hop-h key/value
  block (i - h) mod n, the block is entirely in the past iff h <= i and
  entirely in the future otherwise. Hop 0 is the diagonal block and runs
  the causal kernel. JAX cannot branch per chip and runs the future hops
  with zero weight; a rank here skips them (the same result: those
  contributions are exactly zero there).
* The backward runs K6/K7 per live hop with the GLOBAL lse and delta =
  rowsum(dO.O), so p = 2^(s - lse) are the true attention weights. dq
  accumulates at home; the f32 dk/dv accumulators travel with their
  key/value block and are home again after n hops.

`ring_forward` and `ring_backward` take lists over the ranks a process
runs and a `shift` that moves per-rank tuples one rank forward: the
distributed op runs one rank per process (`ring_shift`); `chip_smoke.py`
runs every rank of a virtual ring in one process with a list rotation,
through the same code.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash_attention as FA
from .collectives import ring_shift

__all__ = ["ring_flash_attention", "ring_forward", "ring_backward",
           "hop_live", "hop_forward", "hop_backward", "rotate"]


def hop_live(rank: int, hop: int, causal: bool) -> bool:
    """Whether rank `rank`'s hop `hop` block holds keys its queries see:
    every hop without causality, else the hops whose block is not in the
    future (hop <= rank)."""
    return not causal or hop <= rank


def hop_forward(q, k, v, causal: bool, scale):
    """One hop's (o, lse): K5 on CUDA tensors (counted in
    `flash_fwd.launches`), its plain version on CPU tensors."""
    if q.device.type == "cuda":
        return FA.flash_fwd(q, k, v, causal, scale)
    return FA.flash_attention_fwd_reference(q, k, v, causal, scale)


def hop_backward(q, k, v, do, lse, delta, causal: bool, scale):
    """One hop's (dq, dk, dv) from the global lse and delta: K6 and K7 on
    CUDA tensors, their plain version on CPU tensors."""
    if q.device.type == "cuda":
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        return (dq,) + FA.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        scale)
    return FA.flash_attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                            scale)


def rotate(items: list) -> list:
    """`shift` of a virtual ring held in one process: rank i's items go to
    rank i + 1 (mod n)."""
    return items[-1:] + items[:-1]


def ring_forward(qs, ks, vs, ranks, n: int, causal: bool, scale, shift):
    """(outs, lses) of the ranks in `ranks` (their q, k, v blocks (B, H,
    S/n, hd) in qs, ks, vs) on a ring of n: out in q's dtype, lse (B, H,
    S/n) f32 base 2, global over the ring. `shift` moves a list of per-rank
    tuples one rank forward."""
    m = [torch.full(q.shape[:3], -torch.inf, device=q.device) for q in qs]
    l = [torch.zeros(q.shape[:3], device=q.device) for q in qs]
    acc = [torch.zeros(q.shape, device=q.device) for q in qs]
    kv = list(zip(ks, vs))
    for h in range(n):
        if h:
            kv = shift(kv)
        for j, i in enumerate(ranks):
            if not hop_live(i, h, causal):
                continue
            o_h, lse_h = hop_forward(qs[j], *kv[j], causal and h == 0,
                                     scale)
            m_new = torch.maximum(m[j], lse_h)
            alpha = torch.exp2(m[j] - m_new)
            w = torch.exp2(lse_h - m_new)
            acc[j] = acc[j] * alpha[..., None] + o_h.float() * w[..., None]
            l[j] = l[j] * alpha + w
            m[j] = m_new
    outs = [(a / s[..., None]).to(q.dtype) for a, s, q in zip(acc, l, qs)]
    return outs, [mj + torch.log2(lj) for mj, lj in zip(m, l)]


def ring_backward(qs, ks, vs, outs, dos, lses, ranks, n: int, causal: bool,
                  scale, shift):
    """(dqs, dks, dvs) of the ranks in `ranks`, each in its input's dtype,
    dk and dv on the rank that holds the block. The hop's dk/dv accumulate
    in f32 buffers that travel with their block."""
    deltas = [(do.float() * o.float()).sum(-1) for do, o in zip(dos, outs)]
    dq = [torch.zeros(q.shape, device=q.device) for q in qs]
    carry = [(k, v, torch.zeros(k.shape, device=k.device),
              torch.zeros(v.shape, device=v.device)) for k, v in zip(ks, vs)]
    for h in range(n):
        for j, i in enumerate(ranks):
            if not hop_live(i, h, causal):
                continue
            kh, vh, dk, dv = carry[j]
            dq_h, dk_h, dv_h = hop_backward(qs[j], kh, vh, dos[j], lses[j],
                                            deltas[j], causal and h == 0,
                                            scale)
            dq[j] += dq_h.float()
            carry[j] = (kh, vh, dk + dk_h.float(), dv + dv_h.float())
        if h < n - 1:
            carry = shift(carry)
        else:         # the accumulators' last hop takes them home
            carry = shift([c[2:] for c in carry])
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [c[0].to(k.dtype) for c, k in zip(carry, ks)],
            [c[1].to(v.dtype) for c, v in zip(carry, vs)])


def _group_shift(group):
    def shift(items):
        (t,) = items
        return [tuple(ring_shift(t, group))]
    return shift


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        shift = _group_shift(group)
        (out,), (lse,) = ring_forward([q], [k], [v], [i], n, causal, scale,
                                      shift)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, i, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, i, causal, scale = ctx.args
        (dq,), (dk,), (dv,) = ring_backward(
            [q], [k], [v], [out], [do.contiguous()], [lse], [i], n, causal,
            scale, _group_shift(group))
        return dq, dk, dv, None, None, None


def ring_flash_attention(q, k, v, group, axis_size: int | None = None,
                         causal: bool = True, scale=None):
    """Flash attention with q, k, v (B, H, S/n, hd) this rank's block of
    the sequence, sharded over the n ranks of `group` (JAX's `axis_name`;
    a mesh axis's group) in rank order; differentiable. Equal to
    `flash_attention` on the gathered arrays, without gathering them.
    `axis_size`, if given, must be n. Sliding windows and dropout are not
    supported on the ring (the model raises for them, as JAX's does).
    The kernels choose their own tiles and take any local S."""
    n = dist.get_world_size(group)
    if axis_size is not None and axis_size != n:
        raise ValueError(f"axis_size {axis_size} != the group's {n} ranks")
    if q.shape != k.shape or k.shape != v.shape or q.dim() != 4:
        raise ValueError(f"want q, k, v of one shape (B, H, S/n, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _RingAttention.apply(q, k, v, group, causal, scale)
