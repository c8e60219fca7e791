"""Differentiable collectives over process groups: the explicit form of
what GSPMD inserts from JAX's stated shardings.

Each op names what its backward does, so the gradient of a sharded
program is the gradient of the whole program: Megatron's two conjugate
ops (`copy_to`: identity forward, all-reduce backward; `reduce_from`:
all-reduce forward, identity backward), the sequence-parallel pair
(`gather`: all-gather forward, reduce-scatter backward; `scatter`:
reduce-scatter forward, all-gather backward), `gather(...,
grad="slice")`, an all-gather whose consumers compute the same gradient
on every rank, so that each keeps its own slice of it, and its
conjugate `split` (this rank's slice forward, all-gather backward).
`all_to_all` is JAX's tiled `lax.all_to_all` (backward: the reverse
all-to-all). A group of one rank, or None, makes every op the identity.
`all_reduce` (a sum, or a max) and `broadcast` are the plain collectives
the tensor-parallel serving programs run under `torch.no_grad`.

`ring_shift` moves tensors one rank forward around a group with
`batch_isend_irecv` (ring attention's hop); `pp_exchange` is one tick of
a pipeline's traffic, activations to the next stage and cotangents to
the previous one in one `batch_isend_irecv`, and `send_next` its
differentiable form (JAX's `lax.ppermute` to stage s + 1, whose
backward sends the cotangent to s - 1)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["copy_to", "reduce_from", "gather", "scatter", "split",
           "all_to_all", "all_reduce", "broadcast", "ring_shift",
           "pp_exchange", "send_next"]


# torch 2.13 names them *_single and deprecates the older names, which
# are the only ones before it
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _live(group) -> bool:
    return group is not None and dist.get_world_size(group) > 1


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, groups: Sequence,
               op: str = "sum") -> torch.Tensor:
    """x summed (`op="sum"`) or its elementwise max taken (`op="max"`)
    over every group in `groups`, in place (not differentiable). Over
    groups of independent mesh axes either composes: the result is the
    reduction over the product of the axes."""
    for g in groups:
        if _live(g):
            dist.all_reduce(x, op=_OPS[op], group=g)
    return x


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """x as rank `src` of `group` holds it, on every rank of the group, in
    place (not differentiable)."""
    if _live(group):
        dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _all_gather(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xt.shape[0]} does not split "
                         f"over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _reduce_scatter(out, xt, group=group)
    return out.movedim(0, dim)


def _slice_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim)[r].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), (group,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.args = (dim, group, grad)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, grad = ctx.args
        fn = _scatter_dim if grad == "sum" else _slice_dim
        return fn(g, dim, group), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _gather_dim(g, dim, group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _slice_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _gather_dim(g.contiguous(), dim, group), None, None


def _all_to_all(x: torch.Tensor, split: int, concat: int, group):
    n = dist.get_world_size(group)
    xt = x.movedim(split, 0)
    if xt.shape[0] % n:
        raise ValueError(f"dim {split} of size {xt.shape[0]} does not split "
                         f"over {n} ranks")
    xt = xt.reshape((n, xt.shape[0] // n) + tuple(xt.shape[1:])).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    # out[i] is rank i's block: put the split dim back, then rank i's block
    # i-th along `concat`
    out = out.movedim(1, split + 1).movedim(0, concat)
    shape = tuple(out.shape)
    return out.reshape(shape[:concat] + (n * shape[concat + 1],)
                       + shape[concat + 2:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        return _all_to_all(g, concat, split, group), None, None, None


def copy_to(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """x itself; its gradient is summed over `groups` (the ranks whose
    contributions to it differ)."""
    groups = tuple(g for g in groups if _live(g))
    return _CopyTo.apply(x, groups) if groups else x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`; the gradient passes unchanged."""
    return _ReduceFrom.apply(x, group) if _live(group) else x


def gather(x: torch.Tensor, dim: int, group, grad: str = "sum"):
    """The ranks' x concatenated along `dim` in rank order. Backward:
    `grad="sum"` reduce-scatters (the ranks' gradients differ and add up),
    `grad="slice"` keeps this rank's slice (they are the same)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad={grad!r}: want 'sum' or 'slice'")
    return _Gather.apply(x, dim, group, grad) if _live(group) else x


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """x summed over `group`, this rank keeping its slice of `dim`; the
    backward all-gathers."""
    return _Scatter.apply(x, dim, group) if _live(group) else x


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of `dim` (x the same on every rank of `group`);
    the backward all-gathers the ranks' gradients of their slices."""
    return _Split.apply(x, dim, group) if _live(group) else x


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """JAX's `lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`:
    `split_dim` cut into one block a rank of `group`, block j sent to rank
    j, the blocks received concatenated along `concat_dim` in rank order.
    The backward is the reverse all-to-all."""
    if not _live(group):
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def _send_recv(sends, recvs, group) -> None:
    """One `batch_isend_irecv` of `sends` [(tensor, global dst)] and
    `recvs` [(out tensor, global src)]. Gloo's point-to-point ops read
    host memory only, so over gloo CUDA tensors travel through host
    copies (ranks sharing a card)."""
    stage = dist.get_backend(group) == "gloo" and any(
        t.is_cuda for t, _ in (*sends, *recvs))
    if stage:
        sends = [(t.cpu(), d) for t, d in sends]
        host = [(torch.empty(o.shape, dtype=o.dtype), s) for o, s in recvs]
    ops = ([dist.P2POp(dist.isend, t, d, group) for t, d in sends]
           + [dist.P2POp(dist.irecv, o, s, group)
              for o, s in (host if stage else recvs)])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if stage:
        for (o, _), (h, _) in zip(recvs, host):
            o.copy_(h)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> list:
    """Each tensor sent to the next rank of `group` and replaced by the one
    the previous rank sent (rank i's go to rank i + 1 mod n), by one
    `batch_isend_irecv`."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + 1) % n)
    src = dist.get_global_rank(group, (r - 1) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    _send_recv([(t, dst) for t in sends], [(o, src) for o in outs], group)
    return outs


def pp_exchange(to_next, to_prev, group):
    """One tick of a pipeline over `group` (its stages in rank order), by
    one `batch_isend_irecv`: `to_next` goes to the next stage and
    `to_prev` to the previous one. Returns (what the previous stage sent,
    what the next stage sent), None where there is no such stage or where
    nothing travels that way: every rank passes a tensor, or None, for
    each direction on the same tick, and receives into a tensor shaped
    like the one it sends."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sends, recvs, got = [], [], [None, None]
    for i, (t, peer) in enumerate(((to_next, r + 1), (to_prev, r - 1))):
        if t is None:
            continue
        src = r - 1 if i == 0 else r + 1
        if 0 <= peer < n:
            sends.append((t.contiguous(), dist.get_global_rank(group, peer)))
        if 0 <= src < n:
            got[i] = torch.empty_like(t, memory_format=torch.contiguous_format)
            recvs.append((got[i], dist.get_global_rank(group, src)))
    _send_recv(sends, recvs, group)
    return got[0], got[1]


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        got, _ = pp_exchange(x, None, group)
        return torch.zeros_like(x) if got is None else got

    @staticmethod
    def backward(ctx, g):
        _, got = pp_exchange(None, g, ctx.group)
        return (torch.zeros_like(g) if got is None else got), None


def send_next(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's `lax.ppermute(x, axis, [(i, i + 1) ...])`: x sent to the next
    rank of `group`, the previous rank's x returned (zeros on rank 0). The
    backward sends the cotangent to the previous rank (ppermute's
    transpose; the last rank's input gets zeros). Every rank of the group
    must call it, and run its backward, in the same order."""
    if not _live(group):
        return torch.zeros_like(x)
    return _SendNext.apply(x, group)
