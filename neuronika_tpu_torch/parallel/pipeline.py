"""Microbatched pipeline parallelism over a `pp` axis (counterpart of
`neuronika_tpu/parallel/pipeline.py`).

Stage s holds its own slice of the stacked layer parameters; microbatches
flow stage to stage. Two schedules, as JAX's:

* `pipeline_forward`: GPipe fill/drain, `n_micro + n_stages - 1` ticks.
  Stage 0 takes a fresh microbatch each tick, earlier outputs ripple down
  the stages, the last stage collects the results, which every stage then
  receives. It is differentiable: its backward is the reversed schedule
  (cotangents ripple to the previous stage: ppermute's transpose), with
  every tick's activations kept from the forward (GPipe's memory).
* `pipeline_train_1f1b`: one forward and one backward a tick. Microbatch
  m forwards at stage s on tick s + m and backwards on tick
  2 (P - 1) - s + m, M + 2 (P - 1) ticks in all; a stage keeps only its
  inputs, in a ring of R = min(M, 2P - 1) slots, and reruns its forward
  at backward time (`torch.autograd.grad` on the saved input, where JAX
  takes `jax.vjp`). The last stage takes each microbatch's loss, its
  dL/dy and the loss params' gradients the tick the microbatch finishes;
  stage 0's dx is the microbatch input's cotangent. `stage_fn` returns
  (y, aux) and aux_weight / M * (sum over stages and microbatches of aux)
  joins the objective.

A stage skips its launch on a bubble tick (JAX computes there and masks
the result) but never the exchange: each tick's activations and
cotangents travel in one `collectives.pp_exchange` (one
`batch_isend_irecv`) on every rank. Each schedule is written once over
lists of the stages a process runs and an `exchange` that moves them: on a
mesh a process runs its own stage and the exchange is point to point
between ranks; with `mesh=None` and `n_stages`, one process runs every
stage of a virtual pipeline and the exchange moves list entries (what
`chip_smoke.py` runs on one card). Both make the same calls in the same
order.

`stage_fn(stage_params, x)` takes one stage's params (the leading stage
axis taken off). Stage params come with a leading stage axis: the stacked
(n_stages, ...) tree, or on a mesh the rank's own shard (a leading axis of
1, or a DTensor split over the axis).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._tree import tree_leaves, tree_map, tree_unflatten
from .collectives import pp_exchange

__all__ = ["pipeline_forward", "pipeline_train_1f1b", "Stages"]


class Stages:
    """The stages one process runs and how their tensors travel: on a
    `mesh`, the rank's stage on `axis`; with `mesh=None`, all `n_stages`
    stages of a virtual pipeline in this process."""

    def __init__(self, mesh=None, axis: str = "pp", n_stages: int = None):
        if mesh is None:
            if not n_stages or n_stages < 1:
                raise ValueError("a virtual pipeline (mesh=None) needs "
                                 "n_stages >= 1")
            self.n, self.group, self.stages = n_stages, None, list(
                range(n_stages))
            return
        names = mesh.mesh_dim_names
        if axis not in names:
            raise ValueError(f"mesh axes {names} have no {axis!r} axis")
        self.n = mesh.size(names.index(axis))
        if n_stages is not None and n_stages != self.n:
            raise ValueError(f"n_stages {n_stages} != the mesh's {axis} "
                             f"size {self.n}")
        self.group = mesh.get_group(axis)
        self.stages = [mesh.get_local_rank(axis)]

    @property
    def last(self) -> int:
        return self.n - 1

    def exchange(self, fwd, bwd):
        """Each stage's `fwd` entry to the next stage and `bwd` entry to
        the previous one (either list may be None): (the entries each
        stage received from its previous stage, from its next stage), None
        where none arrives."""
        if self.group is None:
            f = None if fwd is None else [None] + fwd[:-1]
            b = None if bwd is None else bwd[1:] + [None]
            return f, b
        f, b = pp_exchange(None if fwd is None else fwd[0],
                           None if bwd is None else bwd[0], self.group)
        return ([f] if fwd is not None else None,
                [b] if bwd is not None else None)

    def from_stage(self, s: int, t):
        """Stage s's `t` on every rank of the axis (the others pass a
        tensor of its shape to receive into)."""
        src = dist.get_global_rank(self.group, s)
        dist.broadcast(t, src, group=self.group)
        return t

    def split(self, params) -> list:
        """One tree a local stage from stage params with a leading stage
        axis."""
        def pick(leaf, s):
            if hasattr(leaf, "to_local"):
                leaf = leaf.to_local()
            if self.group is None or leaf.shape[0] == self.n:
                return leaf[s]
            if leaf.shape[0] != 1:
                raise ValueError(f"a stage leaf of leading dim "
                                 f"{leaf.shape[0]}: want {self.n} or this "
                                 f"rank's 1")
            return leaf[0]

        return [tree_map(lambda l, s=s: pick(l, s), params)
                for s in self.stages]

    def stack(self, trees):
        """Per local stage trees -> one tree with a leading stage axis."""
        return tree_map(lambda *ls: torch.stack(ls), *trees)


def _grads(outputs, cotangents, inputs):
    """torch.autograd.grad of the outputs that need it, zeros for the
    inputs they do not reach."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], inputs,
                              [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(got, inputs)]


def _add(acc, new):
    return new if acc is None else [a + b for a, b in zip(acc, new)]


# --------------------------------------------------------------------------
# GPipe


def gpipe_forward(stage_fn, locals_, st: Stages, micro, keep: bool = True):
    """The fill/drain ticks. Returns (the last stage's outputs (M, ...),
    on every rank, the tape: for each local stage the (x, y) of its live
    ticks, x a leaf and y its graph; with `keep` False no graph and an
    empty tape)."""
    M = micro.shape[0]
    tape = [[] for _ in st.stages]
    outs = None
    buf = [None] * len(st.stages)
    ticks = M + st.n - 1
    for t in range(ticks):
        ys = []
        for j, s in enumerate(st.stages):
            m = t - s
            if not 0 <= m < M:
                ys.append(torch.zeros_like(micro[0]))
                continue
            x = micro[m] if s == 0 else buf[j]
            x = x.detach().requires_grad_(keep)
            with torch.set_grad_enabled(keep):
                y = stage_fn(locals_[j], x)
            if keep:
                tape[j].append((x, y))
            if s == st.last:
                if outs is None:
                    outs = micro.new_empty((M,) + tuple(y.shape),
                                           dtype=y.dtype)
                outs[m] = y.detach()
            ys.append(y.detach())
        if t < ticks - 1:
            buf, _ = st.exchange(ys, None)
    if st.group is not None:       # the last stage's outputs on every rank
        outs = st.from_stage(st.last, torch.empty_like(micro)
                             if outs is None else outs)
    return outs, tape


def gpipe_backward(tape, leaves, st: Stages, douts, micro):
    """The reversed schedule: dy of the last stage's tick from `douts`,
    the others' from the next stage. Returns (per local stage the
    gradients of its `leaves`, stage 0's d micro or None)."""
    M = micro.shape[0]
    ticks = M + st.n - 1
    grads = [None] * len(st.stages)
    dmicro = torch.zeros_like(micro) if 0 in st.stages else None
    dxs = None
    for t in reversed(range(ticks)):
        dbuf = (st.exchange(None, dxs)[1] if t < ticks - 1
                else [None] * len(st.stages))
        dxs = []
        for j, s in enumerate(st.stages):
            m = t - s
            if not 0 <= m < M:
                dxs.append(torch.zeros_like(micro[0]))
                continue
            x, y = tape[j].pop()
            dy = douts[m] if s == st.last else dbuf[j]
            g = _grads([y], [dy], [x] + leaves[j])
            grads[j] = _add(grads[j], g[1:])
            if s == 0:
                dmicro[m] = g[0]
            dxs.append(g[0])
    return grads, dmicro


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, stage_fn, likes, micro, *leaves):
        k = len(leaves) // len(st.stages)
        with torch.enable_grad():
            rg = [l.detach().requires_grad_() for l in leaves]
            per = [rg[j * k:(j + 1) * k] for j in range(len(st.stages))]
            locals_ = [tree_unflatten(like, ls) for like, ls in
                       zip(likes, per)]
            outs, tape = gpipe_forward(stage_fn, locals_, st, micro)
        ctx.st, ctx.tape, ctx.per = st, tape, per
        ctx.save_for_backward(micro)
        return outs

    @staticmethod
    def backward(ctx, douts):
        (micro,) = ctx.saved_tensors
        st = ctx.st
        grads, dmicro = gpipe_backward(ctx.tape, ctx.per, st,
                                       douts.contiguous(), micro)
        if st.group is not None:
            if dmicro is None:
                dmicro = torch.empty_like(micro)
            dmicro = st.from_stage(0, dmicro)
        return (None, None, None, dmicro) + tuple(
            g for gs in grads for g in gs)


def pipeline_forward(stage_fn, mesh=None, axis: str = "pp", *,
                     n_stages: int | None = None):
    """A pipelined forward: (stage_params, microbatches) -> outputs.

    `stage_params`: a tree whose leaves carry a leading stage axis (see
    the module docstring); `microbatches` (n_micro, micro_batch, ...), the
    same on every rank, enter at stage 0. Returns the outputs (n_micro,
    micro_batch, ...) of the last stage on every rank (a stage keeps its
    input's shape). Differentiable in the params and the microbatches. On
    a `mesh` each rank runs its stage on `axis`; with `mesh=None` this
    process runs a virtual pipeline of `n_stages`."""
    st = Stages(mesh, axis, n_stages)

    def call(stage_params, microbatches):
        locals_ = st.split(stage_params)
        leaves = [l for t in locals_ for l in tree_leaves(t)]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [microbatches] + leaves):
            return _GPipe.apply(st, stage_fn, locals_, microbatches,
                                *leaves)
        return gpipe_forward(stage_fn, locals_, st, microbatches,
                             keep=False)[0]

    return call


# --------------------------------------------------------------------------
# 1F1B


def onef1b(stage_fn, loss_fn, locals_, loss_params, micro_x, micro_tgt,
           st: Stages, aux_weight: float):
    """The 1F1B ticks for the local stages. Returns per local stage (loss
    accumulated at the last stage, aux accumulated, the gradients of its
    params' leaves, the loss params' gradients at the last stage, d micro
    at stage 0), None where a part is not this stage's."""
    M = micro_x.shape[0]
    P = st.n
    R = min(M, 2 * P - 1)
    ticks = M + 2 * (P - 1)
    n = len(st.stages)
    leaves = [tree_leaves(t) for t in locals_]
    lp_leaves = tree_leaves(loss_params)
    dev = micro_x.device
    aux_ct = torch.tensor(aux_weight / M, dtype=torch.float32, device=dev)
    xbuf = [[None] * R for _ in range(n)]
    gstage = [None] * n
    gloss = None
    lacc = torch.zeros((), dtype=torch.float32, device=dev)
    aacc = [torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(n)]
    dmicro = torch.zeros_like(micro_x) if 0 in st.stages else None
    fwd_in = bwd_in = [None] * n
    zero = torch.zeros_like(micro_x[0])
    for t in range(ticks):
        ys, dxs = [], []
        for j, s in enumerate(st.stages):
            # forward half: microbatch t - s
            m_f = t - s
            y = dy0 = None
            if 0 <= m_f < M:
                x = micro_x[m_f] if s == 0 else fwd_in[j]
                with torch.no_grad():
                    y, aux = stage_fn(locals_[j], x)
                aacc[j] = aacc[j] + aux.float()
                xbuf[j][m_f % R] = x
                if s == st.last:
                    with torch.enable_grad():
                        yv = y.detach().requires_grad_()
                        lp = [p.detach().requires_grad_() for p in lp_leaves]
                        tgt = tree_map(lambda a: a[m_f], micro_tgt)
                        lval = loss_fn(yv, tgt,
                                       tree_unflatten(loss_params, lp))
                        g = _grads([lval], [torch.full_like(lval, 1.0 / M)],
                                   [yv] + lp)
                    lacc = lacc + lval.detach().float() / M
                    dy0 = g[0]
                    gloss = _add(gloss, g[1:])
            # backward half: microbatch t - 2 (P - 1) + s, its stage rerun
            m_b = t - 2 * (P - 1) + s
            dx = None
            if 0 <= m_b < M:
                xs = xbuf[j][m_b % R].detach().requires_grad_()
                xbuf[j][m_b % R] = None
                dy = dy0 if s == st.last else bwd_in[j]
                with torch.enable_grad():
                    rg = [p.detach().requires_grad_() for p in leaves[j]]
                    y2, a2 = stage_fn(tree_unflatten(locals_[j], rg), xs)
                    g = _grads([y2, a2], [dy, aux_ct.to(a2.dtype)],
                               [xs] + rg)
                gstage[j] = _add(gstage[j], g[1:])
                dx = g[0]
                if s == 0:
                    dmicro[m_b] = dx
            ys.append(zero if y is None else y)
            dxs.append(zero if dx is None else dx)
        if t < ticks - 1:
            fwd_in, bwd_in = st.exchange(ys, dxs)
    return lacc, aacc, gstage, gloss, dmicro


def pipeline_train_1f1b(stage_fn, loss_fn, mesh=None, axis: str = "pp",
                        aux_weight: float = 0.0, *,
                        n_stages: int | None = None):
    """A 1F1B train pass (JAX's `pipeline_train_1f1b`).

    * `stage_fn(stage_params, x) -> (y, aux)`: one stage's forward, aux a
      0-d tensor (0.0 if unused);
    * `loss_fn(y, target, loss_params) -> 0-d loss` of one microbatch at
      the last stage (e.g. the LM head and CE); `loss_params` the same on
      every rank.

    Returns `run(stage_params, loss_params, micro_x, micro_tgt)` computing
    L = mean_m loss(y_m) + aux_weight * mean_m (sum over stages of aux)
    and its gradients in one interleaved schedule: `(loss, grads of the
    stage params, grads of the loss params, d micro_x)`, the first, third
    and fourth the same on every rank, the stage grads in the stage
    params' layout (the stacked tree of a virtual pipeline, or this rank's
    stage with a leading axis of 1). `micro_tgt` is a tensor or a tree of
    tensors with a leading microbatch axis."""
    st = Stages(mesh, axis, n_stages)

    def run(stage_params, loss_params, micro_x, micro_tgt):
        locals_ = st.split(stage_params)
        lacc, aacc, gstage, gloss, dmicro = onef1b(
            stage_fn, loss_fn, locals_, loss_params, micro_x, micro_tgt, st,
            aux_weight)
        M = micro_x.shape[0]
        lp_like = tree_leaves(loss_params)
        if st.group is None:
            aux = aacc[0]
            for a in aacc[1:]:
                aux = aux + a
            loss = lacc + (aux_weight / M) * aux
        else:
            last = st.stages[0] == st.last
            v = torch.stack([lacc if last else torch.zeros_like(lacc),
                             aacc[0]])
            dist.all_reduce(v, group=st.group)
            loss = v[0] + (aux_weight / M) * v[1]
            if gloss is None:
                gloss = [torch.zeros_like(p) for p in lp_like]
            gloss = [st.from_stage(st.last, g.contiguous()) for g in gloss]
            if dmicro is None:
                dmicro = torch.empty_like(micro_x)
            dmicro = st.from_stage(0, dmicro)
        grads = st.stack([tree_unflatten(locals_[j], gstage[j])
                          for j in range(len(st.stages))])
        return (loss, grads, tree_unflatten(loss_params, gloss), dmicro)

    return run
