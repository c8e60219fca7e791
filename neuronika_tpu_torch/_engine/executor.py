"""Tape replay (counterpart of `neuronika_tpu/_engine/executor.py`).

The JAX executor stages a whole tape into one jitted XLA program, cached on
the tape's structural signature. PyTorch runs eagerly, so here the cache
entry is the tape resolved into a step list (each op's function, static
`extra`, parent slots, seed slot and train flag) and a call replays that
list eagerly. The signature, the LRU bound and `cache_stats` keep the JAX
contract, so a rebuilt graph of the same structure reuses its entry. There
is no native tape walker: the Python walk is the only one.

Sharded leaves: a leaf whose value is a `DTensor` (`parallel.shard_batch`)
mixes with whole leaves in one tape. Its placement is part of the
signature, the whole leaves are lifted to Replicate on its mesh and the
tape replays on DTensors (`ops/sharded.py`), as GSPMD runs JAX's staged
tape; the root's partial sums are reduced once, and the gradient of a
leaf with a whole value comes back whole (all-reduced once), so
`.data()` and `.grad()` read the unsharded run's values on every rank.

Gradient semantics, as in the reference:
* `backward(seed)` fills the root gradient with `seed` and replays VJPs in
  reverse topological order, accumulating into every differentiable node;
* gradients accumulate across `backward` calls until `zero_grad`;
* backward after `no_grad()` raises;
* the seed each stochastic op drew at forward is recorded on its node and
  reused by its VJP, so backward regenerates the same dropout mask.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch

from ..config import config
from ..ops import sharded
from .node import DEAD_GRADIENT_MSG, FORWARD_NOT_CALLED_MSG, Node


class LRUCache(OrderedDict):
    """Bounded cache: a long session that keeps producing new graph
    structures must not grow it without bound. Evicts the least recently
    used entries past `maxsize`."""

    def __init__(self, maxsize: int) -> None:
        super().__init__()
        self.maxsize = int(maxsize)

    def get(self, key, default=None):
        try:
            self.move_to_end(key)
        except KeyError:
            return default
        return super().__getitem__(key)

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)


_FWD_CACHE: LRUCache = LRUCache(256)
_BWD_CACHE: LRUCache = LRUCache(256)


def cache_stats() -> Tuple[int, int]:
    return len(_FWD_CACHE), len(_BWD_CACHE)


def clear_cache() -> None:
    _FWD_CACHE.clear()
    _BWD_CACHE.clear()


# --------------------------------------------------------------------------
# tape extraction


def _plan(root: Node):
    """(tape, leaves) of the graph rooted at `root`: op nodes in topological
    order (ids are monotone and parents precede children) and leaf nodes in
    first-use order. Identity dedup falls out of the ancestor walk."""
    ops: dict[int, Node] = {}
    stack = [root]
    seen = {root.id}
    while stack:
        n = stack.pop()
        if not n.is_leaf():
            ops[n.id] = n
        for p in n.parents:
            if p.id not in seen:
                seen.add(p.id)
                stack.append(p)
    tape = tuple(ops[i] for i in sorted(ops))
    leaves: List[Node] = []
    lseen = set()
    for n in tape:
        for p in n.parents:
            if p.is_leaf() and p.id not in lseen:
                lseen.add(p.id)
                leaves.append(p)
    return tape, leaves


def _train(n: Node):
    return None if n.status is None else bool(n.status.value)


def _signature(tape: Sequence[Node], leaves: Sequence[Node]) -> Tuple:
    """Structural key: two tapes with equal signatures compute the same
    function of their leaves, so a resolved step list can be reused."""
    pos = {n.id: ("L", i) for i, n in enumerate(leaves)}
    entries = []
    for i, n in enumerate(tape):
        pos[n.id] = ("N", i)
        entries.append((n.op, n.extra, tuple(pos[p.id] for p in n.parents),
                        n.differentiable, n.grad_alive, n.rng, _train(n)))
    leaf_sig = tuple((n.shape, str(n.dtype), n.differentiable,
                      _placement(n.value)) for n in leaves)
    return (tuple(entries), leaf_sig)


def _placement(value):
    """A sharded leaf's layout: its mesh (dim names and sizes) and
    placements; None for a whole value."""
    if not sharded.is_dtensor(value):
        return None
    mesh = value.device_mesh
    return (mesh.mesh_dim_names, tuple(mesh.shape), tuple(value.placements))


def _plan_and_sign(root: Node):
    tape, leaves = _plan(root)
    return tape, leaves, _signature(tape, leaves)


# --------------------------------------------------------------------------
# resolved step lists (the cache entries) and their replay


def _slots(tape, leaves):
    """node id -> slot: leaves first, then the tape in order."""
    slot = {n.id: i for i, n in enumerate(leaves)}
    for j, n in enumerate(tape):
        slot[n.id] = len(leaves) + j
    return slot


def _key_slots(tape):
    return {n.id: i for i, n in enumerate(n for n in tape if n.rng)}


def _build_forward(tape, leaves):
    """[(fn, extra, parent slots, seed index, train)], seed count."""
    slot, keys = _slots(tape, leaves), _key_slots(tape)
    steps = [(n.fn, n.extra, tuple(slot[p.id] for p in n.parents),
              keys.get(n.id), _train(n)) for n in tape]
    return steps, len(keys)


def _build_backward(tape, leaves):
    """Reverse-order VJP specs [(vjp, extra, ((parent slot,
    differentiable), ...), out slot, seed index, train)] over the
    differentiable tape nodes, and the root's slot."""
    slot, keys = _slots(tape, leaves), _key_slots(tape)
    specs = [(n.vjp, n.extra,
              tuple((slot[p.id], p.differentiable) for p in n.parents),
              slot[n.id], keys.get(n.id), _train(n))
             for n in reversed(tape) if n.differentiable]
    return specs, slot[tape[-1].id]


def _lifted(vals):
    """(leaf values as the steps take them, the mesh or None): with a
    sharded leaf, every whole value lifted to Replicate on its mesh."""
    mesh = sharded.leaf_mesh(vals)
    return (vals, None) if mesh is None else (sharded.lift(vals, mesh), mesh)


def _on(mesh):
    """The context a tape replays in: DTensor's implicit replication on a
    mesh, nothing otherwise."""
    return sharded.spmd() if mesh is not None else contextlib.nullcontext()


def _call(fn, extra, args, kidx, train, keys):
    if kidx is None:
        return fn(extra, *args)
    return fn(extra, *args, key=keys[kidx], train=train)


def _run_forward(steps, leaf_vals, keys) -> list:
    env = list(leaf_vals)
    for fn, extra, parents, kidx, train in steps:
        env.append(_call(fn, extra, [env[p] for p in parents], kidx, train,
                         keys))
    return env


def _run_backward(specs, values, keys, root_slot, seed, frees=None):
    """Reverse sweep from the root's seed: {slot: gradient} over every
    slot reached. With `frees` (one tuple of slots per spec), each value
    is dropped from `values` after the last VJP that reads it, and each
    interior gradient once it has been passed on."""
    grads = {root_slot: seed}
    for i, (vjp, extra, parents, out_slot, kidx, train) in enumerate(specs):
        g = grads.pop(out_slot) if frees is not None else grads.get(out_slot)
        if g is not None:
            primals = [values[s] for s, _ in parents]
            out = values[out_slot]
            if kidx is None:
                pgrads = vjp(extra, primals, out, g)
            else:
                pgrads = vjp(extra, primals, out, g, key=keys[kidx],
                             train=train)
            del primals, out, g
            for (ps, pdiff), pg in zip(parents, pgrads):
                if pg is None or not pdiff:
                    continue
                acc = grads.get(ps)
                grads[ps] = pg if acc is None else acc + pg
            del pgrads
        if frees is not None:
            for s in frees[i]:
                values[s] = None
    return grads


# --------------------------------------------------------------------------
# forward / backward


def forward(root: Node) -> None:
    """Compute every node of the graph rooted at `root` and store the
    results in the node cells."""
    tape, leaves, sig = _plan_and_sign(root)
    if not tape:
        return
    entry = _FWD_CACHE.get(sig)
    if entry is None:
        entry = _build_forward(tape, leaves)
        _FWD_CACHE[sig] = entry
    steps, n_rng = entry
    keys = [config.next_seed() for _ in range(n_rng)]
    # record the seeds consumed so backward regenerates the same draws
    rng_nodes = [n for n in tape if n.rng]
    for n, k in zip(rng_nodes, keys):
        n.value_key = k
    leaf_vals, mesh = _lifted([l.get_value() for l in leaves])
    with _on(mesh):
        env = _run_forward(steps, leaf_vals, keys)
    for n, v in zip(tape, env[len(leaves):]):
        n.value = v
        n.computed = True
    root.value = sharded.settled(root.value)


def backward(root: Node, seed: float) -> None:
    tape, leaves, sig = _plan_and_sign(root)
    if not tape:
        # backward on a differentiable leaf FILLS its gradient
        if root.differentiable:
            if not root.grad_alive:
                raise RuntimeError(DEAD_GRADIENT_MSG)
            root.grad = torch.full(root.shape, seed, dtype=root.dtype,
                                   device=root.device)
        return
    for n in tape:
        if not n.computed:
            raise RuntimeError(FORWARD_NOT_CALLED_MSG)
        if n.differentiable and not n.grad_alive:
            raise RuntimeError(DEAD_GRADIENT_MSG)
    for l in leaves:
        if l.differentiable and not l.grad_alive:
            raise RuntimeError(DEAD_GRADIENT_MSG)

    entry = _BWD_CACHE.get(sig)
    if entry is None:
        entry = _build_backward(tape, leaves)
        _BWD_CACHE[sig] = entry
    specs, root_slot = entry
    leaf_vals, mesh = _lifted([l.get_value() for l in leaves])
    values = leaf_vals + [n.get_value() for n in tape]
    keys = [n.value_key for n in tape if n.rng]
    with _on(mesh):
        grads = _run_backward(specs, values, keys, root_slot,
                              torch.full(root.shape, seed, dtype=root.dtype,
                                         device=root.device))
    slotted = list(leaves) + list(tape)
    for s, g in grads.items():
        node = slotted[s]
        if not node.differentiable:
            continue
        if mesh is not None and node.is_leaf() and not sharded.is_dtensor(
                node.value):
            g = sharded.whole(g)    # a whole leaf's gradient, reduced once
        if node is root:
            node.grad = g      # the root gradient is filled, not summed
        else:
            node.accumulate_grad(g)


# --------------------------------------------------------------------------
# fused train step: forward + backward + optimizer update
#
# The perf mode for static training loops. Semantics condensed as in the
# JAX package: gradients do not accumulate across calls (each step is
# forward -> fresh grads -> update) and interior `.data()`/`.grad()` cells
# are left empty. To fit large graphs, each forward value is dropped once
# the last VJP that reads it has run and each interior gradient once it has
# been passed on; the parameters and optimizer state are updated in place.


def _build_fused(tape, leaves):
    steps, _ = _build_forward(tape, leaves)
    specs, root_slot = _build_backward(tape, leaves)
    n_leaves = len(leaves)
    last = {}
    for i, (_, _, parents, out_slot, _, _) in enumerate(specs):
        for s in (*(p for p, _ in parents), out_slot):
            last[s] = i
    frees = [[] for _ in specs]
    for s, i in last.items():
        if s >= n_leaves:          # leaf values stay with their nodes
            frees[i].append(s)
    return steps, specs, root_slot, [tuple(f) for f in frees]


def fused_train_step(root: Node, optimizer, seed: float = 1.0,
                     donate: bool = False, block: bool = True):
    """Run one fused step (forward, backward, update) on the graph rooted
    at `root`, updating the optimizer's registered parameters in place.
    Returns the loss as a float, or None with `block=False` (read
    `loss.item()` later). `donate` is accepted for signature parity: the
    update is in place whatever its value, so it changes nothing."""
    del donate
    tape, leaves, base_sig = _plan_and_sign(root)
    if not tape:
        raise ValueError("fused step requires a non-leaf loss variable")
    leaf_index = {l.id: i for i, l in enumerate(leaves)}
    param_pos = []
    for p in optimizer._params:
        if p.node.id not in leaf_index:
            raise ValueError(
                "all registered parameters must be leaves of the loss graph "
                "for a fused step")
        param_pos.append(leaf_index[p.node.id])

    sig = (base_sig, tuple(param_pos), config.use_kernels)
    entry = optimizer._fused_cache.get(sig)
    if entry is None:
        entry = _build_fused(tape, leaves)
        optimizer._fused_cache[sig] = entry
    steps, specs, root_slot, frees = entry

    keys = [config.next_seed() for n in tape if n.rng]
    leaf_vals = [l.get_value() for l in leaves]
    run_vals, mesh = _lifted(leaf_vals)
    if mesh is not None and any(sharded.is_dtensor(leaf_vals[i])
                                for i in param_pos):
        raise ValueError("a fused step updates whole parameters: shard the "
                         "inputs (parallel.shard_batch), not a registered "
                         "parameter")
    with _on(mesh):
        env = _run_forward(steps, run_vals, keys)
        loss = env[root_slot]
        grads = _run_backward(specs, env, keys, root_slot,
                              torch.full(root.shape, seed, dtype=root.dtype,
                                         device=root.device), frees)
    del env
    # each replicated parameter's gradient all-reduced once; the update
    # (and any penalty) then runs on whole values, the same on every rank
    param_grads = [grads.pop(i, None) for i in param_pos]
    if mesh is not None:
        param_grads = [None if g is None else sharded.whole(g)
                       for g in param_grads]
        loss = sharded.settled(loss)
    optimizer._step_count += 1
    optimizer._apply_update([leaf_vals[i] for i in param_pos], param_grads,
                            inplace=True)
    root.value = loss
    root.computed = True
    if not block:
        return None
    return float(sharded.whole(loss))
