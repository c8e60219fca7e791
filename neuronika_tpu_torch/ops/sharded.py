"""Var tapes on sharded leaves (the port's side of what GSPMD does for the
JAX package's staged tape).

A leaf whose value is a `DTensor` (a batch placed by
`parallel.shard_batch`: Shard(0) over "dp") may mix with whole leaves in
one tape. The executor then lifts every whole leaf to Replicate on the
same mesh (`lift`, no communication) and replays the tape under DTensor's
implicit replication (`spmd`), so that each plain torch op of the tape
runs on DTensors and DTensor's sharding propagation places its result:
a Mean over the sharded axis divides by the global N (a DTensor's shape
is global), the gradient of a replicated leaf comes back a partial sum
and is all-reduced once (`whole`), and a dropout mask drawn at the
global shape is cut to each rank's rows.

The kernels are ctypes launches on raw pointers, so a DTensor cannot
reach them as it is: their ops call them through `local_map` (`run_local`)
with placements chosen per mesh dim by the rules below, so that each
rank's launch sees that rank's rows. Placements a rule does not take are
redistributed first (in the last resort, to Replicate).
"""

from __future__ import annotations

import contextlib
import sys

_DTENSOR = None


def _dtensor_cls():
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return _DTENSOR


def is_dtensor(t) -> bool:
    # no DTensor can exist before its module is imported
    return ("torch.distributed.tensor" in sys.modules
            and isinstance(t, _dtensor_cls()))


def leaf_mesh(values):
    """The mesh of the first DTensor among `values`, or None."""
    if "torch.distributed.tensor" not in sys.modules:
        return None
    cls = _dtensor_cls()
    for v in values:
        if isinstance(v, cls):
            return v.device_mesh
    return None


def replicate(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def lift(values, mesh) -> list:
    """Every plain tensor of `values` as a Replicate DTensor on `mesh` (each
    rank holds the whole value already; no communication); DTensors stay
    as they are, but must lie on `mesh`."""
    cls = _dtensor_cls()
    out = []
    for v in values:
        if isinstance(v, cls):
            if v.device_mesh != mesh:
                raise ValueError("a Var tape's sharded leaves must lie on "
                                 "one mesh")
            out.append(v)
        else:
            out.append(cls.from_local(v, mesh, replicate(mesh),
                                      run_check=False))
    return out


@contextlib.contextmanager
def spmd():
    """Plain tensors that ops make inside the block (masks, zeros, the
    backward's seed) count as Replicate beside DTensor operands."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield


def whole(t):
    """The full value of `t` on every rank (a collective where `t` is a
    DTensor that is split or a partial sum); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def settled(t):
    """`t` with its partial sums reduced (Replicate on those mesh dims), so
    that reading it later needs no communication."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


# --------------------------------------------------------------------------
# kernels on each rank's rows


def _check_even(t, placements) -> None:
    """local_map wraps each rank's result at the global shape of an even
    split: refuse a split that does not divide."""
    mesh = t.device_mesh
    for i, p in enumerate(placements):
        if p.is_shard() and t.shape[p.dim] % mesh.size(i):
            raise ValueError(
                f"dim {p.dim} of {tuple(t.shape)} does not split evenly "
                f"over {mesh.size(i)} ranks of mesh dim "
                f"{(mesh.mesh_dim_names or ('?',) * mesh.ndim)[i]!r}")


def run_local(fn, args, in_placements, out_placements):
    """fn on each rank's local tensors of `args` (DTensors, or plain
    tensors taken as Replicate), each first redistributed to its entry of
    `in_placements`; fn's one output wrapped as a DTensor in
    `out_placements`."""
    from torch.distributed.tensor.experimental import local_map

    mesh = leaf_mesh(args)
    args = lift(args, mesh)
    for a, p in zip(args, in_placements):
        _check_even(a, p)
    # local_map reads a tuple as one placement list an output: a list
    return local_map(fn, out_placements=list(out_placements),
                     in_placements=tuple(in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _placements(t, mesh) -> tuple:
    return t.placements if is_dtensor(t) else replicate(mesh)


def matmul_placements(a, b):
    """(a's, b's, the product's) placements for a (M, K) @ b (K, N), mesh
    dim by mesh dim: rows of a with b whole give rows; columns of b with a
    whole give columns; a's K split against b's K split gives a partial
    sum, as does a partial sum times a whole operand; anything else is
    computed whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = leaf_mesh((a, b))
    pa_all, pb_all = _placements(a, mesh), _placements(b, mesh)
    ins_a, ins_b, outs = [], [], []
    for pa, pb in zip(pa_all, pb_all):
        if pa.is_shard(0) and pb.is_replicate():
            out = Shard(0)
        elif pa.is_replicate() and pb.is_shard(1):
            out = Shard(1)
        elif pa.is_shard(1) and pb.is_shard(0):
            out = Partial()
        elif pa.is_partial() and pb.is_replicate():
            out = pa
        elif pa.is_replicate() and pb.is_partial():
            out = pb
        else:
            pa = pb = out = Replicate()
        ins_a.append(pa)
        ins_b.append(pb)
        outs.append(out)
    return tuple(ins_a), tuple(ins_b), tuple(outs)


def rows_placements(t, keep_dims) -> tuple:
    """t's placements with every mesh dim that splits a dim outside
    `keep_dims`, or holds partial sums, made Replicate."""
    from torch.distributed.tensor import Replicate

    keep = {d % t.ndim for d in keep_dims}
    return tuple(p if p.is_shard() and p.dim in keep else Replicate()
                 for p in _placements(t, leaf_mesh((t,))))


def embedding_placements(w, ids, g):
    """(ids', w's, g's, the table gradient's) placements for the scatter of
    g (ids.shape + (D,)) into a whole table like w: a split of the ids'
    dims (in ids or in g; the other one is cut to match, which needs no
    communication) gives each rank its rows' partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = leaf_mesh((w, ids, g))
    ins_i, ins_g, outs = [], [], []
    for pi, pg in zip(_placements(ids, mesh), _placements(g, mesh)):
        split = pi if pi.is_shard() else pg
        if split.is_shard() and split.dim < ids.ndim and not (
                pi.is_partial() or pg.is_partial()):
            ins_i.append(Shard(split.dim))
            ins_g.append(Shard(split.dim))
            outs.append(Partial())
        else:
            ins_i.append(Replicate())
            ins_g.append(Replicate())
            outs.append(Replicate())
    return tuple(ins_i), replicate(mesh), tuple(ins_g), tuple(outs)


def class_axis_placements(inp, tgt, partial: bool = False):
    """(inp's, tgt's, the result's) placements for a loss over a class
    axis first: inp (C, ...), tgt (...). A split of inp's dim d > 0 (or of
    tgt's dim d - 1) is kept on both, the class axis is whole; the result
    is inp's layout, or with `partial` (a sum over every entry) a partial
    sum over each split mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = leaf_mesh((inp, tgt))
    ins_i, ins_t, outs = [], [], []
    for pi, pt in zip(_placements(inp, mesh), _placements(tgt, mesh)):
        d = (pi.dim if pi.is_shard() and pi.dim > 0 else
             pt.dim + 1 if pt.is_shard() else None)
        if d is None:
            ins_i.append(Replicate())
            ins_t.append(Replicate())
            outs.append(Replicate())
        else:
            ins_i.append(Shard(d))
            ins_t.append(Shard(d - 1))
            outs.append(Partial() if partial else Shard(d))
    return tuple(ins_i), tuple(ins_t), tuple(outs)
