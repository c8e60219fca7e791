"""Device meshes and stated shardings over torch.distributed (counterpart
of `neuronika_tpu/parallel/mesh.py`).

JAX runs one controller over every device and states each array's
`NamedSharding`; PyTorch runs one process per device. Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named axes over the
process group's ranks, a sharding is a `NamedSharding(mesh, spec)` (one
mesh-axis name or None per tensor dim, JAX's `PartitionSpec`) and a sharded
array is a `DTensor` with the matching placements. `shard_map_compat`
is the twin of JAX's `shard_map`: it hands a function each rank's local
shards and wraps what it returns as DTensors; the collectives inside are
the function's own (`collectives.py`).

The process group comes first: `distributed_init` from the `torchrun`
variables or explicit arguments (NCCL on the card, gloo on the CPU), or
the caller's own `torch.distributed.init_process_group`. `spawn` runs a
function on local ranks with a time limit, for tests and for a one-host
run without `torchrun`.
"""

from __future__ import annotations

import datetime
import math
import os
import queue
import time
import traceback
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._tree import tree_leaves, tree_unflatten
from ..config import config
from ..device import resolve

__all__ = [
    "make_mesh", "make_hybrid_mesh", "distributed_init",
    "make_global_batch", "data_parallel_sharding", "replicated",
    "shard_batch", "DataParallel", "shard_map_compat", "NamedSharding",
    "mesh_axis", "spawn",
]


def _device_type() -> str:
    """"cuda" unless `config.device` asks for "cpu"; asking for CUDA where
    there is none raises."""
    return resolve(config.device).type


def make_mesh(axes: Sequence[Tuple[str, int]] = None, devices=None):
    """A DeviceMesh with named axes. Default: all ranks on one `dp` axis.

    `axes` is an ordered list of (name, size) whose sizes multiply to the
    number of ranks (-1 for one inferred axis); `devices` lists the ranks
    (default: the process group's world, in rank order). The mesh runs on
    "cuda" unless `config.device` says "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "distributed_init() or "
                           "torch.distributed.init_process_group first")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(d) for d in devices])
    n = len(ranks)
    if axes is None:
        axes = [("dp", n)]
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not fit "
                         f"{n} devices")
    return _mesh(_device_type(), np.array(ranks).reshape(sizes), names)


def _mesh(device_type, ranks: np.ndarray, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=tuple(names))


def _nodes() -> int:
    """Hosts in the world: the world over torchrun's LOCAL_WORLD_SIZE
    (ranks of one host are consecutive), 1 without it."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    world = dist.get_world_size()
    return world // local if local and world % local == 0 else 1


def make_hybrid_mesh(axes: Sequence[Tuple[str, int]],
                     dcn: Optional[Mapping[str, int]] = None, devices=None):
    """Mesh for several hosts: `axes` as in `make_mesh`, `dcn` maps an axis
    name to how much of it crosses hosts (default: the first axis takes
    the host count). The rest of each axis stays inside a host, so
    collectives on those axes never leave it. One host collapses to
    `make_mesh(axes)`."""
    n_nodes = _nodes()
    if n_nodes == 1:
        return make_mesh(axes, devices)
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if dcn is None:
        dcn = {names[0]: n_nodes}
    unknown = set(dcn) - set(names)
    if unknown:
        raise ValueError(f"dcn axes {unknown} not in mesh axes {names}")
    dcn_sizes = [dcn.get(a, 1) for a in names]
    if math.prod(dcn_sizes) != n_nodes:
        raise ValueError(
            f"dcn factors {dict(dcn)} must multiply to {n_nodes} hosts")
    ici_sizes = []
    for name, total, d in zip(names, sizes, dcn_sizes):
        if total % d:
            raise ValueError(f"axis {name}: size {total} not divisible by "
                             f"dcn factor {d}")
        ici_sizes.append(total // d)
    ranks = (np.arange(dist.get_world_size()) if devices is None
             else np.array([int(d) for d in devices]))
    if ranks.size != math.prod(sizes):
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not fit "
                         f"{ranks.size} devices")
    # host-major ranks: (hosts as dcn_sizes) x (a host's ranks as
    # ici_sizes), each axis then (dcn factor, ici factor)
    k = len(names)
    arr = ranks.reshape(dcn_sizes + ici_sizes)
    arr = arr.transpose([a for i in range(k) for a in (i, k + i)])
    return _mesh(_device_type(), arr.reshape(sizes), names)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     timeout: float = 600.0) -> bool:
    """Start the process group (one process per device).

    With explicit arguments it connects to `coordinator_address`
    ("host:port") as rank `process_id` of `num_processes`; with none it
    starts only when `torchrun`'s variables (RANK, WORLD_SIZE,
    MASTER_ADDR) are set, so one-process scripts and tests can call it
    unconditionally. The backend is NCCL on the card and gloo on the CPU
    (`config.device`); on the card each process takes the device of its
    LOCAL_RANK. A collective waits at most `timeout` s. Returns True if
    this call started the group (False when there is nothing to start or
    a group exists)."""
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(os.environ.get(v) for v in (
            "RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    if dist.is_initialized():
        if explicit:
            raise RuntimeError("a process group is already running")
        return False
    dev = resolve(config.device)
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo",
              timeout=datetime.timedelta(seconds=timeout))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("explicit initialisation needs "
                             "coordinator_address, num_processes and "
                             "process_id")
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
        local = process_id
    else:
        kw.update(init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)
    return True


# --------------------------------------------------------------------------
# stated shardings


class NamedSharding:
    """A layout over a mesh: `spec` names, for each leading tensor dim, the
    mesh axis it is split over (None: not split); later dims are not split
    (JAX's `NamedSharding(mesh, P(*spec))`). `placements` is the DTensor
    form, one placement per mesh dim."""

    def __init__(self, mesh, spec: Sequence[Optional[str]] = ()):
        spec = tuple(spec)
        names = mesh.mesh_dim_names
        used = [a for a in spec if a is not None]
        if any(a not in names for a in used) or len(set(used)) < len(used):
            raise ValueError(f"spec {spec} against mesh axes {names}")
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        return tuple(Shard(self.spec.index(a)) if a in self.spec
                     else Replicate() for a in self.mesh.mesh_dim_names)

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor dim split over `axis`, or None."""
        return self.spec.index(axis) if axis in self.spec else None

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.mesh_dim_names}, {self.spec})"


def mesh_axis(mesh, axis: str) -> tuple:
    """(process group, size, this rank's coordinate) of the mesh axis
    `axis`; (None, 1, 0) where the mesh has no such axis."""
    names = mesh.mesh_dim_names
    if axis not in names:
        return None, 1, 0
    return (mesh.get_group(axis), mesh.size(names.index(axis)),
            mesh.get_local_rank(axis))


def _batch_spec(ndim: int, axis: str) -> tuple:
    return (axis,) + (None,) * (ndim - 1)


def data_parallel_sharding(mesh, axis: str = "dp") -> NamedSharding:
    """The leading (batch) dim split over `axis`."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def place(t, sharding: NamedSharding, src_data_rank: Optional[int] = 0):
    """`t` as a DTensor in `sharding`: a DTensor is redistributed, a plain
    tensor (the same full value on every rank) distributed. With
    `src_data_rank` None each rank takes its shard from its own copy, with
    no communication; with a rank, that rank's copy is scattered."""
    from torch.distributed.tensor import distribute_tensor

    if _is_dtensor(t):
        return t.redistribute(sharding.mesh, sharding.placements)
    t = torch.as_tensor(t, device=sharding.mesh.device_type)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=src_data_rank)


def shard_batch(array, mesh, axis: str = "dp"):
    """A host batch (the same on every rank) placed on the mesh with its
    leading dim split over `axis`; each rank keeps its own rows."""
    t = torch.as_tensor(np.asarray(array) if not isinstance(
        array, torch.Tensor) else array)
    return place(t, NamedSharding(mesh, _batch_spec(t.dim(), axis)),
                 src_data_rank=None)


def make_global_batch(local_batch, mesh, axis: str = "dp"):
    """The global batch assembled from each rank's LOCAL rows (each rank
    reads only its shard; ranks that differ only off `axis` pass the same
    rows): the leading dim is the `axis` size x local rows, split over
    `axis`. With one process this equals `shard_batch`."""
    from torch.distributed.tensor import DTensor

    t = torch.as_tensor(local_batch, device=mesh.device_type)
    sh = NamedSharding(mesh, _batch_spec(t.dim(), axis))
    return DTensor.from_local(t, mesh, sh.placements, run_check=False)


def _flat_specs(specs, tree):
    """`specs` (a tree prefix of `tree`: a NamedSharding or None stands for
    every leaf under it) expanded to one spec a leaf of `tree`."""
    if specs is None or isinstance(specs, NamedSharding):
        return [specs] * len(tree_leaves(tree))
    if isinstance(specs, dict):
        return [s for k in tree for s in _flat_specs(specs[k], tree[k])]
    if isinstance(specs, (list, tuple)):
        return [s for sp, t in zip(specs, tree) for s in _flat_specs(sp, t)]
    raise TypeError(f"not a sharding: {specs!r}")


def _local(t, spec):
    if spec is None or not isinstance(t, torch.Tensor):
        return t
    return place(t, spec, src_data_rank=None).to_local()


def _wrap(t, spec):
    from torch.distributed.tensor import DTensor

    if spec is None:
        return t
    return DTensor.from_local(t, spec.mesh, spec.placements, run_check=False)


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """JAX's `shard_map`: f runs on each rank's local shards. Each
    argument is placed in its spec (a tree prefix of NamedSharding, or None
    to pass it as it is) and handed to f as its local tensors; f's outputs
    are wrapped as DTensors in `out_specs`. The collectives are f's own.
    A plain tensor (the same full value on every rank) is cut by each rank
    from its own copy, with no communication."""
    del mesh   # the specs carry it

    def mapped(*args):
        local = []
        for a, s in zip(args, in_specs):
            flat = _flat_specs(s, a)
            local.append(tree_unflatten(a, [
                _local(t, sp)
                for t, sp in zip(tree_leaves(a), flat)]) if flat else a)
        out = f(*local)
        return tuple(
            tree_unflatten(o, [_wrap(t, sp) for t, sp in zip(
                tree_leaves(o), _flat_specs(s, o))])
            for o, s in zip(out, out_specs))

    return mapped


class DataParallel:
    """Data-parallel wrapper for *pure* step functions: `DataParallel(
    step_fn, mesh)` calls `step_fn(params, batch, ...) -> (params, aux)`
    with the params replicated and every batch argument split on its
    leading dim over `axis`, as DTensors; DTensor's sharding propagation
    inserts the gradient all-reduce, as GSPMD does for JAX's jit. Outputs
    that come back partial sums are reduced to replicated DTensors."""

    def __init__(self, step_fn, mesh, axis: str = "dp") -> None:
        self.mesh, self.axis, self._step = mesh, axis, step_fn

    def __call__(self, params, *batch_args, **kw):
        rep = replicated(self.mesh)
        params = tree_unflatten(params, [place(p, rep)
                                         for p in tree_leaves(params)])
        placed = tuple(shard_batch(b, self.mesh, self.axis)
                       for b in batch_args)
        out = self._step(params, *placed, **kw)
        return tree_unflatten(out, [_reduced(t) for t in tree_leaves(out)])


def _reduced(t):
    from torch.distributed.tensor import Partial, Replicate

    if not _is_dtensor(t) or not any(isinstance(p, Partial)
                                     for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


# --------------------------------------------------------------------------
# local ranks


_GLOO_CUDA_LIB = None


def _gloo_cuda_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors (what DTensor's
    Shard -> Replicate runs) through c10d's all_gather_into_tensor. On
    gloo ranks sharing a card, torch 2.11's functional op (CUDA 12.8)
    kills the process with SIGSEGV in its wait, while c10d's synchronous
    call of the same collective completes; the result is the same
    gathered tensor."""
    global _GLOO_CUDA_LIB
    if _GLOO_CUDA_LIB is not None:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _GLOO_CUDA_LIB = lib


def _rank_main(fn, rank, world, backend, init_file, timeout, results, args):
    try:
        if backend == "gloo":
            torch.set_num_threads(1)
            if torch.cuda.is_available():
                _gloo_cuda_all_gather()
        else:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:        # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, args: tuple = (), *, init_file: str,
          backend: str = "gloo", timeout: float = 60.0,
          limit: float = 300.0) -> list:
    """fn(rank, *args) on `nprocs` new processes, each rank of a process
    group on `backend` ("gloo" on the CPU, "nccl" with one card a rank)
    met through `init_file` (a path that must not exist yet, e.g. under a
    test's tmp_path: no TCP port to collide). Returns the ranks' results
    in rank order (they must pickle). A collective that waits `timeout` s
    fails; a run still going after `limit` s is terminated. Either, or an
    error in any rank, raises RuntimeError with the ranks' tracebacks."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, backend, init_file, timeout,
                               results, args), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    got = {}
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"spawn: {nprocs} ranks still running "
                                   f"after {limit} s; terminated")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and len(got) + len(dead) >= nprocs:
                    raise RuntimeError(f"spawn: ranks exited with codes "
                                       f"{dead} without a result")
                continue
            got[rank] = (ok, value)
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [got[r][1] for r in range(nprocs)]
