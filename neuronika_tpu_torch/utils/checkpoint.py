"""Step-indexed checkpoints of whole train states (counterpart of
`neuronika_tpu/utils/checkpoint.py`, torch-native where the JAX package
uses orbax).

A train state is a tree of dicts, lists and tuples whose leaves are
tensors (numpy arrays and numbers are stored as arrays and come back as
tensors). Each checkpoint is a directory `<directory>/<step>/` holding the
leaves in `utils.serde.save_pytree`'s layout (`state.npz`, JAX's leaf order,
bf16 as raw 16-bit patterns) and the tree's structure (`tree.json`).

Orbax's semantics for the calls a training loop makes:
* `save(step, state, force=False)` returns False without saving when
  `step` is not past the latest step (unless `force`), and raises
  `ValueError` when a checkpoint of `step` exists;
* `keep` bounds how many checkpoints survive (the last saved; None keeps
  all);
* `steps()` lists the steps in the order they were saved (a new
  `Checkpointer` reads them in step order), `latest_step()` is the last
  saved, and both include a save still being written.

A save is safe against in-place updates: the port's train step writes the
params and the optimizer state in place, so `save()` copies every leaf to
host memory before it returns; only the disk write runs in the background
(`async_save=True`, one write at a time), and `wait()` joins it and raises
what it raised. A write goes to a temporary directory that is renamed to
`<step>` when complete, and older checkpoints are deleted only after that
rename, so a run killed mid-save leaves the previous checkpoint whole (a
leftover temporary directory is removed by the next `Checkpointer` on the
same directory).

Sharded states (DTensor leaves, `make_sharded_train_step`'s params and
moments): every rank calls `save` and `restore` alike. A save gathers
each DTensor's full value (a collective) and rank 0 writes it; `wait()`
then holds every rank until the write is done. `restore(like=...)` puts
each leaf straight into the placement of `like`'s DTensor, each rank
reading its own shard out of the file (JAX's restore into a stated
sharding).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import config
from ..device import resolve
from .serde import _array_tensor, _jax_order, _jax_unflatten, save_pytree

__all__ = ["Checkpointer", "save_train_state", "restore_train_state"]

_TMP = ".tmp-"
_LEAVES = "state.npz"
_TREE = "tree.json"


def _structure(tree):
    """The tree's structure as JSON: dicts as objects (in their own key
    order), lists as arrays, tuples as {"__tuple__": [...]}, a leaf as
    "*", None as null."""
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint trees need string dict keys")
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(t) for t in tree]
    if isinstance(tree, tuple):
        return {"__tuple__": [_structure(t) for t in tree]}
    return None if tree is None else "*"


def _skeleton(spec):
    """A tree of `_structure`'s shape with placeholder leaves (for
    `_jax_unflatten`)."""
    if isinstance(spec, dict):
        if "__tuple__" in spec and len(spec) == 1:
            return tuple(_skeleton(s) for s in spec["__tuple__"])
        return {k: _skeleton(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_skeleton(s) for s in spec]
    return None if spec is None else 0


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host_copy(leaf):
    """A leaf copied to host memory, so later in-place updates of the live
    tensor do not reach the checkpoint; a DTensor's full value (gathered:
    every rank takes part)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _like(t: torch.Tensor, like):
    """A restored leaf in the device, dtype and (for a DTensor) placement
    of `like`'s leaf; each rank cuts its shard from its own copy."""
    if not isinstance(like, torch.Tensor):
        return t
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        mesh = like.device_mesh
        return distribute_tensor(t.to(mesh.device_type, like.dtype), mesh,
                                 like.placements, src_data_rank=None)
    return t.to(like.device, like.dtype)


class Checkpointer:
    """Step-indexed train-state checkpoints.

    >>> ck = Checkpointer(dir, keep=3)
    >>> ck.save(step, {"params": params, "opt": opt_state})
    >>> state = ck.restore()                 # latest
    >>> state = ck.restore(step=1000, like=state)
    >>> ck.wait(); ck.close()
    """

    def __init__(self, directory: str, keep: Optional[int] = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        for name in os.listdir(self._dir):
            if name.startswith(_TMP):       # a save that never finished
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
        self._steps: List[int] = sorted(
            int(n) for n in os.listdir(self._dir)
            if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False      # a sharded save awaits wait()'s barrier

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Snapshot `state` at `step`. Returns once every leaf is copied to
        host memory; with `async_save` the disk write continues in the
        background. Returns whether a save was made."""
        step = int(step)
        latest = self.latest_step()
        if not force and latest is not None and latest >= step:
            return False
        self.wait()
        if step in self._steps:
            raise ValueError(f"a checkpoint of step {step} exists already "
                             f"in {self._dir}")
        leaves = _jax_order(state)
        snap = (_structure(state), [_host_copy(l) for l in leaves])
        steps = self._steps + [step]         # in the order of saving
        drop = [] if self.keep is None else steps[:-self.keep]
        self._steps = steps[len(drop):]
        self._sharded = any(_is_dtensor(l) for l in leaves)
        if self._sharded and dist.get_rank() != 0:
            return True                      # rank 0 writes
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_bg, args=(step, snap, drop),
                name=f"checkpoint-{step}")
            self._thread.start()
        else:
            self._write_or_forget(step, snap, drop)
        return True

    def _write_bg(self, step, snap, drop) -> None:
        try:
            self._write_or_forget(step, snap, drop)
        except BaseException as e:      # raised again by wait()
            self._error = e

    def _write_or_forget(self, step, snap, drop) -> None:
        """Write the checkpoint; if that fails, the step is forgotten and
        the steps that were to make room for it stay."""
        try:
            self._write(step, snap)
        except BaseException:
            self._steps = ([s for s in drop if os.path.isdir(self._path(s))]
                           + [s for s in self._steps if s != step])
            raise
        for s in drop:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def _write(self, step: int, snap) -> None:
        spec, leaves = snap
        tmp = os.path.join(self._dir, f"{_TMP}{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            save_pytree(os.path.join(tmp, _LEAVES), leaves)
            with open(os.path.join(tmp, _TREE), "w") as f:
                json.dump(spec, f)
            os.rename(tmp, self._path(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # ------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The checkpoint at `step` (default: the latest). With `like` (a
        tree of the same structure), each leaf takes the device and dtype of
        `like`'s leaf; without it, leaves keep their saved dtype and go to
        `config.device`."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self._dir}")
        path = self._path(int(step))
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self._dir}")
        with open(os.path.join(path, _TREE)) as f:
            spec = json.load(f)
        if like is not None and _structure(like) != spec:
            raise ValueError(f"`like` does not have the structure of the "
                             f"checkpoint of step {step}")
        skeleton = _skeleton(spec)
        with np.load(os.path.join(path, _LEAVES)) as data:
            flat = [_array_tensor(data[f"leaf_{i}"])
                    for i in range(len(_jax_order(skeleton)))]
        if like is None:
            dev = resolve(config.device)
            flat = [t.to(dev) for t in flat]
        else:
            flat = [_like(t, l) for t, l in zip(flat, _jax_order(like))]
        return _jax_unflatten(skeleton, flat)

    # ----------------------------------------------------------- inventory
    def steps(self) -> List[int]:
        """The steps held, in the order they were saved."""
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        """The step saved last (None before any)."""
        return self._steps[-1] if self._steps else None

    # ----------------------------------------------------------- lifecycle
    def wait(self) -> None:
        """Block until a pending save is on disk (after a sharded save, on
        every rank); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_train_state(directory: str, step: int, state: Any) -> None:
    """One synchronous save (no manager to hold)."""
    with Checkpointer(directory, async_save=False) as ck:
        ck.save(step, state)


def restore_train_state(directory: str, step: Optional[int] = None,
                        like: Any = None) -> Any:
    with Checkpointer(directory, async_save=False) as ck:
        return ck.restore(step, like)
