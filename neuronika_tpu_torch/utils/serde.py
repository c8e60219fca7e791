"""Serialization (counterpart of the Var, layer and model half of
`neuronika_tpu/utils/serde.py`).

A variable serializes its data only (no gradient, no graph), and
deserializing rebuilds a leaf on `config.device`; a layer serializes its
parameter set. Two formats:
* JSON, in the JAX package's layout per variable,
  ``{"v": 1, "dim": [...], "data": [...]}``, so a JAX model's `state_dict`
  loads into the port's model of the same layers (this is one way weights
  are carried across);
* NPZ for binary checkpoints (`save_npz`/`load_npz`), and
  `save_optimizer`/`load_optimizer` for the optimizer's slots and step.
bf16 data is written widened to f32 (exact) and rounded back on load.

`save_pytree`/`load_pytree` store a functional-tier params tree (nested
dicts, lists and tuples of tensors) in the JAX package's file layout, so
each package reads the other's files: leaves `leaf_0`, `leaf_1`, ... in
JAX's flattening order, which sorts dict keys (the port's own trees visit
keys in insertion order, `_tree.py`), and the tree's `PyTreeDef` text in
`__treedef__`. bf16 leaves are stored as their raw 16-bit patterns, which
numpy writes as void `V2`, as JAX's numpy arrays of bfloat16 are written.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from ..variable import Var, _to_numpy

__all__ = [
    "var_to_dict", "var_from_dict", "dumps", "loads",
    "save_layer", "load_layer", "state_dict", "load_state_dict",
    "save_npz", "load_npz", "save_optimizer", "load_optimizer",
    "save_pytree", "load_pytree",
]


def var_to_dict(v: Var) -> Dict:
    arr = _to_numpy(v.data())
    return {"v": 1, "dim": list(arr.shape), "data": arr.reshape(-1).tolist()}


def _array(d: Dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=np.float32).reshape(d["dim"])


def var_from_dict(d: Dict, requires_grad: bool = False) -> Var:
    from .. import from_ndarray

    v = from_ndarray(_array(d))
    return v.requires_grad() if requires_grad else v


def dumps(v: Var) -> str:
    return json.dumps(var_to_dict(v))


def loads(s: str, requires_grad: bool = False) -> Var:
    return var_from_dict(json.loads(s), requires_grad)


def _param_fields(layer) -> List[str]:
    """Names of the layer's variable attributes, in declaration order."""
    return [k for k, v in vars(layer).items() if isinstance(v, Var)]


def save_layer(layer) -> Dict:
    """Layer -> JSON-able dict of its parameters."""
    return {name: var_to_dict(getattr(layer, name))
            for name in _param_fields(layer)}


def load_layer(layer, d: Dict) -> None:
    """Write serialized parameters into an existing layer's buffers
    (shape-checked by `assign`)."""
    for name, spec in d.items():
        getattr(layer, name).assign(_array(spec))


def state_dict(model: Dict) -> Dict:
    """{name: layer} -> nested JSON-able dict."""
    return {name: save_layer(layer) for name, layer in model.items()}


def load_state_dict(model: Dict, state: Dict) -> None:
    for name, layer_state in state.items():
        load_layer(model[name], layer_state)


def _npz_path(path: str) -> str:
    # np.savez appends '.npz' to a suffixless path; normalise on both ends
    return path if path.endswith(".npz") else path + ".npz"


def save_npz(path: str, variables: Dict[str, Var]) -> None:
    np.savez(_npz_path(path),
             **{k: _to_numpy(v.data()) for k, v in variables.items()})


def load_npz(path: str, variables: Dict[str, Var]) -> None:
    with np.load(_npz_path(path)) as data:
        for k, v in variables.items():
            v.assign(data[k])


def save_optimizer(path: str, optimizer) -> None:
    """Checkpoint the optimizer's slot state and step counter."""
    flat = {"__step__": np.asarray(optimizer._step_count)}
    for i, state in enumerate(optimizer._state):
        for k, v in state.items():
            flat[f"{i}.{k}"] = _to_numpy(v)
    np.savez(_npz_path(path), **flat)


def load_optimizer(path: str, optimizer) -> None:
    """Restore what `save_optimizer` wrote into a compatible optimizer (the
    same algorithm, the same registration order), each slot in its own
    dtype and on its own device."""
    with np.load(_npz_path(path)) as data:
        step = int(data["__step__"])
        new_state = [{k: torch.from_numpy(data[f"{i}.{k}"]).to(
                          device=v.device, dtype=v.dtype)
                      for k, v in state.items()}
                     for i, state in enumerate(optimizer._state)]
    optimizer._step_count = step
    optimizer._state = new_state


# --------------------------------------------------------------------------
# functional-tier trees in the JAX package's layout


def _jax_order(tree) -> list:
    """The leaves of a tree in JAX's flattening order: dict keys sorted,
    lists and tuples in order, None no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_order(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _jax_order(t)]
    return [] if tree is None else [tree]


def _jax_unflatten(like, leaves):
    """A tree shaped like `like` (keys in its own order) holding `leaves`
    taken in JAX's order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}     # JAX's order
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    return build(like)


def _treedef_text(tree) -> str:
    """`str(jax.tree.structure(tree))` for a tree of dicts, lists and
    tuples."""
    def text(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {text(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(text(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(text(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"

    return f"PyTreeDef({text(tree)})"


def _leaf_array(leaf) -> np.ndarray:
    """A tensor (or array) as numpy; bf16 as its bits in a void V2 array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Store the leaves of `tree` and its treedef text (np.savez, which
    appends '.npz' to a path without it, as in JAX)."""
    leaves = _jax_order(tree)
    np.savez(path,
             __treedef__=np.frombuffer(_treedef_text(tree).encode(),
                                       dtype=np.uint8),
             **{f"leaf_{i}": _leaf_array(l) for i, l in enumerate(leaves)})


def _array_tensor(a: np.ndarray) -> torch.Tensor:
    """A loaded array as a CPU tensor; a void V2 array as bf16 bits."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a raw {a.dtype} leaf is no bf16 leaf")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf_tensor(a: np.ndarray, like) -> torch.Tensor:
    """A loaded array as a tensor on `like`'s device; a void V2 array is
    read as bf16 bits, which `like` must hold."""
    if a.dtype.kind == "V" and not (isinstance(like, torch.Tensor)
                                    and like.dtype == torch.bfloat16):
        raise TypeError(f"a raw {a.dtype} leaf loads only into a bf16 leaf, "
                        f"not {getattr(like, 'dtype', type(like))}")
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return _array_tensor(a).to(dev)


def load_pytree(path: str, like):
    """Load what `save_pytree` (of either package) wrote into the structure
    of `like`: each leaf keeps its saved dtype (bf16 for `V2` leaves) and
    goes to the device of `like`'s leaf."""
    likes = _jax_order(like)
    with np.load(path) as data:
        leaves = [_leaf_tensor(data[f"leaf_{i}"], l)
                  for i, l in enumerate(likes)]
    return _jax_unflatten(like, leaves)
