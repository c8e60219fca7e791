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
