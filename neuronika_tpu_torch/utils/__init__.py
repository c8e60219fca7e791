"""Utilities of the port (counterpart of `neuronika_tpu/utils/`): JSON and
NPZ serialization of variables, layers, models and optimizer state
(`serde`), and finite-difference gradient checking (`gradcheck`). The
JAX package's metrics, checkpoint, hub, aot, profiler and hf modules are
not ported yet."""

from . import serde
from .gradcheck import gradcheck
from .serde import (dumps, load_layer, load_npz, load_optimizer,
                    load_state_dict, loads, save_layer, save_npz,
                    save_optimizer, state_dict, var_from_dict, var_to_dict)

__all__ = [
    "serde", "gradcheck", "dumps", "loads", "var_to_dict", "var_from_dict",
    "save_layer", "load_layer", "state_dict", "load_state_dict",
    "save_npz", "load_npz", "save_optimizer", "load_optimizer",
]
