"""Utilities of the port (counterpart of `neuronika_tpu/utils/`): JSON and
NPZ serialization of variables, layers, models, optimizer state and
functional params trees (`serde`, `save_pytree`/`load_pytree` in the JAX
package's layout), train-state checkpoints (`checkpoint.Checkpointer`,
torch-native where the JAX package uses orbax), the JSONL metrics logger
(`metrics.MetricsLogger`), finite-difference gradient checking
(`gradcheck`), Hugging Face import and export (`hf`: `from_hf_gpt2`,
`from_hf_llama`, `from_huggingface`, `to_hf_gpt2`, `to_hf_llama`,
`to_huggingface`), model bundles in a local directory (`hub.save_model`,
`load_model`, the JAX package's layout), ahead-of-time export on
`torch.export` (`aot.export_fn`, `load_exported`, `save_exported`) and
tracing and step timing (`profiler.trace`, `StepTimer`)."""

from . import aot, checkpoint, hf, hub, metrics, profiler, serde
from .aot import export_fn, load_exported, save_exported
from .checkpoint import Checkpointer, restore_train_state, save_train_state
from .gradcheck import gradcheck
from .hf import (from_hf_gpt2, from_hf_llama, from_huggingface, to_hf_gpt2,
                 to_hf_llama, to_huggingface)
from .metrics import MetricsLogger
from .serde import (dumps, load_layer, load_npz, load_optimizer,
                    load_pytree, load_state_dict, loads, save_layer,
                    save_npz, save_optimizer, save_pytree, state_dict,
                    var_from_dict, var_to_dict)

__all__ = [
    "serde", "gradcheck", "dumps", "loads", "var_to_dict", "var_from_dict",
    "save_layer", "load_layer", "state_dict", "load_state_dict",
    "save_npz", "load_npz", "save_optimizer", "load_optimizer",
    "save_pytree", "load_pytree", "metrics", "MetricsLogger",
    "checkpoint", "Checkpointer", "save_train_state", "restore_train_state",
    "hf", "from_hf_gpt2", "from_hf_llama", "from_huggingface", "to_hf_gpt2",
    "to_hf_llama", "to_huggingface", "hub", "aot", "export_fn",
    "load_exported", "save_exported", "profiler",
]
