"""Model bundles: one directory holding params, config and tokenizer
(counterpart of `neuronika_tpu/utils/hub.py`, in its layout).

`save_model(dir, params, cfg, tokenizer=None)` /
`load_model(dir) -> (params, cfg, tokenizer | None)`: everything needed to
resume or serve a model travels together, in a local directory (nothing
is downloaded). The files are the JAX package's:

* `params.npz`, one array a leaf keyed by its "/"-joined tree path
  (self-describing: no `like` structure is needed to load); bf16 leaves
  as their bits in a void `V2` array, as `np.savez` writes JAX's bfloat16
  arrays (`serde`'s rule);
* `config.json`, the config dataclass's fields with `dtype` by name
  ("bfloat16", "float32") and `__config_class__` ("GPTConfig" or
  "Seq2SeqConfig");
* `tokenizer.json`, the `BpeTokenizer`'s merges and special tokens.

A bundle written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import config
from ..device import resolve
from ..ops.functional import as_dtype, dtype_name
from .serde import _array_tensor, _leaf_array

__all__ = ["save_model", "load_model"]

_CONFIG_CLASSES: Dict[str, Any] = {}


def _config_registry() -> Dict[str, Any]:
    if not _CONFIG_CLASSES:
        from ..models import t5, transformer

        _CONFIG_CLASSES["GPTConfig"] = transformer.GPTConfig
        _CONFIG_CLASSES["Seq2SeqConfig"] = t5.Seq2SeqConfig
    return _CONFIG_CLASSES


def _flat_with_paths(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts and lists, paths as tuples of
    keys and list indices."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _flat_with_paths(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flat_with_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def save_model(directory: str, params, cfg, tokenizer=None) -> None:
    """Write `<dir>/params.npz`, `<dir>/config.json` and (if given)
    `<dir>/tokenizer.json`."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "params.npz"),
             **{"/".join(p): _leaf_array(leaf)
                for p, leaf in _flat_with_paths(params)})
    d = dataclasses.asdict(cfg)
    d["dtype"] = dtype_name(as_dtype(d["dtype"]))
    d["__config_class__"] = type(cfg).__name__
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(d, f, indent=1)
    if tokenizer is not None:
        tokenizer.save(os.path.join(directory, "tokenizer.json"))


def load_model(directory: str) -> Tuple[Dict, Any, Optional[Any]]:
    """Rebuild (params, cfg, tokenizer): the params tree as nested dicts
    from the stored key paths, each leaf in its stored dtype on
    `config.device` ("cuda" unless the caller asks for the CPU); the
    tokenizer None where the bundle has none."""
    dev = resolve(config.device)
    with open(os.path.join(directory, "config.json")) as f:
        d = json.load(f)
    cls = _config_registry()[d.pop("__config_class__")]
    d["dtype"] = as_dtype(d["dtype"])
    cfg = cls(**d)

    params: Dict = {}
    with np.load(os.path.join(directory, "params.npz")) as data:
        for key in data.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _array_tensor(data[key]).to(dev)

    tok = None
    tok_path = os.path.join(directory, "tokenizer.json")
    if os.path.exists(tok_path):
        from ..data.tokenizer import BpeTokenizer

        tok = BpeTokenizer.load(tok_path)
    return params, cfg, tok
