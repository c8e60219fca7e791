"""Ahead-of-time export: serialize a traced program for serving
(counterpart of `neuronika_tpu/utils/aot.py`, on `torch.export`).

`export_fn(fn, *example_args)` traces `fn` once on the example arguments
into an `ExportedProgram` and returns its serialized bytes;
`load_exported(src)` rebuilds a callable from those bytes (or a file)
without any model code: only the port's custom ops must be registered
(the kernels a program reaches are `torch.library.custom_op`s with fake
implementations, as `ops/flash_attention.py`'s K1 forward; loading
registers them). Typical flow::

    gen = T.make_generate(cfg, max_new=64)
    blob = aot.export_fn(gen, params, prompt, None)
    aot.save_exported("gpt.nkx", gen, params, prompt, None)
    ...
    call = aot.load_exported("gpt.nkx")                # no model code
    tokens = call(params, prompt, None)

Shapes, dtypes and the device are fixed at export time: a call with other
shapes raises, as JAX's does; export one artifact per served (batch,
prompt length) bucket. Arguments that hold tensors (a tensor, a dict,
list or tuple of them, or a `ShapeDtypeStruct`) are the program's inputs;
every other argument is baked in at its example value and must be passed
again equal to it. A `torch.Generator` cannot be an exported input: it is
traced as None, and a program that then draws random numbers (sampled
generation) is refused; export the greedy program (temperature 0), whose
tokens the loaded program reproduces bit for bit.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, NamedTuple, Tuple

import torch

from ..config import config
from ..device import resolve

__all__ = ["ShapeDtypeStruct", "export_fn", "load_exported",
           "save_exported"]

_META = "neuronika_tpu_torch/aot.json"
# aten ops that draw from a generator
_RANDOM_OPS = ("rand", "randn", "randint", "rand_like", "randn_like",
               "randint_like", "randperm", "bernoulli", "normal", "uniform",
               "exponential", "multinomial", "native_dropout", "poisson",
               "geometric", "cauchy", "log_normal", "random")


class ShapeDtypeStruct(NamedTuple):
    """An example input given by shape and dtype alone (JAX's
    `jax.ShapeDtypeStruct`); the trace reads zeros of that shape on
    `config.device` ("cuda" unless the caller asks for the CPU)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _holds_tensors(x) -> bool:
    if isinstance(x, (torch.Tensor, ShapeDtypeStruct)):
        return True
    if isinstance(x, dict):
        return any(_holds_tensors(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_tensors(v) for v in x)
    return False


def _example(x):
    if isinstance(x, ShapeDtypeStruct):
        return torch.zeros(x.shape, dtype=x.dtype,
                           device=resolve(config.device))
    if isinstance(x, dict):
        return {k: _example(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_example(v) for v in x)
    return x


def _static_value(x):
    """The JSON record of a baked-in argument."""
    if isinstance(x, torch.Generator):
        return {"generator": True}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"export_fn: an argument of type {type(x).__name__} "
                    f"is neither a tensor tree nor a constant")


class _Program(torch.nn.Module):
    """fn as a module over its tensor arguments; the others baked in (a
    generator as None)."""

    def __init__(self, fn: Callable, n_args: int, static: dict) -> None:
        super().__init__()
        self.fn, self.n_args, self.static = fn, n_args, static

    def forward(self, *inputs):
        it = iter(inputs)
        args = [next(it) if i not in self.static
                else self.static[i].get("value")
                for i in range(self.n_args)]
        return self.fn(*args)


def _refuse_random(ep) -> None:
    """Refuse a program that draws random numbers; the walk enters the
    subgraphs of higher-order ops (a `no_grad` region is one)."""
    nodes = [n for m in ep.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes]
    for node in nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "__name__", str(node.target))
        base = name.split(".")[0].rstrip("_")
        if base in _RANDOM_OPS:
            raise NotImplementedError(
                f"export_fn: the program draws random numbers ({name}); a "
                f"torch.Generator cannot be an exported input. Export the "
                f"greedy program (temperature 0); ROADMAP.md queue 1 item 5")


def export_fn(fn: Callable, *example_args) -> bytes:
    """Trace `fn` on `example_args` (tensors, trees of them,
    `ShapeDtypeStruct`s, or constants) with `torch.export` and return the
    serialized program."""
    static = {i: _static_value(a) for i, a in enumerate(example_args)
              if not _holds_tensors(a)}
    inputs = tuple(_example(a) for i, a in enumerate(example_args)
                   if i not in static)
    ep = torch.export.export(_Program(fn, len(example_args), static),
                             inputs, strict=False)
    _refuse_random(ep)
    ep.example_inputs = None    # the weights are inputs: do not ship them
    meta = {"n_args": len(example_args),
            "static": {str(i): v for i, v in static.items()}}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_exported(src) -> Callable:
    """A callable running the exported program of `export_fn` bytes or a
    file path; it takes the export's argument list (baked-in arguments
    equal to their example values; any generator or None where a
    generator was) and needs no model code."""
    from ..ops import flash_attention  # noqa: F401  registers the custom ops

    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            src = f.read()
    extra = {_META: ""}
    ep = torch.export.load(io.BytesIO(src), extra_files=extra)
    meta = json.loads(extra[_META])
    static = {int(i): v for i, v in meta["static"].items()}
    module = ep.module()

    def call(*args):
        if len(args) != meta["n_args"]:
            raise TypeError(f"the exported program takes {meta['n_args']} "
                            f"arguments, got {len(args)}")
        for i, rec in static.items():
            a = args[i]
            if "generator" in rec:
                if a is not None and not isinstance(a, torch.Generator):
                    raise TypeError(f"argument {i}: a generator or None")
            elif a != rec["value"]:
                raise ValueError(f"argument {i} was baked in as "
                                 f"{rec['value']!r}, got {a!r}")
        return module(*[a for i, a in enumerate(args) if i not in static])

    return call


def save_exported(path, fn: Callable, *example_args) -> None:
    """`export_fn` straight to a file (conventional suffix: .nkx)."""
    blob = export_fn(fn, *example_args)
    with open(path, "wb") as f:
        f.write(blob)
