"""Graph nodes (counterpart of `neuronika_tpu/_engine/node.py`).

A node is a leaf (holds data directly) or an op application carrying a pure
forward function and a VJP. Node ids are globally monotone and every parent
is created before its children, so sorting ids gives a topological order and
the ancestor walk dedups by identity (the reference's `History`). A node
records the device its value lives on; an absent value or gradient reads as
zeros on that device. `grad is None` while alive means "all zeros, not yet
materialised".
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

_IDS = itertools.count()

DEAD_GRADIENT_MSG = (
    "gradient has been deallocated. Perhaps you forgot to call .with_grad() "
    "after .no_grad()?"
)
FORWARD_NOT_CALLED_MSG = (
    "inconsistent state found. Perhaps you forgot to call .forward()?"
)


class Node:
    """One vertex of the define-by-run graph. Cloned `Var`s share the same
    Node (the reference's shared `Rc<RefCell<...>>` buffers)."""

    __slots__ = (
        "id", "op", "fn", "vjp", "parents", "extra", "shape", "dtype",
        "device", "value", "computed", "differentiable", "grad",
        "grad_alive", "rng", "status", "value_key", "__weakref__",
    )

    def __init__(
        self,
        op: str,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        device: torch.device,
        *,
        fn: Optional[Callable] = None,
        vjp: Optional[Callable] = None,
        parents: Sequence["Node"] = (),
        extra: Tuple = (),
        differentiable: bool = False,
        rng: bool = False,
        status: Optional[Any] = None,
    ) -> None:
        self.id = next(_IDS)
        self.op = op
        self.fn = fn
        self.vjp = vjp
        self.parents = tuple(parents)
        self.extra = extra
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.value = None          # torch.Tensor once computed / for leaves
        self.computed = False
        self.differentiable = differentiable
        self.grad = None           # accumulator; None == zeros
        self.grad_alive = True     # False after no_grad()
        self.rng = rng             # op draws a seed each forward (dropout)
        self.status = status       # shared train/eval cell for dropout
        self.value_key = None      # seed consumed by the last forward

    def is_leaf(self) -> bool:
        return self.fn is None

    def get_value(self) -> torch.Tensor:
        """Current buffer contents; zeros if never computed (the reference
        allocates zeroed output buffers at graph-build time)."""
        if self.value is None:
            return torch.zeros(self.shape, dtype=self.dtype,
                               device=self.device)
        return self.value

    def get_grad(self) -> torch.Tensor:
        if not self.grad_alive:
            raise RuntimeError(DEAD_GRADIENT_MSG)
        if self.grad is None:
            return torch.zeros(self.shape, dtype=self.dtype,
                               device=self.device)
        return self.grad

    def accumulate_grad(self, g) -> None:
        if not self.grad_alive:
            raise RuntimeError(DEAD_GRADIENT_MSG)
        self.grad = g if self.grad is None else self.grad + g

    def zero_grad(self) -> None:
        self.grad = None

    def no_grad(self) -> None:
        self.grad = None
        self.grad_alive = False

    def with_grad(self) -> None:
        self.grad = None
        self.grad_alive = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Node(id={self.id}, op={self.op}, shape={self.shape})"
