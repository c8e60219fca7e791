"""Functional optimizer updates over params trees (counterpart of
`neuronika_tpu/optim/functional.py`): Adam and global-norm clipping.

Trees are nested dicts of tensors. `adam_update` writes the new params
and moments IN PLACE into the tensors it is given (the JAX train step
donates both trees) and returns the same trees, so a step holds no second
copy of either. The update keeps the JAX rule's exact order: new m and v
are rounded to the state dtype first, and the parameter update reads the
rounded m and v; all arithmetic is f32 and `step` is an f32 scalar."""

from __future__ import annotations

from typing import Dict

import torch

from .._tree import tree_leaves, tree_map

__all__ = ["adam_init", "adam_update", "global_norm", "clip_by_global_norm"]


def _step_param(p, delta):
    """`p - delta` computed in f32, result in p's dtype."""
    return (p.float() - delta.float()).to(p.dtype)


def adam_init(params, state_dtype=None) -> Dict:
    """Zero m and v in `state_dtype` (default: each param's dtype) and an
    f32 step of 0 on the params' device."""
    leaves = tree_leaves(params)

    def zeros(p):
        return torch.zeros_like(p, dtype=state_dtype or p.dtype)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)}


def adam_update(params, grads, state, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """Bias-corrected Adam (the JAX rule), in place; returns (params,
    state) with the same tensors and a new step."""
    step = state["step"] + 1.0
    bc1 = 1.0 - torch.pow(b1, step)
    bc2 = 1.0 - torch.pow(b2, step)
    lr_c = lr / bc1
    sq_bc2 = torch.sqrt(bc2)

    def upd(p, g, m, v):
        g32 = g.float()
        m.copy_(m.float() * b1 + g32 * (1 - b1))
        v.copy_(v.float() * b2 + g32 * g32 * (1 - b2))
        delta = m.float() / (torch.sqrt(v.float()) / sq_bc2 + eps) * lr_c
        p.copy_(_step_param(p, delta))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squared L2 norms over every leaf), in f32."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree so its global norm is <= max_norm; returns
    (clipped, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda l: (l * scale).to(l.dtype), tree), norm
