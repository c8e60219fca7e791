"""Functional optimizer updates over params trees (counterpart of
`neuronika_tpu/optim/functional.py`): SGD, Adam, AMSGrad, Adagrad, RMSProp,
AdamW, Lion, Muon and Adafactor as `*_init` / `*_update` pairs, EMA of the
params, `warmup_cosine_schedule`, and global-norm clipping.

Trees are nested dicts of tensors. Every `*_update` writes the new params
and state IN PLACE into the tensors it is given (the JAX train step
donates both trees) and returns the same trees, so a step holds no second
copy of either; `step` counters are new f32 scalars. Each rule is the
JAX package's as written: Adam, AdamW, Lion, Muon and Adafactor
compute in f32 and round each result once to the dtype of the tensor that
stores it (where JAX rounds a new moment before the parameter update reads
it, the update reads the rounded moment here too); SGD, AMSGrad, Adagrad
and RMSProp compute in the leaves' dtype, op by op, with JAX's type
promotion (`_c`, `_mul`); every rule takes the parameter step
`p - delta` in f32 (`_step_param`)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .._tree import tree_leaves, tree_map
from ._newton_schulz import newton_schulz5

__all__ = [
    "sgd_init", "sgd_update",
    "adam_init", "adam_update",
    "amsgrad_init", "amsgrad_update",
    "adagrad_init", "adagrad_update",
    "rmsprop_init", "rmsprop_update",
    "adamw_init", "adamw_update",
    "lion_init", "lion_update",
    "muon_init", "muon_update",
    "adafactor_init", "adafactor_update",
    "ema_init", "ema_update", "ema_params",
    "warmup_cosine_schedule", "global_norm", "clip_by_global_norm",
]


def _step_param(p, delta):
    """`p - delta` computed in f32, result in p's dtype."""
    return (p.float() - delta.float()).to(p.dtype)


def _zeros_like_tree(params, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                    params)


def _step0(params) -> torch.Tensor:
    """An f32 step counter of 0 on the params' device."""
    return torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)


def _bias_corrections(step, b1, b2):
    return 1.0 - torch.pow(b1, step), 1.0 - torch.pow(b2, step)


# SGD, AMSGrad, Adagrad and RMSProp are written in the leaves' dtype in JAX
# and run so here, op by op: a Python coefficient is weakly typed there,
# rounded to the array's dtype first (`_c`; torch would keep it in f32),
# and a product with an array scalar (lr given as a tensor, a bias
# correction) is promoted to f32 (`_mul`; torch would keep the leaf's
# dtype).


def _c(coef, t) -> float:
    """A Python coefficient rounded to t's dtype, as JAX's weak typing."""
    return float(torch.tensor(coef, dtype=t.dtype))


def _mul(x, s):
    """x * s with JAX's promotion: a Python scalar takes x's dtype, an
    array scalar (a tensor) promotes the product to f32."""
    if isinstance(s, torch.Tensor):
        return x.float() * s
    return x * _c(s, x)


# -------------------------------------------------------------------- SGD


def sgd_init(params, momentum: float = 0.0) -> Dict:
    """A zero momentum buffer in each param's dtype when `momentum` is set,
    else no state."""
    return {"buffer": _zeros_like_tree(params)} if momentum else {}


def sgd_update(params, grads, state, lr, momentum: float = 0.0,
               dampening: float = 0.0, nesterov: bool = False):
    """SGD with optional momentum, dampening and Nesterov; the buffer starts
    at zero, so the first momentum step applies (1 - dampening) g."""
    with torch.no_grad():
        if not momentum:
            tree_map(lambda p, g: p.copy_(_step_param(p, _mul(g, lr))),
                     params, grads)
            return params, state

        def upd(p, g, b):
            b.copy_(b * _c(momentum, b) + g * _c(1.0 - dampening, g))
            d = (g + b * _c(momentum, b)) if nesterov else b
            p.copy_(_step_param(p, _mul(d, lr)))

        tree_map(upd, params, grads, state["buffer"])
    return params, {"buffer": state["buffer"]}


# ------------------------------------------------------------------- Adam


def adam_init(params, state_dtype=None) -> Dict:
    """Zero m and v in `state_dtype` (default: each param's dtype) and an
    f32 step of 0 on the params' device."""
    return {"m": _zeros_like_tree(params, state_dtype),
            "v": _zeros_like_tree(params, state_dtype),
            "step": _step0(params)}


def _adam_moments(m, v, g32, b1, b2):
    """New m and v written in place, rounded to their dtype."""
    m.copy_(m.float() * b1 + g32 * (1 - b1))
    v.copy_(v.float() * b2 + g32 * g32 * (1 - b2))


def adam_update(params, grads, state, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """Bias-corrected Adam (the JAX rule), in place; returns (params,
    state) with the same tensors and a new step."""
    step = state["step"] + 1.0
    bc1, bc2 = _bias_corrections(step, b1, b2)
    lr_c = lr / bc1
    sq_bc2 = torch.sqrt(bc2)

    def upd(p, g, m, v):
        _adam_moments(m, v, g.float(), b1, b2)
        delta = m.float() / (torch.sqrt(v.float()) / sq_bc2 + eps) * lr_c
        p.copy_(_step_param(p, delta))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------- AMSGrad


def amsgrad_init(params) -> Dict:
    s = adam_init(params)
    s["vmax"] = _zeros_like_tree(params)
    return s


def amsgrad_update(params, grads, state, lr, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """Adam on the running maximum of v."""
    step = state["step"] + 1.0
    bc1, bc2 = _bias_corrections(step, b1, b2)
    lr_c = lr / bc1
    sq_bc2 = torch.sqrt(bc2)

    def upd(p, g, m, v, vmax):
        m.copy_(m * _c(b1, m) + g * _c(1 - b1, g))
        v.copy_(v * _c(b2, v) + g * g * _c(1 - b2, g))
        vmax.copy_(torch.maximum(vmax, v))
        p.copy_(_step_param(p, m.float() / (torch.sqrt(vmax).float() / sq_bc2
                                            + eps) * lr_c))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"], state["vmax"])
    return params, {"m": state["m"], "v": state["v"], "vmax": state["vmax"],
                    "step": step}


# ---------------------------------------------------------------- Adagrad


def adagrad_init(params) -> Dict:
    return {"grad_sq": _zeros_like_tree(params), "step": _step0(params)}


def adagrad_update(params, grads, state, lr, lr_decay: float = 0.0,
                   eps: float = 1e-10):
    """Adagrad with lr decay."""
    step = state["step"] + 1.0
    clr = lr / (1.0 + (step - 1.0) * lr_decay)

    def upd(p, g, s):
        s.copy_(s + g * g)
        p.copy_(_step_param(p, _mul(g / (torch.sqrt(s) + _c(eps, s)), clr)))

    with torch.no_grad():
        tree_map(upd, params, grads, state["grad_sq"])
    return params, {"grad_sq": state["grad_sq"], "step": step}


# ---------------------------------------------------------------- RMSProp


def rmsprop_init(params, momentum: float = 0.0, centered: bool = False) -> Dict:
    state = {"square_avg": _zeros_like_tree(params)}
    if centered:
        state["grad_avg"] = _zeros_like_tree(params)
    if momentum:
        state["buffer"] = _zeros_like_tree(params)
    return state


def rmsprop_update(params, grads, state, lr, alpha: float = 0.99,
                   momentum: float = 0.0, centered: bool = False,
                   eps: float = 1e-8):
    """RMSProp's four paths: plain or centered, with or without momentum."""

    def upd(p, g, *s):
        s = dict(zip(keys, s))
        sq = s["square_avg"]
        sq.copy_(sq * _c(alpha, sq) + g * g * _c(1 - alpha, g))
        if centered:
            ga = s["grad_avg"]
            ga.copy_(ga * _c(alpha, ga) + g * _c(1 - alpha, g))
            denom = torch.sqrt(sq - ga * ga) + _c(eps, sq)
        else:
            denom = torch.sqrt(sq) + _c(eps, sq)
        if momentum:
            buf = s["buffer"]
            buf.copy_(buf * _c(momentum, buf) + g / denom)
            p.copy_(_step_param(p, _mul(buf, lr)))
        else:
            p.copy_(_step_param(p, _mul(g / denom, lr)))

    keys = [k for k in ("square_avg", "grad_avg", "buffer") if k in state]
    with torch.no_grad():
        tree_map(upd, params, grads, *(state[k] for k in keys))
    return params, dict(state)


# ---------------------------------------------------------------- AdamW


def adamw_init(params, state_dtype=None) -> Dict:
    return adam_init(params, state_dtype)


def adamw_update(params, grads, state, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """Adam with decoupled weight decay: the decay multiplies the old
    parameter directly instead of entering the moments."""
    step = state["step"] + 1.0
    bc1, bc2 = _bias_corrections(step, b1, b2)
    lr_c = lr / bc1
    sq_bc2 = torch.sqrt(bc2)
    wd = lr * weight_decay

    def upd(p, g, m, v):
        _adam_moments(m, v, g.float(), b1, b2)
        delta = (m.float() / (torch.sqrt(v.float()) / sq_bc2 + eps) * lr_c
                 + p.float() * wd)
        p.copy_(_step_param(p, delta))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ----------------------------------------------------------------- Lion


def lion_init(params, state_dtype=None) -> Dict:
    return {"m": _zeros_like_tree(params, state_dtype),
            "step": _step0(params)}


def lion_update(params, grads, state, lr, b1: float = 0.9,
                b2: float = 0.99, weight_decay: float = 0.0):
    """Lion (Chen et al. 2023): the sign of an interpolated momentum; one
    state tree."""
    step = state["step"] + 1.0
    wd = lr * weight_decay

    def upd(p, g, m):
        m32, g32 = m.float(), g.float()
        u = torch.sign(m32 * b1 + g32 * (1 - b1))
        p.copy_(_step_param(p, u * lr + p.float() * wd))
        m.copy_(m32 * b2 + g32 * (1 - b2))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"])
    return params, {"m": state["m"], "step": step}


# ------------------------------------------------------------------ Muon


def muon_init(params) -> Dict:
    return {"m": _zeros_like_tree(params, torch.float32),
            "step": _step0(params)}


def muon_update(params, grads, state, lr, momentum: float = 0.95,
                nesterov: bool = True, ns_steps: int = 5,
                adam_lr_scale: float = 1.0):
    """Muon (Jordan et al. 2024): a leaf of rank 2 or more steps by the
    quintic Newton-Schulz orthogonalisation of its momentum, scaled by
    sqrt(max(1, rows/cols)), leading axes batched; other leaves by
    momentum SGD at `lr * adam_lr_scale`. The buffer is f32."""
    step = state["step"] + 1.0

    def upd(p, g, m):
        g32 = g.float()
        m.copy_(m * momentum + g32)
        d = m * momentum + g32 if nesterov else m
        if p.dim() >= 2:
            o = newton_schulz5(d, ns_steps)
            # sqrt in f32, as JAX traces it; a 0-d CPU tensor, so no copy
            # to the card
            scale = torch.sqrt(torch.tensor(
                max(1.0, p.shape[-2] / p.shape[-1]), dtype=torch.float32))
            p.copy_(_step_param(p, o * (lr * scale)))
        else:
            p.copy_(_step_param(p, d * (lr * adam_lr_scale)))

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"])
    return params, {"m": state["m"], "step": step}


# ------------------------------------------------------------- Adafactor


def adafactor_init(params) -> Dict:
    """Factored second moments (Shazeer & Stern 2018): a leaf of rank 2 or
    more keeps a row and a column accumulator (f32) over its last two axes,
    leading axes batched; a vector or scalar keeps a full one."""
    def init(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros((*p.shape[:-2], p.shape[-1]),
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"v": tree_map(init, params), "step": _step0(params)}


def adafactor_update(params, grads, state, lr, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     decay_rate_power: float = 0.8,
                     weight_decay: float = 0.0):
    """beta2_t = 1 - t^-p; the factored v-hat is (vr x vc) / mean(vr);
    updates are RMS-clipped to `clip_threshold`."""
    step = state["step"] + 1.0
    b2t = 1.0 - step ** (-decay_rate_power)
    wd = lr * weight_decay

    def upd(p, g, s):
        g32 = g.float()
        sq = g32 * g32 + eps
        if p.dim() >= 2:
            s["vr"].copy_(s["vr"] * b2t + sq.mean(-1) * (1 - b2t))
            s["vc"].copy_(s["vc"] * b2t + sq.mean(-2) * (1 - b2t))
            denom = s["vr"].mean(-1, keepdim=True)
            vhat = (s["vr"] / denom)[..., None] * s["vc"][..., None, :]
        else:
            s["v"].copy_(s["v"] * b2t + sq * (1 - b2t))
            vhat = s["v"]
        u = g32 * torch.rsqrt(vhat + eps)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(_step_param(p, u * lr + p.float() * wd))

    with torch.no_grad():
        tree_map(upd, params, grads, state["v"])
    return params, {"v": state["v"], "step": step}


# ------------------------------------------------------------------ extras


def ema_init(params):
    """An f32 shadow copy of the params tree for exponential moving
    averaging (evaluation and serving weights)."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def ema_update(ema, params, decay: float = 0.999):
    """ema <- decay ema + (1 - decay) params in f32, in place; returns
    `ema`."""
    with torch.no_grad():
        tree_map(lambda e, p: e.copy_(e * decay + p.float() * (1.0 - decay)),
                 ema, params)
    return ema


def ema_params(ema, params):
    """The f32 shadow in the live tree's dtypes, for evaluation."""
    return tree_map(lambda e, p: e.to(p.dtype), ema, params)


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           final_scale: float = 0.1):
    """step -> lr as a 0-d f32 tensor: linear warmup, then cosine decay to
    final_scale * base_lr."""

    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (final_scale + (1 - final_scale) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr_at


# ------------------------------------------------------- gradient clipping


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squared L2 norms over every leaf), in f32."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree so its global norm is <= max_norm; returns
    (clipped, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda l: (l * scale).to(l.dtype), tree), norm
