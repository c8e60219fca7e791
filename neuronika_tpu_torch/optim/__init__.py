"""Optimizers of the port (counterpart of `neuronika_tpu/optim/__init__.py`).

The define-by-run optimizers `StochasticGD` (alias `SGD`), `Adam`,
`AMSGrad`, `AdamW`, `Lion`, `Adafactor`, `Muon`, `Adagrad` and `RMSProp`,
each a `_hyper` / `_init_state` / `_update` triple on `Optimizer`, whose
`step()` and fused `train_step` run every one of them; the penalties
`L1`/`L2`/`ElasticNet`, `clip_grad_norm` and `lr_scheduler`, which drives
`get_lr`/`set_lr` from the host. Update rules are the JAX package's (and
so the reference's), including its divergences from PyTorch's own
optimizers: SGD's momentum buffer starts at zero, so the first momentum
step applies (1 - dampening) g, and the penalty is added to the stored
gradient before the update. The update runs in f32 whatever the
parameter and state dtypes, and is rounded back to them, in the JAX order;
hyperparameters are f32 scalars, as JAX traces them. State takes the
parameter's dtype (or `state_dtype` where offered) but for Adafactor's
and Muon's, which are f32, as in JAX.

`functional` holds the functional tier's rules over params trees (SGD,
Adam, AMSGrad, Adagrad, RMSProp, AdamW, Lion, Muon, Adafactor, EMA,
`warmup_cosine_schedule`, clipping), updating in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .._engine.executor import LRUCache
from ..ops.functional import as_dtype
from ..variable import VarDiff
from . import functional, lr_scheduler
from ._newton_schulz import newton_schulz5

__all__ = [
    "Optimizer", "StochasticGD", "SGD", "Adam", "AdamW", "AMSGrad",
    "Adagrad", "RMSProp", "Lion", "Adafactor", "Muon", "L1", "L2",
    "ElasticNet", "Penalty", "lr_scheduler", "functional", "clip_grad_norm",
]


def clip_grad_norm(parameters, max_norm: float) -> float:
    """Scale the gradients of `parameters` (VarDiffs) in place so their
    global L2 norm is at most `max_norm`; returns the norm before clipping."""
    params = list(parameters)
    total = sum(float(p.grad().float().square().sum()) for p in params)
    norm = total ** 0.5
    if norm > max_norm and norm > 0.0:
        scale = max_norm / norm
        for p in params:
            p.node.grad = (p.grad() * scale).to(p.node.dtype)
    return norm


# --------------------------------------------------------------------------
# penalties


def _coef(c: float, w) -> float:
    """A Python coefficient as JAX applies it to an array: rounded to the
    array's dtype first (a weakly typed scalar), so a bf16 penalty is the
    same bf16 product in both packages."""
    return float(torch.tensor(c, dtype=w.dtype))


class Penalty:
    """Regularisation penalty added to the gradient: `grad += penalize(w)`,
    computed in w's dtype."""

    def penalize(self, w):
        raise NotImplementedError


class L2(Penalty):
    """Weight decay: 2 lambda w."""

    def __init__(self, lam: float) -> None:
        self.lam = float(lam)

    def penalize(self, w):
        return _coef(2.0 * self.lam, w) * w


class L1(Penalty):
    """lambda sign(w)."""

    def __init__(self, lam: float) -> None:
        self.lam = float(lam)

    def penalize(self, w):
        return _coef(self.lam, w) * torch.sign(w)


class ElasticNet(Penalty):
    """lambda_1 sign(w) + 2 lambda_2 w."""

    def __init__(self, lambda_l1: float, lambda_l2: float) -> None:
        self.lambda_l1 = float(lambda_l1)
        self.lambda_l2 = float(lambda_l2)

    def penalize(self, w):
        return (_coef(self.lambda_l1, w) * torch.sign(w)
                + _coef(2.0 * self.lambda_l2, w) * w)


class _NoPenalty(Penalty):
    def penalize(self, w):
        return 0.0


# --------------------------------------------------------------------------
# base optimizer


class Optimizer:
    """Holds registered parameters and updates them. Subclasses define
    `_hyper()` (scalars, passed as f32), `_init_state(param)` and
    `_update(data, grad, state, hyper, step)` over f32 tensors, returning
    (new_data, new_state). The penalized gradient is written back to the
    parameter's gradient cell by `step`."""

    def __init__(self, lr: float, penalty: Optional[Penalty] = None) -> None:
        self._lr = float(lr)
        self.penalty = penalty if penalty is not None else _NoPenalty()
        self._params: List[VarDiff] = []
        self._state: List[Dict[str, torch.Tensor]] = []
        self._step_count = 0
        self._fused_cache: LRUCache = LRUCache(32)

    # -------------------------------------------------------------- lr api
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, lr: float) -> None:
        if lr < 0.0:
            raise ValueError("the learning rate must be positive")
        self._lr = float(lr)

    @property
    def status(self):
        return self

    # ---------------------------------------------------------- registering
    def register(self, variable: VarDiff) -> None:
        """Register a differentiable variable as a parameter; the optimizer
        shares its data and gradient cells."""
        if not isinstance(variable, VarDiff):
            raise TypeError("only differentiable variables can be registered")
        self._params.append(variable)
        self._state.append(self._init_state(variable))

    def register_all(self, variables) -> None:
        for v in variables:
            self.register(v)

    # -------------------------------------------------------------- stepping
    def _apply_update(self, datas, grads, inplace: bool):
        """One update of every registered parameter from `grads` (None
        reads as zeros). In place: the parameter and state tensors are
        overwritten. Otherwise the nodes and the state get new tensors.
        Returns the penalized gradients."""
        hyper = tuple(torch.tensor(h, dtype=torch.float32)
                      for h in self._hyper())
        step = torch.tensor(float(self._step_count), dtype=torch.float32)
        penalize = not isinstance(self.penalty, _NoPenalty)
        out_g = []
        with torch.no_grad():
            for i, (data, g) in enumerate(zip(datas, grads)):
                if g is None:
                    g = torch.zeros_like(data)
                g32 = g.float()
                if penalize:
                    # as JAX's program runs (XLA keeps the excess precision
                    # of a fused sum): the penalty in the parameter's
                    # dtype, its sum with the gradient in f32 and handed to
                    # the update unrounded; only the gradient written back
                    # takes the parameter's dtype
                    g32 = g32 + self.penalty.penalize(data).float()
                    g = g32.to(g.dtype)
                state = self._state[i]
                nd, ns = self._update(data.float(), g32,
                                      {k: v.float() for k, v in state.items()},
                                      hyper, step)
                if inplace:
                    data.copy_(nd)
                    for k, v in state.items():
                        v.copy_(ns[k])
                else:
                    node = self._params[i].node
                    node.value = nd.to(data.dtype)
                    node.computed = True
                    self._state[i] = {k: ns[k].to(v.dtype)
                                      for k, v in state.items()}
                out_g.append(g)
        return out_g

    def step(self) -> None:
        """Apply one update to every registered parameter."""
        if not self._params:
            return
        datas = [p.node.get_value() for p in self._params]
        grads = [p.node.get_grad() for p in self._params]
        self._step_count += 1
        for p, g in zip(self._params,
                        self._apply_update(datas, grads, inplace=False)):
            p.node.grad = g

    def zero_grad(self) -> None:
        for p in self._params:
            p.node.zero_grad()

    def train_step(self, loss, seed: float = 1.0, donate: bool = False,
                   block: bool = True):
        """Fused step: forward, backward and this optimizer's update in one
        call, equivalent to `loss.forward(); loss.backward(seed);
        self.step(); self.zero_grad()` except that interior values and
        gradients are not kept and the parameters are updated in place.
        Returns the loss, or None with ``block=False`` (read `loss.item()`
        later). ``donate`` is accepted for parity with the JAX package and
        changes nothing: the update is in place already."""
        from .._engine import executor

        return executor.fused_train_step(loss.node, self, seed, donate, block)

    # ------------------------------------------------------------ subclass
    def _hyper(self) -> Tuple[float, ...]:
        raise NotImplementedError

    def _init_state(self, variable: VarDiff) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _update(self, data, grad, state, hyper, step):
        raise NotImplementedError


# --------------------------------------------------------------------------
# SGD


class StochasticGD(Optimizer):
    """SGD with optional momentum / dampening / nesterov."""

    def __init__(self, lr, penalty=None, momentum=None, dampening=None,
                 nesterov: bool = False) -> None:
        super().__init__(lr, penalty)
        self.momentum = None if momentum in (None, 0.0) else float(momentum)
        self.dampening = 0.0 if dampening is None else float(dampening)
        self.nesterov = bool(nesterov)
        if self.nesterov and self.momentum is None:
            raise ValueError("nesterov momentum requires a momentum")

    def get_momentum(self):
        return self.momentum

    def get_dampening(self):
        return self.dampening

    def get_nesterov(self):
        return self.nesterov

    def _hyper(self):
        return (self._lr, self.momentum or 0.0, self.dampening)

    def _init_state(self, variable):
        if self.momentum is None:
            return {}
        return {"buffer": torch.zeros(variable.shape, dtype=variable.dtype,
                                      device=variable.node.device)}

    def _update(self, data, grad, state, hyper, step):
        lr, momentum, dampening = hyper
        if self.momentum is None:
            return data - grad * lr, state
        buf = state["buffer"] * momentum + grad * (1.0 - dampening)
        if self.nesterov:
            new = data - (grad + buf * momentum) * lr
        else:
            new = data - buf * lr
        return new, {"buffer": buf}


SGD = StochasticGD


# --------------------------------------------------------------------------
# Adam


class Adam(Optimizer):
    def __init__(self, lr, beta1: float = 0.9, beta2: float = 0.999,
                 penalty=None, eps: float = 1e-8, state_dtype=None) -> None:
        """`state_dtype` (e.g. torch.bfloat16 or "bfloat16") stores m and v
        in that dtype; the update math stays f32."""
        super().__init__(lr, penalty)
        self.beta1, self.beta2, self.eps = (float(beta1), float(beta2),
                                            float(eps))
        self.state_dtype = None if state_dtype is None else as_dtype(
            state_dtype)

    def _hyper(self):
        return (self._lr, self.beta1, self.beta2, self.eps)

    def _init_state(self, variable):
        def z():
            return torch.zeros(variable.shape,
                               dtype=self.state_dtype or variable.dtype,
                               device=variable.node.device)

        return {"exp_avg": z(), "exp_avg_sq": z()}

    def _update(self, data, grad, state, hyper, step):
        lr, b1, b2, eps = hyper
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        m = state["exp_avg"] * b1 + grad * (1.0 - b1)
        v = state["exp_avg_sq"] * b2 + grad * grad * (1.0 - b2)
        new = data - m / (torch.sqrt(v) / torch.sqrt(bc2) + eps) * (lr / bc1)
        return new, {"exp_avg": m, "exp_avg_sq": v}


def _zeros_like(variable, dtype=None):
    return torch.zeros(variable.shape, dtype=dtype or variable.dtype,
                       device=variable.node.device)


class AMSGrad(Adam):
    """Adam with a running max of the second-moment estimate. Its state
    takes the parameter's dtype (no `state_dtype`), as in JAX."""

    def _init_state(self, variable):
        return {"exp_avg": _zeros_like(variable),
                "exp_avg_sq": _zeros_like(variable),
                "max_exp_avg_sq": _zeros_like(variable)}

    def _update(self, data, grad, state, hyper, step):
        lr, b1, b2, eps = hyper
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        m = state["exp_avg"] * b1 + grad * (1.0 - b1)
        v = state["exp_avg_sq"] * b2 + grad * grad * (1.0 - b2)
        vmax = torch.maximum(state["max_exp_avg_sq"], v)
        new = data - m / (torch.sqrt(vmax) / torch.sqrt(bc2) + eps) * (
            lr / bc1)
        return new, {"exp_avg": m, "exp_avg_sq": v, "max_exp_avg_sq": vmax}


class AdamW(Adam):
    """Adam with decoupled weight decay: the decay multiplies the old
    parameter directly instead of flowing through the moments."""

    def __init__(self, lr, beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.01, penalty=None, eps: float = 1e-8,
                 state_dtype=None) -> None:
        super().__init__(lr, beta1, beta2, penalty, eps, state_dtype)
        self.weight_decay = float(weight_decay)

    def _hyper(self):
        return (self._lr, self.beta1, self.beta2, self.eps,
                self.weight_decay)

    def _update(self, data, grad, state, hyper, step):
        lr, b1, b2, eps, wd = hyper
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        m = state["exp_avg"] * b1 + grad * (1.0 - b1)
        v = state["exp_avg_sq"] * b2 + grad * grad * (1.0 - b2)
        new = (data
               - m / (torch.sqrt(v) / torch.sqrt(bc2) + eps) * (lr / bc1)
               - data * (lr * wd))
        return new, {"exp_avg": m, "exp_avg_sq": v}


class Lion(Optimizer):
    """Sign-momentum optimizer (Chen et al. 2023): one state buffer a
    parameter and a sign update."""

    def __init__(self, lr, beta1: float = 0.9, beta2: float = 0.99,
                 weight_decay: float = 0.0, penalty=None,
                 state_dtype=None) -> None:
        super().__init__(lr, penalty)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.weight_decay = float(weight_decay)
        self.state_dtype = None if state_dtype is None else as_dtype(
            state_dtype)

    def _hyper(self):
        return (self._lr, self.beta1, self.beta2, self.weight_decay)

    def _init_state(self, variable):
        return {"exp_avg": _zeros_like(variable, self.state_dtype)}

    def _update(self, data, grad, state, hyper, step):
        lr, b1, b2, wd = hyper
        m0 = state["exp_avg"]
        u = torch.sign(m0 * b1 + grad * (1.0 - b1))
        new = data - u * lr - data * (lr * wd)
        return new, {"exp_avg": m0 * b2 + grad * (1.0 - b2)}


class Adafactor(Optimizer):
    """Factored second moments (Shazeer & Stern 2018): a parameter of rank
    2 or more keeps a row and a column accumulator (f32) instead of a full
    second-moment tensor; a vector keeps a full one."""

    def __init__(self, lr, clip_threshold: float = 1.0,
                 decay_rate_power: float = 0.8, weight_decay: float = 0.0,
                 penalty=None, eps: float = 1e-30) -> None:
        super().__init__(lr, penalty)
        self.clip_threshold = float(clip_threshold)
        self.decay_rate_power = float(decay_rate_power)
        self.weight_decay = float(weight_decay)
        self.eps = float(eps)

    def _hyper(self):
        return (self._lr, self.clip_threshold, self.weight_decay, self.eps)

    def _init_state(self, variable):
        shape, dev = variable.shape, variable.node.device
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev),
                    "vc": torch.zeros((*shape[:-2], shape[-1]),
                                      dtype=torch.float32, device=dev)}
        return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}

    def _update(self, data, grad, state, hyper, step):
        lr, clip, wd, eps = hyper
        b2t = 1.0 - step ** (-self.decay_rate_power)
        sq = grad * grad + eps
        if data.dim() >= 2:
            vr = state["vr"] * b2t + sq.mean(-1) * (1.0 - b2t)
            vc = state["vc"] * b2t + sq.mean(-2) * (1.0 - b2t)
            denom = vr.mean(-1, keepdim=True)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            ns = {"vr": vr, "vc": vc}
        else:
            vhat = state["v"] * b2t + sq * (1.0 - b2t)
            ns = {"v": vhat}
        u = grad * torch.rsqrt(vhat + eps)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms / clip, min=1.0)
        return data - u * lr - data * (lr * wd), ns


class Muon(Optimizer):
    """Orthogonalised momentum (Jordan et al. 2024): a parameter of rank 2
    or more steps by the quintic Newton-Schulz orthogonalisation of its
    momentum (five matmul-only iterations); others by momentum SGD. The
    buffer is f32."""

    def __init__(self, lr, momentum: float = 0.95, nesterov: bool = True,
                 ns_steps: int = 5, penalty=None) -> None:
        super().__init__(lr, penalty)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.ns_steps = int(ns_steps)

    def _hyper(self):
        return (self._lr, self.momentum)

    def _init_state(self, variable):
        return {"buffer": _zeros_like(variable, torch.float32)}

    def _update(self, data, grad, state, hyper, step):
        lr, mom = hyper
        m = state["buffer"] * mom + grad
        d = m * mom + grad if self.nesterov else m
        if data.dim() >= 2:
            o = newton_schulz5(d, self.ns_steps)
            # sqrt in f32, as JAX traces it; a 0-d CPU tensor like the
            # hyperparameters, so no copy to the card
            scale = torch.sqrt(torch.tensor(
                max(1.0, data.shape[-2] / data.shape[-1]),
                dtype=torch.float32))
            new = data - o * (lr * scale)
        else:
            new = data - d * lr
        return new, {"buffer": m}


class Adagrad(Optimizer):
    def __init__(self, lr, lr_decay: float = 0.0, penalty=None,
                 eps: float = 1e-10) -> None:
        super().__init__(lr, penalty)
        self.lr_decay, self.eps = float(lr_decay), float(eps)

    def _hyper(self):
        return (self._lr, self.lr_decay, self.eps)

    def _init_state(self, variable):
        return {"grad_sq": _zeros_like(variable)}

    def _update(self, data, grad, state, hyper, step):
        lr, lr_decay, eps = hyper
        clr = lr / (1.0 + (step - 1.0) * lr_decay)
        gs = state["grad_sq"] + grad * grad
        return data - grad / (torch.sqrt(gs) + eps) * clr, {"grad_sq": gs}


class RMSProp(Optimizer):
    """RMSProp's four paths: plain or centered, with or without
    momentum."""

    def __init__(self, lr, penalty=None, alpha=None, momentum=None,
                 centered: bool = False, eps: float = 1e-8) -> None:
        super().__init__(lr, penalty)
        self.alpha = 0.0 if alpha is None else float(alpha)
        self.momentum = None if momentum in (None, 0.0) else float(momentum)
        self.centered = bool(centered)
        self.eps = float(eps)

    def _hyper(self):
        return (self._lr, self.alpha, self.momentum or 0.0, self.eps)

    def _init_state(self, variable):
        s = {"square_avg": _zeros_like(variable)}
        if self.centered:
            s["grad_avg"] = _zeros_like(variable)
        if self.momentum is not None:
            s["buffer"] = _zeros_like(variable)
        return s

    def _update(self, data, grad, state, hyper, step):
        lr, alpha, momentum, eps = hyper
        sq = state["square_avg"] * alpha + grad * grad * (1.0 - alpha)
        new_state = {"square_avg": sq}
        if self.centered:
            ga = state["grad_avg"] * alpha + grad * (1.0 - alpha)
            new_state["grad_avg"] = ga
            denom = torch.sqrt(sq - ga * ga) + eps
        else:
            denom = torch.sqrt(sq) + eps
        if self.momentum is not None:
            buf = state["buffer"] * momentum + grad / denom
            new_state["buffer"] = buf
            return data - buf * lr, new_state
        return data - grad / denom * lr, new_state
