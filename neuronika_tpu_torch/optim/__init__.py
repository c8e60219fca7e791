"""Optimizers of the port (counterpart of `neuronika_tpu/optim/__init__.py`).

The define-by-run optimizers: `Optimizer` (register, step, zero_grad and
the fused `train_step`), `StochasticGD` (alias `SGD`), `Adam`, the penalties
`L1`/`L2`/`ElasticNet` and `clip_grad_norm`. Update rules are the JAX
package's (and so the reference's), including its divergences from
PyTorch's own optimizers: SGD's momentum buffer starts at zero, so the
first momentum step applies (1 - dampening) g, and the penalty is added to
the stored gradient before the update. The update runs in f32 whatever the
parameter and state dtypes, and is rounded back to them, in the JAX order;
hyperparameters are f32 scalars, as JAX traces them.

`functional` holds the functional tier's Adam and clipping over params
trees. AMSGrad, AdamW, Lion, Adafactor, Muon, Adagrad, RMSProp and
`lr_scheduler` are not ported yet (ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .._engine.executor import LRUCache
from ..variable import VarDiff
from . import functional

__all__ = [
    "Optimizer", "StochasticGD", "SGD", "Adam", "L1", "L2", "ElasticNet",
    "Penalty", "functional", "clip_grad_norm",
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


class Penalty:
    """Regularisation penalty added to the gradient: `grad += penalize(w)`."""

    def penalize(self, w):
        raise NotImplementedError


class L2(Penalty):
    """Weight decay: 2 lambda w."""

    def __init__(self, lam: float) -> None:
        self.lam = float(lam)

    def penalize(self, w):
        return 2.0 * self.lam * w


class L1(Penalty):
    """lambda sign(w)."""

    def __init__(self, lam: float) -> None:
        self.lam = float(lam)

    def penalize(self, w):
        return self.lam * torch.sign(w)


class ElasticNet(Penalty):
    """lambda_1 sign(w) + 2 lambda_2 w."""

    def __init__(self, lambda_l1: float, lambda_l2: float) -> None:
        self.lambda_l1 = float(lambda_l1)
        self.lambda_l2 = float(lambda_l2)

    def penalize(self, w):
        return self.lambda_l1 * torch.sign(w) + 2.0 * self.lambda_l2 * w


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
                if penalize:
                    g = g + self.penalty.penalize(data)
                state = self._state[i]
                nd, ns = self._update(data.float(), g.float(),
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
        from ..ops.functional import as_dtype

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
