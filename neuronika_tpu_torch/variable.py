"""`Var` / `VarDiff`: the define-by-run variable handles (counterpart of
`neuronika_tpu/variable.py`).

* `Var` is non-differentiable, `VarDiff` differentiable; differentiability
  is sticky: any op with a `VarDiff` operand yields a `VarDiff`.
* ops record graph nodes; nothing computes until `.forward()`;
  `.backward(seed)` replays VJPs in reverse, accumulating into every
  differentiable node's gradient cell.
* cloned handles share the node, and `.data()` / `.grad()` read its cells,
  as `torch.Tensor`s on the node's device.

An op's output shape and dtype are found when the node is created, by
running its forward on "meta" tensors (JAX: `jax.eval_shape`); on meta
tensors the kernel wrappers take their plain versions.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ._engine import executor
from ._engine.executor import LRUCache
from ._engine.node import Node
from .ops import sharded
from .ops.functional import OPS, as_dtype, dtype_name


class Reduction:
    """Loss reduction (the reference's `Reduction` enum)."""

    Sum = "sum"
    Mean = "mean"


class StatusCell:
    """Shared train/eval switch consumed by dropout. ``True`` means
    training (dropout active)."""

    __slots__ = ("value",)

    def __init__(self, value: bool = True) -> None:
        self.value = bool(value)

    def set(self, value: bool) -> None:
        self.value = bool(value)

    def get(self) -> bool:
        return self.value


# --------------------------------------------------------------------------
# tensors from what callers hand in


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A fresh tensor of `dtype` on `device` holding `x` (a tensor, a numpy
    array, including JAX's bfloat16 arrays, or a Python number). Always a
    copy, so an in-place parameter update never writes into the caller's
    array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype, copy=True)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # exact; torch has no numpy bfloat16
    return torch.tensor(arr, device=device).to(dtype)


def _leaf(t: torch.Tensor) -> "Var":
    node = Node("leaf", tuple(t.shape), t.dtype, t.device)
    node.value = t
    node.computed = True
    return Var(node)


# --------------------------------------------------------------------------
# graph construction


def _to_operand(x: Any, dtype=None, device=None) -> "Var":
    """Coerce a scalar or array to a constant leaf Var: in `dtype` (f32 by
    default), on `device` (the peer operand's)."""
    if isinstance(x, Var):
        return x
    dt = as_dtype(dtype) if dtype is not None else torch.float32
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    return _leaf(_tensor(x, dt, device))


_SHAPE_MEMO: LRUCache = LRUCache(8192)


def _infer_shape(op, extra, parents):
    key = (op.name, extra, tuple((p.shape, p.dtype) for p in parents))
    hit = _SHAPE_MEMO.get(key)
    if hit is None:
        metas = [torch.empty(p.shape, dtype=p.dtype, device="meta")
                 for p in parents]
        if op.rng:
            out = op.fwd(extra, *metas, key=0, train=True)
        else:
            out = op.fwd(extra, *metas)
        hit = (tuple(out.shape), out.dtype)
        _SHAPE_MEMO[key] = hit
    return hit


def _apply(name: str, operands: Sequence["Var"], extra: Tuple = (),
           status=None):
    op = OPS[name]
    parents = [o.node for o in operands]
    devices = {p.device for p in parents}
    if len(devices) > 1:
        raise ValueError(f"{name}: operands on different devices "
                         f"{sorted(map(str, devices))}")
    diff = any(isinstance(o, VarDiff) for o in operands)
    out_shape, out_dtype = _infer_shape(op, extra, parents)
    node = Node(name, out_shape, out_dtype, parents[0].device, fn=op.fwd,
                vjp=op.vjp, parents=parents, extra=extra,
                differentiable=diff, rng=op.rng, status=status)
    return VarDiff(node) if diff else Var(node)


def _int_tuple(x) -> Tuple[int, ...]:
    return tuple(int(v) for v in (x if isinstance(x, (tuple, list)) else (x,)))


class Var:
    """Non-differentiable variable."""

    __slots__ = ("node",)

    def __init__(self, node: Node) -> None:
        self.node = node

    def _with_value(self, value) -> "Var":
        self.node.value = value
        self.node.computed = True
        return self

    def _peer(self, x, dtype=None) -> "Var":
        """`x` as an operand beside self: scalars on self's device, in
        `dtype` (f32 when None, as the JAX package defaults)."""
        return _to_operand(x, dtype, self.node.device)

    # ------------------------------------------------------------ plumbing
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.node.shape

    @property
    def ndim(self) -> int:
        return len(self.node.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.node.dtype

    @property
    def device(self) -> torch.device:
        return self.node.device

    def data(self) -> torch.Tensor:
        """Current buffer contents (zeros until the first `forward()`); a
        sharded value is read whole, the same on every rank."""
        return sharded.whole(self.node.get_value())

    def data_mut(self):
        """Mutable access: a numpy copy that is written back on exit of the
        context (`with v.data_mut() as arr: ...`)."""
        return _MutGuard(self.node)

    def assign(self, array) -> None:
        """Overwrite the underlying buffer."""
        t = _tensor(array, self.node.dtype, self.node.device)
        if tuple(t.shape) != self.node.shape:
            raise ValueError(f"assign shape mismatch: {tuple(t.shape)} vs "
                             f"{self.node.shape}")
        self.node.value = t
        self.node.computed = True

    def item(self) -> float:
        return float(self.data().reshape(-1)[0])

    def forward(self) -> None:
        executor.forward(self.node)

    def requires_grad(self) -> "VarDiff":
        """Promote to a differentiable variable."""
        self.node.differentiable = True
        return VarDiff(self.node)

    # ----------------------------------------------------------- operators
    def __add__(self, rhs):
        return _apply("add", (self, self._peer(rhs, self.dtype)))

    def __radd__(self, lhs):
        return _apply("add", (self._peer(lhs, self.dtype), self))

    def __sub__(self, rhs):
        return _apply("sub", (self, self._peer(rhs, self.dtype)))

    def __rsub__(self, lhs):
        return _apply("sub", (self._peer(lhs, self.dtype), self))

    def __mul__(self, rhs):
        return _apply("mul", (self, self._peer(rhs, self.dtype)))

    def __rmul__(self, lhs):
        return _apply("mul", (self._peer(lhs, self.dtype), self))

    def __truediv__(self, rhs):
        return _apply("div", (self, self._peer(rhs, self.dtype)))

    def __rtruediv__(self, lhs):
        return _apply("div", (self._peer(lhs, self.dtype), self))

    def __neg__(self):
        return _apply("neg", (self,))

    # --------------------------------------------------------- linear alg
    def mm(self, rhs):
        return _apply("mm", (self, self._peer(rhs)))

    def mm_t(self, rhs):
        return _apply("mm_t", (self, self._peer(rhs)))

    def mv(self, rhs):
        return _apply("mv", (self, self._peer(rhs)))

    def vm(self, rhs):
        return _apply("vm", (self, self._peer(rhs)))

    def vv(self, rhs):
        return _apply("vv", (self, self._peer(rhs)))

    def matmul(self, rhs):
        """Batched matmul: self (..., K) @ rhs (K, N)."""
        return _apply("matmul", (self, self._peer(rhs, self.dtype)))

    # --------------------------------------------------------- elementwise
    def pow(self, exp: int):
        return _apply("pow", (self,), (int(exp),))

    def sqrt(self):
        return _apply("sqrt", (self,))

    def relu(self):
        return _apply("relu", (self,))

    def leaky_relu(self):
        return _apply("leaky_relu", (self,))

    def softplus(self):
        return _apply("softplus", (self,))

    def sigmoid(self):
        return _apply("sigmoid", (self,))

    def tanh(self):
        return _apply("tanh", (self,))

    def ln(self):
        return _apply("ln", (self,))

    def exp(self):
        return _apply("exp", (self,))

    def softmax(self, axis: int):
        return _apply("softmax", (self,), (int(axis),))

    def log_softmax(self, axis: int):
        return _apply("log_softmax", (self,), (int(axis),))

    # ----------------------------------------------------------- reduction
    def sum(self, axis: int = None):  # noqa: RUF013
        """Full reduction to a scalar; `axis=` reduces one axis, keepdims."""
        if axis is None:
            return _apply("sum", (self,))
        return _apply("sum_axis", (self,), (int(axis),))

    def mean(self, axis: int = None):  # noqa: RUF013
        if axis is None:
            return _apply("mean", (self,))
        return _apply("mean_axis", (self,), (int(axis),))

    # --------------------------------------------------------------- shape
    def t(self):
        return _apply("t", (self,))

    def unsqueeze(self, axis: int):
        return _apply("unsqueeze", (self,), (int(axis),))

    def reshape(self, shape):
        shape = _int_tuple(shape)
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            total = int(np.prod(self.shape))
            shape = tuple(total // known if s == -1 else s for s in shape)
        return _apply("reshape", (self,), (shape,))

    def flatten(self):
        """(N, ...) -> (N, prod(...))."""
        return self.reshape((self.shape[0], -1))

    def embed(self, ids):
        """Token-table lookup: self is the (V, D) table, `ids` float class
        indices."""
        return _apply("embedding", (self, self._peer(ids)))

    def chunks(self, chunk_size) -> List["Var"]:
        """Split into equal chunks of shape `chunk_size`; partial edge
        chunks are dropped."""
        cs = _int_tuple(chunk_size)
        if len(cs) != self.ndim:
            raise ValueError("chunk_size rank must match variable rank")
        grid = [d // c for d, c in zip(self.shape, cs)]
        out = []
        for idx in itertools.product(*(range(g) for g in grid)):
            starts = tuple(i * c for i, c in zip(idx, cs))
            out.append(_apply("chunk", (self,), (starts, cs)))
        return out

    def cat(self, variables: Sequence["Var"], axis: int):
        """n-ary concatenation."""
        return _apply("multi_cat", (self, *variables), (int(axis),))

    def stack(self, variables: Sequence["Var"], axis: int):
        return _apply("multi_stack", (self, *variables), (int(axis),))

    # ------------------------------------------------------------- pooling
    def max_pool(self, window, stride=None):
        w = _int_tuple(window)
        s = w if stride is None else _int_tuple(stride)
        return _apply("max_pool", (self,), (w, s))

    def avg_pool(self, window, stride=None):
        w = _int_tuple(window)
        s = w if stride is None else _int_tuple(stride)
        return _apply("avg_pool", (self,), (w, s))

    def astype(self, dtype):
        """Dtype cast ("float32", "bfloat16" or a torch dtype). The VJP
        casts the cotangent back to this variable's dtype."""
        return _apply("astype", (self,), (dtype_name(as_dtype(dtype)),))

    # ----------------------------------------------------------- attention
    def flash_attention(self, n_head: int, n_kv_head: int = 0,
                        causal: bool = True, dropout: float = 0.0,
                        status: StatusCell = None, block: int = 512):  # noqa: RUF013
        """Fused multi-head attention on the packed group-major qkv
        projection `self` (B, S, (H + 2 KV) hd) -> (B, S, H hd) head-major.
        On the card: the flash kernels (K1 with fast softmax, the fused K2
        backward, attention dropout inside both) where they take the input,
        f32 or bf16 at head dim 64 or 128 with at most 8 query heads per kv
        head; elsewhere, and on the CPU, the same math as a composite,
        which draws the kernels' dropout mask. Dropout is status-gated like
        `Var.dropout`."""
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"dropout probability has to be between 0 and "
                             f"1, but got {dropout}")
        if dropout > 0.0 and status is None:
            raise ValueError(
                "attention dropout requires a StatusCell (train/eval switch)")
        if self.ndim != 3:
            raise ValueError(
                "flash_attention expects a packed (B, S, W) qkv tensor")
        return _apply("flash_attention", (self,),
                      (int(n_head), int(n_kv_head), bool(causal),
                       float(dropout), int(block)), status=status)

    # ------------------------------------------------------------- dropout
    def dropout(self, p: float, status: StatusCell):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability has to be between 0 and "
                             f"1, but got {p}")
        return _apply("dropout", (self,), (float(p),), status=status)

    # ----------------------------------------------------------------- pad
    def pad(self, padding, mode):
        return _apply("pad", (self,), (_int_tuple(padding), mode.name,
                                       mode.value))

    # ---------------------------------------------------------- convolution
    def convolution(self, input, stride, dilation, groups: int = 1):
        """n-d convolution; the receiver is the KERNEL (Co, Ci/groups, *k)
        and the argument the input (N, Ci, *spatial), VALID. The arguments
        are checked as the reference checks them."""
        stride_t, dil_t = _int_tuple(stride), _int_tuple(dilation)
        inp = self._peer(input)
        nd = inp.ndim - 2
        if len(stride_t) == 1 and nd > 1:
            stride_t = stride_t * nd
        if len(dil_t) == 1 and nd > 1:
            dil_t = dil_t * nd
        _check_conv_args(self.shape, inp.shape, stride_t, dil_t, int(groups))
        return _apply("convolution", (self, inp),
                      (stride_t, dil_t, int(groups)))

    # -------------------------------------------------------------- losses
    def mae(self, target, reduction: str = Reduction.Mean):
        return _apply("mae", (self, self._peer(target)), (reduction,))

    def mse(self, target, reduction: str = Reduction.Mean):
        return _apply("mse", (self, self._peer(target)), (reduction,))

    def bce(self, target, reduction: str = Reduction.Mean):
        return _apply("bce", (self, self._peer(target)), (reduction,))

    def bce_with_logits(self, target, reduction: str = Reduction.Mean):
        return _apply("bce_with_logits", (self, self._peer(target)),
                      (reduction,))

    def kldiv(self, target, reduction: str = Reduction.Mean):
        return _apply("kldiv", (self, self._peer(target)), (reduction,))

    def nll(self, target, reduction: str = Reduction.Mean):
        return _apply("nll", (self, self._peer(target)), (reduction,))

    # ---------------------------------------------------------------- repr
    def __repr__(self) -> str:
        return f"Var(shape={self.shape}, op={self.node.op})\n{self.data()}"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A writable numpy copy (bf16 widened to f32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


class _MutGuard:
    """Context manager behind `data_mut()`: yields a writable numpy array
    and writes it back into the node on exit."""

    def __init__(self, node: Node) -> None:
        self._node = node
        self._arr = None

    def __enter__(self):
        self._arr = _to_numpy(self._node.get_value())
        return self._arr

    def __exit__(self, *exc):
        self._node.value = _tensor(self._arr, self._node.dtype,
                                   self._node.device)
        self._node.computed = True
        return False


class VarDiff(Var):
    """Differentiable variable: `Var`'s ops plus the gradient API."""

    __slots__ = ()

    def grad(self) -> torch.Tensor:
        """Accumulated gradient (zeros before the first backward); a
        sharded gradient is read whole, the same on every rank."""
        return sharded.whole(self.node.get_grad())

    def grad_mut(self):
        node = self.node

        class _GradGuard:
            def __enter__(self_inner):
                self_inner._arr = _to_numpy(node.get_grad())
                return self_inner._arr

            def __exit__(self_inner, *exc):
                node.grad = _tensor(self_inner._arr, node.dtype, node.device)
                return False

        return _GradGuard()

    def zero_grad(self) -> None:
        """Reset THIS variable's gradient (not the whole tape)."""
        self.node.zero_grad()

    def no_grad(self) -> None:
        """Drop the gradients of self and its interior ancestors; leaf
        gradients are untouched, and on a leaf this is a no-op."""
        tape, _ = executor._plan(self.node)
        for n in tape:
            if n.differentiable:
                n.no_grad()

    def with_grad(self) -> None:
        """Re-allocate (zeroed) interior gradients after `no_grad`."""
        tape, _ = executor._plan(self.node)
        for n in tape:
            if n.differentiable:
                n.with_grad()

    def backward(self, seed: float) -> None:
        """Seed the root gradient and replay VJPs in reverse topological
        order, accumulating into every differentiable node. Gradients
        accumulate across calls until `zero_grad()`."""
        executor.backward(self.node, float(seed))

    def __repr__(self) -> str:
        return f"VarDiff(shape={self.shape}, op={self.node.op})\n{self.data()}"


# --------------------------------------------------------------------------
# conv argument validation (the reference's check_conv_args panics)


def _check_conv_args(kernel_shape, input_shape, stride, dilation, groups):
    nd = len(input_shape) - 2
    if nd < 1:
        raise ValueError("convolution input must have at least 3 dimensions")
    if len(kernel_shape) != len(input_shape):
        raise ValueError(
            "the kernel and the input must have the same number of dimensions")
    if len(stride) != nd:
        raise ValueError("the stride length must match the spatial rank")
    if len(dilation) != nd:
        raise ValueError("the dilation length must match the spatial rank")
    if any(s < 1 for s in stride) or any(d < 1 for d in dilation):
        raise ValueError("stride and dilation must be positive")
    in_ch, k_in = input_shape[1], kernel_shape[1]
    out_ch = kernel_shape[0]
    if groups < 1:
        raise ValueError("groups must be positive")
    if in_ch % groups != 0 or out_ch % groups != 0:
        raise ValueError(
            "both the input and kernel channels must be divisible by groups")
    if k_in != in_ch // groups:
        raise ValueError(
            f"kernel input channels ({k_in}) must equal input channels / "
            f"groups ({in_ch} / {groups})")
    for i, (inp_d, k_d, d) in enumerate(
            zip(input_shape[2:], kernel_shape[2:], dilation)):
        if inp_d < d * (k_d - 1) + 1:
            raise ValueError(
                f"spatial dimension {i} is too small for the dilated kernel")
