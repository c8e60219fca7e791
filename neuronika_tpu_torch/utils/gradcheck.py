"""Finite-difference gradient checking (counterpart of
`neuronika_tpu/utils/gradcheck.py`), over the port's factories: the leaves
go to `config.device`."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["gradcheck"]


def gradcheck(build: Callable[..., "object"], inputs: Sequence[np.ndarray],
              eps: float = 1e-3, atol: float = 1e-2,
              rtol: float = 1e-2) -> bool:
    """Check the tape's backward against central finite differences.

    `build(*vardiffs)` must return a scalar-output variable built from the
    given differentiable leaves. Raises AssertionError on mismatch.
    """
    import neuronika_tpu_torch as nk
    from ..variable import _to_numpy

    leaves = [nk.from_ndarray(a).requires_grad() for a in inputs]
    root = build(*leaves)
    root.forward()
    root.backward(1.0)
    analytic = [_to_numpy(l.grad()) for l in leaves]

    def eval_at(arrays):
        r = build(*[nk.from_ndarray(a) for a in arrays])
        r.forward()
        return r.item()

    for idx, base in enumerate(inputs):
        num = np.zeros_like(base, dtype=np.float64)
        for j in range(base.size):
            # copy every input (np.ascontiguousarray would alias) and index
            # by unravel_index, so the bump never lands in a temporary
            pos = np.unravel_index(j, base.shape)
            bumped = [np.array(a, order="C", copy=True) for a in inputs]
            bumped[idx][pos] = base[pos] + eps
            up = eval_at(bumped)
            bumped[idx][pos] = base[pos] - eps
            down = eval_at(bumped)
            num[pos] = (up - down) / (2 * eps)
        np.testing.assert_allclose(analytic[idx], num, rtol=rtol, atol=atol,
                                   err_msg=f"gradcheck failed for input "
                                           f"{idx}")
    return True
