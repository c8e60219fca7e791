"""The quintic Newton-Schulz iteration of Muon (counterpart of
`neuronika_tpu/optim/functional.py::_newton_schulz5`)."""

from __future__ import annotations

import torch


def newton_schulz5(m: torch.Tensor, steps: int = 5,
                   eps: float = 1e-7) -> torch.Tensor:
    """Drive the singular values of `m` (..., r, c) toward 1: Frobenius
    normalisation, then `steps` matmul-only iterations with Jordan et al.
    2024's coefficients, on the wide orientation of the matrix."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = m.shape[-2] > m.shape[-1]
    x = m.mT if transpose else m
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        xxt = torch.matmul(x, x.mT)
        x = a * x + torch.matmul(b * xxt + c * torch.matmul(xxt, xxt), x)
    return x.mT if transpose else x
