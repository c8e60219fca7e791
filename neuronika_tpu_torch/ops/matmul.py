"""K3: the define-by-run tier's GEMM (counterpart of
`neuronika_tpu/ops/pallas/matmul.py`).

`matmul(a, b)` computes a (M, K) @ b (K, N) -> (M, N) in a's dtype with
f32 accumulation; mixed operands are promoted first, as `jnp.dot` would.
For CUDA tensors it launches the hand-written kernel of `csrc/matmul.cu`
(FFMA for f32, mma.sync for bf16), which reads each operand through its
own row and column strides, so transposed views need no copy, and masks
ragged shapes itself. Any other tensor (CPU, or "meta" during shape
inference) takes `matmul_reference`, the plain version.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128                 # rows and columns of C per CTA
_MAX_GRID_Y = 65535
_INT_MAX = 2 ** 31 - 1


def _shapes(a, b):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul expects 2-d operands, got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return M, K, N


def matmul_reference(a, b):
    """Plain version of K3: the product of the promoted operands widened
    to f32, rounded once to a's dtype. Runs on any device."""
    _shapes(a, b)
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.mm(a.to(ct).float(), b.to(ct).float()).to(a.dtype)


def matmul(a, b, *, bm: int = 512, bn: int = 1024, bk: int = 512):
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype, f32 accumulation. For
    CUDA tensors: the K3 kernel, adding one to `matmul.launches`; for any
    other tensor, `matmul_reference`. `bm`/`bn`/`bk` size the TPU's VMEM
    blocks in the JAX function; they are accepted and ignored (the kernel
    uses 128 x 128 tiles)."""
    del bm, bn, bk
    M, K, N = _shapes(a, b)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type != "cuda":
        return matmul_reference(a, b)
    ct = torch.promote_types(a.dtype, b.dtype)
    if ct not in _DTYPES:
        raise TypeError(f"matmul kernel takes {', '.join(map(str, _DTYPES))}"
                        f", not {ct}")
    if M < 1 or N < 1:
        raise ValueError(f"empty product {M} x {N}")
    if max(M, N, K) > _INT_MAX or -(-M // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"shape ({M}, {K}) @ ({K}, {N}) exceeds the "
                         f"kernel's grid")
    a2, b2 = a.to(ct), b.to(ct)
    c = torch.empty((M, N), dtype=ct, device=a.device)
    from .._build import load_library

    with torch.cuda.device(a.device):
        err = load_library().nk_matmul(
            _DTYPES[ct], a2.data_ptr(), b2.data_ptr(), c.data_ptr(), M, N, K,
            *a2.stride(), *b2.stride(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err}")
    matmul.launches += 1
    return c if ct == a.dtype else c.to(a.dtype)


matmul.launches = 0
