"""K3: the define-by-run tier's GEMM (counterpart of
`neuronika_tpu/ops/pallas/matmul.py`).

`matmul(a, b)` computes a (M, K) @ b (K, N) -> (M, N) in a's dtype with
f32 accumulation; mixed operands are promoted first, as `jnp.dot` would.
For CUDA tensors it launches the hand-written kernel of `csrc/matmul.cu`
(wgmma and TMA; f32 by 3xTF32, bf16 directly), which masks ragged shapes
itself; the wrapper hands it scratch for K-major copies of the operands it
cannot read in place and, for products whose tiles do not fill the SMs,
for split-K partial sums. Any other tensor (CPU, or "meta" during shape
inference) takes `matmul_reference`, the plain version.
"""

from __future__ import annotations

import functools

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128                 # rows and columns of C per CTA
_STAGE_K = {torch.float32: 32, torch.bfloat16: 64}   # k per 128-byte row
_MIN_SPLIT_STEPS = 4        # k steps a split-K slice keeps at least
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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M, N, K, dtype, sms):
    """How many slices of K the kernel sums apart: 1 when the 128 x 128
    tiles of C fill the SMs, else as many as fit in one wave of them, each
    keeping at least 4 k steps."""
    tiles = -(-M // _TILE) * -(-N // _TILE)
    steps = -(-K // _STAGE_K[dtype])
    if tiles >= sms:
        return 1
    return max(1, min(sms // tiles, steps // _MIN_SPLIT_STEPS))


def _in_place(t, row_stride, k_stride, rows, K):
    """Whether the bf16 kernel's TMA reads operand t as it lies: K-major,
    16-byte aligned base and row stride."""
    return (t.dtype == torch.bfloat16 and k_stride == 1 and rows > 1
            and row_stride >= K and row_stride % 8 == 0
            and t.data_ptr() % 16 == 0)


def matmul(a, b, *, bm: int = 512, bn: int = 1024, bk: int = 512):
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype, f32 accumulation. For
    CUDA tensors: the K3 kernel, adding one to `matmul.launches` (an empty
    contraction, K 0, is zeros without a launch); for any other tensor,
    `matmul_reference`. `bm`/`bn`/`bk` size the TPU's VMEM blocks in the
    JAX function; they are accepted and ignored (the kernel uses 128 x 128
    tiles)."""
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
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"shape ({M}, {K}) @ ({K}, {N}) exceeds the "
                         f"kernel's grid")
    if K == 0:
        return torch.zeros((M, N), dtype=a.dtype, device=a.device)
    a2, b2 = a.to(ct), b.to(ct)
    (sam, sak), (sbk, sbn) = a2.stride(), b2.stride()
    c = torch.empty((M, N), dtype=ct, device=a.device)
    from .._build import load_library

    with torch.cuda.device(a.device):
        splits = split_k(M, N, K, ct, _sm_count(torch.cuda.current_device()))
        # one scratch buffer: the K-major copies of the operands the kernel
        # cannot read in place, then the split-K partial sums
        copy = (2 if ct == torch.float32 else 1) * -(-K // _STAGE_K[ct]) \
            * _STAGE_K[ct] * c.element_size()
        n_a = 0 if _in_place(a2, sam, sak, M, K) else M * copy
        n_b = 0 if _in_place(b2, sbn, sbk, N, K) else N * copy
        n_ws = 4 * splits * M * N if splits > 1 else 0
        base = 0
        if n_a + n_b + n_ws:
            scratch = torch.empty(n_a + n_b + n_ws, dtype=torch.uint8,
                                  device=a.device)
            base = scratch.data_ptr()
        err = load_library().nk_matmul(
            _DTYPES[ct], a2.data_ptr(), b2.data_ptr(), c.data_ptr(), M, N, K,
            sam, sak, sbk, sbn, base if n_a else None,
            base + n_a if n_b else None, base + n_a + n_b if n_ws else None,
            splits, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err}")
    matmul.launches += 1
    return c if ct == a.dtype else c.to(a.dtype)


matmul.launches = 0
