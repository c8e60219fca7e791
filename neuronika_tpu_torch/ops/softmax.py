"""K4: row softmax and log-softmax over the last axis (counterpart of
`neuronika_tpu/ops/pallas/softmax.py`).

`softmax_last_axis(x, log=...)` normalises the last axis of a tensor of
any rank: m = max, s = sum exp(x - m), then exp(x - m) / s or
x - m - log s, in f32, written in x's dtype. For CUDA tensors it launches
the hand-written kernel of `csrc/softmax.cu` (one CTA per row); any other
tensor (CPU, or "meta" during shape inference) takes
`softmax_last_axis_reference`, the plain version.
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def softmax_last_axis_reference(x, *, log: bool = False):
    """Plain version of K4, the kernel's math in f32. Runs on any
    device."""
    x32 = x.float()
    m = x32.amax(-1, keepdim=True)
    e = torch.exp(x32 - m)
    s = e.sum(-1, keepdim=True)
    out = x32 - m - torch.log(s) if log else e / s
    return out.to(x.dtype)


def softmax_last_axis(x, *, log: bool = False, block_rows: int = 256):
    """Softmax (or log-softmax) over the last axis. For CUDA tensors: the K4
    kernel, adding one to `softmax_last_axis.launches`; for any other
    tensor, `softmax_last_axis_reference`. `block_rows` sizes the TPU's
    row block in the JAX function; it is accepted and ignored (the kernel
    runs one CTA per row)."""
    del block_rows
    if x.dim() < 1:
        raise ValueError("softmax over the last axis needs rank >= 1")
    if x.device.type != "cuda":
        return softmax_last_axis_reference(x, log=log)
    if x.dtype not in _DTYPES:
        raise TypeError(f"softmax kernel takes "
                        f"{', '.join(map(str, _DTYPES))}, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("softmax kernel needs a contiguous tensor")
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    if rows < 1 or cols < 1 or rows > _INT_MAX or cols > _INT_MAX:
        raise ValueError(f"softmax kernel: {rows} rows of {cols} columns")
    y = torch.empty_like(x)
    from .._build import load_library

    with torch.cuda.device(x.device):
        err = load_library().nk_softmax(
            _DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), rows, cols,
            int(log), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"softmax kernel launch failed: cudaError {err}")
    softmax_last_axis.launches += 1
    return y


softmax_last_axis.launches = 0
