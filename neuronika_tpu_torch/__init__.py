"""neuronika_tpu_torch: the PyTorch and CUDA port of neuronika_tpu.

The JAX package `neuronika_tpu` stays the reference; this package mirrors
its module names (`models/transformer.py`, `serving.py`,
`ops/paged_attention.py`, `device.py`, `_build.py`) so that each function
has a counterpart to be held against. It imports torch and never jax.
Hand-written CUDA kernels live in `csrc/` and are compiled with nvcc at
their first launch, never at import (see `_build.py`).

Ported so far: paged GPT serving (`serving.PagedBatcher`) with the
paged-attention decode kernel, and the GPT training step
(`models.transformer.make_train_step`, `optim.functional`) with the
packed-qkv flash-attention forward and backward kernels.
"""

__version__ = "0.1.0"
