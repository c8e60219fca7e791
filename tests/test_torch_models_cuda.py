"""The model families on the card (`cuda` marker; skips without a CUDA GPU
and nvcc): `chip_smoke.py` phase 17. BERT-base MLM and a classifier step
(K1, K2a, K2b without a causal mask), t5-base's widths (K1/K2 in the
encoder, K5-K7 in the decoder's causal self-attention and its
cross-attention at Sq != Skv) and greedy generation, ViT-B/16, the Switch
MoE GPT at phase 6's width (its three dispatches against each other, its
decode logits, `generate` against `PagedBatcher(kernel="on")`), LoRA and
QLoRA at the headline (the base bit for bit the same), the kernel routes
against the plain routes on the CPU, and the resnet_cifar twin (K12,
K13); every launch count held exact. This file imports no JAX."""

import gc
import os
import sys

import pytest
import torch

import neuronika_tpu_torch as nk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = nk.config.device
    nk.config.device = "cuda"
    yield torch.device("cuda")
    nk.config.device = old


@pytest.mark.cuda
def test_model_families_on_the_card(cuda):
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from neuronika_tpu_torch.models import resnet as R
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import conv as C
    from neuronika_tpu_torch.ops import cross_entropy as CE
    from neuronika_tpu_torch.ops import flash_attention as FA
    from neuronika_tpu_torch.ops import paged_attention as PA
    from neuronika_tpu_torch.serving import PagedBatcher

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    # the MoE GPT peaks at ~30 GiB; JAX, imported by other test files,
    # takes 75% of the card at its first use unless
    # XLA_PYTHON_CLIENT_PREALLOCATE=false
    assert free >= 40, (f"{free:.1f} GiB free on the card; run the card "
                        f"tests with XLA_PYTHON_CLIENT_PREALLOCATE=false")
    launches = CS.phase_models(T, FA, CE, PA, C, R, PagedBatcher)
    for name in ("flash_fwd_qkv", "flash_bwd_dq_qkv", "flash_bwd_dkv_qkv",
                 "flash_bwd_fused_qkv", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv", "paged_attention", "conv2d_direct_nhwc",
                 "conv2d_dw_nhwc"):
        assert launches[name] > 0, name
