"""The language-model loop on the card (`cuda` marker; skips without a CUDA
GPU and nvcc): a checkpoint round trip of a bf16 train state placed back
on the card, dense generation's decode position kept on the device, and
`chip_smoke.py` phase 16: `Trainer` at the headline configuration (its
first loss equal to `make_train_step`'s, K1 and the fused K2 launches
exact, a resume giving the same losses bit for bit), dense generation at
phase 4's width (greedy tokens the same across `generate`,
`make_generate` and one-beam search in bf16, and the same as
`PagedBatcher(kernel="on")` in f32) and the text-pipeline and GPT example
twins. This file imports no JAX."""

import gc
import os
import sys

import numpy as np
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
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from neuronika_tpu_torch.utils import Checkpointer

    g = torch.Generator("cuda").manual_seed(0)
    state = {"w": torch.randn(8, 4, device="cuda").bfloat16(),
             "step": torch.tensor(3, dtype=torch.int32),
             "gen": g.get_state()}
    with Checkpointer(str(tmp_path)) as ck:
        ck.save(3, state)
        state["w"].add_(1.0)                 # after the snapshot
        got = ck.restore(like=state)
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"] + 1.0, state["w"])
    assert torch.equal(got["gen"], g.get_state())


@pytest.mark.cuda
def test_decode_position_stays_on_the_card(cuda):
    from neuronika_tpu_torch.models import transformer as T

    cfg = T.GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=128,
                      d_ff=256, max_seq=32, dtype=torch.bfloat16)
    params = T.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                           "cuda")
    cache = T.init_kv_cache(cfg, 2)
    assert cache["pos"].device.type == "cuda"
    prompt = torch.randint(0, 64, (2, 5), device="cuda")
    logits, cache = T.make_prefill(cfg)(params, cache, prompt)
    step = T.make_decode_step(cfg)
    for _ in range(3):
        logits, cache = step(params, cache, logits.argmax(-1))
    assert int(cache["pos"]) == 8 and cache["pos"].device.type == "cuda"
    out = T.make_generate(cfg, 6)(params, prompt.cpu().numpy())
    assert out.device.type == "cuda"
    np.testing.assert_array_equal(
        out.cpu().numpy(), T.generate(params, cfg, prompt, 6))


@pytest.mark.cuda
def test_language_model_loop_on_the_card(cuda):
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE
    from neuronika_tpu_torch.ops import flash_attention as FA
    from neuronika_tpu_torch.ops import paged_attention as PA
    from neuronika_tpu_torch.serving import PagedBatcher

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    # the Trainer at the headline peaks at ~27 GiB; JAX, imported by other
    # test files, takes 75% of the card at its first use unless
    # XLA_PYTHON_CLIENT_PREALLOCATE=false
    assert free >= 32, (f"{free:.1f} GiB free on the card; run the card "
                        f"tests with XLA_PYTHON_CLIENT_PREALLOCATE=false")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 16384, size=n, dtype=np.int32)
               for n in (32, 64, 128, 64)]
    flash, k11 = CS.phase_lm_loop(T, FA, CE, PA, PagedBatcher, prompts,
                                  float("nan"))
    assert flash["flash_fwd_qkv"] > 0 and flash["flash_bwd_fused_qkv"] > 0
    assert k11 > 0
