"""The rest of serving on the card (`cuda` marker; skips without a CUDA GPU
and nvcc): the port's batchers on the card, decoding through the paged
attention kernel (K11, kernel="on"), give the greedy tokens of the same
batchers on the CPU (the kernel's plain version) in f32, with int8 and
int4 weights, chunked, bucketed and grouped prefill, a prefix, multi-step
windows and adapters, and K11 runs n_layer times a decode step; then
`chip_smoke.py` phase 18 at phase 4's width. This file imports no JAX."""

import gc
import os
import sys

import numpy as np
import pytest
import torch

from neuronika_tpu_torch import serving as S
from neuronika_tpu_torch.models import lora as LR
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.ops import paged_attention as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# head dim 128, two q heads a kv head: a shape the kernel takes
CFG = T.GPTConfig(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=512, d_ff=256, max_seq=96, dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _serve(device, params, kw, prefix=None, adapters=(), multi_step=4):
    b = S.PagedBatcher(params, CFG, n_slots=3, n_blocks=48, block_size=8,
                       kernel="on" if device.type == "cuda" else "auto",
                       device=device, **kw)
    for ad in adapters:
        b.register_adapter(ad)
    if prefix is not None:
        b.register_prefix(prefix)
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([prefix, rng.integers(1, 64, 5)])
               if prefix is not None and i % 2 else
               rng.integers(1, 64, int(rng.integers(3, 30)))
               for i in range(6)]
    steps = [0]
    step, many = b._step, b._many_prog

    def counted_step(*a):
        steps[0] += 1
        return step(*a)

    def counted_many(k):
        fn = many(k)

        def run(*a):
            steps[0] += k
            return fn(*a)
        return run

    b._step, b._many_prog = counted_step, counted_many
    before = PA.paged_attention.launches
    with b.defer_admission():
        rids = [b.submit(p.astype(np.int32), 10,
                         adapter=(i % (len(adapters) + 1)))
                for i, p in enumerate(prompts)]
    done = b.run(multi_step=multi_step)
    return ([done[r] for r in rids], PA.paged_attention.launches - before,
            steps[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(quant="int4"),
                                dict(prefill_chunk=8, prefill_bucket="pow2"),
                                dict(adapters=2)],
                         ids=["int8", "int4", "chunk-bucket-prefix",
                              "adapters"])
def test_card_batcher_matches_cpu(cuda, kw):
    params = T.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    kw = dict(kw)
    ads = []
    for seed in range(kw.pop("adapters", 0)):
        ad = LR.lora_init(torch.Generator().manual_seed(seed + 1), params, 4)
        for ab in ad.values():
            ab["B"] = 0.05 * torch.randn(ab["B"].shape)
        ads.append(ad)
    prefix = (np.arange(1, 17, dtype=np.int32) if "prefill_chunk" in kw
              else None)
    cpu, _, _ = _serve(torch.device("cpu"), params, kw, prefix, ads)
    card, launches, steps = _serve(cuda, params, kw, prefix, ads)
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)
    assert launches == CFG.n_layer * steps > 0


@pytest.mark.cuda
def test_phase_18_on_the_card(cuda):
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from neuronika_tpu_torch import _build

    _build.load_library()
    gc.collect()
    torch.cuda.empty_cache()
    smi = torch.cuda.get_device_name(0)
    assert CS.phase_serving_rest(T, PA, S, LR, smi, n_req=16) > 0
