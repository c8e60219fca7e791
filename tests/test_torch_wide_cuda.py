"""The attention kernels at every head dim and group size on the card
(`cuda` marker; skips without a CUDA GPU and nvcc): the port's GPT with
flash "on" at hd 80 under rope and a window (K5-K7) and at 16 query heads
over one kv head (K1/K2) gives the loss and gradients of flash "off" in
f32, under remat policy "flash" with K5 launched once a layer; K1, K2a,
K2b and the fused K2 in bf16 past 8 query heads a kv head (G 9, 12, 16,
32; hd 64 and 128) against their plain versions on the Hopper route, K2b
and the fused K2 on their cluster walks; then `chip_smoke.py` phase 19's
kernel checks. This file imports no JAX."""

import dataclasses
import os
import sys

import pytest
import torch

from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.ops import flash_attention as FA
from neuronika_tpu_torch.ops import paged_attention as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, GRAD_TOL = 1e-5, 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(cfg, params, toks):
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten(params, leaves), toks,
                     toks.roll(-1, 1), cfg, train=True)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("make, kw, kernel", [
    (T.llama_config, dict(n_head=2, n_kv_head=1, d_model=160, window=24),
     "flash_fwd"),
    (T.GPTConfig, dict(n_head=16, n_kv_head=1, d_model=256),
     "flash_fwd_qkv")], ids=["rope-hd80-window", "learned-g16"])
def test_kernel_route_matches_plain_route(cuda, make, kw, kernel):
    cfg = make(vocab_size=128, n_layer=2, d_ff=256, max_seq=64,
               dtype=torch.float32, remat_policy="flash", **kw)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    toks = torch.randint(0, 128, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    fwd = getattr(FA, kernel)
    before = fwd.launches
    on = _run(dataclasses.replace(cfg, flash="on"), params, toks)
    torch.cuda.synchronize()
    assert fwd.launches - before == cfg.n_layer
    off = _run(dataclasses.replace(cfg, flash="off"), params, toks)
    assert abs(float(on[0]) - float(off[0])) <= TOL
    assert max(float((a - b).abs().max())
               for a, b in zip(on[1], off[1])) <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [257, 384])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [9, 12, 16, 32])
def test_hopper_route_past_8_heads_matches_plain(cuda, G, hd, S, causal,
                                                 rate):
    """K1, K2a, K2b and the fused K2 against the plain versions at phase
    3's bf16 bounds (chip_smoke.check_flash: per entry and in norm), all on
    the Hopper kernels, K2b on dkv_cluster's cluster and the fused K2 on
    fused_cluster's; two launches of each of those two must give the same
    bits."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke

    KV = 2 if G <= 12 else 1
    H = G * KV
    qkv, do = chip_smoke.flash_case(np.random.default_rng(G * hd + S), 2, H,
                                    KV, hd, S, torch.bfloat16)
    _, (out, lse), _ = chip_smoke.check_flash(
        FA, f"G{G}-hd{hd}-S{S}", qkv, do, H, KV, causal, False, seed=7,
        rate=rate)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    C = FA.dkv_cluster(2, KV, S, G, sms)
    Cf = FA.fused_cluster(2, KV, S, G, sms)
    assert FA.flash_fwd_qkv.route == FA.flash_bwd_dq_qkv.route == "sm90"
    assert FA.flash_bwd_dkv_qkv.route == f"sm90 cluster {C}" and C > 1
    assert FA.flash_bwd_fused_qkv.route == f"sm90 cluster {Cf}" and Cf > 1
    again = [FA.flash_bwd_dkv_qkv(qkv, out, lse, do, torch.zeros_like(qkv),
                                  H, KV, causal, seed=7, rate=rate)
             for _ in range(2)]
    assert torch.equal(*again)
    again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV, causal, seed=7,
                                    rate=rate) for _ in range(2)]
    assert torch.equal(*again)


@pytest.mark.cuda
def test_chip_smoke_phase_19_kernels(cuda):
    sys.path.insert(0, ROOT)
    import chip_smoke

    errs, times = chip_smoke.phase_wide_kernels(FA, PA)
    assert set(times) == {"starcoder", "phi3", "paged"}
    assert errs["paged_attention"] <= chip_smoke.BF16_TOL
