"""Smoke test of the PyTorch/CUDA port (neuronika_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile TABLE_PATH]

Runs from the root of a checkout, on a machine with one CUDA card, nvcc and
nvidia-smi. Phases, each printing one line or a few:
  1. environment: card, power limit, torch and CUDA versions; TF32 off;
  2. build: nvcc compiles the kernels from neuronika_tpu_torch/csrc/, one
     process per source;
  3. every kernel against its plain PyTorch version on the card, with
     error bounds and CUDA-event times: paged attention (K11, each
     sequence split over CTAs as paged_split_plan cuts it) at the serving
     path's shapes and at one long sequence (B1 KV12 MB512, pos 8191;
     also under a window across split boundaries), a planted fault (one
     split's partial dropped) read at both, two launches the same bits,
     and timed there and at phase 4's serving shape (8 live slots at
     contexts 33-192); flash attention forward (K1), the split
     backward pair (K2a, K2b) and the fused backward (K2c/K2d) over f32
     and bf16, causal and full, MHA and GQA, hd 128 and 64, fast and safe
     softmax and a ragged S, then checked and timed at the headline train
     step's shape (bf16 B16 S2048 H12 KV12 hd128, causal, fast softmax),
     where the kernels' errors are the ones the JSON line reports, two
     launches of the fused backward (and of K2a) must give the same bits
     (the fused backward in f32 too, at B2 S1000 H8 KV2), and each
     kernel's TFLOP/s is printed beside SDPA's, with the split pair as the
     backward runs it (one pre-pass for K2a and K2b); then attention
     dropout: every flash kernel (K1, K2a, K2b, the fused K2, K5, K6, K7)
     with in-kernel dropout against its plain twin, which draws the same
     keep mask (`keep_mask`), at rates 0.1 and 0.5 with two seeds each,
     over the flash cases above in f32 and bf16 and six of the split
     cases (windows, ragged S, Sq != Skv), at each case's bounds; K1's
     and K5's masks read back with q = 0 and a one-hot v and held equal to
     keep_mask bit for bit; and each kernel checked at rate 0.1 and timed
     with and without dropout at the table shapes (the JSON line's
     dropout_ms and dropout_max_abs_err);
  4. paged GPT serving end to end at full width (d1536, 8 layers, 12
     heads, d_ff 6144, vocab 16384, max_seq 1024, bf16, random weights
     from a seed): 16 greedy requests through PagedBatcher, with the
     kernels' launch counts read around the run;
  5. the same serving path in f32 with the kernel and with the plain
     gather path: the greedy tokens must be identical;
  6. the GPT train step at the same width, S 2048, batch 16, bf16, the
     headline configuration (no remat, fast softmax, fused backward, bf16
     Adam state, compute-dtype matmul outputs): 2 warm-up and 5 timed
     steps with a finite, falling loss and K1 and the fused backward
     launched once per layer and step; then 1 warm-up and 2 counted steps
     with the GPTConfig defaults (split backward, remat, f32 Adam state),
     which launch K2a and K2b once per layer and step; then the headline
     with fused_ce="on": 2 warm-up and 5 timed steps through the fused
     linear cross-entropy (K8 once a step, K9 and K10 once each in its
     backward, all three on the Hopper kernels of
     csrc/cross_entropy_sm90.cu, held exact), its step time, tokens/s, MFU
     and peak memory
     printed beside the composite headline's; and the headline at
     dropout=0.1 (GPT-2's attn_pdrop), 1 warm-up and 3 timed steps with a
     finite, falling loss and K1 and the fused K2 launched once per layer
     and step, its step time, tokens/s and peak beside the headline's;
  7. the kernel route against the plain route (flash="off") in f32 on a
     small hd-128 model: loss and every gradient leaf, split and fused,
     then at dropout=0.3 (the composite draws the kernels' mask) packed
     with both backwards and split (llama, GQA, a window); and the fused
     CE route (fused_ce "on" against "off", vocab 1024) for a tied GPT and
     an untied llama-style head;
  8. the define-by-run tier's flagship: `build_var_model_batched` at the
     same width (S 2048, B 16, bf16) with `enable_kernels(True)`, trained
     by `optim.Adam(1e-4).train_step` on the log-softmax + NLL loss: 1
     warm-up and 5 timed steps, K1, the fused K2 and K4 counted;
  9. the Var tier's 2-d model, `build_var_model` (d768, 8 layers, 6 heads,
     vocab 16384, S 1024, f32), with every `mm` on K3 and every softmax on
     K4: 1 warm-up and 5 timed steps, launches held exact;
 10. the Var tier's kernel route on the card against its plain route on
     the CPU, f32, small models: loss and every parameter gradient;
 11. the train step of Mistral 7B at its published widths (d4096, 32 heads
     over 8 kv heads, hd 128, d_ff 14336, vocab 32000, window 4096; Jiang
     et al. 2023, Table 1) cut from 32 to 4 layers, S 8192, batch 2, bf16,
     the GPTConfig defaults (remat "full", f32 Adam), random weights from a
     seed: 2 warm-up and 5 timed steps with a finite, falling loss and
     exactly 2 L launches of K5 (remat re-runs it), L of K6 and L of K7 a
     step; then one step at dropout=0.1 cut to 2 layers (K5-K7's dropout
     at full width), its launches held exact, beside the same step
     without dropout;
 12. the split kernel route against the plain route (flash="off") in f32
     on small llama and Mistral models (hd 128, GQA, window < S): loss and
     every gradient leaf;
 13. ResNet-18 training at its published widths (He et al. 2016, Table 1;
     GroupNorm for BatchNorm, imagenet stem, 1000 classes), bf16,
     conv_impl "pallas", 224x224 images at batch 64 from a seed, SGD with
     momentum 0.9 and lr 0.1: 2 warm-up and 5 timed steps with a finite,
     falling loss and K12 launched once a conv forward and once a stride-1
     conv's dx, K13 once a stride-1 conv's dw, every call but the stem's
     on the Hopper kernels of csrc/conv_sm90.cu (counts derived from the
     config); step time, images/s, conv MFU, peak memory. One more step
     records the operands of every K12 and K13 call at each distinct
     shape (forward, stride-1 dx, dw), and each is held against its plain
     version, bf16 per entry and in norm, with a planted fault in each
     kernel read at a ResNet-18 shape;
 14. the conv kernel routes against the plain routes in f32: a small
     ResNet of both stems on the card against the CPU (logits, loss, every
     gradient), a small Var graph of pooled 1-d, 2-d (stride, dilation,
     groups) and 3-d convolutions under use_kernels with conv_route
     "force" (K12, K14, K15) against the library route on the CPU, launch
     counts exact; the tier "auto" picks for bench.py's conv shapes; and
     bf16 Var 1-d and 3-d convs under "force" on the Hopper K14 and K15,
     their forwards held against their plain versions, the 1-d conv's
     gradients (the library's transposed convolutions) against the plain
     route's;
 15. the define-by-run layer kit (nn, optim, data, utils) on the card
     under use_kernels, launches held exact: the twins of the JAX
     package's quickstart (5 epochs, K3), MNIST CNN (MnistCNN at its class
     defaults, 28 x 28, batch 64, 3 epochs of 256, conv_route "force": K12,
     K3, K4; its step time and peak memory; then in eval mode the card's
     kernel route against the CPU's plain route, loss and every gradient)
     and char-RNN (LSTM and GRU cells, hidden 96, 30 steps over lengths
     8/12/16: K3, K4), the scan ops nn.LSTM and nn.GRU on the card against
     the CPU, and the reference's conv x optimizer sweep (a strided,
     dilated, grouped Conv1d on the library, a stride-1 Conv1d on K14 and
     a Conv3d on K15, each trained 8 steps by each of the ten optimizers;
     the losses fall and the card's kernels match the CPU's);
 16. the language-model loop: `train.Trainer` at phase 6's headline
     configuration (warmup-cosine lr, clipping, a JSONL log, eval and
     checkpoints every 2 steps in a temporary directory, 4 steps; its
     first loss equal to make_train_step's, K1 and the fused K2 counted
     exact, a fresh Trainer resumed from step 2 giving steps 3 and 4 the
     same losses bit for bit; its step, eval and checkpoint times beside
     phase 6's step); dense generation at phase 4's model (bf16 greedy
     tokens the same from generate, make_generate and one-beam search, f32
     greedy tokens of generate the same as PagedBatcher(kernel="on")'s on
     phase 5's requests, seeded top-k sampling repeatable and inside each
     step's top 50; tokens/s); and the twins of the JAX package's
     text_pipeline and gpt_train examples at their sizes (losses fall;
     gpt_train's K1/K2 launches exact);
 17. the other model families at published widths, bf16, 2 warm-up and 3
     timed steps each (step time, tokens or images a second, peak memory,
     launches derived from the config and held exact): BERT-base MLM
     (Devlin et al. 2019; B32 S512, f32 Adam, remat: K1 and K2 without a
     causal mask) and one classifier step; t5-base's widths (Raffel et al.
     2020) on this repo's encoder-decoder (source 512, target 128, B16:
     K1/K2 in the encoder, K5-K7 in the decoder's causal self-attention
     and its cross-attention at Sq 128, Skv 512) and greedy generation of
     8 tokens; ViT-B/16 (Dosovitskiy et al. 2021; 224x224, B64; plain
     PyTorch, no kernel); the Switch MoE GPT (Fedus et al. 2022: 8
     experts, sort dispatch, capacity 1.25, aux weight 0.01) at phase 6's
     width, B16 S2048, then in f32 on a small model its three dispatches
     against each other, their decode logits, and generate's greedy
     tokens against PagedBatcher(kernel="on") (K11); LoRA and QLoRA (rank
     8 on qkv and proj) at phase 6's headline, the base bit for bit the
     same, the adapters moved, the persistent state's bytes; the kernel
     routes on the card against the plain routes on the CPU (f32, small:
     a BERT, a T5 at Sq != Skv with its greedy tokens, an MoE GPT per
     dispatch) within phase 7's bounds; and the twin of the JAX package's
     resnet_cifar example at its size (bf16, conv_impl "pallas": K12 and
     K13 held exact);
 18. the rest of serving at phase 4's width (bf16, seeded random weights):
     the W8A8 product (torch._int_mm) with the int8 weight row- and
     column-major; 32 requests (prompts 64-700 tokens, half behind a
     256-token prefix, max_new 32-128, every 4th sampled) through
     PagedBatcher with kernel "on", prefill_chunk 256, pow2 buckets, the
     registered prefix, a deferred burst and run(multi_step=8), in bf16,
     int8 and int4 (tokens/s, TTFT, ITL, peak memory, decode-weight
     bytes, greedy agreement with bf16), K11 held to n_layer launches a
     decode step and each window to one device-to-host sync; the dense
     ContinuousBatcher in bf16 and int8-kv; two rank-8 S-LoRA adapters in
     a mixed batch; speculative decoding (gamma 4, the target as its own
     draft and its first two blocks as a draft); and f32 greedy tokens of
     every option (all at once, multi-step, grouped, prefix, chunked,
     bucketed) equal to the plain per-step PagedBatcher's, speculative
     equal to make_generate's;
 19. the attention kernels at every head dim (1-256) and group size that
     JAX's kernels take: K1, K2a+K2b and the fused K2 at hd 32, 36
     (unaligned rows), 72, 80, 96 and 256 and at G 16 (hd 128 and 96),
     K5-K7 at hd 32, 36, 72, 80, 96 and 256 (windows, full Sq != Skv,
     strided views), K11 at G 1-32 and hd 32-256, each in f32 and bf16
     (K1-K7 also at dropout 0.1) against its plain version at phase 3's
     bounds, then in bf16 K1, K2a+K2b and the fused K2 at G 9, 12 and 32
     (hd 64 and 128), the route each kernel took printed and held (K1 and
     K2a on the Hopper kernels, K2b on its cluster walk, the fused K2 on
     mma.sync), G 16's K2b, fused K2 and K11 twice for the same bits; each
     held against its plain version again and timed at the models'
     shapes beside it, SDPA (k and v repeated to H, or the band as a
     mask) and its bound; then the GPT train step at StarCoderBase-1B's
     published widths (bigcode/starcoderbase-1b: d2048 L24, 16 heads over
     1 kv head, d_ff 8192, V49152), full depth, S2048 B8 bf16, flash "on"
     and "auto" (K1 2 L, K2a and K2b L launches a step: remat "full"),
     its gradients through K1/K2a/K2b against the composite's, and both
     routes at a larger Adam rate (the rate's witness); llama_config at
     Phi-3-mini-4k's (microsoft/Phi-3-mini-4k-instruct: d3072, 32 heads,
     hd 96, d_ff 8192, V32064, window 2047) cut to 4 layers, S4096 B2,
     two timed steps under each remat policy ("full", "flash", "names",
     "dots", "flash_dots": K5 2 L a step under "full" and "dots", L under
     the others; losses within 2^-8 of "full"'s; step time and peak
     memory each); and PagedBatcher (kernel "on") serving 4 requests on
     both (K11 at G 16 hd 128 and at G 1 hd 96), with f32 greedy tokens
     at 4 layers equal to the gather path's.
Phase 3 also holds the matmul (K3) and row-softmax (K4) kernels against
their plain versions (ragged, transposed views, the 2-d model's forward
products and the VJP products of its LM head and MLP as the VJPs lay them
out, the flagship's (32768, 16384) log-softmax) and times them there; K3's
results must be the same bits over two launches, and its split-K products
(the projections, the LM head's dx, the MLP's dx, one head's P V) must
fail the bound with their last K slice dropped (a planted fault); and
the split-layout flash kernels (K5 forward, K6 dq, K7 dk/dv) against
their plain versions over f32 and bf16, causal, windows 1, 6, 100 and
>= S, windows on either side of the bf16 K6/K7's 64-row steps and
128-row CTAs (63, 64, 65, 127, 128, 129), full attention with Sq != Skv,
hd 64 and 128 and ragged S, then at B1 H8 S8192 hd128 window 4096 bf16,
where each is timed beside its plain version and SDPA (with the band as
a boolean mask), and at phase 11's shape (B2 H32 S8192), where they are
checked (the plain versions over 8 heads at a time), three planted faults
are read against the same bound and must fail it, two launches of K5, of
K6 and of K7 must give the same bits, and each is timed alone; the bf16
K5-K7 run the Hopper walks of csrc/flash_sm90.cuh. Their bf16 results are
also held in norm: ||kernel - plain|| <= 1e-2 ||plain|| + 2^-15
sqrt(numel), and so are K1's and K2's, with three planted faults (K1, K2a,
the fused K2) read at the headline shape. Phase 3 then holds the direct convolutions (K12 at strides
1-3, dilation, groups, a 7x7/2 conv on 3 channels and a 1x1/2 one; K13
with a split reduction; K14; a strided 1-d conv on K12; K15 with
dilation; in bf16 the Hopper K12 and K13 at ResNet-18's stage shapes, a
dx, tiles across samples, channel tails and non-square dilated taps, the
Hopper K14 with channel tails, dilation 2, tiles across samples, the
table's widths at batch 2 and (k - 1) d at the rank-3 corner range's
32768 (32769 runs csrc/conv.cu), and the Hopper K15 with ragged boxes,
channel tails, dilation 2 and (k - 1) d at the rank-5 corner range's 16
(18 runs csrc/conv.cu), each call's kernel counted against conv_route's
choice) against their plain
versions in f32 and bf16, and at bench.py's
conv shapes checks them on the Hopper kernels, reads two launches' bits
(the same) and a planted fault per kernel against the same
norm bound and times each beside its plain version and one library call
(F.conv2d, torch.nn.grad.conv2d_weight, F.conv1d, F.conv3d); and times
the conv route at batch 1, 2 and 4 (K12 against F.conv2d at ResNet-18's
four stride-1 k3 stage shapes, K14 against F.conv1d at 3136x256, bf16,
forwards), which `route_conv2d` follows on the card. Last in phase 3, the
fused linear cross-entropy (K8 forward, K9 dx, K10 dW) against its plain
versions in f32 and bf16 (N512 D64 V1024, a ragged N300 D72 V1000, a
tied-head-wide D256, D4160, whose 9 slices run K9 and K10 without a
cluster, and ragged N, V and D at D 1000 and 1536), the bf16 K8, K9 and
K10 on the Hopper kernels wherever ce_fwd_route and ce_grad_route send
them (counted), then at phase 6's LM head (bf16 N32768 D1536 V16384),
held per entry and in norm, with a planted fault per kernel (K8 without
its last cluster rank's vocabulary range, K9 without one vocabulary
tile's term, K10 without one row block's partial), each launched twice
for the same bits, and timed beside its plain version, the composite head
(`_lm_head` + logsumexp + gather: forward, backward, both), for K8 the
logits product alone (`torch.mm`, f32 out: a floor, not the same
function) and its bound.
Every kernel's time is printed beside its plain version's, the one
PyTorch call that computes the same function (where there is one; for
K8-K10 the composite head, several calls) and the bound: the larger of
its bytes over 3.35 TB/s and its FLOPs over the peak of its type (989
TFLOP/s bf16, 67 TFLOP/s f32), H100 SXM; for K3 in f32, the least time of
f32-accurate products on the card, 3 TF32 products at 495 TFLOP/s (165).
With --profile, one more step of phases 6 (the headline, the dropout run,
the defaults and the fused-CE run), 8, 9, 11, 13, 17 (BERT, T5, ViT,
MoE, LoRA, QLoRA) and 19 (StarCoderBase-1B) runs under torch.profiler:
each one's device time by kernel kind is printed and its kernel table
written to TABLE_PATH (the others beside it, "_dropout", "_split",
"_fused_ce", "_var", "_var2d", "_mistral", "_resnet", "_bert", "_t5",
"_vit", "_moe", "_lora", "_qlora" and "_starcoder" added to the
name).
Then a JSON line of per-kernel results and, last, one JSON line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

F32_TOL = 1e-5
# both versions compute in f32 from the same bf16 inputs and round the
# output to bf16 once: they may differ by one bf16 ulp of |o| (2^-6 for
# |o| < 4) plus f32 summation order
BF16_TOL = 2e-2


# H100 SXM: HBM bytes/s and dense peaks by operand type (NVIDIA's data
# sheet; f32 is FFMA outside the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the least time for f32-accurate products on this card, whatever computes
# them: three TF32 tensor-core products (3xTF32) at 495 TFLOP/s
F32_ACCURATE_FLOPS = 495e12 / 3


def bound_ms(nbytes: float, flops: float, dtype, peak=None) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the FLOPs over the type's peak (or `peak`)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of the kernels one fn() launches, from
    torch.profiler over `iters` calls after 3 warm-up calls: where a
    call's host work takes longer than its kernels (K11 at decode shapes),
    back-to-back CUDA events time the host's issue rate instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def paged_case(rng, *, B, KV, G, hd, BS, MB, pos, inactive, dtype):
    """Random q and pool, a shuffled block table; lanes in `inactive` get
    the decode step's idle-lane form (zero table row, pos MB*BS-1)."""
    NB = B * MB + 1
    q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
    pk = rng.standard_normal((NB, KV, BS, hd), dtype=np.float32)
    pv = rng.standard_normal((NB, KV, BS, hd), dtype=np.float32)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    table = table.astype(np.int32)
    pos = np.asarray(pos, np.int32)
    for b in inactive:
        table[b] = 0
        pos[b] = MB * BS - 1

    def dev(a, dt=None):
        return torch.from_numpy(a).to("cuda", dt)

    return (dev(q, dtype), dev(pk, dtype), dev(pv, dtype), dev(table),
            dev(pos))


# K11's shapes beyond the table's (tools/torch_diag.py paged times the
# same three): one long sequence (12 CTAs in one-CTA-a-sequence form, 43
# splits of 12 blocks here) and phase 4's serving shape, 8 live slots at
# contexts 33-192
PAGED_TABLE = dict(B=8, hd=128, BS=16, MB=64,
                   pos=[0, 15, 16, 500, 1023, 700, 129, 0], inactive=[7])
PAGED_LONG = dict(B=1, KV=12, G=1, hd=128, BS=16, MB=512, pos=[8191],
                  inactive=[])
PAGED_SERVING = dict(B=8, KV=12, G=1, hd=128, BS=16, MB=64,
                     pos=[33, 57, 96, 128, 150, 170, 192, 80], inactive=[])


def paged_bound(args, window=0):
    """(bound_ms, bound_by) of one K11 call: the K and V rows of every block
    it must walk (from the one holding the window's first key to the one
    holding pos; an idle lane walks all MB) read once; q and out are
    0.05% of them."""
    q, pk, _, table, pos = args
    _, KV, G, hd = q.shape
    BS = pk.shape[2]
    rows = 0
    for p in pos.tolist():
        p = min(p, table.shape[1] * BS - 1)
        lo = max(p - window + 1, 0) if window else 0
        rows += (p // BS + 1 - lo // BS) * BS
    return bound_ms(rows * KV * hd * 2 * q.element_size(),
                    4 * rows * KV * G * hd, q.dtype)


def paged_held(out, ref, tol):
    """(max abs err, ||err||/||ref||, whether out is within bounds): each
    entry within tol; bf16 also in norm (SPLIT_BF16_REL of ||ref|| plus
    SPLIT_BF16_FLOOR an entry), since at the long shape an entry of out is
    ~0.03 and one split's 192 of 8192 keys move it by less than
    BF16_TOL."""
    err = float((out.float() - ref.float()).abs().max())
    if ref.dtype != torch.bfloat16:
        return err, None, err <= tol
    rel, bound = norm_reading([diff_stats(out.float(), ref.float())])[:2]
    return err, rel, err <= tol and rel <= bound


def paged_fault(PA, args, window):
    """The plain version with one split's partial dropped (split 1, which
    holds attended keys of the long lanes), as a kernel that lost it would
    merge: the planted fault phase 3 reads."""
    q, pk, pv, table, pos = args
    bps = PA._plan(q.shape[0], q.shape[1] * PA.group_chunks(q.shape[2]),
                   table.shape[1], q.device)[1]
    m, l, acc = PA._split_partials(q, pk, pv, table, pos, window, bps)
    m[..., 1] = -math.inf
    return PA._merge_splits(m, l, acc).to(q.dtype)


def phase_kernels(rng, PA):
    """Phase 3: the paged-attention kernel (K11) against its plain version
    at the table shape and the long shape, a planted fault per shape (one
    split's partial dropped) and the same bits twice; then timed at the
    table, long and serving shapes. Returns the table shape's bf16 error
    and {shape: (kernel ms, plain ms, (bound_ms, bound_by), the kernel's
    ms a call back to back)}, the first two device times."""
    reference = PA.paged_attention_reference
    held = paged_held
    errs, rels, faults = {}, {}, {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        cases = [(f"table-{name}", dict(PAGED_TABLE, KV=KV, G=G), window)
                 for name, KV, G in (("mha", 12, 1), ("gqa", 2, 6))
                 for window in (0, 9)]
        # the long sequence, also under a window across a split boundary
        # (splits of 192 keys)
        cases += [("long", PAGED_LONG, 0), ("long", PAGED_LONG, 300)]
        for name, shape, window in cases:
            args = paged_case(rng, dtype=dtype, **shape)
            out = PA.paged_attention(*args, window=window)
            ref = reference(*args, window=window)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == ref.shape,
                  f"kernel output {out.dtype} {tuple(out.shape)}")
            key = f"{str(dtype)[6:]}/{name}/w{window}"
            errs[key], rels[key], ok = held(out, ref, tol)
            check(ok, f"paged_attention {key}: max abs err {errs[key]}, "
                      f"||err||/||ref|| {rels[key]}: out of bounds")
            if window == 0 and name in ("table-mha", "long"):
                reading = held(paged_fault(PA, args, window), ref, tol)
                faults[key] = reading[:2]
                check(not reading[2], f"paged_attention {key}: a planted "
                      f"fault reads {reading[:2]}, within bounds")
                again = PA.paged_attention(*args, window=window)
                check(torch.equal(out, again), f"paged_attention {key}: "
                                               f"two launches differ")
    # times in bf16, plain, kernel, kernel, plain in one call: device time
    # (the profiler), and the kernel's calls issued back to back (CUDA
    # events: the host's issue rate where that is slower)
    times = {}
    for name, shape in (("table", dict(PAGED_TABLE, KV=12, G=1)),
                        ("long", PAGED_LONG), ("serving", PAGED_SERVING)):
        args = paged_case(rng, dtype=torch.bfloat16, **shape)

        def kern():
            PA.paged_attention(*args)

        plain_a = device_ms(lambda: reference(*args), 20)
        kern_a, kern_b = device_ms(kern, 200), device_ms(kern, 200)
        plain_b = device_ms(lambda: reference(*args), 20)
        times[name] = (min(kern_a, kern_b), min(plain_a, plain_b),
                       paged_bound(args), cuda_ms(kern, 200))
    print(f"phase 3 kernels: paged_attention max_abs_err "
          f"{json.dumps(errs)} (tol f32 {F32_TOL}, bf16 {BF16_TOL} and in "
          f"norm {SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an entry: "
          f"bf16 ||err||/||ref|| "
          f"{json.dumps({k: v for k, v in rels.items() if v is not None})}); "
          f"planted faults (split 1's partial dropped; max abs err, "
          f"||err||/||ref||) {json.dumps(faults)}, each two launches the "
          f"same bits; bf16 G1 "
          f"hd128 BS16 (split as paged_split_plan cuts it; device time, "
          f"warm L2 but at the long shape's 50 MB): " + "; ".join(
              f"{name} kernel {k:.4f} ms ({b2b:.4f} ms a call back to "
              f"back), plain {p:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
              for name, (k, p, b, b2b) in times.items())
          + "; no single PyTorch call computes a paged decode step")
    return errs["bfloat16/table-mha/w0"], times


def serve(PagedBatcher, params, cfg, prompts, max_news, **kw):
    """Run the requests through a fresh PagedBatcher; returns the batcher,
    its outputs in submission order, the decode-step count, whether every
    logits row was finite, and the wall time."""
    pb = PagedBatcher(params, cfg, device="cuda", **kw)
    steps = [0]
    finite = [torch.ones((), dtype=torch.bool, device="cuda")]
    step, prefill = pb._step, pb._prefill

    def counted_step(*a):
        logits, cache = step(*a)
        steps[0] += 1
        finite[0] &= torch.isfinite(logits).all()
        return logits, cache

    def checked_prefill(*a):
        logits, cache = prefill(*a)
        finite[0] &= torch.isfinite(logits).all()
        return logits, cache

    pb._step, pb._prefill = counted_step, checked_prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [pb.submit(p, m) for p, m in zip(prompts, max_news)]
    done = pb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return pb, [done[r] for r in rids], steps[0], bool(finite[0]), wall


# flash attention cases: (name, H, KV, hd, S, causal, fast)
FLASH_CASES = (
    ("mha-hd128-causal-safe", 12, 12, 128, 512, True, False),
    ("gqa-hd128-full-fast", 12, 4, 128, 512, False, True),
    ("gqa-hd64-causal-fast", 12, 4, 64, 512, True, True),
    ("mha-hd64-full-safe", 12, 12, 64, 512, False, False),
    ("gqa-hd128-causal-safe-S1000", 12, 4, 128, 1000, True, False),
)
# f32: the same math in another summation order (d_qkv sums up to S
# products per element, so its bound is relative to its largest entry)
FLASH_F32_TOL = 1e-5
# bf16: both sides round p and ds to bf16 at the same places but sum in
# other orders, so a rounding may flip by one bf16 ulp: bounds relative to
# the largest output entry
FLASH_BF16_REL = {"out": 2 ** -6, "d_qkv": 2 ** -5}


def flash_case(rng, B, H, KV, hd, S, dtype):
    W = (H + 2 * KV) * hd
    qkv = torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32))
    do = torch.from_numpy(rng.standard_normal((B, S, H * hd),
                                              dtype=np.float32))
    return qkv.to("cuda", dtype), do.to("cuda", dtype)


def flash_faults(qkv, out, lse, do, split, fused, H):
    """What three planted faults would return at a causal MHA shape (S/2 >=
    512): K1 skipping k rows S/2 .. S/2 + 63 (one k tile) for every q row,
    K2a's dq without that k tile's term dS K, and the fused K2 writing dq =
    0 past q row 511. Returns (out, split d_qkv, fused d_qkv) so faulted."""
    B, S, W = qkv.shape
    hd = W // (3 * H)
    q, k, v = (qkv.view(B, S, H, 3, hd)[:, :, :, i].permute(0, 2, 1, 3)
               for i in range(3))
    j = slice(S // 2, S // 2 + 64)
    p = band_p(q, k[:, :, j], lse, 0, j.start, S)
    c = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, j].float())
    o = out.view(B, S, H, hd).permute(0, 2, 1, 3).float()
    out_f = ((o - c) / (1 - p.sum(-1, keepdim=True))).permute(
        0, 2, 1, 3).reshape(B, S, H * hd)
    del c
    # the k tile's dS = p (dP - delta) scale, as the kernels round it
    g = do.view(B, S, H, hd).permute(0, 2, 1, 3).float()
    delta = (g * o).sum(-1, keepdim=True)
    ds = (p * (torch.einsum("bhqd,bhkd->bhqk", g, v[:, :, j].float())
               - delta) * hd ** -0.5).to(qkv.dtype).float()
    del p, g, o
    split_f = split.clone()
    dq = split_f.view(B, S, H, 3, hd)[:, :, :, 0]
    dq -= torch.einsum("bhqk,bhkd->bqhd", ds, k[:, :, j].float()).to(
        qkv.dtype)
    fused_f = fused.clone()
    fused_f.view(B, S, H, 3, hd)[:, 512:, :, 0] = 0
    return out_f, split_f, fused_f


def check_flash(FA, key, qkv, do, H, KV, causal, fast, faults=False,
                seed=0, rate=0.0):
    """K1, the split pair K2a+K2b and the fused K2 against the plain
    versions on one input, with attention dropout at `rate` from `seed`;
    raises on a mismatch. bf16 results are held per entry and in norm
    (SPLIT_BF16_REL, as K5-K7); with `faults` (causal MHA), flash_faults'
    three planted faults are read against the same plain versions and must
    fail the norm bound. Returns {kernel name: max abs err}, K1's (out,
    lse) and {tensor: (||err||/||ref||, bound)} of the norm readings and
    the faults (empty in f32)."""
    B, S, _ = qkv.shape
    G = H // KV
    drop = dict(seed=seed, rate=rate)
    out, lse = FA.flash_fwd_qkv(qkv, H, KV, causal, fast_softmax=fast,
                                **drop)
    rout, rlse = FA.flash_attention_qkv_fwd_reference(
        qkv, H, KV, causal, fast_softmax=fast, **drop)
    split = torch.empty_like(qkv)
    FA.flash_bwd_dq_qkv(qkv, out, lse, do, split, H, KV, causal, **drop)
    FA.flash_bwd_dkv_qkv(qkv, out, lse, do, split, H, KV, causal, **drop)
    fused = FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV, causal, **drop)
    ref = FA.flash_attention_qkv_bwd_reference(qkv, out, lse, do, H, KV,
                                               causal, **drop)
    torch.cuda.synchronize()
    f32 = qkv.dtype == torch.float32
    o_max = float(rout.float().abs().max())
    g_max = float(ref.float().abs().max())
    o_tol = FLASH_F32_TOL if f32 else FLASH_BF16_REL["out"] * o_max
    g_tol = (FLASH_F32_TOL * max(1.0, g_max) if f32
             else FLASH_BF16_REL["d_qkv"] * g_max)
    e_out = float((out.float() - rout.float()).abs().max())
    e_lse = float((lse - rlse).abs().max())
    parts = split.view(B, S, KV, G + 2, -1)
    rparts = ref.view(B, S, KV, G + 2, -1)
    reads = {}
    if not f32:
        reads = {"out": norm_reading([diff_stats(out, rout)]),
                 "dq": norm_reading([diff_stats(parts[:, :, :, :G],
                                                rparts[:, :, :, :G])]),
                 "dkv": norm_reading([diff_stats(parts[:, :, :, G:],
                                                 rparts[:, :, :, G:])]),
                 "fused": norm_reading([diff_stats(fused, ref)])}
        if faults:
            out_f, split_f, fused_f = flash_faults(qkv, out, lse, do, split,
                                                   fused, H)
            reads["fault out"] = norm_reading([diff_stats(out_f, rout)])
            reads["fault dq"] = norm_reading([diff_stats(
                split_f.view(B, S, KV, G + 2, -1)[:, :, :, :G],
                rparts[:, :, :, :G])])
            reads["fault fused"] = norm_reading([diff_stats(fused_f, ref)])
            del out_f, split_f, fused_f
    del rout, rlse
    diff = (parts.float() - rparts.float()).abs()
    e_dq = float(diff[:, :, :, :G].max())
    e_dkv = float(diff[:, :, :, G:].max())
    del diff, parts, split
    e_fused = float((fused.float() - ref.float()).abs().max())
    print(f"  {key}: out {e_out:.3g} (tol {o_tol:.3g}), lse {e_lse:.3g}, "
          f"dq {e_dq:.3g}, dkv {e_dkv:.3g}, fused {e_fused:.3g} "
          f"(tol {g_tol:.3g})" + ("; ||err||/||ref|| " + ", ".join(
              f"{n} {r[0]:.3g} (bound {r[1]:.3g})" for n, r in reads.items())
              if reads else ""))
    check(e_out <= o_tol, f"flash_fwd_qkv {key}: out err {e_out}")
    check(e_lse <= (FLASH_F32_TOL if f32 else 1e-3),
          f"flash_fwd_qkv {key}: lse err {e_lse}")
    errs = {"flash_fwd_qkv": e_out, "flash_bwd_dq_qkv": e_dq,
            "flash_bwd_dkv_qkv": e_dkv, "flash_bwd_fused_qkv": e_fused}
    for kname, e in list(errs.items())[1:]:
        check(e <= g_tol, f"{kname} {key}: err {e} > {g_tol}")
    for n, (r, bound, _, _) in reads.items():
        if n.startswith("fault"):
            check(r > bound, f"{key}: planted {n} reads {r} <= bound {bound}")
        else:
            check(r <= bound, f"{key}: {n} ||err||/||ref|| {r} > {bound}")
    return errs, (out, lse), {n: r[:2] for n, r in reads.items()}


def phase_flash_kernels(rng, FA):
    """Phase 3, flash part: K1, K2a+K2b and the fused K2 against the plain
    versions on the same inputs, over the small cases and then at the
    headline train step's shape (bf16 B16 S2048 H12 KV12 hd128, causal,
    fast softmax), where they are also timed. Returns {kernel name:
    (max_abs_err at the headline shape, ms, plain_ms)}."""
    for dtype in (torch.float32, torch.bfloat16):
        for name, H, KV, hd, S, causal, fast in FLASH_CASES:
            qkv, do = flash_case(rng, 2, H, KV, hd, S, dtype)
            check_flash(FA, f"{str(dtype)[6:]}/{name}", qkv, do, H, KV,
                        causal, fast)
            del qkv, do
    # the fused backward sums dq over k tiles in a fixed order in f32 too:
    # two launches, same bits (GQA, ragged S, both masks)
    for causal in (True, False):
        qkv, do = flash_case(rng, 2, 8, 2, 128, 1000, torch.float32)
        out, lse = FA.flash_fwd_qkv(qkv, 8, 2, causal)
        again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, 8, 2, causal)
                 for _ in range(2)]
        check(torch.equal(*again), f"flash_bwd_fused_qkv f32 causal={causal}"
              ": two launches on the same inputs differ")
        del qkv, do, out, lse, again

    B, H, S, hd = 16, 12, 2048, 128
    qkv, do = flash_case(rng, B, H, H, hd, S, torch.bfloat16)
    errs, (out, lse), reads = check_flash(
        FA, "bfloat16/headline-B16-S2048-mha-hd128-causal-fast", qkv, do, H,
        H, True, True, faults=True)
    # the fused backward sums dq in a fixed order, and K2a owns its dq
    # rows: two launches of each, same bits
    again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, H) for _ in range(2)]
    check(torch.equal(*again), "flash_bwd_fused_qkv: two launches on the "
          "same inputs differ")
    again = [FA.flash_bwd_dq_qkv(qkv, out, lse, do, torch.zeros_like(qkv), H)
             for _ in range(2)]
    check(torch.equal(*again), "flash_bwd_dq_qkv: two launches on the same "
          "inputs differ")
    del again
    # time at the same shape: plain, kernel, kernel, plain
    d_qkv = torch.empty_like(qkv)
    fwd = (lambda: FA.flash_fwd_qkv(qkv, H, fast_softmax=True),
           lambda: FA.flash_attention_qkv_fwd_reference(qkv, H,
                                                        fast_softmax=True))
    bwd = {"flash_bwd_dq_qkv":
           lambda: FA.flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, H),
           "flash_bwd_dkv_qkv":
           lambda: FA.flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, H),
           "flash_bwd_fused_qkv":
           lambda: FA.flash_bwd_fused_qkv(qkv, out, lse, do, H)}
    plain_bwd = lambda: FA.flash_attention_qkv_bwd_reference(  # noqa: E731
        qkv, out, lse, do, H)
    times = {}
    pa = cuda_ms(fwd[1], 2)
    ka, kb = cuda_ms(fwd[0], 5), cuda_ms(fwd[0], 5)
    pb = cuda_ms(fwd[1], 2)
    times["flash_fwd_qkv"] = (min(ka, kb), min(pa, pb))
    pa = cuda_ms(plain_bwd, 2)
    ks = {k: [cuda_ms(fn, 5)] for k, fn in bwd.items()}
    for k, fn in bwd.items():
        ks[k].append(cuda_ms(fn, 5))
    pb = cuda_ms(plain_bwd, 2)
    for k in bwd:       # one plain backward computes all of d_qkv
        times[k] = (min(ks[k]), min(pa, pb))

    def split_pair():   # as FlashAttentionQKV.backward runs it
        st = FA.flash_bwd_stats_qkv(qkv, out, lse, do, H)
        FA.flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, H, stats=st)
        FA.flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, H, stats=st)

    pair_ms = min(cuda_ms(split_pair, 5), cuda_ms(split_pair, 5))
    lib_fwd, lib_bwd = sdpa_ms(qkv, do, H, hd)
    result, line = {}, []
    for kname, (k_ms, p_ms) in times.items():
        bound, flops = packed_bound(kname, B, H, H, hd, S)
        lib = lib_fwd if kname == "flash_fwd_qkv" else lib_bwd
        result[kname] = (errs[kname], k_ms, p_ms, lib, bound)
        # SDPA's forward runs K1's 2 products, its backward the fused 5
        lib_flops = ((2 if kname == "flash_fwd_qkv" else 5)
                     * B * H * S * S * hd)
        line.append(f"{kname} {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} "
                    f"TFLOP/s) vs plain {p_ms:.3f} ms, SDPA {lib:.3f} ms "
                    f"({lib_flops / lib / 1e9:.1f} TFLOP/s), bound "
                    f"{bound[0]:.3f} ms")
    torch.cuda.synchronize()
    print("phase 3 kernels: flash attention within bounds (f32 "
          f"{FLASH_F32_TOL}, bf16 {FLASH_BF16_REL} of max and in norm "
          f"{SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an entry); "
          "headline ||err||/||ref|| " + ", ".join(
              f"{n} {r:.3g} (bound {b:.3g})" for n, (r, b) in reads.items())
          + "; fused backward (and f32 at B2 S1000 H8 KV2) and K2a "
          "bit-identical over two launches; bf16 B16 "
          "S2048 H12 hd128 causal fast: " + "; ".join(line)
          + f"; the split pair (one pre-pass, K2a, K2b) {pair_ms:.3f} ms"
          + " (the plain backward and SDPA's backward compute all of "
          "d_qkv)")
    return result


def sdpa_ms(qkv, do, H, hd):
    """Times of F.scaled_dot_product_attention (causal) on the strided q,
    k, v views of the packed MHA qkv, and of its backward to d_qkv (one
    `torch.autograd.grad` call over the saved graph). Timed only: the port
    never calls it."""
    import torch.nn.functional as F

    B, S, _ = qkv.shape
    x = qkv.detach().requires_grad_()
    parts = x.view(B, S, H, 3, hd)
    q, k, v = (parts[:, :, :, i].transpose(1, 2) for i in range(3))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 5)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    g = do.view(B, S, H, hd).transpose(1, 2)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, x, g, retain_graph=True),
                  5)
    del out
    return fwd, bwd


TRAIN_CFG = dict(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                 d_ff=6144, max_seq=2048)
# bench.py:1103-1107, the headline train step
HEADLINE = dict(remat=False, scan_layers=False, flash_softmax="fast",
                flash_bwd="fused", opt_state_dtype="bf16",
                matmul_out="compute")


def train_steps(T, kernels, cfg, n_warm, n_timed, batch, lr, profile=None,
                label="one headline step", heldout=None):
    """Run warm-up then timed train steps on fresh params (torch.Generator
    seed 0). Returns the losses, the launch counts of `kernels` in the
    timed steps (and, as "name.sm90", of those that count their Hopper
    kernel's launches apart), the step time in s, the peak memory in GiB
    and the eval loss of the trained params on the `heldout` batch (None
    without one)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    opt = T.opt_init(params, cfg)
    step = T.make_train_step(cfg)
    toks, tgts = batch

    def run():
        nonlocal params, opt
        params, opt, loss = step(params, opt, toks, tgts, lr, gen)
        return loss

    losses, launches, step_s, peak = model_steps(
        run, kernels, n_warm, n_timed, profile, label)
    held = None
    if heldout is not None:
        with torch.no_grad():
            held = float(T.loss_fn(params, *heldout, cfg))
    del params, opt, run
    torch.cuda.empty_cache()
    return losses, launches, step_s, peak, held


def fused_walk(name):
    """A flash_bwd_kv_kernel's FUSED flag, its second-to-last template
    argument (<HD, FUSED, DROPOUT> on Hopper, <T, HD, FUSED, DROPOUT>)."""
    m = re.search(r"flash_bwd_kv_kernel\w*<([^>]*)>", name)
    return bool(m) and m.group(1).split(",")[-2].strip() == "true"


def profile_step(run, label, path):
    """One more step, `run()`, under torch.profiler: prints its device time
    by kernel kind and the device's idle share of the step, and writes the
    kernel table to `path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.key
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        kind = ("K8 ce fwd (sm90)" if "ce_fwd_sm90" in n
                else "K8 ce fwd" if "ce_fwd_kernel" in n
                else "K9 ce dx (sm90)" if "ce_grad_sm90" in n
                and "<true>" in n
                else "K10 ce dw (sm90)" if "ce_grad_sm90" in n
                else "K9 ce dx" if "ce_grad_kernel" in n and "true>" in n
                else "K10 ce dw" if "ce_grad_kernel" in n
                else "K15 conv3d (sm90)" if "conv3d_sm90" in n
                else "K14 conv1d (sm90)" if "conv1d_sm90" in n
                else "K12 conv (sm90)" if "conv_sm90_fwd" in n
                else "K13 conv dw" if "conv_sm90_dw" in n
                or "conv_mma<true>" in n or "conv_ffma<true>" in n
                or "conv_dw_reduce" in n
                else "K12-K15 conv" if "conv_mma<false>" in n
                or "conv_ffma<false>" in n
                else "K5 fwd (sm90)" if "split_fwd_kernel_sm90" in n
                else "K5 fwd" if "split_fwd" in n
                else "K6 dq" if "split_bwd_dq" in n
                else "K7 dk/dv" if "split_bwd_dkv" in n
                else "K2 pre-pass" if "bwd_stats" in n
                else "K2c fused (cluster)" if "kv_kernel_sm90_cluster" in n
                and fused_walk(n)
                else "K2b dk/dv (cluster)" if "kv_kernel_sm90_cluster" in n
                else "K2c fused" if "flash_bwd_kv_kernel" in n
                and fused_walk(n) or "dq_store" in n or "dq_cast" in n
                else "K2b dk/dv" if "flash_bwd_kv_kernel" in n
                else "K2a dq" if "flash_bwd_dq" in n
                else "K1 fwd" if "flash_fwd" in n
                else "K3 matmul" if "k3_" in n
                else "K4 softmax" if "softmax_cached" in n
                or "softmax_online" in n
                else "library conv" if any(c in n for c in (
                    "dgrad", "wgrad", "conv", "Conv"))
                else "GEMM" if any(g in n for g in ("nvjet", "gemm", "xmma",
                                                    "cutlass"))
                else "LayerNorm" if "layer_norm" in n or "GammaBeta" in n
                else "elementwise, casts, reductions")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    busy = sum(kinds.values())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=200))
    print(f"profile: {label}, {wall_ms:.1f} ms host time under "
          f"the profiler, {busy:.1f} ms on the device (idle share "
          f"{1 - busy / wall_ms:.3f}): " + ", ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})"
              for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
          + f"; table in {path}")


def train_kernels(FA, CE):
    """Every kernel a GPT train step may launch."""
    return FA.KERNELS + FA.SPLIT_KERNELS + CE.KERNELS


def phase_train(T, FA, CE, profile):
    """Phase 6: the train step at full width; returns the launch counts of
    the headline run, of the defaults run and of the fused-CE run, and the
    headline's step time in ms."""
    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, TRAIN_CFG["vocab_size"], size=(B, S))
    tgts = np.roll(toks, -1, axis=1)
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(tgts).to("cuda"))
    kernels = train_kernels(FA, CE)
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG, **HEADLINE)
    losses, launches, step_s, peak, _ = train_steps(
        T, kernels, cfg, 2, 5, batch, 5e-4, profile)
    L, n = cfg.n_layer, 5
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd_qkv=L * n, flash_bwd_fused_qkv=L * n)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == want, f"headline launches {launches}, want {want}")
    head_ms = step_s * 1e3
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    head_line = (f"step {step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU "
                 f"{mfu:.4f}, peak {peak:.2f} GiB")
    print(f"phase 6 train: d1536 L8 H12 V16384 S2048 B16 bf16, fused bwd, "
          f"no remat, bf16 Adam: step {step_s * 1e3:.1f} ms, "
          f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (of 989 TFLOP/s), peak "
          f"{peak:.2f} GiB; losses {[round(l, 4) for l in losses]}; "
          f"launches {launches}")
    head = launches
    # the headline at GPT-2's attn_pdrop (Radford et al. 2019): in-kernel
    # dropout in K1 and the fused K2
    cfg = T.GPTConfig(dtype=torch.bfloat16, dropout=0.1, **TRAIN_CFG,
                      **HEADLINE)
    nd = 3
    path = None
    if profile:
        root, ext = os.path.splitext(profile)
        path = f"{root}_dropout{ext}"
    losses, launches, step_s, peak, _ = train_steps(
        T, kernels, cfg, 1, nd, batch, 5e-4, path,
        "one dropout=0.1 headline step")
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd_qkv=L * nd, flash_bwd_fused_qkv=L * nd)
    check(all(np.isfinite(losses)), f"non-finite loss (dropout): {losses}")
    check(losses[-1] < losses[0], f"loss did not fall (dropout): {losses}")
    check(launches == want, f"dropout launches {launches}, want {want}")
    tok_s = B * S / step_s
    print(f"phase 6 train, the headline with dropout=0.1 (in-kernel, K1 and "
          f"the fused K2), 1 warm-up and {nd} timed steps: step "
          f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, peak {peak:.2f} GiB "
          f"(without dropout: {head_line}); losses "
          f"{[round(l, 4) for l in losses]}; launches {launches}")
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG)
    path = None
    if profile:
        root, ext = os.path.splitext(profile)
        path = f"{root}_split{ext}"
    losses, launches, step_s, peak, _ = train_steps(
        T, kernels, cfg, 1, 2, batch, 5e-4, path,
        "one defaults (split backward) step")
    want = dict.fromkeys(launches, 0)     # remat re-runs the forward
    want.update(flash_fwd_qkv=2 * L * 2, flash_bwd_dq_qkv=L * 2,
                flash_bwd_dkv_qkv=L * 2)
    check(all(np.isfinite(losses)), f"non-finite loss (defaults): {losses}")
    check(launches == want, f"defaults launches {launches}, want {want}")
    print(f"phase 6 train, GPTConfig defaults (split bwd, remat, f32 Adam, "
          f"f32 matmul outputs), 1 warm-up and 2 counted steps: step "
          f"{step_s * 1e3:.1f} ms, "
          f"{B * S / step_s:.0f} tokens/s, peak {peak:.2f} GiB; losses "
          f"{[round(l, 4) for l in losses]}; launches {launches}")
    split = launches
    # the headline with the fused linear cross-entropy: rows 32768 and
    # vocab 16384 pass JAX's gate, so K8 runs once a step and K9, K10 once
    # each in its backward, all three on the Hopper kernels
    cfg = T.GPTConfig(dtype=torch.bfloat16, fused_ce="on", **TRAIN_CFG,
                      **HEADLINE)
    path = None
    if profile:
        root, ext = os.path.splitext(profile)
        path = f"{root}_fused_ce{ext}"
    losses, launches, step_s, peak, _ = train_steps(
        T, kernels, cfg, 2, n, batch, 5e-4, path,
        "one fused-CE headline step")
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd_qkv": L * n, "flash_bwd_fused_qkv": L * n,
                 "ce_fwd": n, "ce_dx": n, "ce_dw": n,
                 "ce_fwd.sm90": n,    # K8, K9 and K10 on
                 "ce_dx.sm90": n,     # csrc/cross_entropy_sm90.cu
                 "ce_dw.sm90": n})
    check(all(np.isfinite(losses)), f"non-finite loss (fused CE): {losses}")
    check(losses[-1] < losses[0], f"loss did not fall (fused CE): {losses}")
    check(launches == want, f"fused-CE launches {launches}, want {want}")
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    print(f"phase 6 train, the headline with fused_ce='on' (K8-K10): step "
          f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f}, peak "
          f"{peak:.2f} GiB (the composite headline above: {head_line}); "
          f"losses {[round(l, 4) for l in losses]}; launches {launches}")
    return head, split, launches, head_ms


# phase 7 bounds (f32): loss and gradients of two exact routes that differ
# in summation order only
ROUTE_LOSS_TOL = 1e-5
ROUTE_GRAD_TOL = 2e-5


def route_run(T, params, cfg0, kernels, **kw):
    """The loss and every gradient leaf of one f32 forward and backward on
    a fixed B2 S256 batch (numpy seed 1) with cfg0 updated by kw, and the
    launches of `kernels` it made. Dropout draws its layers' seeds from a
    generator seeded 9, so both routes drop the same entries."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg0.vocab_size,
                                         size=(2, 256))).to("cuda")
    cfg = dataclasses.replace(cfg0, **kw)
    before = [k.launches for k in kernels]
    leaves = [p.detach().clone().requires_grad_()
              for p in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten(params, leaves), toks, toks.roll(-1, 1),
                     cfg, train=True,
                     generator=torch.Generator(device="cuda").manual_seed(9))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return (float(loss.detach()), grads,
            [k.launches - b for k, b in zip(kernels, before)])


def route_errs(phase, ref, run):
    """|d loss| and max |d grad| of `run` against `ref` (route_run
    results), checked against phase 7's bounds."""
    e_l = abs(run[0] - ref[0])
    e_g = max(float((a - b).abs().max()) for a, b in zip(run[1], ref[1]))
    check(e_l <= ROUTE_LOSS_TOL, f"{phase}: loss {run[0]} vs plain {ref[0]}")
    check(e_g <= ROUTE_GRAD_TOL, f"{phase}: grad err {e_g}")
    return e_l, e_g


def phase_routes(T, FA, CE):
    """Phase 7: kernel route vs plain route (flash="off"), f32, hd 128;
    then the fused CE route (fused_ce="on": K8-K10) against the composite
    head ("off") at vocab 1024, where B2 S256 passes the gate, for a tied
    GPT and an untied llama-style head, launches held exact."""
    cfg0 = T.GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=256,
                       d_ff=1024, max_seq=256, dtype=torch.float32,
                       remat=False)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(1),
                           cfg0, "cuda")
    ref = route_run(T, params, cfg0, FA.KERNELS, flash="off")
    errs = {}
    for bwd in ("split", "fused"):
        run = route_run(T, params, cfg0, FA.KERNELS, flash="on",
                        flash_bwd=bwd)
        check(run[2][0] == cfg0.n_layer, f"phase 7 {bwd}: launches {run[2]}")
        errs[bwd] = route_errs(f"phase 7 {bwd}", ref, run)
    print(f"phase 7 kernel vs plain route: f32 d256 H2 hd128 L2 S256 B2, "
          f"loss {ref[0]:.6f}; |d loss|, max |d grad| per leaf: "
          + ", ".join(f"{k} {a:.3g}, {b:.3g}" for k, (a, b) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")
    # dropout 0.3: the composite draws the kernels' keep_mask, so the
    # routes drop the same entries; packed (both backwards) and split
    # (llama, GQA, a window)
    errs, L = {}, cfg0.n_layer
    for name, preset, kw, kern, want in (
            ("packed-split", T.GPTConfig, dict(flash_bwd="split"),
             FA.KERNELS, [L, L, L, 0]),
            ("packed-fused", T.GPTConfig, dict(flash_bwd="fused"),
             FA.KERNELS, [L, 0, 0, L]),
            ("split-llama-window", T.llama_config,
             dict(n_kv_head=1, window=100), FA.SPLIT_KERNELS, [L, L, L])):
        cfg = preset(vocab_size=512, n_layer=2, n_head=2, d_model=256,
                     d_ff=1024, max_seq=256, dtype=torch.float32,
                     remat=False, dropout=0.3, **kw)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(4),
                               cfg, "cuda")
        ref = route_run(T, params, cfg, kern, flash="off")
        run = route_run(T, params, cfg, kern, flash="on")
        check(ref[2] == [0] * len(kern) and run[2] == want,
              f"phase 7 dropout {name}: launches {run[2]}, want {want}")
        errs[name] = (ref[0],) + route_errs(f"phase 7 dropout {name}", ref,
                                            run)
    print("phase 7 kernel vs plain route at dropout=0.3 (f32 d256 H2 hd128 "
          "L2 S256 B2; loss, |d loss|, max |d grad| per leaf): "
          + ", ".join(f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                      for k, (a, b, c) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")
    errs, used = {}, []
    for name, preset, kw in (
            ("gpt-tied", T.GPTConfig, dict(d_ff=1024)),
            ("llama-untied", T.llama_config, dict(n_kv_head=1, d_ff=512))):
        cfg0 = preset(vocab_size=1024, n_layer=2, n_head=2, d_model=256,
                      max_seq=256, dtype=torch.float32, remat=False, **kw)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(3),
                               cfg0, "cuda")
        ref = route_run(T, params, cfg0, CE.KERNELS, fused_ce="off")
        run = route_run(T, params, cfg0, CE.KERNELS, fused_ce="on")
        check(ref[2] == [0, 0, 0] and run[2] == [1, 1, 1],
              f"phase 7 fused CE {name}: launches {run[2]}, want [1, 1, 1]")
        errs[name] = (ref[0],) + route_errs(f"phase 7 fused CE {name}", ref,
                                            run)
        used.append(run[2])
    print("phase 7 fused CE route (K8-K10) vs composite head: f32 d256 H2 "
          "hd128 L2 S256 B2 V1024; loss, |d loss|, max |d grad| per leaf: "
          + ", ".join(f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                      for k, (a, b, c) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL}); CE launches "
          f"{used}")


def bf16_ulp(x_max: float) -> float:
    """One bf16 ulp at |x| = x_max (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(x_max)) - 7)


def within(out, ref, key):
    """Max abs error of a K3/K4 result against its plain version, checked
    against 1e-5 of the largest |entry| in f32 and one bf16 ulp of it in
    bf16. Returns (err, bound)."""
    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{key}: kernel gave {out.dtype} {tuple(out.shape)}")
    top = float(ref.float().abs().max())
    tol = F32_TOL * top if ref.dtype == torch.float32 else bf16_ulp(top)
    err = float((out.float() - ref.float()).abs().max())
    check(err <= tol, f"{key}: max abs err {err} > {tol}")
    return err, tol


def mm_operands(rng, case, dtype):
    """A and B of a K3 case, laid out as the path lays them out: "T" views
    are transposes of row-major storage, as the VJPs and `t()` hand them
    over; "head" is the 2-d model's LM head x @ wte.t(), "head-dx" and
    "head-dw" its two VJP products g @ wte and x.T @ g; "mlp" the first
    MLP product x @ w1, "mlp-dx" its VJP g @ w1.T; "proj" a q, k, v or
    output projection x @ w; "scores" one head's q_h @ k_h.t(), chunk
    views of the (S, d) projections; "pv" one head's p @ v_h."""
    def dev(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dtype)

    name, M, K, N = case
    if name in ("ragged", "head-dx", "mlp", "proj"):
        return dev(M, K), dev(K, N)
    if name == "pv":                          # one head's chunk of v
        return dev(M, K), dev(K, 768)[:, :N]
    if name == "ragged-both-T":
        return dev(K, M).T, dev(N, K).T
    if name == "head":
        return dev(M, K), dev(N, K).T
    if name == "head-dw":
        return dev(K, M).T, dev(K, N)
    if name == "mlp-dx":
        return dev(M, K), dev(N, K).T
    q, k = dev(M, 768), dev(N, 768)          # scores: d 768, hd K
    return q[:, :K], k[:, :K].T


MM_CASES = (("ragged", 1000, 760, 1030), ("ragged-both-T", 1000, 760, 1030),
            ("head", 1024, 768, 16384), ("scores", 1024, 128, 1024),
            ("head-dx", 1024, 16384, 768), ("head-dw", 768, 1024, 16384),
            ("mlp", 1024, 768, 3072), ("mlp-dx", 1024, 3072, 768),
            ("proj", 1024, 768, 768), ("pv", 1024, 1024, 128))
# the K3 cases whose 128 x 128 tiles of C do not fill the card's 132 SMs,
# so the kernel splits K
MM_SPLIT_CASES = ("head-dx", "pv", "proj", "mlp-dx")
SM_CASES = ((64, 1000), (64, 16384), (4, 20000))


def phase_mm_softmax(MM, SM):
    """Phase 3, K3 and K4: each against its plain version on the card at
    the cases above and at the paths' shapes, then timed there (kernel,
    plain, plain, kernel), with the one PyTorch call that computes the
    same function. Returns {kernel: (max_abs_err, ms, plain_ms,
    library_ms, (bound_ms, bound_by))} at the JSON line's shapes: the 2-d
    model's f32 LM head for K3, the flagship's (32768, 16384) f32
    log-softmax for K4."""
    rng = np.random.default_rng(3)
    errs, faults = {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for case in MM_CASES:
            a, b = mm_operands(rng, case, dtype)
            key = f"matmul {str(dtype)[6:]}/{case[0]}"
            out = MM.matmul(a, b)
            ref = MM.matmul_reference(a, b)
            errs[key], tol = within(out, ref, key)
            check(torch.equal(out, MM.matmul(a, b)),
                  f"{key}: two launches on the same inputs differ")
            _, M, K, N = case
            splits = MM.split_k(M, N, K, dtype, sms)
            check((splits > 1) == (case[0] in MM_SPLIT_CASES),
                  f"{key}: {splits} K slices")
            if splits > 1:   # planted fault: the last K slice dropped
                bk = MM._STAGE_K[dtype]
                k0 = (splits - 1) * -(-K // bk) // splits * bk
                bad = (out.float() - a[:, k0:].float() @ b[k0:].float()).to(
                    dtype)
                faults[key] = float((bad.float() - ref.float()).abs().max())
                check(faults[key] > tol, f"{key}: planted fault reads "
                                         f"{faults[key]} <= {tol}")
            del a, b, out, ref
        for rows, cols in SM_CASES:
            x = torch.from_numpy(3 * rng.standard_normal(
                (rows, cols), dtype=np.float32)).to("cuda", dtype)
            for log in (False, True):
                key = f"softmax {str(dtype)[6:]}/{rows}x{cols}/log={log}"
                errs[key] = within(
                    SM.softmax_last_axis(x, log=log),
                    SM.softmax_last_axis_reference(x, log=log), key)[0]
    torch.cuda.synchronize()
    print("phase 3 kernels: matmul and softmax within bounds (1e-5 of "
          "max |entry| in f32, one bf16 ulp of it in bf16): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + "; matmul bit-identical over two launches; planted faults (the "
          "last K slice of a split-K product dropped), max abs err: "
          + ", ".join(f"{k} {v:.3g}" for k, v in faults.items()))

    result, line = {}, []
    # K3 at the 2-d model's LM head (f32, B = wte.t()), and its scores
    for case, dtype in ((MM_CASES[2], torch.float32),
                        (MM_CASES[3], torch.float32),
                        (MM_CASES[2], torch.bfloat16)):
        a, b = mm_operands(rng, case, dtype)
        err, _ = within(MM.matmul(a, b), MM.matmul_reference(a, b),
                        f"matmul {case[0]}")
        _, M, K, N = case
        pa = cuda_ms(lambda: MM.matmul_reference(a, b), 10)
        ka = cuda_ms(lambda: MM.matmul(a, b), 10)
        kb = cuda_ms(lambda: MM.matmul(a, b), 10)
        pb = cuda_ms(lambda: MM.matmul_reference(a, b), 10)
        lib = cuda_ms(lambda: torch.mm(a, b), 10)
        k_ms, p_ms = min(ka, kb), min(pa, pb)
        item = a.element_size()
        bound = bound_ms((M * K + K * N + M * N) * item, 2 * M * K * N, dtype,
                         F32_ACCURATE_FLOPS if dtype == torch.float32
                         else None)
        line.append(f"{str(dtype)[6:]} {case[0]} ({M}, {K}) @ ({K}, {N}): "
                    f"kernel {k_ms:.4f} ms "
                    f"({2 * M * K * N / k_ms / 1e9:.1f} TFLOP/s), plain "
                    f"{p_ms:.4f} ms, torch.mm {lib:.4f} ms, bound "
                    f"{bound[0]:.4f} ms ({bound[1]})")
        if "matmul" not in result:
            result["matmul"] = (err, k_ms, p_ms, lib, bound)
        del a, b
    # K4 at the flagship's loss head, then the 2-d model's two shapes
    for rows, cols, log in ((32768, 16384, True), (1024, 16384, True),
                            (1024, 1024, False)):
        x = torch.from_numpy(3 * rng.standard_normal(
            (rows, cols), dtype=np.float32)).to("cuda")
        err, _ = within(SM.softmax_last_axis(x, log=log),
                        SM.softmax_last_axis_reference(x, log=log),
                        f"softmax {rows}x{cols}")
        torch.cuda.empty_cache()
        lib_fn = torch.log_softmax if log else torch.softmax
        iters = 5 if rows > 10000 else 50
        pa = cuda_ms(lambda: SM.softmax_last_axis_reference(x, log=log),
                     iters)
        ka = cuda_ms(lambda: SM.softmax_last_axis(x, log=log), iters)
        kb = cuda_ms(lambda: SM.softmax_last_axis(x, log=log), iters)
        pb = cuda_ms(lambda: SM.softmax_last_axis_reference(x, log=log),
                     iters)
        lib = cuda_ms(lambda: lib_fn(x, -1), iters)
        k_ms, p_ms = min(ka, kb), min(pa, pb)
        # one read and one write of f32; about 5 f32 operations an element
        bound = bound_ms(2 * rows * cols * 4, 5 * rows * cols, torch.float32)
        line.append(f"f32 {'log_softmax' if log else 'softmax'} ({rows}, "
                    f"{cols}): kernel {k_ms:.4f} ms "
                    f"({2 * rows * cols * 4 / k_ms / 1e6:.0f} GB/s), plain "
                    f"{p_ms:.4f} ms, torch {lib:.4f} ms, bound "
                    f"{bound[0]:.4f} ms ({bound[1]})")
        if "softmax" not in result:
            result["softmax"] = (err, k_ms, p_ms, lib, bound)
        del x
        torch.cuda.empty_cache()
    print("phase 3 kernels, times: " + "; ".join(line))
    return result


# the bench's two Var-tier configurations (bench.py:165-189, :228-244)
VAR_FLAGSHIP = dict(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                    d_ff=6144, max_seq=2048)
VAR_LEGACY = dict(vocab_size=16384, n_layer=8, n_head=6, d_model=768,
                  d_ff=3072, max_seq=1024)


# the kernels a Var path may launch, in the order launch lists use
VAR_KERNELS = ("flash_fwd_qkv", "flash_bwd_fused_qkv", "matmul", "softmax")


def var_kernels(FA, MM, SM):
    return (FA.flash_fwd_qkv, FA.flash_bwd_fused_qkv, MM.matmul,
            SM.softmax_last_axis)


def var_train(optim, params, loss, n_timed, kernels, want, phase):
    """Adam(1e-4) on `params`: 1 warm-up and `n_timed` fused steps on
    `loss`, the timed ones queued without a sync (block=False) and ended by
    one; checks that the loss is finite and falls and that the timed steps
    launched `want` (a list over `kernels`). Returns the optimizer, the
    losses, the step time in s, the peak memory in GiB, the tape's op
    count and the launches read from the kernels' counts."""
    from neuronika_tpu_torch._engine.executor import _plan

    opt = optim.Adam(1e-4)
    opt.register_all(params)
    n_ops = len(_plan(loss.node)[0])
    losses = [opt.train_step(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    vals = []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        opt.train_step(loss, block=False)
        vals.append(loss.data())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = [k.launches for k in kernels]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(v) for v in vals]
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    check(launches == want, f"{phase}: launches {launches}, want {want} "
                            f"({', '.join(VAR_KERNELS)})")
    return opt, losses, step_s, peak, n_ops, launches


def phase_var_flagship(nk, T, optim, FA, MM, SM, profile=None):
    """Phase 8: `build_var_model_batched` at d1536 L8 H12 V16384 S2048 B16
    bf16 with the kernels on; Adam(1e-4) fused steps on the bench's loss.
    Per step: K1 twice a layer (forward, and again in the flash VJP for its
    lse), the fused K2 once a layer, K4 once (the loss head), no K3."""
    B, S, n = 16, 2048, 5
    cfg = T.GPTConfig(dtype=torch.bfloat16, dropout=0.0, flash_block=512,
                      **VAR_FLAGSHIP)
    nk.enable_kernels(True)
    np.random.seed(0)
    params, fwd = T.build_var_model_batched(cfg, batch=B, seq=S,
                                            device="cuda")
    V, L = cfg.vocab_size, cfg.n_layer
    ids = np.random.randint(0, V, (B, S)).astype("float32")
    tgt = np.roll(ids, -1, axis=1).reshape(-1)
    loss = fwd(nk.from_ndarray(ids, device="cuda")).reshape(
        (B * S, V)).log_softmax(1).t().nll(
        nk.from_ndarray(tgt, device="cuda"), nk.Reduction.Mean)
    want = [2 * L * n, L * n, 0, n]
    opt, losses, step_s, peak, n_ops, launches = var_train(
        optim, params, loss, n, var_kernels(FA, MM, SM), want, "phase 8")
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    print(f"phase 8 Var flagship: build_var_model_batched d1536 L8 H12 "
          f"V16384 S2048 B16 bf16, Adam(1e-4) train_step, kernels on: step "
          f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f} (of "
          f"989 TFLOP/s), peak {peak:.2f} GiB, {n_ops} tape ops; losses "
          f"{[round(l, 4) for l in losses]}; launches in {n} steps: K1 "
          f"{launches[0]}, fused K2 {launches[1]}, K3 {launches[2]}, K4 "
          f"{launches[3]}")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_step(lambda: opt.train_step(loss), "one Var flagship step",
                     f"{root}_var{ext}")
    del params, fwd, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    nk.enable_kernels(False)
    return dict(zip(VAR_KERNELS, launches))


def legacy_counts(cfg):
    """K3 and K4 launches of one step of `build_var_model`: per layer the
    q, k, v, output and three MLP products plus 2 per head (the MLP's
    first product is recorded twice, as the JAX builder writes it), and
    the LM head; each `mm` VJP runs two more. K4: one softmax per head and
    layer, and the loss's log-softmax."""
    fwd = cfg.n_layer * (7 + 2 * cfg.n_head) + 1
    return 3 * fwd, cfg.n_layer * cfg.n_head + 1


def phase_var_legacy(nk, T, optim, FA, MM, SM, profile=None):
    """Phase 9: `build_var_model` at d768 L8 H6 V16384 S1024 f32 with the
    kernels on: every `mm` on K3, every softmax on K4."""
    S, n = 1024, 5
    cfg = T.GPTConfig(dtype=torch.float32, **VAR_LEGACY)
    nk.enable_kernels(True)
    np.random.seed(0)
    params, fwd = T.build_var_model(cfg, batch=1, seq=S, device="cuda")
    ids = np.random.randint(0, cfg.vocab_size, (S,)).astype("float32")
    loss = fwd(nk.from_ndarray(ids, device="cuda")).log_softmax(1).t().nll(
        nk.from_ndarray(np.roll(ids, -1), device="cuda"), nk.Reduction.Mean)
    k3, k4 = legacy_counts(cfg)
    want = [0, 0, k3 * n, k4 * n]
    opt, losses, step_s, peak, n_ops, launches = var_train(
        optim, params, loss, n, var_kernels(FA, MM, SM), want, "phase 9")
    tok_s = S / step_s
    flops = T.flops_per_token(cfg, S) * tok_s
    print(f"phase 9 Var 2-d model: build_var_model d768 L8 H6 V16384 S1024 "
          f"f32, Adam(1e-4) train_step, kernels on: step "
          f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU "
          f"{flops / 989e12:.4f} (of 989 TFLOP/s; {flops / 67e12:.4f} of the "
          f"67 TFLOP/s f32 peak), peak {peak:.2f} GiB, {n_ops} tape ops; "
          f"losses {[round(l, 4) for l in losses]}; launches in {n} steps:"
          f" K3 {launches[2]} ({k3 // 3} forward and {2 * k3 // 3} in VJPs a"
          f" step), K4 {launches[3]}")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_step(lambda: opt.train_step(loss), "one Var 2-d step",
                     f"{root}_var2d{ext}")
    del params, fwd, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    nk.enable_kernels(False)
    return dict(zip(VAR_KERNELS, launches))


# phase 10: small models of both kinds, hd 128 so the flash op takes K1/K2
VAR_ROUTE_CFG = dict(vocab_size=512, n_layer=2, n_head=2, d_model=256,
                     d_ff=1024, max_seq=256)


def phase_var_routes(nk, T, FA, MM, SM):
    """Phase 10: the Var tier's kernel route (on the card, kernels on: K1,
    the fused K2, K3 and K4) against its plain route (the same graph on
    the CPU, every op plain), f32, for a small `build_var_model_batched`
    (d256 H2 hd128 L2 S256 B2) and a small `build_var_model` (d256 H2 L2
    S256): the loss and every parameter gradient, within phase 7's bounds
    (two exact routes that differ in summation order only)."""
    cfg = T.GPTConfig(dtype=torch.float32, dropout=0.0, **VAR_ROUTE_CFG)
    B, S, V, L = 2, 256, cfg.vocab_size, cfg.n_layer
    kernels = var_kernels(FA, MM, SM)
    k3, k4 = legacy_counts(cfg)
    rng = np.random.default_rng(4)
    errs = {}
    for name, build, batch, shape, want in (
            ("batched", T.build_var_model_batched, B, (B, S),
             [2 * L, L, 0, 1]),
            ("2-d", T.build_var_model, 1, (S,), [0, 0, k3, k4])):
        ids = rng.integers(0, V, size=shape).astype(np.float32)
        tgt = np.roll(ids, -1, axis=-1).reshape(-1)
        res = {}
        for dev in ("cpu", "cuda"):
            nk.enable_kernels(dev == "cuda")
            np.random.seed(1)
            params, fwd = build(cfg, batch=batch, seq=S, device=dev)
            logits = fwd(nk.from_ndarray(ids, device=dev))
            loss = logits.reshape((-1, V)).log_softmax(1).t().nll(
                nk.from_ndarray(tgt, device=dev), nk.Reduction.Mean)
            before = [k.launches for k in kernels]
            loss.forward()
            loss.backward(1.0)
            torch.cuda.synchronize()
            used = [k.launches - b for k, b in zip(kernels, before)]
            res[dev] = (loss.item(), [p.grad().cpu() for p in params], used)
        nk.enable_kernels(False)
        check(res["cuda"][2] == want, f"phase 10 {name}: launches "
                                      f"{res['cuda'][2]}, want {want}")
        d_loss = abs(res["cuda"][0] - res["cpu"][0])
        d_grad = max(float((a - b).abs().max())
                     for a, b in zip(res["cuda"][1], res["cpu"][1]))
        errs[name] = (res["cpu"][0], d_loss, d_grad)
        check(d_loss <= ROUTE_LOSS_TOL,
              f"phase 10 {name}: loss {res['cuda'][0]} vs {res['cpu'][0]}")
        check(d_grad <= ROUTE_GRAD_TOL, f"phase 10 {name}: grad err "
                                        f"{d_grad}")
    print("phase 10 Var kernel route (card) vs plain route (CPU): f32 d256 "
          "H2 hd128 L2 S256; loss, |d loss|, max |d grad|: "
          + ", ".join(f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                      for k, (a, b, c) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")


# split-layout flash cases (K5-K7): (name, B, H, Sq, Skv, causal, window,
# hd); windows cut the 64-row tiles anywhere or cover all of S; then the
# bf16 K6/K7 geometry (64-row steps, 128-row CTAs): windows on either side
# of a step or a CTA, ragged S with a window below 128, and full attention
# ragged on both sides; then phase 17's T5 shapes (H12 hd64): the
# decoder's causal self-attention at S128 and cross-attention at Sq 128
# over Skv 512, and greedy generation's steps, causal at Sq = Skv 1 to 8
# and cross-attention at Sq 1 to 8 over Skv 512 (less than one q tile)
SPLIT_CASES = (
    ("causal-hd128", 2, 4, 512, 512, True, 0, 128),
    ("window1-hd128", 2, 4, 512, 512, True, 1, 128),
    ("window6-hd64", 2, 4, 512, 512, True, 6, 64),
    ("window100-hd128-S1000", 2, 4, 1000, 1000, True, 100, 128),
    ("window-ge-S-hd64", 2, 4, 512, 512, True, 600, 64),
    ("full-Sq300-Skv777-hd128", 2, 4, 300, 777, False, 0, 128),
    ("full-Sq512-Skv256-hd64", 2, 4, 512, 256, False, 0, 64),
    *((f"window{w}-hd{hd}-S384", 2, 4, 384, 384, True, w, hd)
      for w, hd in ((63, 128), (64, 64), (65, 128), (127, 64), (128, 128),
                    (129, 64))),
    ("window100-hd128-S129", 2, 4, 129, 129, True, 100, 128),
    ("window37-hd64-S1000", 2, 4, 1000, 1000, True, 37, 64),
    ("full-Sq130-Skv1000-hd128", 2, 4, 130, 1000, False, 0, 128),
    ("t5-causal-S128-hd64", 2, 12, 128, 128, True, 0, 64),
    ("t5-full-Sq128-Skv512-hd64", 2, 12, 128, 512, False, 0, 64),
    *((f"t5-causal-S{n}-hd64", 2, 12, n, n, True, 0, 64) for n in (1, 5, 8)),
    *((f"t5-full-Sq{n}-Skv512-hd64", 2, 12, n, 512, False, 0, 64)
      for n in (1, 5, 8)),
)
# f32: the same math in another summation order (dq, dk, dv sum up to S
# products per element: their bound is relative to the largest gradient
# entry, at least 1)
SPLIT_F32_TOL = {"out": 1e-5, "grads": 2e-5}
# bf16: both sides round p and ds to bf16 at the same points but sum in
# other orders, so a rounding flips by one ulp (2^-8 relative) here and
# there. Each entry is held as FLASH_BF16_REL, but those bounds sit above
# a typical entry at long S, so each of out, dq, dk and dv is also held in
# norm to the values compared: ||a - ref|| <= SPLIT_BF16_REL ||ref|| +
# SPLIT_BF16_FLOOR sqrt(numel). The floor is for gradients that are f32
# rounding noise around 0 (window 1: dq = dk = 0, up to ~3e-6 an entry).
# At B2 H32 S8192 window 4096 an entry of out or dq is ~0.026, and the
# planted faults that check_split reads there (split_faults) must fail
# this bound.
SPLIT_BF16_REL, SPLIT_BF16_FLOOR = 1e-2, 2 ** -15
# (batch, head) pairs per plain-version call: its (S, S) f32 scores
SPLIT_HEADS = 8
LOG2E = 1.4426950408889634
# FLOPs per in-band (q row, k row) pair: K5 s and p.v; K6 s, dp and ds.k;
# K7 s, dp, p^T.do and ds^T.q
SPLIT_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dq": 6,
                        "flash_bwd_dkv": 8}
# hd-wide rows each kernel must move once: q, k, v (and do) read, out (dq;
# dk and dv) written; besides, f32 lse (and delta) per q row
SPLIT_ROWS_MOVED = {"flash_fwd": (4, 1), "flash_bwd_dq": (5, 2),
                    "flash_bwd_dkv": (6, 2)}


def band_pairs(S, causal, window):
    """(q, k) pairs of one (batch, head) in the band, Sq == Skv == S when
    causal: what the kernels must compute."""
    if not causal:
        return S * S
    w = min(window or S, S)
    return w * (w + 1) // 2 + (S - w) * w


def split_bound(name, B, H, S, hd, causal, window):
    """bound_ms of one split kernel on bf16 (B, H, S, hd) inputs."""
    rows, f32_rows = SPLIT_ROWS_MOVED[name]
    nbytes = B * H * S * (rows * hd * 2 + f32_rows * 4)
    flops = SPLIT_FLOPS_PER_PAIR[name] * hd * B * H * band_pairs(
        S, causal, window)
    return bound_ms(nbytes, flops, torch.bfloat16), flops


def split_case(g, B, H, Sq, Skv, hd, dtype, strided=True):
    """q, k, v and do on the card; strided: every other head of a wider
    tensor, as the model hands over v."""
    def rand(S):
        t = torch.randn(B, 2 * H if strided else H, S, hd, generator=g,
                        device="cuda").to(dtype)
        return t[:, ::2] if strided else t

    return rand(Sq), rand(Skv), rand(Skv), rand(Sq)


def diff_stats(a, ref):
    """[||a - ref||^2, ||ref||^2, max |a - ref|, max |ref|, numel]."""
    d = a.double() - ref.double()
    return np.array([float(d.square().sum()),
                     float(ref.double().square().sum()),
                     float(d.abs().max()), float(ref.abs().max()),
                     d.numel()])


def norm_reading(stats):
    """Stats of the chunks of one tensor -> (||a - ref|| / ||ref||, the
    bf16 bound on that ratio, max |a - ref|, max |ref|)."""
    s = np.array(stats)
    e2, r2, n = s[:, 0].sum(), s[:, 1].sum(), s[:, 4].sum()
    ref = max(float(np.sqrt(r2)), 1e-30)
    return (float(np.sqrt(e2)) / ref,
            SPLIT_BF16_REL + SPLIT_BF16_FLOOR * float(np.sqrt(n)) / ref,
            float(s[:, 2].max()), float(s[:, 3].max()))


def band_p(q, k, lse, i0, j0, window):
    """The kernels' p = exp2(min(s - lse, 0)) of q rows i0.. against k rows
    j0.. in f32, 0 outside the causal band of `window` > 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5 * LOG2E)
    rows = i0 + torch.arange(q.shape[2], device=q.device)[:, None]
    cols = j0 + torch.arange(k.shape[2], device=q.device)[None, :]
    keep = (cols <= rows) & (rows - cols < window)
    return torch.exp2(torch.clamp(s - lse[..., None], max=0.0)) * keep


def split_faults(q, k, v, do, out, lse, delta, dq, dk, dv, window):
    """What three planted faults would return, from the kernels' results on
    one chunk of heads (causal, `window` > 0, S/2 >= 64):
    K5 skipping k rows S/2 .. S/2 + 63 (one k tile) for every q row; K6
    writing 0 past q row 511; K7 missing q rows S/2 .. S/2 + 31 (half of
    one of its 64-row q steps) from every dk and dv row."""
    S, sc = q.shape[2], q.shape[-1] ** -0.5
    j = slice(S // 2, S // 2 + 64)
    p = band_p(q, k[:, :, j], lse, 0, j.start, window)
    c = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, j].float())
    out_f = (out.float() - c) / (1 - p.sum(-1, keepdim=True))
    dq_f = dq.clone()
    dq_f[:, :, 512:] = 0
    i = slice(S // 2, S // 2 + 32)
    p = band_p(q[:, :, i], k, lse[:, :, i], i.start, 0, window)
    dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, i].float(), v.float())
    ds = p * (dp - delta[:, :, i, None]) * sc
    dk_f = dk.float() - torch.einsum("bhqk,bhqd->bhkd", ds,
                                     q[:, :, i].float())
    dv_f = dv.float() - torch.einsum("bhqk,bhqd->bhkd", p,
                                     do[:, :, i].float())
    return out_f, dq_f, dk_f, dv_f


def check_split(FA, key, q, k, v, do, causal, window, faults=False, seed=0,
                rate=0.0):
    """K5, K6 and K7 against their plain versions on one input, with
    attention dropout at `rate` from `seed`, the plain versions run on
    SPLIT_HEADS (batch, head) pairs at a time (with dropout on the whole
    input at once, as the mask keys by absolute batch and head); raises on
    a mismatch. With `faults`,
    also reads split_faults' planted faults against the same plain
    versions and raises unless each fails the bf16 bound. Returns {kernel
    name: max abs err} and the plain (lse, delta)."""
    B, H = q.shape[:2]
    parts = [(slice(b, b + 1), slice(h, h + SPLIT_HEADS))
             for b in range(B) for h in range(0, H, SPLIT_HEADS)]
    if rate:
        parts = [(slice(0, B), slice(0, H))]
    names = ("out", "dq", "dk", "dv")
    stats = {n: [] for n in names}
    fault = {n: [] for n in names}
    drop = dict(seed=seed, rate=rate)
    out, lse = FA.flash_fwd(q, k, v, causal, window=window, **drop)
    rout, rlse = torch.empty_like(out), torch.empty_like(lse)
    for c in parts:
        rout[c], rlse[c] = FA.flash_attention_fwd_reference(
            q[c], k[c], v[c], causal, window=window, **drop)
        stats["out"].append(diff_stats(out[c], rout[c]))
    delta = (do.float() * rout.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, rlse, delta, causal, window=window,
                         **drop)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, rlse, delta, causal,
                              window=window, **drop)
    for c in parts:
        args = (q[c], k[c], v[c], do[c])
        want = FA.flash_attention_bwd_reference(
            *args, rlse[c], delta[c], causal, window=window, **drop)
        for n, a, w in zip(names[1:], (dq[c], dk[c], dv[c]), want):
            stats[n].append(diff_stats(a, w))
        if faults:
            for n, a, w in zip(names, split_faults(
                    *args, out[c], rlse[c], delta[c], dq[c], dk[c], dv[c],
                    window), (rout[c],) + want):
                fault[n].append(diff_stats(a, w))
        del want
    torch.cuda.synchronize()
    e_lse = float((lse - rlse).abs().max())
    got = {n: norm_reading(stats[n]) for n in names}
    del out, rout, lse, dq, dk, dv
    errs = {"flash_fwd": got["out"][2], "flash_bwd_dq": got["dq"][2],
            "flash_bwd_dkv": max(got["dk"][2], got["dv"][2])}
    print(f"  {key}: ||err||/||ref|| " + ", ".join(
        f"{n} {got[n][0]:.3g} (bound {got[n][1]:.3g})" for n in names)
          + f"; max abs err out {errs['flash_fwd']:.3g}, lse {e_lse:.3g}, "
          f"dq {errs['flash_bwd_dq']:.3g}, dk/dv {errs['flash_bwd_dkv']:.3g}")
    kname = dict(zip(names, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                             "flash_bwd_dkv")))
    f32 = q.dtype == torch.float32
    top = max(got[n][3] for n in names[1:])
    for n in names:
        if f32:
            tol = (SPLIT_F32_TOL["out"] if n == "out" else
                   SPLIT_F32_TOL["grads"] * max(1.0, top))
        else:
            tol = (FLASH_BF16_REL["out"] * float(v.float().abs().max())
                   if n == "out" else FLASH_BF16_REL["d_qkv"] * top)
            check(got[n][0] <= got[n][1], f"{kname[n]} {key}: {n} "
                  f"||err||/||ref|| {got[n][0]} > {got[n][1]}")
        check(got[n][2] <= tol, f"{kname[n]} {key}: {n} max abs err "
                                f"{got[n][2]} > {tol}")
    check(e_lse <= (F32_TOL if f32 else 1e-3),
          f"flash_fwd {key}: lse err {e_lse}")
    if faults:
        read = {n: norm_reading(fault[n]) for n in names}
        S = q.shape[2]
        print(f"  {key} planted faults, ||err||/||ref||: out with k rows "
              f"{S // 2}..{S // 2 + 63} skipped {read['out'][0]:.3g}, dq 0 "
              f"past row 511 {read['dq'][0]:.3g}, dk {read['dk'][0]:.3g} "
              f"and dv {read['dv'][0]:.3g} without q rows {S // 2}.."
              f"{S // 2 + 31}")
        for n in names:
            check(read[n][0] > read[n][1], f"{key}: a planted fault in {n} "
                  f"reads {read[n][0]} <= bound {read[n][1]}")
    return errs, (rlse, delta)


def sdpa_band_ms(q, k, v, do, window):
    """Times of F.scaled_dot_product_attention on (B, H, S, hd) q, k, v
    with the causal band as a boolean mask (is_causal for window 0), and of
    its backward to q, k, v (one `torch.autograd.grad` over the saved
    graph). Timed only: the port never calls it."""
    import torch.nn.functional as F

    S = q.shape[2]
    mask, causal = None, True
    if window:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        causal = False
    xs = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*xs, attn_mask=mask,
                                              is_causal=causal)

    f_ms = cuda_ms(fwd, 5)
    out = fwd()
    b_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, do,
                                               retain_graph=True), 5)
    del out
    return f_ms, b_ms


def phase_split_flash(FA):
    """Phase 3, split-layout flash part: K5, K6 and K7 against their plain
    versions over the small cases, then checked and timed at B1 H8 S8192
    hd128 window 4096 bf16 (beside the plain versions and SDPA; the times
    the JSON line reports), then checked, with the planted faults read, and
    timed alone at phase 11's shape (B2 H32 S8192; the errors the JSON line
    reports). Returns {kernel: (max_abs_err at B2 H32, ms, plain_ms,
    library_ms, bound at B1 H8)}."""
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, H, Sq, Skv, causal, window, hd in SPLIT_CASES:
            q, k, v, do = split_case(g, B, H, Sq, Skv, hd, dtype)
            check_split(FA, f"{str(dtype)[6:]}/{name}", q, k, v, do, causal,
                        window)
    B, H, S, hd, W = 1, 8, 8192, 128, 4096
    q, k, v, do = split_case(g, B, H, S, S, hd, torch.bfloat16, False)
    _, (lse, delta) = check_split(FA, "bfloat16/B1-H8-S8192-hd128-w4096",
                                  q, k, v, do, True, W)
    kern = {"flash_fwd": lambda: FA.flash_fwd(q, k, v, window=W),
            "flash_bwd_dq": lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    window=W),
            "flash_bwd_dkv": lambda: FA.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, window=W)}
    plain = {"flash_fwd": lambda: FA.flash_attention_fwd_reference(
                 q, k, v, window=W),
             "bwd": lambda: FA.flash_attention_bwd_reference(
                 q, k, v, do, lse, delta, window=W)}
    # plain, kernel, kernel, plain; one plain backward computes dq, dk, dv
    p_a = {n: cuda_ms(fn, 2) for n, fn in plain.items()}
    k_ms = {n: min(cuda_ms(fn, 5), cuda_ms(fn, 5)) for n, fn in kern.items()}
    p_ms = {n: min(cuda_ms(fn, 2), p_a[n]) for n, fn in plain.items()}
    torch.cuda.empty_cache()
    lib_fwd, lib_bwd = sdpa_band_ms(q, k, v, do, W)
    timed, line = {}, []
    for name, ms in k_ms.items():
        bound, flops = split_bound(name, B, H, S, hd, True, W)
        plain_ms = p_ms["flash_fwd" if name == "flash_fwd" else "bwd"]
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        timed[name] = (ms, plain_ms, lib, bound)
        line.append(f"{name} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
                    f"vs plain {plain_ms:.3f} ms, SDPA {lib:.3f} ms, bound "
                    f"{bound[0]:.3f} ms ({bound[1]})")
    print("phase 3 kernels: split flash attention within bounds (f32 "
          f"max abs {SPLIT_F32_TOL}, bf16 each entry {FLASH_BF16_REL} of max "
          f"and in norm {SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an "
          f"entry); bf16 B1 H8 S8192 hd128 "
          f"causal window 4096 ({band_pairs(S, True, W)} pairs a head): "
          + "; ".join(line) + " (the plain backward and SDPA's backward "
          "compute dq, dk and dv together)")
    del q, k, v, do, lse, delta, kern, plain
    torch.cuda.empty_cache()

    B, H = 2, 32
    q, k, v, do = split_case(g, B, H, S, S, hd, torch.bfloat16, False)
    errs, (lse, delta) = check_split(
        FA, "bfloat16/B2-H32-S8192-hd128-w4096", q, k, v, do, True, W,
        faults=True)
    torch.cuda.empty_cache()
    # each CTA of K5, K6 and K7 owns its output rows: two launches, same
    # bits
    for name, fn in (("flash_fwd", lambda: FA.flash_fwd(q, k, v, window=W)),
                     ("flash_bwd_dq", lambda: (FA.flash_bwd_dq(
                         q, k, v, do, lse, delta, window=W),)),
                     ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(
                         q, k, v, do, lse, delta, window=W))):
        a, b = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{name} B2 H32 S8192: two launches on the same inputs differ")
        del a, b
    torch.cuda.empty_cache()
    kern = {"flash_fwd": lambda: FA.flash_fwd(q, k, v, window=W),
            "flash_bwd_dq": lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    window=W),
            "flash_bwd_dkv": lambda: FA.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, window=W)}
    line = []
    for name, fn in kern.items():
        ms = cuda_ms(fn, 5)
        bound, flops = split_bound(name, B, H, S, hd, True, W)
        line.append(f"{name} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                    f"bound {bound[0]:.3f} ms ({bound[1]})")
    print(f"phase 3 kernels: split flash alone at phase 11's shape, bf16 B2 "
          f"H32 S8192 hd128 window 4096 ({B * H * band_pairs(S, True, W)} "
          f"pairs; K5, K6 and K7 bit-identical over two launches): "
          + "; ".join(line))
    del q, k, v, do, lse, delta, kern
    torch.cuda.empty_cache()
    return {n: (errs[n],) + t for n, t in timed.items()}


# attention dropout (phase 3): two rates, two seeds each (one above 2^32,
# so that the seed's high word keys the hash too); every dropout body is
# held against its plain twin under each, at its case's bounds
DROPOUT_DRAWS = ((0.1, 11), (0.1, 2 ** 40 + 3), (0.5, 12),
                 (0.5, 2 ** 63 + 5))
# the split cases run with dropout: windows across the bf16 walks' steps,
# ragged S and Sq != Skv
DROPOUT_SPLIT = ("window6-hd64", "window100-hd128-S1000",
                 "full-Sq300-Skv777-hd128", "window65-hd128-S384",
                 "window37-hd64-S1000", "full-Sq130-Skv1000-hd128")


def readout_masks(FA, dtype, hd, rate, seed):
    """Each forward kernel's dropout mask read back and held equal to
    `keep_mask` bit for bit. With q = 0 every score is 0, so p = 1 on each
    row's band and l counts it; with v one-hot on a key range of width hd
    (v[j, j % hd] = 1), out[i, j % hd] = keep(i, j) / ((1 - rate) l): it
    is nonzero exactly where key j is kept in row i's band. K1 on packed
    GQA (B2 H4 KV2 S300, causal and full), K5 with a window (S300 w77) and
    with Sq 130 != Skv 300; every key range of S. Returns the entries
    compared."""
    n_cmp = 0

    def held(name, got, want):
        nonlocal n_cmp
        check(torch.equal(got, want), f"{name} {str(dtype)[6:]} hd{hd} "
              f"rate {rate} seed {seed}: mask read back differs from "
              f"keep_mask in {int((got != want).sum())} entries")
        n_cmp += got.numel()

    B, H, KV, S = 2, 4, 2, 300
    G = H // KV
    i = torch.arange(S, device="cuda")
    for causal in (True, False):
        keep = FA.keep_mask(seed, B, H, S, S, rate, "cuda")
        if causal:
            keep &= i[None, :] <= i[:, None]
        for j0 in range(0, S, hd):
            idx = torch.arange(j0, min(S, j0 + hd), device="cuda")
            qkv = torch.zeros(B, S, KV, G + 2, hd, device="cuda")
            qkv[:, :, :, G] = torch.randn(B, S, KV, hd, device="cuda")
            qkv[:, idx, :, G + 1, idx % hd] = 1.0
            out, _ = FA.flash_fwd_qkv(qkv.reshape(B, S, -1).to(dtype), H, KV,
                                      causal, seed=seed, rate=rate)
            got = out.view(B, S, H, hd).permute(0, 2, 1, 3)[..., idx % hd]
            held("flash_fwd_qkv", got != 0, keep[..., idx])
    for Sq, causal, window in ((S, True, 77), (130, False, 0)):
        keep = FA.keep_mask(seed, B, H, Sq, S, rate, "cuda")
        if causal:
            keep &= ((i[None, :] <= i[:, None])
                     & (i[:, None] - i[None, :] < window))
        for j0 in range(0, S, hd):
            idx = torch.arange(j0, min(S, j0 + hd), device="cuda")
            q = torch.zeros(B, H, Sq, hd, device="cuda", dtype=dtype)
            k = torch.randn(B, H, S, hd, device="cuda").to(dtype)
            v = torch.zeros(B, H, S, hd, device="cuda")
            v[:, :, idx, idx % hd] = 1.0
            out, _ = FA.flash_fwd(q, k, v.to(dtype), causal, window=window,
                                  seed=seed, rate=rate)
            held("flash_fwd", out[..., idx % hd] != 0, keep[..., idx])
    return n_cmp


def phase_dropout_kernels(FA):
    """Phase 3, attention dropout: every flash kernel with dropout against
    its plain twin (same `keep_mask`) at its case's bounds, over
    DROPOUT_DRAWS: K1, K2a+K2b and the fused K2 on FLASH_CASES in f32 and
    bf16, K5-K7 on DROPOUT_SPLIT; each forward kernel's mask read back bit
    for bit (readout_masks); then each kernel checked at rate 0.1 and timed
    with and without dropout at the table shapes (bf16 B16 S2048 H12 hd128
    causal fast; B1 H8 S8192 hd128 window 4096). Returns {kernel name:
    (max abs err at rate 0.1 at its table shape, ms with dropout, ms
    without)}."""
    rng = np.random.default_rng(7)
    g = torch.Generator(device="cuda").manual_seed(7)
    n_cases = n_cmp = 0
    for rate, seed in DROPOUT_DRAWS:
        for dtype in (torch.float32, torch.bfloat16):
            for name, H, KV, hd, S, causal, fast in FLASH_CASES:
                qkv, do = flash_case(rng, 2, H, KV, hd, S, dtype)
                check_flash(FA, f"{str(dtype)[6:]}/{name}/rate{rate}/seed"
                            f"{seed}", qkv, do, H, KV, causal, fast,
                            seed=seed, rate=rate)
                n_cases += 1
            for case in SPLIT_CASES:
                name, B, H, Sq, Skv, causal, window, hd = case
                if name not in DROPOUT_SPLIT:
                    continue
                q, k, v, do = split_case(g, B, H, Sq, Skv, hd, dtype)
                check_split(FA, f"{str(dtype)[6:]}/{name}/rate{rate}/seed"
                            f"{seed}", q, k, v, do, causal, window,
                            seed=seed, rate=rate)
                n_cases += 1
            for hd in (64, 128):
                n_cmp += readout_masks(FA, dtype, hd, rate, seed)
    torch.cuda.empty_cache()

    out = {}
    rate, seed = 0.1, 5
    drop = dict(seed=seed, rate=rate)
    B, H, S, hd = 16, 12, 2048, 128
    qkv, do = flash_case(rng, B, H, H, hd, S, torch.bfloat16)
    errs, (o, lse), _ = check_flash(
        FA, "bfloat16/headline-B16-S2048-mha-hd128-causal-fast/rate0.1", qkv,
        do, H, H, True, True, seed=seed, rate=rate)
    torch.cuda.empty_cache()
    d_qkv = torch.empty_like(qkv)
    st = FA.flash_bwd_stats_qkv(qkv, o, lse, do, H)
    kern = {"flash_fwd_qkv": lambda **d: FA.flash_fwd_qkv(
                qkv, H, fast_softmax=True, **d),
            "flash_bwd_dq_qkv": lambda **d: FA.flash_bwd_dq_qkv(
                qkv, o, lse, do, d_qkv, H, stats=st, **d),
            "flash_bwd_dkv_qkv": lambda **d: FA.flash_bwd_dkv_qkv(
                qkv, o, lse, do, d_qkv, H, stats=st, **d),
            "flash_bwd_fused_qkv": lambda **d: FA.flash_bwd_fused_qkv(
                qkv, o, lse, do, H, **d)}
    for name, fn in kern.items():    # without, with, with, without
        a = cuda_ms(fn, 5)
        d = min(cuda_ms(lambda: fn(**drop), 5), cuda_ms(lambda: fn(**drop),
                                                           5))
        out[name] = (errs[name], d, min(a, cuda_ms(fn, 5)))
    del qkv, do, o, lse, d_qkv, st, kern
    torch.cuda.empty_cache()

    B, H, S, hd, W = 1, 8, 8192, 128, 4096
    q, k, v, do = split_case(g, B, H, S, S, hd, torch.bfloat16, False)
    errs, (lse, delta) = check_split(
        FA, "bfloat16/B1-H8-S8192-hd128-w4096/rate0.1", q, k, v, do, True, W,
        seed=seed, rate=rate)
    torch.cuda.empty_cache()
    kern = {"flash_fwd": lambda **d: FA.flash_fwd(q, k, v, window=W, **d),
            "flash_bwd_dq": lambda **d: FA.flash_bwd_dq(
                q, k, v, do, lse, delta, window=W, **d),
            "flash_bwd_dkv": lambda **d: FA.flash_bwd_dkv(
                q, k, v, do, lse, delta, window=W, **d)}
    for name, fn in kern.items():
        a = cuda_ms(fn, 5)
        d = min(cuda_ms(lambda: fn(**drop), 5), cuda_ms(lambda: fn(**drop),
                                                           5))
        out[name] = (errs[name], d, min(a, cuda_ms(fn, 5)))
    del q, k, v, do, lse, delta, kern
    torch.cuda.empty_cache()
    print(f"phase 3 kernels: attention dropout within the cases' bounds "
          f"against the plain twins ({n_cases} cases over rates and seeds "
          f"{DROPOUT_DRAWS}); K1 and K5 masks read back equal to keep_mask "
          f"in all {n_cmp} entries; at rate 0.1 (bf16 B16 S2048 H12 hd128 "
          f"causal fast; B1 H8 S8192 hd128 window 4096), with vs without "
          f"dropout: " + "; ".join(
              f"{n} {d:.3f} vs {a:.3f} ms (+{(d / a - 1) * 100:.0f}%, max "
              f"abs err {e:.3g})" for n, (e, d, a) in out.items()))
    return out


# Mistral 7B's published widths (Jiang et al. 2023, "Mistral 7B", Table 1;
# window 4096 from mistral_config), depth cut from 32 to 4 layers: f32
# params, grads and Adam state of all 32 layers (~116 GB) exceed the 80 GB
# card
MISTRAL_7B = dict(vocab_size=32000, n_layer=4, n_head=32, n_kv_head=8,
                  d_model=4096, d_ff=14336, max_seq=8192)


def phase_mistral(T, FA, CE, profile):
    """Phase 11: the Mistral 7B train step (4 layers, S 8192, B 2, bf16,
    the GPTConfig defaults). Returns the timed steps' launch counts."""
    rng = np.random.default_rng(0)
    B, S, n = 2, 8192, 5
    cfg = T.mistral_config(dtype=torch.bfloat16, **MISTRAL_7B)

    def batch():
        toks = rng.integers(0, cfg.vocab_size, size=(B, S))
        return (torch.from_numpy(toks).to("cuda"),
                torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))

    path = None
    if profile:
        root, ext = os.path.splitext(profile)
        path = f"{root}_mistral{ext}"
    losses, launches, step_s, peak, held = train_steps(
        T, train_kernels(FA, CE), cfg, 2, n, batch(), 3e-4, path,
        "one Mistral 7B (L4) step", heldout=batch())
    L = cfg.n_layer
    check(all(np.isfinite(losses)), f"phase 11: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"phase 11: loss did not fall: {losses}")
    # the steps repeat one batch, which the model memorises; on fresh
    # uniform tokens nothing that cannot see its target beats ln(V)
    # (a leak through the causal band or the window would)
    check(held >= 0.9 * np.log(cfg.vocab_size),
          f"phase 11: held-out loss {held} < 0.9 ln(V): the model sees its "
          f"targets")
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=2 * L * n, flash_bwd_dq=L * n, flash_bwd_dkv=L * n)
    check(launches == want, f"phase 11: launches {launches}, want {want}")
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    print(f"phase 11 train: Mistral 7B widths (d4096 H32 KV8 hd128 d_ff "
          f"14336 V32000 window 4096) at L4, S8192 B2 bf16, remat, f32 Adam: "
          f"step {step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} (of 989 TFLOP/s, flops_per_token), peak {peak:.2f} "
          f"GiB; losses {[round(l, 4) for l in losses]}, on a fresh batch "
          f"{held:.4f} (ln V {np.log(cfg.vocab_size):.4f}); launches in {n} "
          f"steps: K5 {launches['flash_fwd']}, K6 "
          f"{launches['flash_bwd_dq']}, K7 {launches['flash_bwd_dkv']}")
    # one step at dropout 0.1, 2 layers: K5-K7's dropout at full width;
    # then the same step without dropout, for its cost
    steps = {}
    for rate in (0.1, 0.0):
        cfg = T.mistral_config(dtype=torch.bfloat16, dropout=rate,
                               **dict(MISTRAL_7B, n_layer=2))
        steps[rate] = train_steps(T, train_kernels(FA, CE), cfg, 1, 1,
                                  batch(), 3e-4)
    losses, d_launches, d_step_s, d_peak, _ = steps[0.1]
    L = cfg.n_layer
    want = dict.fromkeys(d_launches, 0)
    want.update(flash_fwd=2 * L, flash_bwd_dq=L, flash_bwd_dkv=L)
    check(all(np.isfinite(losses)), f"phase 11 dropout: loss {losses}")
    check(d_launches == want,
          f"phase 11 dropout: launches {d_launches}, want {want}")
    print(f"phase 11 train at dropout=0.1, L2 (in-kernel in K5-K7), 1 warm-up"
          f" and 1 timed step: {d_step_s * 1e3:.1f} ms (without dropout "
          f"{steps[0.0][2] * 1e3:.1f} ms), peak {d_peak:.2f} GiB, losses "
          f"{[round(l, 4) for l in losses]}; launches K5 "
          f"{d_launches['flash_fwd']}, K6 {d_launches['flash_bwd_dq']}, K7 "
          f"{d_launches['flash_bwd_dkv']}")
    return launches


def phase_split_routes(T, FA):
    """Phase 12: the split kernel route (K5-K7) against the plain route
    (flash="off") in f32 on small llama and Mistral models: d256, 2 heads
    over 1 kv head (hd 128), L 2, S 256, Mistral's window 100."""
    errs = {}
    for name, preset, kw in (("llama", T.llama_config, {}),
                             ("mistral", T.mistral_config,
                              dict(window=100))):
        cfg0 = preset(vocab_size=512, n_layer=2, n_head=2, n_kv_head=1,
                      d_model=256, d_ff=512, max_seq=256,
                      dtype=torch.float32, remat=False, **kw)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(2),
                               cfg0, "cuda")
        ref = route_run(T, params, cfg0, FA.SPLIT_KERNELS, flash="off")
        run = route_run(T, params, cfg0, FA.SPLIT_KERNELS, flash="on")
        L = cfg0.n_layer
        check(ref[2] == [0, 0, 0] and run[2] == [L, L, L],
              f"phase 12 {name}: launches {run[2]}, want {[L] * 3}")
        errs[name] = (ref[0],) + route_errs(f"phase 12 {name}", ref, run)
    print("phase 12 split kernel route vs plain route: f32 d256 H2 KV1 "
          "hd128 L2 S256 B2; loss, |d loss|, max |d grad| per leaf: "
          + ", ".join(f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                      for k, (a, b, c) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")


# --------------------------------------------------------------------------
# the conv tier: K12-K15 (phase 3), ResNet-18 training (phase 13), kernel
# routes against plain routes (phase 14)

# small and ragged cases: (name, kernel, x shape (channels last), w shape
# (*taps, Ci/groups, Co), stride, dilation, groups); "k12-1d" is a strided
# 1-d conv, which runs on K12
CONV_CASES = (
    ("s1", "k12", (2, 13, 12, 8), (3, 3, 8, 16), (1, 1), (1, 1), 1),
    ("s2", "k12", (2, 13, 12, 8), (3, 3, 8, 16), (2, 2), (1, 1), 1),
    ("s3", "k12", (2, 16, 15, 8), (3, 3, 8, 16), (3, 3), (1, 1), 1),
    ("dil2-co300", "k12", (2, 14, 14, 8), (3, 3, 8, 300), (1, 1), (2, 2), 1),
    ("g2", "k12", (2, 10, 10, 8), (3, 3, 4, 12), (1, 1), (1, 1), 2),
    ("g4-s2", "k12", (2, 10, 10, 16), (3, 3, 4, 8), (2, 2), (1, 1), 4),
    ("ci3-7x7-s2", "k12", (2, 230, 230, 3), (7, 7, 3, 64), (2, 2), (1, 1), 1),
    ("1x1-s2", "k12", (4, 56, 56, 64), (1, 1, 64, 128), (2, 2), (1, 1), 1),
    ("ragged-ci256", "k12", (3, 29, 31, 256), (3, 3, 256, 200), (1, 1),
     (1, 1), 1),
    ("conv1d-d2", "k14", (2, 333, 64), (3, 64, 72), (1,), (2,), 1),
    ("conv1d-s2", "k12-1d", (2, 333, 64), (3, 64, 72), (2,), (1,), 1),
    # bf16 on the Hopper K14 (conv_route "sm90"): Ci and Co tails with
    # dilation 2, tiles across samples, the table's widths at batch 2,
    # (k - 1) d = 32768 (the rank-3 corner range); past it, conv.cu's
    ("conv1d-tails-d2", "k14", (2, 333, 72), (3, 72, 136), (1,), (2,), 1),
    ("conv1d-samples", "k14", (7, 45, 32), (3, 32, 64), (1,), (1,), 1),
    ("conv1d-table-B2", "k14", (2, 3138, 256), (3, 256, 256), (1,), (1,),
     1),
    ("conv1d-corner32768", "k14", (1, 32833, 8), (3, 8, 16), (1,),
     (16384,), 1),
    ("conv1d-corner32769", "k14", (1, 32835, 8), (2, 8, 8), (1,),
     (32769,), 1),
    ("conv3d-d2", "k15", (2, 9, 10, 11, 16), (3, 2, 3, 16, 24), (1, 1, 1),
     (2, 1, 2), 1),
    # bf16 on the Hopper K15 (conv_route "sm90"): the table's taps and
    # widths at batch 3 with a ragged box, Ci and Co tails with dilation 2,
    # (k - 1) d = 16 (the rank-5 corner range); past it, conv.cu's kernel
    ("conv3d-k3-c128", "k15", (3, 7, 9, 8, 128), (3, 3, 3, 128, 128),
     (1, 1, 1), (1, 1, 1), 1),
    ("conv3d-tails-d2", "k15", (2, 12, 12, 12, 72), (3, 3, 3, 72, 136),
     (1, 1, 1), (2, 2, 1), 1),
    ("conv3d-corner16", "k15", (1, 20, 6, 6, 8), (3, 1, 1, 8, 8), (1, 1, 1),
     (8, 1, 1), 1),
    ("conv3d-corner18", "k15", (1, 22, 6, 6, 8), (3, 1, 1, 8, 8), (1, 1, 1),
     (9, 1, 1), 1),
    # on the Hopper K12 in bf16 (conv_route "sm90"): ResNet-18's stride-1
    # stage convs at batch 2, stage 1's dx (the padded gradient), tiles
    # spanning samples, Ci and Co tails, non-square taps with dilation
    ("stage1-B2", "k12", (2, 58, 58, 64), (3, 3, 64, 64), (1, 1), (1, 1), 1),
    ("stage2-B2", "k12", (2, 30, 30, 128), (3, 3, 128, 128), (1, 1), (1, 1),
     1),
    ("stage3-B2", "k12", (2, 16, 16, 256), (3, 3, 256, 256), (1, 1), (1, 1),
     1),
    ("stage4-B2", "k12", (2, 9, 9, 512), (3, 3, 512, 512), (1, 1), (1, 1),
     1),
    ("stage1-dx-B2", "k12", (2, 60, 60, 64), (3, 3, 64, 64), (1, 1), (1, 1),
     1),
    ("samples", "k12", (7, 7, 7, 32), (3, 3, 32, 64), (1, 1), (1, 1), 1),
    ("tails", "k12", (3, 11, 13, 200), (3, 3, 200, 200), (1, 1), (1, 1), 1),
    ("k3x2-dil2x1", "k12", (2, 13, 11, 24), (3, 2, 24, 136), (1, 1), (2, 1),
     1),
)
# K13: (name, x shape, g shape, (kh, kw), dilation)
DW_CASES = (
    ("k3", (3, 10, 10, 24), (3, 8, 8, 20), (3, 3), (1, 1)),
    ("k3-dil2", (2, 12, 11, 8), (2, 8, 7, 16), (3, 3), (2, 2)),
    ("k1", (4, 28, 28, 64), (4, 28, 28, 128), (1, 1), (1, 1)),
    ("resnet-stage1-B16", (16, 58, 58, 64), (16, 56, 56, 64), (3, 3),
     (1, 1)),
    ("stage4-B2", (2, 9, 9, 512), (2, 7, 7, 512), (3, 3), (1, 1)),
    ("dil2", (2, 14, 15, 64), (2, 10, 11, 128), (3, 3), (2, 2)),
    ("samples", (7, 7, 7, 32), (7, 5, 5, 64), (3, 3), (1, 1)),
    ("tails", (3, 11, 13, 200), (3, 9, 11, 72), (3, 3), (1, 1)),
    ("k3x2-dil2x1", (2, 13, 11, 24), (2, 9, 10, 136), (3, 2), (2, 1)),
)


def conv_call(C, kind, x, w, stride, dilation, groups):
    """The kernel wrapper a case runs."""
    if kind == "k12":
        return C.conv2d_direct_nhwc(x, w, dilation, stride, groups=groups)
    if kind in ("k14", "k12-1d"):
        return C.conv1d_direct_nwc(x, w, dilation[0], stride[0])
    return C.conv3d_direct_ndhwc(x, w, dilation)


def conv_within(out, ref, key, dtype):
    """A K12-K15 or K13 result against its plain version, by the inputs'
    `dtype`. f32: each entry within 1e-5 of max(1, max |ref|) (the same
    products summed in another order). bf16: each entry within one bf16
    ulp of max |ref| and in norm ||out - ref|| <= SPLIT_BF16_REL ||ref|| +
    SPLIT_BF16_FLOOR sqrt(numel); K12, K14 and K15 round one f32 sum on
    both sides, and K13's f32 output sums up to 200,704 products a CTA
    split at a time in the tensor cores' accumulator, which does not round
    as FFMA does. Returns (max abs err, ||err||/||ref||, its bound)."""
    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{key}: kernel gave {out.dtype} {tuple(out.shape)}, plain "
          f"{ref.dtype} {tuple(ref.shape)}")
    top = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    rel, bound, _, _ = norm_reading([diff_stats(out, ref)])
    if dtype == torch.float32:
        tol = F32_TOL * max(1.0, top)
    else:
        tol = bf16_ulp(top)
        check(rel <= bound, f"{key}: ||err||/||ref|| {rel} > {bound}")
    check(err <= tol, f"{key}: max abs err {err} > {tol}")
    return err, rel, bound


def conv_fault(C, name, x, w, ref):
    """Reads one planted fault against the plain result `ref` of a stride-1,
    unit-dilation conv and raises unless it fails the norm bound: K12, K14,
    K15 dropping the first tap (the kernel run on w with that tap zeroed);
    K13 dropping the partial of its first split (the kernel run on the
    gradient, passed as w, with the pixels of that split zeroed). Returns
    the reading."""
    if name == "conv2d_dw_nhwc":
        kh, kw, ci, co = ref.shape
        _, _, chunk = C.dw_plan(kh, kw, ci, co, w[..., 0].numel(),
                                torch.promote_types(x.dtype, w.dtype))
        g0 = w.clone()
        g0.view(-1, co)[:chunk] = 0
        bad = C.conv2d_dw_nhwc(x, g0, kh, kw)
    else:
        w0 = w.clone()
        w0.view(-1, *w.shape[-2:])[0] = 0
        bad = {"conv2d_direct_nhwc": C.conv2d_direct_nhwc,
               "conv1d_direct_nwc": C.conv1d_direct_nwc,
               "conv3d_direct_ndhwc": C.conv3d_direct_ndhwc}[name](x, w0)
    rel, bound, _, _ = norm_reading([diff_stats(bad, ref)])
    check(rel > bound, f"{name}: a planted fault reads {rel} <= bound "
                       f"{bound}")
    return rel


def phase_conv_kernels(C):
    """Phase 3, conv part: K12-K15 against their plain versions over the
    small cases in f32 and bf16, then at bench.py's conv shapes in bf16
    (:817-888, SAME: the kernels on the padded input), where each runs its
    Hopper kernel, gives the same bits twice, is held against a planted
    fault and is timed beside its plain version, one library call and its
    bound. Returns {kernel: (max_abs_err, ms,
    plain_ms, library_ms, (bound_ms, bound_by))} at those shapes."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)

    errs = {}
    sm90 = dict.fromkeys((k.__name__ for k in C.KERNELS), 0)
    for k in C.KERNELS:
        k.sm90_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for name, kind, xs, ws, stride, dil, groups in CONV_CASES:
            sm90["conv2d_direct_nhwc"] += kind in ("k12", "k12-1d") and \
                C.conv_route("fwd", dtype, xs[-1], ws[-1], groups,
                             ((1,) + stride)[-2:], ((1,) + dil)[-2:],
                             ((1,) + ws[:-2])[-2:]) == "sm90"
            sm90["conv1d_direct_nwc"] += kind == "k14" and C.conv_route(
                "fwd", dtype, xs[-1], ws[-1], groups, stride, dil,
                ws[:1]) == "sm90"
            sm90["conv3d_direct_ndhwc"] += kind == "k15" and C.conv_route(
                "fwd", dtype, xs[-1], ws[-1], groups, stride, dil,
                ws[:3]) == "sm90"
            x, w = rnd(*xs, dtype=dtype), rnd(*ws, dtype=dtype, scale=0.1)
            errs[f"{dt}/{name}"] = conv_within(
                conv_call(C, kind, x, w, stride, dil, groups),
                C.conv_nd_reference(x, w, stride, dil, groups),
                f"{kind} {dt}/{name}", dtype)[:2]
        for name, xs, gs, k, dil in DW_CASES:
            sm90["conv2d_dw_nhwc"] += C.dw_plan(
                *k, xs[-1], gs[-1], math.prod(gs[:-1]), dtype,
                dil)[0] == "sm90"
            x, gg = rnd(*xs, dtype=dtype), rnd(*gs, dtype=dtype)
            errs[f"{dt}/dw-{name}"] = conv_within(
                C.conv2d_dw_nhwc(x, gg, *k, dil),
                C.conv_dw_reference(x, gg, k, dil), f"k13 {dt}/{name}",
                dtype)[:2]
    torch.cuda.synchronize()
    ran = {k.__name__: k.sm90_launches for k in C.KERNELS}
    check(ran == sm90 and min(sm90.values()) > 0,
          f"phase 3: Hopper K12-K15 launches {ran}, conv_route sends "
          f"{sm90}")
    print("phase 3 kernels: conv K12-K15 within bounds (f32 1e-5 of max "
          "|entry|; bf16 one ulp of it and in norm "
          f"{SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an entry); "
          f"on the Hopper K12-K15 (csrc/conv_sm90.cu): {ran}; max "
          "abs err, ||err||/||ref||: " + ", ".join(
              f"{k} {a:.3g}, {r:.2g}" for k, (a, r) in errs.items()))

    # bench.py's shapes, SAME, bf16: (kernel, x padded, w, library call)
    B = 64
    x2 = rnd(B, 58, 58, 256)
    w2 = rnd(3, 3, 256, 256, scale=(256 * 9) ** -0.5)
    g2 = rnd(B, 56, 56, 256)
    x1 = rnd(B, 3138, 256)
    w1 = rnd(3, 256, 256, scale=(256 * 3) ** -0.5)
    x3 = rnd(32, 16, 16, 16, 128)
    w3 = rnd(3, 3, 3, 128, 128, scale=(128 * 27) ** -0.5)
    n2, n3 = x2.permute(0, 3, 1, 2), x3.permute(0, 4, 1, 2, 3)
    w2n = w2.permute(3, 2, 0, 1)
    cases = {
        "conv2d_direct_nhwc": (
            "64x56x56x256 k3", (x2, w2),
            lambda: C.conv2d_direct_nhwc(x2, w2),
            lambda: C.conv_nd_reference(x2, w2, (1, 1), (1, 1)),
            lambda: F.conv2d(n2, w2n), "F.conv2d"),
        "conv2d_dw_nhwc": (
            "64x56x56x256 k3 dw", (x2, g2),
            lambda: C.conv2d_dw_nhwc(x2, g2, 3, 3),
            lambda: C.conv_dw_reference(x2, g2, (3, 3), (1, 1)),
            lambda: torch.nn.grad.conv2d_weight(n2, w2n.shape,
                                                g2.permute(0, 3, 1, 2)),
            "torch.nn.grad.conv2d_weight"),
        "conv1d_direct_nwc": (
            "64x3136x256 k3", (x1, w1),
            lambda: C.conv1d_direct_nwc(x1, w1),
            lambda: C.conv_nd_reference(x1, w1, (1,), (1,)),
            lambda: F.conv1d(x1.transpose(1, 2), w1.permute(2, 1, 0)),
            "F.conv1d"),
        "conv3d_direct_ndhwc": (
            "32x14^3x128 k3", (x3, w3),
            lambda: C.conv3d_direct_ndhwc(x3, w3),
            lambda: C.conv_nd_reference(x3, w3, (1, 1, 1), (1, 1, 1)),
            lambda: F.conv3d(n3, w3.permute(4, 3, 0, 1, 2)), "F.conv3d"),
    }
    result, line = {}, []
    for name, (shape, ins, kern, plain, lib, lib_name) in cases.items():
        fn = getattr(C, name)
        before = fn.sm90_launches
        out, ref = kern(), plain()
        check(fn.sm90_launches == before + 1,
              f"phase 3: {name} {shape} did not run the Hopper kernel")
        err, rel, bound_n = conv_within(out, ref, f"{name} {shape}",
                                        torch.bfloat16)
        check(torch.equal(kern(), out),
              f"phase 3: {name} {shape} gave other bits a second time")
        fault = conv_fault(C, name, *ins, ref)
        n_out = out.numel()
        del out, ref
        torch.cuda.empty_cache()
        pa = cuda_ms(plain, 2)
        ka, kb = cuda_ms(kern, 10), cuda_ms(kern, 10)
        pb = cuda_ms(plain, 2)
        lib_ms = cuda_ms(lib, 10)
        torch.cuda.empty_cache()
        k_ms, p_ms = min(ka, kb), min(pa, pb)
        # FLOPs: 2 per tap product of every output entry (K13: of every
        # pixel of the gradient); bytes: each input read once, the output
        # written once (K13's in f32)
        if name == "conv2d_dw_nhwc":
            flops = 2 * g2.numel() * n_out // g2.shape[-1]
            nbytes = (x2.numel() + g2.numel()) * 2 + n_out * 4
        else:
            x, w = ins
            flops = 2 * n_out * (w.numel() // w.shape[-1])
            nbytes = (x.numel() + w.numel() + n_out) * 2
        bound = bound_ms(nbytes, flops, torch.bfloat16)
        result[name] = (err, k_ms, p_ms, lib_ms, bound)
        line.append(f"{name} {shape}: kernel {k_ms:.3f} ms "
                    f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.3f} "
                    f"ms, {lib_name} {lib_ms:.3f} ms, bound {bound[0]:.3f} ms "
                    f"({bound[1]}, {flops:.4g} FLOPs); max abs err {err:.3g}"
                    f", ||err||/||ref|| {rel:.3g} (bound {bound_n:.3g}), "
                    f"planted fault {fault:.3g}")
    del x1, x2, x3, w1, w2, w3, g2, n2, n3, w2n, cases
    torch.cuda.empty_cache()
    print("phase 3 kernels, conv at bench.py's shapes (bf16, SAME; each on "
          "its Hopper kernel, the same bits twice; faults: K12/K14/K15 "
          "without their first tap, K13 without its first split's "
          "partial): " + "; ".join(line))
    return result


# the stride-1 k3 convs of ResNet-18's four stages, (H = W, channels), each
# of which passes route_conv2d's size test at batch <= 4
ROUTE_CONV2D = ((56, 64), (28, 128), (14, 256), (7, 512))
ROUTE_CONV1D = (3136, 256)          # bench.py's conv1d shape
ROUTE_BATCHES = (1, 2, 4)


def phase_conv_route_times(C):
    """Phase 3, the conv route on the card: K12 against F.conv2d at the
    ROUTE_CONV2D shapes and K14 against F.conv1d at ROUTE_CONV1D, batch 1,
    2 and 4, forwards, bf16, SAME (the kernels on the padded input, the
    library on channels-last views of it), each on its Hopper kernel,
    checked against its plain version and timed in turns (kernel, library,
    library, kernel). Returns
    {(rank, batch, length, channels): (kernel ms, library ms)}."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    cases = []
    for B in ROUTE_BATCHES:
        for hw, ch in ROUTE_CONV2D:
            x, w = rnd(B, hw + 2, hw + 2, ch), rnd(3, 3, ch, ch,
                                                    scale=(9 * ch) ** -0.5)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            cases.append(((2, B, hw, ch), x, w,
                          functools.partial(C.conv2d_direct_nhwc, x, w),
                          functools.partial(F.conv2d, xn, wn),
                          functools.partial(C.conv_nd_reference, x, w,
                                            (1, 1), (1, 1))))
        L, ch = ROUTE_CONV1D
        x, w = rnd(B, L + 2, ch), rnd(3, ch, ch, scale=(3 * ch) ** -0.5)
        cases.append(((1, B, L, ch), x, w,
                      functools.partial(C.conv1d_direct_nwc, x, w),
                      functools.partial(F.conv1d, x.transpose(1, 2),
                                        w.permute(2, 1, 0)),
                      functools.partial(C.conv_nd_reference, x, w, (1,),
                                        (1,))))
    times, line = {}, []
    for key, x, w, kern, lib, plain in cases:
        fn = C.conv2d_direct_nhwc if key[0] == 2 else C.conv1d_direct_nwc
        before = fn.sm90_launches
        out = kern()
        check(fn.sm90_launches == before + 1,
              f"phase 3 route {key}: not on the Hopper kernel")
        conv_within(out, plain(), f"route {key}", torch.bfloat16)
        del out
        ka, la = cuda_ms(kern, 50), cuda_ms(lib, 50)
        lb, kb = cuda_ms(lib, 50), cuda_ms(kern, 50)
        times[key] = (min(ka, kb), min(la, lb))
        rank, B, n, ch = key
        line.append(f"{'conv2d' if rank == 2 else 'conv1d'} B{B} "
                    f"{n}{'x' + str(n) if rank == 2 else ''}x{ch}: kernel "
                    f"{times[key][0]:.4f} ms, library {times[key][1]:.4f} ms")
    for rank in (2, 1):
        won = sum(k < l for (r, *_), (k, l) in times.items() if r == rank)
        n = sum(r == rank for r, *_ in times)
        line.append(f"rank {rank}: the kernel faster at {won} of {n}")
    print("phase 3 conv route at batch <= 4 (bf16, SAME, forwards; "
          "K12 vs F.conv2d, K14 vs F.conv1d): " + "; ".join(line))
    return times


# --------------------------------------------------------------------------
# the fused linear cross-entropy: K8-K10 (phase 3), phase 6's fused run,
# phase 7's fused route

# small and ragged cases: (name, N, D, V); "tied" has the width of a tied
# head on a small GPT; "9-slices" cuts D into more slices than a portable
# cluster holds, so K9 and K10 run without one, each slice computing its
# own logits
CE_CASES = (("N512-D64-V1024", 512, 64, 1024),
            ("ragged-N300-D72-V1000", 300, 72, 1000),
            ("tied-N512-D256-V1024", 512, 256, 1024),
            ("9-slices-N256-D4160-V520", 256, 4160, 520),
            # bf16 K9 and K10 on the Hopper kernel (ce_grad_route "sm90"):
            # ragged N, V and D (6 slices, the last 40 wide), the head's D
            # 1536 (8 slices, one cluster) at ragged N and V
            ("ragged-N777-D1000-V555", 777, 1000, 555),
            ("ragged-N1000-D1536-V300", 1000, 1536, 300))
# phase 6's LM head: B S rows of the headline step, d_model, vocab
CE_HEAD = (16 * 2048, 1536, 16384)
CE_LINES = {"ce_fwd": 37, "ce_dx": 77, "ce_dw": 101}   # cross_entropy.py
CE_TILE = 128       # the kernels' stream tile (vocabulary or rows)


def ce_case(g, N, D, V, dtype):
    """x ~ N(0, 1) (hidden states after the final norm), w ~ 0.02 N(0, 1)
    (the init's scale), uniform targets and the backward's row weights
    1/N, on the card."""
    x = torch.randn(N, D, generator=g, device="cuda").to(dtype)
    w = (0.02 * torch.randn(V, D, generator=g, device="cuda")).to(dtype)
    t = torch.randint(0, V, (N,), generator=g, device="cuda")
    return x, w, t, torch.full((N,), 1.0 / N, device="cuda")


def ce_within(out, ref, key):
    """A K9/K10 result against its plain version, both scaled by the power
    of two that brings max |ref| into [1, 2) (exact; dx and dW are of
    order g = 1/N, under the norm bound's floor otherwise), then held by
    conv_within's rule. Returns (max abs err unscaled, ||err||/||ref||,
    its bound, the scale)."""
    scale = 2.0 ** -np.floor(np.log2(float(ref.float().abs().max())))
    err, rel, bound = conv_within(out * scale, ref * scale, key, ref.dtype)
    return float(err / scale), rel, bound, scale


def ce_pg(x, w, t, lse, g, rows, cols):
    """cast((exp(logits - lse) - onehot) g) of rows x cols of the logits,
    as the kernels and their plain versions form it (f32, then x's
    dtype)."""
    logits = x[rows].float() @ w[cols].float().T
    i = torch.arange(x.shape[0], device=x.device)[rows]
    j = torch.arange(w.shape[0], device=x.device)[cols]
    onehot = (t[i][:, None] == j[None, :]).float()
    p = torch.exp(logits - lse[rows][:, None]) - onehot
    return (p * g[rows][:, None]).to(x.dtype), logits, onehot


def check_ce(CE, key, x, w, t, g, faults=False):
    """K8, K9 and K10 against their plain versions on one input (K9 and
    K10 fed the plain lse); raises on a mismatch. K8's loss and lse are
    f32: each entry within 1e-5 of max(1, max |lse|). With `faults`, three
    planted faults are read against the same plain versions and must fail
    their bounds: K8 without a vocabulary range (on the Hopper kernel the
    last cluster rank's, as ce_fwd_plan_sm90 cuts it; else the first tile
    of CE_TILE rows), K9 without the first vocabulary tile's term, K10
    without the first row block's partial (CE_TILE rows each). Returns
    {kernel: max abs err}."""
    loss, lse = CE.ce_fwd(x, w, t)
    rloss, rlse = CE.ce_fwd_reference(x, w, t)
    dx, dw = CE.ce_dx(x, w, t, rlse, g), CE.ce_dw(x, w, t, rlse, g)
    rdx = CE.ce_dx_reference(x, w, t, rlse, g)
    rdw = CE.ce_dw_reference(x, w, t, rlse, g)
    torch.cuda.synchronize()
    top = max(1.0, float(rlse.abs().max()))
    e_fwd = max(float((loss - rloss).abs().max()),
                float((lse - rlse).abs().max()))
    check(loss.shape == lse.shape == rlse.shape and e_fwd <= F32_TOL * top,
          f"ce_fwd {key}: max abs err {e_fwd} > {F32_TOL * top}")
    got = {"ce_dx": ce_within(dx, rdx, f"ce_dx {key}"),
           "ce_dw": ce_within(dw, rdw, f"ce_dw {key}")}
    errs = {"ce_fwd": e_fwd, "ce_dx": got["ce_dx"][0],
            "ce_dw": got["ce_dw"][0]}
    text = (f"  {key}: ce_fwd {e_fwd:.3g} (tol {F32_TOL * top:.3g}); "
            + ", ".join(f"{n} {a:.3g}, ||err||/||ref|| {r:.3g} (bound "
                        f"{b:.3g})" for n, (a, r, b, _) in got.items()))
    if faults:
        tile, every = slice(0, CE_TILE), slice(None)
        N, D = x.shape
        gone = tile
        if CE.ce_fwd_route(x.dtype, D) == "sm90":
            gone = slice(*CE.ce_fwd_plan_sm90(N, w.shape[0], D)[2][-1])
        # K8: lse without the range's exp-sum; the target logit without the
        # range's targets
        _, logits, onehot = ce_pg(x, w, t, rlse, g, every, gone)
        p_gone = torch.exp(logits - rlse[:, None]).sum(-1)
        lse_f = rlse + torch.log1p(-p_gone)
        loss_f = lse_f - ((rlse - rloss) - (logits * onehot).sum(-1))
        e8 = float((loss_f - rloss).abs().max())
        check(e8 > F32_TOL * top, f"ce_fwd {key}: a planted fault reads "
                                  f"{e8} <= {F32_TOL * top}")
        pg, _, _ = ce_pg(x, w, t, rlse, g, every, tile)
        dx_f = dx.float() - pg.float() @ w[tile].float()
        pg, _, _ = ce_pg(x, w, t, rlse, g, tile, every)
        dw_f = dw.float() - pg.float().T @ x[tile].float()
        read = {}
        for n, bad, ref in (("ce_dx", dx_f, rdx), ("ce_dw", dw_f, rdw)):
            s = got[n][3]
            read[n] = norm_reading([diff_stats(bad * s, ref.float() * s)])
            check(read[n][0] > read[n][1], f"{n} {key}: a planted fault "
                  f"reads {read[n][0]} <= bound {read[n][1]}")
        del logits, onehot, pg, dx_f, dw_f
        text += (f"; planted faults: ce_fwd without vocabulary rows "
                 f"{gone.start}-{gone.stop} max abs err {e8:.3g}, ce_dx "
                 f"without vocabulary tile 0's term "
                 f"||err||/||ref|| {read['ce_dx'][0]:.3g}, ce_dw without "
                 f"row block 0 {read['ce_dw'][0]:.3g}")
    print(text)
    return errs


def ce_composite(T, cfg):
    """loss_fn's composite head as a function of (x, w, t): `_lm_head`
    (the head GEMM with an f32 result), logsumexp and the gathered target
    logit, mean over rows."""
    def run(x, w, t):
        logits = T._lm_head(x, {"wte": w}, cfg).float()
        lse = torch.logsumexp(logits, -1)
        return (lse - logits.gather(-1, t[:, None])[:, 0]).mean()

    return run


def phase_ce_kernels(CE, T):
    """Phase 3, fused CE part: K8, K9 and K10 against their plain versions
    over CE_CASES in f32 and bf16, then at phase 6's head (bf16 N 32768 D
    1536 V 16384), where the planted faults are read and each kernel is
    timed beside its plain version, the composite head (two or more calls,
    not one library call: forward, backward from its saved graph, and both)
    and its bound. Returns {kernel: (max_abs_err, ms, plain_ms,
    composite_ms, (bound_ms, bound_by))}: the composite's forward for K8,
    its backward (dx and dW together) for K9 and K10."""
    g = torch.Generator(device="cuda").manual_seed(8)
    grads = {"dx": CE.ce_dx, "dw": CE.ce_dw}
    kinds = {"fwd": CE.ce_fwd, **grads}
    routed = dict.fromkeys(kinds, 0)
    for fn in kinds.values():
        fn.sm90_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, N, D, V in CE_CASES:
            routed["fwd"] += CE.ce_fwd_route(dtype, D) == "sm90"
            for kind in grads:
                routed[kind] += CE.ce_grad_route(kind, dtype, D) == "sm90"
            check_ce(CE, f"{str(dtype)[6:]}/{name}",
                     *ce_case(g, N, D, V, dtype))
    N, D, V = CE_HEAD
    x, w, t, gr = ce_case(g, N, D, V, torch.bfloat16)
    errs = check_ce(CE, f"bfloat16/head-N{N}-D{D}-V{V}", x, w, t, gr,
                    faults=True)
    torch.cuda.empty_cache()
    _, lse = CE.ce_fwd(x, w, t)
    # K8, K9 and K10 at the head twice: the same bits (each CTA, and K8's
    # cluster merge, sum in a fixed order); K8 ran once more just above
    routed["fwd"] += 1
    for kind, fn in kinds.items():
        if kind == "fwd":
            d1, d2 = torch.stack(fn(x, w, t)), torch.stack(fn(x, w, t))
        else:
            d1, d2 = fn(x, w, t, lse, gr), fn(x, w, t, lse, gr)
        torch.cuda.synchronize()
        check(torch.equal(d1, d2), f"ce_{kind} at the head: two launches "
                                   f"differ")
        del d1, d2
        routed[kind] += 1 + 2
        check(fn.sm90_launches == routed[kind] and routed[kind] > 3,
              f"phase 3: Hopper ce_{kind} launches {fn.sm90_launches}, "
              f"the routes send {routed[kind]}")
    fns = {"ce_fwd": (lambda: CE.ce_fwd(x, w, t),
                      lambda: CE.ce_fwd_reference(x, w, t)),
           "ce_dx": (lambda: CE.ce_dx(x, w, t, lse, gr),
                     lambda: CE.ce_dx_reference(x, w, t, lse, gr)),
           "ce_dw": (lambda: CE.ce_dw(x, w, t, lse, gr),
                     lambda: CE.ce_dw_reference(x, w, t, lse, gr))}
    times = {}
    for name, (kern, plain) in fns.items():
        pa = cuda_ms(plain, 2)
        ka, kb = cuda_ms(kern, 3), cuda_ms(kern, 3)
        pb = cuda_ms(plain, 2)
        times[name] = (min(ka, kb), min(pa, pb))
        torch.cuda.empty_cache()
    comp = ce_composite(T, T.GPTConfig(vocab_size=V, d_model=D,
                                       dtype=torch.bfloat16))
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    c_fwd = cuda_ms(lambda: comp(x, w, t), 3)
    c_all = cuda_ms(lambda: torch.autograd.grad(comp(xr, wr, t), (xr, wr)),
                    3)
    saved = comp(xr, wr, t)
    c_bwd = cuda_ms(lambda: torch.autograd.grad(saved, (xr, wr),
                                                retain_graph=True), 3)
    del saved, xr, wr
    torch.cuda.empty_cache()
    # a floor for K8, not the same function: the logits product alone (x
    # W^T, bf16 operands, f32 out), which K8 computes and never stores
    mm_ms = cuda_ms(lambda: torch.mm(x, w.T, out_dtype=torch.float32), 3)
    torch.cuda.empty_cache()
    # bytes: x and w read once, targets (int32), lse and row weights (f32)
    # as a kernel reads them, its outputs written once
    io = (N * D + V * D) * 2
    nbytes = {"ce_fwd": io + N * 4 + 2 * N * 4,
              "ce_dx": io + 3 * N * 4 + N * D * 2,
              "ce_dw": io + 3 * N * 4 + V * D * 2}
    passes = {"ce_fwd": 2, "ce_dx": 4, "ce_dw": 4}
    result, line = {}, []
    for name, (k_ms, p_ms) in times.items():
        flops = passes[name] * N * V * D
        bound = bound_ms(nbytes[name], flops, torch.bfloat16)
        lib = c_fwd if name == "ce_fwd" else c_bwd
        result[name] = (errs[name], k_ms, p_ms, lib, bound)
        line.append(f"{name} {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} "
                    f"TFLOP/s) vs plain {p_ms:.3f} ms, bound "
                    f"{bound[0]:.3f} ms ({bound[1]})")
    print("phase 3 kernels: fused CE within bounds (f32 outputs and f32 "
          f"gradients 1e-5 of max |entry|; bf16 gradients one ulp of it and "
          f"in norm {SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an "
          f"entry); bf16 N{N} D{D} V{V}: " + "; ".join(line)
          + f"; composite (_lm_head + logsumexp + gather, several calls, "
          f"no single library call) forward {c_fwd:.3f} ms, backward "
          f"{c_bwd:.3f} ms, both {c_all:.3f} ms; torch.mm of the logits "
          f"alone (x W^T, f32 out; a floor, not the same function) "
          f"{mm_ms:.3f} ms; fused K8 + K9 + K10 "
          f"{sum(t[0] for t in times.values()):.3f} ms; on the Hopper "
          f"kernels (csrc/cross_entropy_sm90.cu) K8 {routed['fwd']}, K9 "
          f"{routed['dx']} and K10 {routed['dw']} times, each the same "
          f"bits twice at the head")
    del x, w, t, gr, lse, fns
    torch.cuda.empty_cache()
    return result


# ResNet-18's published widths (He et al. 2016, "Deep Residual Learning for
# Image Recognition", Table 1) with the repo's GroupNorm for BatchNorm
RESNET18 = dict(stages=(2, 2, 2, 2), width=64, num_classes=1000,
                stem="imagenet")


def resnet_conv_flops(cfg, B, size):
    """Forward conv FLOPs of one batch, counted from the shapes: 2 B Ho Wo
    kh kw Ci Co a conv, SAME padding."""
    s0, k0 = (1, 3) if cfg.stem == "cifar" else (2, 7)
    h = -(-size // s0)
    flops = 2 * B * h * h * k0 * k0 * 3 * cfg.width
    if cfg.stem == "imagenet":
        h = -(-h // 2)                        # the stem's max pool
    c_in = cfg.width
    for si, n_blocks in enumerate(cfg.stages):
        c_out = cfg.width * 2 ** si
        for bi in range(n_blocks):
            s = 2 if (bi == 0 and si > 0) else 1
            h = -(-h // s)
            flops += 2 * B * h * h * 9 * (c_in * c_out + c_out * c_out)
            if s != 1 or c_in != c_out:
                flops += 2 * B * h * h * c_in * c_out
            c_in = c_out
    return flops


def conv_launch_want(R, cfg, steps):
    """K12-K15 launches of `steps` ResNet train steps on conv_impl "pallas":
    K12 once a conv forward and once a stride-1 conv's dx (the stem's input,
    the image, needs none), K13 once a stride-1 conv's dw."""
    strides = R.conv_strides(cfg)
    dx = strides[1:].count(1)
    return {"conv2d_direct_nhwc": steps * (len(strides) + dx),
            "conv2d_dw_nhwc": steps * strides.count(1),
            "conv1d_direct_nwc": 0, "conv3d_direct_ndhwc": 0}


def conv_sm90_want(R, cfg, steps):
    """The K12 and K13 calls of `steps` bf16 ResNet train steps that
    conv_route sends to the Hopper kernels: every conv but the stem (its 3
    input channels give TMA a 6-byte row) forward, and every stride-1
    conv's dx and dw (conv_launch_want's, none of them the stem's)."""
    strides = R.conv_strides(cfg)
    s1 = strides[1:].count(1)
    return {"conv2d_direct_nhwc": steps * (len(strides) - 1 + s1),
            "conv2d_dw_nhwc": steps * s1}


def record_convs(C, run):
    """Runs `run()` with K12's and K13's wrappers, and the stride-1 dx
    around K12, wrapped to keep contiguous copies of the operands of the
    first call at each distinct shape and role: "fwd", "dx" (K12 on the
    padded gradient with the flipped, io-swapped kernel) or "dw". The
    kernels launch as usual; launches during `run` go to the wrappers'
    copies of the counters, not to the kernels' own. Returns {(role, x
    shape, w or g shape, stride or taps, dilation, groups): (x, w or g)}."""
    seen, role = {}, ["fwd"]
    k12, k13, dx = (C.conv2d_direct_nhwc, C.conv2d_dw_nhwc,
                    C.conv2d_input_grad_nhwc)

    def keep(key, x, w):
        if key not in seen:
            seen[key] = tuple(t.detach().clone(
                memory_format=torch.contiguous_format) for t in (x, w))

    @functools.wraps(k12)
    def rec12(x, w, dilation=(1, 1), stride=(1, 1), *, groups=1, **kw):
        keep((role[0], tuple(x.shape), tuple(w.shape), C._as_tuple(stride, 2),
              C._as_tuple(dilation, 2), groups), x, w)
        return k12(x, w, dilation, stride, groups=groups, **kw)

    @functools.wraps(k13)
    def rec13(x, g, kh, kw, dilation=(1, 1), **kwargs):
        keep(("dw", tuple(x.shape), tuple(g.shape), (kh, kw),
              C._as_tuple(dilation, 2), 1), x, g)
        return k13(x, g, kh, kw, dilation, **kwargs)

    @functools.wraps(dx)
    def recdx(*args, **kwargs):
        role[0] = "dx"
        try:
            return dx(*args, **kwargs)
        finally:
            role[0] = "fwd"

    C.conv2d_direct_nhwc, C.conv2d_dw_nhwc = rec12, rec13
    C.conv2d_input_grad_nhwc = recdx
    try:
        run()
    finally:
        C.conv2d_direct_nhwc, C.conv2d_dw_nhwc = k12, k13
        C.conv2d_input_grad_nhwc = dx
    return seen


def unit_scaled(t):
    """t times the power of two that brings max |t| into [1, 2): exact in
    f32 and bf16, so a kernel's result on it is its result on t, scaled."""
    top = float(t.float().abs().max())
    return t * 2.0 ** -np.floor(np.log2(top)) if top > 0 else t


def check_recorded_convs(C, records):
    """Each recorded K12/K13 call (record_convs) against its plain version
    on the same operands, each brought to unit scale by a power of two (so
    that the norm bound's floor, set for entries of order one, reads as at
    phase 3's shapes): held per entry and in norm by conv_within. Then one
    planted fault per kernel (conv_fault), read at the widest dx (K12) and
    at the dw of the fewest splits above one (K13), must fail the norm
    bound. Returns the largest max abs err
    of each kernel (in the kernel's output units at unit-scaled operands)
    and the printed readings."""
    errs = {"conv2d_direct_nhwc": 0.0, "conv2d_dw_nhwc": 0.0}
    line, faults = [], {}
    for key in sorted(records, key=str):
        role, xs, ws, st, dil, groups = key
        x, w = (unit_scaled(t) for t in records[key])
        dtype = torch.promote_types(x.dtype, w.dtype)
        if role == "dw":
            name = "conv2d_dw_nhwc"
            out = C.conv2d_dw_nhwc(x, w, *st, dil)
            ref = C.conv_dw_reference(x, w, st, dil)
        else:
            name = "conv2d_direct_nhwc"
            out = C.conv2d_direct_nhwc(x, w, dil, st, groups=groups)
            ref = C.conv_nd_reference(x, w, st, dil, groups)
        err, rel, bound = conv_within(out, ref, f"phase 13 {key}", dtype)
        errs[name] = max(errs[name], err)
        line.append(f"{role} {xs}*{ws} {'k' if role == 'dw' else 's'}"
                    f"{st[0]}: {err:.3g}, {rel:.2g}")
        # where to plant: K12's widest dx; K13's dw of the fewest splits
        # above one (a split there is the largest share of the sum), else
        # any dw
        if role == "dx":
            rank = -xs[-1]
        else:
            rank = C.dw_plan(*st, xs[-1], ws[-1], math.prod(ws[:-1]),
                             dtype, dil)[1]
            rank = rank if rank > 1 else math.inf
        if role != "fwd" and (role not in faults or rank < faults[role][0]):
            faults[role] = (rank, xs, ws, x, w, ref)
        del out, ref
    read = {}
    for role, name in (("dx", "conv2d_direct_nhwc"),
                       ("dw", "conv2d_dw_nhwc")):
        _, xs, ws, x, w, ref = faults[role]
        read[role] = (xs, ws, conv_fault(C, name, x, w, ref))
    faults.clear()
    torch.cuda.empty_cache()
    return errs, "; ".join(line), read


def phase_resnet(R, C, profile):
    """Phase 13: ResNet-18 (RESNET18, bf16, conv_impl "pallas") on 224x224
    images at batch 64 (numpy seed 0), SGD with momentum 0.9 and lr 0.1: 2
    warm-up and 5 timed steps on the repeated batch, launches held exact;
    then one more step records every K12 and K13 call's operands, held
    against the plain versions (check_recorded_convs). Returns the timed
    steps' launch counts and the largest max abs err of K12 and K13 at
    this path's shapes."""
    B, size, n = 64, 224, 5
    cfg = R.ResNetConfig(dtype=torch.bfloat16, conv_impl="pallas",
                         **RESNET18)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (B, size, size, 3)).astype(
        np.float32)).to("cuda")
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, B)).to("cuda")
    params = R.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    buf = R.momentum_init(params)
    step = R.make_train_step(cfg, momentum=0.9)
    losses = []
    for _ in range(2):
        params, buf, loss = step(params, buf, x, y, 0.1)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in C.KERNELS:
        k.launches = 0
    for k in (C.conv2d_direct_nhwc, C.conv2d_dw_nhwc):
        k.sm90_launches = 0
    t0 = time.perf_counter()
    for _ in range(n):
        params, buf, loss = step(params, buf, x, y, 0.1)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    launches = {k.__name__: k.launches for k in C.KERNELS}
    sm90 = {k.__name__: k.sm90_launches for k in (C.conv2d_direct_nhwc,
                                                  C.conv2d_dw_nhwc)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"phase 13: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"phase 13: loss did not fall: {losses}")
    want = conv_launch_want(R, cfg, n)
    check(launches == want, f"phase 13: launches {launches}, want {want}")
    want = conv_sm90_want(R, cfg, n)
    check(sm90 == want, f"phase 13: Hopper K12/K13 launches {sm90}, want "
                        f"{want}")
    flops = resnet_conv_flops(cfg, B, size)
    mfu = 3 * flops / step_s / 989e12
    print(f"phase 13 ResNet-18: imagenet stem, widths 64-512, 1000 classes, "
          f"GroupNorm, bf16, conv_impl pallas, 224x224 B64, SGD momentum 0.9 "
          f"lr 0.1: step {step_s * 1e3:.2f} ms, {B / step_s:.1f} images/s, "
          f"conv MFU {mfu:.4f} (3 x {flops:.4g} forward conv FLOPs a step, "
          f"of 989 TFLOP/s), peak {peak:.2f} GiB; losses "
          f"{[round(v, 4) for v in losses]}; launches in {n} steps: K12 "
          f"{launches['conv2d_direct_nhwc']} (on the Hopper kernel "
          f"{sm90['conv2d_direct_nhwc']}), K13 {launches['conv2d_dw_nhwc']} "
          f"(Hopper {sm90['conv2d_dw_nhwc']})")
    records = record_convs(C, lambda: step(params, buf, x, y, 0.1))
    roles = [k[0] for k in records]
    errs, line, read = check_recorded_convs(C, records)
    del records
    print(f"phase 13 K12/K13 at ResNet-18's shapes (one more step's operands, "
          f"each distinct shape: {roles.count('fwd')} forward, "
          f"{roles.count('dx')} dx, {roles.count('dw')} dw; unit-scaled by "
          f"powers of two; bf16 within one ulp of max |entry| and in norm "
          f"{SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an entry), max "
          f"abs err, ||err||/||ref||: {line}; planted faults, ||err||/||ref||"
          f": K12 dx without its first tap at {read['dx'][0]}*{read['dx'][1]}"
          f" {read['dx'][2]:.3g}, K13 without its first split's partial at "
          f"{read['dw'][0]}*{read['dw'][1]} {read['dw'][2]:.3g}")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_step(lambda: step(params, buf, x, y, 0.1),
                     "one ResNet-18 step", f"{root}_resnet{ext}")
    del params, buf, x, step
    gc.collect()
    torch.cuda.empty_cache()
    launches.update({f"{k}.sm90": v for k, v in sm90.items()})
    return launches, errs


# phase 14's Var conv graph: (name, kernel shape, input shape, stride,
# dilation, groups, (pool, window), the kernel the forward launches)
VAR_CONV_CASES = (
    ("1d-d2", (8, 4, 3), (2, 4, 40), (1,), (2,), 1, ("max_pool", (2,)),
     "conv1d_direct_nwc"),
    ("1d-s2", (8, 4, 3), (2, 4, 40), (2,), (1,), 1, ("avg_pool", (3,)),
     "conv2d_direct_nhwc"),
    ("2d-s2", (8, 4, 3, 3), (2, 4, 17, 16), (2, 2), (1, 1), 1,
     ("max_pool", (2, 2)), "conv2d_direct_nhwc"),
    ("2d-d2", (8, 4, 3, 3), (2, 4, 17, 16), (1, 1), (2, 2), 1,
     ("avg_pool", (2, 2)), "conv2d_direct_nhwc"),
    ("2d-g2", (8, 2, 3, 3), (2, 4, 12, 12), (1, 1), (1, 1), 2,
     ("max_pool", (3, 3)), "conv2d_direct_nhwc"),
    ("3d-d2", (6, 4, 2, 2, 2), (2, 4, 7, 8, 6), (1, 1, 1), (1, 2, 1), 1,
     ("avg_pool", (2, 2, 2)), "conv3d_direct_ndhwc"),
)
# bench.py:897-913, the shapes whose conv tier the JAX bench records
ROUTE_SHAPES = (
    ("conv2d_56x56x256_s1", 2, (1, 1), dict(batch=64)),
    ("conv2d_56x56x256_s2", 2, (2, 2), dict(batch=64)),
    ("conv2d_28x28x512_B4", 2, (1, 1), dict(
        batch=4, ksize=3, sample_bytes=30 * 28 * 512 * 2,
        weight_bytes=9 * 512 * 512 * 2)),
    ("conv1d_3136x256", 1, (1,), dict(batch=64)),
    ("conv1d_3136x256_B4", 1, (1,), dict(
        batch=4, ksize=3, sample_bytes=3139 * 256 * 2,
        weight_bytes=3 * 256 * 256 * 2)),
    ("conv3d_14x128", 3, (1, 1, 1), dict(batch=32)),
)


def phase_conv_routes(nk, R, C):
    """Phase 14: the conv kernel routes on the card against the plain
    routes on the CPU, f32, within phase 7's bounds: a small ResNet
    (stages (1, 1), width 16, both stems, conv_impl "pallas": K12/K13 on
    the card, their plain versions on the CPU) on its logits, loss and
    every gradient; and a small Var graph of 1-d, 2-d and 3-d convolutions,
    each pooled, under use_kernels with conv_route "force" (K12, K14, K15)
    against the library route on the CPU, on its loss and every gradient.
    Launch counts are held exact, each run's counted from 0. Then the tier
    "auto" picks for the shapes bench.py names. Last, the same route in
    bf16 on the card: a Var 3-d conv on the Hopper K15, held against its
    plain version, and a Var 1-d conv on the Hopper K14, its forward held
    against its plain version and its gradients against the plain route's.
    Returns the Var graphs' launches on the card (f32 and bf16)."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten

    def zero_counts():
        for k in C.KERNELS:
            k.launches = 0

    def counts():
        return {k.__name__: k.launches for k in C.KERNELS}

    errs = {}
    for stem, size in (("cifar", 16), ("imagenet", 32)):
        cfg = R.ResNetConfig(stages=(1, 1), width=16, num_classes=10,
                             stem=stem, conv_impl="pallas")
        params = R.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
        rng = np.random.default_rng(5)
        xv = rng.uniform(0.0, 1.0, (2, size, size, 3)).astype(np.float32)
        yv = rng.integers(0, cfg.num_classes, 2)
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            x, y = torch.from_numpy(xv).to(dev), torch.from_numpy(yv).to(dev)
            with torch.no_grad():
                logits = R.forward(p, x, cfg).cpu()
            leaves = [t.detach().clone().requires_grad_()
                      for t in tree_leaves(p)]
            zero_counts()
            loss = R.loss_fn(tree_unflatten(p, leaves), x, y, cfg)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            res[dev] = (logits, float(loss.detach()),
                        [t.cpu() for t in grads], counts())
        want = conv_launch_want(R, cfg, 1)
        check(res["cuda"][3] == want, f"phase 14 resnet-{stem}: launches "
                                      f"{res['cuda'][3]}, want {want}")
        e_logit = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        e_loss = abs(res["cuda"][1] - res["cpu"][1])
        e_grad = max(float((a - b).abs().max())
                     for a, b in zip(res["cuda"][2], res["cpu"][2]))
        errs[f"resnet-{stem}"] = (res["cpu"][1], max(e_logit, e_loss),
                                  e_grad)
        check(max(e_logit, e_loss) <= ROUTE_LOSS_TOL,
              f"phase 14 resnet-{stem}: logits/loss err {e_logit}, {e_loss}")
        check(e_grad <= ROUTE_GRAD_TOL,
              f"phase 14 resnet-{stem}: grad err {e_grad}")

    rng = np.random.default_rng(9)
    hopper = [k for k in C.KERNELS if hasattr(k, "sm90_launches")]
    arrays = [((0.2 * rng.standard_normal(ks)).astype(np.float32),
               rng.standard_normal(xs).astype(np.float32))
              for _, ks, xs, *_ in VAR_CONV_CASES]
    res = {}
    old_route = nk.config.conv_route
    for dev in ("cpu", "cuda"):
        nk.enable_kernels(dev == "cuda")
        nk.config.conv_route = "force"
        leaves, loss = [], None
        for (name, _, _, s, d, groups, (pool, win), _), (kv, xv) in zip(
                VAR_CONV_CASES, arrays):
            k = nk.from_ndarray(kv, device=dev).requires_grad()
            x = nk.from_ndarray(xv, device=dev).requires_grad()
            leaves += [k, x]
            term = getattr(k.convolution(x, s, d, groups), pool)(win).pow(
                2).mean()
            loss = term if loss is None else loss + term
        zero_counts()
        for k in hopper:
            k.sm90_launches = 0
        loss.forward()
        loss.backward(1.0)
        torch.cuda.synchronize()
        res[dev] = (loss.item(), [v.grad().cpu() for v in leaves], counts())
    hop = {f"{k.__name__}.sm90": k.sm90_launches for k in hopper}
    nk.enable_kernels(False)
    nk.config.conv_route = old_route
    want = {k.__name__: 0 for k in C.KERNELS}
    for case in VAR_CONV_CASES:
        want[case[-1]] += 1
    check(res["cuda"][2] == want, f"phase 14 Var convs: launches "
                                  f"{res['cuda'][2]}, want {want}")
    e_loss = abs(res["cuda"][0] - res["cpu"][0])
    e_grad = max(float((a - b).abs().max())
                 for a, b in zip(res["cuda"][1], res["cpu"][1]))
    errs["var-convs"] = (res["cpu"][0], e_loss, e_grad)
    check(e_loss <= ROUTE_LOSS_TOL, f"phase 14 Var convs: loss err {e_loss}")
    check(e_grad <= ROUTE_GRAD_TOL, f"phase 14 Var convs: grad err {e_grad}")

    # the forced route in bf16 on the card: the Var 3-d conv (dilation
    # (2, 1, 2), a ragged box) on the Hopper K15, held against its plain
    # version by phase 3's bf16 rule
    nk.enable_kernels(True)
    nk.config.conv_route = "force"
    kv = (0.2 * rng.standard_normal((16, 8, 3, 2, 3))).astype(np.float32)
    xv = rng.standard_normal((2, 8, 9, 10, 11)).astype(np.float32)
    kb = nk.from_ndarray(kv, dtype=torch.bfloat16, device="cuda")
    xb = nk.from_ndarray(xv, dtype=torch.bfloat16, device="cuda")
    zero_counts()
    C.conv3d_direct_ndhwc.sm90_launches = 0
    yb = kb.convolution(xb, (1, 1, 1), (2, 1, 2))
    yb.forward()
    torch.cuda.synchronize()
    nk.enable_kernels(False)
    nk.config.conv_route = old_route
    ref = C.conv_nd_reference(
        xb.data().permute(0, 2, 3, 4, 1), kb.data().permute(2, 3, 4, 1, 0),
        (1, 1, 1), (2, 1, 2)).permute(0, 4, 1, 2, 3)
    e_bf16 = conv_within(yb.data(), ref, "phase 14 bf16 Var conv3d",
                         torch.bfloat16)
    k15 = (C.conv3d_direct_ndhwc.launches,
           C.conv3d_direct_ndhwc.sm90_launches)
    check(k15 == (1, 1) and sum(counts().values()) == 1,
          f"phase 14 bf16 Var conv3d: launches {counts()}, Hopper K15 "
          f"{k15[1]}, want one launch, on the Hopper kernel")
    launches = {**res["cuda"][2], **hop}
    launches["conv3d_direct_ndhwc"] += 1
    launches["conv3d_direct_ndhwc.sm90"] += 1

    # a bf16 Var 1-d conv (channels multiples of 8, dilation 2, output
    # positions ragged against the 128-row tiles) under "force" on the
    # Hopper K14 against the plain route (the library convolution) on the
    # card: the forward held against its plain version by phase 3's bf16
    # rule; the loss sum(y * G) hands both routes' backwards (the library's
    # transposed convolutions) the same output gradient G, so their
    # gradients are held to each other by the same rule
    kv = (0.2 * rng.standard_normal((24, 16, 3))).astype(np.float32)
    xv = rng.standard_normal((3, 16, 150)).astype(np.float32)
    gv = rng.standard_normal((3, 24, 146)).astype(np.float32)
    var1d = {}
    for forced in (True, False):
        nk.enable_kernels(forced)
        nk.config.conv_route = "force" if forced else old_route
        kb = nk.from_ndarray(kv, dtype=torch.bfloat16,
                             device="cuda").requires_grad()
        xb = nk.from_ndarray(xv, dtype=torch.bfloat16,
                             device="cuda").requires_grad()
        yb = kb.convolution(xb, (1,), (2,))
        loss = (yb * nk.from_ndarray(gv, dtype=torch.bfloat16,
                                     device="cuda")).sum()
        zero_counts()
        C.conv1d_direct_nwc.sm90_launches = 0
        loss.forward()
        loss.backward(1.0)
        torch.cuda.synchronize()
        var1d[forced] = (yb.data(), kb.grad(), xb.grad(), counts(),
                         C.conv1d_direct_nwc.sm90_launches)
    nk.enable_kernels(False)
    nk.config.conv_route = old_route
    y1, dk1, dx1, n1, k14 = var1d[True]
    check(n1["conv1d_direct_nwc"] == 1 and k14 == 1
          and sum(n1.values()) == 1 and sum(var1d[False][3].values()) == 0,
          f"phase 14 bf16 Var conv1d: launches {n1}, Hopper K14 {k14} "
          f"(plain route {var1d[False][3]}), want one launch, on the "
          f"Hopper kernel, and none on the plain route")
    ref = C.conv_nd_reference(xb.data().transpose(1, 2),
                              kb.data().permute(2, 1, 0), (1,),
                              (2,)).transpose(1, 2)
    e_1d = [conv_within(y1, ref, "phase 14 bf16 Var conv1d", torch.bfloat16)]
    for key, a, b in (("dk", dk1, var1d[False][1]),
                      ("dx", dx1, var1d[False][2])):
        e_1d.append(conv_within(a, b, f"phase 14 bf16 Var conv1d {key}",
                                torch.bfloat16))
    launches["conv1d_direct_nwc"] += 1
    launches["conv1d_direct_nwc.sm90"] += 1

    nk.config.conv_route = "auto"
    routes = {name: C.route_conv2d(nd, stride, (1,) * nd, 1, on_card=True,
                                   **kw)
              for name, nd, stride, kw in ROUTE_SHAPES}
    nk.config.conv_route = old_route
    print("phase 14 conv kernel routes (card) vs plain routes (CPU), f32: "
          "ResNet stages (1, 1) width 16 B2 (cifar 16x16, imagenet 32x32), "
          "conv_impl pallas; Var graph of 1-d, 2-d (stride, dilation, "
          "groups) and 3-d convolutions, each pooled, kernels on with "
          "conv_route force; loss, |d logits or loss|, max |d grad|: "
          + ", ".join(f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                      for k, (a, b, c) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL}); launches "
          f"{res['cuda'][2]} (Var graph); bf16 Var conv3d on the Hopper "
          f"K15 (conv_route force): max abs err {e_bf16[0]:.3g}, "
          f"||err||/||ref|| {e_bf16[1]:.3g} (bound {e_bf16[2]:.3g}); "
          f"bf16 Var conv1d on the Hopper K14 (forward against its plain "
          f"version; dk, dx against the plain route's): max abs err, "
          f"||err||/||ref|| (bound) "
          + ", ".join(f"{a:.3g}, {r:.3g} ({b:.3g})" for a, r, b in e_1d)
          + "; "
          f"conv_route auto on the card "
          f"picks {json.dumps(routes)} (the JAX package's table with its "
          f"rank-2 row on the library, as phase 3's batch 1-4 timings "
          f"decide)")
    return launches


# phase 15: the define-by-run layer kit through the JAX package's three
# examples' twins and the reference's conv x optimizer sweep
# (BASELINE.md:21-24). The kernels the kit reaches, in the order the JSON
# line names them
KIT_KERNELS = ("matmul", "softmax", "conv2d_direct_nhwc",
               "conv1d_direct_nwc", "conv3d_direct_ndhwc")
# the sweep: (name, kernel shape, input shape, stride, dilation, groups);
# the stride-1 convs take K14 and K15 under conv_route "force", the
# strided, dilated, grouped 1-d conv the library (tests/
# test_torch_gradcheck_sweep.py runs the same cases on the CPU against JAX)
KIT_SWEEP_CASES = (
    ("conv1d_grouped", (4, 2, 3), (2, 4, 12), (2,), (2,), 2),
    ("conv1d", (4, 4, 3), (2, 4, 12), (1,), (1,), 1),
    ("conv3d", (4, 2, 2, 2, 2), (2, 2, 5, 5, 5), (1, 1, 1), (1, 1, 1), 1),
)
KIT_SWEEP_LAUNCH = {"conv1d": "conv1d_direct_nwc",
                    "conv3d": "conv3d_direct_ndhwc"}
# the sweep's kernels after 8 steps, card against CPU: both routes are f32
# and differ in summation order only, and every update is at most about
# lr = 1e-2 an entry; held to phase 7's gradient bound. Muon's is looser:
# its Newton-Schulz iteration over the conv3d kernel's 2 x 2 slices (slope
# 3.4445 at 0, five times) amplifies a rounding difference about 3x a step
# (on the CPU, the kernels' plain versions against the library route: 4e-8
# after one step, 1.7e-5 after eight); 1e-3 is 60 times that and a tenth
# of one step of lr 1e-2
KIT_PARAM_TOL = ROUTE_GRAD_TOL
KIT_MUON_TOL = 1e-3


def kit_optimizers(optim):
    """The ten optimizers of the sweep, each at lr 1e-2."""
    return {
        "sgd": lambda: optim.StochasticGD(0.01),
        "sgd_nesterov": lambda: optim.StochasticGD(0.01, momentum=0.9,
                                                   nesterov=True),
        "adam": lambda: optim.Adam(0.01),
        "amsgrad": lambda: optim.AMSGrad(0.01),
        "adamw": lambda: optim.AdamW(0.01),
        "lion": lambda: optim.Lion(0.01),
        "adafactor": lambda: optim.Adafactor(0.01),
        "muon": lambda: optim.Muon(0.01),
        "adagrad": lambda: optim.Adagrad(0.01),
        "rmsprop": lambda: optim.RMSProp(0.01, alpha=0.9, momentum=0.5,
                                         centered=True),
    }


def phase_layer_kit(nk, C, MM, SM, card):
    """Phase 15: the layer kit on the card under `enable_kernels()`, every
    run's launches counted from 0 and summed:
    (a) the quickstart twin, 5 epochs (3->5->5->1, SGD with L2(0.0),
        batches of 2 with drop_last, the model's JSON round trip): finite
        losses, K3 exactly 3 launches an `mm_t` a step (its forward and
        its VJP's two products); then one forward and backward of its
        network on its first batch, the same weights on the card's kernel
        route and the CPU's plain route, the loss and every parameter
        gradient within phase 7's bounds;
    (b) MnistCNN at its class defaults (channels 16, hidden 64, dropout
        0.25, 28 x 28), batch 64, Adam(1e-3, L2(1e-4)), 3 epochs of 256
        synthetic digits, conv_route "force": the loss falls; K12 twice a
        step, K3 6 and K4 once, exactly; the step time and peak memory
        (and how far it rose above what earlier phases left allocated);
        then in eval mode the same weights and batch on the card's kernel
        route against the CPU's plain route, the loss and every parameter
        gradient within phase 7's bounds;
    (c) CharRNN, LSTM and GRU cells, hidden 96, batch 8, lengths 8/12/16
        in turn, Adam(1e-2), 30 steps: the loss falls; K3 9 T launches a
        step of length T (3 cell and readout products a character, each
        with its two VJP products), K4 T; then one CharRNN loss of each
        cell on fixed windows (T 16), card kernels against CPU plain as in
        (b); then nn.LSTM and nn.GRU (the scan ops, plain torch on both
        devices, so no hand-written kernel) on the card against the CPU
        within the same bounds;
    and every K3 and K4 call of the route checks' card runs is recorded
    (the first at each shape, layout and mode) and held against its plain
    version there, by phase 3's rule (`within`);
    (d) the sweep: each case's kernel trained 8 steps by each of the ten
        optimizers on the card (kernels on, "force") and on the CPU (the
        plain route): the loss falls on the card, and the card's kernel
        after 8 steps matches the CPU's within KIT_PARAM_TOL (Muon's
        within KIT_MUON_TOL).
    Returns the launches summed over (a)-(d)'s training runs (the route
    checks' launches are not counted), and the conv kernels' launches among
    them on the Hopper kernels (under "name.sm90"; none, since the kit is
    f32)."""
    from neuronika_tpu_torch import models, nn, optim
    from neuronika_tpu_torch.examples import char_rnn, mnist_cnn, quickstart
    from neuronika_tpu_torch.examples import on_device
    from neuronika_tpu_torch.ops import functional as F

    fns = (MM.matmul, SM.softmax_last_axis, *C.KERNELS)
    sm90 = [k for k in C.KERNELS if hasattr(k, "sm90_launches")]

    def zero_counts():
        for f in fns:
            f.launches = 0
        for f in sm90:
            f.sm90_launches = 0

    def counts():
        got = {f.__name__: f.launches for f in fns}
        got["softmax"] = got.pop("softmax_last_axis")
        return {k: got.get(k, 0) for k in KIT_KERNELS}

    total = dict.fromkeys(KIT_KERNELS, 0)
    total_sm90 = {f"{k.__name__}.sm90": 0 for k in sm90}

    def run(fn, want, what):
        """fn() on the card from counts of 0: checks the launches against
        `want` (kernel -> count, others 0), and that no conv ran on a Hopper
        kernel (f32 takes conv.cu), and adds them to the total."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        exp = {k: want.get(k, 0) for k in KIT_KERNELS}
        check(got == exp, f"phase 15 {what}: launches {got}, want {exp}")
        for k, v in got.items():
            total[k] += v
        hop = {f"{k.__name__}.sm90": k.sm90_launches for k in sm90}
        check(not any(hop.values()), f"phase 15 {what}: f32 convs on the "
                                     f"Hopper kernels: {hop}")
        for k, v in hop.items():
            total_sm90[k] += v
        return out

    # the first K3 and K4 operands at each shape, layout and mode that the
    # route checks' card runs hand the kernels (through the op registry's
    # own references to the wrappers)
    seen_mm, seen_sm = {}, {}

    def rec_mm(a, b, **kw):
        key = (tuple(a.shape), a.stride(), tuple(b.shape), b.stride(),
               a.dtype)
        if key not in seen_mm:
            seen_mm[key] = (a.detach().clone(), b.detach().clone())
        return MM.matmul(a, b, **kw)

    def rec_sm(x, *, log=False, **kw):
        key = (tuple(x.shape), log, x.dtype)
        if key not in seen_sm:
            seen_sm[key] = x.detach().clone()
        return SM.softmax_last_axis(x, log=log, **kw)

    def route_check(build, loss_of, want, what):
        """One forward and backward of loss_of(model), the model built by
        build() with the same weights, on the card's kernel route and the
        CPU's plain route, each inside on_device: the card's launches held
        to `want` (not counted in the total), its K3 and K4 operands
        recorded, and the loss and every parameter gradient within phase
        7's bounds. Returns (CPU loss, |d loss|, max |d grad|)."""
        with on_device("cpu"):
            weights = [p.data().numpy() for p in build().parameters()]
        res = {}
        for dev in ("cpu", "cuda"):
            nk.enable_kernels(dev == "cuda")
            with on_device(dev):
                m = build()
                nn.params_from_jax(m, weights)
                orig = F.kernel_matmul, F.softmax_last_axis
                if dev == "cuda":
                    F.kernel_matmul, F.softmax_last_axis = rec_mm, rec_sm
                try:
                    loss = loss_of(m)
                    zero_counts()
                    loss.forward()
                    loss.backward(1.0)
                    torch.cuda.synchronize()
                finally:
                    F.kernel_matmul, F.softmax_last_axis = orig
            res[dev] = (loss.item(), [p.grad().cpu() for p in m.parameters()],
                        counts())
        nk.enable_kernels(True)
        exp = {k: want.get(k, 0) for k in KIT_KERNELS}
        check(res["cuda"][2] == exp, f"phase 15 {what} route: launches "
                                     f"{res['cuda'][2]}, want {exp}")
        e_loss = abs(res["cuda"][0] - res["cpu"][0])
        e_grad = max(float((a - b).abs().max())
                     for a, b in zip(res["cuda"][1], res["cpu"][1]))
        check(e_loss <= ROUTE_LOSS_TOL and e_grad <= ROUTE_GRAD_TOL,
              f"phase 15 {what} route: |d loss| {e_loss}, max |d grad| "
              f"{e_grad}")
        return res["cpu"][0], e_loss, e_grad

    def route_note(r):
        return (f"loss {r[0]:.6f}, |d loss| {r[1]:.3g}, max |d grad| "
                f"{r[2]:.3g}")

    old_route = nk.config.conv_route
    nk.enable_kernels(True)
    nk.config.conv_route = "force"
    lines = []

    # (a) 5 epochs of 2 batches, 3 Linear layers a batch
    qs = run(lambda: quickstart.main(device="cuda", steps=5, verbose=False),
             {"matmul": 5 * 2 * 3 * 3}, "quickstart")
    check(all(np.isfinite(qs)), f"phase 15 quickstart: losses {qs}")

    def quickstart_loss(m):
        x, y = next(iter(quickstart.load_dataset().batch(2).drop_last()))
        return nn.loss.mse_loss(m.forward(nk.from_ndarray(x)),
                                nk.from_ndarray(y), nn.loss.Reduction.Mean)

    qr = route_check(quickstart.NeuralNetwork, quickstart_loss,
                     {"matmul": 3 * 3}, "quickstart")
    lines.append(f"(a) quickstart twin 3-5-5-1, SGD, 5 epochs: losses "
                 f"{[round(l, 4) for l in qs]}, K3 {5 * 2 * 3 * 3}; its "
                 f"first batch, card vs CPU: {route_note(qr)}")

    # (b) MnistCNN at its defaults: a 1-epoch warm-up, then 3 timed epochs
    cnn = dict(channels=16, hidden=64, dropout=0.25, image=28, n=256,
               batch=64, verbose=False)
    mnist_cnn.main(device="cuda", steps=1, **cnn)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    steps = 3 * 256 // 64
    t0 = time.perf_counter()
    ml = run(lambda: mnist_cnn.main(device="cuda", steps=3, **cnn),
             {"conv2d_direct_nhwc": 2 * steps, "matmul": 6 * steps,
              "softmax": steps}, "MnistCNN")
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(ml)) and ml[-1] < ml[0],
          f"phase 15 MnistCNN: losses {ml}")
    rng = np.random.default_rng(7)
    X, Y = mnist_cnn.synthetic_digits(64, rng)

    def mnist_loss(m):
        m.eval()
        return m.forward(nk.from_ndarray(X)).log_softmax(1).t().nll(
            nk.from_ndarray(Y), nk.Reduction.Mean)

    mr = route_check(models.MnistCNN, mnist_loss,
                     {"conv2d_direct_nhwc": 2, "matmul": 6, "softmax": 1},
                     "MnistCNN eval")
    lines.append(
        f"(b) MnistCNN c16 h64 p0.25 28x28 B64, Adam(1e-3, L2(1e-4)), 3 "
        f"epochs of 256, conv_route force: losses {ml[0]:.4f} -> "
        f"{ml[-1]:.4f}; step {step_ms:.2f} ms (host wall time, 12 steps), "
        f"peak {peak:.3f} GiB, {peak - base:.3f} above the {base:.3f} GiB "
        f"allocated before the run; eval route card vs CPU: "
        f"{route_note(mr)} (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")

    # (c) CharRNN, 30 steps over lengths 8, 12, 16 in turn
    lengths = (8, 12, 16)
    chars_t = sum(lengths[s % 3] for s in range(30))
    for cell in ("lstm", "gru"):
        t0 = time.perf_counter()
        cl = run(lambda: char_rnn.main(device="cuda", steps=30, cell=cell,
                                       lengths=lengths, sample=0,
                                       verbose=False),
                 {"matmul": 9 * chars_t, "softmax": chars_t},
                 f"CharRNN {cell}")
        rnn_ms = (time.perf_counter() - t0) / 30 * 1e3
        check(all(np.isfinite(cl)) and np.mean(cl[-3:]) < np.mean(cl[:3]),
              f"phase 15 CharRNN {cell}: losses {cl}")
        lines.append(f"(c) CharRNN {cell} h96 B8, Adam(1e-2), 30 steps: "
                     f"loss {np.mean(cl[:3]):.4f} -> {np.mean(cl[-3:]):.4f} "
                     f"(mean of the first and last 3), step {rnn_ms:.1f} ms "
                     f"(host wall time), K3 {9 * chars_t}, K4 {chars_t}")
    # one CharRNN loss a cell on fixed windows of the twin's text, T 16 B8
    vocab = sorted(set(char_rnn.TEXT))
    ids = np.array([vocab.index(c) for c in char_rnn.TEXT], dtype=np.int64)
    starts = np.random.default_rng(11).integers(0, len(ids) - 17, size=8)
    tokens = np.stack([ids[s:s + 16] for s in starts])
    target = np.stack([ids[s + 1:s + 17] for s in starts])
    rnn_route = {}
    for cell in ("lstm", "gru"):
        rnn_route[cell] = route_check(
            lambda: models.CharRNN(len(vocab), 96, cell),
            lambda m: m.loss(tokens, target),
            {"matmul": 9 * 16, "softmax": 16}, f"CharRNN {cell}")
    lines.append("(c) CharRNN h96 on fixed windows T16 B8, card vs CPU: "
                 + ", ".join(f"{k} {route_note(r)}"
                             for k, r in rnn_route.items())
                 + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL}); K3 "
                 f"{9 * 16}, K4 16 each")
    # the K3 and K4 calls of (a)-(c)'s route checks, each against its plain
    # version at the shape the path gave it
    mm_err = sm_err = 0.0
    for (sa, _, sb, _, _), (a, b) in seen_mm.items():
        mm_err = max(mm_err, within(MM.matmul(a, b), MM.matmul_reference(
            a, b), f"phase 15 matmul {sa} @ {sb}")[0])
    for (sx, log, _), x in seen_sm.items():
        sm_err = max(sm_err, within(
            SM.softmax_last_axis(x, log=log),
            SM.softmax_last_axis_reference(x, log=log),
            f"phase 15 softmax {sx} log={log}")[0])
    check(seen_mm and seen_sm, "phase 15: no K3 or K4 call recorded")
    lines.append(
        f"K3 at the {len(seen_mm)} shapes and layouts, K4 at the "
        f"{len(seen_sm)} shapes, of (a)-(c)'s route checks on the card, each "
        f"against its plain version (1e-5 of max |entry|): max abs err "
        f"{mm_err:.3g}, {sm_err:.3g}; K3's (M, K, N): "
        + ", ".join(sorted({f"({a[0]}, {a[1]}, {b[1]})"
                            for a, _, b, _, _ in seen_mm})))
    scan = {}
    xv = rng.standard_normal((16, 8, 24)).astype(np.float32)
    gv = rng.standard_normal((16, 8, 96)).astype(np.float32)
    for kind in ("LSTM", "GRU"):
        with on_device("cpu"):
            weights = [p.data().numpy()
                       for p in getattr(nn, kind)(24, 96).parameters()]
        res = {}
        for dev in ("cpu", "cuda"):
            with on_device(dev):
                layer = getattr(nn, kind)(24, 96)
            nn.params_from_jax(layer, weights)
            x = nk.from_ndarray(xv, device=dev).requires_grad()
            out = layer.forward(x)
            loss = (out * nk.from_ndarray(gv, device=dev)).sum()
            loss.forward()
            loss.backward(1.0)
            res[dev] = [out.data().cpu(), x.grad().cpu()] + [
                p.grad().cpu() for p in layer.parameters()]
        e_out = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        e_grad = max(float((a - b).abs().max())
                     for a, b in zip(res["cuda"][1:], res["cpu"][1:]))
        check(e_out <= ROUTE_LOSS_TOL and e_grad <= ROUTE_GRAD_TOL,
              f"phase 15 nn.{kind}: max |d out| {e_out}, max |d grad| "
              f"{e_grad}")
        scan[kind] = (e_out, e_grad)
    lines.append(
        "(c) scan ops card vs CPU, T16 B8 I24 H96 (plain torch on both "
        "devices; no hand-written kernel runs in them): " + ", ".join(
            f"nn.{k} max |d out| {a:.3g}, max |d grad| {b:.3g}"
            for k, (a, b) in scan.items())
        + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")

    # (d) the conv x optimizer sweep, card against CPU
    def sweep(make, case, dev):
        _, ks, xs, stride, dil, groups = case
        g = np.random.default_rng(2)
        kv = (0.3 * g.standard_normal(ks)).astype(np.float32)
        kernel = nk.from_ndarray(kv, device=dev).requires_grad()
        x = nk.from_ndarray(g.standard_normal(xs).astype(np.float32),
                            device=dev)
        opt = make()
        opt.register(kernel)
        losses = []
        for _ in range(8):
            loss = kernel.convolution(x, stride, dil, groups).pow(2).mean()
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
            losses.append(loss.item())
        return losses, kernel.data().cpu()

    worst = [0.0, 0.0]          # max |d kernel|: the others, Muon
    for name, make in kit_optimizers(optim).items():
        for case in KIT_SWEEP_CASES:
            nk.enable_kernels(False)
            _, ref = sweep(make, case, "cpu")
            nk.enable_kernels(True)
            launch = KIT_SWEEP_LAUNCH.get(case[0])
            cl, got = run(lambda: sweep(make, case, "cuda"),
                          {launch: 8} if launch else {},
                          f"sweep {case[0]} {name}")
            err = float((got - ref).abs().max())
            check(cl[-1] < cl[0], f"phase 15 sweep {case[0]} {name}: "
                                  f"losses {cl}")
            tol = KIT_MUON_TOL if name == "muon" else KIT_PARAM_TOL
            check(err <= tol, f"phase 15 sweep {case[0]} {name}: max |d "
                              f"kernel| {err} (bound {tol})")
            worst[name == "muon"] = max(worst[name == "muon"], err)
    lines.append(f"(d) conv1d (stride 2, dilation 2, groups 2; library), "
                 f"conv1d and conv3d (stride 1; K14, K15) x 10 optimizers, "
                 f"8 steps each: losses fall, card vs CPU kernels max |d| "
                 f"{worst[0]:.3g} (bound {KIT_PARAM_TOL}), Muon's "
                 f"{worst[1]:.3g} (bound {KIT_MUON_TOL})")

    nk.enable_kernels(False)
    nk.config.conv_route = old_route
    print(f"phase 15 layer kit on the card ({card}), kernels on: "
          + "; ".join(lines) + f"; launches {total}, on the Hopper conv "
          f"kernels {total_sm90}")
    return {**total, **total_sm90}


# --------------------------------------------------------------------------
# phase 16: the language-model loop (Trainer, eval, checkpoints, dense
# generation, the text-pipeline and GPT example twins)

# the Trainer run: warmup-cosine lr (warmup 2 of 6 steps), clipping,
# eval and a checkpoint every 2 steps, keep 2; fit takes 4 steps
LOOP_RUN = dict(lr=3e-4, warmup_steps=2, total_steps=6, grad_clip=1.0,
                checkpoint_every=2, keep=2, eval_every=2)
LOOP_STEPS = 4
# dense generation: phase 4's model, 8 prompts of 64 tokens, 64 new each
GEN_B, GEN_P, GEN_NEW, GEN_TOP_K = 8, 64, 64, 50


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def loop_trainer(T, train, data, utils, FA, CE, head_step_ms):
    """Phase 16 (a): `Trainer` at phase 6's headline configuration on
    random token windows (`data.lm_windows`), B16 S2048; returns the
    launch counts of its first fit and a summary line."""
    from neuronika_tpu_torch._tree import tree_map

    B, S = 16, 2048
    V = TRAIN_CFG["vocab_size"]
    rng = np.random.default_rng(16)
    toks, tgts = data.lm_windows(
        rng.integers(0, V, size=(LOOP_STEPS + 1) * B * S + 1), S)
    batches = [(toks[i * B:(i + 1) * B], tgts[i * B:(i + 1) * B])
               for i in range(LOOP_STEPS)]
    held = (toks[LOOP_STEPS * B:], tgts[LOOP_STEPS * B:])
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG, **HEADLINE)
    L = cfg.n_layer
    kernels = train_kernels(FA, CE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        def trainer(log):
            return train.Trainer(
                cfg, generator=torch.Generator("cuda").manual_seed(0),
                checkpoint_dir=os.path.join(tmp, "ck"),
                log_path=os.path.join(tmp, log),
                eval_batches=lambda: [held], **LOOP_RUN)

        tr = trainer("first.jsonl")
        # make_train_step from the same params, Adam state, batch and lr
        p0 = tree_map(torch.clone, tr.params)
        o0 = tree_map(torch.clone, tr.opt_state)
        ref = T.make_train_step(cfg, grad_clip=LOOP_RUN["grad_clip"])(
            p0, o0, torch.from_numpy(batches[0][0]).cuda(),
            torch.from_numpy(batches[0][1]).cuda(),
            torch.tensor(tr.lr_fn(0), dtype=torch.float32), tr.generator)[2]
        ref = float(ref)
        del p0, o0
        torch.cuda.empty_cache()
        # the evals inside fit, timed from a drained queue
        fit_evals, evaluate = [], tr.evaluate

        def timed_eval(b):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = evaluate(b)
            fit_evals.append((time.perf_counter() - t) * 1e3)
            return r

        tr.evaluate = timed_eval
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        tr.fit(iter(batches), steps=LOOP_STEPS)
        fit_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = read_jsonl(os.path.join(tmp, "first.jsonl"))
        check(len(recs) == LOOP_STEPS, f"phase 16: {len(recs)} records")
        check([r["lr"] for r in recs]
              == [tr.lr_fn(i) for i in range(LOOP_STEPS)],
              f"phase 16: lr {[r['lr'] for r in recs]}")
        losses = [r["loss"] for r in recs]
        check(all(np.isfinite(losses)), f"phase 16: losses {losses}")
        check(losses[0] == ref, f"phase 16: the Trainer's first loss "
                                f"{losses[0]} != make_train_step's {ref}")
        n_eval = LOOP_STEPS // LOOP_RUN["eval_every"]
        want = dict.fromkeys(launches, 0)
        want.update(flash_fwd_qkv=L * (LOOP_STEPS + n_eval),
                    flash_bwd_fused_qkv=L * LOOP_STEPS)
        check(launches == want, f"phase 16 trainer launches {launches}, "
                                f"want {want}")
        ev = tr.last_eval["loss"]
        check(np.isfinite(ev) and ev >= 0.9 * math.log(V),
              f"phase 16: eval loss {ev} < 0.9 ln V on a held-out batch")
        check(tr._ckpt.steps() == [2, 4], f"phase 16: checkpoints "
                                          f"{tr._ckpt.steps()}")
        step_ms = [r.get("step_ms") for r in recs]
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # a fresh Trainer with the same arguments resumes step 2
        tr = trainer("resumed.jsonl")
        check(tr.resume(2) == 2, "phase 16: resume did not restore step 2")
        tr.fit(iter(batches[2:]), steps=LOOP_STEPS)
        again = [r["loss"] for r in read_jsonl(
            os.path.join(tmp, "resumed.jsonl"))]
        check(again == losses[2:], f"phase 16: resumed losses {again} != "
                                   f"{losses[2:]}")

        # the checkpoint's cost, on a Checkpointer of its own
        ck = utils.Checkpointer(os.path.join(tmp, "timed"), keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(tr.step_num, tr._state())
        snap_s = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        size = dir_bytes(os.path.join(tmp, "timed"))
        t0 = time.perf_counter()
        tr.evaluate([held])
        eval_s = time.perf_counter() - t0
        # the trainer's own step with its one sync (float(loss)), after
        # the run: 3 steps on the resumed state
        b0 = batches[0]
        float(tr.train_step(*b0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            float(tr.train_step(*b0))
        own_ms = (time.perf_counter() - t0) / 3 * 1e3
        del tr, ck
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    line = (f"(a) Trainer at the headline (d1536 L8 H12 V16384 S2048 B16 "
            f"bf16, fused bwd, bf16 Adam), {LOOP_STEPS} steps in "
            f"{fit_s:.2f} s: losses {[round(l, 4) for l in losses]} (first "
            f"= make_train_step's, bit for bit; steps 3-4 the same after a "
            f"resume from step 2), JSONL step_ms {step_ms} (eval at steps "
            f"2 and 4, checkpoint after step 2), the Trainer's own step "
            f"{own_ms:.1f} ms with its float(loss) sync against phase 6's "
            f"{head_step_ms:.1f} ms; eval loss {ev:.4f} (ln V "
            f"{math.log(V):.4f}) in {eval_s * 1e3:.1f} ms alone, "
            f"{[round(t, 1) for t in fit_evals]} ms inside fit; checkpoint "
            f"{size / 2 ** 30:.3f} GiB, snapshot to host {snap_s:.3f} s, "
            f"on disk after {save_s:.3f} s; peak {peak:.2f} GiB; launches "
            f"{launches}")
    return launches, line


def loop_generate(T, PA, PagedBatcher, prompts):
    """Phase 16 (b): dense generation at phase 4's width (random weights,
    torch.Generator seed 0); `prompts` are phase 5's requests. Returns the
    paged-attention launches of its f32 identity and a summary line."""
    cfg = T.GPTConfig(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                      d_ff=6144, max_seq=1024, dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    rng = np.random.default_rng(16)
    batch = rng.integers(0, cfg.vocab_size, size=(GEN_B, GEN_P),
                         dtype=np.int32)
    on_dev = T.make_generate(cfg, GEN_NEW)
    runs = {"generate": lambda: T.generate(params, cfg, batch, GEN_NEW),
            "make_generate": lambda: on_dev(params, batch).cpu().numpy()}
    for run in runs.values():                           # warm-up
        run()
    times = {name: [] for name in runs}
    out = {}
    # in turns: generate, make_generate, make_generate, generate
    for name in ("generate", "make_generate", "make_generate", "generate"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = runs[name]()
        times[name].append(time.perf_counter() - t0)
    host, dev = out["generate"], out["make_generate"]
    host_s, dev_s = min(times["generate"]), min(times["make_generate"])
    beams, scores = T.make_beam_search(cfg, GEN_NEW, 1)(params, batch)
    beams = beams[:, 0].cpu().numpy()
    check(np.array_equal(host, dev) and np.array_equal(host, beams),
          "phase 16: bf16 greedy tokens differ between generate, "
          "make_generate and one-beam search")
    check(bool(torch.isfinite(scores).all()), "phase 16: beam scores")

    # seeded sampling repeats, and each token is inside its step's top k,
    # read from the same prefill and decode steps fed the sampled tokens
    temp = 0.8
    samp = T.make_generate(cfg, GEN_NEW, temperature=temp, top_k=GEN_TOP_K)
    a = samp(params, batch, torch.Generator("cuda").manual_seed(7))
    b = samp(params, batch, torch.Generator("cuda").manual_seed(7))
    check(torch.equal(a, b), "phase 16: seeded sampling did not repeat")
    prep = T.prepare_decode_params(params, cfg)
    cache = T.init_kv_cache(cfg, GEN_B, device="cuda")
    logits, cache = T.make_prefill(cfg)(prep, cache, a[:, :GEN_P])
    decode = T.make_decode_step(cfg)
    inside = torch.ones((), dtype=torch.bool, device="cuda")
    for t in range(GEN_NEW):
        tok = a[:, GEN_P + t]
        lt = logits.float() / temp
        kth = torch.topk(lt, GEN_TOP_K, -1).values[:, -1]
        inside &= (lt.gather(1, tok.long()[:, None])[:, 0] >= kth).all()
        if t + 1 < GEN_NEW:
            logits, cache = decode(prep, cache, tok)
    check(bool(inside), f"phase 16: a sampled token outside its step's "
                        f"top {GEN_TOP_K}")
    distinct = len({tuple(r) for r in a.cpu().numpy()[:, GEN_P:]})
    del prep, cache, params
    torch.cuda.empty_cache()

    # f32: the dense cache against the paged kernel (K11) on phase 5's
    # requests, greedy
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg32, "cuda")
    news = [16] * len(prompts)
    PA.paged_attention.launches = 0
    _, paged, steps, finite, _ = serve(
        PagedBatcher, params, cfg32, prompts, news, n_slots=4,
        n_blocks=257, block_size=16, kernel="on")
    k11 = PA.paged_attention.launches
    check(finite, "phase 16: non-finite logits (f32, kernel='on')")
    check(k11 == cfg32.n_layer * steps, f"phase 16: K11 launches {k11}")
    for p, want, n in zip(prompts, paged, news):
        got = T.generate(params, cfg32, p[None], n)[0, len(p):]
        check(np.array_equal(got, want), f"phase 16: f32 dense generate "
                                         f"{got} != paged {want}")
    del params
    torch.cuda.empty_cache()
    n_tok = GEN_B * GEN_NEW
    line = (f"(b) generation at phase 4's model (d1536 L8 H12 V16384, bf16, "
            f"max_seq 1024), {GEN_B} prompts of {GEN_P} + {GEN_NEW} greedy "
            f"tokens: generate, make_generate and one-beam search "
            f"identical; make_generate {n_tok / dev_s:.1f} tok/s "
            f"({[round(t, 4) for t in times['make_generate']]} s), "
            f"generate {n_tok / host_s:.1f} tok/s "
            f"({[round(t, 4) for t in times['generate']]} s; the faster of "
            f"two runs in turns, after a warm-up; host-bound, not "
            f"targets); seeded sampling "
            f"(T {temp}, top-k {GEN_TOP_K}) repeats, every token inside "
            f"its step's top {GEN_TOP_K}, {distinct} distinct rows of "
            f"{GEN_B}; f32 greedy dense generate = PagedBatcher("
            f"kernel='on') on phase 5's {len(prompts)} requests x 16 "
            f"tokens ({k11} K11 launches)")
    return k11, line


def loop_examples(FA, text_pipeline, gpt_train):
    """Phase 16 (c): the twins of the JAX package's text_pipeline and
    gpt_train examples at their sizes on the card; returns gpt_train's
    flash launches and a summary line (text_pipeline's K5-K7 are held
    exact here and left out of the kernels line)."""
    kernels = FA.KERNELS + FA.SPLIT_KERNELS
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    tp = text_pipeline.main(device="cuda")
    tp_s = time.perf_counter() - t0
    tp_launch = {k.__name__: k.launches for k in kernels}
    # f32 rope hd 32 on the split op: K5 twice a layer and step (remat)
    # and once a layer in the one eval batch, K6 and K7 once a layer and
    # step
    n, L = len(tp["losses"]), 2
    want = dict.fromkeys(tp_launch, 0)
    want.update(flash_fwd=2 * L * n + L, flash_bwd_dq=L * n,
                flash_bwd_dkv=L * n)
    check(tp_launch == want, f"phase 16: text_pipeline launches "
                             f"{tp_launch}, want {want}")
    for k in kernels:
        k.launches = 0
    check(tp["losses"][-1] < tp["losses"][0] and np.isfinite(
        tp["eval"]["loss"]), f"phase 16: text_pipeline losses "
                             f"{tp['losses'][::20]}, eval {tp['eval']}")
    t0 = time.perf_counter()
    gt = gpt_train.main(device="cuda")
    gt_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    # bf16 hd 64, remat: K1 twice a layer and step, K2a and K2b once
    n = len(gt["losses"])
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd_qkv=2 * L * n, flash_bwd_dq_qkv=L * n,
                flash_bwd_dkv_qkv=L * n)
    check(launches == want, f"phase 16 gpt_train launches {launches}, "
                            f"want {want}")
    check(gt["losses"][-1] < gt["losses"][0] and all(
        np.isfinite(gt["losses"])), f"phase 16: gpt_train losses "
                                    f"{gt['losses'][::50]}")
    line = (f"(c) text_pipeline twin ({len(tp['losses'])} steps, f32, "
            f"{tp_s:.2f} s): loss {tp['losses'][0]:.3f} -> "
            f"{tp['losses'][-1]:.3f}, eval {tp['eval']['loss']:.3f}, "
            f"generated {tp['text']!r}; gpt_train twin ({n} steps, bf16, "
            f"{gt_s:.2f} s): loss {gt['losses'][0]:.3f} -> "
            f"{gt['losses'][-1]:.3f}; launches {launches}")
    return launches, line


def phase_lm_loop(T, FA, CE, PA, PagedBatcher, prompts, head_step_ms):
    """Phase 16: the language-model loop; returns the K1/K2 launches of
    (a) and (c) summed, and the K11 launches of (b)."""
    from neuronika_tpu_torch import data, train, utils
    from neuronika_tpu_torch.examples import gpt_train, text_pipeline

    t0 = time.perf_counter()
    trained, a = loop_trainer(T, train, data, utils, FA, CE, head_step_ms)
    k11, b = loop_generate(T, PA, PagedBatcher, prompts)
    examples, c = loop_examples(FA, text_pipeline, gpt_train)
    wall = time.perf_counter() - t0
    print(f"phase 16 language-model loop ({wall:.1f} s): {a}; {b}; {c}")
    flash = {k: trained.get(k, 0) + examples.get(k, 0)
             for k in set(trained) | set(examples)}
    return flash, k11


# --------------------------------------------------------------------------
# phase 17: the other model families (BERT, T5, ViT, the MoE GPT, LoRA and
# QLoRA, the resnet_cifar twin)

# Devlin et al. 2019, BERT-base (MLM at B32 S512)
BERT_BASE = dict(vocab_size=30522, n_layer=12, n_head=12, d_model=768,
                 d_ff=3072, max_seq=512)
# Raffel et al. 2020, t5-base's widths, on this repo's encoder-decoder
# (learned positions, LayerNorm, GELU, no relative attention bias)
T5_BASE = dict(vocab_size=32128, n_layer=12, n_head=12, d_model=768,
               d_ff=3072, max_src=512, max_tgt=128)
# Dosovitskiy et al. 2021, Table 1: ViT-B/16 on 224x224, 1000 classes
VIT_B16 = dict(image=224, patch=16, d_model=768, n_layer=12, n_head=12,
               d_ff=3072, num_classes=1000)
# phase 6's width with 8 Switch experts (Fedus et al. 2022: training
# capacity factor 1.25, aux weight alpha 0.01)
MOE = dict(n_experts=8, moe_impl="sort", moe_capacity=1.25,
           moe_aux_weight=0.01)
MODEL_WARM, MODEL_TIMED = 2, 3
# the small f32 models of phase 17's card-against-CPU checks (hd 128)
MODEL_SMALL = dict(vocab_size=512, n_layer=2, n_head=2, d_model=256,
                   max_seq=256, dtype=torch.float32)


def model_steps(run, kernels, n_warm=MODEL_WARM, n_timed=MODEL_TIMED,
                profile=None, label=""):
    """`run()` takes one train step and returns its loss tensor: n_warm
    warm-up steps, then n_timed timed ones (and, with a `profile` path, one
    more under the profiler). Returns the losses, the launches of
    `kernels` in the timed steps (launch_counts), the step time in s and
    the peak memory of the timed steps in GiB."""
    losses = [run() for _ in range(n_warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
        if hasattr(k, "sm90_launches"):
            k.sm90_launches = 0
    t0 = time.perf_counter()
    losses += [run() for _ in range(n_timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        profile_step(run, label, profile)
    return [float(l) for l in losses], launches, step_s, peak


def launch_counts(kernels):
    """{name: launches} of `kernels`, and {"name.sm90": launches of its
    Hopper kernel} for those that count them apart."""
    counts = {k.__name__: k.launches for k in kernels}
    counts.update({f"{k.__name__}.sm90": k.sm90_launches for k in kernels
                   if hasattr(k, "sm90_launches")})
    return counts


def profile_path(profile, name):
    """TABLE_PATH with "_name" before its extension, or None."""
    if not profile:
        return None
    root, ext = os.path.splitext(profile)
    return f"{root}_{name}{ext}"


def want_launches(kernels, **counts):
    """launch_counts' keys, all 0 but `counts`."""
    want = dict.fromkeys(launch_counts(kernels), 0)
    want.update(counts)
    return want


def counted(kernels, run):
    """run(), and the launches of `kernels` it made (launch_counts)."""
    before = launch_counts(kernels)
    out = run()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts(kernels).items()}


def tree_numel(tree) -> int:
    from neuronika_tpu_torch._tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def tree_bytes(*trees) -> int:
    from neuronika_tpu_torch._tree import tree_leaves

    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree))


def models_bert(T, B_, OF, kernels, profile=None):
    """Phase 17 (a): BERT-base MLM pre-training, bf16, B32 S512, the
    GPTConfig defaults (remat: K1 twice a layer, split K2), then one
    classifier step. Returns the MLM run's launches and a summary line."""
    cfg = B_.bert_config(dtype=torch.bfloat16, flash="on", **BERT_BASE)
    L, n, B, S = cfg.n_layer, MODEL_TIMED, 32, 512
    gen = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    opt = T.opt_init(params, cfg)
    step = B_.make_mlm_train_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size - 1, size=(B, S))).cuda()
    losses, launches, step_s, peak = model_steps(
        lambda: step(params, opt, toks, 1e-4, gen)[2], kernels,
        profile=profile_path(profile, "bert"), label="one BERT-base step")
    check(all(np.isfinite(losses)), f"phase 17 BERT: MLM losses {losses}")
    want = want_launches(kernels, flash_fwd_qkv=2 * L * n,
                         flash_bwd_dq_qkv=L * n, flash_bwd_dkv_qkv=L * n)
    check(launches == want, f"phase 17 BERT: launches {launches}, want "
                            f"{want}")
    del opt
    head = B_.init_classifier(gen, cfg, 2, device="cuda")
    copt = OF.adam_init([params, head])
    cstep = B_.make_classifier_train_step(cfg, 2)
    labels = torch.arange(B, device="cuda") % 2
    (_, _, _, closs), ran = counted(kernels, lambda: cstep(
        params, head, copt, toks, labels, 1e-4, gen))
    want = want_launches(kernels, flash_fwd_qkv=2 * L, flash_bwd_dq_qkv=L,
                         flash_bwd_dkv_qkv=L)
    check(ran == want and math.isfinite(float(closs)),
          f"phase 17 BERT classifier: loss {float(closs)}, launches {ran}")
    del params, copt, head
    torch.cuda.empty_cache()
    return launches, (
        f"(a) BERT-base (L12 d768 H12 d_ff 3072 V30522, bf16, f32 Adam, "
        f"remat) MLM at B32 S512: step {step_s * 1e3:.1f} ms, "
        f"{B * S / step_s:.0f} tokens/s, peak {peak:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; K1 {launches['flash_fwd_qkv']}"
        f", K2a {launches['flash_bwd_dq_qkv']}, K2b "
        f"{launches['flash_bwd_dkv_qkv']} (non-causal); one classifier "
        f"step, loss {float(closs):.4f}")


def models_t5(T5, OF, kernels, profile=None):
    """Phase 17 (b): t5-base's widths, bf16, source 512, target 128, B16:
    the encoder on K1/K2, the decoder's causal self-attention (S128) and
    cross-attention (Sq 128, Skv 512) on K5-K7; then greedy_generate for
    8 tokens. Returns the train run's launches, the generation's and a
    summary line."""
    cfg = T5.Seq2SeqConfig(dtype=torch.bfloat16, flash="on", **T5_BASE)
    L, n, B = cfg.n_layer, MODEL_TIMED, 16
    gen = torch.Generator("cuda").manual_seed(0)
    params = T5.init_params(gen, cfg, "cuda")
    opt = OF.adam_init(params)
    step = T5.make_train_step(cfg)
    rng = np.random.default_rng(17)
    src = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 512))).cuda()
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 129))).cuda()
    losses, launches, step_s, peak = model_steps(
        lambda: step(params, opt, src, tgt[:, :-1], tgt[:, 1:], 1e-4, gen)[2],
        kernels, profile=profile_path(profile, "t5"),
        label="one t5-base step")
    check(all(np.isfinite(losses)), f"phase 17 T5: losses {losses}")
    want = want_launches(
        kernels, flash_fwd_qkv=2 * L * n, flash_bwd_dq_qkv=L * n,
        flash_bwd_dkv_qkv=L * n, flash_fwd=2 * L * n, flash_bwd_dq=2 * L * n,
        flash_bwd_dkv=2 * L * n)
    check(launches == want, f"phase 17 T5: launches {launches}, want {want}")
    del opt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ran = counted(kernels, lambda: T5.greedy_generate(
        params, src, cfg, bos_id=0, max_new=8))
    gen_s = time.perf_counter() - t0
    want = want_launches(kernels, flash_fwd_qkv=L, flash_fwd=2 * L * 8)
    check(out.shape == (B, 9) and out.min() >= 0
          and out.max() < cfg.vocab_size and ran == want,
          f"phase 17 T5 generate: {out.shape}, launches {ran}, want {want}")
    del params
    torch.cuda.empty_cache()
    return launches, ran, (
        f"(b) t5-base widths (12 + 12 layers, d768 H12 d_ff 3072 V32128; "
        f"learned positions, LayerNorm, GELU, no relative bias), bf16, f32 "
        f"Adam, source 512, target 128, B16: step {step_s * 1e3:.1f} ms, "
        f"{B * 128 / step_s:.0f} target tokens/s ({B * 640 / step_s:.0f} "
        f"source + target), peak {peak:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; launches {launches}; "
        f"greedy_generate, 8 tokens for 16 sources, {gen_s:.3f} s, "
        f"launches {ran}")


def models_vit(V, OF, kernels, profile=None):
    """Phase 17 (c): ViT-B/16 on 224x224, B64, bf16 (weights stored in
    bf16 and Adam state in their dtype, JAX's ViT rule): no kernel."""
    cfg = V.ViTConfig(dtype=torch.bfloat16, **VIT_B16)
    B = 64
    gen = torch.Generator("cuda").manual_seed(0)
    params = V.init_params(gen, cfg, "cuda")
    opt = OF.adam_init(params)
    step = V.make_train_step(cfg)
    x = torch.rand((B, 224, 224, 3), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    losses, launches, step_s, peak = model_steps(
        lambda: step(params, opt, x, y, 1e-4)[2], kernels,
        profile=profile_path(profile, "vit"), label="one ViT-B/16 step")
    check(all(np.isfinite(losses)), f"phase 17 ViT: losses {losses}")
    check(not any(launches.values()), f"phase 17 ViT: launches {launches}")
    del params, opt
    torch.cuda.empty_cache()
    return (f"(c) ViT-B/16 (L12 d768 H12 MLP 3072, 224x224, 1000 classes), "
            f"bf16 weights and Adam state, B64: step {step_s * 1e3:.1f} ms, "
            f"{B / step_s:.1f} images/s, peak {peak:.2f} GiB; losses "
            f"{[round(v, 4) for v in losses]}; no kernel")


def models_moe(T, PA, PagedBatcher, kernels, profile=None):
    """Phase 17 (d): the Switch MoE GPT at phase 6's width (8 experts, sort
    dispatch, capacity 1.25, aux 0.01; GPTConfig defaults: remat, split
    K2, f32 Adam), B16 S2048; then in f32 on a small model: the three
    dispatches agree at full capacity, sparse and sort at capacity 1.0,
    their decode logits agree, and generate's greedy tokens equal
    PagedBatcher(kernel="on")'s (K11). Returns the train run's launches,
    the K11 launches and a summary line."""
    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, TRAIN_CFG["vocab_size"], size=(B, S))
    batch = (torch.from_numpy(toks).cuda(),
             torch.from_numpy(np.roll(toks, -1, axis=1)).cuda())
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG, **MOE)
    L, n = cfg.n_layer, MODEL_TIMED
    losses, launches, step_s, peak, _ = train_steps(
        T, kernels, cfg, MODEL_WARM, n, batch, 5e-4,
        profile_path(profile, "moe"), "one MoE GPT step")
    # the parameter count from a fresh tree's leaves
    n_params = tree_numel(T.init_params(torch.Generator("cuda"), cfg, "cuda"))
    check(all(np.isfinite(losses)), f"phase 17 MoE: losses {losses}")
    want = dict.fromkeys(launches, 0)     # the ".sm90" counts of K8-K10
    want.update(flash_fwd_qkv=2 * L * n, flash_bwd_dq_qkv=L * n,
                flash_bwd_dkv_qkv=L * n)
    check(launches == want, f"phase 17 MoE: launches {launches}, want "
                            f"{want}")
    line = (f"(d) Switch MoE GPT (d1536 L8 H12 d_ff 6144 V16384, 8 experts, "
            f"sort dispatch, capacity 1.25, aux 0.01; {n_params / 1e9:.3f} B "
            f"params), bf16, f32 Adam, remat, B16 S2048: step "
            f"{step_s * 1e3:.1f} ms, {B * S / step_s:.0f} tokens/s, peak "
            f"{peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; "
            f"launches {launches}")

    # f32, small: the dispatches against each other
    base = dict(MODEL_SMALL, d_ff=512, n_experts=4)
    params = T.init_params(torch.Generator("cuda").manual_seed(5),
                           T.GPTConfig(**base), "cuda")
    x = torch.from_numpy(rng.integers(0, 512, size=(2, 64))).cuda()

    def logits(impl, cap):
        return T.forward(params, x, T.GPTConfig(moe_impl=impl,
                                                moe_capacity=cap, **base))

    full = {impl: logits(impl, 8.0) for impl in ("dense", "sparse", "sort")}
    e_full = max(float((full[i] - full["dense"]).abs().max())
                 for i in ("sparse", "sort"))
    e_drop = float((logits("sparse", 1.0) - logits("sort", 1.0)).abs().max())
    check(e_full <= F32_TOL and e_drop <= F32_TOL,
          f"phase 17 MoE dispatch: full capacity {e_full}, capacity 1.0 "
          f"sparse vs sort {e_drop}")
    toks8 = torch.from_numpy(rng.integers(0, 512, size=(8, 6))).cuda()
    dec = {}
    for impl in ("dense", "sparse", "sort"):
        cfg32 = T.GPTConfig(moe_impl=impl, moe_capacity=0.25, **base)
        step = T.make_decode_step(cfg32)
        cache = T.init_kv_cache(cfg32, 8, device="cuda")
        for t in range(6):
            lg, cache = step(params, cache, toks8[:, t])
        dec[impl] = lg
    e_dec = max(float((dec[i] - dec["dense"]).abs().max())
                for i in ("sparse", "sort"))
    check(e_dec <= 1e-6, f"phase 17 MoE decode logits differ by {e_dec}")
    # serving: prefill through sort at capacity 1.0 (tokens drop as in
    # generate's one-prompt prefill), decode by the dense routing on K11
    cfg32 = T.GPTConfig(moe_impl="sort", moe_capacity=1.0, **base)
    prompts = [rng.integers(0, 512, size=m, dtype=np.int32)
               for m in (17, 40, 64, 9)]
    PA.paged_attention.launches = 0
    _, paged, steps, finite, _ = serve(
        PagedBatcher, params, cfg32, prompts, [12] * 4, n_slots=2,
        n_blocks=64, block_size=16, kernel="on")
    k11 = PA.paged_attention.launches
    check(finite and k11 == cfg32.n_layer * steps,
          f"phase 17 MoE serving: finite {finite}, K11 {k11}")
    for p, want_tok in zip(prompts, paged):
        got = T.generate(params, cfg32, p[None], 12)[0, len(p):]
        check(np.array_equal(got, want_tok), f"phase 17 MoE: generate "
                                             f"{got} != paged {want_tok}")
    del params
    torch.cuda.empty_cache()
    line += (f"; f32 d256 E4: dense, sparse and sort logits within "
             f"{e_full:.3g} at capacity 8, sparse vs sort {e_drop:.3g} at "
             f"1.0 (bound {F32_TOL}), decode logits within {e_dec:.3g} "
             f"(bound 1e-6), generate = PagedBatcher(kernel='on') on 4 "
             f"requests x 12 tokens ({k11} K11 launches)")
    return launches, k11, line


def models_lora(T, LR, OF, kernels, profile=None):
    """Phase 17 (e): LoRA and QLoRA (rank 8 on qkv and proj) at phase 6's
    headline (d1536 L8 S2048 B16 bf16, fused K2, no remat): the base
    unchanged bit for bit, the adapters moved, the persistent training
    state. Returns the launches of both runs summed and a summary line."""
    from neuronika_tpu_torch._tree import tree_leaves

    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, TRAIN_CFG["vocab_size"], size=(B, S))
    tt = torch.from_numpy(toks).cuda()
    tg = torch.from_numpy(np.roll(toks, -1, axis=1)).cuda()
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG, **HEADLINE)
    L, n = cfg.n_layer, MODEL_TIMED
    gen = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    n_base = tree_numel(params)
    full_state = n_base * (4 + 2 * 2)      # f32 params, bf16 Adam m and v
    total, parts = {}, []
    for kind in ("lora", "qlora"):
        base = LR.qlora_quantize_base(params) if kind == "qlora" else params
        lora = LR.lora_init(gen, params, 8)
        opt = OF.adam_init(lora)
        step = (LR.make_qlora_train_step if kind == "qlora"
                else LR.make_lora_train_step)(cfg)
        before = [t.clone() for t in tree_leaves(base)]
        losses, launches, step_s, peak = model_steps(
            lambda: step(base, lora, opt, tt, tg, 5e-4, gen)[2], kernels,
            profile=profile_path(profile, kind), label=f"one {kind} step")
        check(all(np.isfinite(losses)), f"phase 17 {kind}: {losses}")
        want = want_launches(kernels, flash_fwd_qkv=L * n,
                             flash_bwd_fused_qkv=L * n)
        check(launches == want, f"phase 17 {kind}: launches {launches}, "
                                f"want {want}")
        check(all(torch.equal(a, b) for a, b in zip(tree_leaves(base),
                                                    before)),
              f"phase 17 {kind}: the base moved")
        check(all(float(ab["B"].abs().max()) > 0 for ab in lora.values()),
              f"phase 17 {kind}: an adapter did not move")
        state = tree_bytes(base, lora, opt)
        parts.append(
            f"{kind} step {step_s * 1e3:.1f} ms, {B * S / step_s:.0f} "
            f"tokens/s, peak {peak:.2f} GiB, persistent state (base + "
            f"{LR.lora_param_count(lora) / 1e6:.2f} M adapters + their Adam)"
            f" {state / 2 ** 30:.3f} GiB, losses "
            f"{[round(v, 4) for v in losses]}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del base, lora, opt, before
    del params
    torch.cuda.empty_cache()
    return total, (
        f"(e) at phase 6's headline (d1536 L8 S2048 B16 bf16, rank 8 on "
        f"qkv and proj, alpha 8): " + "; ".join(parts)
        + f"; full fine-tuning's persistent state (f32 params, bf16 m and "
        f"v) {full_state / 2 ** 30:.3f} GiB; the base bit for bit the same "
        f"and every adapter moved in both; launches each: K1 {L * n}, the "
        f"fused K2 {L * n}")


def card_vs_cpu(what, params, loss_of, kernels, want):
    """loss_of(tree, device) -> loss: its value and every gradient leaf on
    the card (the kernels; launches held to `want`) and on the CPU (the
    plain versions; no launch), within phase 7's bounds. Returns the CPU
    loss, |d loss| and max |d grad|."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    res = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).clone().requires_grad_()
                  for t in tree_leaves(params)]

        def run():
            loss = loss_of(tree_unflatten(params, leaves), dev)
            return loss, torch.autograd.grad(loss, leaves)

        (loss, grads), ran = counted(kernels, run)
        res[dev] = (float(loss.detach()), [g.cpu() for g in grads], ran)
    check(not any(res["cpu"][2].values()) and res["cuda"][2] == want,
          f"phase 17 {what}: launches {res['cuda'][2]}, want {want}")
    return (res["cpu"][0],) + route_errs(f"phase 17 {what}", res["cpu"],
                                         res["cuda"])


# phase 17 (f), bf16: one MoE layer (`_moe_mlp`) on the card (the gate
# by `_DotF32`, the experts' GEMMs by `_BmmF32`, bf16 operands with f32
# results) against the CPU (operands widened exactly to f32) on the same
# bf16 input. Both round to bf16 at the same points and sum in other
# orders, so an entry rounded near a half-ulp moves by one ulp (2^-8
# relative) here and there: the output, the loss and each gradient are
# held in norm to MOE_BF16_REL of the CPU's. A planted fault must fail
# that bound: the CPU's layer with experts 0 and 1 trading weights (the
# tokens routed to one run the other's FFN).
MOE_BF16_REL = 2 ** -6


def moe_bf16_routes(T):
    """Phase 17 (f), bf16: per dispatch, one MoE layer (D256 F512 E4, B2
    S128, capacity 1.0) on the card against the CPU: the output, the loss
    (the output's mean against a fixed random tensor, plus the aux loss)
    and its gradients to x, the gate and every expert leaf (random
    weights and biases, numpy seed 7), each held in norm to MOE_BF16_REL;
    the swapped-expert fault must fail it. Returns {dispatch: (the largest
    ratio, the fault's)}."""
    rng = np.random.default_rng(7)
    D, F_, E = 256, 512, 4

    def rand(*shape, s=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32))

    leaves0 = {"gate": rand(D, E, s=D ** -0.5), "fc_in": rand(E, D, F_,
               s=D ** -0.5), "fc_in_b": rand(E, F_, s=0.1),
               "fc_out": rand(E, F_, D, s=F_ ** -0.5),
               "fc_out_b": rand(E, D, s=0.1)}
    x0 = rand(2, 128, D).to(torch.bfloat16)
    r = rand(2, 128, D)
    names = ("out", "loss", "x") + tuple(leaves0)
    swap = torch.tensor([1, 0, 2, 3])

    def run(cfg, dev, fault=False):
        leaves = {k: v.to(dev).requires_grad_() for k, v in leaves0.items()}
        x = x0.to(dev).requires_grad_()
        blk = {k: v[swap.to(dev)] if fault and k != "gate" else v
               for k, v in leaves.items()}
        out, aux = T._moe_mlp(x, blk, cfg)
        loss = (out.float() * r.to(dev)).mean() + aux
        grads = torch.autograd.grad(loss, [x, *leaves.values()])
        return [t.detach().float().cpu() for t in (out, loss, *grads)]

    def ratios(got, ref):
        return {n: float((a - b).norm() / b.norm())
                for n, a, b in zip(names, got, ref)}

    res = {}
    for impl in ("dense", "sparse", "sort"):
        cfg = T.GPTConfig(**dict(MODEL_SMALL, dtype=torch.bfloat16),
                          d_ff=F_, n_experts=E, moe_impl=impl,
                          moe_capacity=1.0)
        ref = run(cfg, "cpu")
        card = ratios(run(cfg, "cuda"), ref)
        fault = max(ratios(run(cfg, "cpu", fault=True), ref).values())
        worst = max(card, key=card.get)
        check(card[worst] <= MOE_BF16_REL,
              f"phase 17 MoE bf16 {impl}: {worst} ||err||/||ref|| "
              f"{card[worst]} > {MOE_BF16_REL} ({card})")
        check(fault > MOE_BF16_REL, f"phase 17 MoE bf16 {impl}: the "
              f"swapped-expert fault reads {fault} <= {MOE_BF16_REL}")
        res[impl] = (card[worst], fault)
    return res


def models_routes(T, B_, T5, kernels):
    """Phase 17 (f): the kernel route on the card against the plain route
    on the CPU, f32, d256 H2 (hd 128) L2: a BERT's MLM loss (B2 S256), a
    T5's loss (source 256, target 96) and its greedy tokens, an MoE GPT's
    loss per dispatch (capacity 1.0, aux 0.01); each within phase 7's
    bounds, launches exact. Then a bf16 MoE layer per dispatch
    (moe_bf16_routes)."""
    from neuronika_tpu_torch._tree import tree_map

    rng = np.random.default_rng(3)
    L, errs = 2, {}
    cfg = B_.bert_config(d_ff=1024, remat=False, flash="on", **MODEL_SMALL)
    params = T.init_params(torch.Generator("cuda").manual_seed(1), cfg,
                           "cuda")
    toks = torch.from_numpy(rng.integers(0, 511, size=(2, 256)))
    c, lab, w = B_.mask_tokens(torch.Generator().manual_seed(3), toks, 511,
                               512)
    errs["bert"] = card_vs_cpu(
        "BERT", params, lambda p, d: B_.mlm_loss_fn(
            p, c.to(d), lab.to(d), w.to(d), cfg, train=True), kernels,
        want_launches(kernels, flash_fwd_qkv=L, flash_bwd_dq_qkv=L,
                      flash_bwd_dkv_qkv=L))
    t5cfg = T5.Seq2SeqConfig(vocab_size=512, n_layer=2, n_head=2,
                             d_model=256, d_ff=512, max_src=256,
                             max_tgt=128, dtype=torch.float32, flash="on")
    params = T5.init_params(torch.Generator("cuda").manual_seed(2), t5cfg,
                            "cuda")
    src = torch.from_numpy(rng.integers(0, 512, size=(2, 256)))
    tgt = torch.from_numpy(rng.integers(0, 512, size=(2, 97)))
    errs["t5"] = card_vs_cpu(
        "T5", params, lambda p, d: T5.loss_fn(
            p, src.to(d), tgt[:, :-1].to(d), tgt[:, 1:].to(d), t5cfg,
            train=True), kernels,
        want_launches(kernels, flash_fwd_qkv=2 * L, flash_bwd_dq_qkv=L,
                      flash_bwd_dkv_qkv=L, flash_fwd=2 * L,
                      flash_bwd_dq=2 * L, flash_bwd_dkv=2 * L))
    card = T5.greedy_generate(params, src, t5cfg, bos_id=0, max_new=6)
    cpu = T5.greedy_generate(tree_map(lambda t: t.cpu(), params), src,
                             t5cfg, bos_id=0, max_new=6)
    check(np.array_equal(card, cpu), f"phase 17 T5: greedy tokens card "
                                     f"{card} vs CPU {cpu}")
    for impl in ("dense", "sparse", "sort"):
        cfg = T.GPTConfig(d_ff=512, remat=False, n_experts=4,
                          moe_impl=impl, moe_capacity=1.0,
                          moe_aux_weight=0.01, **MODEL_SMALL)
        params = T.init_params(torch.Generator("cuda").manual_seed(4), cfg,
                               "cuda")
        errs[f"moe-{impl}"] = card_vs_cpu(
            f"MoE {impl}", params, lambda p, d: T.loss_fn(
                p, toks.to(d), toks.roll(-1, 1).to(d), cfg, train=True),
            kernels, want_launches(kernels, flash_fwd_qkv=L,
                                   flash_bwd_dq_qkv=L, flash_bwd_dkv_qkv=L))
    bf16 = moe_bf16_routes(T)
    return ("(f) kernel route (card) vs plain route (CPU), f32 d256 H2 hd128 "
            "L2; loss, |d loss|, max |d grad| per leaf: " + ", ".join(
                f"{k} {a:.6f}, {b:.3g}, {c:.3g}"
                for k, (a, b, c) in errs.items())
            + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL}); T5 greedy "
            f"tokens the same on both; bf16 MoE layer (D256 F512 E4, B2 "
            f"S128), largest ||err||/||ref|| of output, loss and gradients "
            f"against the CPU, beside the swapped-expert fault's: " + ", ".join(
                f"{k} {a:.3g} (fault {b:.3g})" for k, (a, b) in bf16.items())
            + f" (bound {MOE_BF16_REL})")


def models_resnet_cifar(R, C, resnet_cifar):
    """Phase 17 (g): the resnet_cifar twin at the example's size (300
    steps, B64, 32x32, stages (2, 2, 2), width 32; bf16, conv_impl
    "pallas"), K12/K13 launches derived from the config and held exact.
    Returns its launches (with "name.sm90" counts) and a summary line."""
    cfg = R.ResNetConfig(stages=(2, 2, 2), width=32, num_classes=10)
    k12, k13 = C.conv2d_direct_nhwc, C.conv2d_dw_nhwc
    for k in C.KERNELS:
        k.launches = 0
    for k in (k12, k13):
        k.sm90_launches = 0
    t0 = time.perf_counter()
    out = resnet_cifar.main(device="cuda", verbose=False)
    wall = time.perf_counter() - t0
    steps, fwd = len(out["losses"]), len(R.conv_strides(cfg))
    launches = {k.__name__: k.launches for k in C.KERNELS}
    want = conv_launch_want(R, cfg, steps)
    want["conv2d_direct_nhwc"] += fwd            # the eval forward
    check(launches == want, f"phase 17 resnet_cifar: launches {launches}, "
                            f"want {want}")
    sm90 = {k.__name__: k.sm90_launches for k in (k12, k13)}
    want = conv_sm90_want(R, cfg, steps)
    want["conv2d_direct_nhwc"] += fwd - 1        # all but the stem
    check(sm90 == want, f"phase 17 resnet_cifar: Hopper launches {sm90}, "
                        f"want {want}")
    losses = out["losses"]
    check(all(np.isfinite(losses)) and np.mean(losses[-20:]) < losses[0],
          f"phase 17 resnet_cifar: losses {losses[::30]}")
    launches.update({f"{k}.sm90": v for k, v in sm90.items()})
    return launches, (
        f"(g) resnet_cifar twin (stages (2, 2, 2), width 32, bf16, "
        f"conv_impl pallas, {steps} steps of B64): {wall:.2f} s, loss "
        f"{losses[0]:.3f} -> {np.mean(losses[-20:]):.3f} (mean of the last "
        f"20), synthetic accuracy {out['accuracy']:.3f}; K12 "
        f"{launches['conv2d_direct_nhwc']} (Hopper "
        f"{sm90['conv2d_direct_nhwc']}), K13 {launches['conv2d_dw_nhwc']} "
        f"(Hopper {sm90['conv2d_dw_nhwc']})")


def phase_models(T, FA, CE, PA, C, R, PagedBatcher, profile=None):
    """Phase 17: the model families; returns the launches by kernel name
    (the conv rows' Hopper counts as "name.sm90"). With a `profile` path,
    one more step of each timed run is profiled (the profile step's
    launches are not counted)."""
    from neuronika_tpu_torch.examples import resnet_cifar
    from neuronika_tpu_torch.models import bert as B_
    from neuronika_tpu_torch.models import lora as LR
    from neuronika_tpu_torch.models import t5 as T5
    from neuronika_tpu_torch.models import vit as V
    from neuronika_tpu_torch.optim import functional as OF

    kernels = train_kernels(FA, CE)
    t0 = time.perf_counter()

    def done(line):
        print(f"phase 17 {line}")
        gc.collect()
        torch.cuda.empty_cache()

    bert, line = models_bert(T, B_, OF, kernels, profile)
    done(line)
    t5_train, t5_gen, line = models_t5(T5, OF, kernels, profile)
    done(line)
    done(models_vit(V, OF, kernels, profile))
    moe, k11, line = models_moe(T, PA, PagedBatcher, kernels, profile)
    done(line)
    lora, line = models_lora(T, LR, OF, kernels, profile)
    done(line)
    done(models_routes(T, B_, T5, kernels))
    convs, line = models_resnet_cifar(R, C, resnet_cifar)
    done(line)
    print(f"phase 17 model families: {time.perf_counter() - t0:.1f} s")
    launches = {"paged_attention": k11, **convs}
    for run in (bert, t5_train, t5_gen, moe, lora):
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
    return launches


# --------------------------------------------------------------------------
# phase 18: the rest of serving (quantized weights, the dense-slot batcher,
# chunked, bucketed and grouped prefill, the prefix cache, multi-step
# windows, S-LoRA adapters, speculative decoding) at phase 4's width

SERVE18 = dict(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
               d_ff=6144, max_seq=1024)
SERVE18_POOL = dict(n_slots=8, n_blocks=513, block_size=16)
SERVE18_FEATURES = dict(prefill_chunk=256, prefill_bucket="pow2")
SERVE18_PREFIX, SERVE18_WINDOW = 256, 8


def serve18_requests(rng, vocab, n, prefix, new_lo=32, new_hi=128,
                     sampled_every=4):
    """n requests: prompts of 64-700 tokens, the even ones behind `prefix`
    (so 257-700 tokens), max_new in [new_lo, new_hi]; every
    `sampled_every`-th request samples (temperature 0.8, top-k 50, top-p
    0.9, its own seed), the others are greedy. Returns (prompts, max_news,
    submit kwargs)."""
    prompts, news, kws = [], [], []
    for i in range(n):
        if i % 2 == 0:
            tail = int(rng.integers(1, 701 - prefix.size))
            p = np.concatenate([prefix, rng.integers(0, vocab, tail)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(64, 701)))
        prompts.append(p.astype(np.int32))
        news.append(int(rng.integers(new_lo, new_hi + 1)))
        kws.append(dict(temperature=0.8, top_k=50, top_p=0.9, seed=i)
                   if sampled_every and i % sampled_every == 3 else {})
    return prompts, news, kws


class Serve18Meter:
    """Counts a batcher's decode steps (one a per-step call, k a window),
    its windows, and the device-to-host syncs inside each window (CUDA's
    sync debug mode warns once a synchronizing call; the syncs of the
    admissions a window ends with are left out)."""

    def __init__(self, pb, syncs: bool = False):
        self.steps = self.windows = 0
        self.window_syncs = []
        self.rec = None
        step, many, admit, step_many = (pb._step, pb._many_prog, pb._admit,
                                        pb.step_many)
        self._admit_syncs = 0
        self._in_window = False

        def counted_step(*a):
            self.steps += 1
            return step(*a)

        def counted_many(k):
            fn = many(k)

            def run(*a):
                self.steps += k
                self.windows += 1
                self._in_window = True
                return fn(*a)
            return run

        def counted_admit():
            n0 = self._n()
            admit()
            self._admit_syncs += self._n() - n0

        def counted_step_many(k):
            self._in_window = False
            n0, a0 = self._n(), self._admit_syncs
            step_many(k)
            if self._in_window:
                self.window_syncs.append(
                    self._n() - n0 - (self._admit_syncs - a0))

        pb._step, pb._many_prog = counted_step, counted_many
        if syncs:
            pb._admit, pb.step_many = counted_admit, counted_step_many

    def _n(self):
        return 0 if self.rec is None else sum(
            "synchroniz" in str(w.message) for w in self.rec)


def serve18_run(S, params, cfg, reqs, cls="PagedBatcher", prefix=None,
                multi_step=SERVE18_WINDOW, defer=True, syncs=False,
                adapters=(), grouped=True, **kw):
    """The requests through a fresh batcher on the card; returns (outputs
    in order, wall s, metrics, meter, batcher, peak GiB)."""
    import warnings

    pool = (SERVE18_POOL if cls == "PagedBatcher"
            else {"n_slots": SERVE18_POOL["n_slots"]})
    b = getattr(S, cls)(params, cfg, device="cuda", **pool, **kw)
    if not grouped:
        b._group_prefill = False
    for ad in adapters:
        b.register_adapter(ad)
    if prefix is not None:
        b.register_prefix(prefix)
    meter = Serve18Meter(b, syncs)
    prompts, news, kws = reqs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        if syncs:
            meter.rec = rec
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            ctx = b.defer_admission() if defer else contextlib.nullcontext()
            with ctx:
                rids = [b.submit(p, m, **k)
                        for p, m, k in zip(prompts, news, kws)]
            done = b.run(multi_step=multi_step)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    outs = [done[r] for r in rids]
    check(all(o.shape == (m,) for o, m in zip(outs, news)),
          f"phase 18 {cls}: a request did not return max_new tokens")
    return outs, wall, b.metrics, meter, b, peak


def serve18_line(name, outs, wall, met, peak=None):
    n_tok = sum(len(o) for o in outs)
    line = (f"{name}{' ' if name else ''}{n_tok / wall:.1f} tok/s ({n_tok} tokens in "
            f"{wall:.3f} s), ttft_mean {met['ttft_mean_s'] * 1e3:.1f} ms, "
            f"itl_mean {met['itl_mean_s'] * 1e3:.3f} ms")
    return line + (f", peak {peak:.2f} GiB" if peak is not None else "")


def serve18_k11(PA, cfg, meter, before, name):
    """Check K11's launches since `before` against n_layer x the decode
    steps the scheduler ran; returns them."""
    n = PA.paged_attention.launches - before
    check(n == cfg.n_layer * meter.steps,
          f"phase 18 {name}: paged_attention launches {n} != n_layer "
          f"{cfg.n_layer} x decode steps {meter.steps}")
    return n


def agree(a_outs, b_outs, greedy):
    """(requests whose tokens are all the same, of the greedy ones)."""
    return sum(np.array_equal(a, b) for a, b, g in zip(a_outs, b_outs, greedy)
               if g), sum(greedy)


def serve18_int8_layouts(T):
    """The W8A8 product (`transformer._int8_mm`: torch._int_mm, exact in
    int32) at phase 18's decode shapes, 8 rows by each layer matrix and
    the head, with the int8 weight stored row-major and column-major:
    both exact against a float64 product; CUDA-event times."""
    g = torch.Generator("cuda").manual_seed(0)
    d, f, V = SERVE18["d_model"], SERVE18["d_ff"], SERVE18["vocab_size"]
    parts = []
    for K, N in ((d, 3 * d), (d, d), (d, f), (f, d), (d, V)):
        x = torch.randint(-127, 128, (8, K), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        want = x.double() @ w.double()
        times = []
        for ww in (w, w.mT.contiguous().mT):
            check(torch.equal(T._int8_mm(x, ww).double(), want),
                  f"phase 18: the int8 product {K}x{N} is not exact")
            times.append(cuda_ms(lambda: T._int8_mm(x, ww), 50))
        parts.append(f"{K}x{N} row-major {times[0]:.4f} / column-major "
                     f"{times[1]:.4f} ms")
    return ("W8A8 product at 8 rows (torch._int_mm, exact; weight layout "
            "row- / column-major): " + "; ".join(parts))


def phase_serving_rest(T, PA, S, LR, smi_line, n_req=32, f32_req=8,
                       spec_new=64):
    """Phase 18: the rest of serving at phase 4's width. Returns the K11
    launches of its paged runs."""
    from neuronika_tpu_torch._tree import tree_map

    t0 = time.perf_counter()
    cfg = T.GPTConfig(dtype=torch.bfloat16, **SERVE18)
    params = T.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                           "cuda")
    rng = np.random.default_rng(18)
    prefix = rng.integers(0, cfg.vocab_size, SERVE18_PREFIX).astype(np.int32)
    reqs = serve18_requests(rng, cfg.vocab_size, n_req, prefix)
    greedy = [not k for k in reqs[2]]
    k11 = 0
    lines = [serve18_int8_layouts(T)]
    feat = dict(kernel="on", **SERVE18_FEATURES)

    # (a) the full PagedBatcher in bf16 and with int8 and int4 weights
    res = {}
    for quant in (None, "int8", "int4"):
        warm = ([p[:80] for p in reqs[0][:2]], [4, 4], [{}, {}])
        serve18_run(S, params, cfg, warm, prefix=prefix, quant=quant,
                    **feat)
        before = PA.paged_attention.launches
        outs, wall, met, meter, b, peak = serve18_run(
            S, params, cfg, reqs, prefix=prefix, quant=quant,
            syncs=quant is None, **feat)
        k11 += serve18_k11(PA, cfg, meter, before, f"quant={quant}")
        res[quant] = (outs, wall, met, meter, tree_bytes(b.params), peak)
        del b
    outs, wall, met, meter, wbytes, peak = res[None]
    ws = meter.window_syncs
    check(ws and max(ws) == 1,
          f"phase 18: device-to-host syncs per window {sorted(set(ws))}, "
          f"want 1 (the one read of the window's tokens)")
    lines.append(
        f"(a) PagedBatcher kernel='on', prefill_chunk 256, bucket pow2, a "
        f"256-token prefix, defer_admission, run(multi_step=8), {n_req} "
        f"requests (prompts 64-700, max_new 32-128, every 4th sampled): "
        + serve18_line("bf16", outs, wall, met, peak)
        + f"; {meter.steps} decode steps ({meter.windows} windows of up to "
        f"8), K11 launches = {cfg.n_layer} x steps; syncs per window "
        f"{min(ws)}-{max(ws)} over {len(ws)} windows")
    for quant in ("int8", "int4"):
        q_outs, q_wall, q_met, _, q_bytes, q_peak = res[quant]
        same, of = agree(q_outs, outs, greedy)
        lines.append(
            serve18_line(quant, q_outs, q_wall, q_met, q_peak)
            + f"; decode weights {q_bytes / 2 ** 20:.1f} MiB vs bf16 "
            f"{wbytes / 2 ** 20:.1f} MiB; greedy requests equal to bf16's: "
            f"{same} of {of}")

    # (b) the dense-slot ContinuousBatcher, bf16 and int8-kv
    for quant in (None, "int8-kv"):
        d_outs, d_wall, d_met, _, b, d_peak = serve18_run(
            S, params, cfg, reqs, cls="ContinuousBatcher", prefix=prefix,
            quant=quant, **SERVE18_FEATURES)
        same, of = agree(d_outs, outs, greedy)
        lines.append(f"(b) ContinuousBatcher quant={quant}: "
                     + serve18_line("", d_outs, d_wall, d_met, d_peak)
                     + f"; greedy requests equal to paged bf16's: {same} of "
                     f"{of}")
        del b

    # (c) two S-LoRA adapters (rank 8 on qkv and proj) in a mixed batch
    ads = []
    for seed in (1, 2):
        g = torch.Generator("cuda").manual_seed(seed)
        ad = LR.lora_init(g, params, 8)
        for ab in ad.values():
            ab["B"] = 0.02 * torch.randn(ab["B"].shape, generator=g,
                                         device="cuda")
        ads.append(ad)
    a_reqs = (reqs[0], reqs[1], [dict(k, adapter=i % 3)
                                 for i, k in enumerate(reqs[2])])
    before = PA.paged_attention.launches
    a_outs, a_wall, a_met, meter, b, _ = serve18_run(
        S, params, cfg, a_reqs, adapters=ads, prefix=prefix, **feat)
    k11 += serve18_k11(PA, cfg, meter, before, "adapters")
    base_same = sum(np.array_equal(x, y) for x, y, k, g in
                    zip(a_outs, outs, a_reqs[2], greedy)
                    if g and k["adapter"] == 0)
    lines.append(f"(c) two adapters, rank 8 on qkv and proj, requests "
                 f"cycling adapters 0/1/2: "
                 + serve18_line("", a_outs, a_wall, a_met)
                 + f"; {meter.steps} decode steps, K11 = {cfg.n_layer} x "
                 f"steps; base "
                 f"requests equal to (a)'s: {base_same}")
    del b

    # (d) speculative decoding, gamma 4: the target as its own draft, and
    # its first two blocks (with its embedding and head) as the draft
    prompt = rng.integers(0, cfg.vocab_size, (1, 128)).astype(np.int32)
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    params2 = dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"]))
    plain = T.make_generate(cfg, spec_new)
    plain(params, prompt)                                 # warm-up
    torch.cuda.synchronize()
    ts = time.perf_counter()
    ref = plain(params, prompt).cpu().numpy()
    plain_tps = spec_new / (time.perf_counter() - ts)
    spec_line = [f"(d) speculative gamma 4, B1, prompt 128, {spec_new} new: "
                 f"plain make_generate {plain_tps:.1f} tok/s"]
    for name, (dcfg, dparams) in (("self-draft", (cfg, params)),
                                  ("2-block draft", (cfg2, params2))):
        spec = T.make_speculative_generate(cfg, dcfg, spec_new, gamma=4)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        toks, passes = spec(params, dparams, prompt)
        toks = toks.cpu().numpy()
        tps = spec_new / (time.perf_counter() - ts)
        if name == "self-draft":
            check(passes <= -(-spec_new // 5) + 1,
                  f"phase 18: self-draft took {passes} target passes")
        spec_line.append(f"{name} {passes} target passes, {tps:.1f} tok/s, "
                         f"{int((toks == ref).all())} (1 = equal) against "
                         f"bf16 greedy")
    lines.append("; ".join(spec_line))
    torch.cuda.empty_cache()

    # (e) f32 greedy identities at the same width
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(181)
    r32 = serve18_requests(rng, cfg.vocab_size, f32_req, prefix,
                           new_lo=16, new_hi=24, sampled_every=0)
    one = dict(kernel="on", multi_step=1, defer=False, grouped=False)
    before = PA.paged_attention.launches
    ref_outs, *_, meter, b, _ = serve18_run(S, params, cfg32, r32, **one)
    k11 += serve18_k11(PA, cfg32, meter, before, "f32 per-step")
    del b
    runs = {
        "every feature": dict(prefix=prefix, **feat),
        "multi_step 8": dict(one, multi_step=SERVE18_WINDOW),
        "grouped (defer)": dict(one, defer=True, grouped=True),
        "prefix": dict(one, prefix=prefix),
        "chunked 256": dict(one, prefill_chunk=256),
        "bucketed pow2": dict(one, prefill_bucket="pow2"),
    }
    for name, kw in runs.items():
        before = PA.paged_attention.launches
        o, *_, meter, b, _ = serve18_run(S, params, cfg32, r32, **kw)
        k11 += serve18_k11(PA, cfg32, meter, before, f"f32 {name}")
        check(all(np.array_equal(x, y) for x, y in zip(o, ref_outs)),
              f"phase 18: f32 greedy tokens of '{name}' differ from the "
              f"plain per-step PagedBatcher's")
        del b
    g32 = T.make_generate(cfg32, 32)(params, prompt).cpu().numpy()
    s32, passes = T.make_speculative_generate(cfg32, dataclasses.replace(
        cfg2, dtype=torch.float32), 32, gamma=4)(params, params2, prompt)
    check(np.array_equal(s32.cpu().numpy(), g32),
          "phase 18: f32 speculative tokens differ from make_generate's")
    lines.append(f"(e) f32 greedy tokens identical to the plain per-step "
                 f"PagedBatcher (kernel='on', exact one-by-one prefill) on "
                 f"{f32_req} requests for: " + ", ".join(runs)
                 + f"; speculative (2-block draft, {passes} passes) = "
                 f"make_generate over 32 tokens")
    del params, params2
    gc.collect()
    torch.cuda.empty_cache()
    for line in lines:
        print(f"phase 18 {line} [{smi_line}]")
    print(f"phase 18 rest of serving: {time.perf_counter() - t0:.1f} s, "
          f"{k11} K11 launches [{smi_line}]")
    return k11


# --------------------------------------------------------------------------
# phase 19: the attention kernels at every head dim and group size JAX's
# take, the remat policies, StarCoderBase-1B and Phi-3-mini

# K1/K2 cases (name, H, KV, hd, S, causal, fast): hd 36 rows are not
# 16-byte aligned (element loads), S 257 is ragged, G 16 is MQA, past 8
# q heads a kv head (K2b and the fused K2 on a cluster); in f32, and in
# bf16 but at G 16 hd 128, on the mma.sync/FFMA kernels' head-dim tiers
WIDE_FLASH_CASES = (
    ("hd32-gqa", 8, 2, 32, 384, True, False),
    ("hd36-gqa-S257", 6, 3, 36, 257, True, False),
    ("hd72-full", 4, 4, 72, 384, False, False),
    ("hd80", 4, 4, 80, 384, True, False),
    ("hd96-fast", 4, 4, 96, 384, True, True),
    ("hd256", 2, 2, 256, 384, True, False),
    ("g16-hd128", 16, 1, 128, 384, True, False),
    ("g16-hd96-S257", 16, 1, 96, 257, True, False),
)
# bf16 K1/K2 cases past 8 q heads a kv head on the Hopper route (name, H,
# KV, hd, S, causal, fast): K1 and K2a a CTA per q tile, K2b and the fused
# K2 the group split over a cluster (G 9 and 12 unevenly)
WIDE_SM90_CASES = (
    ("g9-hd64-S257", 9, 1, 64, 257, True, False),
    ("g9-hd128-full", 18, 2, 128, 384, False, False),
    ("g12-hd64-full-S257", 12, 1, 64, 257, False, False),
    ("g12-hd128", 24, 2, 128, 384, True, False),
    ("g32-hd64-fast", 32, 1, 64, 384, True, True),
    ("g32-hd128-S257", 32, 1, 128, 257, True, False),
)
# K5-K7 cases (name, B, H, Sq, Skv, causal, window, hd), strided views
WIDE_SPLIT_CASES = (
    ("hd32-window50", 2, 4, 384, 384, True, 50, 32),
    ("hd36-causal-S257", 2, 3, 257, 257, True, 0, 36),
    ("hd72-full-Sq130-Skv300", 2, 4, 130, 300, False, 0, 72),
    ("hd80-window100", 2, 4, 384, 384, True, 100, 80),
    ("hd96-window127-S300", 2, 4, 300, 300, True, 127, 96),
    ("hd256-causal", 2, 2, 384, 384, True, 0, 256),
)
# K11 cases (name, KV, G, hd) at phase 3's table shape (B8 BS16 MB64)
WIDE_PAGED_CASES = (
    ("g1-hd96", 4, 1, 96), ("g3-hd72", 2, 3, 72), ("g8-hd32", 2, 8, 32),
    ("g12-hd36", 2, 12, 36), ("g16-hd128", 1, 16, 128),
    ("g16-hd256", 1, 16, 256), ("g32-hd80", 1, 32, 80),
)
WIDE_RATE, WIDE_SEED = 0.1, 2 ** 33 + 5


def wide_flash_checks(rng, FA):
    """K1, K2a+K2b and the fused K2 at WIDE_FLASH_CASES, f32 and bf16,
    without and with dropout at WIDE_RATE, each at check_flash's bounds;
    then at G 16 (bf16, hd 128) two launches of the fused K2 and of K2b,
    each on its cluster walk, must give the same bits. Returns {kernel:
    worst max abs err}."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, H, KV, hd, S, causal, fast in WIDE_FLASH_CASES:
            qkv, do = flash_case(rng, 2, H, KV, hd, S, dtype)
            for rate in (0.0, WIDE_RATE):
                errs, _, _ = check_flash(
                    FA, f"{str(dtype)[6:]}/{name}/p{rate}", qkv, do, H, KV,
                    causal, fast, seed=WIDE_SEED, rate=rate)
                for k, e in errs.items():
                    worst[k] = max(worst.get(k, 0.0), e)
            del qkv, do
    qkv, do = flash_case(rng, 2, 16, 1, 128, 1000, torch.bfloat16)
    out, lse = FA.flash_fwd_qkv(qkv, 16, 1)
    again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, 16, 1)
             for _ in range(2)]
    check(torch.equal(*again), "flash_bwd_fused_qkv G16: two launches on "
          "the same inputs differ")
    again = [FA.flash_bwd_dkv_qkv(qkv, out, lse, do, torch.zeros_like(qkv),
                                  16, 1) for _ in range(2)]
    check(torch.equal(*again), "flash_bwd_dkv_qkv G16: two launches on the "
          "same inputs differ")
    for k in (FA.flash_bwd_dkv_qkv, FA.flash_bwd_fused_qkv):
        check(k.route.startswith("sm90 cluster"),
              f"{k.__name__} G16 ran {k.route}")
    return worst


def flash_routes(FA):
    """{kernel: the route of its last launch} of K1, K2a, K2b, fused K2."""
    return {k.__name__: k.route for k in FA.KERNELS}


def wide_sm90_checks(rng, FA):
    """K1, K2a+K2b and the fused K2 at WIDE_SM90_CASES (bf16), without and
    with dropout at WIDE_RATE, at check_flash's bounds; each case prints
    the route each kernel took, and fails unless K1 and K2a ran the Hopper
    kernels, K2b its cluster walk at dkv_cluster's size and the fused K2
    its cluster walk at fused_cluster's. Returns {kernel: worst max abs
    err}."""
    worst = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, H, KV, hd, S, causal, fast in WIDE_SM90_CASES:
        qkv, do = flash_case(rng, 2, H, KV, hd, S, torch.bfloat16)
        C = FA.dkv_cluster(2, KV, S, H // KV, sms)
        Cf = FA.fused_cluster(2, KV, S, H // KV, sms)
        want = {"flash_fwd_qkv": "sm90", "flash_bwd_dq_qkv": "sm90",
                "flash_bwd_dkv_qkv": f"sm90 cluster {C}",
                "flash_bwd_fused_qkv": f"sm90 cluster {Cf}"}
        for rate in (0.0, WIDE_RATE):
            key = f"bfloat16/{name}/p{rate}"
            errs, _, _ = check_flash(FA, key, qkv, do, H, KV, causal, fast,
                                     seed=WIDE_SEED, rate=rate)
            routes = flash_routes(FA)
            print(f"  {key} routes: {json.dumps(routes)}")
            check(routes == want, f"{key}: routes {routes}, want {want}")
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
        del qkv, do
    return worst


def wide_split_checks(FA):
    """K5-K7 at WIDE_SPLIT_CASES, f32 and bf16, without and with dropout at
    WIDE_RATE, at check_split's bounds. Returns {kernel: worst max abs
    err}."""
    g = torch.Generator(device="cuda").manual_seed(19)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, H, Sq, Skv, causal, window, hd in WIDE_SPLIT_CASES:
            q, k, v, do = split_case(g, B, H, Sq, Skv, hd, dtype)
            for rate in (0.0, WIDE_RATE):
                errs, _ = check_split(FA, f"{str(dtype)[6:]}/{name}/p{rate}",
                                      q, k, v, do, causal, window,
                                      seed=WIDE_SEED, rate=rate)
                for kname, e in errs.items():
                    worst[kname] = max(worst.get(kname, 0.0), e)
            del q, k, v, do
    return worst


def wide_paged_checks(rng, PA):
    """K11 at WIDE_PAGED_CASES, f32 and bf16, windows 0 and 9, against the
    plain version at phase 3's bounds (paged_held); at G 16 hd 128 two
    launches must give the same bits. Returns the worst max abs err."""
    worst = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, KV, G, hd in WIDE_PAGED_CASES:
            args = paged_case(rng, dtype=dtype,
                              **dict(PAGED_TABLE, KV=KV, G=G, hd=hd))
            for window in (0, 9):
                out = PA.paged_attention(*args, window=window)
                ref = PA.paged_attention_reference(*args, window=window)
                err, rel, ok = paged_held(out, ref, tol)
                check(ok, f"paged_attention {str(dtype)[6:]}/{name}/w"
                          f"{window}: max abs err {err}, ||err||/||ref|| "
                          f"{rel}")
                worst = max(worst, err)
                if window == 0 and name == "g16-hd128":
                    check(torch.equal(out, PA.paged_attention(*args)),
                          f"paged_attention {name}: two launches differ")
    return worst


def packed_bound(name, B, H, KV, hd, S):
    """(bound_ms, FLOPs) of one K1/K2 kernel on bf16 packed (B, S, (H + 2
    KV) hd), causal: qkv (and out, lse, do in the backward) read once, the
    outputs written once; 2 FLOPs a multiply-add over half the S x S pairs
    of each of the kernel's products (fwd s, pv; dq s, dp, dq; dk/dv s,
    dp, dv, dk; fused all five)."""
    W, D = (H + 2 * KV) * hd, H * hd
    el, lse = B * S * 2, B * H * S * 4
    moved = {"flash_fwd_qkv": W + D, "flash_bwd_dq_qkv": W + 3 * D,
             "flash_bwd_dkv_qkv": W + 2 * D + 2 * KV * hd,
             "flash_bwd_fused_qkv": 2 * W + 2 * D}
    passes = {"flash_fwd_qkv": 2, "flash_bwd_dq_qkv": 3,
              "flash_bwd_dkv_qkv": 4, "flash_bwd_fused_qkv": 5}
    flops = 2 * passes[name] * B * H * S * S * hd / 2
    return bound_ms(el * moved[name] + lse, flops, torch.bfloat16), flops


def wide_packed_times(rng, FA, B, H, KV, hd, S):
    """K1, K2a, K2b and the fused K2 at a bf16 causal packed shape: first
    each against the plain versions on the same input (check_flash, phase
    3's bounds), then each kernel's CUDA-event time (kernel, kernel between
    plain, plain), the plain forward's and backward's, SDPA's forward and
    backward on the same q with k and v repeated to H (repeated before
    timing), and the bound. Returns {kernel: (ms, plain_ms, library_ms,
    bound, max abs err)}; prints the route each kernel took and, past 8
    q heads a kv head, holds K2b and the fused K2 to the same bits over two
    launches and every kernel to check_flash's bounds at dropout WIDE_RATE
    too."""
    import torch.nn.functional as F

    qkv, do = flash_case(rng, B, H, KV, hd, S, torch.bfloat16)
    key = f"bfloat16/model-B{B}-S{S}-H{H}-KV{KV}-hd{hd}-causal"
    errs, (out, lse), _ = check_flash(FA, key, qkv, do, H, KV, True, False)
    print(f"  {key} routes: {json.dumps(flash_routes(FA))}")
    if H // KV > 8:
        check_flash(FA, f"{key}/p{WIDE_RATE}", qkv, do, H, KV, True, False,
                    seed=WIDE_SEED, rate=WIDE_RATE)
        again = [FA.flash_bwd_dkv_qkv(qkv, out, lse, do,
                                      torch.zeros_like(qkv), H, KV)
                 for _ in range(2)]
        check(torch.equal(*again), f"flash_bwd_dkv_qkv {key}: two launches "
              "on the same inputs differ")
        again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV)
                 for _ in range(2)]
        check(torch.equal(*again), f"flash_bwd_fused_qkv {key}: two "
              "launches on the same inputs differ")
        del again
    d_qkv = torch.empty_like(qkv)
    kern = {"flash_fwd_qkv": lambda: FA.flash_fwd_qkv(qkv, H, KV),
            "flash_bwd_dq_qkv": lambda: FA.flash_bwd_dq_qkv(
                qkv, out, lse, do, d_qkv, H, KV),
            "flash_bwd_dkv_qkv": lambda: FA.flash_bwd_dkv_qkv(
                qkv, out, lse, do, d_qkv, H, KV),
            "flash_bwd_fused_qkv": lambda: FA.flash_bwd_fused_qkv(
                qkv, out, lse, do, H, KV)}
    plain = {"fwd": lambda: FA.flash_attention_qkv_fwd_reference(qkv, H, KV),
             "bwd": lambda: FA.flash_attention_qkv_bwd_reference(
                 qkv, out, lse, do, H, KV)}
    p_ms = {k: [cuda_ms(fn, 1)] for k, fn in plain.items()}
    k_ms = {k: min(cuda_ms(fn, 5), cuda_ms(fn, 5)) for k, fn in kern.items()}
    for k, fn in plain.items():
        p_ms[k].append(cuda_ms(fn, 1))
    q, kk, v = FA._unpack(qkv, H, KV)
    G = H // KV
    q = q.reshape(B, H, S, hd).detach().requires_grad_()
    kk, v = (t.repeat_interleave(G, 1).detach().requires_grad_()
             for t in (kk, v))
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kk, v, is_causal=True), 5)
    o = F.scaled_dot_product_attention(q, kk, v, is_causal=True)
    g = torch.randn_like(o)
    lib_b = cuda_ms(lambda: torch.autograd.grad(o, (q, kk, v), g,
                                                retain_graph=True), 5)
    del o, q, kk, v, g
    res = {}
    for name, ms in k_ms.items():
        fwd = name == "flash_fwd_qkv"
        res[name] = (ms, min(p_ms["fwd" if fwd else "bwd"]),
                     lib_f if fwd else lib_b,
                     packed_bound(name, B, H, KV, hd, S)[0], errs[name])
    return res


def wide_split_times(FA, B, H, S, hd, window):
    """K5, K6 and K7 at a bf16 causal windowed split shape: first each
    against the plain versions on the same input (check_split, phase 3's
    bounds), then CUDA-event times as wide_packed_times, the plain
    versions', SDPA's with the band as a boolean mask (sdpa_band_ms) and
    split_bound. Returns {kernel: (ms, plain_ms, library_ms, bound, max
    abs err)}."""
    g = torch.Generator(device="cuda").manual_seed(96)
    q, k, v, do = split_case(g, B, H, S, S, hd, torch.bfloat16,
                             strided=False)
    errs, _ = check_split(FA, f"bfloat16/model-B{B}-H{H}-S{S}-hd{hd}-window"
                              f"{window}", q, k, v, do, True, window)
    out, lse = FA.flash_fwd(q, k, v, True, window=window)
    delta = (do.float() * out.float()).sum(-1)
    kern = {"flash_fwd": lambda: FA.flash_fwd(q, k, v, True, window=window),
            "flash_bwd_dq": lambda: FA.flash_bwd_dq(
                q, k, v, do, lse, delta, True, window=window),
            "flash_bwd_dkv": lambda: FA.flash_bwd_dkv(
                q, k, v, do, lse, delta, True, window=window)}
    plain = {"fwd": lambda: FA.flash_attention_fwd_reference(
                 q, k, v, True, window=window),
             "bwd": lambda: FA.flash_attention_bwd_reference(
                 q, k, v, do, lse, delta, True, window=window)}
    p_ms = {n: [cuda_ms(fn, 1)] for n, fn in plain.items()}
    k_ms = {n: min(cuda_ms(fn, 5), cuda_ms(fn, 5)) for n, fn in kern.items()}
    for n, fn in plain.items():
        p_ms[n].append(cuda_ms(fn, 1))
    lib_f, lib_b = sdpa_band_ms(q, k, v, do, window)
    return {name: (ms, min(p_ms["fwd" if name == "flash_fwd" else "bwd"]),
                   lib_f if name == "flash_fwd" else lib_b,
                   split_bound(name, B, H, S, hd, True, window)[0],
                   errs[name])
            for name, ms in k_ms.items()}


def wide_paged_times(rng, PA, KV, G, hd, MB, pos):
    """K11 at a bf16 decode shape (B = len(pos), BS 16): first against the
    plain version on the same input (paged_held, phase 3's bounds), then
    the kernel's and the plain version's device times (profiler; plain,
    kernel, kernel, plain) and paged_bound. Returns (ms, plain_ms, None,
    bound, max abs err)."""
    args = paged_case(rng, B=len(pos), KV=KV, G=G, hd=hd, BS=16, MB=MB,
                      pos=pos, inactive=[], dtype=torch.bfloat16)
    ref = lambda: PA.paged_attention_reference(*args)  # noqa: E731
    kern = lambda: PA.paged_attention(*args)  # noqa: E731
    err, rel, ok = paged_held(kern(), ref(), BF16_TOL)
    check(ok, f"paged_attention bfloat16/model-KV{KV}-G{G}-hd{hd}-MB{MB}: "
              f"max abs err {err}, ||err||/||ref|| {rel}")
    pa = device_ms(ref, 10)
    ka, kb = device_ms(kern, 100), device_ms(kern, 100)
    pb = device_ms(ref, 10)
    return min(ka, kb), min(pa, pb), None, paged_bound(args), err


# StarCoderBase-1B (bigcode/starcoderbase-1b config.json: n_embd 2048,
# n_layer 24, n_head 16, multi_query -> 1 kv head, n_inner 8192, vocab
# 49152, n_positions 8192; learned positions, LayerNorm, tanh GELU, biases,
# tied head): full depth
STARCODER_1B = dict(vocab_size=49152, n_layer=24, n_head=16, n_kv_head=1,
                    d_model=2048, d_ff=8192, max_seq=8192)
# Phi-3-mini-4k (microsoft/Phi-3-mini-4k-instruct config.json: hidden
# 3072, 32 heads over 32 kv heads (hd 96), intermediate 8192, vocab 32064,
# 4096 positions, rope_theta 10000, rms_norm_eps 1e-5, sliding_window
# 2047, untied head) cut from 32 to 4 layers
PHI3_MINI = dict(vocab_size=32064, n_layer=4, n_head=32, d_model=3072,
                 d_ff=8192, max_seq=4096, rope_theta=10000.0, norm_eps=1e-5,
                 window=2047)
# every remat policy's losses against "full"'s, relative: the policies
# keep or recompute the same deterministic kernels and GEMMs, so this
# allows one bf16 ulp where a GEMM's reduction order differs
REMAT_LOSS_REL = 2 ** -8
# phase 19's Adam rate: a random 24-layer model takes sign-like first Adam
# steps without warmup, and at 1e-4 its third loss rose above its first
# (PERF.md); phase 19 (a) runs both attention routes at WITNESS_LR and
# prints whether the composite's loss rises the same way
WIDE_LR = 2e-5
WITNESS_LR = 1e-4
# the bf16 loss of the kernel route against the composite's, relative:
# the two round p to bf16 in other places and sum in other orders
ROUTE_BF16_REL = 2 ** -7
# the bf16 gradients of a kernel route against the composite's, ||g -
# g_off|| / ||g_off|| over all leaves of StarCoderBase-1B: the split route
# reads 0.0149 on an H100 (PERF.md); twice that, rounded up to a power of 2
ROUTE_GRAD_BF16_REL = 2 ** -5


def lm_batch(rng, vocab, B, S):
    """Uniform tokens and their next-token targets on the card."""
    toks = rng.integers(0, vocab, size=(B, S))
    return (torch.from_numpy(toks).to("cuda"),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))


def phase_starcoder(T, FA, CE, profile=None):
    """Phase 19 (a): the GPT train step at StarCoderBase-1B's published
    widths, full depth, S 2048, B 8, bf16, the GPTConfig defaults (remat
    "full", split backward, f32 Adam) with flash "on" (1 warm-up, 2 timed
    steps, and with a `profile` path one more under the profiler), the
    same with flash_bwd "fused" (likewise) and "auto" (1 warm-up, 1
    counted step): K1 and K2a/K2b at G 16 (the Hopper kernels, K2b on its
    cluster walk), 2 L, L and L launches a step, or K1 and the fused K2 (on
    its cluster walk) 2 L and L, no composite; first the forward loss
    through K1 against the composite's (ROUTE_BF16_REL), and the gradients
    through K1 and the split pair, then through K1 and the fused K2,
    against the composite's (||g - g_off|| / ||g_off||, overall held to
    ROUTE_GRAD_BF16_REL, and the worst leaf). Last, the witness for
    WIDE_LR: both routes from the same seed and batch at WITNESS_LR (1
    warm-up, 2 timed steps), their losses printed with whether the third
    rose above the first, the kernel route's each within ROUTE_BF16_REL of
    the composite's. Returns the launches of the kernel runs, summed."""
    rng = np.random.default_rng(1)
    B, S = 8, 2048
    batch = lm_batch(rng, STARCODER_1B["vocab_size"], B, S)
    kernels = train_kernels(FA, CE)
    # first the forward loss through K1 against the composite's, on the
    # step's initial params
    cfg = T.GPTConfig(dtype=torch.bfloat16, **STARCODER_1B)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    with torch.no_grad():
        fwd = {f: float(T.loss_fn(params, *batch,
                                  dataclasses.replace(cfg, flash=f)))
               for f in ("on", "off")}
    gaps = route_grad_gap(T, params, batch, [
        cfg, dataclasses.replace(cfg, flash_bwd="fused")])
    del params
    torch.cuda.empty_cache()
    rel = abs(fwd["on"] - fwd["off"]) / fwd["off"]
    check(rel <= ROUTE_BF16_REL, f"phase 19 StarCoder: the loss through K1 "
          f"{fwd['on']} against the composite's {fwd['off']}")
    for bwd, gap in zip(("K2a/K2b", "the fused K2"), gaps):
        check(gap[0] <= ROUTE_GRAD_BF16_REL, f"phase 19 StarCoder: the "
              f"gradients through K1 and {bwd} against the composite's, "
              f"||g - g_off|| / ||g_off|| {gap[0]}")
    total, parts = {}, [f"the forward loss through K1 {fwd['on']:.5f}, "
                        f"the composite's {fwd['off']:.5f} (bound "
                        f"{ROUTE_BF16_REL:.3g} relative); gradients against "
                        f"the composite's, ||g - g_off|| / ||g_off|| (bound "
                        f"{ROUTE_GRAD_BF16_REL:.3g}): through K1/K2a/K2b "
                        f"{gaps[0][0]:.4g}, worst leaf {gaps[0][1]:.4g} "
                        f"({gaps[0][2]}); through K1 and the fused K2 "
                        f"{gaps[1][0]:.4g}, worst leaf {gaps[1][1]:.4g} "
                        f"({gaps[1][2]})"]
    steps = []
    for flash, bwd, n in (("on", "split", 2), ("on", "fused", 2),
                          ("auto", "split", 1)):
        cfg = T.GPTConfig(dtype=torch.bfloat16, flash=flash, flash_bwd=bwd,
                          **STARCODER_1B)
        losses, launches, step_s, peak, _ = train_steps(
            T, kernels, cfg, 1, n, batch, WIDE_LR,
            profile_path(profile, "starcoder" if bwd == "split"
                         else "starcoder_fused") if flash == "on" else None,
            f"one StarCoderBase-1B step, {bwd} backward")
        L = cfg.n_layer
        want = want_launches(kernels, flash_fwd_qkv=2 * L * n, **(
            dict(flash_bwd_dq_qkv=L * n, flash_bwd_dkv_qkv=L * n)
            if bwd == "split" else dict(flash_bwd_fused_qkv=L * n)))
        key = f"phase 19 StarCoder {flash} {bwd}"
        check(all(np.isfinite(losses)), f"{key}: loss {losses}")
        check(losses[-1] < losses[0], f"{key}: loss did not fall: {losses}")
        check(launches == want, f"{key}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        tok_s = B * S / step_s
        mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
        steps.append(f"flash={flash!r} flash_bwd={bwd!r}: step "
                     f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU "
                     f"{mfu:.4f}, peak {peak:.2f} GiB, losses "
                     f"{[round(l, 4) for l in losses]}, "
                     + " ".join(f"{name} {launches[k]}" for name, k in (
                         ("K1", "flash_fwd_qkv"), ("K2a", "flash_bwd_dq_qkv"),
                         ("K2b", "flash_bwd_dkv_qkv"),
                         ("fused K2", "flash_bwd_fused_qkv")))
                     + f" in {n} step(s)")
    parts.append(" | ".join(steps))
    wit = {}
    for flash in ("off", "on"):
        cfg = T.GPTConfig(dtype=torch.bfloat16, flash=flash, **STARCODER_1B)
        losses, launches, _, peak, _ = train_steps(
            T, kernels, cfg, 1, 2, batch, WITNESS_LR)
        wit[flash] = losses
        L = cfg.n_layer
        want = want_launches(kernels, **({} if flash == "off" else dict(
            flash_fwd_qkv=4 * L, flash_bwd_dq_qkv=2 * L,
            flash_bwd_dkv_qkv=2 * L)))
        check(all(np.isfinite(losses)), f"phase 19 StarCoder witness "
                                        f"{flash}: loss {losses}")
        check(launches == want, f"phase 19 StarCoder witness {flash}: "
                                f"launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        parts.append(f"witness at lr {WITNESS_LR}, flash={flash!r}: losses "
                     f"{[round(l, 4) for l in losses]}, third "
                     f"{'above' if losses[2] > losses[0] else 'below'} the "
                     f"first, peak {peak:.2f} GiB")
    rel = max(abs(a - b) / b for a, b in zip(wit["on"], wit["off"]))
    check(rel <= ROUTE_BF16_REL, f"phase 19 StarCoder witness: the kernel "
          f"route's losses {wit['on']} against the composite's {wit['off']}")
    line = ("phase 19 train: StarCoderBase-1B widths (d2048 L24 H16 KV1 "
            "hd128 d_ff 8192 V49152, learned positions, tied head), S2048 "
            f"B8 bf16, remat full, f32 Adam at {WIDE_LR}; "
            + "; ".join(parts))
    print(line)
    return total


def route_grad_gap(T, params, batch, cfgs):
    """The train loss's gradients through the kernels (flash "on") of each
    config of `cfgs` against the composite's (flash "off", of the first)
    on the same params and batch: [(||g - g_off|| / ||g_off|| over all
    leaves, the worst leaf's, its index)], one a config."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    def grads(cfg, flash):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = T.loss_fn(tree_unflatten(params, leaves), *batch,
                         dataclasses.replace(cfg, flash=flash), train=True)
        return torch.autograd.grad(loss, leaves)

    g_off = grads(cfgs[0], "off")
    r2 = [float(b.double().square().sum()) for b in g_off]
    gaps = []
    for cfg in cfgs:
        g_on = grads(cfg, "on")
        e2 = [float((a.double() - b.double()).square().sum())
              for a, b in zip(g_on, g_off)]
        del g_on
        rel = [math.sqrt(e / max(r, 1e-300)) for e, r in zip(e2, r2)]
        worst = int(np.argmax(rel))
        gaps.append((math.sqrt(sum(e2) / sum(r2)), rel[worst], worst))
    return gaps


def phase_phi3(T, FA, CE):
    """Phase 19 (b): `llama_config` at Phi-3-mini-4k's published widths,
    cut to 4 layers, S 4096, B 2, bf16, K5-K7 at hd 96 under the window:
    1 warm-up and 2 timed steps under each remat policy from the same seed
    and batch. Every policy's losses within REMAT_LOSS_REL of "full"'s; K5
    launched 2 L a step under "full" and "dots" (the recompute reruns it),
    L under "flash", "names" and "flash_dots" (its outputs kept); K6 and
    K7 L each. Returns the launches summed over the policies and
    {policy: (step ms, peak GiB)}."""
    rng = np.random.default_rng(2)
    B, S, n = 2, 4096, 2
    batch = lm_batch(rng, PHI3_MINI["vocab_size"], B, S)
    kernels = train_kernels(FA, CE)
    total, per, ref = {}, {}, None
    for policy in ("full", "flash", "names", "dots", "flash_dots"):
        cfg = T.llama_config(dtype=torch.bfloat16, flash="on",
                             remat_policy=policy, **PHI3_MINI)
        losses, launches, step_s, peak, _ = train_steps(
            T, kernels, cfg, 1, n, batch, WIDE_LR)
        L = cfg.n_layer
        fwd = L if policy in ("flash", "names", "flash_dots") else 2 * L
        want = want_launches(kernels, flash_fwd=fwd * n, flash_bwd_dq=L * n,
                             flash_bwd_dkv=L * n)
        check(all(np.isfinite(losses)), f"phase 19 Phi-3 {policy}: loss "
                                        f"{losses}")
        check(launches == want, f"phase 19 Phi-3 {policy}: launches "
                                f"{launches}, want {want}")
        ref = ref or losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        check(rel <= REMAT_LOSS_REL, f"phase 19 Phi-3 {policy}: losses "
              f"{losses} differ from full's {ref} by {rel}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        per[policy] = (step_s * 1e3, peak, launches["flash_fwd"] // n, rel)
    print(f"phase 19 train: Phi-3-mini-4k widths (d3072 H32 hd96 d_ff 8192 "
          f"V32064, rope, RMSNorm, SwiGLU, window 2047) at L4, S4096 B2 "
          f"bf16, f32 Adam at {WIDE_LR}, 1 warm-up and {n} timed steps a "
          f"remat policy: "
          + "; ".join(f"{p} step {ms:.1f} ms, peak {pk:.2f} GiB, K5 {k5} a "
                      f"step, losses within {rel:.2g} of full's"
                      for p, (ms, pk, k5, rel) in per.items())
          + f" (bound {REMAT_LOSS_REL:.3g}); full's losses "
          f"{[round(l, 4) for l in ref]}")
    return total, per


def phase_wide_serving(T, PA, PagedBatcher):
    """Phase 19 (c): PagedBatcher (kernel "on") serving 4 greedy requests
    (prompts 64-200 tokens, 24 new each) on StarCoderBase-1B (full depth,
    K11 at G 16 hd 128) and Phi-3-mini (L4, K11 at G 1 hd 96) in bf16, K11
    launched n_layer times a decode step; then in f32 at 4 layers each the
    greedy tokens the same as the gather path's (kernel "off"). Returns
    K11's launches."""
    rng = np.random.default_rng(3)
    launches, parts = 0, []
    for name, make, widths in (
            ("StarCoderBase-1B", T.GPTConfig, STARCODER_1B),
            ("Phi-3-mini", T.llama_config, PHI3_MINI)):
        cfg = make(dtype=torch.bfloat16, **widths)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(4),
                               cfg, "cuda")
        prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in (64, 200, 97, 150)]
        pool = dict(n_slots=4, n_blocks=4 * 16 + 1, block_size=16)
        PA.paged_attention.launches = 0
        _, outs, steps, finite, wall = serve(PagedBatcher, params, cfg,
                                             prompts, [24] * 4, kernel="on",
                                             **pool)
        k11 = PA.paged_attention.launches
        check(finite, f"phase 19 serving {name}: non-finite logits")
        check(all(o.shape == (24,) for o in outs),
              f"phase 19 serving {name}: a request came back short")
        check(k11 == cfg.n_layer * steps, f"phase 19 serving {name}: K11 "
              f"{k11} != n_layer {cfg.n_layer} x steps {steps}")
        launches += k11
        del params
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layer=4)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(5),
                               cfg32, "cuda")
        toks = {}
        for kernel in ("on", "off"):
            PA.paged_attention.launches = 0
            _, toks[kernel], _, ok, _ = serve(
                PagedBatcher, params, cfg32, prompts, [16] * 4,
                kernel=kernel, **pool)
            check(ok, f"phase 19 serving {name} f32 {kernel}: non-finite")
            launches += PA.paged_attention.launches
        check(all(np.array_equal(a, b) for a, b in zip(toks["on"],
                                                       toks["off"])),
              f"phase 19 serving {name}: f32 greedy tokens differ between "
              f"K11 and the gather path")
        del params
        torch.cuda.empty_cache()
        n_tok = 24 * len(prompts)
        parts.append(f"{name} bf16 {n_tok} tokens in {wall:.3f} s "
                     f"({n_tok / wall:.1f} tok/s), {steps} decode steps, K11 "
                     f"{k11}; f32 L4 greedy tokens identical to the gather "
                     f"path's")
    print("phase 19 serving: PagedBatcher kernel='on', 4 requests: "
          + "; ".join(parts))
    return launches


def wide_row(shape, err, times):
    """The JSON line's "phase19" entry of a kernel: its worst error over
    phase 19's widened shapes, and its error against the plain version
    and its times at the models' shapes."""
    return {"shape": shape, "max_abs_err": err, "times": {
        k: {"max_abs_err": e, "ms": ms, "plain_ms": p_ms, "library_ms": lib,
            "bound_ms": b[0], "bound_by": b[1]}
        for k, (ms, p_ms, lib, b, e) in times.items()}}


def phase_wide_kernels(FA, PA):
    """Phase 19 (d): every widened kernel against its plain version
    (wide_flash_checks, wide_split_checks, wide_paged_checks), then held
    against it again and timed at the shapes phase 19's models give them: K1/K2 at StarCoderBase-1B's
    (B8 S2048 H16 KV1 hd128), K5-K7 at Phi-3-mini's (B1 H32 S4096 hd96,
    window 2047), K11 at StarCoderBase-1B's decode (G16 hd128) and
    Phi-3-mini's (KV32 G1 hd96). Returns ({kernel: worst max abs err},
    {row: {kernel: (ms, plain_ms, library_ms, bound, max abs err)}})."""
    rng = np.random.default_rng(19)
    t0 = time.perf_counter()
    errs = wide_flash_checks(rng, FA)
    for k, e in wide_sm90_checks(rng, FA).items():
        errs[k] = max(errs[k], e)
    errs.update(wide_split_checks(FA))
    errs["paged_attention"] = wide_paged_checks(rng, PA)
    check_s = time.perf_counter() - t0
    times = {"starcoder": wide_packed_times(rng, FA, 8, 16, 1, 128, 2048)}
    star_routes = flash_routes(FA)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {"flash_fwd_qkv": "sm90", "flash_bwd_dq_qkv": "sm90",
            "flash_bwd_dkv_qkv":
                f"sm90 cluster {FA.dkv_cluster(8, 1, 2048, 16, sms)}",
            "flash_bwd_fused_qkv":
                f"sm90 cluster {FA.fused_cluster(8, 1, 2048, 16, sms)}"}
    check(star_routes == want, f"phase 19: StarCoderBase-1B's K1/K2 routes "
          f"{star_routes}, want {want}")
    times["phi3"] = wide_split_times(FA, 1, 32, 4096, 96, 2047)
    pos = [2047, 1500, 700, 64, 1900, 33, 1024, 2000]
    times["paged"] = {
        "g16-hd128": wide_paged_times(rng, PA, 1, 16, 128, 128, pos),
        "g1-hd96": wide_paged_times(rng, PA, 32, 1, 96, 128, pos)}
    torch.cuda.synchronize()

    def fmt(name, t):
        ms, p_ms, lib, (b_ms, b_by), e = t
        return (f"{name} {ms:.4f} ms (plain {p_ms:.3f} ms, library "
                + (f"{lib:.4f} ms" if lib is not None else "none")
                + f", bound {b_ms:.4f} ms by {b_by}; max abs err {e:.3g} "
                f"against plain)")

    print(f"phase 19 kernels: K1/K2 at {len(WIDE_FLASH_CASES)} shapes and "
          f"{len(WIDE_SM90_CASES)} bf16 shapes past G 8 on the Hopper "
          f"route, K5-K7 at {len(WIDE_SPLIT_CASES)}, K11 at "
          f"{len(WIDE_PAGED_CASES)}, f32 and bf16, dropout 0 and "
          f"{WIDE_RATE} (K1-K7), within phase 3's bounds in {check_s:.1f} "
          f"s; worst max abs err {json.dumps(errs)}; G16 fused K2 and K2b "
          f"and K11 bit-identical over two launches; at StarCoderBase-1B's "
          f"shape (B8 S2048 KV1 G16) routes {json.dumps(star_routes)}, K2b "
          f"cluster size {FA.dkv_cluster(8, 1, 2048, 16, sms)}, fused K2 "
          f"cluster size {FA.fused_cluster(8, 1, 2048, 16, sms)} on {sms} "
          f"SMs (two launches of each the same bits)")
    for row, ts in times.items():
        print(f"phase 19 times ({row}, bf16): "
              + "; ".join(fmt(n, t) for n, t in ts.items()))
    return errs, times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="TABLE_PATH",
                        help="profile one more headline train step, "
                             "dropout headline step, defaults (split "
                             "backward) step, fused-CE headline step, Var "
                             "flagship step, Var 2-d step, Mistral 7B step, "
                             "ResNet-18 step, phase 17's BERT, T5, ViT, "
                             "MoE, LoRA and QLoRA steps and phase 19's "
                             "StarCoderBase-1B step and write their "
                             "kernel tables here (and *_dropout, *_split, "
                             "*_fused_ce, *_var, *_var2d, *_mistral, "
                             "*_resnet, *_bert, *_t5, *_vit, *_moe, "
                             "*_lora, *_qlora, *_starcoder)")
    profile = parser.parse_args().profile
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    import neuronika_tpu_torch as nk
    from neuronika_tpu_torch import _build, optim
    from neuronika_tpu_torch.models import resnet as R
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import conv as C
    from neuronika_tpu_torch.ops import cross_entropy as CE
    from neuronika_tpu_torch.ops import flash_attention as FA
    from neuronika_tpu_torch.ops import matmul as MM
    from neuronika_tpu_torch.ops import softmax as SM
    from neuronika_tpu_torch.ops import paged_attention as PA
    from neuronika_tpu_torch import serving as S
    from neuronika_tpu_torch.models import lora as LR
    from neuronika_tpu_torch.serving import PagedBatcher

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi[0])
    print(f"phase 1 env: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f", CUDA {torch.version.cuda}; TF32 matmul and cuDNN off")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build(force=True)
    build_s = time.perf_counter() - t0
    _build.load_library()
    print(f"phase 2 build: {lib.name} from {len(_build.SOURCES)} source(s) "
          f"with nvcc in {build_s:.1f} s")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    err, paged = phase_kernels(rng, PA)
    flash = phase_flash_kernels(rng, FA)
    mm_sm = phase_mm_softmax(MM, SM)
    sflash = phase_split_flash(FA)
    dflash = phase_dropout_kernels(FA)
    convk = phase_conv_kernels(C)
    phase_conv_route_times(C)
    cek = phase_ce_kernels(CE, T)

    # 4. serving end to end at full width
    cfg = T.GPTConfig(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                      d_ff=6144, max_seq=1024, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    pool = dict(n_slots=8, n_blocks=513, block_size=16)
    rng = np.random.default_rng(0)
    lens = rng.choice([32, 64, 128], size=16)
    max_news = [int(m) for m in rng.choice([32, 64], size=16)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in lens]
    serve(PagedBatcher, params, cfg, prompts[:1], [4], **pool)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    PA.paged_attention.launches = 0
    pb, outs, steps, finite, wall = serve(PagedBatcher, params, cfg,
                                          prompts, max_news, **pool)
    launches = PA.paged_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(all(o.shape == (m,) for o, m in zip(outs, max_news)),
          "a request did not return max_new tokens")
    check(finite, "non-finite logits in the bf16 serving run")
    check(pb.block_stats == (0, 512), f"block_stats {pb.block_stats}")
    check(launches == cfg.n_layer * steps,
          f"paged_attention launches {launches} != n_layer {cfg.n_layer} "
          f"x decode steps {steps}")
    met = pb.metrics
    n_tok = sum(len(o) for o in outs)
    print(f"phase 4 serving: d1536 L8 H12 V16384 bf16, 16 requests, "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
          f"ttft_mean {met['ttft_mean_s'] * 1e3:.2f} ms, itl_mean "
          f"{met['itl_mean_s'] * 1e3:.3f} ms; {steps} decode steps, "
          f"{launches} kernel launches; peak {peak_gb:.2f} GiB")

    # 5. kernel against the gather path, end to end, in f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks = {}
    for kernel in ("auto", "off"):
        _, toks[kernel], _, finite, _ = serve(
            PagedBatcher, params, cfg32, prompts[:4], [16] * 4,
            n_slots=4, n_blocks=257, block_size=16, kernel=kernel)
        check(finite, f"non-finite logits (f32, kernel={kernel})")
    same = all(np.array_equal(a, b) for a, b in zip(toks["auto"],
                                                    toks["off"]))
    check(same, f"greedy tokens differ: kernel {toks['auto']} vs gather "
                f"{toks['off']}")
    print("phase 5 kernel vs gather path: f32 d1536 L8, 4 requests x 16 "
          "greedy tokens identical")

    # 6. the train step at full width; 7. kernel vs plain route in f32
    del params
    torch.cuda.empty_cache()
    head, split, fused_ce, head_ms = phase_train(T, FA, CE, profile)
    phase_routes(T, FA, CE)

    # 8-10. the define-by-run tier
    flag = phase_var_flagship(nk, T, optim, FA, MM, SM, profile)
    legacy = phase_var_legacy(nk, T, optim, FA, MM, SM, profile)
    phase_var_routes(nk, T, FA, MM, SM)

    # 11. the Mistral 7B train step; 12. split kernel vs plain route in f32
    gc.collect()
    torch.cuda.empty_cache()
    mistral = phase_mistral(T, FA, CE, profile)
    phase_split_routes(T, FA)

    # 13. ResNet-18 training on K12/K13; 14. conv kernel vs plain routes
    gc.collect()
    torch.cuda.empty_cache()
    resnet, resnet_errs = phase_resnet(R, C, profile)
    var_convs = phase_conv_routes(nk, R, C)

    # 15. the define-by-run layer kit: the examples' twins and the sweep
    gc.collect()
    torch.cuda.empty_cache()
    kit = phase_layer_kit(nk, C, MM, SM, smi[0])

    # 16. the language-model loop: Trainer, eval, checkpoints, dense
    # generation, the text-pipeline and GPT example twins
    gc.collect()
    torch.cuda.empty_cache()
    loop, loop_k11 = phase_lm_loop(T, FA, CE, PA, PagedBatcher, prompts[:4],
                                   head_ms)

    # 17. the model families: BERT, T5, ViT, the MoE GPT, LoRA and QLoRA,
    # the resnet_cifar twin
    gc.collect()
    torch.cuda.empty_cache()
    models = phase_models(T, FA, CE, PA, C, R, PagedBatcher, profile)

    # 18. the rest of serving: quantized weights, the dense-slot batcher,
    # chunked, bucketed and grouped prefill, the prefix cache, multi-step
    # windows, S-LoRA adapters, speculative decoding
    gc.collect()
    torch.cuda.empty_cache()
    serving18 = phase_serving_rest(T, PA, S, LR, smi[0])

    # 19. the attention kernels at every head dim and group size JAX's
    # take: each against its plain version, then StarCoderBase-1B (G 16)
    # and Phi-3-mini (hd 96) training under the remat policies, and both
    # served through K11
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    wide_errs, wide_times = phase_wide_kernels(FA, PA)
    star = phase_starcoder(T, FA, CE, profile)
    phi3, _ = phase_phi3(T, FA, CE)
    wide_k11 = phase_wide_serving(T, PA, PagedBatcher)
    print(f"phase 19 took {time.perf_counter() - t19:.1f} s")

    csrc = "neuronika_tpu_torch/csrc/"
    src = f"{csrc}flash_attention_qkv.cu"
    at = "neuronika_tpu/ops/pallas/attention.py:"
    # K11's times at the table shape; its long and serving shapes beside
    kern_ms, plain_ms, bound, _ = paged["table"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "neuronika_tpu_torch/csrc/paged_attention.cu",
        "replaces": "neuronika_tpu/ops/pallas/paged_attention.py:44",
        "launches": (launches + loop_k11 + models["paged_attention"]
                     + serving18 + wide_k11),
        "launches_by_phase": {"4": launches, "16": loop_k11,
                              "17": models["paged_attention"],
                              "18": serving18, "19": wide_k11},
        "max_abs_err": err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None,
        "back_to_back_ms": paged["table"][3],
        "long_ms": paged["long"][0], "long_bound_ms": paged["long"][2][0],
        "serving_ms": paged["serving"][0],
        "serving_bound_ms": paged["serving"][2][0],
        "phase19": wide_row("G16 hd128 and G1 hd96 (B8 MB128 BS16)",
                            wide_errs["paged_attention"],
                            wide_times["paged"])}]
    # K2c (:1109) and K2d (:1194) are one CUDA kernel; it names the first.
    # Phase 6's launches (the headline, or for K2a/K2b the defaults run),
    # phase 16's (the Trainer: K1, K2c; gpt_train's twin: K1, K2a, K2b) and
    # phase 17's (BERT, the T5 encoder, the MoE GPT: K1, K2a, K2b; LoRA and
    # QLoRA: K1, K2c) and phase 19's (StarCoderBase-1B: K1, K2a, K2b and,
    # with flash_bwd "fused", K2c at G 16); "phase19" holds the widened shapes' worst error, and the error
    # against the plain versions and the times at StarCoderBase-1B's shape
    for name, line, counts in (("flash_fwd_qkv", 639, head),
                               ("flash_bwd_dq_qkv", 708, split),
                               ("flash_bwd_dkv_qkv", 755, split),
                               ("flash_bwd_fused_qkv", 1109, head)):
        e, ms, p_ms, lib, bound = flash[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{at}{line}",
                        "launches": (counts[name] + loop[name] + models[name]
                                     + star[name]),
                        "launches_by_phase": {"6": counts[name],
                                              "16": loop[name],
                                              "17": models[name],
                                              "19": star[name]},
                        "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib,
                        "dropout_ms": dflash[name][1],
                        "dropout_max_abs_err": dflash[name][0],
                        "phase19": wide_row(
                            "G16 hd128 B8 S2048 (StarCoderBase-1B)",
                            wide_errs[name],
                            {name: wide_times["starcoder"][name]})})
    # K3 runs on the 2-d model's path, K4 on both Var paths (phases 8, 9);
    # both on the layer kit's (phase 15)
    for name, source, replaces in (
            ("matmul", "neuronika_tpu_torch/csrc/matmul.cu",
             "neuronika_tpu/ops/pallas/matmul.py:30"),
            ("softmax", "neuronika_tpu_torch/csrc/softmax.cu",
             "neuronika_tpu/ops/pallas/softmax.py:19")):
        e, ms, p_ms, lib, bound = mm_sm[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": flag[name] + legacy[name] + kit[name],
                        "max_abs_err": e, "ms": ms, "plain_ms": p_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib})
    # K5-K7 run on phase 11's path, phase 17's (the T5 decoder) and phase
    # 19's (Phi-3-mini under the five remat policies); their errors are at
    # phase 11's B2 H32 S8192, their times at B1 H8 S8192 (where the plain
    # versions fit); "phase19" holds the widened shapes' worst error, and
    # the error against the plain versions and the times at Phi-3-mini's
    # shape
    for name, line in (("flash_fwd", 91), ("flash_bwd_dq", 177),
                       ("flash_bwd_dkv", 243)):
        e, ms, p_ms, lib, bound = sflash[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}flash_attention.cu",
                        "replaces": f"{at}{line}",
                        "launches": mistral[name] + models[name] + phi3[name],
                        "launches_by_phase": {"11": mistral[name],
                                              "17": models[name],
                                              "19": phi3[name]},
                        "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib,
                        "dropout_ms": dflash[name][1],
                        "dropout_max_abs_err": dflash[name][0],
                        "phase19": wide_row(
                            "hd96 B1 H32 S4096 window 2047 (Phi-3-mini)",
                            wide_errs[name],
                            {name: wide_times["phi3"][name]})})
    # K12 and K13 run on phase 13's path (launches, and errors on its
    # operands brought to unit scale), K14 and K15 on phase 14's Var graphs
    # (launches; errors at bench.py's shapes); K12, K14 and K15 on the layer
    # kit's too (phase 15's launches added), K12 and K13 on phase 17's
    # resnet_cifar twin (added; its stem on csrc/conv.cu); times at
    # bench.py's shapes
    # (phase 3); all four there, K12 and K13 on phase 13's path in bf16 but
    # for the stem, and K14 and K15 in phase 14's bf16 Var convs, run
    # csrc/conv_sm90.cu; the f32 launches (the stem, phase 14's f32 Var
    # graph, all of phase 15's) run csrc/conv.cu: launches_by_source splits
    # `launches` by the wrappers' sm90_launches
    for name, line, path, source in (
            ("conv2d_direct_nhwc", 46, resnet, "conv_sm90.cu"),
            ("conv2d_dw_nhwc", 334, resnet, "conv_sm90.cu"),
            ("conv1d_direct_nwc", 574, var_convs, "conv_sm90.cu"),
            ("conv3d_direct_ndhwc", 733, var_convs, "conv_sm90.cu")):
        e, ms, p_ms, lib, bound = convk[name]
        e = resnet_errs.get(name, e)
        n = path[name] + kit.get(name, 0) + models.get(name, 0)
        hop = (path[f"{name}.sm90"] + kit.get(f"{name}.sm90", 0)
               + models.get(f"{name}.sm90", 0))
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}{source}",
                        "replaces": f"neuronika_tpu/ops/pallas/conv.py:{line}",
                        "launches": n,
                        "launches_by_source": {f"{csrc}{source}": hop,
                                               f"{csrc}conv.cu": n - hop},
                        "max_abs_err": e, "ms": ms, "plain_ms": p_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib})
    # K8-K10 run on phase 6's fused-CE path (launches), checked and timed
    # at its LM head (phase 3); library_ms is the composite head's time
    # (forward for K8, its backward for K9 and K10), several calls. In
    # bf16 all three run csrc/cross_entropy_sm90.cu (phase 6's launches
    # counted there: fused_ce["ce_fwd.sm90"], ["ce_dx.sm90"], ...)
    for name, line in CE_LINES.items():
        e, ms, p_ms, lib, bound = cek[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}cross_entropy_sm90.cu",
                        "replaces": "neuronika_tpu/ops/pallas/"
                                    f"cross_entropy.py:{line}",
                        "launches": fused_ce[name], "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib})
    print(smi[0])           # again, so that the end of the output holds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
