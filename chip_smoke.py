"""Smoke test of the PyTorch/CUDA port (neuronika_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile TABLE_PATH]

Runs from the root of a checkout, on a machine with one CUDA card, nvcc and
nvidia-smi. Phases, each printing one line or a few:
  1. environment: card, power limit, torch and CUDA versions; TF32 off;
  2. build: nvcc compiles the kernels from neuronika_tpu_torch/csrc/, one
     process per source;
  3. every kernel against its plain PyTorch version on the card, with
     error bounds and CUDA-event times: paged attention (K11) at the
     serving path's shapes; flash attention forward (K1), the split
     backward pair (K2a, K2b) and the fused backward (K2c/K2d) over f32
     and bf16, causal and full, MHA and GQA, hd 128 and 64, fast and safe
     softmax and a ragged S, then checked and timed at the headline train
     step's shape (bf16 B16 S2048 H12 KV12 hd128, causal, fast softmax),
     where the kernels' errors are the ones the JSON line reports, two
     launches of the fused backward (and of K2a) must give the same bits
     (the fused backward in f32 too, at B2 S1000 H8 KV2), and each
     kernel's TFLOP/s is printed beside SDPA's, with the split pair as the
     backward runs it (one pre-pass for K2a and K2b);
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
     backward, held exact), its step time, tokens/s, MFU and peak memory
     printed beside the composite headline's;
  7. the kernel route against the plain route (flash="off") in f32 on a
     small hd-128 model: loss and every gradient leaf, split and fused;
     and the fused CE route (fused_ce "on" against "off", vocab 1024) for
     a tied GPT and an untied llama-style head;
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
     step;
 12. the split kernel route against the plain route (flash="off") in f32
     on small llama and Mistral models (hd 128, GQA, window < S): loss and
     every gradient leaf;
 13. ResNet-18 training at its published widths (He et al. 2016, Table 1;
     GroupNorm for BatchNorm, imagenet stem, 1000 classes), bf16,
     conv_impl "pallas", 224x224 images at batch 64 from a seed, SGD with
     momentum 0.9 and lr 0.1: 2 warm-up and 5 timed steps with a finite,
     falling loss and K12 launched once a conv forward and once a stride-1
     conv's dx, K13 once a stride-1 conv's dw (counts derived from the
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
     counts exact; and the tier "auto" picks for bench.py's conv shapes.
Phase 3 also holds the matmul (K3) and row-softmax (K4) kernels against
their plain versions (ragged, transposed views, the 2-d model's forward
products and the VJP products of its LM head and MLP as the VJPs lay them
out, the flagship's (32768, 16384) log-softmax) and times them there; K3's
results must be the same bits over two launches, and its split-K products
(the projections, the LM head's dx, the MLP's dx, one head's P V) must
fail the bound with their last K slice dropped (a planted fault); and
the split-layout flash kernels (K5 forward, K6 dq, K7 dk/dv) against
their plain versions over f32 and bf16, causal, windows 1, 6, 100 and
>= S, full attention with Sq != Skv, hd 64 and 128 and a ragged S, then
at B1 H8 S8192 hd128 window 4096 bf16, where each is timed beside its
plain version and SDPA (with the band as a boolean mask), and at phase
11's shape (B2 H32 S8192), where they are checked (the plain versions
over 8 heads at a time), three planted faults are read against the same
bound and must fail it, and each is timed alone. Their bf16 results are
also held in norm: ||kernel - plain|| <= 1e-2 ||plain|| + 2^-15
sqrt(numel), and so are K1's and K2's, with three planted faults (K1, K2a,
the fused K2) read at the headline shape. Phase 3 then holds the direct convolutions (K12 at strides
1-3, dilation, groups, a 7x7/2 conv on 3 channels and a 1x1/2 one; K13
with a split reduction; K14; a strided 1-d conv on K12; K15 with
dilation) against their plain versions in f32 and bf16, and at bench.py's
conv shapes checks them, reads a planted fault per kernel against the same
norm bound and times each beside its plain version and one library call
(F.conv2d, torch.nn.grad.conv2d_weight, F.conv1d, F.conv3d); and times
the conv route at batch 1, 2 and 4 (K12 against F.conv2d at ResNet-18's
four stride-1 k3 stage shapes, K14 against F.conv1d at 3136x256, bf16,
forwards), which `route_conv2d` follows on the card. Last in phase 3, the
fused linear cross-entropy (K8 forward, K9 dx, K10 dW) against its plain
versions in f32 and bf16 (N512 D64 V1024, a ragged N300 D72 V1000, a
tied-head-wide D256, and D4160, whose 9 slices run K9 and K10 without a
cluster), then at phase 6's LM head (bf16 N32768 D1536
V16384), held per entry and in norm, with a planted fault per kernel (K8
without one vocabulary tile, K9 without that tile's term, K10 without one
row block's partial), and timed beside its plain version, the composite
head (`_lm_head` + logsumexp + gather: forward, backward, both) and its
bound.
Every kernel's time is printed beside its plain version's, the one
PyTorch call that computes the same function (where there is one; for
K8-K10 the composite head, several calls) and the bound: the larger of
its bytes over 3.35 TB/s and its FLOPs over the peak of its type (989
TFLOP/s bf16, 67 TFLOP/s f32), H100 SXM; for K3 in f32, the least time of
f32-accurate products on the card, 3 TF32 products at 495 TFLOP/s (165).
With --profile, one more step of phases 6 (the headline, the defaults and
the fused-CE run), 8, 9, 11 and 13 runs under torch.profiler: each one's
device time by kernel kind is printed and its kernel table written to
TABLE_PATH (the others beside it, "_split", "_fused_ce", "_var", "_var2d",
"_mistral" and "_resnet" added to the name).
Then a JSON line of per-kernel results and, last, one JSON line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
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


def phase_kernels(rng, paged_attention, reference):
    """Phase 3: the paged-attention kernel against its plain version."""
    shape = dict(B=8, hd=128, BS=16, MB=64,
                 pos=[0, 15, 16, 500, 1023, 700, 129, 0], inactive=[7])
    errs = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, KV, G in (("mha", 12, 1), ("gqa", 2, 6)):
            args = paged_case(rng, KV=KV, G=G, dtype=dtype, **shape)
            for window in (0, 9):
                out = paged_attention(*args, window=window)
                ref = reference(*args, window=window)
                torch.cuda.synchronize()
                check(out.dtype == dtype and out.shape == ref.shape,
                      f"kernel output {out.dtype} {tuple(out.shape)}")
                err = float((out.float() - ref.float()).abs().max())
                key = f"{str(dtype)[6:]}/{name}/w{window}"
                errs[key] = err
                check(err <= tol, f"paged_attention {key}: max abs err "
                                  f"{err} > {tol}")
    # time at the serving path's shape and dtype: plain, kernel, kernel,
    # plain in one call
    args = paged_case(rng, KV=12, G=1, dtype=torch.bfloat16, **shape)
    plain_a = cuda_ms(lambda: reference(*args), 20)
    kern_a = cuda_ms(lambda: paged_attention(*args), 200)
    kern_b = cuda_ms(lambda: paged_attention(*args), 200)
    plain_b = cuda_ms(lambda: reference(*args), 20)
    kern_ms, plain_ms = min(kern_a, kern_b), min(plain_a, plain_b)
    # bytes the kernel must read: the K and V rows of every block it walks
    BS, KV, hd = 16, 12, 128
    live = sum((p // BS + 1) * BS for p in shape["pos"][:7]) + 64 * BS
    gbytes = live * KV * hd * 2 * 2 / 1e9
    # bound: those K/V bytes (the q and out rows are 0.05% of them)
    bound = bound_ms(gbytes * 1e9, 4 * live * KV * hd, torch.bfloat16)
    print(f"phase 3 kernels: paged_attention max_abs_err "
          f"{json.dumps(errs)} (tol f32 {F32_TOL}, bf16 {BF16_TOL}); "
          f"bf16 B8 KV12 G1 hd128 BS16 MB64: kernel {kern_ms:.4f} ms "
          f"({gbytes / kern_ms * 1e3:.0f} GB/s of K/V, warm L2), plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); no "
          f"single PyTorch call computes a paged decode step")
    return errs["bfloat16/mha/w0"], kern_ms, plain_ms, bound


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


def check_flash(FA, key, qkv, do, H, KV, causal, fast, faults=False):
    """K1, the split pair K2a+K2b and the fused K2 against the plain
    versions on one input; raises on a mismatch. bf16 results are held per
    entry and in norm (SPLIT_BF16_REL, as K5-K7); with `faults` (causal
    MHA), flash_faults' three planted faults are read against the same
    plain versions and must fail the norm bound. Returns {kernel name: max abs
    err}, K1's (out, lse) and {tensor: (||err||/||ref||, bound)} of the
    norm readings and the faults (empty in f32)."""
    B, S, _ = qkv.shape
    G = H // KV
    out, lse = FA.flash_fwd_qkv(qkv, H, KV, causal, fast_softmax=fast)
    rout, rlse = FA.flash_attention_qkv_fwd_reference(qkv, H, KV, causal,
                                                      fast_softmax=fast)
    split = torch.empty_like(qkv)
    FA.flash_bwd_dq_qkv(qkv, out, lse, do, split, H, KV, causal)
    FA.flash_bwd_dkv_qkv(qkv, out, lse, do, split, H, KV, causal)
    fused = FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV, causal)
    ref = FA.flash_attention_qkv_bwd_reference(qkv, out, lse, do, H, KV,
                                               causal)
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
    # matmul passes per (q, k) tile: fwd s, pv; dq s, dp, dq; dkv s, dp,
    # dv, dk; fused all five. Causal: half of the S x S pairs.
    passes = {"flash_fwd_qkv": 2, "flash_bwd_dq_qkv": 3,
              "flash_bwd_dkv_qkv": 4, "flash_bwd_fused_qkv": 5}
    lib_fwd, lib_bwd = sdpa_ms(qkv, do, H, hd)
    # bytes each kernel must move: qkv (and out, lse, do in the backward)
    # read once, its outputs written once
    W, D = 3 * H * hd, H * hd
    el = B * S * 2
    nbytes = {"flash_fwd_qkv": el * (W + D) + B * H * S * 4,
              "flash_bwd_dq_qkv": el * (W + 2 * D + D) + B * H * S * 4,
              "flash_bwd_dkv_qkv": el * (W + 2 * D + 2 * D) + B * H * S * 4,
              "flash_bwd_fused_qkv": el * (W + 2 * D + W) + B * H * S * 4}
    result, line = {}, []
    for kname, (k_ms, p_ms) in times.items():
        flops = 2 * passes[kname] * B * H * S * S * hd / 2
        bound = bound_ms(nbytes[kname], flops, torch.bfloat16)
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
    timed steps, the step time in s, the peak memory in GiB and the eval
    loss of the trained params on the `heldout` batch (None without
    one)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    opt = T.opt_init(params, cfg)
    step = T.make_train_step(cfg)
    toks, tgts = batch
    losses = []
    for _ in range(n_warm):
        params, opt, loss = step(params, opt, toks, tgts, lr, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        params, opt, loss = step(params, opt, toks, tgts, lr, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        profile_step(lambda: step(params, opt, toks, tgts, lr, gen), label,
                     profile)
    held = None
    if heldout is not None:
        with torch.no_grad():
            held = float(T.loss_fn(params, *heldout, cfg))
    losses = [float(l) for l in losses]
    del params, opt
    torch.cuda.empty_cache()
    return losses, launches, step_s, peak, held


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
        kind = ("K8 ce fwd" if "ce_fwd_kernel" in n
                else "K9 ce dx" if "ce_grad_kernel" in n and "true>" in n
                else "K10 ce dw" if "ce_grad_kernel" in n
                else "K12-K15 conv" if "conv_mma<false>" in n
                or "conv_ffma<false>" in n
                else "K13 conv dw" if "conv_mma<true>" in n
                or "conv_ffma<true>" in n or "conv_dw_reduce" in n
                else "K5 fwd" if "split_fwd" in n
                else "K6 dq" if "split_bwd_dq" in n
                else "K7 dk/dv" if "split_bwd_dkv" in n
                else "K2 pre-pass" if "bwd_stats" in n
                else "K2c fused" if "flash_bwd_kv_kernel" in n
                and "true>" in n or "dq_store" in n or "dq_cast" in n
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
    the headline run, of the defaults run and of the fused-CE run."""
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
    # each in its backward
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
    want.update(flash_fwd_qkv=L * n, flash_bwd_fused_qkv=L * n, ce_fwd=n,
                ce_dx=n, ce_dw=n)
    check(all(np.isfinite(losses)), f"non-finite loss (fused CE): {losses}")
    check(losses[-1] < losses[0], f"loss did not fall (fused CE): {losses}")
    check(launches == want, f"fused-CE launches {launches}, want {want}")
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    print(f"phase 6 train, the headline with fused_ce='on' (K8-K10): step "
          f"{step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f}, peak "
          f"{peak:.2f} GiB (the composite headline above: {head_line}); "
          f"losses {[round(l, 4) for l in losses]}; launches {launches}")
    return head, split, launches


# phase 7 bounds (f32): loss and gradients of two exact routes that differ
# in summation order only
ROUTE_LOSS_TOL = 1e-5
ROUTE_GRAD_TOL = 2e-5


def route_run(T, params, cfg0, kernels, **kw):
    """The loss and every gradient leaf of one f32 forward and backward on
    a fixed B2 S256 batch (numpy seed 1) with cfg0 updated by kw, and the
    launches of `kernels` it made."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg0.vocab_size,
                                         size=(2, 256))).to("cuda")
    cfg = dataclasses.replace(cfg0, **kw)
    before = [k.launches for k in kernels]
    leaves = [p.detach().clone().requires_grad_()
              for p in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten(params, leaves), toks, toks.roll(-1, 1),
                     cfg, train=True)
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
# hd); windows cut the 64-row tiles anywhere or cover all of S
SPLIT_CASES = (
    ("causal-hd128", 2, 4, 512, 512, True, 0, 128),
    ("window1-hd128", 2, 4, 512, 512, True, 1, 128),
    ("window6-hd64", 2, 4, 512, 512, True, 6, 64),
    ("window100-hd128-S1000", 2, 4, 1000, 1000, True, 100, 128),
    ("window-ge-S-hd64", 2, 4, 512, 512, True, 600, 64),
    ("full-Sq300-Skv777-hd128", 2, 4, 300, 777, False, 0, 128),
    ("full-Sq512-Skv256-hd64", 2, 4, 512, 256, False, 0, 64),
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
    writing 0 past q row 511; K7 missing q rows S/2 .. S/2 + 31 (one inner
    q tile) from every dk and dv row."""
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


def check_split(FA, key, q, k, v, do, causal, window, faults=False):
    """K5, K6 and K7 against their plain versions on one input, the plain
    versions run on SPLIT_HEADS (batch, head) pairs at a time; raises on a
    mismatch. With `faults`, also reads split_faults' planted faults
    against the same plain versions and raises unless each fails the bf16
    bound. Returns {kernel name: max abs err} and the plain (lse, delta)."""
    B, H = q.shape[:2]
    parts = [(slice(b, b + 1), slice(h, h + SPLIT_HEADS))
             for b in range(B) for h in range(0, H, SPLIT_HEADS)]
    names = ("out", "dq", "dk", "dv")
    stats = {n: [] for n in names}
    fault = {n: [] for n in names}
    out, lse = FA.flash_fwd(q, k, v, causal, window=window)
    rout, rlse = torch.empty_like(out), torch.empty_like(lse)
    for c in parts:
        rout[c], rlse[c] = FA.flash_attention_fwd_reference(
            q[c], k[c], v[c], causal, window=window)
        stats["out"].append(diff_stats(out[c], rout[c]))
    delta = (do.float() * rout.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, rlse, delta, causal, window=window)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, rlse, delta, causal,
                              window=window)
    for c in parts:
        args = (q[c], k[c], v[c], do[c])
        want = FA.flash_attention_bwd_reference(
            *args, rlse[c], delta[c], causal, window=window)
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
          f"pairs): " + "; ".join(line))
    del q, k, v, do, lse, delta, kern
    torch.cuda.empty_cache()
    return {n: (errs[n],) + t for n, t in timed.items()}


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
    ("conv3d-d2", "k15", (2, 9, 10, 11, 16), (3, 2, 3, 16, 24), (1, 1, 1),
     (2, 1, 2), 1),
)
# K13: (name, x shape, g shape, (kh, kw), dilation)
DW_CASES = (
    ("k3", (3, 10, 10, 24), (3, 8, 8, 20), (3, 3), (1, 1)),
    ("k3-dil2", (2, 12, 11, 8), (2, 8, 7, 16), (3, 3), (2, 2)),
    ("k1", (4, 28, 28, 64), (4, 28, 28, 128), (1, 1), (1, 1)),
    ("resnet-stage1-B16", (16, 58, 58, 64), (16, 56, 56, 64), (3, 3),
     (1, 1)),
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
        _, chunk = C._dw_splits(kh * kw * ci, co, w[..., 0].numel())
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
    (:817-888, SAME: the kernels on the padded input), where each is also
    held against a planted fault and timed beside its plain version, one
    library call and its bound. Returns {kernel: (max_abs_err, ms,
    plain_ms, library_ms, (bound_ms, bound_by))} at those shapes."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for name, kind, xs, ws, stride, dil, groups in CONV_CASES:
            x, w = rnd(*xs, dtype=dtype), rnd(*ws, dtype=dtype, scale=0.1)
            errs[f"{dt}/{name}"] = conv_within(
                conv_call(C, kind, x, w, stride, dil, groups),
                C.conv_nd_reference(x, w, stride, dil, groups),
                f"{kind} {dt}/{name}", dtype)[:2]
        for name, xs, gs, k, dil in DW_CASES:
            x, gg = rnd(*xs, dtype=dtype), rnd(*gs, dtype=dtype)
            errs[f"{dt}/dw-{name}"] = conv_within(
                C.conv2d_dw_nhwc(x, gg, *k, dil),
                C.conv_dw_reference(x, gg, k, dil), f"k13 {dt}/{name}",
                dtype)[:2]
    torch.cuda.synchronize()
    print("phase 3 kernels: conv K12-K15 within bounds (f32 1e-5 of max "
          "|entry|; bf16 one ulp of it and in norm "
          f"{SPLIT_BF16_REL} of ||ref|| + {SPLIT_BF16_FLOOR} an entry); max "
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
        out, ref = kern(), plain()
        err, rel, bound_n = conv_within(out, ref, f"{name} {shape}",
                                        torch.bfloat16)
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
    print("phase 3 kernels, conv at bench.py's shapes (bf16, SAME; faults: "
          "K12/K14/K15 without their first tap, K13 without its first "
          "split's partial): " + "; ".join(line))
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
    library on channels-last views of it), each checked against its plain
    version and timed in turns (kernel, library, library, kernel). Returns
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
        conv_within(kern(), plain(), f"route {key}", torch.bfloat16)
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
            ("9-slices-N256-D4160-V520", 256, 4160, 520))
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
    their bounds: K8 skipping the first vocabulary tile, K9 without that
    tile's term, K10 without the first row block's partial (one tile of
    CE_TILE each). Returns {kernel: max abs err} and the printed readings."""
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
        # K8: lse without the tile's exp-sum; the target logit without the
        # tile's targets
        pg, logits, onehot = ce_pg(x, w, t, rlse, g, every, tile)
        p_tile = torch.exp(logits - rlse[:, None]).sum(-1)
        lse_f = rlse + torch.log1p(-p_tile)
        loss_f = lse_f - ((rlse - rloss) - (logits * onehot).sum(-1))
        e8 = float((loss_f - rloss).abs().max())
        check(e8 > F32_TOL * top, f"ce_fwd {key}: a planted fault reads "
                                  f"{e8} <= {F32_TOL * top}")
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
        text += (f"; planted faults: ce_fwd without vocabulary tile 0 max "
                 f"abs err {e8:.3g}, ce_dx without its term "
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
    for dtype in (torch.float32, torch.bfloat16):
        for name, N, D, V in CE_CASES:
            check_ce(CE, f"{str(dtype)[6:]}/{name}",
                     *ce_case(g, N, D, V, dtype))
    N, D, V = CE_HEAD
    x, w, t, gr = ce_case(g, N, D, V, torch.bfloat16)
    errs = check_ce(CE, f"bfloat16/head-N{N}-D{D}-V{V}", x, w, t, gr,
                    faults=True)
    torch.cuda.empty_cache()
    _, lse = CE.ce_fwd(x, w, t)
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
          f"{c_bwd:.3f} ms, both {c_all:.3f} ms; fused K8 + K9 + K10 "
          f"{sum(t[0] for t in times.values()):.3f} ms")
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
            rank = C._dw_splits(st[0] * st[1] * xs[-1], ws[-1],
                                math.prod(ws[:-1]))[0]
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
    t0 = time.perf_counter()
    for _ in range(n):
        params, buf, loss = step(params, buf, x, y, 0.1)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    launches = {k.__name__: k.launches for k in C.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"phase 13: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"phase 13: loss did not fall: {losses}")
    want = conv_launch_want(R, cfg, n)
    check(launches == want, f"phase 13: launches {launches}, want {want}")
    flops = resnet_conv_flops(cfg, B, size)
    mfu = 3 * flops / step_s / 989e12
    print(f"phase 13 ResNet-18: imagenet stem, widths 64-512, 1000 classes, "
          f"GroupNorm, bf16, conv_impl pallas, 224x224 B64, SGD momentum 0.9 "
          f"lr 0.1: step {step_s * 1e3:.2f} ms, {B / step_s:.1f} images/s, "
          f"conv MFU {mfu:.4f} (3 x {flops:.4g} forward conv FLOPs a step, "
          f"of 989 TFLOP/s), peak {peak:.2f} GiB; losses "
          f"{[round(v, 4) for v in losses]}; launches in {n} steps: K12 "
          f"{launches['conv2d_direct_nhwc']}, K13 "
          f"{launches['conv2d_dw_nhwc']}")
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
    "auto" picks for the shapes bench.py names. Returns the Var graph's
    launches on the card."""
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
        loss.forward()
        loss.backward(1.0)
        torch.cuda.synchronize()
        res[dev] = (loss.item(), [v.grad().cpu() for v in leaves], counts())
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
          f"{res['cuda'][2]} (Var graph); conv_route auto on the card "
          f"picks {json.dumps(routes)} (the JAX package's table with its "
          f"rank-2 row on the library, as phase 3's batch 1-4 timings "
          f"decide)")
    return res["cuda"][2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="TABLE_PATH",
                        help="profile one more headline train step, "
                             "defaults (split backward) step, fused-CE "
                             "headline step, Var flagship step, Var 2-d "
                             "step, Mistral 7B step and ResNet-18 step and "
                             "write their kernel tables here (and *_split, "
                             "*_fused_ce, *_var, *_var2d, *_mistral, "
                             "*_resnet)")
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
    from neuronika_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)
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
    err, kern_ms, plain_ms, paged_bound = phase_kernels(
        rng, paged_attention, paged_attention_reference)
    flash = phase_flash_kernels(rng, FA)
    mm_sm = phase_mm_softmax(MM, SM)
    sflash = phase_split_flash(FA)
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
    paged_attention.launches = 0
    pb, outs, steps, finite, wall = serve(PagedBatcher, params, cfg,
                                          prompts, max_news, **pool)
    launches = paged_attention.launches
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
    head, split, fused_ce = phase_train(T, FA, CE, profile)
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

    csrc = "neuronika_tpu_torch/csrc/"
    src = f"{csrc}flash_attention_qkv.cu"
    at = "neuronika_tpu/ops/pallas/attention.py:"
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "neuronika_tpu_torch/csrc/paged_attention.cu",
        "replaces": "neuronika_tpu/ops/pallas/paged_attention.py:44",
        "launches": launches, "max_abs_err": err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": paged_bound[0],
        "bound_by": paged_bound[1], "library_ms": None}]
    # K2c (:1109) and K2d (:1194) are one CUDA kernel; it names the first
    for name, line, counts in (("flash_fwd_qkv", 639, head),
                               ("flash_bwd_dq_qkv", 708, split),
                               ("flash_bwd_dkv_qkv", 755, split),
                               ("flash_bwd_fused_qkv", 1109, head)):
        e, ms, p_ms, lib, bound = flash[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{at}{line}",
                        "launches": counts[name], "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib})
    # K3 runs on the 2-d model's path, K4 on both Var paths (phases 8, 9)
    for name, source, replaces in (
            ("matmul", "neuronika_tpu_torch/csrc/matmul.cu",
             "neuronika_tpu/ops/pallas/matmul.py:30"),
            ("softmax", "neuronika_tpu_torch/csrc/softmax.cu",
             "neuronika_tpu/ops/pallas/softmax.py:19")):
        e, ms, p_ms, lib, bound = mm_sm[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": flag[name] + legacy[name],
                        "max_abs_err": e, "ms": ms, "plain_ms": p_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib})
    # K5-K7 run on phase 11's path; their errors are at its B2 H32 S8192,
    # their times at B1 H8 S8192 (where the plain versions fit)
    for name, line in (("flash_fwd", 91), ("flash_bwd_dq", 177),
                       ("flash_bwd_dkv", 243)):
        e, ms, p_ms, lib, bound = sflash[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}flash_attention.cu",
                        "replaces": f"{at}{line}",
                        "launches": mistral[name], "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib})
    # K12 and K13 run on phase 13's path (launches, and errors on its
    # operands brought to unit scale), K14 and K15 on phase 14's Var graph
    # (launches; errors at bench.py's shapes); times at bench.py's shapes
    # (phase 3)
    for name, line, path in (
            ("conv2d_direct_nhwc", 46, resnet),
            ("conv2d_dw_nhwc", 334, resnet),
            ("conv1d_direct_nwc", 574, var_convs),
            ("conv3d_direct_ndhwc", 733, var_convs)):
        e, ms, p_ms, lib, bound = convk[name]
        e = resnet_errs.get(name, e)
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}conv.cu",
                        "replaces": f"neuronika_tpu/ops/pallas/conv.py:{line}",
                        "launches": path[name],
                        "max_abs_err": e, "ms": ms, "plain_ms": p_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib})
    # K8-K10 run on phase 6's fused-CE path (launches), checked and timed
    # at its LM head (phase 3); library_ms is the composite head's time
    # (forward for K8, its backward for K9 and K10), several calls
    for name, line in CE_LINES.items():
        e, ms, p_ms, lib, bound = cek[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}cross_entropy.cu",
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
