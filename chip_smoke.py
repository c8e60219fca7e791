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
     where the kernels' errors are the ones the JSON line reports;
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
     which launch K2a and K2b once per layer and step;
  7. the kernel route against the plain route (flash="off") in f32 on a
     small hd-128 model: loss and every gradient leaf, split and fused.
With --profile, one more step of phase 6 runs under torch.profiler: its
device time by kernel kind is printed and its kernel table written to
TABLE_PATH.
Then a JSON line of per-kernel results and, last, one JSON line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    print(f"phase 3 kernels: paged_attention max_abs_err "
          f"{json.dumps(errs)} (tol f32 {F32_TOL}, bf16 {BF16_TOL}); "
          f"bf16 B8 KV12 G1 hd128 BS16 MB64: kernel {kern_ms:.4f} ms "
          f"({gbytes / kern_ms * 1e3:.0f} GB/s of K/V, warm L2), plain "
          f"{plain_ms:.4f} ms")
    return errs["bfloat16/mha/w0"], kern_ms, plain_ms


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


def check_flash(FA, key, qkv, do, H, KV, causal, fast):
    """K1, the split pair K2a+K2b and the fused K2 against the plain
    versions on one input; raises on a mismatch. Returns {kernel name: max
    abs err} and K1's (out, lse)."""
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
    del rout, rlse
    parts = (split.float() - ref.float()).abs().reshape(B, S, KV, G + 2, -1)
    e_dq = float(parts[:, :, :, :G].max())
    e_dkv = float(parts[:, :, :, G:].max())
    del parts, split
    e_fused = float((fused.float() - ref.float()).abs().max())
    print(f"  {key}: out {e_out:.3g} (tol {o_tol:.3g}), lse {e_lse:.3g}, "
          f"dq {e_dq:.3g}, dkv {e_dkv:.3g}, fused {e_fused:.3g} "
          f"(tol {g_tol:.3g})")
    check(e_out <= o_tol, f"flash_fwd_qkv {key}: out err {e_out}")
    check(e_lse <= (FLASH_F32_TOL if f32 else 1e-3),
          f"flash_fwd_qkv {key}: lse err {e_lse}")
    errs = {"flash_fwd_qkv": e_out, "flash_bwd_dq_qkv": e_dq,
            "flash_bwd_dkv_qkv": e_dkv, "flash_bwd_fused_qkv": e_fused}
    for kname, e in list(errs.items())[1:]:
        check(e <= g_tol, f"{kname} {key}: err {e} > {g_tol}")
    return errs, (out, lse)


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

    B, H, S, hd = 16, 12, 2048, 128
    qkv, do = flash_case(rng, B, H, H, hd, S, torch.bfloat16)
    errs, (out, lse) = check_flash(FA, "bfloat16/headline-B16-S2048-mha-"
                                   "hd128-causal-fast", qkv, do, H, H, True,
                                   True)
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
    # matmul passes per (q, k) tile: fwd s, pv; dq s, dp, dq; dkv s, dp,
    # dv, dk; fused all five. Causal: half of the S x S pairs.
    passes = {"flash_fwd_qkv": 2, "flash_bwd_dq_qkv": 3,
              "flash_bwd_dkv_qkv": 4, "flash_bwd_fused_qkv": 5}
    result, line = {}, []
    for kname, (k_ms, p_ms) in times.items():
        tflops = 2 * passes[kname] * B * H * S * S * hd / 2 / k_ms / 1e9
        result[kname] = (errs[kname], k_ms, p_ms)
        line.append(f"{kname} {k_ms:.3f} ms ({tflops:.1f} TFLOP/s) vs "
                    f"plain {p_ms:.3f} ms")
    torch.cuda.synchronize()
    print("phase 3 kernels: flash attention within bounds (f32 "
          f"{FLASH_F32_TOL}, bf16 {FLASH_BF16_REL} of max); bf16 B16 S2048 "
          f"H12 hd128 causal fast: " + "; ".join(line) + " (the plain "
          "backward computes all of d_qkv)")
    return result


TRAIN_CFG = dict(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                 d_ff=6144, max_seq=2048)
# bench.py:1103-1107, the headline train step
HEADLINE = dict(remat=False, scan_layers=False, flash_softmax="fast",
                flash_bwd="fused", opt_state_dtype="bf16",
                matmul_out="compute")


def train_steps(T, FA, cfg, n_warm, n_timed, batch, lr, profile=None):
    """Run warm-up then timed train steps on fresh params (torch.Generator
    seed 0). Returns the losses, the launch counts of the timed steps, the
    step time in s and the peak memory in GiB."""
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
    for k in FA.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        params, opt, loss = step(params, opt, toks, tgts, lr, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = {k.__name__: k.launches for k in FA.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        profile_step(step, params, opt, toks, tgts, lr, gen, profile)
    losses = [float(l) for l in losses]
    del params, opt
    torch.cuda.empty_cache()
    return losses, launches, step_s, peak


def profile_step(step, params, opt, toks, tgts, lr, gen, path):
    """One more step under torch.profiler: prints its device time by
    kernel kind and the device's idle share of the step, and writes the
    kernel table to `path`."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, toks, tgts, lr, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.key
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        kind = ("K2 fused" if "flash_bwd_kv_kernel" in n or "dq_store" in n
                else "K2a dq" if "flash_bwd_dq" in n
                else "K1 fwd" if "flash_fwd" in n
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
    print(f"profile: one headline step, {wall_ms:.1f} ms host time under "
          f"the profiler, {busy:.1f} ms on the device (idle share "
          f"{1 - busy / wall_ms:.3f}): " + ", ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})"
              for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
          + f"; table in {path}")


def phase_train(T, FA, profile):
    """Phase 6: the train step at full width; returns the launch counts of
    the headline run and of the defaults run."""
    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, TRAIN_CFG["vocab_size"], size=(B, S))
    tgts = np.roll(toks, -1, axis=1)
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(tgts).to("cuda"))
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG, **HEADLINE)
    losses, launches, step_s, peak = train_steps(T, FA, cfg, 2, 5, batch,
                                                 5e-4, profile)
    L, n = cfg.n_layer, 5
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches["flash_fwd_qkv"] == L * n
          and launches["flash_bwd_fused_qkv"] == L * n
          and launches["flash_bwd_dq_qkv"] == 0,
          f"headline launches {launches}, want {L * n} fwd and fused")
    tok_s = B * S / step_s
    mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
    print(f"phase 6 train: d1536 L8 H12 V16384 S2048 B16 bf16, fused bwd, "
          f"no remat, bf16 Adam: step {step_s * 1e3:.1f} ms, "
          f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (of 989 TFLOP/s), peak "
          f"{peak:.2f} GiB; losses {[round(l, 4) for l in losses]}; "
          f"launches {launches}")
    head = launches
    cfg = T.GPTConfig(dtype=torch.bfloat16, **TRAIN_CFG)
    losses, launches, step_s, peak = train_steps(T, FA, cfg, 1, 2, batch,
                                                 5e-4)
    check(all(np.isfinite(losses)), f"non-finite loss (defaults): {losses}")
    check(launches["flash_bwd_dq_qkv"] == L * 2
          and launches["flash_bwd_dkv_qkv"] == L * 2
          and launches["flash_bwd_fused_qkv"] == 0,
          f"defaults launches {launches}, want {L * 2} dq and dkv")
    print(f"phase 6 train, GPTConfig defaults (split bwd, remat, f32 Adam, "
          f"f32 matmul outputs), 1 warm-up and 2 counted steps: step "
          f"{step_s * 1e3:.1f} ms, "
          f"{B * S / step_s:.0f} tokens/s, peak {peak:.2f} GiB; losses "
          f"{[round(l, 4) for l in losses]}; launches {launches}")
    return head, launches


# phase 7 bounds (f32): loss and gradients of two exact routes that differ
# in summation order only
ROUTE_LOSS_TOL = 1e-5
ROUTE_GRAD_TOL = 2e-5


def phase_routes(T, FA):
    """Phase 7: kernel route vs plain route (flash="off"), f32, hd 128."""
    from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten

    cfg0 = T.GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=256,
                       d_ff=1024, max_seq=256, dtype=torch.float32,
                       remat=False)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(1),
                           cfg0, "cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, size=(2, 256))).to("cuda")
    tgts = toks.roll(-1, 1)

    def run(**kw):
        cfg = dataclasses.replace(cfg0, **kw)
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree_leaves(params)]
        loss = T.loss_fn(tree_unflatten(params, leaves), toks, tgts, cfg,
                         train=True)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    ref_loss, ref_grads = run(flash="off")
    errs = {}
    for bwd in ("split", "fused"):
        before = [k.launches for k in FA.KERNELS]
        loss, grads = run(flash="on", flash_bwd=bwd)
        torch.cuda.synchronize()
        used = [k.launches - b for k, b in zip(FA.KERNELS, before)]
        check(used[0] == cfg0.n_layer, f"phase 7 {bwd}: launches {used}")
        e_g = max(float((a - b).abs().max())
                  for a, b in zip(grads, ref_grads))
        errs[bwd] = (abs(loss - ref_loss), e_g)
        check(abs(loss - ref_loss) <= ROUTE_LOSS_TOL,
              f"phase 7 {bwd}: loss {loss} vs plain {ref_loss}")
        check(e_g <= ROUTE_GRAD_TOL, f"phase 7 {bwd}: grad err {e_g}")
    print(f"phase 7 kernel vs plain route: f32 d256 H2 hd128 L2 S256 B2, "
          f"loss {ref_loss:.6f}; |d loss|, max |d grad| per leaf: "
          + ", ".join(f"{k} {a:.3g}, {b:.3g}" for k, (a, b) in errs.items())
          + f" (bounds {ROUTE_LOSS_TOL}, {ROUTE_GRAD_TOL})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="TABLE_PATH",
                        help="profile one more headline train step and "
                             "write its kernel table here")
    profile = parser.parse_args().profile
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import flash_attention as FA
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
    err, kern_ms, plain_ms = phase_kernels(rng, paged_attention,
                                           paged_attention_reference)
    flash = phase_flash_kernels(rng, FA)

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
    head, split = phase_train(T, FA, profile)
    phase_routes(T, FA)

    src = "neuronika_tpu_torch/csrc/flash_attention_qkv.cu"
    at = "neuronika_tpu/ops/pallas/attention.py:"
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "neuronika_tpu_torch/csrc/paged_attention.cu",
        "replaces": "neuronika_tpu/ops/pallas/paged_attention.py:44",
        "launches": launches, "max_abs_err": err, "ms": kern_ms,
        "plain_ms": plain_ms}]
    # K2c (:1109) and K2d (:1194) are one CUDA kernel; it names the first
    for name, line, counts in (("flash_fwd_qkv", 639, head),
                               ("flash_bwd_dq_qkv", 708, split),
                               ("flash_bwd_dkv_qkv", 755, split),
                               ("flash_bwd_fused_qkv", 1109, head)):
        e, ms, p_ms = flash[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{at}{line}",
                        "launches": counts[name], "max_abs_err": e,
                        "ms": ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
