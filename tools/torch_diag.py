"""Twenty-two measurements of the PyTorch/CUDA port that chip_smoke.py does
not make, run on one CUDA card from the root of a checkout:

    python3 tools/torch_diag.py step TREE_ROOT
        the GPTConfig defaults train step (split flash backward; d1536 L8
        H12 V16384 S2048 B16 bf16, 1 warm-up and 4 timed steps) and the Var
        2-d model's step (chip_smoke.py phase 9) of the checkout at
        TREE_ROOT, with that checkout's own package and chip_smoke.py; run
        it for two checkouts in turns (A, B, B, A) on one card to
        compare them;
    python3 tools/torch_diag.py headline TREE_ROOT
        chip_smoke.py phase 6's headline train step (fused flash backward,
        no remat, fast softmax, bf16 Adam; d1536 L8 H12 V16384 S2048 B16
        bf16) of the checkout at TREE_ROOT, 1 warm-up and 4 timed steps;
        run it for two checkouts in turns to compare them;
    python3 tools/torch_diag.py mistral TREE_ROOT
        the same for chip_smoke.py phase 11's step: Mistral 7B's widths at
        L4, S8192 B2 bf16, window 4096 (1 warm-up and 4 timed steps);
    python3 tools/torch_diag.py kernels TREE_ROOT
        CUDA-event times of the checkout's flash kernels: K5 (also at
        dropout 0.1), K6 and K7 at bf16 B1 H8 and B2 H32 S8192 hd128 window
        4096 (chip_smoke.py phase 3's shapes; SDPA's band-masked backward
        beside them at B1 H8), and K1 (also at dropout 0.1), K2a (with its
        own pre-pass), K2b, the split pair and the fused K2 at the headline
        (bf16 B16 S2048 H12 hd128 causal, fast softmax); the best of two
        runs of 5 launches each, as phase 3 times them;
    python3 tools/torch_diag.py f32-noise
        the f32 packed-qkv flash backward (K2a + K2b, the fused K2) and its
        plain version against an exact f64 backward, per chunk (dq, dk,
        dv), causal, at S 2065 / 2048 / 200 and G 8 / 4: how far each side
        sits from the exact result;
    python3 tools/torch_diag.py f32-fused TREE_ROOT
        CUDA-event time of the f32 fused flash backward (the kernel that
        phases 7 and 10 of chip_smoke.py run) of the checkout at TREE_ROOT,
        at B4 S2048 H12 hd128 causal, beside its bound (FFMA's 67 TFLOP/s);
    python3 tools/torch_diag.py conv TREE_ROOT
        CUDA-event times of the checkout's K12 and K13 (bf16) at the table
        shape of chip_smoke.py phase 3 (64x56x56x256 -> 256, k3) and at
        every distinct shape and role (forward, stride-1 dx, dw) that one
        step of phase 13's ResNet-18 (224x224 B64 bf16, conv_impl
        "pallas") calls them with, each beside cuDNN's call for the same
        function (F.conv2d, torch.nn.grad.conv2d_weight; TF32 off) and
        its bound, and the sums over the step's calls; device time a call
        from torch.profiler, the best of two runs of 20 calls each;
    python3 tools/torch_diag.py stem TREE_ROOT
        the checkout's K12 at both ResNet stems (bf16 B64, SAME: the
        padded 229x229x3 input, 7x7/2 -> 64, and 34x34x3, 3x3/1 -> 32):
        the whole call by CUDA events (the best of two runs of 20) and by
        the profiler's device time a kernel, beside cuDNN's (F.conv2d on a
        channels-last view of the same input, TF32 off) and the bound;
        where the checkout stacks the stem's taps (`stack_taps_nhwc`), the
        pre-pass and the stacked K12 alone too; the stem's weight gradient
        as the strided backward runs it (torch.nn.grad.conv2d_weight on
        contiguous NCHW copies), by kernel; run it for two checkouts in
        turns to compare them;
    python3 tools/torch_diag.py profile-window TREE_ROOT SECONDS
        whether torch.profiler keeps the first kernels of a window late in
        a long process: runs phase 13's ResNet-18 train step of the
        checkout for SECONDS, then profiles one step at a time, three
        times without and three times with 0.1 s of idle time at each end
        of the window, in turns (a clock drift between host and card would
        drop the first kernels of the unpadded window only), printing the
        kernels the window holds, whether the stem's kernels are among
        them, and when the first one starts after the window opens;
    python3 tools/torch_diag.py ce TREE_ROOT
        CUDA-event times of the checkout's K8, K9 and K10 at chip_smoke.py
        phase 6's LM head (bf16 N32768 D1536 V16384; the best of two runs
        of 3 launches each, as phase 3 times them, each after 2 s of an
        idle card: right after the other Hopper CE kernel one reads about
        4% slower on an H100 at 700 W) and phase 6's headline step with
        fused_ce="on" (1 warm-up and 4 timed steps); run it for two
        checkouts in turns to compare them;
    python3 tools/torch_diag.py paged TREE_ROOT
        CUDA-event times of the checkout's K11 (paged decode attention,
        bf16 G1 hd128 BS16) at chip_smoke.py phase 3's table shape (B8 KV12
        MB64, its pos list and an idle lane), at the long-context shape (B1
        KV12 MB512 at pos 8191) and at phase 4's serving shape (B8 KV12
        MB64, contexts 33-192): the device time a call from torch.profiler
        (the best of two runs of 200 calls) beside the time a call of 200
        issued back to back (CUDA events, as phase 3 times them: where the
        host's work for a call takes longer than the kernel, that is the
        host's issue rate); run it for two checkouts in turns to compare
        them;
    python3 tools/torch_diag.py paged-g16 TREE_ROOT
        K11 at StarCoderBase-1B's decode (bf16 B8, 16 query heads over one
        kv head, hd128 BS16 MB128, contexts up to 2048) for the checkout
        at TREE_ROOT: the device time a call from torch.profiler (the best
        of two runs of 200) and the time a call issued back to back (CUDA
        events), the route it took and its error against the plain
        version, under the checkout's plan and, where the checkout has the
        tensor-core body's plan (`paged_mma_plan`), under 8, 16, 32 and 64
        splits of the 128 blocks; then the `paged` mode's G1 shapes; run
        it for two checkouts in turns to compare them;
    python3 tools/torch_diag.py paged-loads TREE_ROOT
        the tensor-core K11 body's loads two ways: copies the checkout's
        package and chip_smoke.py into a temporary directory, replaces
        the body's 1-d bulk copies (a K or V row a lane, on an mbarrier a
        warp and stage) there with cp.async loads of 16 bytes a lane
        (PAGED_CP_ASYNC), builds both, then runs the `paged-g16` mode on
        the checkout, the copy, the copy and the checkout;
    python3 tools/torch_diag.py serve TREE_ROOT
        chip_smoke.py phase 4's serving run of the checkout at TREE_ROOT
        (16 greedy requests through PagedBatcher at d1536 L8 bf16, after
        its one-request warm-up): tokens/s, TTFT and ITL (host clock) and
        the decode steps; then the run once more under torch.profiler:
        its device time in all and K11's (the host's time there is the
        profiler's too); run it for two checkouts in turns to compare
        them;
    python3 tools/torch_diag.py conv3d TREE_ROOT
        CUDA-event time of the checkout's K15 at the table shape of
        chip_smoke.py phase 3 (bf16 32x16^3x128 -> 128, k3; the best of two
        runs of 20 launches) beside F.conv3d's and the bound;
    python3 tools/torch_diag.py conv1d TREE_ROOT
        CUDA-event times of the checkout's K14 (bf16, k3, 256 -> 256
        channels) at the table shape of chip_smoke.py phase 3 (B64 L3138 ->
        3136; the best of two runs of 20 launches) and at phase 3's route
        shapes (B1, B2 and B4 at L3136; 50 launches, in turns with the
        library), each beside F.conv1d's and the bound, and the kernel
        that ran (Hopper or csrc/conv.cu); run it for two checkouts in
        turns to compare them;
    python3 tools/torch_diag.py resnet TREE_ROOT
        phase 13's ResNet-18 train step of the checkout: 2 warm-up and 5
        timed steps, twice, with its K12 and K13 launch counts;
    python3 tools/torch_diag.py host TREE_ROOT
        the host's time for one K3 call (`ops.matmul.matmul`) of the
        checkout at TREE_ROOT at three of phase 9's f32 products, for one
        K12 and one K13 call at ResNet-18's stage-4 conv at batch 1 (bf16)
        beside F.conv2d's, and for one K11 call at phase 4's serving shape
        (the `paged` mode's): 200 calls issued back to back (fewer
        launches than the card's queue holds), in all and with the kernel
        library replaced by a stub that launches nothing (the Python
        wrapper alone), beside the device time (CUDA events for K3, the
        profiler for the convs).
    python3 tools/torch_diag.py tiers TREE_ROOT five|three
        what the CUDA-core flash kernels' 32 and 96 head-dim tiers buy:
        builds the checkout's kernels with all five tiers, or with
        NK_FLASH_TIERS_3 (only 64, 128 and 256, so hd 32 runs masked at
        64 and hd 96 at 128), printing nvcc's wall time when it builds,
        then CUDA-event times (the best of two runs of 5 launches) of K1,
        K2a and K2b at bf16 B8 S2048 H16 causal at hd 32 and at hd 96, and
        of K5, K6 and K7 at Phi-3-mini's shape (bf16 B1 H32 S4096 hd96,
        window 2047); run five, three, three, five in one call to compare.
    python3 tools/torch_diag.py hd96 TREE_ROOT [TABLE_PATH]
        the split flash kernels at Phi-3-mini's head dim for the checkout
        at TREE_ROOT: CUDA-event times (the best of two runs of 5
        launches) of K5, K6 and K7, and of K6 and K7 at dropout 0.1, at
        bf16 B1 H32 S4096 hd96 window 2047 (chip_smoke.py phase 19's
        shape) beside SDPA's band-masked backward and each kernel's bound,
        with the route each took where the checkout records it; as
        controls the same at B1 H8 S8192 hd128 window 4096 (phase 3's;
        and SDPA's band-masked forward and backward at phase 11's B2 H32
        there) and K1, K2a, K2b and the fused K2 at bf16 S2048 causal, B16 H12
        hd128 and B8 H16 hd64; then phase 19's Phi-3-mini
        L4 train step (S4096 B2 bf16, remat "full", 1 warm-up and 3 timed
        steps) and, with TABLE_PATH, one more step under torch.profiler
        (chip_smoke.profile_step); run it for two checkouts in turns to
        compare them;
    python3 tools/torch_diag.py starcoder TREE_ROOT [TABLE_PATH]
        chip_smoke.py phase 19's StarCoderBase-1B shapes for the checkout
        at TREE_ROOT: K1, K2a and K2b (and the fused K2) at bf16 B8 S2048
        H16 KV1 hd128 causal, first against their plain versions, then
        their CUDA-event times (the best of two runs of 5 launches) beside
        the plain versions', SDPA's (k and v repeated) and the bounds
        (chip_smoke.wide_packed_times), with the route each kernel took
        where the checkout records it, and K2b's time at each cluster
        size 1, 2, 4 and 8 where it has a cluster plan, the fused K2's
        likewise where it has one (`fused_cluster`); then the train step
        at StarCoderBase-1B's widths (full depth, S2048 B8 bf16, flash
        "on", the GPTConfig defaults, split backward, then the same with
        flash_bwd "fused"; 1 warm-up and 2 timed steps each): step time,
        tokens/s and MFU, and with TABLE_PATH one more step of each under
        torch.profiler (chip_smoke.profile_step: device time by kernel
        kind, the kernel tables written there, "_fused" before the fused
        step's extension); run it for two checkouts in turns to compare
        them;
    python3 tools/torch_diag.py fused-parts TREE_ROOT
        where the bf16 fused K2's walk spends its time: copies the
        checkout's package and chip_smoke.py into temporary directories,
        takes one part of csrc/flash_sm90.cuh::kv_walk's FUSED walk out of
        each copy (FUSED_CUTS: the dq writer's bulk stores and adds, its
        turn waits, both, the dQ = dS K product; their results are wrong
        and only their times are read), builds all at once, then times
        the fused K2 of the whole checkout and of each copy in turns
        (whole, cuts, whole, cuts reversed, whole; the best of two runs
        of 5 launches each) at StarCoderBase-1B's shape (bf16 B8 S2048 H16
        KV1 hd128 causal: the cluster walk) and at the headline (B16 H12
        KV12, fast softmax: one CTA an item).
"""

import functools
import math
import os
import sys
import time

import torch


def step(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np

    import chip_smoke as cs
    import neuronika_tpu_torch as nk
    from neuronika_tpu_torch import _build, optim
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE
    from neuronika_tpu_torch.ops import flash_attention as FA
    from neuronika_tpu_torch.ops import matmul as MM
    from neuronika_tpu_torch.ops import softmax as SM

    _build.load_library()
    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, cs.TRAIN_CFG["vocab_size"], size=(B, S))
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))
    cfg = T.GPTConfig(dtype=torch.bfloat16, **cs.TRAIN_CFG)
    losses, launches, step_s, _, _ = cs.train_steps(
        T, cs.train_kernels(FA, CE), cfg, 1, 4, batch, 5e-4)
    print(f"{root}: defaults step {step_s * 1e3:.2f} ms, losses "
          f"{[round(l, 4) for l in losses]}, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    torch.cuda.empty_cache()
    cs.phase_var_legacy(nk, T, optim, FA, MM, SM)


def _tree(root):
    """chip_smoke and the flash ops of the checkout at `root`."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.ops import flash_attention as FA

    _build.load_library()
    return root, cs, FA


def headline(root):
    import numpy as np

    root, cs, FA = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE

    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, cs.TRAIN_CFG["vocab_size"], size=(B, S))
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))
    cfg = T.GPTConfig(dtype=torch.bfloat16, **cs.TRAIN_CFG, **cs.HEADLINE)
    losses, launches, step_s, peak, _ = cs.train_steps(
        T, cs.train_kernels(FA, CE), cfg, 1, 4, batch, 5e-4)
    print(f"{root}: headline step {step_s * 1e3:.2f} ms, peak {peak:.2f} "
          f"GiB, losses {[round(l, 4) for l in losses]}, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)


def mistral(root):
    import numpy as np

    root, cs, FA = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE

    rng = np.random.default_rng(0)
    B, S = 2, 8192
    cfg = T.mistral_config(dtype=torch.bfloat16, **cs.MISTRAL_7B)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))
    losses, launches, step_s, peak, _ = cs.train_steps(
        T, cs.train_kernels(FA, CE), cfg, 1, 4, batch, 3e-4)
    print(f"{root}: Mistral L4 step {step_s * 1e3:.2f} ms, peak {peak:.2f} "
          f"GiB, losses {[round(l, 4) for l in losses]}, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)


def kernels(root):
    import numpy as np

    root, cs, FA = _tree(root)

    def best(fn):
        return min(cs.cuda_ms(fn, 5), cs.cuda_ms(fn, 5))

    g = torch.Generator(device="cuda").manual_seed(5)
    S, hd, W = 8192, 128, 4096
    for B, H in ((1, 8), (2, 32)):
        q, k, v, do = cs.split_case(g, B, H, S, S, hd, torch.bfloat16, False)
        out, lse = FA.flash_fwd(q, k, v, window=W)
        delta = (do.float() * out.float()).sum(-1)
        line = []
        for name, fn in (
                ("flash_fwd", lambda: FA.flash_fwd(q, k, v, window=W)),
                ("flash_fwd dropout 0.1", lambda: FA.flash_fwd(
                    q, k, v, window=W, seed=3, rate=0.1)),
                ("flash_bwd_dq", lambda: FA.flash_bwd_dq(
                    q, k, v, do, lse, delta, window=W)),
                ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(
                    q, k, v, do, lse, delta, window=W))):
            ms = best(fn)
            bound, flops = cs.split_bound(name.split()[0], B, H, S, hd, True,
                                          W)
            line.append(f"{name} {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                        f"TFLOP/s, bound {bound[0]:.3f})")
        if B == 1:
            line.append(f"SDPA backward "
                        f"{cs.sdpa_band_ms(q, k, v, do, W)[1]:.3f} ms")
        print(f"{root}: bf16 B{B} H{H} S{S} hd{hd} window {W}: "
              + "; ".join(line), flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    B, H, S = 16, 12, 2048
    qkv, do = cs.flash_case(np.random.default_rng(0), B, H, H, hd, S,
                            torch.bfloat16)
    out, lse = FA.flash_fwd_qkv(qkv, H, fast_softmax=True)
    d_qkv = torch.empty_like(qkv)

    def pair():
        st = FA.flash_bwd_stats_qkv(qkv, out, lse, do, H)
        FA.flash_bwd_dq_qkv(qkv, out, lse, do, d_qkv, H, stats=st)
        FA.flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, H, stats=st)

    line = [f"{name} {best(fn):.3f} ms" for name, fn in (
        ("flash_fwd_qkv", lambda: FA.flash_fwd_qkv(qkv, H,
                                                   fast_softmax=True)),
        ("flash_fwd_qkv dropout 0.1", lambda: FA.flash_fwd_qkv(
            qkv, H, fast_softmax=True, seed=3, rate=0.1)),
        ("flash_bwd_dq_qkv", lambda: FA.flash_bwd_dq_qkv(
            qkv, out, lse, do, d_qkv, H)),
        ("flash_bwd_dkv_qkv", lambda: FA.flash_bwd_dkv_qkv(
            qkv, out, lse, do, d_qkv, H)),
        ("split pair", pair),
        ("flash_bwd_fused_qkv", lambda: FA.flash_bwd_fused_qkv(
            qkv, out, lse, do, H)))]
    print(f"{root}: bf16 B{B} S{S} H{H} hd{hd} causal fast: "
          + "; ".join(line), flush=True)


def starcoder(root, table=None):
    import json

    import numpy as np

    here = os.getcwd()
    root, cs, FA = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE

    times = cs.wide_packed_times(np.random.default_rng(19), FA, 8, 16, 1,
                                 128, 2048)
    routes = {k.__name__: getattr(k, "route", "not recorded")
              for k in FA.KERNELS}
    print(f"{root}: StarCoderBase-1B's attention (bf16 B8 S2048 H16 KV1 "
          f"hd128 causal): " + "; ".join(
              f"{n} {ms:.4f} ms (plain {p_ms:.3f}, SDPA {lib:.4f}, bound "
              f"{b[0]:.4f}; max abs err {e:.3g})"
              for n, (ms, p_ms, lib, b, e) in times.items())
          + f"; routes {json.dumps(routes)}", flush=True)
    # K2b, then the fused K2, at each cluster size (1 included) where the
    # checkout has the kernel's plan
    qkv, do = cs.flash_case(np.random.default_rng(21), 8, 16, 1, 128, 2048,
                            torch.bfloat16)
    out, lse = FA.flash_fwd_qkv(qkv, 16, 1)
    d_qkv = torch.empty_like(qkv)
    for label, attr, fn, run in (
            ("K2b", "dkv_cluster", FA.flash_bwd_dkv_qkv,
             lambda: FA.flash_bwd_dkv_qkv(qkv, out, lse, do, d_qkv, 16, 1)),
            ("the fused K2", "fused_cluster", FA.flash_bwd_fused_qkv,
             lambda: FA.flash_bwd_fused_qkv(qkv, out, lse, do, 16, 1))):
        if not hasattr(FA, attr):
            continue
        plan, line = getattr(FA, attr), []
        try:
            for c in (1, 2, 4, 8):
                setattr(FA, attr, lambda *a, c=c: c)
                ms = min(cs.cuda_ms(run, 5) for _ in range(2))
                line.append(f"{fn.route} {ms:.4f} ms")
        finally:
            setattr(FA, attr, plan)
        print(f"{root}: {label} at StarCoderBase-1B's shape by cluster size "
              f"(the plan takes {plan(8, 1, 2048, 16)}): " + "; ".join(line),
              flush=True)
    del qkv, do, out, lse, d_qkv
    torch.cuda.empty_cache()
    B, S = 8, 2048
    batch = cs.lm_batch(np.random.default_rng(1),
                        cs.STARCODER_1B["vocab_size"], B, S)
    if table:
        table = os.path.abspath(os.path.join(here, table))
    for bwd in ("split", "fused"):
        cfg = T.GPTConfig(dtype=torch.bfloat16, flash="on", flash_bwd=bwd,
                          **cs.STARCODER_1B)
        path = table
        if table and bwd == "fused":
            path = "{0}_fused{1}".format(*os.path.splitext(table))
        losses, launches, step_s, peak, _ = cs.train_steps(
            T, cs.train_kernels(FA, CE), cfg, 1, 2, batch, cs.WIDE_LR, path,
            f"one StarCoderBase-1B step of {root}, {bwd} backward")
        tok_s = B * S / step_s
        mfu = T.flops_per_token(cfg, S) * tok_s / 989e12
        print(f"{root}: StarCoderBase-1B step, {bwd} backward, "
              f"{step_s * 1e3:.2f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f}, "
              f"peak {peak:.2f} GiB, losses {[round(l, 4) for l in losses]}, "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)


# kv_walk's FUSED walk with one part taken out (fused-parts): the text of
# csrc/flash_sm90.cuh each cut replaces with an empty statement
_BULK = ("                bulk_store(dst, src, kBQh * Sm::LDQ * 4);",
         "                bulk_add_f32(dst, src, kBQh * Sm::LDQ * 4);")
_TURN = "              while (ld_acquire(turn) < w.kt) __nanosleep(32);"
_DQ = ("                wgmma_ss<1, 1>(dq, mnmajor<kBN>(smem_u32(dSt), 0, k),\n"
       "                               mnmajor<kBN>(k_addr, wg, k), k > 0);")
FUSED_CUTS = {"no dq adds": _BULK, "no turn waits": (_TURN,),
              "no writer": _BULK + (_TURN,), "no dQ product": (_DQ,)}


def fused_parts(root):
    import shutil
    import subprocess
    import tempfile

    root = os.path.abspath(root)
    tmp = tempfile.mkdtemp(prefix="fused_parts_")
    trees = {"whole": root}
    try:
        for i, (name, cuts) in enumerate(FUSED_CUTS.items()):
            tree = os.path.join(tmp, f"cut{i}")
            shutil.copytree(os.path.join(root, "neuronika_tpu_torch"),
                            os.path.join(tree, "neuronika_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(root, "chip_smoke.py"), tree)
            path = os.path.join(tree, "neuronika_tpu_torch", "csrc",
                                "flash_sm90.cuh")
            with open(path) as f:
                text = f.read()
            for cut in cuts:
                if text.count(cut) != 1:
                    sys.exit(f"fused-parts: {name}: the walk no longer "
                             f"holds {cut!r} once")
                text = text.replace(cut, "                ;")
            with open(path, "w") as f:
                f.write(text)
            trees[name] = tree
        build = ("import sys; sys.path.insert(0, '.'); from "
                 "neuronika_tpu_torch import _build; _build.build()")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t)
                 for t in trees.values()]
        if any(p.wait() for p in procs):
            sys.exit("fused-parts: a build failed")
        cuts = list(FUSED_CUTS)
        for name in ["whole"] + cuts + ["whole"] + cuts[::-1] + ["whole"]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "fused-time", trees[name], name], check=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fused_time(root, name):
    import numpy as np

    root, cs, FA = _tree(root)
    line = []
    for B, H, KV, fast in ((8, 16, 1, False), (16, 12, 12, True)):
        qkv, do = cs.flash_case(np.random.default_rng(21), B, H, KV, 128,
                                2048, torch.bfloat16)
        out, lse = FA.flash_fwd_qkv(qkv, H, KV, fast_softmax=fast)
        ms = min(cs.cuda_ms(lambda: FA.flash_bwd_fused_qkv(
            qkv, out, lse, do, H, KV), 5) for _ in range(2))
        line.append(f"B{B} H{H} KV{KV} {ms:.4f} ms "
                    f"({FA.flash_bwd_fused_qkv.route})")
        del qkv, do, out, lse
    print(f"fused K2, {name}: " + "; ".join(line), flush=True)


def tiers(root, which):
    import numpy as np

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.ops import flash_attention as FA

    if which == "three":
        _build.NVCC_FLAGS += ("-DNK_FLASH_TIERS_3",)
    built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    _build.load_library()

    def best(fn):
        return min(cs.cuda_ms(fn, 5), cs.cuda_ms(fn, 5))

    line = [f"nvcc {build_s:.1f} s" if built else "library reused"]
    B, H, S = 8, 16, 2048
    for hd in (32, 96):
        qkv, do = cs.flash_case(np.random.default_rng(0), B, H, H, hd, S,
                                torch.bfloat16)
        out, lse = FA.flash_fwd_qkv(qkv, H)
        d_qkv = torch.empty_like(qkv)
        line += [f"{name} hd{hd} {best(fn):.4f} ms" for name, fn in (
            ("flash_fwd_qkv", lambda: FA.flash_fwd_qkv(qkv, H)),
            ("flash_bwd_dq_qkv", lambda: FA.flash_bwd_dq_qkv(
                qkv, out, lse, do, d_qkv, H)),
            ("flash_bwd_dkv_qkv", lambda: FA.flash_bwd_dkv_qkv(
                qkv, out, lse, do, d_qkv, H)))]
        del qkv, do, out, lse, d_qkv
    g = torch.Generator(device="cuda").manual_seed(96)
    W = 2047
    q, k, v, do = cs.split_case(g, 1, 32, 4096, 4096, 96, torch.bfloat16,
                                False)
    out, lse = FA.flash_fwd(q, k, v, window=W)
    delta = (do.float() * out.float()).sum(-1)
    line += [f"{name} hd96 {best(fn):.4f} ms" for name, fn in (
        ("flash_fwd", lambda: FA.flash_fwd(q, k, v, window=W)),
        ("flash_bwd_dq", lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 window=W)),
        ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   window=W)))]
    print(f"{root} tiers {which}: " + "; ".join(line), flush=True)


def hd96(root, table=None):
    import numpy as np

    root, cs, FA = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE

    def best(fn):
        return min(cs.cuda_ms(fn, 5), cs.cuda_ms(fn, 5))

    def route(fn):
        return getattr(fn, "route", None) or "route not recorded"

    g = torch.Generator(device="cuda").manual_seed(96)
    for B, H, S, hd, W in ((1, 32, 4096, 96, 2047), (1, 8, 8192, 128, 4096)):
        q, k, v, do = cs.split_case(g, B, H, S, S, hd, torch.bfloat16, False)
        out, lse = FA.flash_fwd(q, k, v, window=W)
        delta = (do.float() * out.float()).sum(-1)
        line = []
        for name, fn in (
                ("flash_fwd", lambda: FA.flash_fwd(q, k, v, window=W)),
                ("flash_bwd_dq", lambda: FA.flash_bwd_dq(
                    q, k, v, do, lse, delta, window=W)),
                ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(
                    q, k, v, do, lse, delta, window=W)),
                ("flash_bwd_dq dropout 0.1", lambda: FA.flash_bwd_dq(
                    q, k, v, do, lse, delta, window=W, seed=3, rate=0.1)),
                ("flash_bwd_dkv dropout 0.1", lambda: FA.flash_bwd_dkv(
                    q, k, v, do, lse, delta, window=W, seed=3, rate=0.1))):
            ms = best(fn)
            kname = name.split()[0]
            bound, flops = cs.split_bound(kname, B, H, S, hd, True, W)
            line.append(f"{name} {ms:.4f} ms ({route(getattr(FA, kname))}, "
                        f"{flops / ms / 1e9:.1f} TFLOP/s, bound "
                        f"{bound[0]:.4f})")
        line.append(f"SDPA band-masked backward "
                    f"{cs.sdpa_band_ms(q, k, v, do, W)[1]:.4f} ms")
        print(f"{root}: bf16 B{B} H{H} S{S} hd{hd} window {W}: "
              + "; ".join(line), flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    q, k, v, do = cs.split_case(g, 2, 32, 8192, 8192, 128, torch.bfloat16,
                                False)
    print(f"{root}: bf16 B2 H32 S8192 hd128 window 4096: SDPA band-masked "
          "forward %.4f ms, backward %.4f ms"
          % cs.sdpa_band_ms(q, k, v, do, 4096), flush=True)
    del q, k, v, do
    torch.cuda.empty_cache()
    for B, H, hd in ((16, 12, 128), (8, 16, 64)):
        qkv, do = cs.flash_case(np.random.default_rng(0), B, H, H, hd, 2048,
                                torch.bfloat16)
        out, lse = FA.flash_fwd_qkv(qkv, H)
        d_qkv = torch.empty_like(qkv)
        line = []
        for fn, call in (
                (FA.flash_fwd_qkv, lambda: FA.flash_fwd_qkv(qkv, H)),
                (FA.flash_bwd_dq_qkv, lambda: FA.flash_bwd_dq_qkv(
                    qkv, out, lse, do, d_qkv, H)),
                (FA.flash_bwd_dkv_qkv, lambda: FA.flash_bwd_dkv_qkv(
                    qkv, out, lse, do, d_qkv, H)),
                (FA.flash_bwd_fused_qkv, lambda: FA.flash_bwd_fused_qkv(
                    qkv, out, lse, do, H))):
            line.append(f"{fn.__name__} {best(call):.4f} ms ({route(fn)})")
        print(f"{root}: bf16 B{B} S2048 H{H} hd{hd} causal: "
              + "; ".join(line), flush=True)
        del qkv, do, out, lse, d_qkv
        torch.cuda.empty_cache()
    batch = cs.lm_batch(np.random.default_rng(2), cs.PHI3_MINI["vocab_size"],
                        2, 4096)
    cfg = T.llama_config(dtype=torch.bfloat16, flash="on",
                         remat_policy="full", **cs.PHI3_MINI)
    losses, launches, step_s, peak, _ = cs.train_steps(
        T, cs.train_kernels(FA, CE), cfg, 1, 3, batch, cs.WIDE_LR, table,
        "one Phi-3-mini L4 step, remat full")
    print(f"{root}: Phi-3-mini L4 S4096 B2 step {step_s * 1e3:.2f} ms, peak "
          f"{peak:.2f} GiB, losses {[round(l, 4) for l in losses]}, "
          f"launches { {k: v for k, v in launches.items() if v} }, routes "
          f"{ {k.__name__: route(k) for k in FA.SPLIT_KERNELS} }",
          flush=True)


def ce(root):
    import numpy as np

    root, cs, FA = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.ops import cross_entropy as CE

    g = torch.Generator(device="cuda").manual_seed(8)
    N, D, V = cs.CE_HEAD
    x, w, t, gr = cs.ce_case(g, N, D, V, torch.bfloat16)
    _, lse = CE.ce_fwd(x, w, t)
    line = []
    for name, fn in (("ce_fwd", lambda: CE.ce_fwd(x, w, t)),
                     ("ce_dx", lambda: CE.ce_dx(x, w, t, lse, gr)),
                     ("ce_dw", lambda: CE.ce_dw(x, w, t, lse, gr))):
        torch.cuda.synchronize()
        time.sleep(2)
        ms = min(cs.cuda_ms(fn, 3), cs.cuda_ms(fn, 3))
        line.append(f"{name} {ms:.3f} ms")
    print(f"{root}: bf16 N{N} D{D} V{V}: " + ", ".join(line), flush=True)
    del x, w, t, gr, lse
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    B, S = 16, 2048
    toks = rng.integers(0, cs.TRAIN_CFG["vocab_size"], size=(B, S))
    batch = (torch.from_numpy(toks).to("cuda"),
             torch.from_numpy(np.roll(toks, -1, axis=1)).to("cuda"))
    cfg = T.GPTConfig(dtype=torch.bfloat16, fused_ce="on", **cs.TRAIN_CFG,
                      **cs.HEADLINE)
    losses, launches, step_s, peak, _ = cs.train_steps(
        T, cs.train_kernels(FA, CE), cfg, 1, 4, batch, 5e-4)
    print(f"{root}: fused-CE headline step {step_s * 1e3:.2f} ms, peak "
          f"{peak:.2f} GiB, losses {[round(l, 4) for l in losses]}, "
          f"launches { {k: v for k, v in launches.items() if v} }",
          flush=True)


# K11's three shapes (chip_smoke.py phase 3): name, then paged_case's
# arguments
PAGED_SHAPES = (
    ("table B8 KV12 MB64", dict(B=8, KV=12, MB=64, inactive=[7], pos=[
        0, 15, 16, 500, 1023, 700, 129, 0])),
    ("long B1 KV12 MB512", dict(B=1, KV=12, MB=512, inactive=[],
                                pos=[8191])),
    ("serving B8 KV12 MB64", dict(B=8, KV=12, MB=64, inactive=[], pos=[
        33, 57, 96, 128, 150, 170, 192, 80])))


def paged(root):
    import numpy as np

    root, cs, _ = _tree(root)
    from neuronika_tpu_torch.ops.paged_attention import paged_attention

    line = []
    for name, shape in PAGED_SHAPES:
        args = cs.paged_case(np.random.default_rng(0), G=1, hd=128, BS=16,
                             dtype=torch.bfloat16, **shape)

        def run():
            paged_attention(*args)

        dev = min(_device_ms(run, 200), _device_ms(run, 200))
        ms = min(cs.cuda_ms(run, 200), cs.cuda_ms(run, 200))
        line.append(f"{name} device {dev:.4f} ms, back to back {ms:.4f} ms")
    print(f"{root}: K11 bf16 G1 hd128 BS16: " + "; ".join(line), flush=True)


# StarCoderBase-1B's decode step (chip_smoke.py phase 3's PAGED_G16 and
# phase 19's K11 row): 16 query heads over one kv head, B8 MB128, contexts
# up to 2048
PAGED_G16 = dict(B=8, KV=1, G=16, hd=128, BS=16, MB=128, inactive=[],
                 pos=[2047, 1500, 700, 64, 1900, 33, 1024, 2000])
# the tensor-core body's plans timed beside its own: splits of the 128
# blocks
PAGED_G16_SPLITS = (8, 16, 32, 64)


def paged_g16(root):
    import numpy as np

    root, cs, _ = _tree(root)
    from neuronika_tpu_torch.ops import paged_attention as PA

    args = cs.paged_case(np.random.default_rng(0), dtype=torch.bfloat16,
                         **PAGED_G16)
    ref = PA.paged_attention_reference(*args).float()

    def timed(label):
        def run():
            PA.paged_attention(*args)

        err = float((PA.paged_attention(*args).float() - ref).abs().max())
        route = getattr(PA.paged_attention, "route", None) or "chunked"
        dev = min(_device_ms(run, 200), _device_ms(run, 200))
        ms = min(cs.cuda_ms(run, 200), cs.cuda_ms(run, 200))
        print(f"{root}: K11 bf16 B8 KV1 G16 hd128 BS16 MB128 {label}: device "
              f"{dev:.4f} ms, back to back {ms:.4f} ms, route {route}, max "
              f"abs err against plain {err:.3g}", flush=True)

    timed("plan " + str(PA.paged_mma_plan(8, 1, 16, 128)
                        if hasattr(PA, "paged_mma_plan") else
                        PA.paged_split_plan(8, 2, 128)))
    if hasattr(PA, "paged_mma_plan"):
        plan = PA._plan
        MB = PAGED_G16["MB"]
        for n in PAGED_G16_SPLITS:
            bps = -(-MB // n)
            PA._plan = lambda *a, bps=bps: (-(-MB // bps), bps)
            timed(f"{-(-MB // bps)} splits of {bps} blocks")
        PA._plan = plan
    paged(root)


# paged-loads: the tensor-core K11 body's K/V loads as cp.async 16 bytes a
# lane (rows outside the pool zero-filled by the copy, one commit group a
# tile) in place of its 1-d bulk copies (a K or V row a lane on an
# mbarrier a warp and stage); (text of csrc/paged_attention.cu, its
# replacement) pairs
_CP_HELPERS = ("""// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)""", """\
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)""")
_CP_ISSUE = ("""\
  auto issue = [&](int i) -> uint32_t {
    const int base = t_begin + (warp + kMmaWarps * i) * kMmaKeys;
    const int row = lane % kMmaKeys, col = base + row;
    const int blk = col < t_end ? __ldg(trow + col / BS) : -1;
    const bool ok = blk >= 0 && blk < NB;
    const uint32_t live = __ballot_sync(kFull, ok) & 0xffffu;
    __nv_bfloat16* dst = ring + (i % kMmaStages) * 2 * Sm::kTile +
                         (lane >= kMmaKeys ? Sm::kTile : 0) + row * LD;
    if (!ok)
#pragma unroll
      for (int ch = 0; ch < CPR; ++ch)
        reinterpret_cast<uint4*>(dst)[ch] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();  // the zeros and this stage's last reads, then
    __syncwarp();         // the copies
    uint64_t* bar = bars + i % kMmaStages;
    if (lane == 0) mbar_expect_tx(bar, __popc(live) * 2 * 2 * HD);
    if (ok)
      bulk_load(dst,
                (lane >= kMmaKeys ? pv : pk) +
                    (((size_t)blk * KV + kv) * BS + col % BS) * HD,
                2 * HD, bar);
    return live;
  };""", """\
  auto issue = [&](int i) -> uint32_t {
    const int base = t_begin + (warp + kMmaWarps * i) * kMmaKeys;
    __nv_bfloat16* ks = ring + (i % kMmaStages) * 2 * Sm::kTile;
    __nv_bfloat16* vs = ks + Sm::kTile;
    uint32_t live = 0;
#pragma unroll
    for (int it = 0; it < kMmaKeys * CPR / 32; ++it) {
      const int j = lane + 32 * it;
      const int row = j / CPR, ch = j % CPR, col = base + row;
      const int blk = col < t_end ? __ldg(trow + col / BS) : -1;
      const bool ok = blk >= 0 && blk < NB;
      const size_t at =
          ok ? (((size_t)blk * KV + kv) * BS + col % BS) * HD + ch * 8 : 0;
      cp_async16(ks + row * LD + ch * 8, pk + at, ok);
      cp_async16(vs + row * LD + ch * 8, pv + at, ok);
      if (ok) live |= 1u << row;
    }
    cp_async_commit();
    return __reduce_or_sync(kFull, live);
  };""")
_CP_LOOP = ("""\
  for (int s = 0; s + 1 < kMmaStages; ++s) live[s] = s < mine ? issue(s) : 0;
  for (int i = 0; i < mine; ++i) {
    live[kMmaStages - 1] =
        i + kMmaStages - 1 < mine ? issue(i + kMmaStages - 1) : 0;
    mbar_wait(bars + i % kMmaStages, (i / kMmaStages) & 1);""", """\
  for (int s = 0; s + 1 < kMmaStages; ++s) {
    if (s < mine) {
      live[s] = issue(s);
    } else {
      cp_async_commit();
      live[s] = 0;
    }
  }
  for (int i = 0; i < mine; ++i) {
    if (i + kMmaStages - 1 < mine) {
      live[kMmaStages - 1] = issue(i + kMmaStages - 1);
    } else {
      cp_async_commit();
      live[kMmaStages - 1] = 0;
    }
    cp_async_wait<kMmaStages - 1>();""")
PAGED_CP_ASYNC = (_CP_HELPERS, _CP_ISSUE, _CP_LOOP)


def paged_loads(root):
    import shutil
    import subprocess
    import tempfile

    root = os.path.abspath(root)
    tmp = tempfile.mkdtemp(prefix="paged_loads_")
    try:
        tree = os.path.join(tmp, "cp_async")
        shutil.copytree(os.path.join(root, "neuronika_tpu_torch"),
                        os.path.join(tree, "neuronika_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), tree)
        path = os.path.join(tree, "neuronika_tpu_torch", "csrc",
                            "paged_attention.cu")
        with open(path) as f:
            text = f.read()
        for old, new in PAGED_CP_ASYNC:
            if text.count(old) != 1:
                sys.exit(f"paged-loads: the body no longer holds {old!r} "
                         f"once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        build = ("import sys; sys.path.insert(0, '.'); from "
                 "neuronika_tpu_torch import _build; _build.build()")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t)
                 for t in (root, tree)]
        if any(p.wait() for p in procs):
            sys.exit("paged-loads: a build failed")
        for t in (root, tree, tree, root):
            print(f"paged-loads: {'cp.async' if t == tree else 'bulk copies'}"
                  f" ({t})", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "paged-g16", t], check=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve(root):
    import numpy as np

    root, cs, _ = _tree(root)
    from neuronika_tpu_torch.models import transformer as T
    from neuronika_tpu_torch.serving import PagedBatcher

    cfg = T.GPTConfig(vocab_size=16384, n_layer=8, n_head=12, d_model=1536,
                      d_ff=6144, max_seq=1024, dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    pool = dict(n_slots=8, n_blocks=513, block_size=16)
    rng = np.random.default_rng(0)
    lens = rng.choice([32, 64, 128], size=16)
    max_news = [int(m) for m in rng.choice([32, 64], size=16)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in lens]
    cs.serve(PagedBatcher, params, cfg, prompts[:1], [4], **pool)
    pb, outs, steps, _, wall = cs.serve(PagedBatcher, params, cfg, prompts,
                                        max_news, **pool)
    met = pb.metrics
    n_tok = sum(len(o) for o in outs)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.serve(PagedBatcher, params, cfg, prompts, max_news, **pool)
    dev = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    k11 = sum(ms for name, ms in dev.items() if "paged_attention" in name)
    print(f"{root}: serving {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s; ttft_mean "
          f"{met['ttft_mean_s'] * 1e3:.2f} ms, itl_mean "
          f"{met['itl_mean_s'] * 1e3:.3f} ms; {steps} decode steps; under "
          f"the profiler {sum(dev.values()):.1f} ms on the device, K11 "
          f"{k11:.2f} ms", flush=True)


def conv3d(root):
    import torch.nn.functional as F

    root, cs, _ = _tree(root)
    from neuronika_tpu_torch.ops import conv as C

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(32, 16, 16, 16, 128, generator=g,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn(3, 3, 3, 128, 128, generator=g, device="cuda")
         * (27 * 128) ** -0.5).to(torch.bfloat16)
    xn, wn = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
    n_out = 32 * 14 ** 3 * 128
    flops = 2 * n_out * 27 * 128
    bound = cs.bound_ms((x.numel() + w.numel() + n_out) * 2, flops,
                        torch.bfloat16)[0]
    k = min(cs.cuda_ms(lambda: C.conv3d_direct_ndhwc(x, w), 20),
            cs.cuda_ms(lambda: C.conv3d_direct_ndhwc(x, w), 20))
    lib = min(cs.cuda_ms(lambda: F.conv3d(xn, wn), 20),
              cs.cuda_ms(lambda: F.conv3d(xn, wn), 20))
    print(f"{root}: K15 bf16 32x16^3x128 k3: kernel {k:.4f} ms "
          f"({flops / k / 1e9:.1f} TFLOP/s), F.conv3d {lib:.4f} ms, bound "
          f"{bound:.4f} ms", flush=True)


def conv1d(root):
    import torch.nn.functional as F

    root, cs, _ = _tree(root)
    from neuronika_tpu_torch.ops import conv as C

    k14 = C.conv1d_direct_nwc
    g = torch.Generator(device="cuda").manual_seed(6)
    line = []
    for B, iters in ((64, 20), (1, 50), (2, 50), (4, 50)):
        x = torch.randn(B, 3138, 256, generator=g,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn(3, 256, 256, generator=g, device="cuda")
             * (3 * 256) ** -0.5).to(torch.bfloat16)
        xn, wn = x.transpose(1, 2), w.permute(2, 1, 0)
        n_out = B * 3136 * 256
        flops = 2 * n_out * 3 * 256
        bound = cs.bound_ms((x.numel() + w.numel() + n_out) * 2, flops,
                            torch.bfloat16)[0]
        before = getattr(k14, "sm90_launches", None)
        k14(x, w)
        hopper = before is not None and k14.sm90_launches == before + 1

        def kern():
            return k14(x, w)

        def lib():
            return F.conv1d(xn, wn)

        ka, la = cs.cuda_ms(kern, iters), cs.cuda_ms(lib, iters)
        lb, kb = cs.cuda_ms(lib, iters), cs.cuda_ms(kern, iters)
        k, lib_ms = min(ka, kb), min(la, lb)
        line.append(f"B{B}: K14 ({'sm90' if hopper else 'conv.cu'}) "
                    f"{k:.4f} ms ({flops / k / 1e9:.1f} TFLOP/s, "
                    f"{bound / k:.1%} of bound), F.conv1d {lib_ms:.4f} ms, "
                    f"bound {bound:.4f} ms")
    print(f"{root}: K14 bf16 L3136 256->256 k3: " + "; ".join(line),
          flush=True)


def f32_fused(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch.ops import flash_attention as FA

    B, S, H, hd = 4, 2048, 12, 128
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, S, 3 * H * hd, generator=gen).cuda()
    do = torch.randn(B, S, H * hd, generator=gen).cuda()
    out, lse = FA.flash_fwd_qkv(qkv, H)
    ms = min(cs.cuda_ms(lambda: FA.flash_bwd_fused_qkv(qkv, out, lse, do, H),
                        5) for _ in range(2))
    flops = 5 * B * H * S * S * hd      # 5 products, half the pairs
    print(f"{root}: f32 fused K2 B{B} S{S} H{H} hd{hd} causal {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), bound "
          f"{flops / 67e12 * 1e3:.3f} ms (operations)", flush=True)


def host(root):
    import numpy as np
    import torch.nn.functional as F

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.ops import conv as C
    from neuronika_tpu_torch.ops import matmul as MM

    lib = _build.load_library()

    class Stub:
        def __getattr__(self, name):
            return lambda *args: 0

    def issue_us(fn, n=200):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    def line(name, fn, dev_us):
        full = issue_us(fn)
        _build.load_library = lambda: Stub()
        wrapper = issue_us(fn)
        _build.load_library = lambda: lib
        print(f"{root}: {name}: host {full:.1f} us a call ({wrapper:.1f} in "
              f"the Python wrapper), {dev_us:.1f} us a call on the device",
              flush=True)

    x = torch.randn(1024, 768, device="cuda")
    w = torch.randn(768, 768, device="cuda")
    p = torch.randn(1024, 1024, device="cuda")
    v = torch.randn(1024, 768, device="cuda")
    for name, a, b in (("proj x @ w (1024, 768) @ (768, 768)", x, w),
                       ("pv p @ v_h (1024, 1024) @ (1024, 128)", p,
                        v[:, :128]),
                       ("scores q_h @ k_h.t() (1024, 128) @ (128, 1024)",
                        x[:, :128], v[:, :128].t())):
        line(name, functools.partial(MM.matmul, a, b),
             cs.cuda_ms(lambda: MM.matmul(a, b), 50) * 1e3)
    # the conv wrappers at batch 1 (ResNet-18's stage-4 conv), bf16; device
    # time from the profiler
    xc = torch.randn(1, 9, 9, 512, device="cuda").bfloat16()
    wc = (0.01 * torch.randn(3, 3, 512, 512, device="cuda")).bfloat16()
    gc = torch.randn(1, 7, 7, 512, device="cuda").bfloat16()
    for name, fn in (
            ("K12 (1, 9, 9, 512) * (3, 3, 512, 512) bf16",
             functools.partial(C.conv2d_direct_nhwc, xc, wc)),
            ("K13 of the same conv",
             functools.partial(C.conv2d_dw_nhwc, xc, gc, 3, 3))):
        line(name, fn, _device_ms(fn, 20) * 1e3)
    fn = functools.partial(F.conv2d, xc.permute(0, 3, 1, 2),
                           wc.permute(3, 2, 0, 1))
    print(f"{root}: F.conv2d of the same conv: host {issue_us(fn):.1f} us a "
          f"call, {_device_ms(fn, 20) * 1e3:.1f} us a call on the device",
          flush=True)
    from neuronika_tpu_torch.ops.paged_attention import paged_attention

    name, shape = PAGED_SHAPES[2]
    fn = functools.partial(paged_attention, *cs.paged_case(
        np.random.default_rng(0), G=1, hd=128, BS=16, dtype=torch.bfloat16,
        **shape))
    line(f"K11 bf16 G1 hd128 BS16, {name}", fn, _device_ms(fn, 200) * 1e3)


def _resnet(root):
    """chip_smoke, the conv ops and phase 13's ResNet-18 train step (its
    config, params, momentum buffers, batch and step function) of the
    checkout at `root`."""
    import numpy as np

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.models import resnet as R
    from neuronika_tpu_torch.ops import conv as C

    _build.load_library()
    torch.backends.cudnn.allow_tf32 = False
    B, size = 64, 224
    cfg = R.ResNetConfig(dtype=torch.bfloat16, conv_impl="pallas",
                         **cs.RESNET18)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (B, size, size, 3)).astype(
        np.float32)).to("cuda")
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, B)).to("cuda")
    params = R.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    return (root, cs, C, R, cfg, params, R.momentum_init(params), x, y,
            R.make_train_step(cfg, momentum=0.9))


def _device_ms(fn, n):
    """Device time of the kernels one fn() launches, from torch.profiler
    over n calls after 3 warm-up calls: back-to-back CUDA events would
    time the host's issue rate at the small ResNet-18 shapes, whose
    kernels take less time than a call's host work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / n / 1e3


def resnet(root):
    root, cs, C, R, cfg, params, buf, x, y, step = _resnet(root)
    for _ in range(2):
        params, buf, loss = step(params, buf, x, y, 0.1)
    for run in range(2):
        torch.cuda.synchronize()
        for k in C.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        for _ in range(5):
            params, buf, loss = step(params, buf, x, y, 0.1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"{root}: ResNet-18 224x224 B64 bf16 step {ms:.2f} ms (run "
              f"{run + 1}), loss {float(loss):.4f}, launches in 5 steps: K12 "
              f"{C.conv2d_direct_nhwc.launches}, K13 "
              f"{C.conv2d_dw_nhwc.launches}", flush=True)


def conv(root):
    import collections

    import torch.nn.functional as F

    root, cs, C, R, cfg, params, buf, x, y, step = _resnet(root)
    params, buf, _ = step(params, buf, x, y, 0.1)
    # one step's K12/K13 calls: operands of the first call at each shape
    # and role, and the calls at each
    seen, calls, role = {}, collections.Counter(), ["fwd"]
    k12, k13, dx = (C.conv2d_direct_nhwc, C.conv2d_dw_nhwc,
                    C.conv2d_input_grad_nhwc)

    def keep(key, a, b):
        calls[key] += 1
        if key not in seen:
            seen[key] = tuple(t.detach().clone(
                memory_format=torch.contiguous_format) for t in (a, b))

    @functools.wraps(k12)
    def rec12(a, w, dilation=(1, 1), stride=(1, 1), *, groups=1, **kw):
        keep((role[0], tuple(a.shape), tuple(w.shape),
              C._as_tuple(stride, 2), C._as_tuple(dilation, 2), groups), a, w)
        return k12(a, w, dilation, stride, groups=groups, **kw)

    @functools.wraps(k13)
    def rec13(a, g, kh, kw, dilation=(1, 1), **kwargs):
        keep(("dw", tuple(a.shape), tuple(g.shape), (kh, kw),
              C._as_tuple(dilation, 2), 1), a, g)
        return k13(a, g, kh, kw, dilation, **kwargs)

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
        step(params, buf, x, y, 0.1)
        torch.cuda.synchronize()
    finally:
        C.conv2d_direct_nhwc, C.conv2d_dw_nhwc = k12, k13
        C.conv2d_input_grad_nhwc = dx
    del params, buf
    torch.cuda.empty_cache()

    def best(fn):
        return min(_device_ms(fn, 20), _device_ms(fn, 20))

    def time_call(role, a, b, st, dil, groups):
        """(kernel ms, cuDNN ms, bound ms) of one K12 or K13 call."""
        an = a.permute(0, 3, 1, 2)
        if role == "dw":
            kern = functools.partial(C.conv2d_dw_nhwc, a, b, *st, dil)
            lib = functools.partial(
                torch.nn.grad.conv2d_weight, an,
                (b.shape[-1], a.shape[-1], *st), b.permute(0, 3, 1, 2),
                dilation=dil)
            flops = 2 * b.numel() * st[0] * st[1] * a.shape[-1]
            nbytes = (a.numel() + b.numel()) * 2 + \
                st[0] * st[1] * a.shape[-1] * b.shape[-1] * 4
        else:
            kern = functools.partial(C.conv2d_direct_nhwc, a, b, dil, st,
                                     groups=groups)
            lib = functools.partial(F.conv2d, an, b.permute(3, 2, 0, 1),
                                    stride=st, dilation=dil, groups=groups)
            n_out = kern().numel()
            flops = 2 * n_out * (b.numel() // b.shape[-1])
            nbytes = (a.numel() + b.numel() + n_out) * 2
        bound = cs.bound_ms(nbytes, flops, torch.bfloat16)[0]
        return best(kern), best(lib), bound

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    xt, wt = rnd(64, 58, 58, 256), rnd(3, 3, 256, 256, scale=(9 * 256) ** -0.5)
    gt = rnd(64, 56, 56, 256)
    for role, b, st in (("fwd", wt, (1, 1)), ("dw", gt, (3, 3))):
        k, lib, bound = time_call(role, xt, b, st, (1, 1), 1)
        print(f"{root}: table shape 64x56x56x256 k3 {role}: kernel {k:.4f} "
              f"ms, cuDNN {lib:.4f} ms, bound {bound:.4f} ms", flush=True)
    del xt, wt, gt
    sums = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for key in sorted(seen, key=str):
        role, xs, ws, st, dil, groups = key
        k, lib, bound = time_call(role, *seen[key], st, dil, groups)
        n = calls[key]
        tot = sums["K13" if role == "dw" else "K12"]
        for i, v in enumerate((k, lib, bound, 1)):
            tot[i] += n * v
        print(f"{root}: {role} {xs}*{ws} {'k' if role == 'dw' else 's'}"
              f"{st[0]} x{n} a step: kernel {k:.4f} ms, cuDNN {lib:.4f} ms, "
              f"bound {bound:.4f} ms", flush=True)
    for name, (k, lib, bound, n) in sorted(sums.items()):
        print(f"{root}: {name} over one step's calls ({n} calls): kernel "
              f"{k:.3f} ms, cuDNN {lib:.3f} ms, bound {bound:.3f} ms",
              flush=True)


def _kernel_ms(fn, n=20):
    """{kernel name: device ms a call} of fn() from torch.profiler (n
    calls after 3 warm-up calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def stem(root):
    import torch.nn.functional as F

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.ops import conv as C

    _build.load_library()
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)
    stacked = hasattr(C, "stack_taps_nhwc")

    def best(fn):
        return min(cs.cuda_ms(fn, 20), cs.cuda_ms(fn, 20))

    for name, xs, ws, st in (("imagenet", (64, 229, 229, 3), (7, 7, 3, 64),
                              (2, 2)),
                             ("cifar", (64, 34, 34, 3), (3, 3, 3, 32),
                              (1, 1))):
        kh, kw, ci, co = ws
        x = torch.randn(*xs, generator=g, device="cuda").bfloat16()
        w = (torch.randn(*ws, generator=g, device="cuda")
             * (kh * kw * ci) ** -0.5).bfloat16()
        whole = functools.partial(C.conv2d_direct_nhwc, x, w, (1, 1), st)
        out = whole()
        ref = C.conv_nd_reference(x, w, st, (1, 1))
        err = float((out.float() - ref.float()).abs().max())
        lib = functools.partial(F.conv2d, x.permute(0, 3, 1, 2),
                                w.permute(3, 2, 0, 1), stride=st)
        bound = cs.bound_ms((x.numel() + w.numel() + out.numel()) * 2,
                            2 * out.numel() * kh * kw * ci, torch.bfloat16)
        line = [f"whole call {best(whole):.4f} ms (events), kernels "
                + ", ".join(f"{k.split('(')[0].split(' ')[-1]} {v:.4f}"
                            for k, v in _kernel_ms(whole).items())]
        if stacked:
            rows, h2, cs_ = C.stack_plan(xs[1], ci, (kh, kw), st, (1, 1))
            args = (x, kw, st[1], 1, cs_, rows, h2)
            xs_k = C.stack_taps_nhwc(*args)
            k12 = functools.partial(
                C._launch, C.conv2d_direct_nhwc, "nk_conv2d_stacked_sm90",
                xs_k, C.stack_weights(w, rows, cs_), (st[0] // rows, 1),
                (1, 1), 1, tuple(out.shape[1:3]))
            line.append(f"{rows} rows of taps in {cs_} channels: pre-pass "
                        f"{best(lambda: C.stack_taps_nhwc(*args)):.4f} ms, "
                        f"stacked K12 {best(k12):.4f} ms")
            pre_bound = cs.bound_ms((x.numel() + xs_k.numel()) * 2, 0,
                                    torch.bfloat16)
            line.append(f"pre-pass bound {pre_bound[0]:.4f} ms")
        line.append(f"cuDNN {best(lib):.4f} ms (events), "
                    f"{sum(_kernel_ms(lib).values()):.4f} ms (device)")
        # the stem's weight gradient as the port's strided backward runs
        # it (ops/conv.py::_ConvNHWC.backward: the library's, on
        # contiguous NCHW copies)
        xn = x.permute(0, 3, 1, 2).contiguous()
        gn = torch.randn(out.shape[0], co, *out.shape[1:3], generator=g,
                         device="cuda").bfloat16()
        wgrad = functools.partial(torch.nn.grad.conv2d_weight, xn,
                                  (co, ci, kh, kw), gn, st)
        line.append("wgrad (conv2d_weight) kernels " + ", ".join(
            f"{k.split('(')[0].split(' ')[-1][:60]} {v:.4f}"
            for k, v in _kernel_ms(wgrad).items()) + " ms")
        line.append(f"bound {bound[0]:.4f} ms ({bound[1]}); max abs err "
                    f"against plain {err:.3g}")
        print(f"{root}: {name} stem {xs}*{ws} s{st[0]}: " + "; ".join(line),
              flush=True)
        del x, w, out, ref, xn, gn
        torch.cuda.empty_cache()


# idle time at each end of a window, profile-window's second variant
_PAD_S = 0.1


def profile_window(root, seconds):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    root, cs, C, R, cfg, params, buf, x, y, step = _resnet(root)
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        params, buf, _ = step(params, buf, x, y, 0.1)
        n += 1
        if n % 50 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    print(f"{root}: {n} ResNet-18 steps in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stem = ("conv_mma<false>", "conv_stack_taps", "conv_sm90_stacked")
    for pad in (0.0, _PAD_S) * 3:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            step(params, buf, x, y, 0.1)
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        names = {k for e in dev for k in stem if k in e.name}
        first = min((e.time_range.start for e in dev), default=float("nan"))
        op0 = min(e.time_range.start for e in prof.events()
                  if e.device_type != DeviceType.CUDA
                  and e.name.startswith("aten::"))
        print(f"{root}: pad {pad} s: {len(dev)} kernels, "
              f"{sum(e.time_range.elapsed_us() for e in dev) / 1e3:.3f} ms;"
              f" stem kernels {sorted(names)}; the first kernel starts "
              f"{(first - op0) / 1e3:.3f} ms after the step's first op",
              flush=True)


def exact_backward(qkv, do, H, KV):
    """d_qkv of causal attention on the packed layout, all in f64."""
    B, S, W = qkv.shape
    hd = W // (H + 2 * KV)
    G = H // KV
    x = qkv.double().reshape(B, S, KV, G + 2, hd)
    q = x[:, :, :, :G].permute(0, 2, 3, 1, 4)
    k = x[:, :, :, G].permute(0, 2, 1, 3)[:, :, None]
    v = x[:, :, :, G + 1].permute(0, 2, 1, 3)[:, :, None]
    g = do.double().reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    sc = hd ** -0.5
    s = (q @ k.transpose(-1, -2) * sc).masked_fill(
        ~torch.ones(S, S, dtype=torch.bool, device=qkv.device).tril(),
        -math.inf)
    p = torch.softmax(s, -1)
    ds = p * (g @ v.transpose(-1, -2)
              - (g * (p @ v)).sum(-1, keepdim=True)) * sc
    dq = ds @ k
    dk = (ds.transpose(-1, -2) @ q).sum(2)
    dv = (p.transpose(-1, -2) @ g).sum(2)
    return torch.cat([dq.permute(0, 3, 1, 2, 4),
                      dk.permute(0, 2, 1, 3)[:, :, :, None],
                      dv.permute(0, 2, 1, 3)[:, :, :, None]],
                     3).reshape(B, S, W)


def f32_noise():
    sys.path.insert(0, os.getcwd())
    from neuronika_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for hd in (64, 128):
        for S, G in ((2065, 8), (2065, 4), (200, 8), (2048, 8)):
            H, KV = G, 1
            qkv = torch.randn(1, S, (H + 2) * hd, generator=gen).cuda()
            do = torch.randn(1, S, H * hd, generator=gen).cuda()
            out, lse = FA.flash_fwd_qkv(qkv, H, KV)
            split = torch.empty_like(qkv)
            FA.flash_bwd_dq_qkv(qkv, out, lse, do, split, H, KV)
            FA.flash_bwd_dkv_qkv(qkv, out, lse, do, split, H, KV)
            fused = FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV)
            ref = FA.flash_attention_qkv_bwd_reference(qkv, out, lse, do, H,
                                                       KV)
            ex = exact_backward(qkv, do, H, KV)

            def chunks(t):
                t = t.view(1, S, KV, G + 2, hd)
                return (float(t[:, :, :, :G].max()), float(t[:, :, :, G].max()),
                        float(t[:, :, :, G + 1].max()))

            line = [f"hd{hd} S{S} G{G}: max|exact| dq %.3g dk %.3g dv %.3g"
                    % chunks(ex.abs()),
                    "kernel - plain %.3g" % float((split - ref).abs().max())]
            for name, t in (("split", split), ("fused", fused),
                            ("plain", ref)):
                line.append(f"{name} - exact dq %.3g dk %.3g dv %.3g"
                            % chunks((t.double() - ex).abs()))
            print("; ".join(line), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_diag: needs a CUDA card")
    if sys.argv[1:2] == ["step"] and len(sys.argv) == 3:
        step(sys.argv[2])
    elif sys.argv[1:] == ["f32-noise"]:
        f32_noise()
    elif sys.argv[1:2] == ["headline"] and len(sys.argv) == 3:
        headline(sys.argv[2])
    elif sys.argv[1:2] == ["mistral"] and len(sys.argv) == 3:
        mistral(sys.argv[2])
    elif sys.argv[1:2] == ["kernels"] and len(sys.argv) == 3:
        kernels(sys.argv[2])
    elif sys.argv[1:2] == ["f32-fused"] and len(sys.argv) == 3:
        f32_fused(sys.argv[2])
    elif sys.argv[1:2] == ["host"] and len(sys.argv) == 3:
        host(sys.argv[2])
    elif sys.argv[1:2] == ["conv"] and len(sys.argv) == 3:
        conv(sys.argv[2])
    elif sys.argv[1:2] == ["stem"] and len(sys.argv) == 3:
        stem(sys.argv[2])
    elif sys.argv[1:2] == ["profile-window"] and len(sys.argv) == 4:
        profile_window(sys.argv[2], float(sys.argv[3]))
    elif sys.argv[1:2] == ["ce"] and len(sys.argv) == 3:
        ce(sys.argv[2])
    elif sys.argv[1:2] == ["paged"] and len(sys.argv) == 3:
        paged(sys.argv[2])
    elif sys.argv[1:2] == ["paged-g16"] and len(sys.argv) == 3:
        paged_g16(sys.argv[2])
    elif sys.argv[1:2] == ["paged-loads"] and len(sys.argv) == 3:
        paged_loads(sys.argv[2])
    elif sys.argv[1:2] == ["serve"] and len(sys.argv) == 3:
        serve(sys.argv[2])
    elif sys.argv[1:2] == ["conv3d"] and len(sys.argv) == 3:
        conv3d(sys.argv[2])
    elif sys.argv[1:2] == ["conv1d"] and len(sys.argv) == 3:
        conv1d(sys.argv[2])
    elif sys.argv[1:2] == ["resnet"] and len(sys.argv) == 3:
        resnet(sys.argv[2])
    elif sys.argv[1:2] == ["hd96"] and len(sys.argv) in (3, 4):
        hd96(*sys.argv[2:])
    elif sys.argv[1:2] == ["starcoder"] and len(sys.argv) in (3, 4):
        starcoder(*sys.argv[2:])
    elif sys.argv[1:2] == ["fused-parts"] and len(sys.argv) == 3:
        fused_parts(sys.argv[2])
    elif sys.argv[1:2] == ["fused-time"] and len(sys.argv) == 4:
        fused_time(sys.argv[2], sys.argv[3])
    elif (sys.argv[1:2] == ["tiers"] and len(sys.argv) == 4
          and sys.argv[3] in ("five", "three")):
        tiers(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
