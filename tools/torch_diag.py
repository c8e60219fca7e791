"""Six measurements of the PyTorch/CUDA port that chip_smoke.py does not
make, run on one CUDA card from the root of a checkout:

    python3 tools/torch_diag.py step TREE_ROOT
        the GPTConfig defaults train step (split flash backward; d1536 L8
        H12 V16384 S2048 B16 bf16, 1 warm-up and 4 timed steps) and the Var
        2-d model's step (chip_smoke.py phase 9) of the checkout at
        TREE_ROOT, with that checkout's own package and chip_smoke.py; run
        it for two checkouts in turns (A, B, B, A) on one card to
        compare them;
    python3 tools/torch_diag.py mistral TREE_ROOT
        the same for chip_smoke.py phase 11's step: Mistral 7B's widths at
        L4, S8192 B2 bf16, window 4096 (1 warm-up and 4 timed steps);
    python3 tools/torch_diag.py kernels TREE_ROOT
        CUDA-event times of the checkout's flash kernels: K5, K6 and K7 at
        bf16 B1 H8 and B2 H32 S8192 hd128 window 4096 (chip_smoke.py phase
        3's shapes; SDPA's band-masked backward beside them at B1 H8), and
        K1, K2a (with its own pre-pass), K2b, the split pair and the fused
        K2 at the headline (bf16 B16 S2048 H12 hd128 causal, fast softmax);
        the best of two runs of 5 launches each, as phase 3 times them;
    python3 tools/torch_diag.py f32-noise
        the f32 packed-qkv flash backward (K2a + K2b, the fused K2) and its
        plain version against an exact f64 backward, per chunk (dq, dk,
        dv), causal, at S 2065 / 2048 / 200 and G 8 / 4: how far each side
        sits from the exact result;
    python3 tools/torch_diag.py f32-fused TREE_ROOT
        CUDA-event time of the f32 fused flash backward (the kernel that
        phases 7 and 10 of chip_smoke.py run) of the checkout at TREE_ROOT,
        at B4 S2048 H12 hd128 causal, beside its bound (FFMA's 67 TFLOP/s);
    python3 tools/torch_diag.py host TREE_ROOT
        the host's time for one K3 call (`ops.matmul.matmul`) of the
        checkout at TREE_ROOT at three of phase 9's f32 products: 200 calls
        issued back to back (fewer launches than the card's queue holds),
        in all and with the kernel library replaced by a stub that launches
        nothing (the Python wrapper alone), beside the CUDA-event time.
"""

import math
import os
import sys

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
                ("flash_bwd_dq", lambda: FA.flash_bwd_dq(
                    q, k, v, do, lse, delta, window=W)),
                ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(
                    q, k, v, do, lse, delta, window=W))):
            ms = best(fn)
            bound, flops = cs.split_bound(name, B, H, S, hd, True, W)
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
        ("flash_bwd_dq_qkv", lambda: FA.flash_bwd_dq_qkv(
            qkv, out, lse, do, d_qkv, H)),
        ("flash_bwd_dkv_qkv", lambda: FA.flash_bwd_dkv_qkv(
            qkv, out, lse, do, d_qkv, H)),
        ("split pair", pair),
        ("flash_bwd_fused_qkv", lambda: FA.flash_bwd_fused_qkv(
            qkv, out, lse, do, H)))]
    print(f"{root}: bf16 B{B} S{S} H{H} hd{hd} causal fast: "
          + "; ".join(line), flush=True)


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
    import time

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from neuronika_tpu_torch import _build
    from neuronika_tpu_torch.ops import matmul as MM

    lib = _build.load_library()

    class Stub:
        def __getattr__(self, name):
            return lambda *args: 0

    def issue_us(a, b, n=200):
        for _ in range(20):
            MM.matmul(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            MM.matmul(a, b)
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    x = torch.randn(1024, 768, device="cuda")
    w = torch.randn(768, 768, device="cuda")
    p = torch.randn(1024, 1024, device="cuda")
    v = torch.randn(1024, 768, device="cuda")
    for name, a, b in (("proj x @ w (1024, 768) @ (768, 768)", x, w),
                       ("pv p @ v_h (1024, 1024) @ (1024, 128)", p,
                        v[:, :128]),
                       ("scores q_h @ k_h.t() (1024, 128) @ (128, 1024)",
                        x[:, :128], v[:, :128].t())):
        full = issue_us(a, b)
        dev = cs.cuda_ms(lambda: MM.matmul(a, b), 50) * 1e3
        _build.load_library = lambda: Stub()
        wrapper = issue_us(a, b)
        _build.load_library = lambda: lib
        print(f"{root}: {name}: host {full:.1f} us a call ({wrapper:.1f} in "
              f"the Python wrapper), {dev:.1f} us a call by CUDA events",
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
    elif sys.argv[1:2] == ["mistral"] and len(sys.argv) == 3:
        mistral(sys.argv[2])
    elif sys.argv[1:2] == ["kernels"] and len(sys.argv) == 3:
        kernels(sys.argv[2])
    elif sys.argv[1:2] == ["f32-fused"] and len(sys.argv) == 3:
        f32_fused(sys.argv[2])
    elif sys.argv[1:2] == ["host"] and len(sys.argv) == 3:
        host(sys.argv[2])
    else:
        sys.exit(__doc__)
