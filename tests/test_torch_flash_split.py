"""The port's split-layout flash attention (neuronika_tpu_torch/ops/
flash_attention.py: K5, K6, K7 and the `flash_attention` op) against the
JAX package: the plain forward and backward against JAX's Pallas kernels
`_fwd_call` / `_bwd_call` run in interpret mode (as tests/test_pallas.py
runs them on the CPU), the op against JAX's `flash_attention` custom VJP
under `jax.vjp` and against the composite `reference_attention`; on the
card, each CUDA kernel against its plain version. Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas import attention as JA
from neuronika_tpu_torch.ops import flash_attention as FA

# f32: the same exp2-domain math in another summation order
TOL = 2e-5
# JAX's tiles (they must divide S there; the port's kernels need not)
BLOCK = 16

# (id, Sq, Skv, causal, window): the causal band, windows that cut tiles
# anywhere (1, 6 and 17 against 16-row tiles) or cover all of S, and full
# cross attention with Sq != Skv
CASES = [("causal", 64, 64, True, 0), ("window1", 64, 64, True, 1),
         ("window6", 64, 64, True, 6), ("window17", 64, 64, True, 17),
         ("window-ge-S", 64, 64, True, 100),
         ("full-Sq32-Skv48", 32, 48, False, 0)]
IDS = [c[0] for c in CASES]


def _inputs(Sq, Skv, B=1, H=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((B, H, Skv, hd), dtype=np.float32)
    v = rng.standard_normal((B, H, Skv, hd), dtype=np.float32)
    do = rng.standard_normal((B, H, Sq, hd), dtype=np.float32)
    return q, k, v, do


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for a in arrays]


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _jax_fwd(q, k, v, causal, window):
    sc = q.shape[-1] ** -0.5
    return JA._fwd_call(*map(jnp.asarray, (q, k, v)), sc, causal, BLOCK,
                        BLOCK, True, window=window)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_jax_kernel(case):
    """K5: out and the base-2 lse (JAX's first lse lane)."""
    _, Sq, Skv, causal, window = case
    q, k, v, _ = _inputs(Sq, Skv)
    out, lse = FA.flash_attention_fwd_reference(*_t(q, k, v), causal,
                                                window=window)
    jout, jlse = _jax_fwd(q, k, v, causal, window)
    assert out.shape == (1, 2, Sq, 32) and lse.shape == (1, 2, Sq)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert _err(out, jout) <= TOL
    assert _err(lse, np.asarray(jlse)[..., 0]) <= TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_kernels(case):
    """K6 and K7 from the same out, lse and dO on both sides; the port
    takes delta = rowsum(dO.O) as an input, JAX's wrapper computes it."""
    _, Sq, Skv, causal, window = case
    q, k, v, do = _inputs(Sq, Skv, seed=1)
    jout, jlse = _jax_fwd(q, k, v, causal, window)
    want = JA._bwd_call(*map(jnp.asarray, (q, k, v)), jout, jlse,
                        jnp.asarray(do), q.shape[-1] ** -0.5, causal, BLOCK,
                        BLOCK, True, window=window)
    out, lse = np.asarray(jout), np.asarray(jlse)[..., 0]
    delta = (do * out).sum(-1)
    got = FA.flash_attention_bwd_reference(*_t(q, k, v, do, lse, delta),
                                           causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _err(a, b) <= TOL, name


def _port_vjp(q, k, v, do, causal, window, fn=FA.flash_attention):
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = fn(qt, kt, vt, causal, window=window)
    out.backward(torch.from_numpy(do).to(out.dtype))
    return out, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_matches_jax_custom_vjp(case):
    """The differentiable op (plain K5, then K6/K7 on the CPU) against
    JAX's `flash_attention` under `jax.vjp`, its kernels in interpret
    mode: the output and all three gradients."""
    _, Sq, Skv, causal, window = case
    q, k, v, do = _inputs(Sq, Skv, seed=2)
    jout, vjp = jax.vjp(
        lambda a, b, c: JA.flash_attention(a, b, c, causal, None, BLOCK,
                                           BLOCK, True, window),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    out, *grads = _port_vjp(q, k, v, do, causal, window)
    assert _err(out, jout) <= TOL
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert _err(a, b) <= TOL, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_autograd_matches_reference_attention(case):
    """The op against autograd through the composite oracle, and that
    oracle against JAX's `reference_attention` where it is defined
    (JAX's composite takes no window)."""
    _, Sq, Skv, causal, window = case
    q, k, v, do = _inputs(Sq, Skv, seed=3)
    ours = _port_vjp(q, k, v, do, causal, window)
    ref = _port_vjp(q, k, v, do, causal, window, FA.reference_attention)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        assert _err(a, b.detach().numpy()) <= TOL, name
    if not window:
        want = JA.reference_attention(*map(jnp.asarray, (q, k, v)), causal)
        assert _err(ref[0], want) <= TOL


# bf16 inputs against the f32 oracle on the same (rounded) inputs. Each
# side rounds p (and ds) to bf16 before a product and the result once;
# each rounding is within 2^-8 relative, so each entry of the output is
# within 2^-6 of max |v| and of a gradient within 2^-5 of its largest
# entry (dq and dk share dv's scale, and with window 1 they are rounding
# noise around 0). Those bounds sit near a typical entry, so each tensor
# is also held in norm to the values compared: ||a - b|| <= BF16_REL ||b||
# + BF16_FLOOR sqrt(numel), the rule chip_smoke.py holds K5-K7 to. Here
# the plain versions read at most 2.9e-3 of ||b||; the floor is for
# window 1's dq and dk (f32 noise of ~1e-7 an entry).
BF16_OUT, BF16_GRAD = 2 ** -6, 2 ** -5
BF16_REL, BF16_FLOOR = 1e-2, 2 ** -15


def _within_norm(a, b):
    a = a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = b.detach().float().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float32)
    return (np.linalg.norm(a - b)
            <= BF16_REL * np.linalg.norm(b) + BF16_FLOOR * np.sqrt(b.size))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_plain_versions_within_bound_of_f32_oracle(case):
    _, Sq, Skv, causal, window = case
    q, k, v, do = (a.astype(jnp.bfloat16).astype(np.float32)
                   for a in _inputs(Sq, Skv, seed=4))
    jout, jlse = _jax_fwd(q, k, v, causal, window)
    want = JA._bwd_call(*map(jnp.asarray, (q, k, v)), jout, jlse,
                        jnp.asarray(do), q.shape[-1] ** -0.5, causal, BLOCK,
                        BLOCK, True, window=window)
    qb, kb, vb, dob = _t(q, k, v, do, dtype=torch.bfloat16)
    out, lse = FA.flash_attention_fwd_reference(qb, kb, vb, causal,
                                                window=window)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _err(out, jout) <= BF16_OUT * np.abs(v).max()
    assert _within_norm(out, jout)
    delta = (dob.float() * out.float()).sum(-1)
    got = FA.flash_attention_bwd_reference(qb, kb, vb, dob, lse, delta,
                                           causal, window=window)
    top = max(float(np.abs(np.asarray(b)).max()) for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        assert _err(a, b) <= BF16_GRAD * top, name
        assert _within_norm(a, b), name


def test_refusals_match_jax():
    """causal needs Sq == Skv and a window needs causal, on both sides;
    the port refuses before any work."""
    q, k, v, _ = _inputs(32, 48)
    for causal, window, match in ((True, 0, "matching"),
                                  (False, 4, "window")):
        kv = (k, v) if causal else (q, q)
        with pytest.raises(ValueError, match=match):
            JA._fwd_call(*map(jnp.asarray, (q, *kv)), 1.0, causal, BLOCK,
                         BLOCK, True, window=window)
        with pytest.raises(ValueError, match=match):
            FA.flash_attention(*_t(q, *kv), causal, window=window)


def _mistral_operands(preset, dtype, B=2, S=48):
    """q, k, v as the model hands them to `flash_attention`: `_split_qkv`
    of a random packed projection, then rope on q and k."""
    from neuronika_tpu_torch.models import transformer as T

    cfg = preset(vocab_size=64, n_layer=1, n_head=32, n_kv_head=8,
                 d_model=4096, d_ff=64, max_seq=S, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, S, T._qkv_width(cfg), generator=g).to(dtype)
    q, k, v = T._split_qkv(qkv, cfg, B, S)
    if cfg.pos_emb == "rope":
        cos, sin = T._rope_cos_sin(cfg, torch.arange(S))
        q, k = T._apply_rope(q, cos, sin), T._apply_rope(k, cos, sin)
    return cfg, (q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("preset", ["mistral", "learned-window-mha"])
def test_model_operands_pass_aligned_unchanged(preset, dtype):
    """At Mistral's head geometry (H32 KV8 hd128; rope, GQA repeated) and
    with the q, k, v views of the packed projection that a learned-position
    windowed model hands over (H32 KV32: head stride 3 hd), every operand
    of the split flash op passes `_aligned` as itself: the kernels (the
    bf16 backward's TMA maps included) read it with no copy."""
    from neuronika_tpu_torch.models import transformer as T

    if preset == "mistral":
        cfg, ops = _mistral_operands(T.mistral_config, dtype)
        assert (cfg.n_head, cfg.n_kv_head, cfg.window) == (32, 8, 4096)
    else:
        cfg = T.GPTConfig(vocab_size=64, n_layer=1, n_head=32,
                          d_model=4096, d_ff=64, max_seq=48, window=16,
                          dtype=dtype)
        qkv = torch.randn(2, 48, T._qkv_width(cfg)).to(dtype)
        ops = T._split_qkv(qkv, cfg, 2, 48)
        assert not ops[0].is_contiguous()
    for t in ops:
        assert t.shape == (2, 32, 48, 128)
        assert FA._aligned(t) is t


def test_aligned_copies_what_a_map_cannot_step():
    """A stride 0 on an axis longer than 1 (an expanded gradient) or a
    stride that is not a multiple of 16 bytes gets a contiguous copy; a
    stride 0 on an axis of length 1 is kept."""
    base = torch.randn(1, 1, 8, 64, dtype=torch.bfloat16)
    for t in (base.expand(2, 3, 8, 64),
              torch.randn(2, 1, 8, 68, dtype=torch.bfloat16)[..., :64]):
        c = FA._aligned(t)
        assert c is not t and c.is_contiguous() and torch.equal(c, t)
    one = base.as_strided((1, 1, 8, 64), (0, 0, 64, 1))
    assert FA._aligned(one) is one


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = _t(*_inputs(16, 16))
    before = [f.launches for f in FA.SPLIT_KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd(q, k, v)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_bwd_dkv(q, k, v, do, lse, lse)
    assert [f.launches for f in FA.SPLIT_KERNELS] == before


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


# (id, B, H, Sq, Skv, causal, window): the band against 64-row tiles
# (windows 1, 6, 65, 100, >= S), ragged S, Sq != Skv; then the bf16 K6/K7
# geometry of 64-row steps and 128-row CTAs: windows on either side of one
# step or one CTA (63, 64, 65, 127, 128, 129), ragged S below a CTA's rows
# with a window below 128, and full attention ragged on both sides
GPU_CASES = [("causal", 2, 3, 256, 256, True, 0),
             ("window1", 2, 3, 256, 256, True, 1),
             ("window6", 2, 3, 256, 256, True, 6),
             ("window65", 2, 3, 256, 256, True, 65),
             ("window100-ragged", 1, 2, 1000, 1000, True, 100),
             ("window-ge-S", 1, 2, 200, 200, True, 300),
             ("full-Sq200-Skv333", 2, 2, 200, 333, False, 0),
             *((f"window{w}-S384", 1, 2, 384, 384, True, w)
               for w in (63, 64, 65, 127, 128, 129)),
             ("window100-S129", 2, 2, 129, 129, True, 100),
             ("window37-S1000", 1, 2, 1000, 1000, True, 37),
             ("full-Sq130-Skv1000", 2, 2, 130, 1000, False, 0)]
# f32: the same math in another summation order; bf16: each entry within
# BF16_OUT of max |v| (out) or BF16_GRAD of the largest gradient entry,
# rounding points that may flip by one ulp on either side, and each
# tensor in norm as above
GPU_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_OUT,
                                                         BF16_GRAD)}


# the bands of both test tables (S <= 1000), for the host's mirror of the
# bf16 K6/K7 walk (runs on the CPU)
WALK_CASES = ([(f"cpu-{c[0]}",) + c[1:5] for c in CASES]
              + [(f"gpu-{c[0]}",) + c[3:7] for c in GPU_CASES])


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_split_walk_visits_every_band_pair_once(case):
    """`split_walk` (the bf16 K6/K7 walk over 128-row CTAs and 64-row
    steps, as csrc/flash_sm90.cuh runs it) covers each in-band (q, k) pair
    of a band exactly once, for dq (over q tiles) and for dk/dv (over k
    tiles), and visits no step that holds none."""
    _, Sq, Skv, causal, window = case
    rows = np.arange(Sq)[:, None]
    cols = np.arange(Skv)[None, :]
    band = np.ones((Sq, Skv), bool)
    if causal:
        band = (cols <= rows) & ((rows - cols < window) if window else True)
    walk = FA.split_walk(Sq, Skv, causal, window)
    for name, steps in walk.items():
        seen = np.zeros((Sq, Skv), np.int32)
        for i0, ni, j0, nj in steps:
            seen[i0:i0 + ni, j0:j0 + nj] += 1
            assert band[i0:i0 + ni, j0:j0 + nj].any(), (name, i0, j0)
        assert (seen[band] == 1).all(), name
        assert seen.max() == 1, name


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_fwd_walk_visits_every_band_pair_once(case):
    """`fwd_walk` (the bf16 K5 walk: 128-row k tiles a 128-row CTA, each
    warpgroup's 64 rows skipping the tiles that hold none of their keys,
    as csrc/flash_sm90.cuh runs it) covers each in-band (q, k) pair of a
    band exactly once and visits no step that holds none."""
    _, Sq, Skv, causal, window = case
    rows = np.arange(Sq)[:, None]
    cols = np.arange(Skv)[None, :]
    band = np.ones((Sq, Skv), bool)
    if causal:
        band = (cols <= rows) & ((rows - cols < window) if window else True)
    seen = np.zeros((Sq, Skv), np.int32)
    for i0, ni, j0, nj in FA.fwd_walk(Sq, Skv, causal, window):
        assert (ni, nj) == (64, 128)
        seen[i0:i0 + ni, j0:j0 + nj] += 1
        assert band[i0:i0 + ni, j0:j0 + nj].any(), (i0, j0)
    assert (seen[band] == 1).all()
    assert seen.max() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_kernels_match_plain_versions_on_gpu(cuda, case, dtype, hd):
    """K5, K6 and K7 against their plain versions on the same inputs;
    q, k and v are strided views (every other head of a wider tensor)."""
    _, B, H, Sq, Skv, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(0)

    def rand(S):
        return torch.randn(B, 2 * H, S, hd, generator=g, device=cuda,
                           dtype=torch.float32).to(dtype)[:, ::2]

    q, k, v, do = rand(Sq), rand(Skv), rand(Skv), rand(Sq)
    assert not q.is_contiguous()
    before = [f.launches for f in FA.SPLIT_KERNELS]
    out, lse = FA.flash_fwd(q, k, v, causal, window=window)
    rout, rlse = FA.flash_attention_fwd_reference(q, k, v, causal,
                                                  window=window)
    delta = (do.float() * rout.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, rlse, delta, causal, window=window)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, rlse, delta, causal,
                              window=window)
    want = FA.flash_attention_bwd_reference(q, k, v, do, rlse, delta, causal,
                                            window=window)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(FA.SPLIT_KERNELS, before)] \
        == [1, 1, 1]
    o_tol, g_tol = GPU_TOL[dtype]
    bf16 = dtype == torch.bfloat16
    if bf16:
        o_tol *= float(v.float().abs().max())
    assert out.dtype == dtype and out.shape == rout.shape
    assert float((out.float() - rout.float()).abs().max()) <= o_tol
    assert not bf16 or _within_norm(out, rout)
    assert float((lse - rlse).abs().max()) <= (
        1e-5 if dtype == torch.float32 else 1e-3)
    top = max(float(b.float().abs().max()) for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        bound = g_tol * (max(1.0, top) if dtype == torch.float32 else top)
        assert a.dtype == dtype and a.shape == b.shape, name
        assert float((a.float() - b.float()).abs().max()) <= bound, name
        assert not bf16 or _within_norm(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_read_views_of_a_packed_projection_on_gpu(cuda, dtype):
    """K5, K6 and K7 on q, k, v that are views of one packed (B, S, W)
    tensor, as `_split_qkv` makes them without GQA (head stride 3 hd, row
    stride W): the bf16 backward's 4-d TMA maps step over heads that are
    not dense. Held as test_kernels_match_plain_versions_on_gpu holds
    them."""
    B, H, S, hd, window = 2, 4, 300, 128, 100
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(B, S, H, 3, hd, generator=g, device=cuda).to(dtype)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(B, H, S, hd, generator=g, device=cuda).to(dtype)
    assert q.stride() == (S * 3 * H * hd, 3 * hd, 3 * H * hd, 1)
    assert all(FA._aligned(t) is t for t in (q, k, v))
    out, lse = FA.flash_fwd(q, k, v, True, window=window)
    rout, rlse = FA.flash_attention_fwd_reference(q, k, v, True,
                                                  window=window)
    delta = (do.float() * rout.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, rlse, delta, True, window=window)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, rlse, delta, True, window=window)
    want = FA.flash_attention_bwd_reference(q, k, v, do, rlse, delta, True,
                                            window=window)
    torch.cuda.synchronize()
    o_tol, g_tol = GPU_TOL[dtype]
    bf16 = dtype == torch.bfloat16
    if bf16:
        o_tol *= float(v.float().abs().max())
    assert float((out.float() - rout.float()).abs().max()) <= o_tol
    top = max(float(b.float().abs().max()) for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        bound = g_tol * (max(1.0, top) if not bf16 else top)
        assert float((a.float() - b.float()).abs().max()) <= bound, name
        assert not bf16 or _within_norm(a, b), name


@pytest.mark.cuda
def test_backward_kernels_are_bit_identical_across_runs_on_gpu(cuda):
    """Each CTA of K6 and K7 owns its output rows (no atomics): two
    launches on the same inputs give the same bits (bf16 B2 H4 S1000,
    window 100, hd 128)."""
    B, H, S, hd, window = 2, 4, 1000, 128, 100
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(B, H, S, hd, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    _, lse = FA.flash_attention_fwd_reference(q, k, v, True, window=window)
    delta = torch.randn(B, H, S, generator=g, device=cuda)
    runs = [(FA.flash_bwd_dq(q, k, v, do, lse, delta, True, window=window),
             *FA.flash_bwd_dkv(q, k, v, do, lse, delta, True, window=window))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["plain", "dropout"])
def test_forward_kernel_is_bit_identical_across_runs_on_gpu(cuda, rate):
    """Each CTA of the bf16 K5 owns its q rows: two launches on the same
    inputs give the same out and lse bits (B2 H4 S1000, window 100, hd
    128), with and without dropout."""
    B, H, S, hd, window = 2, 4, 1000, 128, 100
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(B, H, S, hd, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    runs = [FA.flash_fwd(q, k, v, True, window=window, seed=7, rate=rate)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_op_routes_cuda_tensors_to_the_kernels(cuda):
    """The op on the card: K5 once, K6 and K7 once each, and the same
    output and gradients as on the CPU (f32, hd 128, window 6)."""
    q, k, v, do = _inputs(100, 100, B=2, H=2, hd=128, seed=5)
    before = [f.launches for f in FA.SPLIT_KERNELS]
    dev = [t.to(cuda).requires_grad_() for t in _t(q, k, v)]
    out = FA.flash_attention(*dev, True, window=6)
    out.backward(torch.from_numpy(do).to(cuda))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(FA.SPLIT_KERNELS, before)] \
        == [1, 1, 1]
    cpu = _port_vjp(q, k, v, do, True, 6)
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          (out, *(t.grad for t in dev)), cpu):
        assert _err(a.cpu(), b.detach().numpy()) <= TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(320, torch.float32),
                                      (128, torch.float16)],
                         ids=["hd320", "f16"])
def test_shapes_the_kernels_cannot_take_are_refused(cuda, hd, dtype):
    q = torch.zeros(1, 2, 16, hd, device=cuda, dtype=dtype)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention(q, q, q)
