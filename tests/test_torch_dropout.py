"""Attention dropout in the port's flash attention (neuronika_tpu_torch/
ops/flash_attention.py and csrc/dropout.cuh) on the CPU: the keep mask
`keep_mask` (Philox4x32-10 at the absolute (b, h, row, col)), its
statistics and its independence of tiling; the plain twins of the dropout
kernels against a composite attention that applies the same mask, against
finite differences, at rate 0 against the JAX kernels in interpret mode,
and in distribution against JAX's `flash_attention_dropout` (whose bits
depend on its tiles, so no bit comparison is possible); remat with
dropout. On the card, each dropout kernel against its plain twin and each
forward kernel's mask read back bit for bit. Inputs come from numpy
seeds; f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas import attention as JA
from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.ops import flash_attention as FA

FWD_TOL = 1e-5    # f32: the same math in another summation order
GRAD_TOL = 2e-5   # gradients sum up to S products of O(1) terms
M32 = np.uint64(0xFFFFFFFF)


def _philox_np(c, k0, k1):
    """Philox4x32-10 with numpy's exact uint64 products: an oracle written
    apart from the port's 16-bit limbs."""
    c = [np.asarray(x, np.uint64) for x in c]
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & M32
    return c


def _keep_np(seed, b, h, row, col, rate):
    """keep of the entries (b, h, row, col) (arrays), as csrc/dropout.cuh
    defines it, from the numpy oracle."""
    seed = int(seed) & ((1 << 64) - 1)
    row, col = np.asarray(row, np.uint64), np.asarray(col, np.uint64)
    one = np.uint64(1)
    w = _philox_np([col >> one, row >> one, h, b], seed & 0xFFFFFFFF,
                   seed >> 32)
    word = np.choose((2 * (row & one) + (col & one)).astype(np.int64), w)
    return word >= np.uint64(FA.dropout_threshold(rate))


# --------------------------------------------------------------------------
# the keep mask


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = FA.philox4x32_10(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want
    assert tuple(int(w) for w in _philox_np(ctr, *key)) == want


def test_keep_mask_matches_the_scalar_definition():
    """Random entries of a mask (B3 H5, ragged Sq, Skv, a seed above 2^32)
    equal the per-entry definition; the mask is deterministic for a seed
    and differs for another."""
    seed, rate = 2 ** 40 + 12345, 0.3
    m = FA.keep_mask(seed, 3, 5, 77, 131, rate)
    assert m.shape == (3, 5, 77, 131) and m.dtype == torch.bool
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, n, 4000) for n in m.shape]
    want = _keep_np(seed, *(i.astype(np.uint64) for i in idx), rate)
    assert np.array_equal(m.numpy()[tuple(idx)], want)
    assert torch.equal(m, FA.keep_mask(seed, 3, 5, 77, 131, rate))
    assert not torch.equal(m, FA.keep_mask(seed + 1, 3, 5, 77, 131, rate))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_4_sigma(rate):
    """Over 2^21 draws the kept fraction is 1 - rate within 4 sigma."""
    m = FA.keep_mask(7, 2, 4, 512, 512, rate)
    n = m.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(m.double().mean()) - (1 - rate)) <= 4 * sigma


@pytest.mark.parametrize("axis", ["rows", "cols", "heads", "batches",
                                  "seeds"])
def test_neighbours_are_uncorrelated(axis):
    """The correlation between the masks of neighbouring rows, cols, heads,
    batches and seeds is below 0.01 (about 7 sigma at 2^19 pairs)."""
    seed, rate = 3, 0.5
    m = FA.keep_mask(seed, 2, 4, 256, 256, rate).double()
    if axis == "rows":
        a, b = m[:, :, :-1], m[:, :, 1:]
    elif axis == "cols":
        a, b = m[..., :-1], m[..., 1:]
    elif axis == "heads":
        a, b = m[:, :-1], m[:, 1:]
    elif axis == "batches":
        a, b = m[:-1], m[1:]
    else:
        a, b = m, FA.keep_mask(seed + 1, 2, 4, 256, 256, rate).double()
    a, b = a - a.mean(), b - b.mean()
    corr = float((a * b).mean() / (a.std() * b.std()))
    assert abs(corr) < 0.01, corr


@pytest.mark.parametrize("Sq,Skv", [(64, 64), (33, 100), (1, 257)])
def test_mask_does_not_depend_on_tiling(Sq, Skv):
    """A block of rows and cols of a large mask, computed in many chunks,
    equals the mask of that block: the key is the absolute position, never
    a tile."""
    seed, rate = 99, 0.2
    big = FA.keep_mask(seed, 2, 3, 1500, 1600, rate)
    assert torch.equal(big[:, :, :Sq, :Skv],
                       FA.keep_mask(seed, 2, 3, Sq, Skv, rate))
    rows = np.arange(700, 700 + Sq, dtype=np.uint64)[:, None]
    cols = np.arange(900, 900 + Skv, dtype=np.uint64)[None, :]
    want = _keep_np(seed, 1, 2, rows, cols, rate)
    assert np.array_equal(big[1, 2, 700:700 + Sq, 900:900 + Skv].numpy(),
                          want)


def test_rate_edges():
    """Rate 0 keeps all, rate >= 1 none; the wrappers and ops refuse rates
    outside [0, 1)."""
    assert FA.keep_mask(1, 1, 2, 9, 9, 0.0).all()
    assert not FA.keep_mask(1, 1, 2, 9, 9, 1.0).any()
    assert FA.dropout_threshold(0.5) == 2 ** 31
    assert FA.dropout_threshold(1.0) == 2 ** 32 - 1
    x = torch.zeros(1, 8, 3 * 64)
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout rate"):
            FA.flash_attention_qkv(x, 1, dropout=rate, seed=1)
        with pytest.raises(ValueError, match="dropout rate"):
            FA.flash_attention_dropout(x[:, None], x[:, None], x[:, None], 1,
                                       rate=rate)


# --------------------------------------------------------------------------
# the plain twins


def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (B, S, (H + 2 * KV) * hd), dtype=np.float32))


def _heads(qkv, H, KV):
    """Packed (B, S, W) -> (B, H, S, hd) q, k, v, kv repeated over each
    group (a view that autograd follows back to qkv)."""
    B, S, W = qkv.shape
    hd = W // (H + 2 * KV)
    G = H // KV
    parts = qkv.reshape(B, S, KV, G + 2, hd)
    q = parts[:, :, :, :G].reshape(B, S, H, hd).transpose(1, 2)
    k = parts[:, :, :, G].transpose(1, 2).repeat_interleave(G, 1)
    v = parts[:, :, :, G + 1].transpose(1, 2).repeat_interleave(G, 1)
    return q, k, v


def _composite(q, k, v, causal, window, seed, rate):
    """Attention with the keep mask applied to the softmax, in f32: the
    definition the kernels and their twins implement."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5
    if causal:
        i = torch.arange(Sq)[:, None]
        j = torch.arange(Skv)[None, :]
        band = j <= i
        if window:
            band &= i - j < window
        s = s.masked_fill(~band, float("-inf"))
    w = torch.softmax(s, -1)
    keep = FA.keep_mask(seed, B, H, Sq, Skv, rate)
    w = torch.where(keep, w / (1 - rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _grad_err(fn_a, fn_b, xs):
    """Max abs difference of the grads of two scalar functions of xs, and
    of their values."""
    ga = torch.autograd.grad(fn_a(*xs), xs)
    gb = torch.autograd.grad(fn_b(*xs), xs)
    return max(float((a - b).abs().max()) for a, b in zip(ga, gb))


PACKED = {  # B, S, H, KV, hd, causal
    "mha-causal": (2, 96, 4, 4, 32, True),
    "gqa-full": (2, 64, 4, 2, 32, False),
    "gqa4-causal-ragged": (1, 77, 4, 1, 64, True),
}


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("case", list(PACKED))
def test_packed_twin_matches_composite_with_the_mask(case, rate):
    """The packed op on the CPU (K1's and K2's plain twins): forward and
    d_qkv (split and fused backward route alike) against the composite
    with `keep_mask` applied."""
    B, S, H, KV, hd, causal = PACKED[case]
    seed = 2 ** 35 + 17
    qkv = _qkv(B, S, H, KV, hd).requires_grad_()
    out = FA.flash_attention_qkv(qkv, H, KV, causal, dropout=rate, seed=seed)
    ref = _composite(*_heads(qkv, H, KV), causal, 0, seed, rate)
    ref = ref.transpose(1, 2).reshape(B, S, H * hd)
    assert float((out - ref).detach().abs().max()) <= FWD_TOL
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape, dtype=np.float32))
    err = _grad_err(
        lambda x: (FA.flash_attention_qkv(x, H, KV, causal, dropout=rate,
                                          seed=seed) * do).sum(),
        lambda x: (_composite(*_heads(x, H, KV), causal, 0, seed, rate)
                   .transpose(1, 2).reshape(B, S, H * hd) * do).sum(),
        (qkv,))
    assert err <= GRAD_TOL


SPLIT = {  # B, H, Sq, Skv, hd, causal, window
    "causal": (2, 3, 80, 80, 32, True, 0),
    "window": (1, 4, 100, 100, 32, True, 17),
    "full-Sq-ne-Skv": (2, 2, 40, 75, 64, False, 0),
}


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("case", list(SPLIT))
def test_split_twin_matches_composite_with_the_mask(case, rate):
    """`flash_attention_dropout` on the CPU (K5-K7's plain twins): forward
    and dq, dk, dv against the composite with `keep_mask` applied."""
    B, H, Sq, Skv, hd, causal, window = SPLIT[case]
    seed = 31337
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, n, hd), dtype=np.float32)) for n in (Sq, Skv, Skv, Sq))
    xs = tuple(t.requires_grad_() for t in (q, k, v))
    out = FA.flash_attention_dropout(*xs, seed, causal, rate=rate,
                                     window=window)
    ref = _composite(*xs, causal, window, seed, rate)
    assert float((out - ref).detach().abs().max()) <= FWD_TOL
    err = _grad_err(
        lambda *a: (FA.flash_attention_dropout(*a, seed, causal, rate=rate,
                                               window=window) * do).sum(),
        lambda *a: (_composite(*a, causal, window, seed, rate) * do).sum(),
        xs)
    assert err <= GRAD_TOL


@pytest.mark.parametrize("op", ["packed", "split"])
def test_dropout_functions_match_finite_differences(op):
    """Both autograd Functions with dropout against central differences
    along random directions (JAX's test_flash_dropout_custom_vjp_matches_fd,
    atol/rtol 2e-2): the backward regenerates the forward's mask."""
    rng = np.random.default_rng(3)
    if op == "packed":
        xs = (_qkv(1, 64, 2, 1, 32, seed=4),)

        def f(x):
            return FA.flash_attention_qkv(x, 2, 1, True, dropout=0.3,
                                          seed=42).sum()
    else:
        xs = tuple(torch.from_numpy(rng.standard_normal(
            (1, 1, 64, 32), dtype=np.float32)) for _ in range(3))

        def f(q, k, v):
            return FA.flash_attention_dropout(q, k, v, 42, True,
                                              rate=0.3).sum()
    xs = tuple(x.requires_grad_() for x in xs)
    grads = torch.autograd.grad(f(*xs), xs)
    eps = 1e-2
    for _ in range(3):
        ts = [torch.from_numpy(rng.standard_normal(x.shape,
                                                   dtype=np.float32))
              for x in xs]
        with torch.no_grad():
            plus = f(*(x + eps * t for x, t in zip(xs, ts)))
            minus = f(*(x - eps * t for x, t in zip(xs, ts)))
        fd = float(plus - minus) / (2 * eps)
        an = sum(float((g * t).sum()) for g, t in zip(grads, ts))
        assert abs(fd - an) <= 2e-2 + 2e-2 * abs(an), (fd, an)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_rate_zero_is_the_no_dropout_path_and_jax(causal):
    """At rate 0 the dropout entry points are the plain path bit for bit,
    and agree with JAX's kernels in interpret mode: the packed op with
    JAX's `flash_attention_qkv(..., dropout=0)`, `flash_attention_dropout`
    with JAX's `flash_attention`."""
    qkv = _qkv(2, 128, 4, 2, 32, seed=5)
    a = FA.flash_attention_qkv(qkv, 4, 2, causal, dropout=0.0, seed=9)
    assert torch.equal(a, FA.flash_attention_qkv(qkv, 4, 2, causal))
    ja = JA.flash_attention_qkv(jnp.asarray(qkv.numpy()), None, 4, 2, causal,
                                None, 64, 64, True, 0.0)
    assert float(np.abs(a.numpy() - np.asarray(ja)).max()) <= FWD_TOL
    q, k, v = (t.contiguous() for t in _heads(qkv, 4, 2))
    b = FA.flash_attention_dropout(q, k, v, 9, causal, rate=0.0)
    assert torch.equal(b, FA.flash_attention(q, k, v, causal))
    jb = JA.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            causal, None, 64, 64, True)
    assert float(np.abs(b.numpy() - np.asarray(jb)).max()) <= FWD_TOL


def test_unbiased_in_distribution_like_jax():
    """The mean over 32 seeds of the dropout output lies within rel 0.25 of
    plain attention, for the port and for JAX's flash_attention_dropout
    in interpret mode at rate 0.3 (JAX's own bound, tests/test_pallas.py):
    the two agree in distribution, their bits cannot."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    plain = FA.flash_attention(tq, tk, tv, True).numpy()
    port = np.mean([FA.flash_attention_dropout(tq, tk, tv, 13 * i + 1, True,
                                               rate=0.3).numpy()
                    for i in range(32)], 0)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    jfn = jax.jit(lambda s: JA.flash_attention_dropout(
        jq, jk, jv, s, True, None, 64, 64, True, 0.3))
    jx = np.mean([np.asarray(jfn(jnp.float32(13 * i + 1)))
                  for i in range(32)], 0)
    for got in (port, jx):
        rel = float(np.abs(got - plain).mean() / np.abs(plain).mean())
        assert rel < 0.25, rel


@pytest.mark.parametrize("path", ["packed", "split-window"])
def test_remat_with_dropout_gives_the_same_gradients(path):
    """A checkpointed block re-runs the flash forward with its layer's seed,
    so it redraws the same mask: f32 gradients with remat equal those
    without."""
    kw = dict(vocab_size=64, n_layer=2, n_head=2, d_model=64, d_ff=128,
              max_seq=32, dropout=0.3, dtype=torch.float32)
    if path == "split-window":
        kw.update(pos_emb="rope", window=8)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 64, (2, 32)))
    tp = TT.init_params(torch.Generator().manual_seed(0),
                        TT.GPTConfig(**kw), "cpu")

    def grads(remat):
        cfg = TT.GPTConfig(remat=remat, **kw)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        loss = TT.loss_fn(tree_unflatten(tp, leaves), toks, toks.roll(-1, 1),
                          cfg, train=True,
                          generator=torch.Generator().manual_seed(5))
        return loss, torch.autograd.grad(loss, leaves)

    (la, ga), (lb, gb) = grads(False), grads(True)
    assert float(la.detach()) == float(lb.detach())
    assert max(float((a - b).abs().max()) for a, b in zip(ga, gb)) <= 1e-6


@pytest.mark.parametrize("flash_bwd", ["split", "fused"])
def test_flash_and_composite_routes_drop_alike(flash_bwd):
    """flash="on" (the plain twins on the CPU) and flash="off" (the
    composite) draw the same mask from each layer's seed: loss and
    gradients agree, as phase 7 of chip_smoke.py holds the kernel route on
    the card."""
    kw = dict(vocab_size=64, n_layer=2, n_head=2, d_model=64, d_ff=128,
              max_seq=32, dropout=0.3, dtype=torch.float32, remat=False,
              flash_bwd=flash_bwd)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 64, (2, 32)))
    tp = TT.init_params(torch.Generator().manual_seed(1),
                        TT.GPTConfig(**kw), "cpu")

    def run(flash):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        loss = TT.loss_fn(tree_unflatten(tp, leaves), toks, toks.roll(-1, 1),
                          TT.GPTConfig(flash=flash, **kw), train=True,
                          generator=torch.Generator().manual_seed(3))
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    (la, ga), (lb, gb) = run("on"), run("off")
    assert abs(la - lb) <= FWD_TOL
    assert max(float((a - b).abs().max()) for a, b in zip(ga, gb)) <= GRAD_TOL


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [64, 128])
def test_packed_dropout_kernels_match_twins_on_gpu(cuda, hd, causal, dtype):
    """K1, K2a, K2b and the fused K2 with dropout against their plain twins
    (GQA, ragged S), at the bounds of chip_smoke.py's check_flash."""
    import chip_smoke as cs

    for rate, seed in ((0.1, 11), (0.5, 2 ** 40 + 3)):
        qkv, do = cs.flash_case(np.random.default_rng(0), 2, 8, 2, hd, 200,
                                dtype)
        cs.check_flash(FA, f"test/{hd}/{causal}/{rate}", qkv, do, 8, 2,
                       causal, False, seed=seed, rate=rate)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(2, 4, 300, 300, True, 77),
                                  (2, 4, 130, 300, False, 0)],
                         ids=["window", "full-Sq-ne-Skv"])
def test_split_dropout_kernels_match_twins_on_gpu(cuda, case, dtype):
    """K5, K6 and K7 with dropout against their plain twins."""
    import chip_smoke as cs

    B, H, Sq, Skv, causal, window = case
    g = torch.Generator(device="cuda").manual_seed(0)
    for hd in (64, 128):
        q, k, v, do = cs.split_case(g, B, H, Sq, Skv, hd, dtype)
        cs.check_split(FA, f"test/{hd}/{case}", q, k, v, do, causal, window,
                       seed=5, rate=0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_forward_kernels_draw_keep_mask_bit_for_bit_on_gpu(cuda, hd, dtype):
    """The one-hot readout of chip_smoke.py: K1's and K5's masks equal
    `keep_mask` in every entry."""
    import chip_smoke as cs

    assert cs.readout_masks(FA, dtype, hd, 0.3, 2 ** 63 + 5) > 0
