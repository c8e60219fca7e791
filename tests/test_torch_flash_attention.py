"""The port's packed-qkv flash attention (neuronika_tpu_torch/ops/
flash_attention.py) against the JAX package: the plain forward and
backward against JAX's Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them on the CPU) and against the composite
`reference_attention`; on the card, each CUDA kernel against its plain
version. Inputs come from numpy seeds; f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas import attention as JA
from neuronika_tpu_torch.ops import flash_attention as FA

# f32: the same exp2-domain math in another summation order
FWD_TOL = 1e-5
BWD_TOL = 2e-5     # d_qkv sums S products of O(1) terms per element


def _qkv(B=2, S=256, H=4, KV=4, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, (H + 2 * KV) * hd), dtype=np.float32)


def _do(B, S, H, hd, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, H * hd), dtype=np.float32)


def _err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def _jax_fwd(qkv, H, KV, causal, fast=False, block=128):
    sc = 1.0 / (qkv.shape[-1] // (H + 2 * KV)) ** 0.5
    out, lse = JA._fwd_call_qkv(jnp.asarray(qkv), H, KV, sc, causal, block,
                                block, True, 0.0, None, fast)
    return out, lse


def _unpack_bhsd(qkv, H, KV):
    """numpy packed (B, S, W) -> (B, H, S, hd) q, k, v with kv repeated
    over each group (the layout convention of tests/test_pallas.py)."""
    B, S, W = qkv.shape
    hd = W // (H + 2 * KV)
    G = H // KV
    parts = qkv.reshape(B, S, KV, G + 2, hd)
    q = parts[:, :, :, :G].reshape(B, S, H, hd).transpose(0, 2, 1, 3)
    k = np.repeat(parts[:, :, :, G].transpose(0, 2, 1, 3), G, axis=1)
    v = np.repeat(parts[:, :, :, G + 1].transpose(0, 2, 1, 3), G, axis=1)
    return q, k, v


@pytest.mark.parametrize("fast", [False, True], ids=["safe", "fast"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_plain_forward_matches_jax_kernel(kv, causal, fast):
    H, hd = 4, 64
    qkv = _qkv(KV=kv)
    out, lse = FA.flash_attention_qkv_fwd_reference(
        torch.from_numpy(qkv), H, kv, causal, fast_softmax=fast)
    jout, jlse = _jax_fwd(qkv, H, kv, causal, fast)
    assert out.shape == (2, 256, H * hd) and lse.shape == (2, H, 256)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert _err(out, jout) <= FWD_TOL
    assert _err(lse, np.asarray(jlse)[..., 0]) <= FWD_TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_plain_forward_matches_reference_attention(kv, causal):
    """The packed-layout convention (tests/test_pallas.py:339): the packed
    forward equals reference attention on the unpacked heads, kv head g
    repeated over q heads gG .. gG+G-1; JAX's composite and the port's
    agree too."""
    H, B, S = 4, 2, 256
    qkv = _qkv(KV=kv, seed=2)
    q, k, v = _unpack_bhsd(qkv, H, kv)
    want = np.asarray(JA.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    ours = FA.reference_attention(*map(torch.from_numpy, (q, k, v)), causal)
    assert _err(ours, want) <= FWD_TOL
    out, _ = FA.flash_attention_qkv_fwd_reference(torch.from_numpy(qkv), H,
                                                  kv, causal)
    want = want.transpose(0, 2, 1, 3).reshape(B, S, -1)
    assert _err(out, want) <= 2e-5          # the bound of test_pallas.py


def test_fast_softmax_matches_safe():
    """tests/test_pallas.py:307: no running max gives the same result at
    normal logit scales."""
    qkv = torch.from_numpy(_qkv(B=1, H=2, KV=2))
    a, la = FA.flash_attention_qkv_fwd_reference(qkv, 2, 0, True)
    b, lb = FA.flash_attention_qkv_fwd_reference(qkv, 2, 0, True,
                                                 fast_softmax=True)
    assert _err(a, b.numpy()) <= 1e-5 and _err(la, lb.numpy()) <= 1e-5


# (JAX backward, port backward) pairs: split = K2a + K2b, fused = K2c,
# blocked = K2d; the port's one plain backward stands for all of them
_JAX_BWD = {"split": JA._bwd_call_qkv, "fused": JA._bwd_call_qkv_fused,
            "blocked": JA._bwd_call_qkv_fused_blocked}


@pytest.mark.parametrize("variant", list(_JAX_BWD))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_plain_backward_matches_jax_kernels(kv, causal, variant):
    """tests/test_pallas.py:319 and :845: every TPU backward gives the
    same d_qkv as the port's plain backward, from each side's own forward
    and the same dO."""
    H, hd, B, S = 4, 64, 2, 256
    qkv = _qkv(KV=kv, seed=3)
    do = _do(B, S, H, hd)
    sc = hd ** -0.5
    jout, jlse = _jax_fwd(qkv, H, kv, causal)
    want = _JAX_BWD[variant](jnp.asarray(qkv), H, kv, jout, jlse,
                             jnp.asarray(do), sc, causal, 128, 128, True)
    t = torch.from_numpy(qkv)
    out, lse = FA.flash_attention_qkv_fwd_reference(t, H, kv, causal)
    got = FA.flash_attention_qkv_bwd_reference(t, out, lse,
                                               torch.from_numpy(do), H, kv,
                                               causal)
    assert got.shape == qkv.shape and got.dtype == torch.float32
    assert _err(got, want) <= BWD_TOL


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("kv", [4, 2])
def test_autograd_matches_reference_gradients(kv, fused):
    """tests/test_pallas.py:366: gradients of the differentiable op equal
    autodiff through the unpack + composite, mapped back into the packed
    layout; on CPU tensors no kernel is launched."""
    H, hd, B, S = 4, 64, 1, 128
    G = H // kv
    qkv = torch.from_numpy(_qkv(B=B, S=S, KV=kv, seed=4))
    w = torch.from_numpy(_do(B, S, H, hd, seed=5))
    before = [k.launches for k in FA.KERNELS]

    x = qkv.clone().requires_grad_()
    (FA.flash_attention_qkv(x, H, kv, fused_bwd=fused) * w).sum().backward()

    y = qkv.clone().requires_grad_()
    parts = y.reshape(B, S, kv, G + 2, hd)
    q = parts[:, :, :, :G].reshape(B, S, H, hd).transpose(1, 2)
    k = parts[:, :, :, G].transpose(1, 2).repeat_interleave(G, 1)
    v = parts[:, :, :, G + 1].transpose(1, 2).repeat_interleave(G, 1)
    o = FA.reference_attention(q, k, v, True)
    (o.transpose(1, 2).reshape(B, S, H * hd) * w).sum().backward()
    assert _err(x.grad, y.grad.numpy()) <= 5e-5   # test_pallas.py's bound
    assert [k.launches for k in FA.KERNELS] == before


def test_head_dim_128_and_jax_entry_point():
    """hd 128 (the flagship's) through JAX's public custom-VJP function:
    output and input gradient of a weighted sum."""
    H, kv, hd, B, S = 2, 1, 128, 1, 256
    qkv = _qkv(B=B, S=S, H=H, KV=kv, hd=hd, seed=6)
    w = _do(B, S, H, hd, seed=7)

    def jloss(x):
        return (JA.flash_attention_qkv(x, None, H, kv, True, None, 128, 128,
                                       True) * w).sum()

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    val = (FA.flash_attention_qkv(x, H, kv) * torch.from_numpy(w)).sum()
    val.backward()
    val = float(val.detach())
    assert abs(val - float(jval)) <= 1e-5 * abs(float(jval)) + 1e-3
    assert _err(x.grad, jgrad) <= BWD_TOL


def test_ragged_sequence_and_geometry():
    """S = 100 (no multiple of any tile) against the composite, and a
    packed width that does not factor into the heads is refused."""
    H, kv = 4, 2
    qkv = _qkv(B=1, S=100, KV=kv, seed=8)
    q, k, v = _unpack_bhsd(qkv, H, kv)
    want = FA.reference_attention(*map(torch.from_numpy, (q, k, v)), True)
    out, lse = FA.flash_attention_qkv_fwd_reference(torch.from_numpy(qkv),
                                                    H, kv)
    assert _err(out, want.transpose(1, 2).reshape(1, 100, -1)) <= 2e-5
    assert lse.shape == (1, H, 100) and torch.isfinite(lse).all()
    with pytest.raises(ValueError, match="factor"):
        FA.flash_attention_qkv(torch.zeros(1, 8, 100), 4, 2)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, dtype, B, S, H, KV, hd, seed=0):
    qkv = torch.from_numpy(_qkv(B, S, H, KV, hd, seed)).to(cuda, dtype)
    do = torch.from_numpy(_do(B, S, H, hd, seed + 1)).to(cuda, dtype)
    return qkv, do


CARD = {
    "mha-hd128": dict(B=2, S=256, H=4, KV=4, hd=128),
    "gqa-hd64": dict(B=2, S=256, H=6, KV=2, hd=64),
    "g8-ragged": dict(B=1, S=200, H=8, KV=1, hd=64),
}
# also at ragged S, both head dims and every group size the wrappers take
CARD.update({f"S{S}-hd{hd}-G{G}": dict(B=1 if S > 1000 else 2, S=S,
                                        H=G * (1 if G == 8 else 2),
                                        KV=1 if G == 8 else 2, hd=hd)
             for S in (1, 63, 65, 200, 2048 + 17) for hd in (64, 128)
             for G in (1, 2, 4, 8)})
CARD_CASES = [(n, d) for d in (torch.float32, torch.bfloat16) for n in CARD]


def _norm_ok(got, ref):
    """||got - ref|| <= 1e-2 ||ref|| + 2^-15 sqrt(numel), the norm bound
    that chip_smoke.py holds the bf16 flash kernels to."""
    d = float((got.float() - ref.float()).norm())
    return d <= 1e-2 * float(ref.float().norm()) + 2 ** -15 * got.numel() ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["safe", "fast"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name,dtype", CARD_CASES,
                         ids=[f"{n}-{'f32' if d == torch.float32 else 'bf16'}"
                              for n, d in CARD_CASES])
def test_kernels_match_plain_versions_on_gpu(cuda, name, causal, fast,
                                             dtype):
    """K1, K2a, K2b and the fused K2 against the plain versions on the
    same inputs. f32: the same math in another summation order, d_qkv
    relative to its largest entry, as chip_smoke.py holds it (dk and dv
    sum G S terms in sequence: at S 2065 G 8 hd 128 both sides sit 5.9e-5
    and 9.3e-6 from an exact f64 backward, on entries to 12.9). bf16 (the
    wgmma/TMA kernels): both round p and ds to bf16 at the same places but
    sum in other orders, so a rounding may flip by one bf16 ulp: bound
    2^-6 of max|o| for out and 2^-5 of max|d_qkv| per entry, and in norm
    1e-2 of the reference's."""
    c = CARD[name]
    H, KV = c["H"], c["KV"]
    qkv, do = _card_case(cuda, dtype, **c)
    before = [k.launches for k in FA.KERNELS]
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
    assert [k.launches - b for k, b in zip(FA.KERNELS, before)] == [1] * 4
    f32 = dtype == torch.float32
    o_tol = 1e-5 if f32 else 2 ** -6 * float(rout.float().abs().max())
    g_max = float(ref.float().abs().max())
    g_tol = 2e-5 * max(1.0, g_max) if f32 else 2 ** -5 * g_max
    assert float((out.float() - rout.float()).abs().max()) <= o_tol
    assert float((lse - rlse).abs().max()) <= (1e-5 if f32 else 1e-3)
    assert f32 or _norm_ok(out, rout)
    for got in (split, fused):
        assert got.dtype == dtype and got.shape == qkv.shape
        assert float((got.float() - ref.float()).abs().max()) <= g_tol
        assert f32 or _norm_ok(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fused_backward_is_bit_identical_across_runs_on_gpu(cuda, causal,
                                                            dtype):
    """The fused K2 sums dq over k tiles in a fixed order, in f32 and in
    bf16, so two launches on the same inputs give the same bits (the fault
    it had when it summed by atomics); K2a owns its dq rows, so it does
    too."""
    H, KV, hd, B, S = 8, 2, 128, 2, 1000
    qkv, do = _card_case(cuda, dtype, B, S, H, KV, hd, seed=11)
    out, lse = FA.flash_fwd_qkv(qkv, H, KV, causal)
    first = FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV, causal)
    again = [FA.flash_bwd_fused_qkv(qkv, out, lse, do, H, KV, causal)
             for _ in range(3)]
    dq = [FA.flash_bwd_dq_qkv(qkv, out, lse, do, torch.zeros_like(qkv), H,
                              KV, causal) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)
    assert all(torch.equal(dq[0], d) for d in dq[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_pair_shares_one_prepass_on_gpu(cuda, causal):
    """bf16: K2a and K2b given the pre-pass's stats (as the backward runs
    them) write the same bits as each running its own pre-pass."""
    H, KV, hd, B, S = 8, 2, 64, 2, 333
    qkv, do = _card_case(cuda, torch.bfloat16, B, S, H, KV, hd, seed=12)
    out, lse = FA.flash_fwd_qkv(qkv, H, KV, causal)
    alone, shared = torch.zeros_like(qkv), torch.zeros_like(qkv)
    FA.flash_bwd_dq_qkv(qkv, out, lse, do, alone, H, KV, causal)
    FA.flash_bwd_dkv_qkv(qkv, out, lse, do, alone, H, KV, causal)
    stats = FA.flash_bwd_stats_qkv(qkv, out, lse, do, H, KV)
    assert stats.shape == (B, H, 384, 2)
    FA.flash_bwd_dq_qkv(qkv, out, lse, do, shared, H, KV, causal,
                        stats=stats)
    FA.flash_bwd_dkv_qkv(qkv, out, lse, do, shared, H, KV, causal,
                         stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(alone, shared)
    assert FA.flash_bwd_stats_qkv(qkv.float(), out.float(), lse, do.float(),
                                  H, KV) is None


@pytest.mark.cuda
def test_autograd_launches_the_kernels_on_gpu(cuda):
    qkv, do = _card_case(cuda, torch.float32, B=1, S=128, H=2, KV=1, hd=64)
    for fused, counted in ((False, (1, 1, 1, 0)), (True, (1, 0, 0, 1))):
        before = [k.launches for k in FA.KERNELS]
        x = qkv.clone().requires_grad_()
        FA.flash_attention_qkv(x, 2, 1, fused_bwd=fused).backward(do)
        torch.cuda.synchronize()
        assert tuple(k.launches - b
                     for k, b in zip(FA.KERNELS, before)) == counted
        ref = FA.flash_attention_qkv_bwd_reference(
            qkv, *FA.flash_attention_qkv_fwd_reference(qkv, 2, 1), do, 2, 1)
        assert float((x.grad - ref).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_run(cuda):
    qkv, do = _card_case(cuda, torch.float32, B=1, S=64, H=2, KV=2, hd=64)
    out, lse = FA.flash_fwd_qkv(qkv, 2)
    with pytest.raises(TypeError):
        FA.flash_fwd_qkv(qkv.half(), 2)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_qkv(torch.zeros(1, 64, 6 * 320, device=cuda), 2)
    with pytest.raises(ValueError, match="divide"):
        FA.flash_fwd_qkv(torch.zeros(1, 8, 7 * 64, device=cuda), 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_fwd_qkv(qkv.expand(2, -1, -1), 2)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd_qkv(qkv.cpu(), 2)
    with pytest.raises(ValueError, match="is on"):
        FA.flash_bwd_fused_qkv(qkv, out, lse.cpu(), do, 2)
    with pytest.raises(TypeError, match="lse"):
        FA.flash_bwd_fused_qkv(qkv, out, lse.double(), do, 2)
