"""K11's tensor-core body past 8 query heads a kv head (route "mma",
StarCoderBase-1B's decode) on the CPU: the route (`paged_route`), the
body's plan (`paged_mma_plan`) and its walk of each split's keys as the
kernel deals them to its warps, and the plain split-and-merge twin under
that plan against JAX's paged-attention kernel in interpret mode. The
kernel itself runs on the card (tests/test_torch_wide_cuda.py)."""

import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from neuronika_tpu_torch.ops import paged_attention as PA
from tests.conftest import REF_TOL

SRC = (pathlib.Path(PA.__file__).parent.parent / "csrc" /
       "paged_attention.cu").read_text()
# the kernel's tile: 16 keys a warp's tile, 4 warps a CTA
KEYS, WARPS = 16, 4


@pytest.mark.parametrize("hd", [8, 36, 64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8, 9, 12, 16, 32, 64])
def test_paged_route(G, hd):
    """bf16 past 8 query heads a kv head at hd 64 and 128 takes the
    tensor-core body; every other group, head dim and f32 the chunked
    one, in chunks of 8 heads (the mma body's are of 16)."""
    assert PA.paged_route(torch.float32, G, hd) == "chunked"
    want = "mma" if G > 8 and hd in (64, 128) else "chunked"
    assert PA.paged_route(torch.bfloat16, G, hd) == want
    assert PA.group_chunks(G) == -(-G // 8)
    assert PA.group_chunks(G, "mma") == -(-G // 16)


def test_mma_constants_are_the_kernels():
    """The module's mirror of the body's tile (csrc/paged_attention.cu:
    kMmaRows query heads a CTA) and the head dims it is built for."""
    rows = int(re.search(r"constexpr int kMmaRows = (\d+);", SRC).group(1))
    assert rows == PA.MMA_G
    built = {int(h) for h in re.findall(r"launch_mma<(\d+)>", SRC)}
    assert built == set(PA.MMA_HEAD_DIMS)


def _walk(pos, window, BS, MB, bps):
    """The keys the kernel masks in for one sequence, as
    `paged_attention_mma_kernel` computes them: the splits that meet the
    attended blocks, each split's [t_begin, t_end) cut into 16-key tiles
    dealt to 4 warps in turn, a key kept where lo <= key <= pos. Returns
    {key: times kept}."""
    splits = -(-MB // bps)
    pos = min(pos, MB * BS - 1)
    lo = max(pos - window + 1, 0) if window > 0 else 0
    z_lo, z_hi = lo // BS // bps, pos // BS // bps
    kept = {}
    for z in range(splits):
        if z < z_lo or z > z_hi:
            continue
        t_begin = max(lo // BS * BS, z * bps * BS)
        t_end = min((pos // BS + 1) * BS, min(MB, (z + 1) * bps) * BS)
        ntiles = -(-(t_end - t_begin) // KEYS)
        for w in range(WARPS):
            for t in range(w, ntiles, WARPS):
                for key in range(t_begin + KEYS * t,
                                 t_begin + KEYS * (t + 1)):
                    if key < t_end and lo <= key <= pos:
                        kept[key] = kept.get(key, 0) + 1
    return kept


PLAN_SHAPES = list(itertools.product((1, 3, 8), (1, 2, 4), (9, 16, 33, 64),
                                     (1, 7, 128, 512)))


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("B,KV,G,MB", PLAN_SHAPES,
                         ids=[f"B{b}-KV{k}-G{g}-MB{m}"
                              for b, k, g, m in PLAN_SHAPES])
def test_mma_plan_covers_each_block_once(B, KV, G, MB, sms):
    """Every logical block of a (sequence, kv head, chunk) lies in exactly
    one split, in order, none empty; a split walks at least MMA_MIN_BLOCKS
    blocks unless one split takes them all; no more CTAs than one wave of
    MMA_CTAS_PER_SM an SM are asked for; the plan does not depend on pos.
    Then the kernel's walk keeps each attended key exactly once, at four
    positions and three windows of one block size."""
    splits, bps = PA.paged_mma_plan(B, KV, G, MB, sms)
    assert PA.paged_plan("mma", B, KV, G, MB, sms) == (splits, bps)
    blocks = [m for z in range(splits)
              for m in range(z * bps, min(MB, (z + 1) * bps))]
    assert blocks == list(range(MB))
    assert (splits - 1) * bps < MB <= splits * bps
    assert splits == 1 or bps >= PA.MMA_MIN_BLOCKS
    items = B * KV * PA.group_chunks(G, "mma")
    assert splits == 1 or items * (splits - 1) < PA.MMA_CTAS_PER_SM * sms
    assert splits <= PA.SPLIT_MAX
    BS = 16
    for pos in sorted({0, 17, MB * BS // 2, MB * BS - 1}):
        for window in (0, 1, 300):
            kept = _walk(pos, window, BS, MB, bps)
            pos = min(pos, MB * BS - 1)   # the kernel clamps it so
            lo = max(pos - window + 1, 0) if window else 0
            assert kept == {k: 1 for k in range(lo, pos + 1)}, (pos, window)


def test_starcoder_decode_plan():
    """StarCoderBase-1B's decode (B8, one kv head of 16 query heads, MB128)
    on an H100: one chunk a (sequence, kv head), 16 splits of 8 blocks,
    128 CTAs, one wave of its 132 SMs."""
    assert PA.paged_route(torch.bfloat16, 16, 128) == "mma"
    assert PA.paged_mma_plan(8, 1, 16, 128) == (16, 8)


def _case(B, KV, G, hd, BS, MB, pos, seed):
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    pk = rng.normal(size=(NB, KV, BS, hd)).astype(np.float32)
    pv = rng.normal(size=(NB, KV, BS, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    return q, pk, pv, table.astype(np.int32), np.array(pos, np.int32)


def _jax(case, window, dtype):
    q, pk, pv, table, pos = case
    out = jax_paged_attention(
        *(jnp.asarray(a, dtype) for a in (q, pk, pv)), jnp.asarray(table),
        jnp.asarray(pos), window=window, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(case, dtype):
    q, pk, pv, table, pos = case
    return ([torch.from_numpy(a).to(dtype) for a in (q, pk, pv)]
            + [torch.from_numpy(a) for a in (table, pos)])


# (G, KV, hd): StarCoderBase-1B's group (one tile), and 12 heads padded to
# 16 rows over two kv heads; BS 8 and MB 24, so the plan cuts 3 splits of 8
# blocks and pos 191, 77 and 9 put a split alone, three splits, or a
# window across a split boundary
MMA_CASES = [(16, 1, 128), (12, 2, 64)]


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("G,KV,hd", MMA_CASES,
                         ids=[f"G{g}-KV{k}-hd{h}" for g, k, h in MMA_CASES])
def test_split_twin_under_mma_plan_matches_jax_f32(G, KV, hd, window):
    """The plain split-and-merge twin, cut as the tensor-core body's plan
    cuts the keys, against JAX's kernel in interpret mode, f32, to
    REF_TOL."""
    B, BS, MB = 3, 8, 24
    splits, bps = PA.paged_mma_plan(B, KV, G, MB)
    assert (splits, bps) == (3, 8)
    case = _case(B, KV, G, hd, BS, MB, [191, 77, 9], seed=G + hd + window)
    out = PA.paged_attention_split_reference(*_torch(case, torch.float32),
                                             window=window, bps=bps)
    assert out.dtype == torch.float32 and out.shape == case[0].shape
    err = np.abs(out.numpy() - _jax(case, window, jnp.float32)).max()
    assert err <= REF_TOL, err


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("G,KV,hd", MMA_CASES,
                         ids=[f"G{g}-KV{k}-hd{h}" for g, k, h in MMA_CASES])
def test_split_twin_under_mma_plan_matches_jax_bf16(G, KV, hd, window):
    """The same in bf16, where the route is "mma" and the twin takes that
    plan by default. Bound: two bf16 ulps of the largest output (2^-6
    max|o|): one from rounding the output, one from JAX (and the kernel)
    rounding p to bf16 before P V where the twin keeps it in f32."""
    B, BS, MB = 3, 8, 24
    case = _case(B, KV, G, hd, BS, MB, [191, 77, 9], seed=G + hd + window)
    args = _torch(case, torch.bfloat16)
    out = PA.paged_attention_split_reference(*args, window=window)
    plan = PA.paged_attention_split_reference(
        *args, window=window, bps=PA.paged_mma_plan(B, KV, G, MB)[1])
    assert torch.equal(out, plan)
    ref = _jax(case, window, jnp.bfloat16)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2 ** -6 * np.abs(ref).max(), err
