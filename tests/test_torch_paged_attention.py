"""The port's paged-attention decode (neuronika_tpu_torch/ops/
paged_attention.py) against the JAX kernel (ops/pallas/paged_attention.py,
run in interpret mode as tests/test_pallas.py runs it on the CPU), and the
CUDA kernel against its plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from neuronika_tpu_torch.ops import paged_attention as PA
from neuronika_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference,
    paged_attention_split_reference, paged_split_plan)

F32_TOL = 1e-5


def _case(B=3, KV=2, G=2, hd=128, BS=16, MB=4, seed=0, pos=None,
          inactive=()):
    """Random q and pool, per-sequence shuffled block tables (as
    tests/test_pallas.py); lanes in `inactive` take the decode step's
    idle-lane form: an all-zero table row and pos clamped to MB*BS-1."""
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    pk = rng.normal(size=(NB, KV, BS, hd)).astype(np.float32)
    pv = rng.normal(size=(NB, KV, BS, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    table = table.astype(np.int32)
    pos = np.array([5, 37, MB * BS - 1] if pos is None else pos, np.int32)
    for b in inactive:
        table[b] = 0
        pos[b] = MB * BS - 1
    return q, pk, pv, table, pos


CASES = {
    # the cases of tests/test_pallas.py::TestPagedAttention
    "gqa-g2": dict(),
    "mha-g1": dict(KV=4, G=1, seed=1),
    # wider query groups, position edges (first key, block ends and
    # starts, last slot) and an inactive lane
    "gqa-g6": dict(KV=2, G=6, seed=2),
    "edges-inactive": dict(B=5, KV=2, G=1, seed=3, pos=[0, 15, 16, 63, 9],
                           inactive=[4]),
}


def _jax(case, window, dtype=jnp.float32):
    q, pk, pv, table, pos = case
    out = jax_paged_attention(
        *(jnp.asarray(a, dtype) for a in (q, pk, pv)), jnp.asarray(table),
        jnp.asarray(pos), window=window, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(case, dtype=torch.float32, device="cpu"):
    q, pk, pv, table, pos = case
    return ([torch.from_numpy(a).to(device, dtype) for a in (q, pk, pv)]
            + [torch.from_numpy(a).to(device) for a in (table, pos)])


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel_f32(name, window):
    case = _case(**CASES[name])
    before = paged_attention.launches
    out = paged_attention(*_torch(case), window=window)
    assert paged_attention.launches == before      # CPU: no kernel launch
    assert out.dtype == torch.float32 and out.shape == case[0].shape
    err = np.abs(out.numpy() - _jax(case, window)).max()
    assert err < F32_TOL, err


@pytest.mark.parametrize("window", [0, 9])
def test_plain_version_matches_jax_kernel_bf16(window):
    """Same bf16 inputs on both sides. Bound: two bf16 ulps of the largest
    output (2^-6 * max|o|): one from rounding the output, one from JAX
    rounding the softmax weights to bf16 before PV (2^-9 relative per
    weight) where the port keeps them in f32."""
    case = _case(**CASES["gqa-g6"])
    out = paged_attention(*_torch(case, torch.bfloat16), window=window)
    assert out.dtype == torch.bfloat16
    ref = _jax(case, window, jnp.bfloat16)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2 ** -6 * np.abs(ref).max(), err


def test_window_and_gqa_change_the_result():
    # the cases above are not vacuous: the window and the query grouping
    # both move the output
    case = _case(**CASES["gqa-g6"])
    full = paged_attention_reference(*_torch(case))
    band = paged_attention_reference(*_torch(case), window=9)
    assert (full - band).abs().max() > 1e-2
    assert (full[:, :, 0] - full[:, :, 1]).abs().max() > 1e-2


# (B, KV, MB): the tests' cases, chip_smoke.py phase 3's table and long
# shapes, its GQA case, one sequence of one block, a batch that fills the
# card without a split, and MB not a multiple of the split
SPLIT_SHAPES = [(3, 2, 4), (5, 2, 4), (8, 12, 64), (1, 12, 512), (8, 2, 64),
                (1, 1, 1), (64, 12, 64), (2, 3, 37), (1, 1, 1000),
                (1, 1, 4096)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("B,KV,MB", SPLIT_SHAPES)
def test_split_plan_covers_each_block_once(B, KV, MB, sms):
    """Every logical block of a (sequence, kv head) lies in exactly one
    split, the splits in order and none empty; a split holds at least
    SPLIT_MIN_BLOCKS blocks unless one split takes them all; more CTAs than
    the card's SPLIT_CTAS_PER_SM a SM are never asked for."""
    splits, bps = paged_split_plan(B, KV, MB, sms)
    blocks = [m for z in range(splits)
              for m in range(z * bps, min(MB, (z + 1) * bps))]
    assert blocks == list(range(MB))
    assert (splits - 1) * bps < MB <= splits * bps
    assert splits == 1 or bps >= PA.SPLIT_MIN_BLOCKS
    assert splits == 1 or B * KV * (splits - 1) < PA.SPLIT_CTAS_PER_SM * sms
    assert splits <= PA.SPLIT_MAX


def test_split_cap_is_the_kernels():
    """The plan never asks for more splits than the kernel's merge takes
    (csrc/paged_attention.cu: kMaxSplits), even for one very long
    sequence on a large card."""
    import pathlib
    import re

    src = (pathlib.Path(PA.__file__).parent.parent / "csrc" /
           "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSplits = (\d+);",
                         src).group(1)) == PA.SPLIT_MAX
    assert paged_split_plan(1, 1, 1 << 16, 1000)[0] <= PA.SPLIT_MAX


def test_long_context_splits():
    """The shapes the split was made for: one sequence of 8192 keys, 12 kv
    heads, cut into 43 splits of 12 blocks; phase 4's serving shape into
    6 of 11."""
    assert paged_split_plan(1, 12, 512) == (43, 12)
    assert paged_split_plan(8, 12, 64) == (6, 11)


@pytest.mark.parametrize("bps", [1, 3, None], ids=["bps1", "bps3", "plan"])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("name", list(CASES))
def test_split_twin_matches_jax_kernel_f32(name, window, bps):
    """The plain twin of the kernel's split-and-merge math against the JAX
    kernel: splits of one block (most of them empty past pos or before the
    window), of three (the last one ragged) and the plan's."""
    case = _case(**CASES[name])
    out = paged_attention_split_reference(*_torch(case), window=window,
                                          bps=bps)
    assert out.dtype == torch.float32 and out.shape == case[0].shape
    err = np.abs(out.numpy() - _jax(case, window)).max()
    assert err < F32_TOL, err


def test_split_twin_empty_splits_and_a_dropped_partial():
    """An empty split leaves m = -inf and l = 0 and adds nothing to the
    merge; dropping a split that holds attended keys moves the result."""
    q, pk, pv, table, pos = _torch(_case(**CASES["edges-inactive"]))
    m, l, acc = PA._split_partials(q, pk, pv, table, pos, 0, 1)
    assert m.shape == (5, 2, 1, 4) and acc.shape == (5, 2, 1, 4, 128)
    empty = m == -np.inf                       # pos 0 and 15: splits 1-3
    assert bool(empty[0, :, :, 1:].all()) and bool((l[empty] == 0).all())
    assert not bool(empty[3].any())            # pos 63 meets every split
    full = PA._merge_splits(m, l, acc)
    ref = paged_attention_reference(q, pk, pv, table, pos)
    assert float((full - ref).abs().max()) < F32_TOL
    m[:, :, :, 1] = -np.inf
    assert float((PA._merge_splits(m, l, acc) - ref).abs().max()) > 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_version_on_gpu(cuda, name, window, dtype, tol):
    """bf16 bound: both sides compute in f32 from the same bf16 inputs and
    round once, so one bf16 ulp of |o| (2^-6 for |o| < 4)."""
    args = _torch(_case(**CASES[name]), dtype, cuda)
    before = paged_attention.launches
    out = paged_attention(*args, window=window)
    ref = paged_attention_reference(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == dtype and out.device.type == "cuda"
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_run(cuda):
    q, pk, pv, table, pos = _torch(_case(), torch.float32, cuda)
    with pytest.raises(TypeError):
        paged_attention(q.half(), pk.half(), pv.half(), table, pos)
    with pytest.raises(TypeError):
        paged_attention(q, pk, pv, table.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                        pk, pv, table, pos)
    with pytest.raises(ValueError, match="head dim"):
        wide = (320,)
        paged_attention(q.new_zeros(q.shape[:-1] + wide),
                        pk.new_zeros(pk.shape[:-1] + wide),
                        pv.new_zeros(pv.shape[:-1] + wide), table, pos)
    with pytest.raises(ValueError, match="is on"):
        paged_attention(q, pk.cpu(), pv, table, pos)


def _long_case(dtype, device, hd=128, KV=12, G=1, B=1, MB=512, pos=None,
               inactive=(), seed=4):
    """phase 3's long-context shape (B1 KV12 hd128 BS16 MB512 at pos 8191)
    and its variants, on the card."""
    pos = [MB * 16 - 1] * B if pos is None else pos
    return _torch(_case(B=B, KV=KV, G=G, hd=hd, BS=16, MB=MB, seed=seed,
                        pos=pos, inactive=inactive), dtype, device)


# (name, _long_case arguments, window): each cut into several splits by
# paged_split_plan
SPLIT_CASES = [
    ("long", dict(), 0),
    ("long-window-across-splits", dict(), 300),     # splits of 192 keys
    ("gqa-g6", dict(KV=2, G=6, B=3, MB=64, pos=[700, 1023, 5]), 0),
    ("gqa-g6-window", dict(KV=2, G=6, B=3, MB=64, pos=[700, 1023, 5]), 100),
    ("hd64", dict(hd=64, B=4, MB=64, pos=[0, 200, 1023, 513]), 0),
    ("hd256", dict(hd=256, KV=4, B=2, MB=96, pos=[1535, 400]), 37),
    ("idle-lanes", dict(B=4, MB=64, pos=[0, 300, 16, 900], inactive=[1, 3]),
     0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,kw,window", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_kernel_matches_plain_version_on_gpu(cuda, name, kw, window,
                                                   dtype, tol):
    """The split kernel (more than one CTA per sequence and kv head, merged
    by the last one in) against the plain version and its split twin."""
    args = _long_case(dtype, cuda, **kw)
    B, KV = args[0].shape[:2]
    G, hd = args[0].shape[2:]
    assert PA._plan(PA.paged_route(dtype, G, hd), B, KV, G,
                    args[3].shape[1], args[0].device)[0] > 1
    before = paged_attention.launches
    out = paged_attention(*args, window=window)
    ref = paged_attention_reference(*args, window=window)
    twin = paged_attention_split_reference(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((out.float() - twin.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_kernel_gives_the_same_bits_twice(cuda, dtype):
    """Whichever CTA of a sequence comes last and merges, the splits merge
    in split order; the counters are back at 0 after each launch."""
    args = _long_case(dtype, cuda, B=2, pos=[8191, 3000])
    a = paged_attention(*args, window=1000)
    b = paged_attention(*args, window=1000)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(PA._scratch(cuda, 0, 24)[1][:24].abs().sum()) == 0
