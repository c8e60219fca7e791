"""The split kernels K5-K7 at head dim 96, Phi-3-mini's: the gate that
sends bf16 hd 64, 96 and 128 to the Hopper forward, dq and dk/dv walks
while hd 96 keeps the packed kernels off them (`_sm90_route`), and the
plain versions of K5-K7 at hd 96 against JAX's Pallas kernels `_fwd_call`
/ `_bwd_call` (`_fwd_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`) in
interpret mode, under Phi-3-mini's band (causal with a window, S not a
multiple of 64) and full cross attention with Sq != Skv. f32; inputs from
numpy seeds. The kernels themselves run on the card
(tests/test_torch_wide_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.ops.pallas import attention as JA
from neuronika_tpu_torch.ops import flash_attention as FA
from tests.conftest import TOL

HD = 96
# (id, Sq, Skv, causal, window, JAX's q and kv blocks, which must divide
# Sq and Skv there): Phi-3-mini's band cut to S 300 (window 2047 -> 127),
# the causal band alone, and cross attention with Sq != Skv
CASES = [("phi3-window127-S300", 300, 300, True, 127, 60, 60),
         ("causal-S300", 300, 300, True, 0, 60, 60),
         ("full-Sq120-Skv300", 120, 300, False, 0, 60, 60)]
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("hd", [8, 32, 64, 72, 80, 96, 128, 256])
def test_gate_per_kernel(hd):
    """bf16 at hd 64, 96 and 128 sends the split K5, K6 and K7 to the
    Hopper walks; the packed K1 and K2 go there at hd 64 and 128 only; f32
    never does."""
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        assert FA._sm90_route(dtype, hd, split=True) == (
            bf16 and hd in (64, 96, 128))
        assert FA._sm90_route(dtype, hd) == (bf16 and hd in (64, 128))
        assert FA._sm90_route(dtype, hd, split=False) == \
            FA._sm90_route(dtype, hd)


def _inputs(Sq, Skv, seed, B=1, H=2):
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, HD), (B, H, Skv, HD), (B, H, Skv, HD),
              (B, H, Sq, HD))
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _err(a, b):
    return float(np.abs(a.detach().numpy() - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_split_matches_jax_kernels_hd96(case):
    """K5's plain forward (out, base-2 lse), then K6's and K7's plain
    backward from JAX's out and lse, against JAX's kernels in interpret
    mode."""
    _, Sq, Skv, causal, window, bq, bk = case
    q, k, v, do = _inputs(Sq, Skv, seed=Sq + Skv + window)
    sc = HD ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = JA._fwd_call(jq, jk, jv, sc, causal, bq, bk, True,
                              window=window)
    want = JA._bwd_call(jq, jk, jv, jout, jlse, jdo, sc, causal, bq, bk,
                        True, window=window)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = FA.flash_attention_fwd_reference(*t[:3], causal,
                                                window=window)
    assert out.shape == (1, 2, Sq, HD) and lse.shape == (1, 2, Sq)
    assert _err(out, jout) <= TOL
    assert _err(lse, np.asarray(jlse)[..., 0]) <= TOL
    o = np.asarray(jout)
    delta = torch.from_numpy((do * o).sum(-1))
    jl = torch.from_numpy(np.ascontiguousarray(np.asarray(jlse)[..., 0]))
    got = FA.flash_attention_bwd_reference(*t, jl, delta, causal,
                                           window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _err(a, b) <= TOL, name
