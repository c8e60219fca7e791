"""Greedy speculative decoding and beam search under the quant modes in
the port (`transformer.make_speculative_generate`, `_verify_body`,
`make_beam_search(quant=)`) on the CPU in f32 against the JAX package:
the cases of tests/test_models.py:612, :641, :1539 and :1658.

* The speculative output equals JAX's greedy `make_generate` tokens of
  the target for any draft (a random smaller draft, the target itself,
  gamma 1, 4 and 7), for the GPT, rope + GQA and llama stacks, and under
  None, "int8" and "int8-kv" (the same mode's greedy generation); with
  the target as its own draft, at most ceil(max_new / (gamma + 1)) + 1
  target passes, and as many passes as JAX's for one random draft;
* `_verify_body` over C tokens equals C single decode steps (logits
  within TOL, the same cache), the port's own identity;
* beam search under "int8" and "int8-kv": JAX's tokens, scores within
  TOL."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch.models import transformer as TT
from tests.conftest import TOL
from tests.test_torch_serving_slots import one_thread  # noqa: F401

TARGET = dict(vocab_size=48, n_layer=2, n_head=2, d_model=48, d_ff=96,
              max_seq=64)
DRAFT = dict(vocab_size=48, n_layer=1, n_head=2, d_model=32, d_ff=64,
             max_seq=64)
STACKS = {
    "gpt": (JT.GPTConfig, TT.GPTConfig, {}),
    "rope-gqa": (JT.GPTConfig, TT.GPTConfig,
                 dict(pos_emb="rope", n_head=4, n_kv_head=2)),
    "llama": (JT.llama_config, TT.llama_config,
              dict(n_head=4, n_kv_head=2)),
}


@functools.lru_cache(maxsize=None)
def pair(stack, draft: bool = False):
    """(jax cfg, port cfg, jax params, port params) of a stack's target
    (or its smaller draft)."""
    jmake, tmake, kw = STACKS[stack]
    base = dict(DRAFT if draft else TARGET, **kw)
    if draft and "n_head" in kw:
        base["n_head"] = 2
        base["n_kv_head"] = 1
    jcfg = jmake(dtype=jnp.float32, flash="off", remat=False, **base)
    tcfg = tmake(dtype=torch.float32, **base)
    jp = JT.init_params(jax.random.key(9 if draft else 0), jcfg)
    return jcfg, tcfg, jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


PROMPT = np.random.default_rng(1).integers(0, 48, (1, 8)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_greedy(stack, quant=None, max_new=16):
    jcfg, _, jp, _ = pair(stack)
    return np.asarray(JT.make_generate(jcfg, max_new=max_new, quant=quant)(
        jp, jnp.asarray(PROMPT), jax.random.key(0)))


def spec(stack, gamma, quant=None, self_draft=False, max_new=16):
    _, tcfg, _, tp = pair(stack)
    _, dcfg, _, dp = pair(stack, draft=not self_draft)
    out, passes = TT.make_speculative_generate(
        tcfg, dcfg, max_new, gamma=gamma, quant=quant, draft_quant=quant)(
        tp, dp, torch.from_numpy(PROMPT))
    return out.numpy(), passes


@pytest.mark.parametrize("stack", list(STACKS))
def test_speculative_equals_target_greedy(stack):
    want = jax_greedy(stack)
    for gamma in (1, 4, 7):
        out, passes = spec(stack, gamma)
        np.testing.assert_array_equal(out, want)
        assert passes <= 16
    out, passes = spec(stack, 4, self_draft=True)
    np.testing.assert_array_equal(out, want)
    assert passes <= -(-16 // 5) + 1          # a perfect draft


def test_speculative_passes_match_jax():
    jcfg, _, jp, _ = pair("gpt")
    jdcfg, _, jdp, _ = pair("gpt", draft=True)
    want, jpasses = JT.make_speculative_generate(jcfg, jdcfg, 16, gamma=4)(
        jp, jdp, jnp.asarray(PROMPT))
    out, passes = spec("gpt", 4)
    np.testing.assert_array_equal(out, np.asarray(want))
    assert passes == int(jpasses)


@pytest.mark.parametrize("quant", ["int8", "int8-kv"])
def test_speculative_under_quant_equals_same_mode_greedy(quant):
    out, _ = spec("gpt", 3, quant=quant)
    np.testing.assert_array_equal(out, jax_greedy("gpt", quant))


def test_verify_body_equals_decode_steps():
    _, tcfg, _, tp = pair("rope-gqa")
    params = TT.prepare_decode_params(tp, tcfg)
    prompt = torch.from_numpy(PROMPT)
    chunk = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)
    a = TT.init_kv_cache(tcfg, 1, device="cpu")
    _, a = TT._prefill_body(params, a, prompt, tcfg)
    b = {n: t.clone() for n, t in a.items()}
    lg, a = TT._verify_body(params, a, chunk, tcfg)
    for i in range(chunk.shape[1]):
        step, b = TT._decode_step_body(params, b, chunk[:, i], tcfg)
        np.testing.assert_allclose(lg[:, i].numpy(), step.numpy(), rtol=TOL,
                                   atol=TOL)
    assert int(a["pos"]) == int(b["pos"]) == 12
    np.testing.assert_allclose(a["k"].numpy(), b["k"].numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("quant", ["int8", "int8-kv"])
def test_beam_search_under_quant_matches_jax(quant):
    jcfg, tcfg, jp, tp = pair("gpt")
    want_t, want_s = JT.make_beam_search(jcfg, max_new=6, n_beams=3,
                                         quant=quant)(jp, jnp.asarray(PROMPT))
    got_t, got_s = TT.make_beam_search(tcfg, max_new=6, n_beams=3,
                                       quant=quant)(tp, torch.from_numpy(
                                           PROMPT))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=TOL,
                               atol=TOL)
