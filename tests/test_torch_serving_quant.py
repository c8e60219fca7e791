"""Quantized serving weights and the int8 KV cache of the port
(neuronika_tpu_torch/models/transformer.py: `_quant_w`, `_quant_kv`,
`prepare_decode_params(quant=)`, `_qdot`, `init_kv_cache(quant="int8-kv")`
and quant on `make_prefill`, `make_decode_step`, `make_generate`) against
the JAX package on the CPU in f32 (JAX's gather path; params through
`params_from_jax`).

* The prepared trees: every int8 and int4 leaf and scale equal to JAX's
  bit for bit.
* The W8A8 product: `_int8_mm` equal to an int64 numpy product.
* Logits: the prefill and 8 decode steps of each mode within QUANT_TOL of
  JAX's (relative to the largest logit): the int8 products are exact
  integers on both sides, so the two differ only by f32 summation order
  (and, rarely, an activation rounded the other way at a .5 tie).
* Greedy `make_generate` tokens identical to JAX's in every mode (the
  cases of tests/test_models.py:435, :469, :504)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch.models import transformer as TT
from tests.test_torch_serving_slots import one_thread  # noqa: F401

BASE = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
            d_ff=128, max_seq=32)
MODES = ["int8", "int8-kv", "int4"]
# relative to max |logit|: f32 summation order (measured below 1e-6)
QUANT_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = JT.GPTConfig(dtype=jnp.float32, flash="off", remat=False, **BASE)
    tcfg = TT.GPTConfig(dtype=torch.float32, **BASE)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(1).integers(0, 64, (4, 8)).astype(
        np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if torch.is_tensor(v)
                               else np.asarray(v))
    return out


@pytest.mark.parametrize("quant", MODES)
def test_prepared_trees_match_jax_bit_for_bit(model, quant):
    jcfg, tcfg, jp, tp, _ = model
    want = _flat(JT.prepare_decode_params(jp, jcfg, quant))
    got = _flat(TT.prepare_decode_params(tp, tcfg, quant))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    if quant != "int4":
        assert got["blocks/qkv/q8"].dtype == np.int8
    else:
        assert got["blocks/qkv/q4p"].dtype == np.int8
    # prepared params pass through every program unchanged
    prep = TT.prepare_decode_params(tp, tcfg, quant)
    assert TT._prep_decode_params(prep, tcfg, quant) is prep


def test_int8_product_is_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (3, 72)).astype(np.int8)
    w = rng.integers(-127, 128, (72, 40)).astype(np.int8)
    got = TT._int8_mm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


def _decode_logits(mod, cfg, params, prompt, quant, as_in):
    pre = mod.make_prefill(cfg, quant)
    step = mod.make_decode_step(cfg, quant)
    kw = {} if mod is JT else dict(device="cpu")
    cache = mod.init_kv_cache(cfg, prompt.shape[0], quant=quant, **kw)
    logits, cache = pre(params, cache, as_in(prompt))
    out = [np.asarray(logits)]
    for t in range(8):          # the same inputs on both sides
        logits, cache = step(params, cache, as_in(prompt[:, t]))
        out.append(np.asarray(logits))
    return np.stack(out), cache


@pytest.mark.parametrize("quant", MODES)
def test_prefill_and_decode_logits_match_jax(model, quant):
    jcfg, tcfg, jp, tp, prompt = model
    want, jcache = _decode_logits(JT, jcfg, jp, prompt, quant, jnp.asarray)
    got, tcache = _decode_logits(TT, tcfg, tp, prompt, quant,
                                 torch.from_numpy)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= QUANT_TOL * scale
    if quant == "int8-kv":
        assert tcache["k"].dtype == torch.int8
        assert tuple(tcache["ks"].shape) == tuple(jcache["ks"].shape)
        np.testing.assert_allclose(tcache["ks"].numpy(),
                                   np.asarray(jcache["ks"]), rtol=1e-5)


@pytest.mark.parametrize("quant", [None] + MODES)
def test_make_generate_tokens_match_jax(model, quant):
    jcfg, tcfg, jp, tp, prompt = model
    want = np.asarray(JT.make_generate(jcfg, max_new=8, quant=quant)(
        jp, jnp.asarray(prompt), jax.random.key(5)))
    got = TT.make_generate(tcfg, max_new=8, quant=quant)(
        tp, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantized_logits_track_full_precision(model):
    """The port's own quantized decode stays near its f32 decode, as the
    JAX tests hold JAX's (int8 within 2%, int4 within 6% on a trained
    model; here random weights, so the bounds are looser)."""
    _, tcfg, _, tp, prompt = model
    full, _ = _decode_logits(TT, tcfg, tp, prompt, None, torch.from_numpy)
    scale = np.abs(full).max()
    for quant, bound in (("int8", 0.05), ("int8-kv", 0.05), ("int4", 0.3)):
        q, _ = _decode_logits(TT, tcfg, tp, prompt, quant, torch.from_numpy)
        assert np.abs(q - full).max() <= bound * scale, quant
