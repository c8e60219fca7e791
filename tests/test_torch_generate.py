"""The port's evaluation step and dense KV-cache generation
(neuronika_tpu_torch/models/transformer.py: `make_eval_step`, `evaluate`,
`init_kv_cache`, `make_prefill`, `make_decode_step`, `sample_logits`,
`generate`, `make_generate`, `make_beam_search`) against the JAX package on
the CPU in f32, for a tied GPT with learned positions and an untied
llama-style GQA model whose window is shorter than prompt plus new tokens.
Params come from JAX's init through `params_from_jax`; tokens from numpy.

* Eval: summed token CE within TOL (relative) of JAX's and the same
  token count, with and without `pad_id`; `evaluate`'s dict likewise.
* Decode: the prefill's and each decode step's logits within TOL of
  JAX's; the cache path's logits within TOL of the port's full forward.
* Greedy `generate` and `make_generate` tokens, and greedy tokens under a
  repetition penalty, identical to JAX's; `make_beam_search` tokens
  identical and scores within TOL (relative), with one beam equal to
  greedy, and the exhaustive case (n_beams == vocab, max_new 2) against
  brute force, as the JAX package's own test does.
* Sampling: the draws cannot match JAX's PRNG bits, so `sample_logits`'s
  filters are checked by property, and a seeded generator repeats."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch.models import transformer as TT
from tests.conftest import TOL

BASE = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, d_ff=64,
            max_seq=32)
MODELS = {
    "gpt": (JT.GPTConfig, TT.GPTConfig, {}),
    # window 6 < prompt 8 + new tokens
    "llama_gqa": (JT.llama_config, TT.llama_config,
                  dict(n_kv_head=2, window=6)),
}
P, NEW = 8, 12


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    jmake, tmake, kw = MODELS[request.param]
    jcfg = jmake(dtype=jnp.float32, **BASE, **kw)
    tcfg = tmake(dtype=torch.float32, **BASE, **kw)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, BASE["vocab_size"], size=(3, P), dtype=np.int32)
    greedy = np.asarray(JT.generate(jp, jcfg, prompt, max_new=NEW))
    return request.param, jcfg, tcfg, jp, tp, prompt, greedy


def _close(a, ref, tol=TOL):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(a, ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


# -------------------------------------------------------------------- eval


@pytest.mark.parametrize("pad_id", [None, 0])
def test_eval_step_sums_and_counts_match_jax(model, pad_id):
    _, jcfg, tcfg, jp, tp, _, _ = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, size=(2, 16), dtype=np.int32)
    tgts = np.roll(toks, -1, axis=1)
    tgts[:, -3:] = 0                               # padded tails
    js, jn = JT.make_eval_step(jcfg, pad_id=pad_id)(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    ts, tn = TT.make_eval_step(tcfg, pad_id=pad_id)(
        tp, torch.from_numpy(toks), torch.from_numpy(tgts))
    assert ts.dtype == tn.dtype == torch.float32
    assert float(tn) == float(jn)
    _close(float(ts), float(js))
    batches = [(toks, tgts), (toks[:1], tgts[:1])]
    je = JT.evaluate(jp, jcfg, batches, pad_id=pad_id)
    te = TT.evaluate(tp, tcfg, batches, pad_id=pad_id)
    assert te["tokens"] == je["tokens"]
    _close([te["loss"], te["perplexity"]], [je["loss"], je["perplexity"]])


def test_eval_turns_dropout_off(model):
    _, jcfg, tcfg, jp, tp, _, _ = model
    import dataclasses

    toks = np.arange(32, dtype=np.int32).reshape(2, 16) % 64
    drop = dataclasses.replace(tcfg, dropout=0.5)
    a = TT.make_eval_step(drop)(tp, torch.from_numpy(toks),
                                torch.from_numpy(toks))
    b = TT.make_eval_step(tcfg)(tp, torch.from_numpy(toks),
                                torch.from_numpy(toks))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="no tokens"):
        TT.evaluate(tp, tcfg, [])


# ------------------------------------------------------------------ decode


def test_decode_logits_match_jax_step_by_step(model):
    _, jcfg, tcfg, jp, tp, prompt, _ = model
    jc = JT.init_kv_cache(jcfg, 3)
    tc = TT.init_kv_cache(tcfg, 3, device="cpu")
    assert tc["pos"].dtype == torch.int32 and tc["pos"].dim() == 0
    jl, jc = JT.make_prefill(jcfg)(jp, jc, jnp.asarray(prompt))
    tl, tc = TT.make_prefill(tcfg)(tp, tc, torch.from_numpy(prompt))
    _close(tl, jl)
    jd, td = JT.make_decode_step(jcfg), TT.make_decode_step(tcfg)
    rng = np.random.default_rng(2)
    for _ in range(NEW):
        tok = rng.integers(0, 64, size=3).astype(np.int32)
        jl, jc = jd(jp, jc, jnp.asarray(tok))
        tl, tc = td(tp, tc, torch.from_numpy(tok))
        _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == P + NEW
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_cache_path_matches_full_forward(model):
    _, _, tcfg, _, tp, prompt, _ = model
    toks = torch.from_numpy(np.concatenate([prompt, prompt[:, ::-1]], 1))
    full = TT.forward(tp, toks, tcfg)
    cache = TT.init_kv_cache(tcfg, 3, device="cpu")
    logits, cache = TT.make_prefill(tcfg)(tp, cache, toks[:, :4])
    _close(logits, full[:, 3])
    step = TT.make_decode_step(tcfg)
    for t in range(4, toks.shape[1]):
        logits, cache = step(tp, cache, toks[:, t])
        _close(logits, full[:, t])


# ------------------------------------------------------------- generation


def test_greedy_generate_matches_jax(model):
    _, _, tcfg, _, tp, prompt, greedy = model
    out = TT.generate(tp, tcfg, prompt, max_new=NEW)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, greedy)
    on_dev = TT.make_generate(tcfg, NEW)(tp, prompt)
    assert on_dev.dtype == torch.int32
    np.testing.assert_array_equal(on_dev.numpy(), greedy)


def test_repetition_penalty_greedy_matches_jax(model):
    _, jcfg, tcfg, jp, tp, prompt, greedy = model
    j = np.asarray(JT.make_generate(jcfg, NEW, repetition_penalty=1.5)(
        jp, jnp.asarray(prompt), jax.random.key(0)))
    t = TT.make_generate(tcfg, NEW, repetition_penalty=1.5)(tp, prompt)
    np.testing.assert_array_equal(t.numpy(), j)
    assert not np.array_equal(j, greedy)      # the penalty moved something


def test_beam_search_matches_jax(model):
    _, jcfg, tcfg, jp, tp, prompt, greedy = model
    jt, js = JT.make_beam_search(jcfg, 5, 3)(jp, jnp.asarray(prompt))
    tt, ts = TT.make_beam_search(tcfg, 5, 3)(tp, prompt)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(ts, js)
    one, _ = TT.make_beam_search(tcfg, NEW, 1)(tp, prompt)
    np.testing.assert_array_equal(one[:, 0].numpy(), greedy)


def test_beam_search_exhaustive_matches_brute_force():
    """n_beams == vocab and max_new 2: the top beam is the best of all V^2
    continuations (the JAX package's own check), and JAX's beams agree."""
    kw = dict(vocab_size=8, n_layer=2, n_head=2, d_model=32, d_ff=64,
              max_seq=16)
    jcfg = JT.GPTConfig(dtype=jnp.float32, flash="off", remat=False, **kw)
    tcfg = TT.GPTConfig(dtype=torch.float32, flash="off", remat=False, **kw)
    jp = JT.init_params(jax.random.key(3), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    prompt = np.asarray([[1, 2, 3]], np.int32)
    toks, scores = TT.make_beam_search(tcfg, 2, 8)(tp, prompt)
    jt, js = JT.make_beam_search(jcfg, 2, 8)(jp, jnp.asarray(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    _close(scores, js)

    def seq_logp(t1, t2):
        ids = torch.tensor([[1, 2, 3, t1, t2]])
        lp = torch.log_softmax(TT.forward(tp, ids, tcfg), -1)
        return float(lp[0, 2, t1] + lp[0, 3, t2])

    best = max(((a, b, seq_logp(a, b)) for a, b in
                itertools.product(range(8), range(8))), key=lambda x: x[2])
    assert toks[0, 0, 3:].tolist() == list(best[:2])
    assert abs(float(scores[0, 0]) - best[2]) < 1e-4
    assert (np.diff(scores[0].numpy()) <= 1e-6).all()


# ---------------------------------------------------------------- sampling


def test_sample_logits_filters_by_property():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 50, generator=g) * 3
    top = logits.argmax(-1)
    assert torch.equal(TT.sample_logits(logits).long(), top)
    draws = torch.stack([TT.sample_logits(logits, g, 0.7, top_k=5)
                         for _ in range(20)]).long()
    kth = torch.topk(logits, 5, -1).values[:, -1]
    assert (logits.gather(1, draws.T) >= kth[:, None]).all()
    # top-p: every draw inside the smallest prefix of the sorted
    # probabilities whose mass reaches p (the top token always kept)
    draws = torch.stack([TT.sample_logits(logits, g, 1.0, top_p=0.5)
                         for _ in range(20)]).long()
    srt, order = torch.sort(logits, -1, descending=True)
    probs = torch.softmax(srt, -1)
    keep_n = ((torch.cumsum(probs, -1) - probs) < 0.5).sum(-1)
    rank = (order[:, None, :] == draws.T[:, :, None]).float().argmax(-1)
    assert (rank < keep_n[:, None]).all()
    # min-p: every draw's probability is >= min_p x the top one's
    draws = torch.stack([TT.sample_logits(logits, g, 1.0, min_p=0.3)
                         for _ in range(20)]).long()
    p = torch.softmax(logits, -1)
    assert (p.gather(1, draws.T) >= 0.3 * p.amax(-1, keepdim=True)).all()
    # a flat row spreads its draws
    flat = torch.zeros(1, 50)
    seen = {int(TT.sample_logits(flat, g, 1.0)) for _ in range(200)}
    assert len(seen) > 30


def test_seeded_sampling_repeats(model):
    _, _, tcfg, _, tp, prompt, _ = model
    gen = TT.make_generate(tcfg, NEW, temperature=0.8, top_k=10, top_p=0.9,
                           min_p=0.05)
    a = gen(tp, prompt, torch.Generator().manual_seed(5))
    b = gen(tp, prompt, torch.Generator().manual_seed(5))
    c = gen(tp, prompt, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :P], torch.from_numpy(prompt))


def test_generation_refuses_what_it_cannot_run(model):
    _, _, tcfg, _, tp, prompt, _ = model
    with pytest.raises(ValueError, match="max_seq"):
        TT.generate(tp, tcfg, prompt, max_new=BASE["max_seq"])
    with pytest.raises(ValueError, match="max_seq"):
        TT.make_generate(tcfg, BASE["max_seq"])(tp, prompt)
