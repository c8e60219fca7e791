"""The GPT's mixture-of-experts MLP in the port (neuronika_tpu_torch/models/
transformer.py: `_moe_mlp` and its dense, sparse and sort dispatch; "ep"
runs the sparse one without a mesh) against the JAX package on the CPU in
f32: logits, loss (with the Switch aux loss) and gradients per `moe_impl`
with and without dropped tokens, the aux loss itself, three Adam steps,
decode logits (a single-token step never drops), `PagedBatcher` and
`generate` greedy tokens, a bias-free model and the errors. Params come
from the JAX tree through `params_from_jax`; tokens from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu import serving as JS
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import serving as TS
from neuronika_tpu_torch.models import transformer as TT
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _port_grads, _tree_err)

# 4 experts, d64 H4 (hd 16), L2; 2 x 16 tokens: capacity 2.0 keeps every
# token, 0.5 keeps 4 of each expert's (tokens drop), 0.25 keeps 2
SMALL = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=96,
             max_seq=32, n_experts=4)
IMPLS = ("dense", "sparse", "sort", "ep")


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return (JT.GPTConfig(dtype=jnp.float32, flash="off", **base),
            TT.GPTConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab_size"], size=(B, S), dtype=np.int32)
    return toks, np.roll(toks, -1, axis=1)


def test_init_params_build_the_jax_tree():
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert TT.tree_map(lambda t: tuple(t.shape), tp) == shapes
    assert tp["blocks"]["fc_in"].shape == (2, 4, 64, 96)
    assert tp["blocks"]["gate"].shape == (2, 64, 4)


@pytest.mark.parametrize("capacity", [2.0, 0.5], ids=["full", "overflow"])
@pytest.mark.parametrize("impl", IMPLS)
def test_logits_loss_and_grads_match_jax(impl, capacity):
    """With remat and the aux loss at weight 0.01: the logits, the loss and
    every gradient leaf, the gate's included."""
    jcfg, tcfg = _cfgs(moe_impl=impl, moe_capacity=capacity,
                       moe_aux_weight=0.01)
    jp, tp = _params(jcfg)
    toks, tgts = _batch()
    jlog = JT.forward(jp, jnp.asarray(toks), jcfg)
    tlog = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert float(np.abs(tlog.numpy() - np.asarray(jlog)).max()) <= TOL
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_aux_loss_matches_jax(impl):
    jcfg, tcfg = _cfgs(moe_impl=impl, moe_capacity=0.5)
    jp, tp = _params(jcfg)
    toks, _ = _batch(seed=1)
    _, jaux = JT.hidden_states(jp, jnp.asarray(toks), jcfg)
    _, aux = TT._hidden_aux(tp, torch.from_numpy(toks), tcfg)
    assert abs(float(aux) - float(jaux)) <= TOL
    assert float(aux) >= 1.0 - 1e-6       # E sum f P >= 1 by Cauchy-Schwarz


def test_tokens_drop_where_jax_drops_them():
    """At capacity 0.25 the sparse and sort dispatch keep the same tokens
    (position order within an expert) and agree exactly with each other;
    at full capacity both equal the dense dispatch."""
    toks, _ = _batch(seed=2)
    x = torch.from_numpy(toks)
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    outs = {}
    for impl in ("sparse", "sort"):
        for cap in (8.0, 0.25):
            cfg = TT.GPTConfig(dtype=torch.float32, moe_impl=impl,
                               moe_capacity=cap, **SMALL)
            outs[impl, cap] = TT.forward(tp, x, cfg)
    dense = TT.forward(tp, x, tcfg)
    assert torch.equal(outs["sparse", 0.25], outs["sort", 0.25])
    assert float((outs["sparse", 8.0] - dense).abs().max()) <= TOL
    assert float((outs["sort", 8.0] - dense).abs().max()) <= TOL
    assert float((outs["sort", 0.25] - dense).abs().max()) > 1e-3


def test_train_steps_match_jax():
    """Three `make_train_step` Adam steps, sort dispatch with dropped
    tokens, aux weight 0.01: the loss each step, the params and the first
    moments after."""
    jcfg, tcfg = _cfgs(moe_impl="sort", moe_capacity=1.0,
                       moe_aux_weight=0.01)
    jp, tp = _params(jcfg)
    jstep, tstep = JT.make_train_step(jcfg), TT.make_train_step(tcfg)
    jopt, topt = JT.opt_init(jp, jcfg), TT.opt_init(tp, tcfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        toks, tgts = _batch(B=4, seed=i)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts),
                             jnp.float32(LR), jax.random.key(i))
        tp, topt, tl = tstep(tp, topt, torch.from_numpy(toks),
                             torch.from_numpy(tgts), LR, gen)
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(tp, jp, 3)
    assert _tree_err(topt["m"], jopt["m"]) <= GRAD_TOL


def test_decode_never_drops_tokens():
    """JAX's test_moe_decode_never_drops_tokens: at B8 a decode step's
    capacity would count over the batch, so every impl decodes by the
    dense routing; the three impls' logits agree within 1e-6 and match
    JAX's decode step by step."""
    base = dict(vocab_size=24, n_layer=2, n_head=2, d_model=32, d_ff=64,
                max_seq=10, n_experts=4)
    jcfg = JT.GPTConfig(dtype=jnp.float32, **base)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(1).integers(0, 24, size=(8, 6),
                                             dtype=np.int32)
    jdec = JT.make_decode_step(jcfg)
    jcache = JT.init_kv_cache(jcfg, 8)
    for t in range(6):
        jlog, jcache = jdec(jp, jcache, jnp.asarray(toks[:, t]))
    outs = {}
    for impl in ("dense", "sparse", "sort"):
        cfg = TT.GPTConfig(dtype=torch.float32, moe_impl=impl,
                           moe_capacity=0.25, **base)
        decode = TT.make_decode_step(cfg)
        cache = TT.init_kv_cache(cfg, 8, device="cpu")
        for t in range(6):
            logits, cache = decode(tp, cache, torch.from_numpy(toks[:, t]))
        outs[impl] = logits
    assert float((outs["sparse"] - outs["dense"]).abs().max()) <= 1e-6
    assert float((outs["sort"] - outs["dense"]).abs().max()) <= 1e-6
    assert float(np.abs(outs["dense"].numpy() - np.asarray(jlog)).max()) \
        <= TOL


@pytest.mark.parametrize("impl", ["dense", "sort"])
def test_greedy_tokens_match_jax(impl):
    """`PagedBatcher` (prefill through `moe_impl`, dropping tokens at
    capacity 0.5 as JAX's prefill does; decode by the dense routing) and
    `generate`: the same greedy tokens as JAX's."""
    jcfg, tcfg = _cfgs(moe_impl=impl, moe_capacity=0.5)
    jp, tp = _params(jcfg)
    prompts = [np.array([1, 2, 3, 4, 5, 6], np.int32),
               np.array([7, 8], np.int32),
               np.array([9, 10, 11, 12, 13, 14, 15, 16, 17], np.int32)]
    news = [8, 5, 6]
    jb = JS.PagedBatcher(jp, jcfg, n_slots=2, n_blocks=16, block_size=8,
                         kernel="off")
    jr = [jb.submit(p, m) for p, m in zip(prompts, news)]
    jout = jb.run()
    tb = TS.PagedBatcher(tp, tcfg, n_slots=2, n_blocks=16, block_size=8,
                         device="cpu")
    tr = [tb.submit(p, m) for p, m in zip(prompts, news)]
    tout = tb.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tout[b], jout[a])
    prompt = np.stack([prompts[0], prompts[0][::-1]])
    np.testing.assert_array_equal(
        TT.generate(tp, tcfg, prompt, 8),
        np.asarray(JT.generate(jp, jcfg, jnp.asarray(prompt), 8)))


def test_bias_free_llama_moe_matches_jax():
    """bias=False with rope, RMSNorm and an untied head (the llama stack
    with GELU experts): the loss and the gradients; no *_b leaves."""
    base = dict(SMALL, n_kv_head=2, moe_impl="sparse", moe_capacity=1.0)
    jcfg = JT.llama_config(dtype=jnp.float32, flash="off", mlp="gelu",
                           **base)
    tcfg = TT.llama_config(dtype=torch.float32, mlp="gelu", **base)
    jp, tp = _params(jcfg)
    assert not any(k.endswith("_b") for k in tp["blocks"])
    toks, tgts = _batch(seed=3)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


def test_swiglu_experts_and_bad_impl_raise():
    with pytest.raises(ValueError, match="swiglu"):
        TT.init_params(torch.Generator(), TT.llama_config(
            dtype=torch.float32, **SMALL), "cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        TT.GPTConfig(moe_impl="scatter", **SMALL)
