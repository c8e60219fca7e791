"""The BERT encoder in the port (neuronika_tpu_torch/models/bert.py: the GPT
body with causal=False) against the JAX package on the CPU in f32: `encode`
against JAX's composite and JAX's packed Pallas path (interpret mode), the
masked-LM loss and gradients and one MLM Adam step from the same
corruption, three classifier steps, pooling, the decoding guard, and
`mask_tokens` by its contract (its draws cannot match JAX's bits). Params
come from the JAX tree through `params_from_jax`; tokens from numpy."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.config import config as jax_config
from neuronika_tpu.models import bert as JB
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import bert as TB
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _tree_err)

SMALL = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
             max_seq=128)


def _cfgs(jflash="off", tflash="auto", **kw):
    base = dict(SMALL)
    base.update(kw)
    return (JB.bert_config(dtype=jnp.float32, flash=jflash, **base),
            TB.bert_config(dtype=torch.float32, flash=tflash, **base))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"] - 1, size=(B, S), dtype=np.int32)


@pytest.fixture
def interpret():
    """JAX's Pallas kernels in interpret mode, as its CPU tests run them."""
    old = jax_config.pallas_interpret
    jax_config.pallas_interpret = True
    yield
    jax_config.pallas_interpret = old


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_encode_matches_jax_composite(flash):
    """The port's packed flash op without a causal mask (its plain version
    on the CPU) and its composite, against JAX's composite."""
    jcfg, tcfg = _cfgs(tflash=flash)
    jp, tp = _params(jcfg)
    toks = _tokens()
    want = np.asarray(JB.encode(jp, jnp.asarray(toks), jcfg))
    got = TB.encode(tp, torch.from_numpy(toks), tcfg)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_encode_matches_jax_pallas_path(interpret):
    """JAX's packed non-causal Pallas forward (K1 in interpret mode, 64-row
    tiles over S128), against the port's packed op."""
    jcfg, tcfg = _cfgs("on", flash_block=64)
    jp, tp = _params(jcfg)
    toks = _tokens(S=128, seed=1)
    want = np.asarray(JB.encode(jp, jnp.asarray(toks), jcfg))
    got = TB.encode(tp, torch.from_numpy(toks), tcfg)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_position_zero_sees_the_future():
    _, tcfg = _cfgs()
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.from_numpy(_tokens())
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % SMALL["vocab_size"]
    h, h2 = TB.encode(tp, toks, tcfg), TB.encode(tp, toks2, tcfg)
    assert float((h[:, 0] - h2[:, 0]).abs().max()) > 1e-6


def _jax_corruption(key, toks, mask_id):
    c, l, w = JB.mask_tokens(key, jnp.asarray(toks), mask_id,
                             SMALL["vocab_size"], 0.15)
    return np.array(c), np.array(l), np.array(w)


def test_mlm_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    c, l, w = _jax_corruption(jax.random.key(3), _tokens(B=4), 63)
    assert 0 < w.sum() < w.size
    jloss, jgrads = jax.value_and_grad(JB.mlm_loss_fn)(
        jp, jnp.asarray(c), jnp.asarray(l), jnp.asarray(w), jcfg, train=True)

    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    got = TB.mlm_loss_fn(tree_unflatten(tp, leaves), torch.from_numpy(c),
                         torch.from_numpy(l), torch.from_numpy(w), tcfg,
                         train=True)
    got.backward()
    grads = tree_unflatten(tp, [t.grad for t in leaves])
    assert abs(float(got.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


def test_mlm_train_step_matches_jax(monkeypatch):
    """One `make_mlm_train_step` Adam step from JAX's corruption: the
    port's `mask_tokens` is replaced by the corruption JAX's step draws
    (its key's first half), so both steps see the same positions."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(B=4)
    key = jax.random.key(7)
    c, l, w = _jax_corruption(jax.random.split(key)[0], toks, 63)
    monkeypatch.setattr(TB, "mask_tokens", lambda *a, **k: (
        torch.from_numpy(c), torch.from_numpy(l), torch.from_numpy(w)))
    jp, _, jloss = JB.make_mlm_train_step(jcfg)(
        jp, JT.adam_init(jp), jnp.asarray(toks), jnp.float32(LR), key)
    tp, _, loss = TB.make_mlm_train_step(tcfg)(
        tp, TF.adam_init(tp), torch.from_numpy(toks), LR,
        torch.Generator().manual_seed(0))
    assert abs(float(loss) - float(jloss)) <= TOL
    _adam_params_close(tp, jp, 1)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_classifier_steps_match_jax(pooling):
    """Three `make_classifier_train_step` steps of the encoder and head
    under one Adam state: the loss each step, the params and head after."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jhead = JB.init_classifier(jax.random.key(2), jcfg, 3)
    head = TT.params_from_jax(jax.tree.map(np.asarray, jhead))
    toks = _tokens(B=4)
    labels = np.array([0, 1, 2, 1], np.int32)
    jstep = JB.make_classifier_train_step(jcfg, 3, pooling=pooling)
    tstep = TB.make_classifier_train_step(tcfg, 3, pooling=pooling)
    jopt, opt = JT.adam_init((jp, jhead)), TF.adam_init([tp, head])
    for i in range(3):
        jp, jhead, jopt, jl = jstep(jp, jhead, jopt, jnp.asarray(toks),
                                    jnp.asarray(labels), jnp.float32(LR),
                                    jax.random.key(i))
        tp, head, opt, tl = tstep(tp, head, opt, torch.from_numpy(toks),
                                  torch.from_numpy(labels), LR)
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(tp, jp, 3)
    _adam_params_close(head, jhead, 3)


def test_pool_modes_and_init_classifier():
    h = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(
        np.float32)
    for mode in ("mean", "cls"):
        np.testing.assert_allclose(
            TB.pool(torch.from_numpy(h), mode).numpy(),
            np.asarray(JB.pool(jnp.asarray(h), mode)), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="pooling"):
        TB.pool(torch.from_numpy(h), "max")
    head = TB.init_classifier(torch.Generator().manual_seed(0),
                              _cfgs()[1], 3, device="cpu")
    assert head["w"].shape == (64, 3) and not head["b"].any()


def test_decoding_guard():
    """An encoder refuses the KV-cache entry points, as JAX's does."""
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="causal"):
        TT.make_decode_step(tcfg)
    with pytest.raises(ValueError, match="causal"):
        TT.make_generate(tcfg, max_new=4)


def test_mask_tokens_contract():
    """256 x 256 tokens below the mask id, rate 0.15 (N = 65536
    positions). Each bound is 5 binomial standard deviations: the selected
    share within 5 sqrt(r (1 - r) / N) of r; among the n selected, the
    masked share within 5 sqrt(0.16 / n) of 0.8, the changed-to-another-
    token share within 5 sqrt(0.09 / n) of 0.1 (1 - 1/V) and the unchanged
    share within 5 sqrt(0.09 / n) of 0.1 + 0.1 / V. Labels are the tokens;
    weights are 1 exactly at the selected positions and nothing outside
    them changes."""
    V, mask_id, rate = 1000, 999, 0.15
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, V - 1, size=(256, 256)))
    c, labels, w = TB.mask_tokens(torch.Generator().manual_seed(5), toks,
                                  mask_id, V, rate)
    assert torch.equal(labels, toks) and w.dtype == torch.float32
    assert set(w.unique().tolist()) <= {0.0, 1.0}
    sel = w.bool()
    N, n = toks.numel(), int(sel.sum())
    assert abs(n / N - rate) <= 5 * math.sqrt(rate * (1 - rate) / N)
    assert torch.equal(c[~sel], toks[~sel])
    masked = float((c[sel] == mask_id).float().mean())
    changed = float(((c[sel] != mask_id) & (c[sel] != toks[sel])).float()
                    .mean())
    kept = float((c[sel] == toks[sel]).float().mean())
    assert abs(masked - 0.8) <= 5 * math.sqrt(0.16 / n)
    assert abs(changed - 0.1 * (1 - 1 / V)) <= 5 * math.sqrt(0.09 / n)
    assert abs(kept - (0.1 + 0.1 / V)) <= 5 * math.sqrt(0.09 / n)
    assert int(c.min()) >= 0 and int(c.max()) < V
