"""The encoder-decoder in the port (neuronika_tpu_torch/models/t5.py) against
the JAX package on the CPU in f32: `forward` against JAX's composite and
against JAX's split flash path (K5 in interpret mode, the decoder's causal
self-attention at Sq = Skv and its cross-attention at Sq != Skv), the loss
with `pad_id` and its gradients, three Adam steps, `greedy_generate`'s
tokens, decoder causality, cross-attention reading the source and the
encoder's memory reused. Params come from the JAX tree through
`params_from_jax`; tokens from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.config import config as jax_config
from neuronika_tpu.models import t5 as J5
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import t5 as T5
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _tree_err)

# d32 H2 (hd 16), 2 + 2 layers; source 24, target 16 (Sq != Skv)
SMALL = dict(vocab_size=40, n_layer=2, n_head=2, d_model=32, d_ff=64,
             max_src=64, max_tgt=32)
BOS, EOS, PAD = 38, 39, 37


def _cfgs(jflash="off", tflash="auto", **kw):
    base = dict(SMALL)
    base.update(kw)
    return (J5.Seq2SeqConfig(dtype=jnp.float32, flash=jflash, **base),
            T5.Seq2SeqConfig(dtype=torch.float32, flash=tflash, **base))


def _params(jcfg, seed=0):
    jp = J5.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(B=2, Ss=24, St=16, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 37, size=(B, Ss), dtype=np.int32)
    tgt_in = rng.integers(0, 37, size=(B, St), dtype=np.int32)
    tgt_out = np.roll(tgt_in, -1, axis=1)
    tgt_out[:, St // 2 + 3:] = PAD
    return src, tgt_in, tgt_out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def interpret():
    """JAX's Pallas kernels in interpret mode, as its CPU tests run them."""
    old = jax_config.pallas_interpret
    jax_config.pallas_interpret = True
    yield
    jax_config.pallas_interpret = old


def test_init_params_build_the_jax_tree():
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    tp = T5.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == TT.tree_map(
        lambda t: tuple(t.shape), tp)


@pytest.mark.parametrize("tflash", ["auto", "off"])
def test_forward_matches_jax_composite(tflash):
    """The port's split flash op (plain K5 on the CPU) and its composite
    against JAX's composite: f32 logits at source 24, target 16."""
    jcfg, tcfg = _cfgs(tflash=tflash)
    jp, tp = _params(jcfg)
    src, tgt, _ = _batch()
    want = np.asarray(J5.forward(jp, jnp.asarray(src), jnp.asarray(tgt),
                                 jcfg))
    got = T5.forward(tp, *_t(src, tgt), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 40)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_forward_matches_jax_flash_path(interpret):
    """JAX's flash="on" runs its split K5 in interpret mode in the
    decoder (16-row tiles: causal self-attention at S32, cross-attention
    at Sq 32 over Skv 64) and the packed K1 in the encoder."""
    jcfg, tcfg = _cfgs("on", flash_block=16)
    jp, tp = _params(jcfg)
    src, tgt, _ = _batch(Ss=64, St=32, seed=1)
    want = np.asarray(J5.forward(jp, jnp.asarray(src), jnp.asarray(tgt),
                                 jcfg))
    got = T5.forward(tp, *_t(src, tgt), tcfg)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


@pytest.mark.parametrize("pad_id", [None, PAD], ids=["no-pad", "pad"])
def test_loss_and_grads_match_jax(pad_id):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    src, ti, to = _batch(seed=2)
    jloss, jgrads = jax.value_and_grad(J5.loss_fn)(
        jp, jnp.asarray(src), jnp.asarray(ti), jnp.asarray(to), jcfg,
        pad_id=pad_id, train=True)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    loss = T5.loss_fn(tree_unflatten(tp, leaves), *_t(src, ti, to), tcfg,
                      pad_id=pad_id, train=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(tree_unflatten(tp, [t.grad for t in leaves]),
                     jgrads) <= GRAD_TOL


def test_train_steps_match_jax():
    """Three `make_train_step` Adam steps with clipping and `pad_id`: the
    loss each step, the params after."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jstep = J5.make_train_step(jcfg, pad_id=PAD, grad_clip=1.0)
    tstep = T5.make_train_step(tcfg, pad_id=PAD, grad_clip=1.0)
    jopt, opt = JT.adam_init(jp), TF.adam_init(tp)
    for i in range(3):
        src, ti, to = _batch(seed=10 + i)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(src), jnp.asarray(ti),
                             jnp.asarray(to), jnp.float32(LR),
                             jax.random.key(i))
        tp, opt, tl = tstep(tp, opt, *_t(src, ti, to), LR)
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(tp, jp, 3)


def test_greedy_generate_matches_jax():
    """After 30 steps on a copy task (so the tokens are not all one), the
    greedy tokens of both, with an end token, are identical."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jstep = J5.make_train_step(jcfg)
    jopt = JT.adam_init(jp)
    rng = np.random.default_rng(0)
    for i in range(30):
        src = rng.integers(0, 37, size=(8, 6)).astype(np.int32)
        ti = np.concatenate([np.full((8, 1), BOS, np.int32), src], 1)
        to = np.concatenate([src, np.full((8, 1), EOS, np.int32)], 1)
        jp, jopt, _ = jstep(jp, jopt, jnp.asarray(src), jnp.asarray(ti),
                            jnp.asarray(to), jnp.float32(3e-3),
                            jax.random.key(i))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    src = rng.integers(0, 37, size=(3, 6)).astype(np.int32)
    want = J5.greedy_generate(jp, jnp.asarray(src), jcfg, bos_id=BOS,
                              eos_id=EOS, max_new=9)
    got = T5.greedy_generate(tp, src, tcfg, bos_id=BOS, eos_id=EOS,
                             max_new=9)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) > 1


def test_decoder_is_causal_and_reads_the_source():
    _, tcfg = _cfgs()
    tp = T5.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    src, tgt, _ = _t(*_batch(seed=3))
    a = T5.forward(tp, src, tgt, tcfg)
    tgt2 = tgt.clone()
    tgt2[:, -1] = (tgt2[:, -1] + 1) % 40
    b = T5.forward(tp, src, tgt2, tcfg)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-6
    src2 = src.clone()
    src2[:, 0] = (src2[:, 0] + 1) % 40
    c = T5.forward(tp, src2, tgt, tcfg)
    assert float((a - c).abs().max()) > 1e-6       # every position reads it
    mem = T5.encode(tp, src, tcfg)
    assert torch.equal(T5.forward(tp, None, tgt, tcfg, memory=mem), a)


def test_decoder_dropout_needs_a_generator_and_is_off_in_eval():
    _, tcfg = _cfgs(dropout=0.5)
    tp = T5.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    src, tgt, _ = _t(*_batch(seed=4))
    with pytest.raises(ValueError, match="generator"):
        T5.forward(tp, src, tgt, tcfg, train=True)
    g = torch.Generator().manual_seed(1)
    a = T5.forward(tp, src, tgt, tcfg, train=True, generator=g)
    b = T5.forward(tp, src, tgt, tcfg, train=True, generator=g)
    assert float((a - b).abs().max()) > 1e-6
    assert torch.equal(T5.forward(tp, src, tgt, tcfg),
                       T5.forward(tp, src, tgt, tcfg))
