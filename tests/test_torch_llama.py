"""The llama/Mistral stack of the port (neuronika_tpu_torch/models/
transformer.py: `llama_config`, `mistral_config`; rotary positions,
RMSNorm, SwiGLU, no biases, an untied head, GQA and a sliding window)
against the JAX package on the CPU in f32: the loss and its gradients with
JAX's split flash path (K5-K7 in interpret mode) and with both composite
paths, 3 Adam steps, each variant on its own, and the greedy tokens of
`PagedBatcher` with rotary keys in the cache. Params come from the JAX
tree through `params_from_jax`; tokens from numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu import serving as JS
from neuronika_tpu.config import config as jax_config
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import serving as TS
from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import transformer as TT
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _batch, _port_grads, _tree_err)

# d128, 4 heads over 2 kv heads (hd 32), L 2; JAX's flash tiles of 16 rows
# cut the 64-token sequence into 4, so its band loops run; the window
# (Mistral) is 16 < S
SMALL = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=128,
             d_ff=192, max_seq=64, flash_block=16)
PRESETS = {"llama": {}, "mistral": dict(window=16)}


def _cfgs(preset, jflash="off", **kw):
    base = dict(SMALL, **PRESETS[preset])
    base.update(kw)
    return (JT.llama_config(dtype=jnp.float32, flash=jflash, **base),
            TT.llama_config(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def interpret():
    """JAX's Pallas kernels in interpret mode, as its CPU tests run them."""
    old = jax_config.pallas_interpret
    jax_config.pallas_interpret = True
    yield
    jax_config.pallas_interpret = old


def test_presets_build_the_jax_tree():
    """The same fields and the same param structure as JAX's presets."""
    for name, fn in (("llama", "llama_config"), ("mistral",
                                                 "mistral_config")):
        jcfg = getattr(JT, fn)(**SMALL)
        tcfg = getattr(TT, fn)(**SMALL)
        for f in ("pos_emb", "rope_theta", "norm", "mlp", "bias",
                  "tied_head", "window"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)
        jp, _ = _params(jcfg)
        tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        assert tree_unflatten(tp, [tuple(t.shape) for t in tree_leaves(tp)]
                              ) == shapes, name


@pytest.mark.parametrize("jflash", ["on", "off"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_loss_and_grads_match_jax(preset, jflash, interpret):
    """The port's split flash op (plain K5-K7 on the CPU) and its
    composite, against JAX's split flash path (K5-K7 in interpret mode,
    jflash="on") or its composite: loss and every gradient, with remat."""
    jcfg, tcfg = _cfgs(preset, jflash)
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=64)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    for flash in ("auto", "off"):
        loss, grads = _port_grads(tp, dataclasses.replace(tcfg, flash=flash),
                                  toks, tgts)
        assert abs(float(loss.detach()) - float(jloss)) <= TOL, flash
        assert _tree_err(grads, jgrads) <= GRAD_TOL, flash


@pytest.mark.parametrize("preset", list(PRESETS))
def test_three_adam_steps_match_jax(preset, interpret):
    """3 steps of make_train_step on each side, JAX through K5-K7 in
    interpret mode: the losses, the params (within 2 LR per step, see
    `_adam_params_close`) and the first moments."""
    jcfg, tcfg = _cfgs(preset, "on")
    jp, tp = _params(jcfg, seed=1)
    jstep, tstep = JT.make_train_step(jcfg), TT.make_train_step(tcfg)
    jopt, topt = JT.opt_init(jp, jcfg), TT.opt_init(tp, tcfg)
    for i in range(3):
        toks, tgts = _batch(jcfg, B=2, S=64, seed=i)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts),
                             jnp.float32(LR), jax.random.key(i))
        tp, topt, tl = tstep(tp, topt, torch.from_numpy(toks),
                             torch.from_numpy(tgts), LR)
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(tp, jp, 3)
    assert _tree_err(topt["m"], jopt["m"]) <= GRAD_TOL


# each variant alone on the GPT-2 stack (learned positions, LayerNorm,
# GELU, tied head otherwise)
VARIANTS = {"rope": dict(pos_emb="rope"), "rms": dict(norm="rms"),
            "swiglu": dict(mlp="swiglu"), "untied": dict(tied_head=False)}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_single_variant_matches_jax(name):
    """The port's default flash path (the split op under rope, else the
    packed op; plain versions on the CPU) against JAX's composite."""
    kw = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
              max_seq=48, **VARIANTS[name])
    jcfg = JT.GPTConfig(dtype=jnp.float32, flash="off", **kw)
    tcfg = TT.GPTConfig(dtype=torch.float32, **kw)
    jp, tp = _params(jcfg)
    assert sorted(tp) == sorted(jp)
    toks, tgts = _batch(jcfg, S=32)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


def _prompts():
    # the requests of tests/test_models.py::TestPagedBatcher
    return ([np.array([1, 2, 3, 4], np.int32), np.array([7, 8], np.int32),
             np.array([9, 10, 11, 12, 13, 14, 15, 16], np.int32)],
            [10, 4, 7])


@pytest.mark.parametrize("port_kernel", ["auto", "off"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_paged_batcher_greedy_tokens_match_jax(preset, port_kernel):
    """Rotary q/k at each token's position, keys cached after rotation,
    GQA (and Mistral's window 6 over a 48-token context): the port's
    PagedBatcher, with the paged kernel's plain version or the gather
    path, gives JAX's greedy tokens (JAX's gather path, f32)."""
    kw = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
              d_ff=96, max_seq=48)
    if preset == "mistral":
        kw["window"] = 6
    jcfg = JT.llama_config(dtype=jnp.float32, flash="off", **kw)
    tcfg = TT.llama_config(dtype=torch.float32, **kw)
    jp, tp = _params(jcfg, seed=2)
    prompts, max_news = _prompts()
    pool = dict(n_slots=2, n_blocks=16, block_size=8)
    jb = JS.PagedBatcher(jp, jcfg, kernel="off", **pool)
    jr = [jb.submit(p, m) for p, m in zip(prompts, max_news)]
    jout = jb.run()
    tb = TS.PagedBatcher(tp, tcfg, kernel=port_kernel, device="cpu", **pool)
    tr = [tb.submit(p, m) for p, m in zip(prompts, max_news)]
    tout = tb.run()
    for a, b, m in zip(jr, tr, max_news):
        assert tout[b].shape == (m,)
        np.testing.assert_array_equal(tout[b], jout[a])


def test_flops_per_token_matches_jax_for_mistral_7b():
    """JAX's count, kept as is (it counts neither SwiGLU's third matrix,
    nor GQA's narrower qkv, nor the window band)."""
    kw = dict(vocab_size=32000, n_layer=32, n_head=32, n_kv_head=8,
              d_model=4096, d_ff=14336, max_seq=8192)
    assert TT.flops_per_token(TT.mistral_config(**kw), 8192) == \
        JT.flops_per_token(JT.mistral_config(**kw), 8192)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(PRESETS))
def test_kernel_route_matches_plain_route_on_gpu(cuda, preset):
    """f32, hd 128, GQA, window 48 < S 128 for Mistral: the loss and
    gradients through K5-K7 equal the composite route's (flash="off") on
    the card, and each layer launches K5, K6 and K7 once (no remat)."""
    from neuronika_tpu_torch.ops import flash_attention as FA

    jcfg, tcfg = _cfgs(preset, vocab_size=128, n_layer=2, n_head=2,
                       n_kv_head=1, d_model=256, d_ff=512, max_seq=128,
                       remat=False, **({"window": 48} if preset == "mistral"
                                        else {}))
    jp, _ = _params(jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), cuda)
    toks, tgts = (torch.from_numpy(a).to(cuda)
                  for a in _batch(jcfg, S=128))
    runs = {}
    for flash in ("on", "off"):
        cfg = dataclasses.replace(tcfg, flash=flash)
        before = [k.launches for k in FA.SPLIT_KERNELS]
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        loss = TT.loss_fn(tree_unflatten(tp, leaves), toks, tgts, cfg,
                          train=True)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[flash] = (float(loss.detach()), grads,
                       [k.launches - b for k, b in zip(FA.SPLIT_KERNELS,
                                                       before)])
    assert runs["on"][2] == [2, 2, 2] and runs["off"][2] == [0, 0, 0]
    assert abs(runs["on"][0] - runs["off"][0]) <= TOL
    assert max(float((a - b).abs().max())
               for a, b in zip(runs["on"][1], runs["off"][1])) <= GRAD_TOL
