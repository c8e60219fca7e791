"""The Vision Transformer in the port (neuronika_tpu_torch/models/vit.py,
plain PyTorch: JAX's ViT reaches no Pallas kernel) against the JAX package
on the CPU: `_patchify` exactly, logits, loss and gradients in f32, three
Adam steps, and a bf16 step (weights stored in bf16, as JAX's) finite.
Params come from the JAX tree through `params_from_jax`; images from
numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import vit as JV
from neuronika_tpu.optim import functional as JF
from neuronika_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.models import vit as TV
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _tree_err)

SMALL = dict(image=16, patch=4, d_model=64, n_layer=2, n_head=2, d_ff=128,
             num_classes=5)


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return (JV.ViTConfig(dtype=jnp.float32, **base),
            TV.ViTConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = JV.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, 16, 16, 3)).astype(np.float32)
    return x, rng.integers(0, 5, B).astype(np.int32)


def _dicts(tree):
    """The tree with its lists (the ViT's blocks) as dicts keyed by
    position, for test_torch_train's dict-walking comparisons."""
    if isinstance(tree, (list, dict)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {str(k): _dicts(v) for k, v in items}
    return tree


def test_patchify_is_exact():
    jcfg, tcfg = _cfgs(image=8)
    x = np.random.default_rng(0).uniform(size=(2, 8, 8, 3)).astype(
        np.float32)
    got = TV._patchify(torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(JV._patchify(
        jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(got[0, 1], x[0, :4, 4:, :].reshape(-1))


def test_init_params_build_the_jax_tree():
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    tp = TV.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), jp) == \
        tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)


def test_logits_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x, y = _batch()
    want = np.asarray(JV.forward(jp, jnp.asarray(x), jcfg))
    got = TV.forward(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    jloss, jgrads = jax.value_and_grad(JV.loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    loss = TV.loss_fn(tree_unflatten(tp, leaves), torch.from_numpy(x),
                      torch.from_numpy(y), tcfg)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(_dicts(tree_unflatten(tp, [t.grad for t in leaves])),
                     _dicts(jgrads)) <= GRAD_TOL


def test_train_steps_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jstep, tstep = JV.make_train_step(jcfg), TV.make_train_step(tcfg)
    jopt, opt = JF.adam_init(jp), TF.adam_init(tp)
    for i in range(3):
        x, y = _batch(seed=i)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y),
                             jnp.float32(LR))
        tp, opt, tl = tstep(tp, opt, torch.from_numpy(x),
                            torch.from_numpy(y), LR)
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(_dicts(tp), _dicts(jp), 3)


def test_bf16_step_is_finite():
    """bf16 storage and products, f32 scores, statistics and logits, as
    JAX's dtype rules: five steps on one batch stay finite and fall."""
    tcfg = TV.ViTConfig(dtype=torch.bfloat16, **SMALL)
    tp = TV.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert tp["blocks"][0]["qkv"].dtype == torch.bfloat16
    assert tp["ln_f"]["scale"].dtype == torch.float32
    step, opt = TV.make_train_step(tcfg), TF.adam_init(tp)
    x, y = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(5):
        tp, opt, loss = step(tp, opt, x, y, 1e-3)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
