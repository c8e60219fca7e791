"""The ResNet of the port (neuronika_tpu_torch/models/resnet.py) against
the JAX package's on the CPU in f32, at stages (1, 1) and width 8 with
both stems: logits, loss and every gradient for conv_impl "xla" (the
library convolution against lax's) and "pallas" (K12/K13's plain versions
against JAX's Pallas kernels in interpret mode), 3 SGD steps of
`make_train_step`, GroupNorm's batch independence and the params tree.
Params come from the JAX tree through `params_from_jax`; images and labels
from numpy. On the card: one train step with K12/K13's launches counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.config import config as jax_config
from neuronika_tpu.models import resnet as JR
from neuronika_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten
from neuronika_tpu_torch.models import resnet as TR
from neuronika_tpu_torch.ops import conv as TC
from tests.conftest import TOL

GRAD_TOL = 1e-4
SMALL = dict(stages=(1, 1), width=8, num_classes=10)
SIZE = {"cifar": 16, "imagenet": 32}


@pytest.fixture
def interpret():
    """JAX's Pallas kernels in interpret mode, as its CPU tests run them."""
    old = jax_config.pallas_interpret
    jax_config.pallas_interpret = True
    yield
    jax_config.pallas_interpret = old


def _cfgs(stem, impl="xla", **kw):
    kw = dict(SMALL, **kw)
    return (JR.ResNetConfig(stem=stem, dtype=jnp.float32, conv_impl=impl,
                            **kw),
            TR.ResNetConfig(stem=stem, dtype=torch.float32, conv_impl=impl,
                            **kw))


def _batch(stem, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (B, SIZE[stem], SIZE[stem], 3)).astype(
        np.float32)
    return x, rng.integers(0, SMALL["num_classes"], size=B).astype(np.int32)


def _params(jcfg, seed=0):
    jp = JR.init_params(jax.random.key(seed), jcfg)
    return jp, TR.params_from_jax(jax.tree.map(np.asarray, jp))


def _tree_err(port, ref):
    """max |port - ref| over the leaves, walked by structure."""
    errs = tree_map(lambda a, b: float(np.abs(
        a.detach().numpy() - np.asarray(b)).max()), port,
        jax.tree.map(np.asarray, ref))
    return max(tree_leaves(errs))


def _port_grads(tp, x, y, tcfg):
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    loss = TR.loss_fn(tree_unflatten(tp, leaves), torch.from_numpy(x),
                      torch.from_numpy(y), tcfg)
    return loss, tree_unflatten(tp, torch.autograd.grad(loss, leaves))


def test_init_builds_the_jax_tree():
    for stem in ("cifar", "imagenet"):
        jcfg, tcfg = _cfgs(stem, stages=(2, 1, 1))
        jp = jax.eval_shape(lambda k: JR.init_params(k, jcfg),
                            jax.random.key(0))
        tp = TR.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
        shapes = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), jp)
        assert tree_map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix("torch.")),
                        tp) == shapes
        # He init: the stem's std is sqrt(2 / fan_in)
        w = tp["stem"]["w"]
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        assert abs(float(w.std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.3


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("stem", ["cifar", "imagenet"])
def test_logits_loss_and_grads_match_jax(stem, impl, interpret):
    jcfg, tcfg = _cfgs(stem, impl)
    jp, tp = _params(jcfg)
    x, y = _batch(stem)
    jlogits = JR.forward(jp, jnp.asarray(x), jcfg)
    tlogits = TR.forward(tp, torch.from_numpy(x), tcfg)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits,
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    jloss, jgrads = jax.value_and_grad(JR.loss_fn)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jcfg)
    tloss, tgrads = _port_grads(tp, x, y, tcfg)
    tloss = tloss.detach()
    assert abs(float(tloss) - float(jloss)) <= TOL * max(1.0, float(jloss))
    assert _tree_err(tgrads, jgrads) <= GRAD_TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("stem", ["cifar", "imagenet"])
def test_three_sgd_steps_match_jax(stem, impl, interpret):
    """Momentum 0.9, decoupled weight decay 1e-3, lr 0.1: the losses of
    each step and the params and momentum buffers after the third."""
    jcfg, tcfg = _cfgs(stem, impl)
    jp, tp = _params(jcfg, seed=1)
    jbuf, tbuf = JR.momentum_init(jp), TR.momentum_init(tp)
    jstep = JR.make_train_step(jcfg, momentum=0.9, weight_decay=1e-3)
    tstep = TR.make_train_step(tcfg, momentum=0.9, weight_decay=1e-3)
    for i in range(3):
        x, y = _batch(stem, seed=10 + i)
        jp, jbuf, jloss = jstep(jp, jbuf, jnp.asarray(x), jnp.asarray(y),
                                0.1)
        tp, tbuf, tloss = tstep(tp, tbuf, torch.from_numpy(x),
                                torch.from_numpy(y), 0.1)
        assert abs(float(tloss) - float(jloss)) <= GRAD_TOL
    assert _tree_err(tp, jp) <= GRAD_TOL
    assert _tree_err(tbuf, jbuf) <= GRAD_TOL


def test_step_updates_in_place():
    _, tcfg = _cfgs("cifar")
    tp = TR.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    buf = TR.momentum_init(tp)
    before = [p.data_ptr() for p in tree_leaves(tp) + tree_leaves(buf)]
    x, y = _batch("cifar")
    tp2, buf2, _ = TR.make_train_step(tcfg)(tp, buf, torch.from_numpy(x),
                                            torch.from_numpy(y), 0.1)
    assert tp2 is tp and buf2 is buf
    assert [p.data_ptr() for p in tree_leaves(tp) + tree_leaves(buf)] \
        == before
    assert all(float(b.abs().sum()) > 0 for b in tree_leaves(buf))


@pytest.mark.parametrize("stem", ["cifar", "imagenet"])
def test_groupnorm_makes_samples_independent(stem):
    """GroupNorm normalises within a sample, so a sample's logits do not
    depend on the rest of the batch (BatchNorm's would)."""
    _, tcfg = _cfgs(stem)
    tp = TR.init_params(torch.Generator().manual_seed(2), tcfg, "cpu")
    x, _ = _batch(stem, B=3)
    full = TR.forward(tp, torch.from_numpy(x), tcfg)
    alone = TR.forward(tp, torch.from_numpy(x[1:2]), tcfg)
    np.testing.assert_allclose(alone.detach().numpy(),
                               full[1:2].detach().numpy(), rtol=TOL,
                               atol=TOL)


def test_conv_strides_of_resnet18():
    """The stem and 19 convs of the blocks; 13 run at stride 1 (the counts
    chip_smoke.py holds K12 and K13 to)."""
    cfg = TR.ResNetConfig(stem="imagenet")
    s = TR.conv_strides(cfg)
    assert len(s) == 20 and s.count(1) == 13 and s[0] == 2
    assert len(TR.conv_strides(TR.ResNetConfig())) == 20
    assert TR.conv_strides(TR.ResNetConfig()).count(1) == 14
    jp = jax.eval_shape(lambda k: JR.init_params(k, JR.ResNetConfig()),
                        jax.random.key(0))
    n_kernels = 1 + sum(len([k for k in b if k in ("w1", "w2", "proj")])
                        for st in jp["stages"] for b in st)
    assert n_kernels == len(s)


def test_bad_config_raises():
    with pytest.raises(ValueError, match="conv_impl"):
        TR.ResNetConfig(conv_impl="cudnn")
    with pytest.raises(ValueError, match="stem"):
        TR.ResNetConfig(stem="vit")


@pytest.mark.cuda
def test_train_step_on_gpu_launches_k12_k13():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    cfg = TR.ResNetConfig(stem="imagenet", conv_impl="pallas", **SMALL)
    tp = TR.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    buf = TR.momentum_init(tp)
    x, y = _batch("imagenet")
    strides = TR.conv_strides(cfg)
    before = TC.conv2d_direct_nhwc.launches, TC.conv2d_dw_nhwc.launches
    _, _, loss = TR.make_train_step(cfg)(tp, buf, torch.from_numpy(x).cuda(),
                                         torch.from_numpy(y).cuda(), 0.1)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    # the stem's input, the image, needs no dx
    assert (TC.conv2d_direct_nhwc.launches - before[0],
            TC.conv2d_dw_nhwc.launches - before[1]) == (
        len(strides) + strides[1:].count(1), strides.count(1))
