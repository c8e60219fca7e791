"""The port's GPT training step (neuronika_tpu_torch/models/transformer.py
and optim/functional.py) against the JAX package on the CPU in f32:
logits, loss and gradients, Adam steps of `make_train_step` (with
clipping, accumulation, bf16 moments and a resume from JAX's state), the
packed flash path against JAX's packed Pallas path in interpret mode, and
the options the port refuses. Params come from the JAX tree through
`params_from_jax`; tokens from numpy."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.config import config as jax_config
from neuronika_tpu.models import transformer as JT
from neuronika_tpu.optim import functional as JF
from neuronika_tpu_torch._tree import tree_leaves, tree_unflatten
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL

# the width of __graft_entry__.entry(), in f32
ENTRY = dict(vocab_size=512, n_layer=4, n_head=4, d_model=256, d_ff=1024,
             max_seq=128)
# gradients: sums over B*S positions of products of O(1e-2) terms
GRAD_TOL = 2e-5
LR = 1e-3


def _cfgs(jflash="off", **kw):
    base = dict(ENTRY)
    base.update(kw)
    return (JT.GPTConfig(dtype=jnp.float32, flash=jflash, **base),
            TT.GPTConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tree_err(t_tree, j_tree):
    """Largest abs difference over all leaves (the keys must agree)."""
    tl, jl = _leaves(t_tree), _leaves(j_tree)
    assert tl.keys() == jl.keys()
    return max(float(np.abs(tl[k].detach().float().numpy()
                            - np.asarray(jl[k], np.float32)).max())
               for k in tl)


def _port_grads(tp, tcfg, toks, tgts, train=True):
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    loss = TT.loss_fn(tree_unflatten(tp, leaves), torch.from_numpy(toks),
                      torch.from_numpy(tgts), tcfg, train=train)
    loss.backward()
    return loss, tree_unflatten(tp, [p.grad for p in leaves])


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_logits_loss_and_grads_match_jax(flash):
    """The port's packed flash op (plain version on the CPU) and its
    composite both match JAX's composite path."""
    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, flash=flash)
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg)
    logits = TT.forward(tp, torch.from_numpy(toks), tcfg)
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    assert logits.shape == (2, 64, 512) and logits.dtype == torch.float32
    assert float(np.abs(logits.numpy() - np.asarray(want)).max()) <= TOL
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
    loss, grads = _port_grads(tp, tcfg, toks, tgts)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


STEP_KW = {"plain": {}, "clip": dict(grad_clip=0.5),
           "accum": dict(accum_steps=2)}


@pytest.mark.parametrize("name", list(STEP_KW))
def test_three_adam_steps_match_jax(name):
    """3 steps of make_train_step at the entry() width: the losses, the
    final params (see `_adam_params_close`) and the first moments."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    kw = STEP_KW[name]
    jstep = JT.make_train_step(jcfg, **kw)
    tstep = TT.make_train_step(tcfg, **kw)
    jopt, topt = JT.opt_init(jp, jcfg), TT.opt_init(tp, tcfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        toks, tgts = _batch(jcfg, B=4, seed=i)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts),
                             jnp.float32(LR), jax.random.key(i))
        tp2, topt2, tl = tstep(tp, topt, torch.from_numpy(toks),
                               torch.from_numpy(tgts), LR, gen)
        assert tp2 is tp and topt2["m"] is topt["m"]    # updated in place
        topt = topt2
        assert abs(float(tl) - float(jl)) <= TOL, i
    assert float(topt["step"]) == 3.0
    _adam_params_close(tp, jp, 3)
    assert _tree_err(topt["m"], jopt["m"]) <= GRAD_TOL


def _adam_params_close(t_tree, j_tree, steps, tol=3 * TOL):
    """Adam's first step moves every param by LR * sign(g), whatever |g|,
    and divides by sqrt(v) after: where a gradient is rounding noise (the
    k bias has an analytically zero gradient, as softmax ignores a shift
    of a whole score row; a few weights get |g| < 1e-7) the two sides may
    step in opposite directions. So: every param within 2 LR per step, and
    all but 1e-4 of them within `tol`."""
    tl, jl = _leaves(t_tree), _leaves(j_tree)
    assert tl.keys() == jl.keys()
    d = np.concatenate([np.abs(tl[k].float().numpy()
                               - np.asarray(jl[k], np.float32)).ravel()
                        for k in tl])
    assert d.max() <= 2 * LR * steps
    assert (d > tol).mean() <= 1e-4, (d > tol).sum()


def test_bf16_adam_state_and_resume_from_jax():
    """opt_state_dtype="bf16": 2 JAX steps, then the params and the bf16
    Adam state carried into the port by params_from_jax /
    opt_state_from_jax, and one more step on each side. The moments are
    rounded to bf16 on both sides; a rounding that flips on a ~1e-7
    gradient difference moves m by one bf16 ulp (2^-8 relative), so a
    param moves by at most about LR * 2^-7 more than on the other side."""
    jcfg, tcfg = _cfgs(opt_state_dtype="bf16")
    jp, _ = _params(jcfg)
    jstep = JT.make_train_step(jcfg)
    jopt = JT.opt_init(jp, jcfg)
    assert jax.tree.leaves(jopt["m"])[0].dtype == jnp.bfloat16
    for i in range(2):
        toks, tgts = _batch(jcfg, seed=i)
        jp, jopt, _ = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts),
                            jnp.float32(LR), jax.random.key(i))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    topt = TT.opt_state_from_jax(jax.tree.map(np.asarray, jopt))
    assert all(t.dtype == torch.bfloat16 for t in _leaves(topt["v"]).values())
    assert float(topt["step"]) == 2.0
    fresh = TT.opt_init(tp, tcfg)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(fresh["m"]).values())
    toks, tgts = _batch(jcfg, seed=2)
    jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts),
                         jnp.float32(LR), jax.random.key(2))
    tp, topt, tl = TT.make_train_step(tcfg)(
        tp, topt, torch.from_numpy(toks), torch.from_numpy(tgts), LR)
    assert abs(float(tl) - float(jl)) <= TOL
    _adam_params_close(tp, jp, 3, LR * 2 ** -7)
    assert _tree_err(topt["m"], jopt["m"]) <= 2 ** -8 * max(
        float(np.abs(np.asarray(l, np.float32)).max())
        for l in jax.tree.leaves(jopt["m"]))


def test_packed_flash_path_matches_jax_packed_kernels():
    """hd 128: JAX's packed Pallas path (flash="on", interpret mode) and
    the port's packed op give the same loss and gradients, with the split
    and the fused backward."""
    kw = dict(vocab_size=128, n_layer=2, n_head=2, d_model=256, d_ff=512,
              max_seq=128)
    old = jax_config.pallas_interpret
    jax_config.pallas_interpret = True
    try:
        for bwd in ("split", "fused"):
            jcfg, tcfg = _cfgs("on", flash_bwd=bwd, remat=False, **kw)
            tcfg = dataclasses.replace(tcfg, flash="on")
            jp, tp = _params(jcfg, seed=1)
            toks, tgts = _batch(jcfg, S=128, seed=3)
            jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
                jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=True)
            loss, grads = _port_grads(tp, tcfg, toks, tgts)
            assert abs(float(loss.detach()) - float(jloss)) <= TOL, bwd
            assert _tree_err(grads, jgrads) <= GRAD_TOL, bwd
    finally:
        jax_config.pallas_interpret = old


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal((5,)).astype(dtype)}}


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_adam_update_matches_jax(state_dtype):
    rng = np.random.default_rng(0)
    p, g = _tree(rng), _tree(rng)
    jdt = jnp.bfloat16 if state_dtype == "bf16" else None
    tdt = torch.bfloat16 if state_dtype == "bf16" else None
    jp = jax.tree.map(jnp.asarray, p)
    tp = TT.params_from_jax(p)
    js, ts = JF.adam_init(jp, jdt), TF.adam_init(tp, tdt)
    for i in range(3):
        gi = jax.tree.map(lambda a: a * (i + 1), g)
        jp, js = JF.adam_update(jp, jax.tree.map(jnp.asarray, gi), js, 0.01)
        tp, ts = TF.adam_update(tp, TT.params_from_jax(gi), ts, 0.01)
    assert _tree_err(tp, jp) <= TOL
    for k in ("m", "v"):
        assert _tree_err(ts[k], js[k]) <= (TOL if tdt is None else 1e-2)
    assert float(ts["step"]) == float(js["step"]) == 3.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    jc, jn = JF.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = TF.clip_by_global_norm(TT.params_from_jax(g), max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    assert _tree_err(tc, jc) <= TOL
    assert abs(float(TF.global_norm(tc)) - min(max_norm, float(jn))) <= 1e-4


def test_flops_per_token_matches_jax():
    for kw in (ENTRY, dict(vocab_size=16384, n_layer=8, n_head=12,
                           d_model=1536, d_ff=6144, max_seq=2048)):
        jcfg, tcfg = _cfgs(**kw)
        assert TT.flops_per_token(tcfg, 2048) == JT.flops_per_token(jcfg,
                                                                    2048)


def test_composite_dropout_is_seeded_and_survives_remat():
    """flash="off" dropout draws from the step's generator: the same seed
    gives the same loss and grads, another seed another loss, and a
    checkpointed block redraws its own mask when it is recomputed."""
    kw = dict(vocab_size=64, n_layer=2, n_head=2, d_model=64, d_ff=128,
              max_seq=32, dropout=0.3, flash="off", dtype=torch.float32)
    tp = TT.init_params(torch.Generator().manual_seed(0),
                        TT.GPTConfig(**kw), "cpu")
    toks, tgts = (torch.from_numpy(a) for a in _batch(TT.GPTConfig(**kw),
                                                      S=32))

    def run(seed, remat):
        cfg = TT.GPTConfig(remat=remat, **kw)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        tree = tree_unflatten(tp, leaves)
        loss = TT.loss_fn(tree, toks, tgts, cfg, train=True,
                          generator=torch.Generator().manual_seed(seed))
        loss.backward()
        return float(loss.detach()), tree["blocks"]["qkv"].grad

    l0, g0 = run(0, False)
    l1, g1 = run(0, True)
    l2, _ = run(1, False)
    assert l0 == l1 and torch.allclose(g0, g1, atol=1e-6)
    assert l0 != l2
    evl = float(TT.loss_fn(tp, toks, tgts, TT.GPTConfig(**kw)))
    assert evl not in (l0, l2)                # eval runs no dropout


@pytest.mark.parametrize("kw,train,match", [
    (dict(dropout=0.1), True, "dropout"),
], ids=["flash-dropout"])
def test_flash_path_refuses_what_it_cannot_run(kw, train, match):
    """What the flash path once refused now runs: attention dropout in
    training is in the kernels (their plain twins on the CPU), with a
    finite loss that differs from eval's; without a generator to draw the
    layers' seeds it still raises."""
    cfg = TT.GPTConfig(vocab_size=64, n_layer=1, n_head=2, d_model=64,
                       d_ff=128, max_seq=32, dtype=torch.float32,
                       flash="on", **kw)
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64,
                                                              (1, 16)))
    loss = TT.loss_fn(tp, toks, toks, cfg, train=train,
                      generator=torch.Generator())
    assert np.isfinite(float(loss))
    assert float(loss) != float(TT.loss_fn(tp, toks, toks, cfg))
    with pytest.raises(ValueError, match=f"{match} in training needs a "
                                         "generator"):
        TT.loss_fn(tp, toks, toks, cfg, train=train)


# ROADMAP.md open fault 1: GPTConfig's default flash="auto" with dropout
FAULT1 = dict(vocab_size=64, d_model=64, n_head=2, n_layer=1, max_seq=16,
              dropout=0.1)


def test_auto_flash_trains_with_dropout_like_jax():
    """The fault's config (head dim 32) with the default flash trains on
    the CPU: finite losses that fall over Adam steps, and over 16 seeds
    the mean training loss agrees with JAX's `loss_fn(train=True)` over 16
    keys within 4 standard errors of their difference (the masks differ:
    JAX draws jax.random bits, the port its Philox keep mask)."""
    jcfg = JT.GPTConfig(dtype=jnp.float32, **FAULT1)
    tcfg = TT.GPTConfig(dtype=torch.float32, **FAULT1)
    assert tcfg.flash == "auto"
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=16)
    jloss = jax.jit(lambda k: JT.loss_fn(jp, jnp.asarray(toks),
                                         jnp.asarray(tgts), jcfg, train=True,
                                         key=k))
    jl = [float(jloss(jax.random.key(i))) for i in range(16)]
    tt, tg = torch.from_numpy(toks), torch.from_numpy(tgts)
    tl = [float(TT.loss_fn(tp, tt, tg, tcfg, train=True,
                           generator=torch.Generator().manual_seed(i)))
          for i in range(16)]
    assert all(np.isfinite(tl))
    se = np.sqrt((np.var(jl) + np.var(tl)) / 16)
    assert abs(np.mean(tl) - np.mean(jl)) <= 4 * se, (np.mean(tl),
                                                      np.mean(jl), se)
    step = TT.make_train_step(tcfg)
    opt = TT.opt_init(tp, tcfg)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        tp, opt, loss = step(tp, opt, tt, tg, 1e-2, gen)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_config_takes_every_jax_field():
    """ROADMAP.md open fault 2: the port's GPTConfig is built from every
    field of JAX's at its default; the mixture-of-experts fields and
    sequence parallelism (which acts on a mesh: test_torch_parallel.py)
    take other values."""
    jcfg = JT.GPTConfig()
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dtype"] = torch.bfloat16
    cfg = TT.GPTConfig(**kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == value, name
    for name, value in (("n_experts", 8), ("moe_impl", "sparse"),
                        ("moe_capacity", 1.25), ("moe_aux_weight", 0.01)):
        assert getattr(TT.GPTConfig(**{name: value}), name) == value
    assert TT.GPTConfig(seq_parallel=True).seq_parallel is True


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_flash_window_matches_jax(train):
    """A window takes the flash path through the split op (plain K5-K7 on
    the CPU), in training and in eval, and gives JAX's loss (and, in
    training, its gradients) on its composite path."""
    jcfg, tcfg = _cfgs(window=8, n_layer=2)
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=32)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg, train=train)
    loss, grads = _port_grads(tp, tcfg, toks, tgts, train)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert _tree_err(grads, jgrads) <= GRAD_TOL


@pytest.mark.parametrize("kw", [dict(remat_policy="names"),
                                dict(remat_policy="dots")],
                         ids=["remat-names", "remat-dots"])
def test_unported_training_options_raise(kw):
    """The remat policies are ported (test_torch_remat.py); what is left
    of their ROADMAP item, f16 on the flash kernels, raises under
    flash="on" on the card, and an unknown policy is refused."""
    cfg = TT.GPTConfig(dtype=torch.float16, flash="on", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT._use_flash(cfg, types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(ValueError, match="remat_policy"):
        TT.GPTConfig(remat_policy=kw["remat_policy"] + "-offload")
    TT.GPTConfig(remat=False, remat_policy="names")   # policy unused


def test_window_still_serves_and_trains_on_the_composite():
    """Serving keeps `window`; training takes it on flash="off"."""
    jcfg, tcfg = _cfgs(window=8, n_layer=2)
    tcfg = dataclasses.replace(tcfg, flash="off")
    jp, tp = _params(jcfg)
    toks, tgts = _batch(jcfg, S=32)
    jl = JT.loss_fn(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    tl = TT.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tgts), tcfg)
    assert abs(float(tl) - float(jl)) <= TOL
    TT.make_paged_decode_step(tcfg, 8)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["split", "fused"])
def test_kernel_route_matches_plain_route_on_gpu(cuda, bwd):
    """f32, hd 128: the loss and gradients through the CUDA kernels equal
    the composite route's (flash="off") on the card."""
    from neuronika_tpu_torch.ops import flash_attention as FA

    jcfg, tcfg = _cfgs(vocab_size=128, n_layer=2, n_head=2, d_model=256,
                       d_ff=512, remat=False, flash_bwd=bwd)
    jp, _ = _params(jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), cuda)
    toks, tgts = (torch.from_numpy(a).to(cuda)
                  for a in _batch(jcfg, S=128))
    runs = {}
    for flash in ("on", "off"):
        cfg = dataclasses.replace(tcfg, flash=flash)
        before = [k.launches for k in FA.KERNELS]
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
        loss = TT.loss_fn(tree_unflatten(tp, leaves), toks, tgts, cfg,
                          train=True)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[flash] = (float(loss.detach()), grads,
                       [k.launches - b for k, b in zip(FA.KERNELS, before)])
    want = [2, 2, 2, 0] if bwd == "split" else [2, 0, 0, 2]
    assert runs["on"][2] == want and runs["off"][2] == [0, 0, 0, 0]
    assert abs(runs["on"][0] - runs["off"][0]) <= TOL
    assert max(float((a - b).abs().max())
               for a, b in zip(runs["on"][1], runs["off"][1])) <= GRAD_TOL


@pytest.mark.cuda
def test_auto_flash_takes_the_composite_at_head_dim_32_on_gpu(cuda):
    """ROADMAP.md open fault 1 on the card, in f16: the kernels take
    head dim 32 in f32 and bf16 but not f16, so flash="auto" takes the
    composite (no kernel launches, the loss of flash="off" with the same
    mask) where "on" raises."""
    from neuronika_tpu_torch.ops import flash_attention as FA

    cfg = TT.GPTConfig(dtype=torch.float16, **FAULT1)
    tp = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                        cuda)
    toks, tgts = (torch.from_numpy(a).to(cuda) for a in _batch(cfg, S=16))
    before = [k.launches for k in FA.KERNELS]
    loss = {f: float(TT.loss_fn(
        tp, toks, tgts, dataclasses.replace(cfg, flash=f), train=True,
        generator=torch.Generator(device=cuda).manual_seed(1)))
        for f in ("auto", "off")}
    assert [k.launches for k in FA.KERNELS] == before
    assert np.isfinite(loss["auto"]) and loss["auto"] == loss["off"]
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        TT.loss_fn(tp, toks, tgts, dataclasses.replace(cfg, flash="on"),
                   train=True, generator=torch.Generator(device=cuda))


@pytest.mark.cuda
def test_bf16_headline_step_trains_on_gpu(cuda):
    """The headline options (fused backward, fast softmax, no remat, bf16
    Adam state, compute-dtype matmul outputs) at a small width: the loss
    is finite and falls, params stay f32 and the moments bf16."""
    cfg = TT.GPTConfig(vocab_size=256, n_layer=2, n_head=2, d_model=256,
                       d_ff=512, max_seq=256, dtype=torch.bfloat16,
                       remat=False, flash_softmax="fast", flash_bwd="fused",
                       opt_state_dtype="bf16", matmul_out="compute")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = TT.init_params(gen, cfg, cuda)
    opt = TT.opt_init(params, cfg)
    step = TT.make_train_step(cfg)
    toks = torch.randint(0, 256, (4, 256), generator=gen, device=cuda)
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, toks, toks.roll(-1, 1), 1e-3,
                                 gen)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert params["wte"].dtype == torch.float32
    assert opt["v"]["wte"].dtype == torch.bfloat16
