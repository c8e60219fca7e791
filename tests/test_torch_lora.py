"""LoRA and QLoRA in the port (neuronika_tpu_torch/models/lora.py and the
int4 quantizer `transformer._quant_w4`/`dequant_w4`) against the JAX
package on the CPU in f32: the int4 base bit for bit, the adapters'
structure, the merged trees, and three LoRA and QLoRA Adam steps from
JAX's adapters (the loss each step, the adapters and their first moments
after; the base unchanged bit for bit). Params come from the JAX tree
through `params_from_jax`; tokens from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu.models import lora as JL
from neuronika_tpu.models import transformer as JT
from neuronika_tpu.optim import functional as JF
from neuronika_tpu_torch._tree import tree_leaves, tree_map
from neuronika_tpu_torch.models import lora as TL
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.optim import functional as TF
from tests.conftest import TOL
from tests.test_torch_train import (GRAD_TOL, LR, _adam_params_close,
                                    _tree_err)

# d128 (one 128-row int4 group for qkv, proj and fc_in; two for fc_out),
# H4 (hd 32), L2
SMALL = dict(vocab_size=128, n_layer=2, n_head=4, d_model=128, d_ff=256,
             max_seq=32)


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return (JT.GPTConfig(dtype=jnp.float32, flash="off", **base),
            TT.GPTConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab_size"], size=(B, S), dtype=np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.mark.parametrize("shape, dtype", [
    ((2, 256, 64), "float32"), ((3, 96, 40), "float32"),
    ((384, 128), "float32"), ((2, 256, 48), "bfloat16")],
    ids=["stacked-2-groups", "one-group-of-96", "2d-3-groups", "bf16"])
def test_quant_w4_is_bit_identical_to_jax(shape, dtype):
    """Packed nibbles (low nibble first), per-group f32 scales (the whole
    axis when 128 does not divide it), round half to even, and the
    dequantized weights in f32 and bf16."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., :, 0] = 0.0                # an all-zero column: the 1e-8 floor
    jw = jnp.asarray(w, dtype=dtype)
    tw = torch.from_numpy(np.array(jw, np.float32)).to(getattr(torch, dtype))
    jq, tq = JT._quant_w4(jw), TT._quant_w4(tw)
    assert tq["q4p"].dtype == torch.int8 and tq["s4"].dtype == torch.float32
    np.testing.assert_array_equal(tq["q4p"].numpy(), np.asarray(jq["q4p"]))
    np.testing.assert_array_equal(tq["s4"].numpy(), np.asarray(jq["s4"]))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            TT.dequant_w4(tq, td).float().numpy(),
            np.asarray(JT.dequant_w4(jq, jd), np.float32))
    with pytest.raises(ValueError, match="even"):
        TT._quant_w4(torch.zeros(3, 5))


def test_lora_init_structure_and_zero_delta():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    ad = TL.lora_init(torch.Generator().manual_seed(1), tp, rank=4)
    jad = JL.lora_init(jax.random.key(1), jp, rank=4)
    assert jax.tree.map(lambda a: a.shape, jad) == tree_map(
        lambda t: tuple(t.shape), ad)
    assert TL.lora_param_count(ad) == JL.lora_param_count(jad)
    for name in TL.DEFAULT_TARGETS:
        assert not ad[name]["B"].any()
        assert abs(float(ad[name]["A"].std()) - 0.5) < 0.05   # 1/sqrt(4)
    merged = TL.lora_apply(tp, ad)
    for a, b in zip(tree_leaves(merged), tree_leaves(tp)):
        assert torch.equal(a, b)


def _jax_adapters(jp, rank=4, targets=TL.DEFAULT_TARGETS, seed=1):
    """JAX's adapters with B drawn non-zero, so the delta is not 0."""
    jad = JL.lora_init(jax.random.key(seed), jp, rank, targets)
    rng = np.random.default_rng(seed)
    return {k: {"A": v["A"], "B": jnp.asarray(
        rng.standard_normal(v["B"].shape).astype(np.float32) * 0.02)}
        for k, v in jad.items()}


@pytest.mark.parametrize("targets", [("qkv", "proj"),
                                     ("qkv", "proj", "fc_in", "fc_out")],
                         ids=["default", "with-mlp"])
def test_lora_apply_and_merge_match_jax(targets):
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    jad = _jax_adapters(jp, targets=targets)
    ad = TT.params_from_jax(_np(jad))
    got, want = TL.lora_apply(tp, ad, alpha=16.0), JL.lora_apply(jp, jad, 16.0)
    assert _tree_err(got, want) <= TOL
    merged = TL.lora_merge(tp, ad, alpha=16.0)
    for a, b in zip(tree_leaves(merged), tree_leaves(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["lora", "qlora"])
def test_train_steps_match_jax(kind):
    """Three steps from JAX's adapters (B zero, as `lora_init` draws it):
    the loss each step, the adapters and their first moments after; the
    base leaves are the same tensors, bit for bit, and carry no gradient."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jad = JL.lora_init(jax.random.key(1), jp, rank=4)
    ad = TT.params_from_jax(_np(jad))
    if kind == "qlora":
        jp, tp = JL.qlora_quantize_base(jp), TL.qlora_quantize_base(tp)
        jstep = JL.make_qlora_train_step(jcfg, alpha=16.0)
        tstep = TL.make_qlora_train_step(tcfg, alpha=16.0)
    else:
        jstep = JL.make_lora_train_step(jcfg, alpha=16.0)
        tstep = TL.make_lora_train_step(tcfg, alpha=16.0)
    base = [t.clone() for t in tree_leaves(tp)]
    jopt, opt = JF.adam_init(jad), TF.adam_init(ad)
    for i in range(3):
        toks, tgts = _batch(seed=i)
        jad, jopt, jl = jstep(jp, jad, jopt, jnp.asarray(toks),
                              jnp.asarray(tgts), jnp.float32(LR),
                              jax.random.key(i))
        ad2, opt, tl = tstep(tp, ad, opt, torch.from_numpy(toks),
                             torch.from_numpy(tgts), LR)
        assert ad2 is ad
        assert abs(float(tl) - float(jl)) <= TOL, i
    _adam_params_close(ad, _np(jad), 3)
    assert _tree_err(opt["m"], _np(jopt["m"])) <= GRAD_TOL
    assert all(ad[n]["B"].abs().max() > 0 for n in ad)      # adapters moved
    for a, b in zip(tree_leaves(tp), base):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


def test_qlora_base_and_merge_match_jax():
    """The quantized base equals JAX's bit for bit (embeddings, norms and
    biases untouched); zero adapters give the dequantized base; a merge
    with non-zero adapters matches JAX's."""
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    jq, tq = JL.qlora_quantize_base(jp), TL.qlora_quantize_base(tp)
    for name in TL.QLORA_QUANT_LEAVES:
        if name in tq["blocks"]:
            for part in ("q4p", "s4"):
                np.testing.assert_array_equal(
                    tq["blocks"][name][part].numpy(),
                    np.asarray(jq["blocks"][name][part]))
    assert tq["wte"] is tp["wte"] and tq["blocks"]["qkv_b"] is \
        tp["blocks"]["qkv_b"]
    zero = TL.lora_init(torch.Generator().manual_seed(0), tp, rank=4)
    merged = TL.qlora_apply(tq, zero, dtype=torch.float32)
    for name in ("qkv", "proj", "fc_in", "fc_out"):
        assert torch.equal(merged["blocks"][name],
                           TT.dequant_w4(tq["blocks"][name], torch.float32))
    jad = _jax_adapters(jp)
    ad = TT.params_from_jax(_np(jad))
    got = TL.qlora_merge(tq, ad, dtype=torch.float32)
    want = JL.qlora_merge(jq, jad, dtype=jnp.float32)
    assert _tree_err(got, want) <= TOL


def test_bad_and_expert_targets_raise():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    with pytest.raises(ValueError, match="unknown LoRA target"):
        TL.lora_init(torch.Generator(), tp, 4, targets=("nope",))
    moe = TT.init_params(torch.Generator().manual_seed(0),
                         TT.GPTConfig(dtype=torch.float32, n_experts=2,
                                      **SMALL), "cpu")
    with pytest.raises(ValueError, match="MoE expert"):
        TL.lora_init(torch.Generator(), moe, 4, targets=("fc_in",))
    # the quantized base keeps the 4-d expert tensors as they are
    assert TL.qlora_quantize_base(moe)["blocks"]["fc_in"] is \
        moe["blocks"]["fc_in"]
