"""Hugging Face import and export of the port (neuronika_tpu_torch/utils/
hf.py) against the JAX package's `utils/hf.py` on tiny GPT-2, Llama (GQA)
and Mistral (sliding window) models built locally from seeded configs:
the imported params and configs equal JAX's, the port's logits match the
`transformers` forward, the exported state dicts equal JAX's, and export
then import gives the params back bit for bit. f32 on the CPU."""

import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neuronika_tpu.utils import hf as JH  # noqa: E402
from neuronika_tpu_torch.models import transformer as TT  # noqa: E402
from neuronika_tpu_torch.utils import hf as TH  # noqa: E402
from tests.conftest import REF_TOL  # noqa: E402
from tests.test_torch_train import _leaves, _tree_err  # noqa: E402

SMALL = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=128, max_position_embeddings=64)


def _model(kind):
    torch.manual_seed({"gpt2": 0, "llama": 1, "mistral": 2}[kind])
    if kind == "gpt2":
        return transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    if kind == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(
            rms_norm_eps=1e-6, tie_word_embeddings=False,
            attention_bias=False, attention_dropout=0.0, **SMALL)).eval()
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        sliding_window=8, rms_norm_eps=1e-5, **SMALL)).eval()


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in ("gpt2", "llama", "mistral")}


def _import(model):
    """(port params, port cfg, JAX params, JAX cfg) of one HF model."""
    tp, tcfg = TH.from_huggingface(model, dtype=torch.float32, device="cpu")
    jp, jcfg = JH.from_huggingface(model, dtype=jnp.float32)
    return tp, tcfg, jp, jcfg


CFG_FIELDS = ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model",
              "d_ff", "max_seq", "pos_emb", "rope_theta", "norm", "norm_eps",
              "mlp", "bias", "tied_head", "window", "dropout")


@pytest.mark.parametrize("kind", ["gpt2", "llama", "mistral"])
def test_import_matches_jax_and_hf_logits(models, kind):
    """The same params (bit for bit) and config fields as JAX's importer;
    the port's f32 logits match the transformers forward (inside Mistral's
    window, where every transformers version masks alike)."""
    model = models[kind]
    tp, tcfg, jp, jcfg = _import(model)
    assert _tree_err(tp, jp) == 0.0
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in _leaves(tp).values())
    for f in CFG_FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.dtype == torch.float32
    S = 8 if kind == "mistral" else 16
    ids = np.random.default_rng(3).integers(0, 97, (2, S))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float()
        got = TT.forward(tp, torch.from_numpy(ids), tcfg)
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= REF_TOL


def test_dispatch_and_a_train_step(models):
    """from_huggingface refuses an unknown model_type; an imported tree
    takes an Adam step unchanged in structure."""
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        TH.from_huggingface(types.SimpleNamespace(
            config=types.SimpleNamespace(model_type="bert")))
    params, cfg = TH.from_huggingface(models["gpt2"], dtype=torch.float32,
                                      device="cpu")
    step = TT.make_train_step(cfg)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 16)))
    p2, _, loss = step(params, TT.opt_init(params, cfg), ids, ids, 1e-3)
    assert np.isfinite(float(loss))
    assert _leaves(p2).keys() == _leaves(params).keys()


def test_import_reads_only_config_and_state_dict(models):
    """Any object with a config and a state dict imports, with no
    transformers model class in sight: the package is optional."""
    model = models["llama"]
    fields = dict(model.config.to_dict(), model_type="llama")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    bare = types.SimpleNamespace(config=types.SimpleNamespace(**fields),
                                 state_dict=lambda: sd)
    tp, tcfg = TH.from_huggingface(bare, dtype=torch.float32, device="cpu")
    want, _ = TH.from_hf_llama(model, dtype=torch.float32, device="cpu")
    assert _tree_err(tp, want) == 0.0
    assert tcfg.n_kv_head == 2 and not tcfg.tied_head


@pytest.mark.parametrize("kind", ["gpt2", "llama", "mistral"])
def test_export_matches_jax_and_round_trips(models, kind):
    """to_huggingface's state dict equals JAX's exporter's on the same
    params, the exported model's logits equal the source model's, and
    importing it again gives the params back bit for bit."""
    tp, tcfg, jp, jcfg = _import(models[kind])
    mine = TH.to_huggingface(tp, tcfg)
    theirs = JH.to_huggingface(jp, jcfg)
    assert type(mine) is type(theirs)
    a, b = mine.state_dict(), theirs.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    back, cfg2 = TH.from_huggingface(mine, dtype=torch.float32,
                                     device="cpu")
    assert _tree_err(back, tp) == 0.0
    assert cfg2 == tcfg
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (1, 8)))
    with torch.no_grad():
        assert torch.allclose(mine(ids).logits, models[kind](ids).logits,
                              atol=1e-5)


def test_export_refuses_other_families_and_needs_transformers(
        models, monkeypatch):
    """The exporters refuse what HF cannot hold (GQA in GPT-2, a GPT-2
    stack as llama) with JAX's errors, and raise ImportError naming
    transformers where it is missing."""
    tp, tcfg, _, _ = _import(models["gpt2"])
    with pytest.raises(ValueError, match="llama export needs rope"):
        TH.to_hf_llama(tp, tcfg)
    with pytest.raises(ValueError, match="no grouped-query attention"):
        TH.to_hf_gpt2(tp, dataclasses.replace(tcfg, n_kv_head=2))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        TH.to_huggingface(tp, tcfg)
