"""The port's model bundles (`neuronika_tpu_torch/utils/hub.py`) against the
JAX package's (`neuronika_tpu/utils/hub.py`) on the CPU: the twins of
tests/test_utils.py::TestModelBundle, then bundles crossing between the
packages both ways (the same layout: params.npz keyed by tree path,
config.json with the dtype by name and `__config_class__`,
tokenizer.json), with equal forward logits: f32 within TOL = 1e-5 of the
largest |logit| (at least 1), the loaded params bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu_torch.data.tokenizer import BpeTokenizer
from neuronika_tpu_torch.models import t5
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.utils.hub import load_model, save_model

TOL = 1e-5
LLAMA = dict(vocab_size=300, n_layer=2, n_head=2, d_model=32, d_ff=96,
             max_seq=16)


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_gpt_bundle_roundtrip(tmp_path):
    cfg = T.llama_config(dtype=torch.float32, **LLAMA)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = BpeTokenizer.train(["the quick brown fox " * 30], 300)
    d = str(tmp_path / "model")
    save_model(d, params, cfg, tok)

    p2, cfg2, tok2 = load_model(d)
    assert cfg2 == cfg
    a, b = _leaves(params), _leaves(p2)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tok2.encode("the quick") == tok.encode("the quick")
    toks = torch.from_numpy(_tokens(300, (2, 16)))
    assert T.forward(p2, toks, cfg2).shape == (2, 16, 300)


def test_seq2seq_bundle_without_tokenizer(tmp_path):
    cfg = t5.Seq2SeqConfig(vocab_size=40, n_layer=1, n_head=2, d_model=32,
                           d_ff=64, max_src=8, max_tgt=8,
                           dtype=torch.float32)
    p = t5.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    d = str(tmp_path / "s2s")
    save_model(d, p, cfg)
    p2, cfg2, tok = load_model(d)
    assert tok is None and cfg2 == cfg
    src = torch.from_numpy(_tokens(40, (1, 8), 1))
    tgt = torch.from_numpy(_tokens(40, (1, 4), 2))
    assert torch.equal(t5.forward(p2, src, tgt, cfg2),
                       t5.forward(p, src, tgt, cfg))


def _jax_llama(dtype_name):
    import jax
    import jax.numpy as jnp

    from neuronika_tpu.data.tokenizer import BpeTokenizer as JTok
    from neuronika_tpu.models import transformer as JT

    cfg = JT.llama_config(dtype=getattr(jnp, dtype_name), **LLAMA)
    params = JT.init_params(jax.random.key(0), cfg)
    tok = JTok.train(["the quick brown fox " * 30], 300)
    return JT, cfg, params, tok


def test_jax_bundle_loads_in_the_port(tmp_path):
    """A bundle JAX wrote: the port's config equals JAX's field by field,
    the params are JAX's bits, the tokenizer encodes alike and the port's
    forward gives JAX's logits."""
    from neuronika_tpu.utils.hub import save_model as jsave

    JT, jcfg, jparams, jtok = _jax_llama("float32")
    d = str(tmp_path / "jax")
    jsave(d, jparams, jcfg, jtok)
    params, cfg, tok = load_model(d)
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert str(got.pop("dtype")) == "torch.float32"
    assert want.pop("dtype").__name__ == "float32"
    assert got == want
    jl = {k: np.asarray(v) for k, v in _leaves(jparams).items()}
    pl = _leaves(params)
    assert jl.keys() == pl.keys()
    for k in jl:
        np.testing.assert_array_equal(pl[k].numpy(), jl[k])
    assert tok.encode("the quick brown") == jtok.encode("the quick brown")
    toks = _tokens(300, (2, 16))
    _close(T.forward(params, torch.from_numpy(toks), cfg).numpy(),
           np.asarray(JT.forward(jparams, toks, jcfg)))


def test_port_bundle_loads_in_jax(tmp_path):
    """A bundle the port wrote, of params carried from JAX: JAX's loader
    rebuilds JAX's config and bits, and JAX's forward of them gives the
    port's logits."""
    import jax

    from neuronika_tpu.utils.hub import load_model as jload

    JT, jcfg, jparams, jtok = _jax_llama("float32")
    cfg = T.llama_config(dtype=torch.float32, **LLAMA)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams))
    tok = BpeTokenizer.train(["the quick brown fox " * 30], 300)
    d = str(tmp_path / "port")
    save_model(d, params, cfg, tok)
    with open(os.path.join(d, "config.json")) as f:
        meta = json.load(f)
    assert meta["dtype"] == "float32"
    assert meta["__config_class__"] == "GPTConfig"
    p2, cfg2, tok2 = jload(d)
    assert cfg2 == jcfg
    for k, v in _leaves(p2).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      _leaves(params)[k].numpy())
    assert tok2.encode("the quick brown") == tok.encode("the quick brown")
    toks = _tokens(300, (2, 16))
    _close(np.asarray(JT.forward(p2, toks, cfg2)),
           T.forward(params, torch.from_numpy(toks), cfg).numpy())


def test_bf16_leaves_cross_as_raw_bits(tmp_path):
    """bf16 leaves travel as 16-bit V2 arrays (serde's rule): a JAX bf16
    tree loads into the port bit for bit as bf16 tensors, and the port's
    bf16 bundle round-trips bit for bit with the dtype named bfloat16."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu.utils.hub import save_model as jsave

    JT, jcfg, jparams, _ = _jax_llama("bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    d = str(tmp_path / "jax_bf16")
    jsave(d, jparams, jcfg)
    params, cfg, _ = load_model(d)
    assert cfg.dtype == torch.bfloat16
    jl = _leaves(jparams)
    for k, t in _leaves(params).items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(jl[k]).view(np.int16))
    d2 = str(tmp_path / "port_bf16")
    save_model(d2, params, cfg)
    with np.load(os.path.join(d2, "params.npz")) as z:
        assert all(z[k].dtype == np.dtype("V2") for k in z.files)
    p2, cfg2, _ = load_model(d2)
    assert cfg2 == cfg
    a, b = _leaves(params), _leaves(p2)
    assert all(torch.equal(a[k].view(torch.int16), b[k].view(torch.int16))
               for k in a)


def test_load_model_runs_on_the_card_unless_asked(tmp_path):
    """load_model places the weights on config.device: "cuda" by default,
    which raises where there is no card (nothing falls back to the CPU)."""
    cfg = T.GPTConfig(vocab_size=32, n_layer=1, n_head=2, d_model=16,
                      d_ff=32, max_seq=8, dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    d = str(tmp_path / "m")
    save_model(d, params, cfg)
    nk.config.device = "cuda"
    if torch.cuda.is_available():
        p2, _, _ = load_model(d)
        assert all(t.device.type == "cuda" for t in _leaves(p2).values())
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            load_model(d)
    nk.config.device = "cpu"
    p3, _, _ = load_model(d)
    assert all(t.device.type == "cpu" for t in _leaves(p3).values())
