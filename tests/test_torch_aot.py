"""The port's ahead-of-time export (`neuronika_tpu_torch/utils/aot.py`, on
`torch.export`) against the JAX package's (`neuronika_tpu/utils/aot.py`)
on the CPU: the twins of tests/test_utils.py::TestAOTExport. The greedy
`make_generate` program exported and loaded gives JAX's tokens bit for
bit (params carried from JAX's init); a program given by shapes alone
runs and refuses other shapes; a sampled program (a torch.Generator
input) is refused; the loaded program needs no model code; the exported
forward holds the K1 custom op and gives the eager logits bit for bit."""

import io

import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu_torch import utils
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.utils import aot

CFG = dict(vocab_size=32, n_layer=1, n_head=2, d_model=32, d_ff=64,
           max_seq=16, flash="off", remat=False)


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


@pytest.fixture(scope="module")
def model():
    """JAX's program and params (test_utils.py:270), its greedy tokens,
    and the port's params carried from JAX."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu.models import transformer as JT

    jcfg = JT.GPTConfig(dtype=jnp.float32, **CFG)
    jparams = JT.init_params(jax.random.key(0), jcfg)
    prompt = np.arange(6, dtype=np.int32)[None]
    want = np.asarray(JT.make_generate(jcfg, max_new=4)(
        jparams, jnp.asarray(prompt), jax.random.key(7)))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams))
    return T.GPTConfig(dtype=torch.float32, **CFG), params, \
        torch.from_numpy(prompt), want


def test_roundtrip_bytes_and_file(model, tmp_path):
    cfg, params, prompt, want = model
    gen = T.make_generate(cfg, max_new=4)
    key = torch.Generator().manual_seed(7)
    np.testing.assert_array_equal(gen(params, prompt, key).numpy(), want)

    blob = utils.export_fn(gen, params, prompt, key)
    assert isinstance(blob, bytes) and len(blob) > 100
    got = utils.load_exported(blob)(params, prompt, key)
    np.testing.assert_array_equal(got.numpy(), want)

    p = tmp_path / "gpt.nkx"
    utils.save_exported(p, gen, params, prompt, key)
    got2 = utils.load_exported(p)(params, prompt, None)
    np.testing.assert_array_equal(got2.numpy(), want)


def test_shape_struct_export_and_mismatch_error():
    def f(x):
        return x * 2.0 + 1.0

    blob = utils.export_fn(f, aot.ShapeDtypeStruct((4,), torch.float32))
    call = utils.load_exported(blob)
    np.testing.assert_allclose(call(torch.ones(4)).numpy(), np.full(4, 3.0))
    with pytest.raises(Exception):
        call(torch.ones(5))  # shapes are fixed at export


def test_shape_struct_runs_on_the_card_unless_asked():
    """A ShapeDtypeStruct's zeros lie on config.device: "cuda" by default,
    which raises where there is no card (nothing falls back to the
    CPU)."""
    nk.config.device = "cuda"
    struct = aot.ShapeDtypeStruct((4,), torch.float32)
    if torch.cuda.is_available():
        call = utils.load_exported(utils.export_fn(torch.neg, struct))
        assert call(torch.ones(4, device="cuda")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            utils.export_fn(torch.neg, struct)


def test_sampled_generation_is_refused(model):
    """A sampling program draws from its generator, which cannot be an
    exported input: export raises rather than bake in other draws."""
    cfg, params, prompt, _ = model
    gen = T.make_generate(cfg, max_new=4, temperature=0.8)
    with pytest.raises(NotImplementedError, match="random"):
        utils.export_fn(gen, params, prompt, torch.Generator().manual_seed(7))


def test_loaded_program_needs_no_model_code(model, monkeypatch):
    """After export, the model functions the program traced may vanish:
    the loaded program still gives the same tokens; a prompt of another
    length is refused."""
    cfg, params, prompt, want = model
    blob = utils.export_fn(T.make_generate(cfg, max_new=4), params, prompt,
                           None)

    def gone(*a, **k):
        raise AssertionError("model code called")

    for name in ("_prefill_body", "_decode_step_body", "forward",
                 "make_generate", "sample_logits"):
        monkeypatch.setattr(T, name, gone)
    call = utils.load_exported(blob)
    np.testing.assert_array_equal(call(params, prompt, None).numpy(), want)
    with pytest.raises(Exception):
        call(params, prompt[:, :5], None)


def test_exported_forward_holds_the_flash_custom_op():
    """The forward exported with flash on: the graph calls the K1 custom
    op (on the CPU its plain version), the loaded logits are the eager
    ones bit for bit."""
    cfg = T.GPTConfig(dtype=torch.float32, **dict(CFG, flash="on"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32, (2, 16)))

    def fwd(p, t):
        return T.forward(p, t, cfg)

    blob = utils.export_fn(fwd, params, toks)
    ep = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == "call_function"]
    assert any("neuronika_tpu_torch.flash_fwd_qkv" in o for o in ops)
    assert torch.equal(utils.load_exported(blob)(params, toks),
                       fwd(params, toks))
