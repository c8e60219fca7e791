"""neuronika_tpu_torch's import boundary and the options it refuses.

The port must import without jax (the reference), without triton and
without anything of the JAX package (`neuronika_tpu`), and
every option that is not ported yet must raise rather than be ignored."""

import os
import subprocess
import sys
import types

import pytest
import torch

from neuronika_tpu_torch import device as D
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher, PagedBatcher
from neuronika_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("neuronika_tpu_torch", "neuronika_tpu_torch._build",
           "neuronika_tpu_torch._tree",
           "neuronika_tpu_torch.device", "neuronika_tpu_torch.serving",
           "neuronika_tpu_torch.models.transformer",
           "neuronika_tpu_torch.ops.paged_attention",
           "neuronika_tpu_torch.ops.flash_attention",
           "neuronika_tpu_torch.optim",
           "neuronika_tpu_torch.optim.functional",
           "neuronika_tpu_torch.config", "neuronika_tpu_torch.variable",
           "neuronika_tpu_torch._engine.node",
           "neuronika_tpu_torch._engine.executor",
           "neuronika_tpu_torch.ops.functional",
           "neuronika_tpu_torch.ops.matmul",
           "neuronika_tpu_torch.ops.softmax",
           "neuronika_tpu_torch.ops.conv",
           "neuronika_tpu_torch.ops.cross_entropy",
           "neuronika_tpu_torch.models.resnet",
           "neuronika_tpu_torch.nn", "neuronika_tpu_torch.nn.init",
           "neuronika_tpu_torch.nn.loss", "neuronika_tpu_torch.nn.recurrent",
           "neuronika_tpu_torch.optim.lr_scheduler",
           "neuronika_tpu_torch.optim._newton_schulz",
           "neuronika_tpu_torch.data", "neuronika_tpu_torch.utils",
           "neuronika_tpu_torch.utils.serde",
           "neuronika_tpu_torch.utils.gradcheck",
           "neuronika_tpu_torch.models.mlp", "neuronika_tpu_torch.models.cnn",
           "neuronika_tpu_torch.models.rnn",
           "neuronika_tpu_torch.examples",
           "neuronika_tpu_torch.examples.quickstart",
           "neuronika_tpu_torch.examples.mnist_cnn",
           "neuronika_tpu_torch.examples.char_rnn",
           "neuronika_tpu_torch.train", "neuronika_tpu_torch.utils.metrics",
           "neuronika_tpu_torch.utils.checkpoint",
           "neuronika_tpu_torch.data.tokenizer",
           "neuronika_tpu_torch.examples.text_pipeline",
           "neuronika_tpu_torch.examples.gpt_train",
           "neuronika_tpu_torch.models", "neuronika_tpu_torch.models.bert",
           "neuronika_tpu_torch.models.t5", "neuronika_tpu_torch.models.vit",
           "neuronika_tpu_torch.models.lora",
           "neuronika_tpu_torch.examples.resnet_cifar",
           "neuronika_tpu_torch.examples.serving",
           "neuronika_tpu_torch.examples.speculative_decode",
           "neuronika_tpu_torch.examples.serve_http",
           "neuronika_tpu_torch.examples.finetune_qlora",
           "neuronika_tpu_torch.parallel",
           "neuronika_tpu_torch.parallel.mesh",
           "neuronika_tpu_torch.parallel.ring",
           "neuronika_tpu_torch.parallel.collectives",
           "neuronika_tpu_torch.parallel.pipeline",
           "neuronika_tpu_torch.ops.sharded",
           "neuronika_tpu_torch.utils.hub", "neuronika_tpu_torch.utils.aot",
           "neuronika_tpu_torch.utils.profiler",
           "neuronika_tpu_torch.entry")


def _cfg(**kw):
    base = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
                max_seq=48, dtype=torch.float32)
    base.update(kw)
    return T.GPTConfig(**base)


@pytest.fixture(scope="module")
def params():
    return T.init_params(torch.Generator().manual_seed(0), _cfg(), "cpu")


def _batcher(params, **kw):
    return PagedBatcher(params, _cfg(), n_slots=2, n_blocks=8, block_size=8,
                        device="cpu", **kw)


def test_import_pulls_in_neither_jax_nor_triton():
    """Nor does it build: no kernel library is loaded by an import."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'triton', 'neuronika_tpu') "
            "if m in sys.modules]\n"
            "if bad: raise SystemExit(f'imported {bad}')\n"
            "from neuronika_tpu_torch import _build\n"
            "if _build.load_library.cache_info().currsize:\n"
            "    raise SystemExit('an import loaded the kernels')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", [
    "Var", "VarDiff", "Reduction", "StatusCell", "seed", "enable_kernels",
    "from_ndarray", "zeros", "ones", "full", "rand", "eye", "linspace",
    "logspace", "geomspace", "range", "cat", "stack", "Zero", "Constant",
    "Reflective", "Replicative", "Param", "Learnable", "to_device",
    "device_of", "nn", "data", "utils", "Device", "devices",
    "default_device", "train"])
def test_package_exposes_the_define_by_run_surface(name):
    import neuronika_tpu_torch as nk

    assert name in nk.__all__ and getattr(nk, name) is not None


class _DpMesh:
    """A mesh's axis names without a "tp" axis (checked before any
    collective, so no process group is needed)."""
    mesh_dim_names = ("dp",)


@pytest.mark.parametrize("kw", [dict(mesh=_DpMesh())], ids=["mesh"])
def test_unported_batcher_options_raise(params, kw):
    """The batchers' mesh, refused here until tensor-parallel serving was
    ported (tests/test_torch_serving_tp.py runs it on 4 ranks), now raises
    only JAX's ValueError for a mesh without a "tp" axis, in its words."""
    with pytest.raises(ValueError,
                       match="sharded serving needs a 'tp' mesh axis"):
        _batcher(params, **kw)
    with pytest.raises(ValueError,
                       match="sharded serving needs a 'tp' mesh axis"):
        ContinuousBatcher(params, _cfg(), 2, device="cpu", **kw)


def _lora(params, rank=2):
    from neuronika_tpu_torch.models.lora import lora_init

    ad = lora_init(torch.Generator().manual_seed(1), params, rank)
    for ab in ad.values():
        ab["B"] += 0.05
    return ad


# what these options and methods refused before they were ported: each now
# serves a request (tests/test_torch_serving_*.py hold them against JAX)
@pytest.mark.parametrize("make, drive", [
    (dict(quant="int8"), None), (dict(quant="int4"), None),
    (dict(prefill_chunk=8), None), (dict(prefill_bucket="pow2"), None),
    (None, lambda pb, p: pb.register_prefix(list(range(1, 9)))),
    (None, lambda pb, p: pb.register_adapter(_lora(p))),
    (None, lambda pb, p: pb.step_many(4)),
    (None, lambda pb, p: pb.run(multi_step=4)),
    (None, lambda pb, p: (pb.register_adapter(_lora(p)),
                          pb.submit([1, 2], 4, adapter=1))),
], ids=["quant-int8", "quant-int4", "prefill_chunk", "prefill_bucket",
        "register_prefix", "register_adapter", "step_many",
        "run-multi_step", "submit-adapter"])
def test_ported_batcher_options_and_methods_serve(params, make, drive):
    pb = _batcher(params, **(make or {}))
    if drive is not None:
        drive(pb, params)
    rid = pb.submit(list(range(1, 13)), 4)
    out = pb.run(multi_step=2)
    assert out[rid].shape == (4,)
    assert pb.block_stats[0] == 0


def test_dense_slot_batcher_serves(params):
    cb = ContinuousBatcher(params, _cfg(), 2, quant="int8-kv", device="cpu")
    rids = [cb.submit([1, 2, 3], 5), cb.submit([4, 5], 3)]
    out = cb.run()
    assert [out[r].shape for r in rids] == [(5,), (3,)]
    assert cb.cache["k"].dtype == torch.int8


def test_paged_int8_kv_is_refused_like_jax(params):
    for call in (lambda: _batcher(params, quant="int8-kv"),
                 lambda: T.make_paged_decode_many(_cfg(), 8, 4,
                                                  quant="int8-kv")):
        with pytest.raises(NotImplementedError,
                           match="paged serving supports"):
            call()


@pytest.mark.parametrize("kw, item", [
    (dict(seq_parallel=True, n_experts=2), 5),
    (dict(remat_policy="flash", dtype=torch.float16, flash="on"), 3)],
    ids=["seq_parallel", "remat-flash"])
def test_unported_model_variants_raise(kw, item):
    """Sequence parallelism and experts on a mesh are ported
    (test_torch_parallel.py); what the sharded step still refuses is a pp
    axis (pipelines train through the pipelined steps), checked before the
    mesh is touched. f16 is refused by the flash gate on the card under
    flash="on" (a stand-in with a CUDA device: the gate reads only that),
    with remat_policy "flash", which is ported. (rope, rms, swiglu, an
    untied head, mixture-of-experts and every remat policy are ported:
    test_torch_llama.py, test_torch_moe.py and test_torch_remat.py hold
    them against JAX.)"""
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "pp"))
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue 1 item {item}"):
        if kw.get("seq_parallel"):
            T.make_sharded_train_step(mesh, _cfg(**kw))
        else:
            T._use_flash(_cfg(**kw), types.SimpleNamespace(
                device=torch.device("cuda")))


_ITEM5 = (NotImplementedError, r"ROADMAP\.md queue 1 item 5")


@pytest.mark.parametrize("call, raises", [
    (lambda: T.make_generate(_cfg(), 4, mesh=_DpMesh()),
     (ValueError, "sharded serving needs a mesh with 'dp' and 'tp' axes")),
    (lambda: Trainer(_cfg(), generator=torch.Generator(), mesh=object(),
                     grad_clip=1.0), _ITEM5),
    (lambda: Trainer(_cfg(), generator=torch.Generator(), mesh=object(),
                     fsdp=True, accum_steps=2), _ITEM5),
], ids=["make_generate-mesh", "Trainer-mesh", "Trainer-fsdp"])
def test_unported_loop_options_raise_and_name_their_queue_item(call, raises):
    """Clipping or accumulation on a mesh name their queue item
    (Trainer(mesh=, fsdp=) itself is ported: test_torch_parallel.py).
    make_generate(mesh=), refused here until tensor-parallel serving was
    ported (tests/test_torch_serving_tp.py), raises only JAX's ValueError
    for a mesh without dp and tp axes, in its words."""
    with pytest.raises(raises[0], match=raises[1]):
        call()


@pytest.mark.parametrize("call", [
    lambda: T.init_kv_cache(_cfg(), 2, quant="int8-kv", device="cpu"),
    lambda: T.make_decode_step(_cfg(), quant="int8"),
    lambda: T.make_prefill(_cfg(), quant="int4"),
    lambda: T.make_generate(_cfg(), 4, quant="int8"),
    lambda: T.make_beam_search(_cfg(), 4, 2, quant="int8"),
    lambda: T.make_speculative_generate(_cfg(), _cfg(), 4),
], ids=["init_kv_cache-quant", "make_decode_step-quant",
        "make_prefill-quant", "make_generate-quant",
        "make_beam_search-quant", "make_speculative_generate"])
def test_ported_loop_options_build(call):
    """(tests/test_torch_serving_quant.py and _speculative.py hold them
    against JAX.)"""
    assert call() is not None


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="unknown quant mode"):
        T.make_decode_step(_cfg(), quant="int3")


def test_kernel_on_refuses_cpu_tensors(params):
    pb = _batcher(params, kernel="on")
    pb.submit([1, 2, 3], 4)          # prefill runs no kernel
    with pytest.raises(ValueError, match="kernel='on'"):
        pb.run()


def test_bad_kernel_mode_and_pool_raise(params):
    with pytest.raises(ValueError, match="auto/on/off"):
        _batcher(params, kernel="maybe")
    with pytest.raises(ValueError, match="n_blocks"):
        PagedBatcher(params, _cfg(), n_slots=2, n_blocks=1, device="cpu")
    small = PagedBatcher(params, _cfg(), n_slots=2, n_blocks=4,
                         block_size=8, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        small.submit(list(range(30)), 8)      # 5 blocks, the pool has 3


def test_cuda_without_gpu_raises_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        D.resolve("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        T.init_params(torch.Generator(), _cfg(), "cuda")
    assert D.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        D.resolve("meta")
