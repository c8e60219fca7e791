"""neuronika_tpu_torch's import boundary and the options it refuses.

The port must import without jax (the reference) and without triton, and
every option that is not ported yet must raise rather than be ignored."""

import os
import subprocess
import sys

import pytest
import torch

from neuronika_tpu_torch import device as D
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher, PagedBatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("neuronika_tpu_torch", "neuronika_tpu_torch._build",
           "neuronika_tpu_torch._tree",
           "neuronika_tpu_torch.device", "neuronika_tpu_torch.serving",
           "neuronika_tpu_torch.models.transformer",
           "neuronika_tpu_torch.ops.paged_attention",
           "neuronika_tpu_torch.ops.flash_attention",
           "neuronika_tpu_torch.optim",
           "neuronika_tpu_torch.optim.functional")


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
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'triton') if m in sys.modules]\n"
            "if bad: raise SystemExit(f'imported {bad}')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(quant="int4"),
                                dict(prefill_chunk=8),
                                dict(prefill_bucket="pow2"),
                                dict(mesh=object())],
                         ids=["quant-int8", "quant-int4", "prefill_chunk",
                              "prefill_bucket", "mesh"])
def test_unported_batcher_options_raise(params, kw):
    with pytest.raises(NotImplementedError):
        _batcher(params, **kw)


@pytest.mark.parametrize("call", [
    lambda pb: pb.register_prefix([1, 2, 3, 4, 5, 6, 7, 8]),
    lambda pb: pb.register_adapter({}),
    lambda pb: pb.step_many(4),
    lambda pb: pb.run(multi_step=4),
    lambda pb: pb.submit([1, 2], 4, adapter=1),
], ids=["register_prefix", "register_adapter", "step_many",
        "run-multi_step", "submit-adapter"])
def test_unported_batcher_methods_raise(params, call):
    with pytest.raises(NotImplementedError):
        call(_batcher(params))


def test_dense_slot_batcher_is_not_ported(params):
    with pytest.raises(NotImplementedError, match="PagedBatcher"):
        ContinuousBatcher(params, _cfg(), 2, device="cpu")


@pytest.mark.parametrize("kw", [dict(pos_emb="rope"), dict(norm="rms"),
                                dict(mlp="swiglu"), dict(n_experts=2),
                                dict(tied_head=False)],
                         ids=["rope", "rms", "swiglu", "moe", "untied"])
def test_unported_model_variants_raise(kw):
    with pytest.raises(NotImplementedError):
        _cfg(**kw)


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
