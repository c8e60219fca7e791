"""The port's `Trainer` and `warmup_cosine` (neuronika_tpu_torch/train.py)
against the JAX package's on the CPU in f32.

* From JAX's params (`params_from_jax`), on the same batches at dropout 0,
  with warmup, `total_steps`, `min_lr`, `grad_clip` 1.0, `accum_steps` 2,
  `eval_every` and `pad_id`: each step's loss and lr in the JSONL and the
  eval loss within TOL of JAX's `Trainer` (run without `checkpoint_dir`),
  the records with JAX's keys.
* A run saved at step 3, resumed by a fresh `Trainer` and fitted to 6
  gives, bit for bit, the losses, params and Adam state of the port's own
  uninterrupted run, at dropout 0.1, so the generator's state (the
  dropout masks' seeds) is restored too.
* `mesh` and `fsdp` raise; the generator must be on the trainer's
  device."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu import train as jtrain
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import train as ttrain
from neuronika_tpu_torch._tree import tree_leaves
from neuronika_tpu_torch.models import transformer as TT
from tests.conftest import TOL

BASE = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, d_ff=64,
            max_seq=16)
RUN = dict(lr=3e-3, warmup_steps=2, total_steps=5, min_lr=3e-4,
           grad_clip=1.0, accum_steps=2, eval_every=2, pad_id=0)
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


def _batches(n, seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(1, 64, size=(B, S), dtype=np.int32)
        tgts = np.roll(toks, -1, axis=1)
        tgts[:, -2:] = 0                             # padded targets
        out.append((toks, tgts))
    return out


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_warmup_cosine_matches_jax():
    for args in ((1e-3, 0, None, 0.0), (1e-3, 3, 10, 1e-4),
                 (2e-3, 4, 4, 0.0)):
        j, t = jtrain.warmup_cosine(*args), ttrain.warmup_cosine(*args)
        assert [t(s) for s in range(14)] == [j(s) for s in range(14)]


def test_trainer_matches_jax(tmp_path):
    jcfg = JT.GPTConfig(dtype=jnp.float32, **BASE)
    tcfg = TT.GPTConfig(dtype=torch.float32, **BASE)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))  # JAX donates jp
    batches = _batches(STEPS)
    held = _batches(2, seed=1)
    jt = jtrain.Trainer(jcfg, key=jax.random.key(1), params=jp,
                        log_path=str(tmp_path / "j.jsonl"),
                        eval_batches=lambda: held, **RUN)
    jt.fit(batches, steps=STEPS)
    tt = ttrain.Trainer(tcfg, generator=torch.Generator().manual_seed(1),
                        params=tp,
                        log_path=str(tmp_path / "t.jsonl"),
                        eval_batches=lambda: held, **RUN)
    summary = tt.fit(batches, steps=STEPS)
    jr, tr = _records(tmp_path / "j.jsonl"), _records(tmp_path / "t.jsonl")
    assert len(tr) == len(jr) == STEPS and tt.step_num == STEPS
    for j, t in zip(jr, tr):
        assert t.keys() == j.keys()
        assert t["step"] == j["step"]
        assert t["lr"] == j["lr"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=TOL)
        if "eval_loss" in j:
            np.testing.assert_allclose(t["eval_loss"], j["eval_loss"],
                                       rtol=TOL)
    assert sum("eval_loss" in r for r in tr) == STEPS // RUN["eval_every"]
    assert summary["n"] == STEPS
    np.testing.assert_allclose(tt.last_eval["loss"], jt.last_eval["loss"],
                               rtol=TOL)
    assert tt.last_eval["tokens"] == jt.last_eval["tokens"]
    ev, jev = tt.evaluate(held), jt.evaluate(held)    # after step 5
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=TOL)


def _resumable(tmp_path, name, **kw):
    cfg = TT.GPTConfig(dtype=torch.float32, dropout=0.1, **BASE)
    return ttrain.Trainer(cfg, generator=torch.Generator().manual_seed(2),
                          checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=3, keep=2,
                          log_path=str(tmp_path / f"{name}.jsonl"), **kw)


def test_resume_is_bit_identical(tmp_path):
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=6, grad_clip=1.0)
    batches = _batches(6, seed=3)
    whole = ttrain.Trainer(
        TT.GPTConfig(dtype=torch.float32, dropout=0.1, **BASE),
        generator=torch.Generator().manual_seed(2),
        log_path=str(tmp_path / "whole.jsonl"), **kw)
    whole.fit(batches, steps=6)
    first = _resumable(tmp_path, "first", **kw)
    first.fit(batches[:3], steps=3)
    assert first._ckpt.steps() == [3]
    second = _resumable(tmp_path, "second", **kw)
    assert second.resume() == 3
    second.fit(iter(batches[3:]), steps=6)
    assert second._ckpt.steps() == [3, 6]
    losses = [r["loss"] for r in _records(tmp_path / "first.jsonl")
              + _records(tmp_path / "second.jsonl")]
    assert losses == [r["loss"] for r in _records(tmp_path / "whole.jsonl")]
    for a, b in zip(tree_leaves(second.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(second.opt_state),
                    tree_leaves(whole.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(second.generator.get_state(),
                       whole.generator.get_state())


@pytest.mark.parametrize("kw", [dict(mesh=object(), grad_clip=1.0),
                                dict(mesh=object(), fsdp=True,
                                     accum_steps=2)],
                         ids=["mesh", "fsdp"])
def test_sharding_options_raise(kw):
    """Trainer(mesh=, fsdp=) is ported (test_torch_parallel.py holds it);
    clipping and accumulation on a mesh are not, and raise before the
    mesh is touched."""
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ttrain.Trainer(TT.GPTConfig(dtype=torch.float32, **BASE),
                       generator=torch.Generator(), **kw)


def test_generator_must_be_on_the_trainer_device(monkeypatch):
    nk.config.device = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.Trainer(TT.GPTConfig(dtype=torch.float32, **BASE),
                       generator=torch.Generator())
