"""The port's metrics logger, params-tree files and train-state checkpoints
(neuronika_tpu_torch/utils/metrics.py, serde.py, checkpoint.py) against the
JAX package's on the CPU.

* `MetricsLogger`: the same scalars under one patched clock give JAX's
  records and JSONL lines.
* `save_pytree`/`load_pytree`: a file written by either package loads in
  the other (f32 and int leaves of a GPT params tree whose insertion order
  is not JAX's sorted order), bf16 leaves written by JAX load as bf16 and
  the port writes the same bytes, and the treedef text is JAX's.
* `Checkpointer`: save, restore and retention round trips; `save()` is a
  snapshot (in-place updates after it do not reach the file); a failure
  injected mid-write leaves the latest checkpoint whole; and one small
  test: the same `save` calls leave the same `steps()` as the JAX
  package's orbax `Checkpointer(async_save=False)`."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk
from neuronika_tpu_torch._tree import tree_map
from neuronika_tpu import utils as jutils
from neuronika_tpu.models import transformer as JT
from neuronika_tpu.utils import metrics as jmetrics
from neuronika_tpu_torch import utils as tutils
from neuronika_tpu_torch.models import transformer as TT
from neuronika_tpu_torch.utils import checkpoint as tck
from neuronika_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(autouse=True)
def _cpu():
    old = nk.config.device
    nk.config.device = "cpu"
    yield
    nk.config.device = old


# -------------------------------------------------------------- metrics


def _log_run(mod, path, monkeypatch):
    """Five log calls under a clock that advances 0.25 s of perf_counter
    and 1 s of wall time per reading; returns the history."""
    ticks = iter(range(100))
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(ticks))
    walls = iter(range(100))
    monkeypatch.setattr(time, "time", lambda: 1e9 + next(walls))
    rng = np.random.default_rng(0)
    with mod.MetricsLogger(path, print_every=2, ema=0.9,
                           tokens_per_step=512, flops_per_step=1e9,
                           peak_flops=1e12) as m:
        for step in (0, 1, 2, 4, 4):
            m.log(step, loss=float(rng.standard_normal()), lr=1e-3 * step)
        summary = m.summary()
    return m.history, summary


def test_metrics_logger_records_match_jax(tmp_path, monkeypatch, capsys):
    jh, js = _log_run(jmetrics, str(tmp_path / "j.jsonl"), monkeypatch)
    jout = capsys.readouterr().out
    th, ts = _log_run(tmetrics, str(tmp_path / "t.jsonl"), monkeypatch)
    assert th == jh and ts == js
    assert capsys.readouterr().out == jout
    with open(tmp_path / "j.jsonl") as f, open(tmp_path / "t.jsonl") as g:
        assert [json.loads(x) for x in g] == [json.loads(x) for x in f]


# --------------------------------------------------------- params trees


def _gpt_tree():
    """A tied GPT's params from JAX's init (f32) plus an int leaf, with the
    port's copy; the port's keys are in an insertion order other than
    JAX's sorted one."""
    cfg = JT.GPTConfig(vocab_size=32, n_layer=2, n_head=2, d_model=16,
                       d_ff=32, max_seq=8, dtype=jnp.float32)
    jp = JT.init_params(jax.random.key(0), cfg)
    jp = dict(jp, step=jnp.arange(3, dtype=jnp.int32))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp))
    tp = {k: tp[k] for k in ("wte", "wpe", "step", "ln_f", "blocks")}
    assert list(tp) != sorted(tp)
    return jp, tp


def _same(t_tree, j_tree):
    jl, tl = jax.tree.leaves(j_tree), tutils.serde._jax_order(t_tree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32))


def test_jax_file_loads_in_the_port(tmp_path):
    jp, tp = _gpt_tree()
    path = str(tmp_path / "j.npz")
    jutils.save_pytree(path, jp)
    got = tutils.load_pytree(path, tree_map(torch.zeros_like, tp))
    assert list(got) == list(tp)            # the like tree's key order
    _same(got, jp)


def test_port_file_loads_in_jax(tmp_path):
    jp, tp = _gpt_tree()
    path = str(tmp_path / "t.npz")
    tutils.save_pytree(path, tp)
    got = jutils.load_pytree(path, jax.tree.map(jnp.zeros_like, jp))
    _same(tp, got)
    with np.load(path) as f:
        text = bytes(f["__treedef__"]).decode()
    assert text == str(jax.tree.structure(jp))


def test_bf16_leaves_cross_as_raw_16_bit(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tt = TT.params_from_jax(jax.tree.map(np.asarray, jt))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jutils.save_pytree(jpath, jt)
    tutils.save_pytree(tpath, tt)
    got = tutils.load_pytree(jpath, tt)
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], tt[k])
    with np.load(jpath) as a, np.load(tpath) as b:
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            assert a[name].tobytes() == b[name].tobytes()
    with pytest.raises(TypeError, match="bf16"):
        tutils.load_pytree(jpath, {k: v.float() for k, v in tt.items()})


# ---------------------------------------------------------- checkpoints


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b16": torch.randn(5, generator=g).bfloat16()},
            "opt": [torch.randn(2, generator=g), (torch.arange(3),)],
            "step": torch.tensor(seed, dtype=torch.int32),
            "gen": torch.Generator().manual_seed(seed).get_state()}


def _equal(a, b):
    la, lb = (tutils.serde._jax_order(t) for t in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_round_trip_and_retention(tmp_path, async_save):
    ck = tck.Checkpointer(str(tmp_path), keep=2, async_save=async_save)
    for step in (1, 2, 3):
        assert ck.save(step, _state(step))
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    _equal(ck.restore(), _state(3))
    like = _state(0)
    got = ck.restore(2, like=like)
    _equal(got, _state(2))
    assert isinstance(got["opt"][1], tuple)
    assert not ck.save(3, _state(3)) and not ck.save(2, _state(2))
    with pytest.raises(ValueError, match="exists"):
        ck.save(3, _state(3), force=True)
    with pytest.raises(ValueError, match="structure"):
        ck.restore(2, like={"params": like["params"]})
    # a new Checkpointer on the directory sees the same steps
    assert tck.Checkpointer(str(tmp_path), keep=2).steps() == [2, 3]
    ck.close()


def test_checkpoint_is_a_snapshot(tmp_path):
    """The train step updates in place after `save()` returns; the file
    holds the values at the call."""
    ck = tck.Checkpointer(str(tmp_path), keep=None)
    state = _state(4)
    ck.save(7, state)
    state["params"]["w"].add_(1.0)
    state["params"]["b16"].mul_(2.0)
    ck.wait()
    _equal(ck.restore(7), _state(4))


@pytest.mark.parametrize("async_save", [True, False])
def test_failed_write_leaves_the_latest_checkpoint_whole(tmp_path,
                                                         monkeypatch,
                                                         async_save):
    ck = tck.Checkpointer(str(tmp_path), keep=2, async_save=async_save)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    ck.wait()

    def broken(path, tree):          # half a file, then the failure
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 truncated")
        raise OSError("disk full")

    monkeypatch.setattr(tck, "save_pytree", broken)
    with pytest.raises(OSError, match="disk full"):
        ck.save(3, _state(3))
        ck.wait()
    assert ck.steps() == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    _equal(ck.restore(), _state(2))
    # a run killed mid-save leaves a temporary directory; the next
    # Checkpointer on the directory removes it and keeps the rest
    os.makedirs(tmp_path / ".tmp-3-dead")
    (tmp_path / ".tmp-3-dead" / "state.npz").write_bytes(b"PK")
    assert tck.Checkpointer(str(tmp_path)).steps() == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]


def test_save_and_restore_train_state(tmp_path):
    tck.save_train_state(str(tmp_path), 5, _state(5))
    _equal(tck.restore_train_state(str(tmp_path)), _state(5))
    with pytest.raises(FileNotFoundError):
        tck.restore_train_state(str(tmp_path / "empty"))


def test_save_decisions_and_steps_match_orbax(tmp_path):
    from neuronika_tpu.utils.checkpoint import Checkpointer as JCk

    j = JCk(str(tmp_path / "j"), keep=2, async_save=False)
    t = tck.Checkpointer(str(tmp_path / "t"), keep=2, async_save=False)
    jstate = {"w": jnp.ones((2,), jnp.float32)}
    tstate = {"w": torch.ones(2)}
    for step, force in ((1, False), (2, False), (2, False), (1, False),
                        (4, False), (3, False), (6, True), (5, True)):
        assert t.save(step, tstate, force) == j.save(step, jstate, force)
        assert t.steps() == list(j.steps()), step
        assert t.latest_step() == j.latest_step()
    for ck in (j, t):
        with pytest.raises(ValueError):
            ck.save(6, jstate if ck is j else tstate, force=True)
    j.close()
    t.close()
