"""Ring attention and the context-parallel GPT step (neuronika_tpu_torch/
parallel/ring.py, the `cp` mesh axis) against the JAX package on the CPU,
mirroring tests/test_ring.py.

The oracle of JAX's ring tests is its `reference_attention` on the
gathered arrays (the ring's combine is exact), so the port's ring is held
to it within REF_TOL, outputs and gradients, causal and non-causal:
first the per-hop code on a virtual ring in this process (`ring_forward`
and `ring_backward` with `rotate`, as chip_smoke.py runs it on the card),
then `ring_flash_attention` itself on rings of 2 and 4 gloo ranks. The
model cases run `make_sharded_train_step` on dp x cp meshes against JAX's
steps (tests/test_torch_parallel.py's helpers and bounds). All rank work
runs in ONE spawn of 4 ranks (60 s a collective, 240 s in all), while JAX
computes its references; the ranks import this module, so jax is
imported only inside the functions that compute the references."""

import concurrent.futures
import functools
import sys

import numpy as np
import pytest
import torch

from neuronika_tpu_torch import parallel as P
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.parallel import ring as R
from tests.test_torch_parallel import (LR, PG_TIMEOUT, RUN_LIMIT, TOL, WORLD,
                                       _batch, _moments_close, _np_params,
                                       _numpy_tree, _params_close)

# conftest's REF_TOL (the reference's F16_EPSILON); not imported from
# conftest, whose import loads the JAX package into the ranks
REF_TOL = 4.88e-4
# bf16 inputs: both sides round the output to bf16 once (2^-8 of |o| <= 4
# is 2^-6), plus f32 summation order; JAX's own ring test holds 2e-2
BF16_TOL = 2e-2
# saturated softmax (scores x 30): relative to the gradient's magnitude,
# JAX's test's bound
EXTREME_REL = 5e-3


def _qkv(S=256, D=64, B=2, H=2, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (scale * rng.standard_normal((3, B, H, S, D))).astype(
        np.float32)
    w = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, w


# the inputs of each case (_qkv's keywords)
CASES = {"base": {}, "bf16": dict(S=128), "extreme": dict(B=1, scale=30.0)}


@functools.cache
def _jax_reference(case, causal, dtype="float32"):
    """JAX's reference_attention on the whole arrays of `case`, and the
    gradients of sum(out * w) (once a process: the virtual and the
    distributed rings share them)."""
    import jax
    import jax.numpy as jnp

    from neuronika_tpu.ops.pallas.attention import reference_attention

    q, k, v, w = _qkv(**CASES[case])
    q, k, v = (jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v))
    out = reference_attention(q, k, v, causal)
    grads = jax.grad(lambda a, b, c: (reference_attention(a, b, c, causal)
                                      .astype(jnp.float32) * w).sum(),
                     (0, 1, 2))(q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _virtual_ring(q, k, v, w, n, causal, dtype=torch.float32):
    """The ring's per-hop code over n ranks held in this process."""
    blocks = [[torch.from_numpy(b).to(dtype) for b in np.split(t, n, 2)]
              for t in (q, k, v)]
    outs, lses = R.ring_forward(*blocks, range(n), n, causal, None,
                                R.rotate)
    dos = [torch.from_numpy(b).to(dtype) for b in np.split(w, n, 2)]
    grads = R.ring_backward(*blocks, outs, dos, lses, range(n), n, causal,
                            None, R.rotate)
    return [torch.cat(ts, 2).float().numpy() for ts in (outs, *grads)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_virtual_ring_matches_jax(n, causal):
    for got, want in zip(_virtual_ring(*_qkv(), n, causal),
                         _jax_reference("base", causal)):
        assert float(np.abs(got - want).max()) <= REF_TOL


def test_virtual_ring_bf16():
    got = _virtual_ring(*_qkv(**CASES["bf16"]), 4, True, torch.bfloat16)[0]
    want = _jax_reference("bf16", True, "bfloat16")[0]
    assert float(np.abs(got - want).max()) <= BF16_TOL


def test_virtual_ring_extreme_scores_gradients_finite():
    """Scores x 30 saturate the softmax: the past hops' p = 2^(s - lse)
    must stay finite and right (JAX's regression for its masked future
    hops; the port skips those hops)."""
    got = _virtual_ring(*_qkv(**CASES["extreme"]), 4, True)
    want = _jax_reference("extreme", True)
    for a, b in zip(got[1:], want[1:]):
        assert np.isfinite(a).all()
        assert float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1.0) \
            <= EXTREME_REL


def test_live_hops_skip_the_future():
    assert [R.hop_live(2, h, True) for h in range(4)] == [True] * 3 + [False]
    assert all(R.hop_live(0, h, False) for h in range(4))


# --------------------------------------------------------------------------
# the ranks

# (mesh axes, GPTConfig fields, batch B, S): the cp model cases
CP_TINY = dict(vocab_size=32, n_layer=2, n_head=4, d_model=32, d_ff=64,
               max_seq=128)
MODELS = {
    "dp2cp2": ([("dp", 2), ("cp", 2)], CP_TINY, 4, 128),
    "tp2cp2_rope": ([("tp", 2), ("cp", 2)], dict(CP_TINY, pos_emb="rope"),
                    4, 128),
    # an encoder: every hop contributes (JAX's BERT-under-cp case)
    "noncausal": ([("dp", 2), ("cp", 2)], dict(CP_TINY, causal=False), 4,
                  128),
    # S 384 over cp 4: 96 local rows, no multiple of JAX's blocks
    "cp4_s384": ([("cp", 4)], dict(CP_TINY, n_layer=1, n_head=2,
                                   max_seq=384), 4, 384),
}
JAX_SHARDED = ("dp2cp2",)


def _job_ring(rank, q, k, v, w):
    """ring_flash_attention on rings of 2 (two of them) and of 4: this
    rank's block of out, dq, dk, dv, and how many neighbour exchanges each
    made; an all-gather raises meanwhile (JAX's test holds its HLO free of
    one)."""
    import torch.distributed as dist

    from neuronika_tpu_torch.parallel import collectives as C

    def refuse(*a, **k):
        raise AssertionError("the ring gathered the sequence")

    exchanges = []
    real = dist.batch_isend_irecv

    def count(ops):
        exchanges[-1] += 1
        return real(ops)

    saved = (C._all_gather, dist.all_gather)
    C._all_gather = dist.all_gather = refuse
    dist.batch_isend_irecv = count
    out = {}
    try:
        for n in (2, 4):
            mesh = P.make_mesh([("dp", WORLD // n), ("cp", n)])
            i = mesh.get_local_rank("cp")
            for causal in (True, False):
                exchanges.append(0)
                ts = [torch.from_numpy(np.split(t, n, 2)[i])
                      .requires_grad_() for t in (q, k, v)]
                o = P.ring_flash_attention(*ts, mesh.get_group("cp"), n,
                                           causal)
                (o * torch.from_numpy(np.split(w, n, 2)[i])).sum() \
                    .backward()
                out[(n, causal)] = [t.detach().numpy()
                                    for t in (o, *(x.grad for x in ts))]
                out[("exchanges", n, causal)] = exchanges[-1]
    finally:
        C._all_gather, dist.all_gather = saved
        dist.batch_isend_irecv = real
    return out


def _job_models(rank, params, batches):
    out = {}
    for name, (axes, kw, B, S) in MODELS.items():
        cfg = T.GPTConfig(dtype=torch.float32, **kw)
        step = T.make_sharded_train_step(P.make_mesh(axes), cfg)
        p = T.params_from_jax(params[name])
        toks, tgts = (torch.from_numpy(a) for a in batches[name])
        p, opt, loss = step(p, T.opt_init(p, cfg), toks, tgts, LR)
        out[name] = {"loss": float(loss), "params": _numpy_tree(p),
                     "m": _numpy_tree(opt["m"])}
    refused = {}
    for name, kw in (("dropout", dict(dropout=0.1)), ("window",
                                                      dict(window=8))):
        cfg = T.GPTConfig(dtype=torch.float32, **dict(CP_TINY, **kw))
        p = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        toks = torch.zeros(4, 128, dtype=torch.int64)
        try:
            T.make_sharded_train_step(P.make_mesh([("dp", 2), ("cp", 2)]),
                                      cfg)(p, T.opt_init(p, cfg), toks,
                                           toks, LR,
                                           torch.Generator().manual_seed(1))
            refused[name] = "no error"
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


def _rank(rank, jobs):
    import neuronika_tpu_torch as nk

    nk.config.device = "cpu"
    fns = {"ring": _job_ring, "models": _job_models}
    out = {name: fns[name](rank, *args) for name, args in jobs}
    out["jax_loaded"] = [m for m in ("jax", "neuronika_tpu")
                         if m in sys.modules]
    return out


@pytest.fixture(scope="module")
def inputs():
    params = {name: _np_params(kw) for name, (_, kw, _B, _S)
              in MODELS.items()}
    batches = {name: _batch(kw["vocab_size"], B, S)
               for name, (_, kw, B, S) in MODELS.items()}
    return _qkv(), params, batches


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    qkvw, params, batches = inputs
    jobs = [("ring", qkvw), ("models", (params, batches))]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(P.mesh.spawn, _rank, WORLD, (jobs,),
                         init_file=str(tmp / "store"), timeout=PG_TIMEOUT,
                         limit=RUN_LIMIT)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_refs(launched, inputs):
    import jax
    import jax.numpy as jnp

    from neuronika_tpu import parallel as JP
    from neuronika_tpu.models import transformer as JT

    _, params, batches = inputs
    ring = {c: _jax_reference("base", c) for c in (True, False)}
    steps = {}
    for name, (axes, kw, B, S) in MODELS.items():
        jcfg = JT.GPTConfig(dtype=jnp.float32, **dict(kw, flash="off"))
        toks, tgts = (jnp.asarray(a) for a in batches[name])
        p0 = jax.tree.map(jnp.asarray, params[name])
        runs = [("unsharded", JT.make_train_step(jcfg))]
        if name in JAX_SHARDED:
            mesh = JP.make_mesh(axes, devices=jax.devices()[:WORLD])
            runs.append(("sharded", JT.make_sharded_train_step(mesh, jcfg)))
        steps[name] = {}
        for key, step in runs:
            p, opt, loss = step(jax.tree.map(jnp.copy, p0),
                                JT.adam_init(p0), toks, tgts,
                                jnp.float32(LR), jax.random.key(2))
            steps[name][key] = (float(loss), jax.tree.map(np.asarray, p),
                                jax.tree.map(np.asarray, opt["m"]))
    return ring, steps


@pytest.fixture(scope="module")
def ranks(launched, jax_refs):
    return launched.result()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_attention_matches_jax(ranks, jax_refs, n, causal):
    """Each rank's block of out, dq, dk and dv (dk, dv back home after the
    n hops) against JAX's whole-array reference."""
    want = jax_refs[0][causal]
    got = [np.concatenate([r["ring"][(n, causal)][j] for r in ranks[:n]],
                          2) for j in range(4)]     # ranks 0..n-1: dp 0
    for a, b in zip(got, want):
        assert float(np.abs(a - b).max()) <= REF_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_ring_moves_blocks_by_neighbour_exchanges_only(ranks, n):
    """n - 1 exchanges forward (k, v) and n backward (k, v and the dk/dv
    accumulators, the last taking them home); no all-gather."""
    for r in ranks[:n]:
        for causal in (True, False):
            assert r["ring"][("exchanges", n, causal)] == 2 * n - 1


@pytest.mark.parametrize("name", list(MODELS))
def test_context_parallel_step_matches_jax(ranks, jax_refs, name):
    """The GPT body S-sharded over cp with attention on the ring: loss (the
    same on every rank), params and Adam's first moment against JAX's unsharded step, and for
    dp2xcp2 against JAX's sharded step on the same mesh shape."""
    port = [r["models"][name] for r in ranks]
    assert len({p["loss"] for p in port}) == 1
    for key, (jloss, jparams, jm) in jax_refs[1][name].items():
        assert abs(port[0]["loss"] - jloss) <= TOL, key
        _params_close(port[0]["params"], jparams)
        _moments_close(port[0]["m"], jm)


def test_ranks_load_no_jax(ranks):
    assert all(r["jax_loaded"] == [] for r in ranks)


@pytest.mark.parametrize("what, word", [("dropout", "dropout"),
                                        ("window", "sliding-window")])
def test_cp_refuses_dropout_and_windows(ranks, what, word):
    """As JAX's: the ring takes neither (ValueError, naming it)."""
    msg = ranks[0]["models"]["refused"][what]
    assert "context parallelism" in msg and word in msg
