"""The port's dense-slot `ContinuousBatcher`, the paged batcher's quant
modes and multi-step decode windows (neuronika_tpu_torch/serving.py) on
the CPU in f32, held against the JAX package's batchers on its gather path
(params through `params_from_jax`). The cases of tests/test_models.py's
TestContinuousBatching (:923), TestPagedBatcher (:1016), TestServingUX
(:2483) and TestMultiStepDecode (:2554):

* greedy tokens of the dense and the paged batcher, in every quant mode,
  identical to the JAX dense batcher's for the same requests (JAX refuses
  "int8-kv" on slots: that mode is held to JAX's int8-kv prefill and
  decode steps request by request); with preemption, rope + GQA + a
  window, an early eos;
* `step_many`/`run(multi_step=)` give, bit for bit, the tokens of the
  port's own per-step path for greedy and seeded sampled rows alike
  (sampled draws cannot match JAX's PRNG), stop and eos overshoot
  discarded, paged windows preempting; greedy rows also equal JAX's;
* the block pool's partition invariant under a random mixed workload, an
  unsatisfiable window evicting nobody, admission gated on blocks, stop
  sequences, streaming and metrics as JAX's tests hold them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronika_tpu import serving as JS
from neuronika_tpu.models import transformer as JT
from neuronika_tpu_torch import serving as TS
from neuronika_tpu_torch.models import transformer as TT

BASE = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
            max_seq=48)
# the requests of tests/test_models.py::TestContinuousBatching
PROMPTS = [np.array([1, 2, 3, 4], np.int32), np.array([7, 8], np.int32),
           np.array([9, 10, 11, 12, 13, 14, 15, 16], np.int32)]
MAX_NEWS = [10, 4, 7]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the port's decode loops run
    many small ops, which one thread runs faster, and the tier-1 run's
    parallel workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def model(**kw):
    """(jax cfg, port cfg, jax params, port params) of the JAX tests'
    serving model with `kw` on top."""
    base = dict(BASE, **kw)
    jcfg = JT.GPTConfig(dtype=jnp.float32, flash="off", **base)
    tcfg = TT.GPTConfig(dtype=torch.float32, **base)
    jp = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, TT.params_from_jax(jax.tree.map(np.asarray, jp))


def serve(b, prompts=PROMPTS, max_news=MAX_NEWS, multi_step=1, kws=None,
          defer=False):
    """Submit the requests to batcher `b`, run it; outputs in order."""
    kws = kws or [{}] * len(prompts)
    if defer:
        with b.defer_admission():
            rids = [b.submit(p, m, **kw)
                    for p, m, kw in zip(prompts, max_news, kws)]
    else:
        rids = [b.submit(p, m, **kw)
                for p, m, kw in zip(prompts, max_news, kws)]
    done = b.run(multi_step=multi_step)
    return [done[r] for r in rids]


@functools.lru_cache(maxsize=None)
def jax_dense(quant=None, **kw):
    """The JAX dense batcher's greedy tokens for PROMPTS (two slots, exact
    prefill: tests/test_models.py's TestContinuousBatching)."""
    jcfg, _, jp, _ = model(**kw)
    return serve(JS.ContinuousBatcher(jp, jcfg, n_slots=2, quant=quant))


@functools.lru_cache(maxsize=None)
def jax_batcher(quant=None, n_adapters=0, **kw):
    """One JAX dense batcher a (quant mode, adapters, config), reused by
    every test of the process: bucketed prefill (JAX's tests hold it to
    exact prefill), one request at a time, so each jitted program
    compiles once a bucket. With `n_adapters`, the JAX adapters of
    tests/test_torch_serving_adapters.py are registered."""
    jcfg, _, jp, _ = model(**kw)
    jb = JS.ContinuousBatcher(jp, jcfg, n_slots=4, quant=quant,
                              prefill_bucket="pow2")
    jb._group_prefill = False
    if n_adapters:
        from tests.test_torch_serving_adapters import adapters

        for _, ad in adapters()[:n_adapters]:
            jb.register_adapter(ad)
    return jb


@functools.lru_cache(maxsize=None)
def _jax_programs(quant=None, **kw):
    jcfg = model(**kw)[0]
    return JT.make_prefill(jcfg, quant), JT.make_decode_step(jcfg, quant)


def jax_decode_alone(prompts, max_news, quant=None, params=None, **kw):
    """JAX's greedy tokens of each prompt alone by its prefill and decode
    programs (compiled once a prompt length); `params` replaces the
    model's (the same shapes)."""
    jcfg, _, jp, _ = model(**kw)
    params = jp if params is None else params
    pre, dec = _jax_programs(quant, **kw)
    out = []
    for p, m in zip(prompts, max_news):
        cache = JT.init_kv_cache(jcfg, 1, quant=quant)
        logits, cache = pre(params, cache, jnp.asarray(p[None]))
        toks = []
        for t in range(m):
            nxt = logits.argmax(-1).astype(jnp.int32)
            toks.append(int(nxt[0]))
            if t + 1 < m:
                logits, cache = dec(params, cache, nxt)
        out.append(np.asarray(toks, np.int32))
    return out


def jax_greedy(prompts=PROMPTS, max_news=MAX_NEWS, quant=None, adapters=None,
               **kw):
    """JAX's greedy tokens for the requests (`adapters`: each one's
    adapter id), through `jax_batcher`."""
    if quant == "int8-kv":       # JAX's slot programs refuse the int8 cache
        return jax_decode_alone(prompts, max_news, quant, **kw)
    ids = adapters or [0] * len(prompts)
    jb = jax_batcher(quant, max(ids), **kw)
    return serve(jb, prompts, max_news, kws=[dict(adapter=a) for a in ids])


def dense(n_slots=2, **kw):
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in ("n_kv_head", "pos_emb",
                                                     "window")}
    _, tcfg, _, tp = model(**cfg_kw)
    return TS.ContinuousBatcher(tp, tcfg, n_slots=n_slots, device="cpu",
                                **kw)


def paged(n_slots=2, n_blocks=16, block_size=8, **kw):
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in ("n_kv_head", "pos_emb",
                                                     "window")}
    _, tcfg, _, tp = model(**cfg_kw)
    return TS.PagedBatcher(tp, tcfg, n_slots=n_slots, n_blocks=n_blocks,
                           block_size=block_size, device="cpu", **kw)


def same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_dense_and_paged_match_jax_dense_batcher(quant):
    want = jax_dense(quant)
    cb = dense(quant=quant)
    rids = [cb.submit(p, m) for p, m in zip(PROMPTS, MAX_NEWS)]
    assert cb.stats[1] == 1         # the third request queued behind 2 slots
    done = cb.run()
    same([done[r] for r in rids], want)
    pb = paged(quant=quant)
    same(serve(pb), want)
    assert pb.block_stats == (0, 15) and pb.preemptions == 0


def test_dense_int8_kv_matches_jax_decode():
    """JAX's slot programs refuse the int8 cache; the port's serve it, and
    each request's greedy tokens equal JAX's int8-kv decode alone."""
    cb = dense(quant="int8-kv")
    assert cb.cache["k"].dtype == torch.int8
    want = jax_greedy(quant="int8-kv")
    same(serve(cb), want)
    same(serve(dense(quant="int8-kv"), multi_step=4), want)


def test_paged_preemption_preserves_output():
    pb = paged(n_blocks=5, block_size=4)
    same(serve(pb), jax_dense())
    assert pb.preemptions > 0 and pb.block_stats == (0, 4)


def test_rope_gqa_sliding_window():
    kw = dict(n_kv_head=2, pos_emb="rope", window=6)
    want = jax_dense(**kw)
    same(serve(dense(**kw)), want)
    same(serve(paged(**kw)), want)
    same(serve(paged(**kw, kernel="off"), multi_step=4), want)


def test_eos_frees_slot_early():
    first = int(jax_greedy([np.array([5, 6, 7], np.int32)], [1])[0][0])
    cb = dense(n_slots=1, eos_id=first)
    rid = cb.submit(np.array([5, 6, 7], np.int32), max_new=20)
    done = cb.run()
    np.testing.assert_array_equal(done[rid], [first])


# --------------------------------------------------------------------------
# multi-step decode windows


def _mixed(eos_tok=None):
    """TestMultiStepDecode's requests: greedy, top-k, top-p and a stop."""
    prompts = PROMPTS + [np.array([20, 21, 22], np.int32)]
    kws = [dict(), dict(temperature=0.9, top_k=8, seed=3),
           dict(temperature=1.2, top_p=0.8, seed=5),
           dict(stop=[[eos_tok]] if eos_tok is not None else None)]
    return dict(prompts=prompts, max_news=[10, 4, 7, 12], kws=kws)


def test_dense_windows_match_per_step():
    ref = serve(dense(n_slots=3), **_mixed())
    for k in (2, 4, 8):
        same(serve(dense(n_slots=3), multi_step=k, **_mixed()), ref)
    np.testing.assert_array_equal(ref[0], jax_dense()[0])   # greedy row


def test_dense_stop_and_eos_overshoot_discarded():
    p = np.array([5, 6, 7], np.int32)
    first = int(jax_greedy([p], [1])[0][0])
    reqs = dict(prompts=[p, np.array([30, 31], np.int32)], max_news=[20, 9])
    ref = serve(dense(eos_id=first), **reqs)
    out = serve(dense(eos_id=first), multi_step=8, **reqs)
    same(out, ref)
    assert len(out[0]) == 1          # stopped at eos immediately


@pytest.mark.parametrize("n_blocks, block_size", [(16, 8), (5, 4)])
def test_paged_windows_match_per_step(n_blocks, block_size):
    a = paged(n_slots=3, n_blocks=n_blocks, block_size=block_size)
    ref = serve(a, **_mixed())
    b = paged(n_slots=3, n_blocks=n_blocks, block_size=block_size)
    same(serve(b, multi_step=4, **_mixed()), ref)
    assert b.block_stats[0] == 0
    if n_blocks == 5:
        assert b.preemptions > 0
    np.testing.assert_array_equal(ref[0], jax_dense()[0])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_windows_match_jax(quant):
    same(serve(paged(quant=quant), multi_step=4), jax_dense(quant))
    same(serve(dense(quant=quant), multi_step=4), jax_dense(quant))


def test_window_reads_tokens_once():
    """A window of k steps reads its tokens back once: the program returns
    them as one (k, B) tensor, and the scheduler calls it once a window."""
    pb = paged()
    calls = []
    prog = pb._many_prog

    def counted(k):
        fn = prog(k)

        def run(*a):
            toks, cache = fn(*a)
            calls.append((k, tuple(toks.shape)))
            return toks, cache
        return run

    pb._many_prog = counted
    out = serve(pb, multi_step=4)
    same(out, jax_dense())
    assert calls and all(shape == (k, 2) for k, shape in calls)


def test_sampled_request_is_independent_of_its_batchmates_dense():
    kw = dict(temperature=0.9, top_k=8, seed=42)
    prompt = np.array([9, 10, 11], np.int32)
    alone = serve(dense(n_slots=3), [prompt], [10], kws=[kw])[0]
    crowded = serve(dense(n_slots=3),
                    [np.array([20, 21], np.int32), prompt,
                     np.array([30], np.int32)], [12, 10, 6],
                    kws=[{}, kw, dict(temperature=1.2, seed=7)])
    np.testing.assert_array_equal(crowded[1], alone)
    # top-k 1 is greedy
    cb = dense()
    r0, r1 = (cb.submit(prompt, 8), cb.submit(prompt, 8, temperature=1.7,
                                               top_k=1))
    out = cb.run()
    np.testing.assert_array_equal(out[r1], out[r0])


# --------------------------------------------------------------------------
# the block pool


def test_block_pool_partition_invariant():
    """Every block id 1..n_blocks-1 sits in exactly one of the free list,
    a prefix's reservation or one slot's own list after every step of a
    random workload of prefix hits, chunked prefill, windows and
    preemption; every request gets its full budget."""
    pb = paged(n_slots=3, n_blocks=14, block_size=4, prefill_chunk=4)

    def check():
        free = list(pb._free_blocks)
        pref = [b for _, blocks in pb._paged_prefixes
                for b in np.asarray(blocks).tolist()]
        owned = [b for bl in pb._slot_blocks.values() for b in bl]
        ids = free + pref + owned
        assert len(ids) == len(set(ids)), "block owned twice"
        assert set(ids) == set(range(1, pb.n_blocks)), "block leaked"

    prefix = np.arange(1, 9, dtype=np.int32)          # 2 full blocks
    pb.register_prefix(prefix)
    check()
    rng = np.random.default_rng(7)
    want = {}
    for _ in range(9):
        if rng.random() < 0.4:
            p = np.concatenate([prefix, rng.integers(1, 64, 3).astype(
                np.int32)])
        else:
            p = rng.integers(1, 64, int(rng.integers(2, 9))).astype(np.int32)
        new = int(rng.integers(2, 7))
        want[pb.submit(p, new)] = new
    guard = 0
    while (pb._running or pb._queue) and guard < 300:
        if guard % 3 == 2:
            pb.step_many(2)
        else:
            pb.step()
        check()
        guard += 1
    assert guard < 300, "batcher did not drain"
    out = pb.run()
    check()
    assert {r: len(t) for r, t in out.items()} == want


def test_unsatisfiable_window_does_not_evict():
    pb = paged(n_blocks=5, block_size=4)
    rids = [pb.submit(np.array(p, np.int32), 4)
            for p in ([1, 2, 3, 4], [5, 6, 7, 8])]
    pb.step()
    assert len(pb._running) == 2
    pos = pb._pos.copy()
    assert pb._grow_many(32) is False
    assert pb.preemptions == 0 and len(pb._running) == 2
    np.testing.assert_array_equal(pb._pos, pos)
    out = pb.run()
    assert pb.preemptions == 0 and all(len(out[r]) == 4 for r in rids)


def test_admission_gated_on_blocks_and_oversized_rejected():
    pb = paged(n_slots=4, n_blocks=5, block_size=4)
    pb.submit(np.arange(1, 13, dtype=np.int32), 4)    # 3 blocks
    pb.submit(np.arange(1, 9, dtype=np.int32), 4)     # needs 2: only 1
    assert pb.stats[:2] == (1, 1)
    assert len(pb.run()) == 2
    small = paged(n_slots=1, n_blocks=3, block_size=4)
    with pytest.raises(ValueError, match="blocks"):
        small.submit(np.arange(1, 9, dtype=np.int32), 8)


# --------------------------------------------------------------------------
# serving UX


def _host_stop(tokens, stops):
    """The tokens a stop list lets through, replayed on the host."""
    out = []
    for t in tokens:
        out.append(t)
        for s in stops:
            if len(out) >= len(s) and out[-len(s):] == s:
                return out[:-len(s)]
    return out


def test_stop_sequence_trims():
    p = np.array([3, 4, 5], np.int32)
    sample = dict(temperature=1.0, seed=7)
    ref = serve(dense(n_slots=1), [p], [10], kws=[sample])[0].tolist()
    stop = [ref[2:4], ref[6:9]]
    expect = _host_stop(ref, stop)
    assert len(expect) < len(ref)
    for ms in (1, 4):
        out = serve(dense(n_slots=1), [p], [10], multi_step=ms,
                    kws=[dict(stop=stop, **sample)])[0]
        np.testing.assert_array_equal(out, np.asarray(expect, np.int32))


def test_on_token_streams_everything_and_metrics_accumulate():
    got = []
    cb = dense()
    r1 = cb.submit(np.array([3, 4, 5], np.int32), 7,
                   on_token=lambda rid, t: got.append((rid, t)))
    r2 = cb.submit(np.array([9, 8], np.int32), 5)
    out = cb.run(multi_step=4)
    np.testing.assert_array_equal([t for rid, t in got if rid == r1],
                                  out[r1])
    assert not any(rid == r2 for rid, _ in got)
    m = cb.metrics
    assert m["completed"] == 2 and m["tokens_out"] == 12
    assert m["ttft_mean_s"] > 0.0 and m["itl_mean_s"] > 0.0
