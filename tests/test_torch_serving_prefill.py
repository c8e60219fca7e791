"""The port's prefill paths in both batchers (neuronika_tpu_torch/
serving.py): chunked (`prefill_chunk`), bucketed (`prefill_bucket`),
grouped admission (`defer_admission`, `make_*_prefill_multi`) and the
prefix cache (`register_prefix`), on the CPU in f32 against the JAX
package. The cases of tests/test_models.py's TestChunkedPrefill (:2340),
TestGroupedPrefill (:2647), TestBucketedPrefill (:2786) and the prefix
cases of TestContinuousBatching and TestPagedBatcher:

* greedy tokens identical to JAX's greedy decode of each prompt alone
  (JAX's tests hold every one of these paths to its one-shot prefill);
* sampled requests (temperature 0.7, seeded) through grouped admission
  give the tokens of the port's own one-by-one admission, bit for bit;
* the program counts and pool accounting JAX's tests assert."""

import numpy as np
import pytest

from tests.test_torch_serving_slots import (PROMPTS, dense, jax_greedy,  # noqa: F401
                                            one_thread, paged, same,
                                            serve)

# TestChunkedPrefill's prompts: 17 is odd, so the last chunk overlaps
CHUNK_PROMPTS = [np.random.default_rng(3).integers(1, 60, n).astype(np.int32)
                 for n in (20, 17, 3)]
# TestBucketedPrefill's: 3, 5, 6, 11 land in pow2 bucket 16, 17 in 32
BUCKET_PROMPTS = [np.arange(1, n + 1, dtype=np.int32)
                  for n in (3, 5, 6, 11, 17)]
BUCKET_NEWS = [6, 4, 5, 7, 6]


# --------------------------------------------------------------- chunked


@pytest.mark.parametrize("quant", [None, "int4"])
def test_dense_chunked_matches_jax(quant):
    want = jax_greedy(CHUNK_PROMPTS, [8] * 3, quant)
    same(serve(dense(quant=quant, prefill_chunk=8), CHUNK_PROMPTS, [8] * 3),
         want)


def test_paged_chunked_matches_jax():
    want = jax_greedy(CHUNK_PROMPTS, [8] * 3)
    same(serve(paged(n_blocks=32, prefill_chunk=8), CHUNK_PROMPTS, [8] * 3),
         want)
    same(serve(paged(n_blocks=32, prefill_chunk=8, quant="int8"),
               CHUNK_PROMPTS, [8] * 3), jax_greedy(CHUNK_PROMPTS, [8] * 3,
                                                   "int8"))


def test_decode_progress_during_chunked_prefill():
    cb = dense(prefill_chunk=4)
    short = cb.submit(np.array([1, 2, 3], np.int32), 30)
    long_r = cb.submit(np.arange(1, 25, dtype=np.int32), 8)
    req_s = cb._running[0]
    assert cb._prefilling
    before = len(req_s.tokens)
    while cb._prefilling:
        cb.step()
    assert len(req_s.tokens) > before
    out = cb.run()
    np.testing.assert_array_equal(
        out[short], jax_greedy([np.array([1, 2, 3], np.int32)], [30])[0])
    assert long_r in out


def test_paged_preemption_of_chunked():
    p1, p2 = np.arange(1, 17, dtype=np.int32), np.arange(20, 40,
                                                         dtype=np.int32)
    pb = paged(n_blocks=7, prefill_chunk=8)
    same(serve(pb, [p1, p2], [12, 12]), jax_greedy([p1, p2], [12, 12]))
    assert pb.preemptions >= 1


def test_prefix_hit_stays_one_shot():
    from neuronika_tpu_torch.serving import _Request

    system = np.arange(1, 13, dtype=np.int32)
    p_hit = np.concatenate([system, [30, 31]]).astype(np.int32)
    p_miss = np.arange(40, 60, dtype=np.int32)
    cb = dense(prefill_chunk=8)
    cb.register_prefix(system)
    assert not cb._should_chunk(_Request(0, p_hit[None], 6))
    same(serve(cb, [p_hit, p_miss], [6, 6]),
         jax_greedy([p_hit, p_miss], [6, 6]))


# --------------------------------------------------------------- grouped


def _reqs():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 64, (int(rng.choice([4, 4, 8])),))
             .astype(np.int32), int(rng.choice([6, 10]))) for _ in range(9)]


def _serve_reqs(b, temperature, defer, multi_step=1):
    reqs = _reqs()
    return serve(b, [p for p, _ in reqs], [m for _, m in reqs],
                 multi_step=multi_step, defer=defer,
                 kws=[dict(temperature=temperature, seed=i)
                      for i in range(len(reqs))])


@pytest.mark.parametrize("bucket, ms", [(None, 1), (None, 4), ("pow2", 4)])
def test_dense_grouped_matches_per_request(bucket, ms):
    a = dense(n_slots=4, eos_id=9)
    a._group_prefill = False                 # one-by-one admission
    ref = _serve_reqs(a, 0.7, defer=False)
    assert a._multi_prefill is None
    b = dense(n_slots=4, eos_id=9, prefill_bucket=bucket)
    same(_serve_reqs(b, 0.7, defer=True, multi_step=ms), ref)
    assert b._multi_prefill is not None      # the grouped path ran


def test_groups_form_at_window_ends_without_defer():
    a = dense(n_slots=4, eos_id=9)
    a._group_prefill = False
    ref = _serve_reqs(a, 0.7, defer=False)
    b = dense(n_slots=4, eos_id=9)
    same(_serve_reqs(b, 0.7, defer=False, multi_step=4), ref)
    assert b._multi_prefill is not None


@pytest.mark.parametrize("n_blocks, bucket", [(32, None), (32, "pow2"),
                                              (9, None)])
def test_paged_grouped_matches_per_request(n_blocks, bucket):
    a = paged(n_slots=4, n_blocks=32, block_size=4, eos_id=9)
    a._group_prefill = False
    ref = _serve_reqs(a, 0.7, defer=False)
    b = paged(n_slots=4, n_blocks=n_blocks, block_size=4, eos_id=9,
              prefill_bucket=bucket)
    same(_serve_reqs(b, 0.7, defer=True, multi_step=4), ref)
    assert b._multi_prefill is not None and b.block_stats[0] == 0
    if n_blocks == 9:
        assert b.preemptions > 0


@pytest.mark.parametrize("quant", [None, "int8", "int8-kv"])
def test_grouped_greedy_matches_jax(quant):
    reqs = _reqs()
    want = jax_greedy([p for p, _ in reqs], [m for _, m in reqs], quant)
    b = dense(n_slots=4, quant=quant)
    same(_serve_reqs(b, 0.0, defer=True, multi_step=4), want)
    assert b._multi_prefill is not None
    if quant != "int8-kv":
        b = paged(n_slots=4, n_blocks=32, block_size=4, quant=quant)
        same(_serve_reqs(b, 0.0, defer=True), want)
        assert b._multi_prefill is not None


def test_ineligible_requests_stay_on_single_path():
    """Prefix hits and adapter requests take the single-request programs
    inside a deferred burst; the mix matches one-by-one admission."""
    from tests.test_torch_serving_adapters import adapters

    prefix = np.arange(1, 7, dtype=np.int32)
    prompts = [np.concatenate([prefix, [20 + i]]).astype(np.int32)
               for i in range(2)] + [np.array([30 + i, 31, 32, 33], np.int32)
                                     for i in range(4)]
    ads = [0, 0, 1, 0, 0, 1]

    def build():
        cb = dense(n_slots=3, eos_id=9)
        cb.register_adapter(adapters()[0][0])
        cb.register_prefix(prefix)
        return cb

    kws = [dict(temperature=0.5, seed=i, adapter=a)
           for i, a in enumerate(ads)]
    ref = serve(build(), prompts, [8] * 6, kws=kws)
    same(serve(build(), prompts, [8] * 6, kws=kws, defer=True, multi_step=4),
         ref)


# -------------------------------------------------------------- bucketed


@pytest.mark.parametrize("bucket", ["pow2", 8])
def test_dense_bucketed_matches_jax(bucket):
    same(serve(dense(prefill_bucket=bucket), BUCKET_PROMPTS, BUCKET_NEWS),
         jax_greedy(BUCKET_PROMPTS, BUCKET_NEWS))


def test_paged_bucketed_matches_jax():
    pb = paged(prefill_bucket="pow2")
    same(serve(pb, BUCKET_PROMPTS, BUCKET_NEWS, multi_step=2),
         jax_greedy(BUCKET_PROMPTS, BUCKET_NEWS))
    assert pb.block_stats[0] == 0        # exact allocation: all returned
    assert {pb._bucket_len(p.size) for p in BUCKET_PROMPTS} == {16, 32}


def test_bad_bucket_rejected():
    with pytest.raises(ValueError, match="prefill_bucket"):
        dense(prefill_bucket=0)


# ---------------------------------------------------------- prefix cache


@pytest.mark.parametrize("quant", [None, "int4", "int8-kv"])
def test_dense_prefix_cache_matches_jax(quant):
    system = np.array([5, 6, 7, 8, 9, 10], np.int32)
    longer = np.concatenate([system, [11, 12]]).astype(np.int32)
    prompts = [np.concatenate([system, [1, 2]]).astype(np.int32),
               np.concatenate([longer, [3]]).astype(np.int32),  # longest wins
               np.array([40, 41, 42], np.int32)]                # no match
    cb = dense(quant=quant)
    cb.register_prefix(system)
    cb.register_prefix(longer)
    assert cb._match_prefix(prompts[1])[2] == len(longer)
    assert cb._match_prefix(prompts[2]) is None
    same(serve(cb, prompts, [6, 5, 4]), jax_greedy(prompts, [6, 5, 4],
                                                  quant))


@pytest.mark.parametrize("kw", [{}, dict(n_kv_head=2, pos_emb="rope")],
                         ids=["gpt", "rope-gqa"])
def test_paged_prefix_cache_matches_jax(kw):
    prefix = np.arange(1, 18, dtype=np.int32)        # 17 tokens, BS 8
    prompts = [np.concatenate([prefix, e]).astype(np.int32) for e in (
        [20, 21], [30], [40, 41, 42, 43, 44, 45, 46, 47])]
    pb = paged(n_blocks=32, **kw)
    assert pb.register_prefix(prefix) == 0 and pb.reserved_blocks == 2
    same(serve(pb, prompts, [8, 6, 5]), jax_greedy(prompts, [8, 6, 5], **kw))
    assert pb.block_stats == (0, 32 - 1 - 2)


def test_paged_prefix_survives_preemption_and_validates():
    prefix = np.arange(1, 9, dtype=np.int32)          # two blocks of 4
    prompts = [np.concatenate([prefix, [20 + i]]).astype(np.int32)
               for i in range(3)]
    pb = paged(n_blocks=8, block_size=4)
    pb.register_prefix(prefix)
    same(serve(pb, prompts, [10] * 3), jax_greedy(prompts, [10] * 3))
    assert pb.preemptions > 0
    with pytest.raises(ValueError, match="full block"):
        paged(block_size=8).register_prefix(np.arange(5, dtype=np.int32))


def test_bucketed_prefix_cache_matches_jax():
    system = np.array([5, 6, 7, 8, 9, 10], np.int32)
    prompts = [np.concatenate([system, np.arange(1, n + 1)]).astype(np.int32)
               for n in (2, 3, 7, 13)]
    want = jax_greedy(prompts, [6, 4, 5, 5])
    cb = dense(prefill_bucket="pow2")
    cb.register_prefix(system)
    same(serve(cb, prompts, [6, 4, 5, 5]), want)
    block = np.arange(50, 58, dtype=np.int32)             # one full block
    prompts = [np.concatenate([block, np.arange(1, n + 1)]).astype(np.int32)
               for n in (2, 5, 9)]
    pb = paged(prefill_bucket="pow2")
    pb.register_prefix(block)
    same(serve(pb, prompts, [6, 4, 5], multi_step=2),
         jax_greedy(prompts, [6, 4, 5]))
    assert pb.block_stats[0] == 0


def test_prefix_hit_among_plain_requests():
    """One prefix hit (the first request) among plain requests that then
    reuse its slot: the rows a prefix copy leaves are rewritten."""
    cb = dense()
    cb.register_prefix(np.arange(1, 4, dtype=np.int32))
    same(serve(cb), jax_greedy(PROMPTS, [10, 4, 7]))
