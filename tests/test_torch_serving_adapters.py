"""Per-request LoRA adapters in the port's batchers (S-LoRA:
`register_adapter`, `submit(adapter=)`, `transformer._lora_delta`) on
the CPU in f32 against the JAX package: the cases of
tests/test_models.py::TestMultiLoRAServing (:2217) and TestChunkedPrefill's
adapter case. The adapters are shaped as JAX's test makes them (ranks and
targets differing, drawn with numpy), the same arrays on both sides.

* A mixed batch (adapter 1, adapter 2, the base) gives each request the
  greedy tokens of JAX's decode over the correspondingly MERGED weights
  (`lora_merge`), dense and paged, per step and in windows, with the
  paged decode on the attention kernel's plain version;
* adapter 0 is the base model; adapter requests skip the prefix cache;
  chunked prefill carries the adapter; bad ids and shapes raise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuronika_tpu.models import lora as JL
from tests.test_torch_serving_slots import (dense, jax_decode_alone,  # noqa: F401
                                            jax_greedy, model,
                                            one_thread, paged, same,
                                            serve)


@functools.lru_cache(maxsize=None)
def adapters():
    """[(numpy tree, JAX tree)] of two adapters shaped as TestMultiLoRA-
    Serving's (`lora_init`'s A ~ N(0, 1/r), and a nonzero B so that the
    adapter changes the model), drawn with numpy: rank 2 on qkv and proj,
    rank 4 on qkv, fc_in and fc_out."""
    blocks = model()[2]["blocks"]
    rng = np.random.default_rng(1)
    out = []
    for rank, targets in ((2, ("qkv", "proj")),
                          (4, ("qkv", "fc_in", "fc_out"))):
        ad = {}
        for name in targets:
            L, d_in, d_out = blocks[name].shape
            ad[name] = {
                "A": (rng.standard_normal((L, d_in, rank)) / np.sqrt(rank)
                      ).astype(np.float32),
                "B": (0.05 * rng.standard_normal((L, rank, d_out))
                      ).astype(np.float32)}
        out.append((ad, jax.tree.map(jnp.asarray, ad)))
    return out


def merged_greedy(prompts, max_news, ad):
    """JAX's greedy tokens over the base merged with JAX adapter `ad`."""
    jp = model()[2]
    return jax_decode_alone(prompts, max_news,
                            params=jp if ad is None else JL.lora_merge(jp, ad))


PROMPTS = [np.array([1, 2, 3, 4], np.int32), np.array([7, 8, 9], np.int32),
           np.array([20, 21], np.int32)]


@pytest.mark.parametrize("kind, ms", [("dense", 1), ("dense", 4),
                                      ("paged", 1), ("paged", 4)])
def test_mixed_batch_matches_merged_models(kind, ms):
    (a1, j1), (a2, j2) = adapters()
    b = (dense if kind == "dense" else paged)(n_slots=3)
    assert (b.register_adapter(a1), b.register_adapter(a2)) == (1, 2)
    got = serve(b, PROMPTS, [8] * 3, multi_step=ms,
                kws=[dict(adapter=1), dict(adapter=2), dict(adapter=0)])
    for g, p, ad in zip(got, PROMPTS, (j1, j2, None)):
        np.testing.assert_array_equal(g, merged_greedy([p], [8], ad)[0])


def test_adapter_zero_is_base():
    cb = dense()
    cb.register_adapter(adapters()[0][0])
    p = np.array([3, 4, 5, 6], np.int32)
    same(serve(cb, [p], [8]), merged_greedy([p], [8], None))


def test_adapter_requests_skip_prefix_cache_and_chunk():
    (a1, j1), _ = adapters()
    system = np.array([5, 6, 7, 8], np.int32)
    p = np.concatenate([system, [1, 2]]).astype(np.int32)
    cb = dense(n_slots=1)
    cb.register_prefix(system)
    cb.register_adapter(a1)
    same(serve(cb, [p], [6], kws=[dict(adapter=1)]),
         merged_greedy([p], [6], j1))
    long_p = np.arange(2, 22, dtype=np.int32)
    for b in (dense(n_slots=1, prefill_chunk=8),
              paged(n_slots=1, prefill_chunk=8)):
        b.register_adapter(a1)
        same(serve(b, [long_p], [6], kws=[dict(adapter=1)]),
             merged_greedy([long_p], [6], j1))


def test_bad_adapter_id_and_shapes():
    cb = dense(n_slots=1)
    with pytest.raises(ValueError, match="not registered"):
        cb.submit(np.array([1, 2], np.int32), 4, adapter=1)
    with pytest.raises(ValueError, match="want A"):
        cb.register_adapter({"qkv": {"A": np.zeros((2, 64, 4), np.float32),
                                     "B": np.zeros((2, 8, 64), np.float32)}})
