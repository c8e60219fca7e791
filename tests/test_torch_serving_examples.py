"""The twins of the JAX package's serving examples (`examples/serving.py`,
`speculative_decode.py`, `serve_http.py`, `finetune_qlora.py`) in
`neuronika_tpu_torch/examples/`, run on the CPU at their own widths (the
training loops cut to a few steps). The HTTP server's engine is driven
directly, not through a socket."""

import numpy as np

from neuronika_tpu_torch.examples import (finetune_qlora, serve_http, serving,
                                          speculative_decode)
from tests.test_torch_serving_slots import one_thread  # noqa: F401


def test_serving_walkthrough():
    out = serving.main(device="cpu", verbose=False)
    assert out["one_shot"].shape == (1, 20)
    assert [t.shape for t in out["batched"]] == [(8,), (12,), (4,)]
    assert [t.shape for t in out["burst"]] == [(8,)] * 6
    # the JAX example's mesh block: dp1 x tp2 on two spawned gloo ranks
    assert out["tp"].shape == (1, 20)
    np.testing.assert_array_equal(out["tp"], out["greedy"])


def test_speculative_decode_is_greedy_identical():
    out = speculative_decode.main(device="cpu", max_new=16, verbose=False)
    np.testing.assert_array_equal(out["tokens"], out["greedy"])
    assert 1 <= out["passes"] <= 16


def test_serve_http_engine():
    engine = serve_http.Engine(device="cpu", train_steps=3)
    try:
        assert engine.losses[-1] < engine.losses[0]
        text = engine.generate("the sun", 8)
        assert isinstance(text, str) and text
        sampled = engine.generate("a traveler", 8, temperature=0.8, top_k=20,
                                  seed=1)
        assert isinstance(sampled, str)
        assert engine.stats() == {"running": 0, "queued": 0,
                                  "free_slots": 8}
        assert serve_http.make_handler(engine).do_POST
    finally:
        engine.close()


def test_finetune_qlora_then_serve():
    out = finetune_qlora.main(device="cpu", steps=6, verbose=False)
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert out["greedy"].shape == out["sampled"].shape == (8,)
