"""Speculative decoding end to end: a draft proposes, the target verifies
(twin of the JAX package's `examples/speculative_decode.py`: a d256 L4
target and a 4x smaller draft sharing a 512-token vocabulary, f32, random
weights from seeds).

The draft proposes `gamma` tokens by decode steps; the target scores all
of them in ONE chunked pass and emits the longest matching prefix plus its
own next token, so the output is EXACTLY the target's greedy continuation
for any draft; the draft only changes how many target passes it takes.

    python -m neuronika_tpu_torch.examples.speculative_decode
"""

from __future__ import annotations

import time

import numpy as np
import torch

from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import transformer as T


def main(device=None, max_new: int = 64, gamma: int = 4,
         verbose: bool = True):
    """Run the example on `device` (default `config.device`); returns a
    dict with the tokens, plain greedy's, the verify passes and both wall
    times (illustrative: random models rarely agree)."""
    dev = resolve(config.device if device is None else device)
    cfg_t = T.GPTConfig(vocab_size=512, n_layer=4, n_head=4, d_model=256,
                        d_ff=1024, max_seq=160, dtype=torch.float32)
    cfg_d = T.GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=64,
                        d_ff=256, max_seq=160, dtype=torch.float32)
    params_t = T.init_params(torch.Generator(dev).manual_seed(0), cfg_t, dev)
    params_d = T.init_params(torch.Generator(dev).manual_seed(1), cfg_d, dev)
    prompt = np.random.default_rng(2).integers(
        1, cfg_t.vocab_size, (1, 16)).astype(np.int32)

    # plain greedy: the output speculative decoding must reproduce
    gen = T.make_generate(cfg_t, max_new=max_new)
    t0 = time.perf_counter()
    ref = gen(params_t, prompt).cpu().numpy()
    t_plain = time.perf_counter() - t0

    spec = T.make_speculative_generate(cfg_t, cfg_d, max_new=max_new,
                                       gamma=gamma)
    t0 = time.perf_counter()
    toks, n_verify = spec(params_t, params_d, prompt)
    toks = toks.cpu().numpy()
    t_spec = time.perf_counter() - t0
    np.testing.assert_array_equal(toks, ref)     # exactness, not similarity
    if verbose:
        print(f"greedy-identical output over {max_new} tokens")
        print(f"verify passes: {n_verify} (vs {max_new} sequential steps "
              f"for plain greedy) -> {max_new / n_verify:.2f} tokens a pass")
        print(f"plain {t_plain * 1e3:.0f} ms vs speculative "
              f"{t_spec * 1e3:.0f} ms (a speed-up needs a draft that "
              f"matches the target)")
    return {"tokens": toks, "greedy": ref, "passes": n_verify,
            "plain_s": t_plain, "spec_s": t_spec}


if __name__ == "__main__":
    main()
