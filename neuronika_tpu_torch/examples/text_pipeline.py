"""End-to-end text pipeline: tokenizer -> GPT training -> held-out
perplexity -> generation (twin of the JAX package's
`examples/text_pipeline.py`: the same corpus, a byte-level BPE tokenizer of
512 ids, 64-token windows split 90/10, the same tiny llama-style model in
f32, 60 clipped Adam steps at lr 3e-3, `evaluate`, then a greedy
continuation).

    python -m neuronika_tpu_torch.examples.text_pipeline
"""

from __future__ import annotations

import numpy as np
import torch

from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.data import BpeTokenizer, lm_windows
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import transformer as T

CORPUS = (
    "the sun rose over the quiet valley and the river kept moving. "
    "a traveler walked the long road toward the distant town. "
    "the town slept while the river sang its old song. "
    "every morning the valley filled with light and the road woke up. "
) * 40

SEQ = 64
PROMPT = "the sun rose over"


def main(device=None, steps: int = 60, seed: int = 0, verbose: bool = True):
    """Run the pipeline on `device` (default `config.device`); returns a
    dict with the corpus ids, every step's loss, the eval dict, the
    generated ids (1, P + 24) and their text."""
    dev = resolve(config.device if device is None else device)
    # 1. tokenizer
    tok = BpeTokenizer.train([CORPUS], vocab_size=512,
                             special_tokens=["<|end|>"])
    ids = np.array(tok.encode(CORPUS), np.int32)
    if verbose:
        print(f"tokenizer: vocab {tok.vocab_size}, corpus {len(ids)} tokens "
              f"({len(CORPUS) / len(ids):.2f} bytes/token)")

    # 2. batching: contiguous SEQ+1 windows
    toks, tgts = lm_windows(ids, SEQ)
    n_win = len(toks)
    split = max(1, int(n_win * 0.9))
    if verbose:
        print(f"dataset: {split} train / {n_win - split} eval windows of "
              f"{SEQ}")

    # 3. model and train step
    cfg = T.llama_config(vocab_size=tok.vocab_size, n_layer=2, n_head=4,
                         d_model=128, d_ff=256, max_seq=SEQ,
                         dtype=torch.float32)
    gen = torch.Generator(dev).manual_seed(seed)
    params = T.init_params(gen, cfg, dev)
    step = T.make_train_step(cfg, grad_clip=1.0)
    opt = T.adam_init(params)
    B = min(16, split)
    lr = torch.tensor(3e-3, dtype=torch.float32)
    rng = np.random.default_rng(0)
    losses = []
    for it in range(steps):
        sel = rng.integers(0, split, B)
        params, opt, loss = step(
            params, opt, torch.from_numpy(toks[sel]).to(dev),
            torch.from_numpy(tgts[sel]).to(dev), lr, gen)
        losses.append(loss)
        if verbose and (it % 20 == 0 or it == steps - 1):
            print(f"step {it:3d} loss {float(loss):.3f}")
    losses = [float(l) for l in losses]

    # 4. held-out perplexity
    ev = T.evaluate(params, cfg,
                    [(toks[split:], tgts[split:])] if n_win > split else
                    [(toks[:1], tgts[:1])])
    if verbose:
        print(f"eval: loss {ev['loss']:.3f}, perplexity "
              f"{ev['perplexity']:.2f} over {ev['tokens']} tokens")

    # 5. a greedy continuation
    pids = np.asarray([tok.encode(PROMPT)], np.int32)
    out = T.generate(params, cfg, pids, max_new=24)
    text = tok.decode(out[0].tolist())
    if verbose:
        print("prompt:      ", PROMPT)
        print("continuation:", text)
    return {"ids": ids, "losses": losses, "eval": ev, "tokens": out,
            "text": text}


if __name__ == "__main__":
    main()
