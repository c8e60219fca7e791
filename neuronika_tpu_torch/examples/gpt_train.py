"""Mini GPT-2 end to end: train on synthetic text, round-trip the params
through `save_pytree`/`load_pytree`, then generate greedily (`generate`),
by sampling on the device (`make_generate`) and by beam search (twin of
the JAX package's `examples/gpt_train.py`: the same text, a character
vocabulary, d128 L2 H2 at S64, 200 Adam steps of batch 16 at lr 3e-3; bf16
on the card, f32 on the CPU).

    python -m neuronika_tpu_torch.examples.gpt_train
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from neuronika_tpu_torch import utils
from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import transformer as T

TEXT = (
    "the quick brown fox jumps over the lazy dog. "
    "she sells sea shells by the sea shore. "
) * 40
PROMPT = "the quick "


def main(device=None, steps: int = 200, seed: int = 0,
         verbose: bool = True):
    """Run the example on `device` (default `config.device`); returns a
    dict with every step's loss, the greedy, sampled and beam tokens
    (prompt included) and the beams' scores."""
    dev = resolve(config.device if device is None else device)
    chars = sorted(set(TEXT))
    stoi = {c: i for i, c in enumerate(chars)}
    data = np.array([stoi[c] for c in TEXT], dtype=np.int32)

    S = 64
    cfg = T.GPTConfig(
        vocab_size=len(chars), n_layer=2, n_head=2, d_model=128, d_ff=256,
        max_seq=S, dropout=0.0,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    gen = torch.Generator(dev).manual_seed(seed)
    params = T.init_params(gen, cfg, dev)
    opt_state = T.adam_init(params)
    step = T.make_train_step(cfg)

    rng = np.random.default_rng(0)
    B = 16
    lr = torch.tensor(3e-3, dtype=torch.float32)
    losses = []
    for it in range(steps):
        starts = rng.integers(0, len(data) - S - 1, B)
        toks = np.stack([data[s:s + S] for s in starts])
        tgts = np.stack([data[s + 1:s + S + 1] for s in starts])
        params, opt_state, loss = step(
            params, opt_state, torch.from_numpy(toks).to(dev),
            torch.from_numpy(tgts).to(dev), lr, gen)
        losses.append(loss)
        if verbose and it % 50 == 0:
            print(f"step {it}: loss {float(loss):.3f}")
    losses = [float(l) for l in losses]

    # checkpoint round trip
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt_params.npz")
        utils.save_pytree(path, params)
        params = utils.load_pytree(path, params)

    def text(ids):
        return "".join(chars[i] for i in ids)

    ids = np.array([[stoi[c] for c in PROMPT]], np.int32)
    greedy = T.generate(params, cfg, ids, max_new=40)
    # the same as one program on the device: no host round trip a token
    sampled = T.make_generate(cfg, max_new=40, temperature=0.8, top_k=8)(
        params, ids, torch.Generator(dev).manual_seed(7)).cpu().numpy()
    # beam search: the 3 most probable continuations, best first
    beams, scores = T.make_beam_search(cfg, max_new=40, n_beams=3)(
        params, ids)
    beams, scores = beams.cpu().numpy(), scores.cpu().numpy()
    if verbose:
        print("sample:", text(greedy[0]))
        print("sample (on-device):", text(sampled[0]))
        for k in range(3):
            print(f"beam {k} ({float(scores[0, k]):7.2f}):",
                  text(beams[0, k]))
    return {"losses": losses, "greedy": greedy, "sampled": sampled,
            "beams": beams, "scores": scores}


if __name__ == "__main__":
    main()
