"""Character-level LSTM language model (twin of the JAX package's
`examples/char_rnn.py`): variable-length batches through the define-by-run
API, the graph rebuilt for every batch, then greedy sampling.

    python -m neuronika_tpu_torch.examples.char_rnn
"""

from __future__ import annotations

import numpy as np

import neuronika_tpu_torch as nk
from neuronika_tpu_torch import models, nn, optim
from neuronika_tpu_torch.examples import on_device
from neuronika_tpu_torch.models.rnn import one_hot

TEXT = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
) * 8


def main(device=None, steps: int = 240, hidden: int = 96,
         cell: str = "lstm", batch: int = 8, lengths=(8, 12, 16),
         lr: float = 1e-2, seed: int = 0, weights=None, sample: int = 40,
         verbose: bool = True):
    """Train `steps` Adam steps on windows of the lengths in turn; returns
    every step's loss. `weights` (arrays in `parameters()` order, for
    example a JAX model's) replace the drawn ones; `sample` greedy
    characters are printed after training when `verbose`."""
    with on_device(device):
        nk.seed(seed)
        chars = sorted(set(TEXT))
        stoi = {c: i for i, c in enumerate(chars)}
        ids = np.array([stoi[c] for c in TEXT], dtype=np.int64)

        rnn = models.CharRNN(vocab=len(chars), hidden=hidden, cell=cell)
        if weights is not None:
            nn.params_from_jax(rnn, weights)
        opt = optim.Adam(lr)
        opt.register_all(rnn.parameters())

        rng = np.random.default_rng(seed)
        losses = []
        for step in range(steps):
            T = lengths[step % len(lengths)]
            starts = rng.integers(0, len(ids) - T - 1, size=batch)
            tokens = np.stack([ids[s:s + T] for s in starts])
            target = np.stack([ids[s + 1:s + T + 1] for s in starts])
            loss = rnn.loss(tokens, target)
            loss.forward()
            loss.backward(1.0)
            opt.step()
            opt.zero_grad()
            losses.append(loss.item())
            if verbose and step % 80 == 0:
                print(f"step {step}: loss {losses[-1]:.3f}")

        if verbose and sample:
            out = [stoi["t"]]
            h, c = nk.zeros((1, hidden)), nk.zeros((1, hidden))
            for _ in range(sample):
                x = nk.from_ndarray(one_hot(np.array([[out[-1]]]),
                                            len(chars))[:, 0])
                if cell == "lstm":
                    c, h = rnn.cell.forward((c, h), x)
                else:
                    h = rnn.cell.forward(h, x)
                logits = rnn.readout.forward(h)
                logits.forward()
                out.append(int(logits.data().argmax()))
            print("sample:", "".join(chars[i] for i in out))
        return losses


if __name__ == "__main__":
    main()
