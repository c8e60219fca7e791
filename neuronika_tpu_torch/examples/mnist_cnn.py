"""MNIST-style CNN training on synthetic digits (twin of the JAX package's
`examples/mnist_cnn.py`): Conv2d + MaxPool + Dropout, Adam with an L2
penalty, the loss as log_softmax + NLL (class axis first).

    python -m neuronika_tpu_torch.examples.mnist_cnn
"""

from __future__ import annotations

import numpy as np

import neuronika_tpu_torch as nk
from neuronika_tpu_torch import models, nn, optim
from neuronika_tpu_torch.examples import on_device


def synthetic_digits(n, rng, image: int = 28):
    """Blurry oriented-bar 'digits', enough structure to overfit: class y
    is a 3 x 12 bar at row 4 + 4 (y % 5) and column 4 + 8 (y // 5) of a
    28 x 28 image, plus N(0, 0.1) noise; other sizes scale the bar."""
    s = image / 28
    ys = rng.integers(0, 10, n)
    xs = np.zeros((n, 1, image, image), np.float32)
    for i, y in enumerate(ys):
        r0, c0 = int(s * (4 + (y % 5) * 4)), int(s * (4 + (y // 5) * 8))
        xs[i, 0, r0:r0 + max(1, round(3 * s)),
           c0:c0 + max(1, round(12 * s))] = 1.0
        xs[i, 0] += rng.normal(0, 0.1, (image, image))
    return xs, ys.astype(np.float32)


def main(device=None, steps: int = 3, n: int = 256, batch: int = 64,
         channels: int = 8, hidden: int = 32, dropout: float = 0.25,
         image: int = 28, seed: int = 0, train: bool = True, weights=None,
         verbose: bool = True):
    """Train for `steps` epochs of `n` images; returns every batch's loss.
    `train=False` puts the model in eval mode (dropout off); `weights`
    (arrays in `parameters()` order, for example a JAX model's) replace
    the drawn ones."""
    with on_device(device):
        rng = np.random.default_rng(seed)
        X, Y = synthetic_digits(n, rng, image)
        cnn = models.MnistCNN(channels=channels, hidden=hidden,
                              dropout=dropout, image=image)
        if weights is not None:
            nn.params_from_jax(cnn, weights)
        if not train:
            cnn.eval()
        opt = optim.Adam(1e-3, penalty=optim.L2(1e-4))
        opt.register_all(cnn.parameters())
        losses = []
        for epoch in range(steps):
            perm = rng.permutation(len(X))
            total, correct = 0.0, 0
            for i in range(0, len(X), batch):
                idx = perm[i:i + batch]
                logits = cnn.forward(nk.from_ndarray(X[idx]))
                loss = logits.log_softmax(1).t().nll(
                    nk.from_ndarray(Y[idx]), nk.Reduction.Mean)
                loss.forward()
                loss.backward(1.0)
                opt.step()
                opt.zero_grad()
                losses.append(loss.item())
                total += losses[-1]
                pred = logits.data().argmax(1).cpu().numpy()
                correct += int((pred == Y[idx]).sum())
            if verbose:
                print(f"epoch {epoch}: loss {total:.3f} acc "
                      f"{correct / len(X):.2%}")
        return losses


if __name__ == "__main__":
    main()
