"""CIFAR-style ResNet training on synthetic data (twin of the JAX
package's `examples/resnet_cifar.py`: ResNet stages (2, 2, 2), width 32,
GroupNorm, SGD with momentum 0.9 and weight decay 5e-4 under a cosine lr
from 0.05, batch 64 of 32x32 images whose class is the position of a
bright 8x8 patch). The convolutions run the port's direct-conv tier
(`conv_impl="pallas"`: K12 forward and dx, K13 dw on the card); bf16 on
the card, f32 on the CPU.

    python -m neuronika_tpu_torch.examples.resnet_cifar
"""

from __future__ import annotations

import math
import time

import torch

from neuronika_tpu_torch._tree import tree_leaves
from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import resnet as R


def synthetic_batch(generator: torch.Generator, batch: int,
                    num_classes: int):
    """Class = position of a bright 8x8 patch on a noisy background (row
    (y % 4) * 8, column (y // 4) * 8): a spatial pattern, which GroupNorm
    keeps, where a colour code would be normalised away. Drawn on
    `generator`'s device: images (B, 32, 32, 3) in [0, 1], labels (B,)."""
    dev = generator.device
    y = torch.randint(0, num_classes, (batch,), generator=generator,
                      device=dev)
    x = torch.rand((batch, 32, 32, 3), generator=generator, device=dev) * 0.5
    row, col = (y % 4) * 8, (y // 4) * 8
    rr = torch.arange(32, device=dev)[None, :, None]
    cc = torch.arange(32, device=dev)[None, None, :]
    patch = ((rr >= row[:, None, None]) & (rr < row[:, None, None] + 8)
             & (cc >= col[:, None, None]) & (cc < col[:, None, None] + 8))
    return (x + 0.5 * patch[..., None]).clamp(0.0, 1.0), y


def main(device=None, steps: int = 300, batch: int = 64, classes: int = 10,
         verbose: bool = True):
    """Run the example on `device` (default `config.device`); returns a
    dict with every step's loss, the accuracy on a fresh batch of 256 and
    the parameter count."""
    dev = resolve(config.device if device is None else device)
    cfg = R.ResNetConfig(
        stages=(2, 2, 2), width=32, num_classes=classes, conv_impl="pallas",
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    params = R.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    buf = R.momentum_init(params)
    step = R.make_train_step(cfg, momentum=0.9, weight_decay=5e-4)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if verbose:
        print(f"ResNet {cfg.stages} width={cfg.width}: "
              f"{n_params / 1e6:.2f}M params")

    data = torch.Generator(dev).manual_seed(1)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        lr = 0.05 * 0.5 * (1 + math.cos(math.pi * i / steps))
        x, y = synthetic_batch(data, batch, classes)
        params, buf, loss = step(params, buf, x, y, lr)
        losses.append(loss)
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(loss):.4f}")
    losses = [float(l) for l in losses]
    dt = time.perf_counter() - t0

    x, y = synthetic_batch(torch.Generator(dev).manual_seed(999), 256,
                           classes)
    with torch.no_grad():
        acc = float((R.forward(params, x, cfg).argmax(-1) == y).float()
                    .mean())
    if verbose:
        print(f"{steps} steps in {dt:.1f}s ({steps / dt:.1f} steps/s)")
        print(f"synthetic eval accuracy: {acc:.2%}")
    return {"losses": losses, "accuracy": acc, "n_params": n_params}


if __name__ == "__main__":
    main()
