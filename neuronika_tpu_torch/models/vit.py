"""Vision Transformer (counterpart of `neuronika_tpu/models/vit.py`).

Patch embedding (a reshape and one matmul), a [CLS] token and learned
positions, pre-LN encoder blocks with bidirectional attention, a head on
the CLS state. Plain PyTorch: the JAX ViT runs its attention as an XLA
composite, reaching no Pallas kernel, and so does this one. JAX's dtype
rules are kept: weights stored in `cfg.dtype`, products emitted in it
(`preferred_element_type=cfg.dtype`), attention scores, LayerNorm
statistics and logits in f32. The params tree is JAX's ("blocks" a list
of dicts); weights are drawn from a `torch.Generator` where JAX takes a
key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from .._tree import tree_leaves, tree_unflatten
from ..device import resolve
from ..optim.functional import adam_update


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image: int = 32
    patch: int = 4
    d_model: int = 192
    n_layer: int = 6
    n_head: int = 3
    d_ff: int = 768
    num_classes: int = 10
    dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image // self.patch) ** 2


def _ln(x, p, eps=1e-5):
    """LayerNorm with f32 statistics; result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"],
                        eps).to(x.dtype)


def init_params(generator: torch.Generator, cfg: ViTConfig,
                device) -> Dict:
    """Dense weights N(0, 1/fan_in), positions N(0, 0.02), a zero CLS token,
    all in cfg.dtype; LayerNorm parameters and the head bias f32. Values
    are drawn on `generator`'s device and placed on `device`; they do not
    reproduce JAX's draws from a key."""
    dev = resolve(device)
    D, F_ = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * std).to(dev, cfg.dtype)

    def dense(i, o):
        return normal((i, o), (1.0 / i) ** 0.5)

    def ln():
        return {"scale": torch.ones(D, dtype=torch.float32, device=dev),
                "bias": torch.zeros(D, dtype=torch.float32, device=dev)}

    p = {
        "embed": dense(cfg.patch * cfg.patch * 3, D),
        "cls": torch.zeros((1, 1, D), dtype=cfg.dtype, device=dev),
        "pos": normal((cfg.n_patches + 1, D), 0.02),
        "ln_f": ln(),
        "head": {"w": dense(D, cfg.num_classes),
                 "b": torch.zeros(cfg.num_classes, dtype=torch.float32,
                                  device=dev)},
        "blocks": [],
    }
    for _ in range(cfg.n_layer):
        p["blocks"].append({"ln1": ln(), "ln2": ln(),
                            "qkv": dense(D, 3 * D), "proj": dense(D, D),
                            "fc_in": dense(D, F_), "fc_out": dense(F_, D)})
    return p


def _patchify(x, cfg: ViTConfig):
    """(B, H, W, 3) -> (B, n_patches, p*p*3) by a reshape and a transpose."""
    B, H, W, C = x.shape
    pn = cfg.patch
    x = x.reshape(B, H // pn, pn, W // pn, pn, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // pn) * (W // pn), pn * pn * C)


def _attn(x, blk, cfg: ViTConfig):
    B, S, D = x.shape
    H = cfg.n_head
    hd = D // H
    qkv = (x @ blk["qkv"]).reshape(B, S, 3, H, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B,H,S,hd)
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / hd ** 0.5
    att = torch.softmax(att, -1).to(cfg.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", att, v)
    return out.transpose(1, 2).reshape(B, S, D) @ blk["proj"]


def forward(params, images, cfg: ViTConfig):
    """images (B, H, W, 3) in [0, 1] -> logits (B, num_classes) f32."""
    x = _patchify(images.to(cfg.dtype), cfg) @ params["embed"]
    cls = params["cls"].expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"][None]
    for blk in params["blocks"]:
        x = x + _attn(_ln(x, blk["ln1"]), blk, cfg)
        h = F.gelu(_ln(x, blk["ln2"]) @ blk["fc_in"], approximate="tanh")
        x = x + h @ blk["fc_out"]
    cls_out = _ln(x, params["ln_f"])[:, 0].float()
    return cls_out @ params["head"]["w"].float() + params["head"]["b"]


def loss_fn(params, images, labels, cfg: ViTConfig):
    logits = forward(params, images, cfg)
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.gather(-1, labels.long()[:, None])[:, 0]).mean()


def make_train_step(cfg: ViTConfig):
    """Forward, backward and Adam (`optim.functional`'s rule):
    step(params, opt_state, images, labels, lr) -> (params, opt_state,
    loss); params and Adam state are updated in place."""

    def step(params, opt_state, images, labels, lr):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), images, labels, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        params, opt_state = adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss.detach()

    return step
