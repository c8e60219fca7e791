"""ResNet on the port (counterpart of `neuronika_tpu/models/resnet.py`).

Pure functions over a params tree, as the JAX model: NHWC activations,
HWIO kernels, GroupNorm (f32 statistics, `min(groups, C)` groups) in place
of BatchNorm, storage in `cfg.dtype` with f32 GroupNorm parameters, head
bias and logits. The tree is JAX's: {"stem": {"w", "gn"}, "stages": a list
of stages, each a list of block dicts ("w1", "gn1", "w2", "gn2" and, where
the block changes stride or width, "proj"), "head": {"w", "b"}}.

`conv_impl` picks the conv tier: "xla" is the library convolution (cuDNN
on the card, as JAX's "xla" is XLA's), "pallas" the direct-conv kernels of
`ops/conv.py` through `conv2d_pallas_nhwc`: K12 forward at every stride,
and at stride 1 K12 for dx and K13 for dw. SAME padding is lax's: the
smaller half first, so a 7x7/2 conv on 224 pads (2, 3) and a 3x3/2 one on
56 pads (0, 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..device import resolve
from ..ops.conv import _pad_nhwc, _same_pads, conv2d_pallas_nhwc

__all__ = ["ResNetConfig", "init_params", "params_from_jax", "forward",
           "loss_fn", "make_train_step", "momentum_init", "conv_strides"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: Tuple[int, ...] = (2, 2, 2, 2)   # blocks per stage (resnet18)
    width: int = 64                           # stem channels
    num_classes: int = 10
    groups: int = 8                           # GroupNorm groups
    stem: str = "cifar"                       # "cifar" 3x3/1 | "imagenet" 7x7/2
    dtype: torch.dtype = torch.float32
    conv_impl: str = "xla"                    # "xla" | "pallas" (K12, K13)

    def __post_init__(self):
        if self.stem not in ("cifar", "imagenet"):
            raise ValueError(f"stem {self.stem!r}: cifar or imagenet")
        if self.conv_impl not in ("xla", "pallas"):
            raise ValueError(f"conv_impl {self.conv_impl!r}: xla or pallas")


def _block_stride(si: int, bi: int) -> int:
    return 2 if (bi == 0 and si > 0) else 1


def conv_strides(cfg: ResNetConfig) -> list:
    """The stride of every conv of one forward, in the order it runs: the
    stem, then per block w1, w2 and the projection where there is one."""
    out = [1 if cfg.stem == "cifar" else 2]
    c_in = cfg.width
    for si, n_blocks in enumerate(cfg.stages):
        c_out = cfg.width * 2 ** si
        for bi in range(n_blocks):
            s = _block_stride(si, bi)
            out += [s, 1] + ([s] if (s != 1 or c_in != c_out) else [])
            c_in = c_out
    return out


def _conv(x, w, stride, impl):
    if impl == "pallas":
        return conv2d_pallas_nhwc(x, w, (stride, stride), "SAME")
    # the library convolution with lax's SAME padding made explicit, on
    # contiguous NCHW copies (see ops/conv.py: its transposes on
    # channels-last views are unsafe on the CPU)
    ph = _same_pads(x.shape[1], w.shape[0], stride)
    pw = _same_pads(x.shape[2], w.shape[1], stride)
    y = F.conv2d(_pad_nhwc(x, ph, pw).permute(0, 3, 1, 2).contiguous(),
                 w.permute(3, 2, 0, 1).contiguous(), stride=stride)
    return y.permute(0, 2, 3, 1)


def _gn(x, p, groups, eps=1e-5):
    B, H, W, C = x.shape
    g = min(groups, C)
    x32 = x.float().reshape(B, H, W, g, C // g)
    mu = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    return (x32.reshape(B, H, W, C) * p["scale"] + p["bias"]).to(x.dtype)


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device) -> Dict:
    """He-normal kernels (std sqrt(2 / fan_in)) drawn in f32 and cast to
    cfg.dtype, GroupNorm scale 1 and bias 0, head N(0, 1/c_in) in
    cfg.dtype with an f32 zero bias: JAX's tree and init. Values are drawn
    on `generator`'s device and placed on `device`; they do not reproduce
    JAX's draws from a key."""
    dev = resolve(device)

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * std).to(dev, cfg.dtype)

    def he(*shape):
        return normal(shape, (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5)

    def gn(c):
        return {"scale": torch.ones(c, dtype=torch.float32, device=dev),
                "bias": torch.zeros(c, dtype=torch.float32, device=dev)}

    k = 3 if cfg.stem == "cifar" else 7
    p = {"stem": {"w": he(k, k, 3, cfg.width), "gn": gn(cfg.width)}}
    c_in, stages = cfg.width, []
    for si, n_blocks in enumerate(cfg.stages):
        c_out = cfg.width * 2 ** si
        blocks = []
        for bi in range(n_blocks):
            blk = {"w1": he(3, 3, c_in, c_out), "gn1": gn(c_out),
                   "w2": he(3, 3, c_out, c_out), "gn2": gn(c_out)}
            if _block_stride(si, bi) != 1 or c_in != c_out:
                blk["proj"] = he(1, 1, c_in, c_out)
            blocks.append(blk)
            c_in = c_out
        stages.append(blocks)
    p["stages"] = stages
    p["head"] = {"w": normal((c_in, cfg.num_classes), c_in ** -0.5),
                 "b": torch.zeros(cfg.num_classes, dtype=torch.float32,
                                  device=dev)}
    return p


def params_from_jax(tree, device="cpu") -> Dict:
    """A JAX ResNet params tree (numpy or JAX arrays) -> the same structure
    of tensors on `device`; bf16 leaves go through f32. Walks the structure
    (dict keys and list positions), never the flattened leaf order, which
    JAX sorts by key."""
    dev = resolve(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(conv, tree)


def _block(x, blk, cfg: ResNetConfig, stride: int):
    h = _conv(x, blk["w1"], stride, cfg.conv_impl)
    h = torch.relu(_gn(h, blk["gn1"], cfg.groups))
    h = _conv(h, blk["w2"], 1, cfg.conv_impl)
    h = _gn(h, blk["gn2"], cfg.groups)
    if "proj" in blk:
        x = _conv(x, blk["proj"], stride, cfg.conv_impl)
    return torch.relu(x + h)


def _max_pool_same(x, k=3, s=2):
    """lax.reduce_window(max) SAME kxk/s on NHWC, padding with -inf."""
    ph = _same_pads(x.shape[1], k, s)
    pw = _same_pads(x.shape[2], k, s)
    xp = _pad_nhwc(x, ph, pw, value=float("-inf"))
    return F.max_pool2d(xp.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def forward(params, x, cfg: ResNetConfig):
    """x (B, H, W, 3) float in [0, 1] -> logits (B, num_classes) f32."""
    x = x.to(cfg.dtype)
    stride = 1 if cfg.stem == "cifar" else 2
    x = torch.relu(_gn(_conv(x, params["stem"]["w"], stride, cfg.conv_impl),
                       params["stem"]["gn"], cfg.groups))
    if cfg.stem == "imagenet":
        x = _max_pool_same(x)
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            x = _block(x, blk, cfg, _block_stride(si, bi))
    x = x.mean(dim=(1, 2)).float()               # global average pool
    return x @ params["head"]["w"].float() + params["head"]["b"]


def loss_fn(params, x, labels, cfg: ResNetConfig):
    logits = forward(params, x, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - tgt).mean()


def momentum_init(params):
    """Zero f32 momentum buffers shaped like `params`."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_train_step(cfg: ResNetConfig, momentum: float = 0.9,
                    weight_decay: float = 0.0):
    """Forward, backward and SGD with momentum and decoupled weight decay,
    JAX's rule in JAX's order and dtypes: buf = buf * momentum + g (buf
    f32, g cast to it); p = p - (lr * (buf + wd * p)) cast to p's dtype.

    Returns step(params, buf, x, labels, lr) -> (params, buf, loss). The
    params and buffers are updated IN PLACE (JAX donates both trees) and
    returned."""

    def step(params, buf, x, labels, lr):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), x, labels, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))

        def upd(p, b, g):
            b.mul_(momentum).add_(g.to(b.dtype))
            p.sub_((lr * (b + weight_decay * p.to(b.dtype))).to(p.dtype))

        with torch.no_grad():
            tree_map(upd, params, buf, grads)
        return params, buf, loss.detach()

    return step
