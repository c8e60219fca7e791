"""LoRA and QLoRA fine-tuning for the functional transformer tier
(counterpart of `neuronika_tpu/models/lora.py`).

Low-rank adapters (Hu et al. 2021) on the stacked per-layer weight leaves:
each targeted (L, in, out) tensor gets A (L, in, r) and B (L, r, out), and
the effective weight is W + (alpha / r) A B. As in the JAX package the
adapters are merged on the fly: one small batched product a leaf per step
gives a merged tree that runs the unchanged forward, flash kernels and
remat, so a LoRA step launches exactly the kernels of a full step.

The base is frozen: the train steps detach every base tensor (JAX's
`stop_gradient`), so gradients and Adam state exist for the adapters only.
QLoRA keeps the frozen base's matmul leaves as group-wise int4
(`transformer._quant_w4`, bit for bit JAX's) and dequantizes them into the
merged tree each step. Initialisation draws from a `torch.Generator`
where JAX takes a key.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..optim.functional import adam_update, clip_by_global_norm
from . import transformer as T

DEFAULT_TARGETS = ("qkv", "proj")
QLORA_QUANT_LEAVES = ("qkv", "proj", "fc_in", "fc_out", "fc_gate")


def lora_init(generator: torch.Generator, params, rank: int,
              targets: Tuple[str, ...] = DEFAULT_TARGETS) -> Dict:
    """A ~ N(0, 1/r), B = 0, f32 on each target's device: the adapted
    model starts equal to the base. `targets` name stacked (L, in, out)
    leaves of params["blocks"]; MoE expert tensors cannot carry adapters."""
    lora = {}
    for name in targets:
        if name not in params["blocks"]:
            raise ValueError(f"unknown LoRA target {name!r}; have "
                             f"{sorted(params['blocks'])}")
        w = params["blocks"][name]
        if isinstance(w, dict) or w.dim() != 3:
            shape = tuple(w.shape) if torch.is_tensor(w) else "quantized"
            raise ValueError(
                f"LoRA target {name!r} has shape {shape}; only stacked "
                "(n_layer, in, out) leaves can carry adapters (MoE expert "
                "tensors are not supported)")
        L, d_in, d_out = w.shape
        a = torch.randn((L, d_in, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        lora[name] = {
            "A": (a / math.sqrt(rank)).to(w.device),
            "B": torch.zeros((L, rank, d_out), dtype=torch.float32,
                             device=w.device),
        }
    return lora


def _add_delta(blocks, lora, alpha):
    """blocks[name] + (alpha / r) A B, in f32, back in the leaf's dtype."""
    for name, ab in lora.items():
        rank = ab["A"].shape[-1]
        delta = torch.matmul(ab["A"].float(), ab["B"].float())
        w = blocks[name]
        blocks[name] = (w.float() + delta * (alpha / rank)).to(w.dtype)
    return blocks


def lora_apply(params, lora, alpha: float = 8.0):
    """Merged tree: base + (alpha / r) A B on every adapted leaf. The base
    leaves are left as they are (a new tree is returned)."""
    out = dict(params)
    out["blocks"] = _add_delta(dict(params["blocks"]), lora, alpha)
    return out


def lora_merge(params, lora, alpha: float = 8.0):
    """Fold the adapters into the base for export or serving: the numbers
    of `lora_apply`, a plain params tree with no LoRA state."""
    return lora_apply(params, lora, alpha)


def lora_param_count(lora) -> int:
    return sum(t.numel() for t in tree_leaves(lora))


def _adapter_step(merge, cfg: T.GPTConfig, grad_clip: float):
    """step(base, lora, opt_state, tokens, targets, lr, generator=None) ->
    (lora, opt_state, loss): the loss of `merge(frozen base, lora)`, its
    gradients for the adapters only, clipping and Adam in place."""

    def step(base, lora, opt_state, tokens, targets, lr, generator=None):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(lora)]
        frozen = tree_map(lambda t: t.detach(), base)
        merged = merge(frozen, tree_unflatten(lora, leaves))
        loss = T.loss_fn(merged, tokens, targets, cfg, train=True,
                         generator=generator)
        grads = tree_unflatten(lora, torch.autograd.grad(loss, leaves))
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lora, opt_state = adam_update(lora, grads, opt_state, lr)
        return lora, opt_state, loss.detach()

    return step


def make_lora_train_step(cfg: T.GPTConfig, *, alpha: float = 8.0,
                         grad_clip: float = 0.0):
    """Fine-tuning step through the merged weights with the base frozen:
    step(params, lora, opt_state, tokens, targets, lr, generator=None) ->
    (lora, opt_state, loss). The adapters and their Adam state (from
    `adam_init(lora)`) are updated in place (JAX donates them)."""
    return _adapter_step(lambda p, l: lora_apply(p, l, alpha), cfg,
                         grad_clip)


def qlora_quantize_base(params) -> Dict:
    """Freeze the base for QLoRA: every stacked (L, in, out) matmul leaf
    becomes group-wise int4 (`transformer._quant_w4`: packed nibbles and
    per-128-group f32 scales, ~4.25 bits a weight); embeddings, norms,
    biases, an untied head and MoE expert tensors stay as they are."""
    blocks = dict(params["blocks"])
    for name in QLORA_QUANT_LEAVES:
        w = blocks.get(name)
        if torch.is_tensor(w) and w.dim() == 3:
            blocks[name] = T._quant_w4(w)
    out = dict(params)
    out["blocks"] = blocks
    return out


def qlora_apply(qparams, lora, alpha: float = 8.0, dtype=torch.bfloat16):
    """Merged compute tree from a quantized base: each int4 leaf
    dequantized to `dtype` (`transformer.dequant_w4`), then the adapter
    delta added; the forward over it is the plain one."""
    blocks = dict(qparams["blocks"])
    for name, w in list(blocks.items()):
        if isinstance(w, dict) and "q4p" in w:
            blocks[name] = T.dequant_w4(w, dtype)
    out = dict(qparams)
    out["blocks"] = _add_delta(blocks, lora, alpha)
    return out


def make_qlora_train_step(cfg: T.GPTConfig, *, alpha: float = 8.0,
                          grad_clip: float = 0.0):
    """`make_lora_train_step` over a `qlora_quantize_base` tree:
    step(qparams, lora, opt_state, tokens, targets, lr, generator=None) ->
    (lora, opt_state, loss). Gradients reach the adapters through the
    dequantized base (a rescale in `cfg.dtype`); the int4 leaves carry
    none."""
    return _adapter_step(lambda q, l: qlora_apply(q, l, alpha, cfg.dtype),
                         cfg, grad_clip)


def qlora_merge(qparams, lora, alpha: float = 8.0, dtype=torch.bfloat16):
    """Export: the dequantized base plus the adapters as a plain params
    tree (the training step's merged tree)."""
    return qlora_apply(qparams, lora, alpha, dtype)
