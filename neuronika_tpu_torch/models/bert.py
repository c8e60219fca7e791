"""BERT-family bidirectional encoder on the functional transformer tier
(counterpart of `neuronika_tpu/models/bert.py`).

The GPT body of `models/transformer.py` with `causal=False`: training
attention runs the packed flash op without a causal mask (K1 forward,
K2 backward on the card), so the encoder takes the decoder's kernels and
remat. This module adds masked-LM corruption and loss, pooling and a
sequence-classification head. Randomness comes from a `torch.Generator`
where JAX takes a key; `mask_tokens` keeps JAX's contract (the selection
rate, 80/10/10 among the selected), not its bits.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .._tree import tree_leaves, tree_unflatten
from ..config import config
from ..device import resolve
from ..optim.functional import adam_update
from . import transformer as T


def bert_config(**kw) -> T.GPTConfig:
    """Encoder preset: bidirectional attention on the pre-LN GPT body,
    learned positions, the MLM head tied to wte. Any GPTConfig field can
    be overridden."""
    base: Dict[str, Any] = dict(causal=False)
    base.update(kw)
    return T.GPTConfig(**base)


def encode(params, tokens, cfg: T.GPTConfig, *, train: bool = False,
           generator: torch.Generator | None = None):
    """tokens (B, S) -> final (LN'd) hidden states (B, S, D), bidirectional.
    MoE aux losses are dropped here; the train steps keep them."""
    return T.hidden_states(params, tokens, cfg, train=train,
                           generator=generator)


def pool(hidden, mode: str = "mean"):
    """(B, S, D) -> (B, D): "mean" over positions or "cls" (position 0)."""
    if mode == "mean":
        return hidden.mean(dim=1)
    if mode == "cls":
        return hidden[:, 0]
    raise ValueError(f"unknown pooling mode {mode!r}")


def mask_tokens(generator: torch.Generator, tokens, mask_id: int,
                vocab_size: int, rate: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BERT 80/10/10 corruption: each position is selected with
    probability `rate`; of the selected, 80% become `mask_id`, 10% a
    uniform random token, 10% stay. Draws on `generator`'s device. Returns
    (corrupted tokens, labels = tokens, f32 weights: 1 exactly at the
    selected positions)."""
    def draw(fn, *args):
        return fn(*args, tokens.shape, generator=generator,
                  device=generator.device).to(tokens.device)

    selected = draw(torch.rand) < rate
    kind = draw(torch.rand)
    rand_tok = draw(torch.randint, 0, vocab_size).to(tokens.dtype)
    corrupted = torch.where(
        selected & (kind < 0.8), torch.full_like(tokens, mask_id),
        torch.where(selected & (kind >= 0.9), rand_tok, tokens))
    return corrupted, tokens, selected.float()


def mlm_loss_fn(params, tokens, labels, weights, cfg: T.GPTConfig, *,
                train: bool = False, generator: torch.Generator | None = None):
    """Mean token cross-entropy over the positions where weights == 1, on
    f32 logits from the head (wte when tied); MoE aux losses are added with
    weight 1, as JAX's does."""
    h, aux = T._hidden_aux(params, tokens, cfg, train, generator)
    head = params["wte"] if cfg.tied_head else params["lm_head"]
    logits = T._dot_f32(h, head.to(cfg.dtype).T).float()
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = ((lse - tgt) * weights).sum() / weights.sum().clamp(min=1.0)
    return loss if aux is None else loss + aux


def make_mlm_train_step(cfg: T.GPTConfig, *, mask_id: int | None = None,
                        mask_rate: float = 0.15):
    """MLM pre-training step: corrupt (`mask_tokens`, mask id V - 1 unless
    given), forward and backward on the selected positions, Adam.
    step(params, opt_state, tokens, lr, generator) -> (params, opt_state,
    loss); params and Adam state are updated in place. `generator` draws
    the corruption, then the dropout seeds."""
    mid = cfg.vocab_size - 1 if mask_id is None else mask_id

    def step(params, opt_state, tokens, lr, generator):
        corrupted, labels, weights = mask_tokens(
            generator, tokens, mid, cfg.vocab_size, mask_rate)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = mlm_loss_fn(tree_unflatten(params, leaves), corrupted, labels,
                           weights, cfg, train=True, generator=generator)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        params, opt_state = adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss.detach()

    return step


# ----------------------------------------------------------- classification


def init_classifier(generator: torch.Generator, cfg: T.GPTConfig,
                    n_classes: int, device=None) -> Dict:
    """(D, C) head N(0, 0.02) and a zero bias, f32, drawn on `generator`'s
    device and placed on `device` (default `config.device`)."""
    dev = resolve(config.device if device is None else device)
    w = torch.randn((cfg.d_model, n_classes), generator=generator,
                    device=generator.device, dtype=torch.float32) * 0.02
    return {"w": w.to(dev),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}


def classify(params, head, tokens, cfg: T.GPTConfig, *,
             pooling: str = "mean", train: bool = False,
             generator: torch.Generator | None = None):
    """f32 class logits (B, C) of the pooled encoder states."""
    h = encode(params, tokens, cfg, train=train, generator=generator)
    return pool(h, pooling).float() @ head["w"] + head["b"]


def make_classifier_train_step(cfg: T.GPTConfig, n_classes: int, *,
                               pooling: str = "mean"):
    """Fine-tune the encoder and the head jointly with softmax CE:
    step(params, head, opt_state, tokens, labels, lr, generator=None) ->
    (params, head, opt_state, loss), with opt_state from
    `adam_init([params, head])` (one Adam state over the pair; JAX's is a
    tuple). All three are updated in place."""
    del n_classes          # the head's shape carries it

    def step(params, head, opt_state, tokens, labels, lr, generator=None):
        both = [params, head]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(both)]
        p, h = tree_unflatten(both, leaves)
        logits = classify(p, h, tokens, cfg, pooling=pooling, train=True,
                          generator=generator)
        lse = torch.logsumexp(logits, -1)
        tgt = logits.gather(-1, labels.long()[:, None])[:, 0]
        loss = (lse - tgt).mean()
        grads = tree_unflatten(both, torch.autograd.grad(loss, leaves))
        _, opt_state = adam_update(both, grads, opt_state, lr)
        return params, head, opt_state, loss.detach()

    return step
