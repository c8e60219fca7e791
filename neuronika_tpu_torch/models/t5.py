"""Encoder-decoder (seq2seq) transformer with cross-attention (counterpart
of `neuronika_tpu/models/t5.py`).

The encoder is the BERT body: a `causal=False` GPTConfig on the GPT stack,
so its attention runs the packed flash op (K1, K2 on the card). The
decoder adds per-layer cross-attention whose keys and values come from
the encoder's output; the source and target share the encoder's token
table, which is also the LM head (T5's weight sharing). Decoder attention
runs the split flash op (`ops/flash_attention.py::flash_attention`: K5
forward, K6 and K7 backward on the card): its self-attention causal at Sq
= Skv, its cross-attention without a mask at Sq = target length and Skv =
source length. This is T5 at its widths only: learned positions,
LayerNorm, GELU and no relative attention bias. Randomness comes from a
`torch.Generator` where JAX takes a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import tree_leaves, tree_unflatten
from ..device import resolve
from ..ops.flash_attention import (MAX_HEAD_DIM, flash_attention,
                                   kernels_take)
from ..optim.functional import adam_update, clip_by_global_norm
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """JAX's `Seq2SeqConfig`, same fields and defaults; `dtype` is a torch
    dtype. `flash`: "on" the flash ops (the kernels for CUDA tensors, their
    plain versions on the CPU; an error on the card where the kernels
    cannot take the shape), "auto" the same but the composite there,
    "off" the composite; `flash_block` is accepted and ignored."""
    vocab_size: int
    n_layer: int = 4          # per stack (encoder and decoder)
    n_head: int = 8
    d_model: int = 512
    d_ff: int = 2048
    max_src: int = 512
    max_tgt: int = 512
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    flash: str = "auto"
    flash_block: int = 256

    def __post_init__(self):
        if self.flash not in ("auto", "on", "off"):
            raise ValueError(f"flash={self.flash!r}: want auto, on or off")

    def encoder_cfg(self) -> T.GPTConfig:
        return T.GPTConfig(
            vocab_size=self.vocab_size, n_layer=self.n_layer,
            n_head=self.n_head, d_model=self.d_model, d_ff=self.d_ff,
            max_seq=self.max_src, dropout=self.dropout, dtype=self.dtype,
            causal=False, flash=self.flash, flash_block=self.flash_block)


def init_params(generator: torch.Generator, cfg: Seq2SeqConfig,
                device) -> Dict:
    """{"encoder": a GPT-body tree, "decoder": {"wpe", "blocks", "ln_f"}};
    the decoder reads the encoder's wte for its tokens and its head. N(0,
    0.02), the residual projections scaled by 1/sqrt(2 L); f32. Values are
    drawn on `generator`'s device and placed on `device`; they do not
    reproduce JAX's draws from a key."""
    dev = resolve(device)
    enc = T.init_params(generator, cfg.encoder_cfg(), dev)
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    std = 0.02
    resid_std = std / math.sqrt(2.0 * L)

    def normal(shape, s=std):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * s).to(dev)

    def ln(*shape):
        return {"scale": torch.ones(shape, dtype=torch.float32, device=dev),
                "bias": torch.zeros(shape, dtype=torch.float32, device=dev)}

    dec = {
        "wpe": normal((cfg.max_tgt, D)),
        "blocks": {
            "ln1": ln(L, D), "ln2": ln(L, D), "ln3": ln(L, D),
            "qkv": normal((L, D, 3 * D)),
            "proj": normal((L, D, D), resid_std),
            "xq": normal((L, D, D)),
            "xkv": normal((L, D, 2 * D)),
            "xproj": normal((L, D, D), resid_std),
            "fc_in": normal((L, D, F_)),
            "fc_out": normal((L, F_, D), resid_std),
        },
        "ln_f": ln(D),
    }
    return {"encoder": enc, "decoder": dec}


def encode(params, src, cfg: Seq2SeqConfig, *, train: bool = False,
           generator: torch.Generator | None = None):
    """src (B, S) -> encoder memory (B, S, D), bidirectional."""
    return T.hidden_states(params["encoder"], src, cfg.encoder_cfg(),
                           train=train, generator=generator)


def _use_flash(cfg: Seq2SeqConfig, x) -> bool:
    """The port's GPT rule (`transformer._use_flash`): a flash op unless
    flash is "off", or "auto" on the card where the kernels cannot take
    the shape (a head dim above 256, a dtype other than f32 and bf16);
    "on" raises there. CPU tensors take the ops' plain versions. JAX's
    gate also asks Sq and Skv to divide into `flash_block` tiles and to be
    at least 8 (TPU tiling: the CUDA kernels mask any ragged length, down
    to Sq = Skv = 1, so greedy generation's first steps take them too)
    and, on "auto", Sq Skv >= 2^16 (a TPU tuning floor); none of these
    applies here."""
    if cfg.flash == "off":
        return False
    hd = cfg.d_model // cfg.n_head
    if x.device.type != "cuda" or kernels_take(cfg.dtype, hd):
        return True
    if cfg.flash == "auto":
        return False
    raise NotImplementedError(
        f"flash='on' on the card: the kernels take f32 and bf16 at head "
        f"dims 1..{MAX_HEAD_DIM}, not {cfg.dtype}, head dim {hd}; "
        f"flash='auto' takes the composite (ROADMAP.md queue 1 item 3)")


def _mha(q, k, v, n_head: int, *, causal: bool, cfg: Seq2SeqConfig):
    """q (B, Sq, D), k and v (B, Skv, D) -> (B, Sq, D): the split flash op
    or the composite (f32 scores and PV, the softmax cast to the compute
    dtype, a causal mask from the top left)."""
    dt = cfg.dtype
    B, Sq, D = q.shape
    Skv = k.shape[1]
    hd = D // n_head
    q = q.reshape(B, Sq, n_head, hd).transpose(1, 2)
    k = k.reshape(B, Skv, n_head, hd).transpose(1, 2)
    v = v.reshape(B, Skv, n_head, hd).transpose(1, 2)
    if _use_flash(cfg, q):
        out = flash_attention(q, k, v, causal, None, cfg.flash_block,
                              cfg.flash_block)
    else:
        att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        att = att / math.sqrt(hd)
        if causal:
            mask = torch.ones(Sq, Skv, dtype=torch.bool,
                              device=q.device).tril()
            att = att.masked_fill(~mask, -1e30)
        att = torch.softmax(att, -1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", att.float(), v.float())
    return out.to(dt).transpose(1, 2).reshape(B, Sq, D)


def _res_drop(y, cfg: Seq2SeqConfig, train: bool, generator):
    """Residual dropout on a decoder sub-layer's output (training only)."""
    if not train or cfg.dropout == 0.0:
        return y
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    u = torch.rand(y.shape, generator=generator, device=generator.device)
    keep = u.to(y.device) < 1.0 - cfg.dropout
    return torch.where(keep, y / (1.0 - cfg.dropout), 0.0).to(y.dtype)


def _decoder_block(x, memory, blk, cfg: Seq2SeqConfig, train: bool,
                   generator):
    dt = cfg.dtype
    H = cfg.n_head

    def dot(a, w):                   # a product in the compute dtype
        return torch.matmul(a, w.to(dt))

    # causal self-attention
    h = T._layer_norm(x, blk["ln1"])
    q, k, v = dot(h, blk["qkv"]).chunk(3, dim=-1)
    a = dot(_mha(q, k, v, H, causal=True, cfg=cfg), blk["proj"])
    x = x + _res_drop(a, cfg, train, generator)
    # cross-attention: queries from the decoder, keys and values from the
    # encoder's memory
    h = T._layer_norm(x, blk["ln2"])
    k, v = dot(memory, blk["xkv"]).chunk(2, dim=-1)
    a = _mha(dot(h, blk["xq"]), k, v, H, causal=False, cfg=cfg)
    x = x + _res_drop(dot(a, blk["xproj"]), cfg, train, generator)
    # MLP
    h = T._layer_norm(x, blk["ln3"])
    m = dot(F.gelu(dot(h, blk["fc_in"]), approximate="tanh"), blk["fc_out"])
    return x + _res_drop(m, cfg, train, generator)


def forward(params, src, tgt, cfg: Seq2SeqConfig, *, train: bool = False,
            generator: torch.Generator | None = None, memory=None):
    """Teacher-forced decode: (src (B, Ss), tgt (B, St)) -> f32 logits
    (B, St, V). A precomputed `memory` skips the encoder (generation)."""
    if memory is None:
        memory = encode(params, src, cfg, train=train, generator=generator)
    dec = params["decoder"]
    St = tgt.shape[1]
    wte = params["encoder"]["wte"]
    x = (wte[tgt.long()] + dec["wpe"][:St]).to(cfg.dtype)
    for i in range(cfg.n_layer):
        x = _decoder_block(x, memory, T._layer(dec["blocks"], i), cfg,
                           train, generator)
    x = T._layer_norm(x, dec["ln_f"])
    return T._dot_f32(x, wte.to(cfg.dtype).T).float()


def loss_fn(params, src, tgt_in, tgt_out, cfg: Seq2SeqConfig, *,
            pad_id: int | None = None, train: bool = False,
            generator: torch.Generator | None = None):
    """Mean token cross-entropy; with `pad_id`, over the positions whose
    target is not `pad_id`."""
    logits = forward(params, src, tgt_in, cfg, train=train,
                     generator=generator)
    lse = torch.logsumexp(logits, -1)
    per = lse - logits.gather(-1, tgt_out.long()[..., None])[..., 0]
    if pad_id is None:
        return per.mean()
    w = (tgt_out != pad_id).float()
    return (per * w).sum() / w.sum().clamp(min=1.0)


def make_train_step(cfg: Seq2SeqConfig, *, pad_id: int | None = None,
                    grad_clip: float = 0.0):
    """Forward, backward, optional clipping and Adam:
    step(params, opt_state, src, tgt_in, tgt_out, lr, generator=None) ->
    (params, opt_state, loss); params and Adam state updated in place."""

    def step(params, opt_state, src, tgt_in, tgt_out, lr, generator=None):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), src, tgt_in, tgt_out,
                       cfg, pad_id=pad_id, train=True, generator=generator)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        params, opt_state = adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss.detach()

    return step


@torch.no_grad()
def greedy_generate(params, src, cfg: Seq2SeqConfig, *, bos_id: int,
                    eos_id: int | None = None, max_new: int = 64):
    """Greedy decode with the encoder's memory computed once; the decoder
    reruns teacher-forced over the grown prefix each step, as JAX's does.
    Runs on the params' device; returns (B, 1 + n) int32 numpy, n <=
    `max_new` (it stops once every row has emitted `eos_id`)."""
    dev = params["encoder"]["wte"].device
    src = torch.as_tensor(src, device=dev)
    memory = encode(params, src, cfg)
    B = src.shape[0]
    out = np.full((B, 1), bos_id, np.int32)
    done = np.zeros(B, bool)
    for _ in range(max_new):
        logits = forward(params, None, torch.from_numpy(out).to(dev), cfg,
                         memory=memory)
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
        if eos_id is not None:
            nxt = np.where(done, eos_id, nxt)
            done |= nxt == eos_id
        out = np.concatenate([out, nxt[:, None].astype(np.int32)], axis=1)
        if eos_id is not None and done.all():
            break
    return out

