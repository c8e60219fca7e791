"""GPT-2-style transformer: the paged serving slice and the training step
(counterpart of `neuronika_tpu/models/transformer.py`).

Params are a plain dict of tensors with the JAX tree's names and shapes:
per-layer tensors are STACKED on a leading `n_layer` axis under "blocks",
so a JAX-initialised tree converts unchanged (`params_from_jax`). Params
live in f32; `prepare_decode_params` casts the big matrices to the compute
dtype once for serving.

Ported: the learned-position / LayerNorm / GELU / tied-head GPT with GQA
and sliding-window attention, the paged KV cache, unbucketed paged
prefill, the paged decode step and per-row sampling; and for training
`hidden_states`, `forward`, `loss_fn`, `opt_init`, `opt_state_from_jax`,
`make_train_step` (Adam, clipping, accumulation) and `flops_per_token`,
whose attention runs the packed-qkv flash op (`ops/flash_attention.py`).
The other variants raise `NotImplementedError` from `GPTConfig`, and so
do in-kernel dropout, remat policies other than "full", the fused
cross-entropy and sliding windows on the flash path.

Rounding that differs from the JAX package in bf16 (f32 is unaffected):
* a bf16 matmul here returns bf16 (f32 accumulation inside), where JAX
  returns f32 (`preferred_element_type`), adds the bias in f32 and rounds
  once; here the product is rounded before the bias add;
* the paged-attention kernel and its plain version keep the softmax
  weights in f32 for PV (JAX's kernel casts them to v's dtype);
LM-head logits are f32 in both, as sampling needs. In training,
`matmul_out="f32"` and the f32 logits come from bf16 GEMMs with an f32
result (`_dot_f32`), as JAX's `preferred_element_type=f32`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..device import resolve
from ..ops.flash_attention import flash_attention_qkv
from ..ops.paged_attention import paged_attention
from ..optim.functional import adam_init, adam_update, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The slice's fields of the JAX `GPTConfig`, same names and
    defaults; `dtype` is the compute dtype (a torch dtype)."""
    vocab_size: int = 256
    n_layer: int = 4
    n_head: int = 4
    # grouped-query attention: number of KV heads (0 -> n_head, i.e. MHA)
    n_kv_head: int = 0
    d_model: int = 256
    d_ff: int = 1024
    max_seq: int = 256
    pos_emb: str = "learned"
    norm: str = "layer"
    norm_eps: float = 1e-5
    mlp: str = "gelu"
    bias: bool = True
    tied_head: bool = True
    causal: bool = True
    # sliding-window attention: attend the last `window` tokens (0 = full)
    window: int = 0
    n_experts: int = 0
    # training fields (JAX names and defaults; see the JAX GPTConfig)
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # "auto"/"on": the packed flash-attention op (the CUDA kernels for
    # CUDA tensors, their plain versions on the CPU); "off": the composite
    flash: str = "auto"
    # checkpoint each block in training (policy "full" only)
    remat: bool = True
    remat_policy: str = "full"
    # TPU tile size; accepted, the CUDA kernels choose their own tiles
    flash_block: int = 256
    # fused linear + cross-entropy kernel ("on" is not ported)
    fused_ce: str = "auto"
    # body matmul outputs: "f32" (bf16 product, f32 result, bias added in
    # f32) or "compute" (result in `dtype`)
    matmul_out: str = "f32"
    # LM-head logits materialised in "f32" or the "compute" dtype
    logits_dtype: str = "f32"
    # accepted; the layers always run as a Python loop
    scan_layers: bool = True
    # flash softmax: "safe" (running max) or "fast" (none)
    flash_softmax: str = "safe"
    # flash backward: "split" (dq kernel, then dk/dv kernel) or "fused"
    flash_bwd: str = "split"
    # Adam m/v dtype: "f32" or "bf16" (update math in f32)
    opt_state_dtype: str = "f32"

    def __post_init__(self):
        for name, want in (("pos_emb", "learned"), ("norm", "layer"),
                           ("mlp", "gelu")):
            if getattr(self, name) != want:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"(only {want!r})")
        if self.n_experts:
            raise NotImplementedError("mixture-of-experts is not ported yet")
        if not self.tied_head:
            raise NotImplementedError("an untied LM head is not ported yet")
        for name, allowed in (("flash", ("auto", "on", "off")),
                              ("fused_ce", ("auto", "on", "off")),
                              ("matmul_out", ("f32", "compute")),
                              ("logits_dtype", ("f32", "compute")),
                              ("flash_softmax", ("safe", "fast")),
                              ("flash_bwd", ("split", "fused")),
                              ("opt_state_dtype", ("f32", "bf16"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: want one "
                                 f"of {allowed}")
        if self.remat and self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} is not ported yet (only "
                f"'full'; ROADMAP.md queue 1 item 6)")
        if self.fused_ce == "on":
            raise NotImplementedError(
                "fused_ce='on' (the fused linear + cross-entropy kernels "
                "K8-K10) is not ported yet (ROADMAP.md queue 1 item 6)")


def _kv_heads(cfg: GPTConfig) -> int:
    return cfg.n_kv_head or cfg.n_head


def _qkv_width(cfg: GPTConfig) -> int:
    hd = cfg.d_model // cfg.n_head
    return cfg.d_model + 2 * _kv_heads(cfg) * hd


def _require_causal(cfg: GPTConfig, what: str) -> None:
    if not cfg.causal:
        raise ValueError(f"{what} needs a causal model (cfg.causal=True)")


# --------------------------------------------------------------------------
# params (per-layer tensors are STACKED with a leading n_layer axis)


def init_params(generator: torch.Generator, cfg: GPTConfig,
                device) -> Dict:
    """GPT-2 style init: N(0, 0.02), residual projections scaled by
    1/sqrt(2*n_layer); f32. Values are drawn on `generator`'s device and
    placed on `device`. They do not reproduce JAX's draws from a key."""
    dev = resolve(device)
    std = 0.02
    resid_std = std / math.sqrt(2.0 * cfg.n_layer)
    L, D, F_ = cfg.n_layer, cfg.d_model, cfg.d_ff
    W = _qkv_width(cfg)

    def normal(shape, s=std):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * s).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ln(*shape):
        return {"scale": torch.ones(shape, dtype=torch.float32, device=dev),
                "bias": zeros(*shape)}

    blocks = {
        "ln1": ln(L, D),
        "ln2": ln(L, D),
        "qkv": normal((L, D, W)),
        "qkv_b": zeros(L, W),
        "proj": normal((L, D, D), resid_std),
        "proj_b": zeros(L, D),
        "fc_in": normal((L, D, F_)),
        "fc_in_b": zeros(L, F_),
        "fc_out": normal((L, F_, D), resid_std),
        "fc_out_b": zeros(L, D),
    }
    if not cfg.bias:
        blocks = {k: v for k, v in blocks.items() if not k.endswith("_b")}
    return {"wte": normal((cfg.vocab_size, D)), "ln_f": ln(D),
            "blocks": blocks, "wpe": normal((cfg.max_seq, D))}


def params_from_jax(tree, device="cpu") -> Dict:
    """A JAX params tree (nested dicts of arrays; pass it through
    `jax.tree.map(np.asarray, ...)` or hand over numpy arrays) -> the same
    keys and shapes as tensors on `device`. bf16 leaves go through f32."""
    dev = resolve(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)     # a writable copy

    return tree_map(conv, tree)


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer i's view of the stacked block params."""
    return tree_map(lambda t: t[i], blocks)


# --------------------------------------------------------------------------
# forward pieces


def _layer_norm(x, p, eps=1e-5):
    """LayerNorm with f32 statistics; result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def _badd(t, blk, name, cfg: GPTConfig):
    """t + blk[name] in the compute dtype; identity cast when the bias
    param is absent (cfg.bias=False)."""
    b = blk.get(name)
    return (t if b is None else t + b).to(cfg.dtype)


def _unpack_qkv(qkv, cfg: GPTConfig):
    """Group-major packed (..., W) -> q (..., KV, G, hd), k/v (..., KV, hd).
    The packed layout is kv-group-major: KV groups of (G+2) hd-wide chunks,
    group g = [q_{gG} ... q_{gG+G-1} | k_g | v_g]."""
    KV = _kv_heads(cfg)
    G = cfg.n_head // KV
    hd = cfg.d_model // cfg.n_head
    parts = qkv.reshape(qkv.shape[:-1] + (KV, G + 2, hd))
    return parts[..., :G, :], parts[..., G, :], parts[..., G + 1, :]


class _DotF32(torch.autograd.Function):
    """a @ b for bf16 operands with an f32 result (JAX's `jnp.dot(...,
    preferred_element_type=f32)`): `torch.mm(..., out_dtype=float32)`, a
    cuBLAS GEMM that accumulates and writes f32. Its backward rounds the
    f32 cotangent to the operands' dtype and runs bf16 GEMMs."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ b.T).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = a.reshape(-1, a.shape[-1]).T @ g2
        return da, db


def _dot_f32(a, b):
    """a @ b with an f32 result. f32 operands: a plain f32 matmul. bf16 on
    the card: `_DotF32`. bf16 on the CPU: the operands widened exactly, so
    only the summation order differs from the card."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        return _DotF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def _body_dot(x, w, cfg: GPTConfig):
    """Body matmul honouring cfg.matmul_out: "compute" returns the product
    in the compute dtype; "f32" returns it in f32 (bias then added in f32
    by `_badd`), as JAX's `_body_dot`."""
    if cfg.matmul_out == "compute":
        return torch.matmul(x, w.to(cfg.dtype))
    return _dot_f32(x, w.to(cfg.dtype))


def _head_w(params, cfg: GPTConfig):
    """(V, D) LM-head weight: the tied wte."""
    return params["wte"]


def _lm_head(x, params, cfg: GPTConfig):
    """Logits in f32, like JAX's `jnp.dot(..., preferred_element_type=f32)`:
    a compute-dtype GEMM with an f32 result (`_dot_f32`)."""
    return _dot_f32(x, _head_w(params, cfg).to(x.dtype).T)


def _qdot(x, w, cfg: GPTConfig):
    """x @ w in the compute dtype (the plain branch of JAX's `_qdot`;
    quantized weights are not ported, see `_check_quant`)."""
    return torch.matmul(x, w.to(cfg.dtype))


def _mlp(x, blk, cfg: GPTConfig, dot=None):
    """Dense GELU MLP (JAX's `_mlp` / `_decode_mlp` for mlp="gelu").
    `jax.nn.gelu` defaults to the tanh approximation, and so does this.
    `dot` is the matmul: `_qdot` for serving, `_body_dot` in training."""
    dot = dot or _qdot
    h = _badd(dot(x, blk["fc_in"], cfg), blk, "fc_in_b", cfg)
    h = F.gelu(h, approximate="tanh")
    return _badd(dot(h, blk["fc_out"], cfg), blk, "fc_out_b", cfg)


def _cast_decode_params(params, cfg: GPTConfig):
    """Cast the big weight matrices to the compute dtype ONCE for serving
    (decode is weight-bandwidth-bound); LayerNorm params and biases stay
    f32."""
    p = dict(params)
    p["wte"] = params["wte"].to(cfg.dtype)
    p["wpe"] = params["wpe"].to(cfg.dtype)
    b = dict(params["blocks"])
    for name in ("qkv", "proj", "fc_in", "fc_out"):
        b[name] = b[name].to(cfg.dtype)
    p["blocks"] = b
    return p


def _check_quant(quant) -> None:
    if quant not in (None, "none"):
        raise NotImplementedError(f"quant={quant!r} is not ported yet")


def prepare_decode_params(params, cfg: GPTConfig, quant: str | None = None):
    """Cast training params for serving once. `quant` other than None or
    "none" is not ported. Casting prepared params again is free (`.to` of a
    tensor already in the dtype returns it)."""
    _check_quant(quant)
    return _cast_decode_params(params, cfg)


def _decode_qkv(x, blk, cfg: GPTConfig):
    """q (B,KV,G,1,hd), new-token k/v (B,KV,1,hd) for one layer."""
    h = _layer_norm(x, blk["ln1"], cfg.norm_eps)
    qkv = _badd(_qdot(h, blk["qkv"], cfg), blk, "qkv_b", cfg)
    # grouped-query attention without repeating K/V: the group axis is
    # folded into the query side (G = H/KV queries share a KV head)
    q, k, v = _unpack_qkv(qkv, cfg)      # q (B,1,KV,G,hd), k/v (B,1,KV,hd)
    return (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3))


def _decode_block(x, blk, q, lk, lv, pos, cfg: GPTConfig):
    """Attention + MLP for a single new token x (B, 1, D) over a gathered
    cache `lk`/`lv` (B, KV, S, hd) that ALREADY holds the new token at
    `pos` (B,). Scores and PV in f32; the softmax is cast to the compute
    dtype before PV, as in JAX."""
    B = x.shape[0]
    hd = cfg.d_model // cfg.n_head
    att = torch.einsum("bkgqd,bksd->bkgqs", q.float(), lk.float())
    att = att / math.sqrt(hd)
    idx = torch.arange(att.shape[-1], device=att.device)
    pos_b = pos.long().view(B, 1, 1, 1, 1)
    keep = idx <= pos_b
    if cfg.window:
        keep &= pos_b - idx < cfg.window
    att = torch.softmax(att.masked_fill(~keep, -1e30), -1).to(cfg.dtype)
    ctx = torch.einsum("bkgqs,bksd->bkgqd", att.float(), lv.float())
    ctx = ctx.to(cfg.dtype).permute(0, 3, 1, 2, 4).reshape(B, 1, cfg.d_model)
    return _decode_post(x, blk, ctx, cfg)


def _decode_post(x, blk, ctx, cfg: GPTConfig):
    """Post-attention half of a decode block: output projection,
    residual, MLP. `ctx` is the merged-heads attention output (B, 1, D)."""
    ctx = _qdot(ctx, blk["proj"], cfg)
    x = x + _badd(ctx, blk, "proj_b", cfg)
    return x + _mlp(_layer_norm(x, blk["ln2"], cfg.norm_eps), blk, cfg)


def _prefill_body(params, cache, prompt, cfg: GPTConfig):
    """Batched prefill: ONE pass over the whole prompt (B, P) writes each
    layer's K/V into `cache` (L, B, KV, S>=P, hd) in place at positions
    0..P-1 and returns the last position's f32 logits (B, V) and the
    cache. Attention here is plain torch, as it is an einsum outside any
    kernel in JAX."""
    B, P = prompt.shape
    hd = cfg.d_model // cfg.n_head
    dev = prompt.device
    x = (params["wte"][prompt] + params["wpe"][:P]).to(cfg.dtype)
    iq = torch.arange(P, device=dev)[:, None]
    ik = torch.arange(P, device=dev)[None, :]
    keep = ik <= iq
    if cfg.window:
        keep &= iq - ik < cfg.window
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        h = _layer_norm(x, blk["ln1"], cfg.norm_eps)
        qkv = _badd(_qdot(h, blk["qkv"], cfg), blk, "qkv_b", cfg)
        q, k, v = _unpack_qkv(qkv, cfg)
        q = q.permute(0, 2, 3, 1, 4)                     # (B,KV,G,P,hd)
        k = k.permute(0, 2, 1, 3)                        # (B,KV,P,hd)
        v = v.permute(0, 2, 1, 3)
        att = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float())
        att = att / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~keep, -1e30), -1).to(cfg.dtype)
        ctx = torch.einsum("bkgqs,bksd->bkgqd", att.float(), v.float())
        ctx = ctx.to(cfg.dtype).permute(0, 3, 1, 2, 4).reshape(
            B, P, cfg.d_model)
        x = x + _badd(_qdot(ctx, blk["proj"], cfg), blk, "proj_b", cfg)
        x = x + _mlp(_layer_norm(x, blk["ln2"], cfg.norm_eps), blk, cfg)
        cache["k"][i, :, :, :P] = k
        cache["v"][i, :, :, :P] = v
    x = _layer_norm(x[:, -1], params["ln_f"], cfg.norm_eps)
    cache["pos"] = cache["pos"] + P
    return _lm_head(x, params, cfg), cache


# --------------------------------------------------------------------------
# paged KV cache (block tables; vLLM-style memory management)


def init_paged_cache(cfg: GPTConfig, n_blocks: int, block_size: int,
                     n_slots: int, device):
    """Block-pool KV cache: K/V live in a shared pool of `n_blocks`
    fixed-size blocks (L, NB, KV, BS, hd) instead of a dense per-slot
    reservation. Block 0 is scratch for inactive decode lanes; the
    allocator (serving.PagedBatcher) never hands it out."""
    dev = resolve(device)
    hd = cfg.d_model // cfg.n_head
    shape = (cfg.n_layer, n_blocks, _kv_heads(cfg), block_size, hd)
    return {
        "pk": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pv": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    }


def make_paged_prefill(cfg: GPTConfig, block_size: int,
                       quant: str | None = None):
    """Prefill into pool blocks: (params, cache, prompt (1, P), slot,
    blocks (>= ceil(P/BS),) int) -> (last-position logits (V,), cache).
    One pass computes the prompt's K/V (`_prefill_body`), which is then
    scattered into the slot's first ceil(P/BS) blocks; pos[slot] = P. The
    cache is updated in place."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_quant(quant)
    BS = block_size

    def pre(params, cache, prompt, slot, blocks):
        params = _cast_decode_params(params, cfg)
        P = prompt.shape[1]
        nb = -(-P // BS)
        L, KV = cfg.n_layer, _kv_heads(cfg)
        hd = cfg.d_model // cfg.n_head
        shape = (L, 1, KV, max(nb * BS, BS), hd)
        mini = {"k": torch.zeros(shape, dtype=cfg.dtype, device=prompt.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=prompt.device),
                "pos": 0}
        logits, mini = _prefill_body(params, mini, prompt, cfg)
        idx = blocks[:nb].long()
        for name, src in (("pk", mini["k"]), ("pv", mini["v"])):
            t = src[:, 0].reshape(L, KV, nb, BS, hd).permute(0, 2, 1, 3, 4)
            cache[name][:, idx] = t.to(cache[name].dtype)
        cache["pos"][slot] = P
        return logits[0], cache

    return pre


def make_paged_decode_step(cfg: GPTConfig, block_size: int,
                           quant: str | None = None, kernel: str = "auto"):
    """Decode over the block pool: (params, cache, tokens (B,), active (B,)
    bool, table (B, MB) int32) -> (logits (B, V) f32, cache). The cache is
    updated in place (JAX donates it).

    `table[s, m]` names the pool block holding slot s's logical positions
    [m*BS, (m+1)*BS). Inactive lanes rewrite scratch block 0 with its own
    values and their outputs are discarded.

    `kernel` picks the attention path: "auto" runs the CUDA kernel
    (`ops/paged_attention.py`) for CUDA tensors and its plain version for
    CPU tensors; "on" is the same but refuses CPU tensors; "off" runs the
    gather path (JAX's XLA branch)."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_quant(quant)
    if kernel not in ("auto", "on", "off"):
        raise ValueError(f"kernel must be auto/on/off, got {kernel!r}")
    BS = block_size

    def step(params, cache, tokens, active, table):
        if kernel == "on" and cache["pk"].device.type != "cuda":
            raise ValueError("kernel='on' needs CUDA tensors; on the CPU "
                             "use kernel='auto' (plain version) or 'off'")
        params = _cast_decode_params(params, cfg)
        return _paged_decode_body(params, cache, tokens, active, table, cfg,
                                  kernel != "off", BS)

    return step


def _paged_decode_body(params, cache, tokens, active, table,
                       cfg: GPTConfig, use_kernel: bool, BS: int):
    """One paged-decode step on PREPARED params."""
    pos = cache["pos"]                                   # (B,) int32
    B = tokens.shape[0]
    MB = table.shape[1]
    KV = _kv_heads(cfg)
    hd = cfg.d_model // cfg.n_head
    pos_w = pos.clamp(max=MB * BS - 1)                   # clamp idle slots
    x = params["wte"][tokens.long()]
    x = x + params["wpe"][pos_w.clamp(max=cfg.max_seq - 1).long()]
    x = x.to(cfg.dtype)[:, None, :]
    t_long = table.long()
    bar = torch.arange(B, device=tokens.device)
    bid = torch.where(active, t_long[bar, (pos_w // BS).long()], 0)
    off = (pos_w % BS).long()
    keep = active[:, None, None]
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        q, k_new, v_new = _decode_qkv(x, blk, cfg)
        pk_l, pv_l = cache["pk"][i], cache["pv"][i]
        # two advanced indices split by a slice: the batch axis comes first,
        # (B, KV, hd), matching k_new[:, :, 0]
        pk_l[bid, :, off] = torch.where(keep, k_new[:, :, 0], pk_l[bid, :, off])
        pv_l[bid, :, off] = torch.where(keep, v_new[:, :, 0], pv_l[bid, :, off])
        if use_kernel:
            ctx = paged_attention(q[:, :, :, 0].contiguous(), pk_l, pv_l,
                                  table, pos_w, window=cfg.window)
            # kv-group-major (B, KV, G, hd) == head-major merge
            x = _decode_post(x, blk, ctx.reshape(B, 1, cfg.d_model), cfg)
        else:
            lk = pk_l[t_long].permute(0, 2, 1, 3, 4).reshape(
                B, KV, MB * BS, hd)
            lv = pv_l[t_long].permute(0, 2, 1, 3, 4).reshape(
                B, KV, MB * BS, hd)
            x = _decode_block(x, blk, q, lk, lv, pos_w, cfg)
    x = _layer_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _lm_head(x[:, 0], params, cfg)
    cache["pos"] = torch.where(active, pos + 1, pos)
    return logits, cache


# --------------------------------------------------------------------------
# sampling


def _row_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def _sample_row(logits, generator, temperature, top_k, top_p, min_p):
    """Sample one token from one row of logits (V,) with per-request
    controls (Python scalars), in JAX's filter order: min-p, top-k, top-p
    on the temperature-scaled logits; each filter keeps the top token.
    temperature <= 0 is greedy (exact argmax, first index on ties)."""
    l32 = logits.float()
    if temperature <= 0.0:
        return l32.argmax()
    lt = l32 / max(temperature, 1e-6)
    if min_p > 0.0:
        probs = torch.softmax(lt, -1)
        lt = lt.masked_fill(probs < min_p * probs.max(), float("-inf"))
    if top_k > 0:
        kth = torch.topk(lt, min(top_k, lt.shape[-1])).values[-1]
        lt = lt.masked_fill(lt < kth, float("-inf"))
    if top_p > 0.0:
        sorted_desc = torch.sort(lt, descending=True).values
        probs_s = torch.softmax(sorted_desc, -1)
        keep = torch.cumsum(probs_s, -1) - probs_s < top_p
        lt = lt.masked_fill(lt < sorted_desc[keep].min(), float("-inf"))
    return torch.multinomial(torch.softmax(lt, -1), 1,
                             generator=generator)[0]


def sample_logits_batched(logits, seeds, steps, temperature, top_k, top_p,
                          min_p):
    """Per-row sampling over (B, V) logits with PER-ROW controls (host
    sequences of length B) -> (B,) int64 tokens on the logits' device.
    Row b's randomness is a `torch.Generator` seeded from
    (seeds[b], steps[b]), so a request's tokens depend only on its own
    seed and step count, never on its batchmates. The draws do not
    reproduce JAX's `fold_in(key(seed), step)` bits; greedy rows are
    exact."""
    out = logits.float().argmax(-1)
    for b, t in enumerate(temperature):
        if t > 0.0:
            g = _row_generator(seeds[b], steps[b], logits.device)
            out[b] = _sample_row(logits[b], g, float(t), int(top_k[b]),
                                 float(top_p[b]), float(min_p[b]))
    return out


# --------------------------------------------------------------------------
# training: forward, loss and the train step


def _use_flash(cfg: GPTConfig) -> bool:
    """The packed flash op unless cfg.flash is "off". The op itself routes
    by device: the CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors (so "auto" and "on" agree)."""
    return cfg.flash != "off"


def _split_qkv(qkv, cfg: GPTConfig, B, S):
    """Group-major packed (B, S, W) -> q (B,H,S,hd), k/v (B,H,S,hd), KV
    heads repeated up to H (GQA) for the composite path."""
    H = cfg.n_head
    KV = _kv_heads(cfg)
    hd = cfg.d_model // H
    q, k, v = _unpack_qkv(qkv, cfg)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    return q, k, v


def _attention(x, blk, cfg: GPTConfig, train: bool, seed):
    """Attention sublayer of the training forward (JAX's `_attention`,
    learned positions). `seed` (an int or None) seeds composite dropout, so
    a checkpointed block redraws the same mask when it is recomputed."""
    if cfg.window and not cfg.causal:
        raise ValueError(
            "cfg.window (sliding-window attention) requires causal=True")
    B, S, D = x.shape
    H = cfg.n_head
    hd = D // H
    qkv = _badd(_body_dot(x, blk["qkv"], cfg), blk, "qkv_b", cfg)
    drop = cfg.dropout if train else 0.0
    if _use_flash(cfg):
        if cfg.window:
            raise NotImplementedError(
                "sliding-window attention on the flash path (the split-"
                "layout kernels K5-K7) is not ported yet (ROADMAP.md queue "
                "1 item 6); use flash='off'")
        if drop > 0.0:
            raise NotImplementedError(
                "attention dropout in training on the flash path (in-kernel "
                "dropout) is not ported yet (ROADMAP.md queue 1 item 6); "
                "use flash='off'")
        # the packed kernels read head blocks straight from qkv: no split,
        # transpose or GQA-repeat copies
        out = flash_attention_qkv(
            qkv, H, _kv_heads(cfg), cfg.causal, None, cfg.flash_block,
            cfg.flash_block, fast_softmax=cfg.flash_softmax == "fast",
            fused_bwd=cfg.flash_bwd == "fused")
    else:
        q, k, v = _split_qkv(qkv, cfg, B, S)
        att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        att = att / math.sqrt(hd)
        if cfg.causal:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            if cfg.window:
                mask &= ~torch.ones(S, S, dtype=torch.bool,
                                    device=x.device).tril(-cfg.window)
            att = att.masked_fill(~mask, -1e30)
        att = torch.softmax(att, -1).to(cfg.dtype)
        if drop > 0.0:
            if seed is None:
                raise ValueError("dropout in training needs a generator")
            gen = torch.Generator(device=x.device).manual_seed(seed)
            keep = torch.rand(att.shape, generator=gen,
                              device=x.device) >= drop
            att = torch.where(keep, att / (1.0 - drop), 0.0).to(cfg.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", att.float(), v.float())
        out = out.to(cfg.dtype).transpose(1, 2).reshape(B, S, D)
    out = _body_dot(out, blk["proj"], cfg)
    return _badd(out, blk, "proj_b", cfg)


def _block(x, blk, cfg: GPTConfig, train: bool, seed):
    h1 = _layer_norm(x, blk["ln1"], cfg.norm_eps)
    x = x + _attention(h1, blk, cfg, train, seed)
    h2 = _layer_norm(x, blk["ln2"], cfg.norm_eps)
    return x + _mlp(h2, blk, cfg, _body_dot)


def hidden_states(params, tokens, cfg: GPTConfig, *, train: bool = False,
                  generator: torch.Generator | None = None):
    """tokens (B, S) int -> final hidden states (B, S, D) in the compute
    dtype. The embedding sum is taken in f32, then cast (as JAX). Layers
    run as a Python loop (`scan_layers` has no effect); with cfg.remat in
    training each block is checkpointed (policy "full": only its input is
    kept). `generator` drives composite dropout."""
    B, S = tokens.shape
    x = (params["wte"][tokens.long()] + params["wpe"][:S]).to(cfg.dtype)
    seeds = [None] * cfg.n_layer
    if train and cfg.dropout > 0.0 and generator is not None:
        seeds = torch.randint(0, 2 ** 62, (cfg.n_layer,), generator=generator,
                              device=generator.device).tolist()
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        if cfg.remat and train:
            x = torch.utils.checkpoint.checkpoint(
                _block, x, blk, cfg, train, seeds[i], use_reentrant=False)
        else:
            x = _block(x, blk, cfg, train, seeds[i])
    return _layer_norm(x, params["ln_f"], cfg.norm_eps)


def forward(params, tokens, cfg: GPTConfig, *, train: bool = False,
            generator: torch.Generator | None = None):
    """tokens (B, S) -> logits (B, S, V) in f32 (`_lm_head`)."""
    x = hidden_states(params, tokens, cfg, train=train, generator=generator)
    return _lm_head(x, params, cfg)


def loss_fn(params, tokens, targets, cfg: GPTConfig, *, train: bool = False,
            generator: torch.Generator | None = None):
    """Mean token cross-entropy: the tied LM head (a compute-dtype GEMM
    with an f32 result, or a compute-dtype result with
    logits_dtype="compute"), then logsumexp minus the gathered target logit
    on f32 logits."""
    x = hidden_states(params, tokens, cfg, train=train, generator=generator)
    if cfg.logits_dtype == "compute":
        logits = torch.matmul(x, _head_w(params, cfg).to(cfg.dtype).T)
    else:
        logits = _lm_head(x, params, cfg)
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, -1)
    tgt = logits32.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def opt_init(params, cfg: GPTConfig):
    """Adam state for `params`, honouring cfg.opt_state_dtype."""
    dt = torch.bfloat16 if cfg.opt_state_dtype == "bf16" else None
    return adam_init(params, state_dtype=dt)


def opt_state_from_jax(state, device="cpu"):
    """A JAX Adam state ({"m", "v", "step"}; numpy or JAX arrays) -> the
    port's: m and v trees with bf16 leaves kept bf16, step a 0-d f32
    tensor. A JAX run can then be resumed with `make_train_step`."""
    dev = resolve(device)
    return {"m": params_from_jax(state["m"], dev),
            "v": params_from_jax(state["v"], dev),
            "step": torch.tensor(float(np.asarray(state["step"])),
                                 dtype=torch.float32, device=dev)}


def make_train_step(cfg: GPTConfig, grad_clip: float = 0.0,
                    accum_steps: int = 1):
    """One training step: forward, backward (optional global-norm clipping
    and `accum_steps`-way accumulation over microbatches) and Adam.

    Returns step(params, opt_state, tokens, targets, lr, generator) ->
    (params, opt_state, loss). The params and the Adam moments are updated
    IN PLACE (JAX donates both trees), so no second copy of either is held;
    the returned trees are the ones passed in. Accumulation runs the
    microbatches in a Python loop, sums their grads and divides by
    `accum_steps`."""

    def loss_grads(params, tokens, targets, generator):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss = loss_fn(tree, tokens, targets, cfg, train=True,
                       generator=generator)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def step(params, opt_state, tokens, targets, lr, generator=None):
        if accum_steps > 1:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(
                    f"accum_steps ({accum_steps}) must divide batch ({B})")
            loss, grads = 0.0, None
            for mt, mg in zip(tokens.chunk(accum_steps),
                              targets.chunk(accum_steps)):
                l, g = loss_grads(params, mt, mg, generator)
                loss = loss + l
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        else:
            loss, grads = loss_grads(params, tokens, targets, generator)
        grads = tree_unflatten(params, grads)
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        params, opt_state = adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss

    return step


def flops_per_token(cfg: GPTConfig, seq: int) -> float:
    """Training FLOPs/token (fwd+bwd ~ 3x fwd; causal attention counted at
    S/2 average keys, the PaLM convention), as the JAX package counts."""
    p_block = 3 * cfg.d_model**2 + cfg.d_model**2 + 2 * cfg.d_model * cfg.d_ff
    p_matmul = cfg.n_layer * p_block + cfg.vocab_size * cfg.d_model
    attn = cfg.n_layer * 2 * seq * cfg.d_model
    return 3.0 * (2.0 * p_matmul + 2.0 * attn)
