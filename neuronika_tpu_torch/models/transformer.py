"""GPT-style transformers: serving and the training step (counterpart
of `neuronika_tpu/models/transformer.py`).

Params are a plain dict of tensors with the JAX tree's names and shapes:
per-layer tensors are STACKED on a leading `n_layer` axis under "blocks",
so a JAX-initialised tree converts unchanged (`params_from_jax`). Params
live in f32; `prepare_decode_params` casts the big matrices to the compute
dtype once for serving.

Ported: the GPT-2 stack (learned positions, LayerNorm, GELU, tied head)
and the llama/Mistral stack (`llama_config`, `mistral_config`: rotary
positions, RMSNorm, SwiGLU, no biases, an untied `lm_head`), each with GQA
and sliding-window attention; serving: quantized decode weights
(`prepare_decode_params(quant=)`: W8A8 "int8", W4A16 "int4") and the int8
KV cache ("int8-kv"; the dense-slot programs take it too, where JAX's
refuse it), the dense KV cache (`init_kv_cache`, `make_prefill`,
`make_decode_step`, `sample_logits`, `generate`, `make_generate`,
`make_beam_search`, `make_speculative_generate`; the decode position stays
on the device), the dense-slot programs (`init_slot_cache`,
`make_slot_prefill`, `_multi`, `_suffix_`, `_chunk_`, `make_slot_decode_
step`, `_many`), the paged ones (`init_paged_cache`, `make_paged_prefill`,
`_multi`, `_suffix_`, `_chunk_`, `make_paged_decode_step`, `_many`: K11 on
every decode step) and per-row sampling and LoRA adapters; for training
`hidden_states`, `forward`, `loss_fn`, `opt_init`, `opt_state_from_jax`,
`make_train_step` (Adam, clipping, accumulation) and `flops_per_token`;
and `make_eval_step`/`evaluate`. The sharded train step
(`make_sharded_train_step`, `param_shardings`, `fsdp_param_shardings`)
runs one process a rank over a mesh with dp, tp, cp and ep axes: the
batch over dp, Megatron column and row splits over tp (with
`seq_parallel` the residual stream sequence-sharded over tp), ZeRO-3 with
fsdp, the sequence over cp with attention on the ring, and experts over
ep with the all-to-all dispatch (`_moe_mlp_ep`; `_Shards` holds a rank's
view and its collectives). The pipelined steps
(`make_pipelined_train_step`: GPipe; `make_pipelined_train_step_1f1b`)
split the blocks into stages over a pp axis, one process a stage, or run
every stage of a virtual pipeline in one process. Serving meshes and a pp
axis in the sharded step raise `NotImplementedError` naming their
ROADMAP.md item, as does the int8 KV cache on the paged programs (JAX's
refusal). Training attention
runs the packed flash op (K1/K2) for learned positions without a window,
and the split flash op (K5-K7, `ops/flash_attention.py`) on q/k/v split
out of the packed projection, rotated under rope, with or without a
window.
`fused_ce="on"` takes the loss through the fused linear cross-entropy
(K8-K10, `ops/cross_entropy.py`) under JAX's gate. Attention dropout runs
inside the flash kernels, each layer's mask keyed by a seed drawn from the
step's generator (`keep_mask`); the composite (flash="off", or "auto"
where the kernels cannot take the shape) draws the same mask.
Mixture-of-experts (`n_experts`; top-1 gated, Switch-style) routes by
`moe_impl`: "dense" (every expert on every token, gated), "sparse" (per-
expert capacity, one-hot dispatch) and "sort" (the same routing by a
stable argsort and row scatter/gather); "ep" takes the sparse path, as
JAX's does without a mesh, and on a mesh with an ep axis the all-to-all
dispatch; a decode step (S == 1) always takes the dense, no-drop
routing. The expert GEMMs run on cuBLAS, as JAX's on XLA.
With `remat`, each block is checkpointed under JAX's five remat policies
(`_remat_context`): "full" keeps only the block's input; "flash" also the
flash forwards' (out, lse), so the backward does not rerun K1 or K5;
"names" those and the tagged activations (`_tagged`: ln1_out, ln2_out,
ffn_pre, ffn_gate, attn_q/k/v, attn_qkv); "dots" the outputs of
matmuls without batch dims; "flash_dots" the union of "flash" and
"dots".

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
import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..config import config
from ..device import resolve
from ..ops.cross_entropy import fused_linear_cross_entropy
from ..ops.flash_attention import (FWD_OPS, MAX_HEAD_DIM, flash_attention,
                                   flash_attention_dropout,
                                   flash_attention_qkv, keep_mask,
                                   kernels_take)
from ..ops.paged_attention import paged_attention
from ..optim.functional import adam_init, adam_update, clip_by_global_norm

REMAT_POLICIES = ("full", "flash", "names", "dots", "flash_dots")


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
    # "learned" (a wpe table) or "rope" (rotary, GPT-NeoX half-split, on
    # q/k; no wpe param)
    pos_emb: str = "learned"
    rope_theta: float = 10000.0
    # "layer" (LayerNorm, scale and bias) or "rms" (RMSNorm, scale only)
    norm: str = "layer"
    norm_eps: float = 1e-5
    # "gelu" or "swiglu" (silu(x @ fc_gate) * (x @ fc_in) -> fc_out)
    mlp: str = "gelu"
    bias: bool = True
    # the LM head is wte (tied) or a separate "lm_head" (V, D) param
    tied_head: bool = True
    causal: bool = True
    # sliding-window attention: attend the last `window` tokens (0 = full)
    window: int = 0
    # mixture-of-experts FFN: 0 = dense MLP; > 0 = top-1 gated experts
    # (gelu only), dispatched by moe_impl ("dense", "sparse", "sort"; "ep"
    # runs "sparse" on one device and the all-to-all on a mesh with an ep
    # axis) with per-expert capacity
    # ceil(moe_capacity * tokens / n_experts) and the Switch load-balancing
    # loss E * sum_e f_e P_e added to the training loss at moe_aux_weight
    n_experts: int = 0
    moe_impl: str = "dense"
    moe_capacity: float = 2.0
    moe_aux_weight: float = 0.0
    # sequence parallelism (sharded step only): the residual stream, norms
    # and head run sequence-sharded over the mesh's tp axis, gathered
    # before and reduce-scattered after each attention and MLP; no effect
    # without a mesh or under a cp axis (JAX's field and meaning)
    seq_parallel: bool = False
    # training fields (JAX names and defaults; see the JAX GPTConfig)
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # "on": the flash-attention ops (the CUDA kernels for CUDA tensors,
    # their plain versions on the CPU); "auto": the same, but the composite
    # where the kernels cannot take the shape on the card (a head dim above
    # 256, f16); "off": the composite
    flash: str = "auto"
    # checkpoint each block in training, keeping what the policy names:
    # "full", "flash", "names", "dots" or "flash_dots" (`_remat_context`)
    remat: bool = True
    remat_policy: str = "full"
    # TPU tile size; accepted, the CUDA kernels choose their own tiles
    flash_block: int = 256
    # fused linear + cross-entropy ("on": K8-K10 where rows % 256 == 0 and
    # vocab_size % 1024 == 0, as JAX gates it; "auto" and "off": composite)
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
        for name, allowed in (("pos_emb", ("learned", "rope")),
                              ("moe_impl", ("dense", "sparse", "sort", "ep")),
                              ("norm", ("layer", "rms")),
                              ("mlp", ("gelu", "swiglu")),
                              ("flash", ("auto", "on", "off")),
                              ("fused_ce", ("auto", "on", "off")),
                              ("matmul_out", ("f32", "compute")),
                              ("logits_dtype", ("f32", "compute")),
                              ("flash_softmax", ("safe", "fast")),
                              ("flash_bwd", ("split", "fused")),
                              ("opt_state_dtype", ("f32", "bf16")),
                              ("remat_policy", REMAT_POLICIES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: want one "
                                 f"of {allowed}")


def llama_config(**kw) -> GPTConfig:
    """Llama-family preset: rotary positions, RMSNorm, SwiGLU MLP, no
    biases, untied LM head. Any GPTConfig field can be overridden."""
    base = dict(pos_emb="rope", norm="rms", mlp="swiglu", bias=False,
                tied_head=False)
    base.update(kw)
    return GPTConfig(**base)


def mistral_config(**kw) -> GPTConfig:
    """Mistral-family preset: the llama stack plus sliding-window
    attention (default window 4096)."""
    base = dict(window=4096)
    base.update(kw)
    return llama_config(**base)


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


def _param_tree(cfg: GPTConfig, normal, fill) -> Dict:
    """The params tree of `cfg` with leaves normal(shape, std) and
    fill(shape, value), made in `init_params`' draw order."""
    std = 0.02
    resid_std = std / math.sqrt(2.0 * cfg.n_layer)
    L, D, F_ = cfg.n_layer, cfg.d_model, cfg.d_ff
    W = _qkv_width(cfg)

    def zeros(*shape):
        return fill(shape, 0.0)

    def ln(*shape):
        p = {"scale": fill(shape, 1.0)}
        if cfg.norm == "layer":
            p["bias"] = zeros(*shape)
        return p

    blocks = {
        "ln1": ln(L, D),
        "ln2": ln(L, D),
        "qkv": normal((L, D, W), std),
        "qkv_b": zeros(L, W),
        "proj": normal((L, D, D), resid_std),
        "proj_b": zeros(L, D),
    }
    if cfg.n_experts:
        if cfg.mlp != "gelu":
            raise ValueError("mlp='swiglu' is dense-MLP only (n_experts=0)")
        E = cfg.n_experts
        blocks.update({
            "gate": normal((L, D, E), std),
            "fc_in": normal((L, E, D, F_), std),
            "fc_in_b": zeros(L, E, F_),
            "fc_out": normal((L, E, F_, D), resid_std),
            "fc_out_b": zeros(L, E, D),
        })
    else:
        blocks.update({
            "fc_in": normal((L, D, F_), std),
            "fc_in_b": zeros(L, F_),
            "fc_out": normal((L, F_, D), resid_std),
            "fc_out_b": zeros(L, D),
        })
    if cfg.mlp == "swiglu":
        blocks["fc_gate"] = normal((L, D, F_), std)
        blocks["fc_gate_b"] = zeros(L, F_)
    if not cfg.bias:
        blocks = {k: v for k, v in blocks.items() if not k.endswith("_b")}
    params = {"wte": normal((cfg.vocab_size, D), std), "ln_f": ln(D),
              "blocks": blocks}
    if cfg.pos_emb == "learned":
        params["wpe"] = normal((cfg.max_seq, D), std)
    if not cfg.tied_head:
        params["lm_head"] = normal((cfg.vocab_size, D), std)
    return params


def init_params(generator: torch.Generator, cfg: GPTConfig,
                device) -> Dict:
    """GPT-2 style init: N(0, 0.02), residual projections scaled by
    1/sqrt(2*n_layer); f32; the JAX tree's structure (rms norms carry only
    a scale, no wpe under rope, fc_gate for SwiGLU, lm_head when untied, no
    *_b without bias; with experts a gate (L, D, E) and expert fc_in (L, E,
    D, F), fc_out (L, E, F, D) with biases (L, E, F), (L, E, D)). Values
    are drawn on `generator`'s device and placed on `device`. They do not
    reproduce JAX's draws from a key."""
    dev = resolve(device)

    def normal(shape, s):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * s).to(dev)

    def fill(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return _param_tree(cfg, normal, fill)


def param_shapes(cfg: GPTConfig) -> Dict:
    """The params tree of `cfg` as tensors on the meta device: shapes and
    dtypes, no storage (JAX's `eval_shape` of `init_params`)."""
    def meta(shape, _):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return _param_tree(cfg, meta, meta)


def param_shardings(mesh, cfg: GPTConfig) -> Dict:
    """Megatron-style tp layout, replicated small params: a tree of
    `parallel.NamedSharding` over `mesh` (JAX's `param_shardings`). The
    stacked block leaves keep their leading layer axis unsplit: qkv,
    fc_in (fc_gate) and their biases split their output columns over tp,
    proj and fc_out their input rows; wte and lm_head split d_model.
    With experts (JAX's ep layouts): the gate replicated, the experts
    split over ep on their expert axis (where the mesh has one) and
    Megatron-split over tp inside each expert."""
    from ..parallel.mesh import NamedSharding

    names = mesh.mesh_dim_names
    axes = {a: (a if a in names else None) for a in ("tp", "ep")}

    def ns(*spec):
        return NamedSharding(mesh, [axes.get(a, a) for a in spec])

    rep = ns()
    ln = ({"scale": rep, "bias": rep} if cfg.norm == "layer"
          else {"scale": rep})
    shard = {
        "wte": ns(None, "tp"),
        "ln_f": dict(ln),
        "blocks": {
            "ln1": dict(ln),
            "ln2": dict(ln),
            "qkv": ns(None, None, "tp"),
            "qkv_b": ns(None, "tp"),
            "proj": ns(None, "tp", None),
            "proj_b": rep,
        },
    }
    if cfg.n_experts:
        shard["blocks"].update({
            "gate": rep,
            "fc_in": ns(None, "ep", None, "tp"),
            "fc_in_b": ns(None, "ep", "tp"),
            "fc_out": ns(None, "ep", "tp", None),
            "fc_out_b": ns(None, "ep", None),
        })
    else:
        shard["blocks"].update({
            "fc_in": ns(None, None, "tp"),
            "fc_in_b": ns(None, "tp"),
            "fc_out": ns(None, "tp", None),
            "fc_out_b": rep,
        })
    if cfg.mlp == "swiglu":
        shard["blocks"]["fc_gate"] = ns(None, None, "tp")
        shard["blocks"]["fc_gate_b"] = ns(None, "tp")
    if not cfg.bias:
        shard["blocks"] = {k: v for k, v in shard["blocks"].items()
                           if not k.endswith("_b")}
    if cfg.pos_emb == "learned":
        shard["wpe"] = rep
    if not cfg.tied_head:
        shard["lm_head"] = ns(None, "tp")
    return shard


def fsdp_param_shardings(mesh, cfg: GPTConfig, *, axis: str = "dp",
                         min_size: int = 1 << 16) -> Dict:
    """ZeRO-3 layout (JAX's `fsdp_param_shardings`): the tp layout widened
    so that every large leaf is also split over the data-parallel `axis`.
    As the sharded step's layout it keeps params, gradients and Adam
    moments at 1/dp a rank; the step gathers each weight where it is used
    and reduce-scatters its gradient. Per leaf the largest dim not already
    split and divisible by the axis size takes `axis` (ties: the later
    dim); leaves under `min_size` elements stay as they were. Shapes come
    from `param_shapes` (the meta device)."""
    from ..parallel.mesh import NamedSharding

    base = param_shardings(mesh, cfg)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def widen(shape_leaf, s):
        shape = shape_leaf.shape
        spec = list(s.spec) + [None] * (len(shape) - len(s.spec))
        cands = [(shape[i], i) for i in range(len(spec))
                 if spec[i] is None and shape[i] % n == 0]
        if not cands or shape_leaf.numel() < min_size:
            return s
        spec[max(cands)[1]] = axis
        return NamedSharding(mesh, spec)

    return tree_map(widen, param_shapes(cfg), base)


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
    """LayerNorm or RMSNorm, dispatched on the param structure (rms params
    carry only a scale), with f32 statistics; result in x's dtype."""
    x32 = x.float()
    if "bias" not in p:
        ms = (x32 * x32).mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)
    return F.layer_norm(x32, x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def _rope_cos_sin(cfg: GPTConfig, positions):
    """cos/sin tables for rotary embedding: positions (...,) int ->
    (..., hd/2) f32 each (GPT-NeoX half-split convention)."""
    hd = cfg.d_model // cfg.n_head
    inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                           device=positions.device) / hd)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """Rotate the last axis of x (..., hd) by the (..., hd/2) tables
    (broadcasting over leading axes), in f32; result in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _badd(t, blk, name, cfg: GPTConfig):
    """t + blk[name] in the compute dtype; identity cast when the bias
    param is absent (cfg.bias=False)."""
    b = blk.get(name)
    return (t if b is None else t + b).to(cfg.dtype)


def _unpack_qkv(qkv, cfg: GPTConfig, KV: int | None = None):
    """Group-major packed (..., W) -> q (..., KV, G, hd), k/v (..., KV, hd).
    The packed layout is kv-group-major: KV groups of (G+2) hd-wide chunks,
    group g = [q_{gG} ... q_{gG+G-1} | k_g | v_g]; a tp shard of whole
    groups is such a tensor with its own KV (`KV`, default all)."""
    G = cfg.n_head // _kv_heads(cfg)
    KV = KV or _kv_heads(cfg)
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
    """(V, D) LM-head weight: a separate lm_head param when untied
    (cfg.tied_head=False, llama family), else the shared wte."""
    return params["lm_head"] if "lm_head" in params else params["wte"]


def _lm_head(x, params, cfg: GPTConfig):
    """Logits in f32, like JAX's `jnp.dot(..., preferred_element_type=f32)`:
    a compute-dtype GEMM with an f32 result (`_dot_f32`)."""
    return _dot_f32(x, _head_w(params, cfg).to(x.dtype).T)


def _mlp(x, blk, cfg: GPTConfig, dot=None, tag=False, mesh=None):
    """Dense MLP (JAX's `_mlp` / `_decode_mlp`): GELU, whose tanh
    approximation is `jax.nn.gelu`'s default, or SwiGLU, silu(g) * h with
    g in f32 (the product promotes to f32 before the cast, as in JAX).
    `dot` is the matmul: `_qdot` for serving, `_body_dot` in training;
    `tag`: tag ffn_pre and ffn_gate (`_tagged`). With experts, the mixture
    (`_moe_mlp`) without its aux loss. Under a `mesh` (`_Shards`) the
    weights are this rank's column (fc_in, fc_gate) and row (fc_out)
    shards: the input enters the tp region and the output leaves it
    (`tp_in`, `tp_out`) before fc_out's bias."""
    if cfg.n_experts:
        return _moe_mlp(x, blk, cfg)[0]
    dot = dot or _qdot
    if mesh is not None:
        x = mesh.tp_in(x)
    h = _tagged(_badd(dot(x, blk["fc_in"], cfg), blk, "fc_in_b", cfg),
                "ffn_pre", tag)
    if cfg.mlp == "swiglu":
        g = _tagged(_badd(dot(x, blk["fc_gate"], cfg), blk, "fc_gate_b",
                          cfg), "ffn_gate", tag)
        h = (F.silu(g.float()) * h).to(cfg.dtype)
    else:
        h = F.gelu(h, approximate="tanh")
    out = dot(h, blk["fc_out"], cfg)
    if mesh is not None:
        out = mesh.tp_out(out)
    return _badd(out, blk, "fc_out_b", cfg)


# --------------------------------------------------------------------------
# mixture-of-experts FFN (top-1 gate; JAX's `_moe_*`)


def _moe_mlp(x, blk, cfg: GPTConfig, mesh=None):
    """(out, aux) of the expert FFN on x (B, S, D). A single-token step (S
    == 1) always takes the dense, no-drop routing: capacity would count
    over the batch there and drop tokens mid-generation. Otherwise
    `moe_impl` picks (`_MOE_DISPATCH`; "ep" without an ep axis is
    "sparse"). Under a `mesh` (`_Shards`) "ep" on a mesh with an ep axis
    is the all-to-all dispatch (`_moe_mlp_ep`); the others run on the
    rank's routing tokens (`_Shards.moe_rows`) with every expert (an ep
    split gathered first, as GSPMD moves the weights to the tokens), the
    capacity counted over those tokens."""
    if x.shape[1] == 1:
        return _moe_mlp_dense(x, blk, cfg)
    if mesh is None:
        return _MOE_DISPATCH[cfg.moe_impl](x, blk, cfg)
    if cfg.moe_impl == "ep" and mesh.has_ep:
        return _moe_mlp_ep(x, blk, cfg, mesh)
    y, aux = _MOE_DISPATCH[cfg.moe_impl](
        mesh.moe_rows(x), mesh.all_experts(blk), cfg, mesh)
    return mesh.moe_back(y), aux


def _moe_gate(x, blk, cfg: GPTConfig):
    """Top-1 routing: the gate probabilities' max, argmax (the first index
    on ties, as `jnp.argmax`) and the (..., E) f32 probabilities."""
    probs = torch.softmax(_dot_f32(x, blk["gate"].to(cfg.dtype)), -1)
    return probs.amax(-1), probs.argmax(-1), probs


def _moe_stats(sel, probs, n_experts: int):
    """The routing statistics of the load-balancing loss: the share of
    tokens each expert takes (no gradient) and the mean probability."""
    f = F.one_hot(sel.reshape(-1), n_experts).float().mean(0)
    return f, probs.reshape(-1, n_experts).mean(0)


def _moe_aux_loss(sel, probs, n_experts: int, mesh=None):
    """Switch load-balancing loss: E * sum_e f_e P_e (uniform routing: 1).
    Under a mesh the statistics are averaged over the ranks' tokens
    first (`_Shards.moe_mean`), never the per-rank losses: the loss is
    not linear in them."""
    f, p = _moe_stats(sel, probs, n_experts)
    if mesh is not None:
        f, p = mesh.moe_mean(f), mesh.moe_mean(p)
    return n_experts * (f * p).sum()


class _BmmF32(torch.autograd.Function):
    """x (E or 1, N, K) @ w (E, K, M) -> (E, N, M) for bf16 operands with
    an f32 result: one `torch.bmm(..., out_dtype=float32)` over the
    experts, x broadcast over them when its first dim is 1. Its backward
    rounds the f32 cotangent to the operands' dtype and runs bf16 GEMMs
    (`_DotF32`'s rule); a broadcast x sums its experts' gradients in f32
    and rounds once."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x.expand(w.shape[0], -1, -1), w,
                         out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if x.shape[0] == w.shape[0]:
                dx = torch.bmm(g, w.mT)
            else:
                dx = torch.bmm(g, w.mT, out_dtype=torch.float32).sum(
                    0, keepdim=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x.expand(w.shape[0], -1, -1).mT, g)
        return dx, dw


def _expert_dot(x, w):
    """x (E or 1, N, K) @ w (E, K, M) -> (E, N, M) f32, an f32 result from
    operands in their dtype (JAX's `ecd,edf->ecf` einsum with
    `preferred_element_type=f32`): bf16 on the card by `_BmmF32`,
    otherwise exactly widened operands (`_dot_f32`'s rule)."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return _BmmF32.apply(x, w)
    return torch.matmul(x.float(), w.float())


def _experts(xe, blk, cfg: GPTConfig, mesh=None):
    """The expert FFNs on their rows xe (E or 1, N, D) in the compute
    dtype -> (E, N, D) in the compute dtype: fc_in (f32 result, bias in
    f32), GELU in the compute dtype, fc_out (f32 result, bias in f32).
    Under a mesh the experts are this rank's tp columns (fc_in) and rows
    (fc_out): the rows enter the tp region and the product leaves it
    before fc_out's bias (JAX's psum over tp)."""
    if mesh is not None:
        xe = mesh.tp_enter(xe)
    h = _expert_dot(xe, blk["fc_in"].to(cfg.dtype))
    if "fc_in_b" in blk:
        h = h + blk["fc_in_b"][:, None, :]
    h = F.gelu(h.to(cfg.dtype), approximate="tanh")
    o = _expert_dot(h, blk["fc_out"].to(cfg.dtype))
    if mesh is not None:
        o = mesh.tp_leave(o)
    if "fc_out_b" in blk:
        o = o + blk["fc_out_b"][:, None, :]
    return o.to(cfg.dtype)


def _moe_mlp_dense(x, blk, cfg: GPTConfig, mesh=None):
    """Dense dispatch: every expert runs every token and the top-1 gate
    weights the combine (E x the FFN FLOPs, no token dropped)."""
    B, S, D = x.shape
    E = cfg.n_experts
    top, sel, probs = _moe_gate(x, blk, cfg)
    aux = _moe_aux_loss(sel, probs, E, mesh)
    combine = (F.one_hot(sel, E).float() * top[..., None]).to(cfg.dtype)
    o = _experts(x.reshape(1, B * S, D), blk, cfg, mesh)      # (E, N, D)
    y = torch.einsum("end,ne->nd", o.float(),
                     combine.reshape(B * S, E).float())
    return y.to(cfg.dtype).reshape(B, S, D), aux


def _capacity(cfg: GPTConfig, N: int) -> int:
    return max(int(math.ceil(cfg.moe_capacity * N / cfg.n_experts)), 1)


def _moe_mlp_sparse(x, blk, cfg: GPTConfig, mesh=None):
    """Switch-style capacity dispatch by one-hot products: token n goes to
    slot (e, c) of its top expert e, c its rank among e's tokens in
    position order; tokens past the capacity C are dropped (their output
    is 0, so they pass through the residual)."""
    B, S, D = x.shape
    E, N = cfg.n_experts, B * S
    C = _capacity(cfg, N)
    xf = x.reshape(N, D)
    top, sel, probs = _moe_gate(xf, blk, cfg)
    aux = _moe_aux_loss(sel, probs, E, mesh)
    onehot = F.one_hot(sel, E).float()                        # (N, E)
    pos = torch.cumsum(onehot, 0) * onehot - 1.0
    keep = (pos < C) & (onehot > 0)
    pos = torch.where(keep, pos, 0.0).long()
    slot = F.one_hot(pos, C).float() * keep[..., None]        # (N, E, C)
    dt = cfg.dtype
    expert_in = torch.einsum("nec,nd->ecd", slot.to(dt).float(),
                             xf.to(dt).float()).to(dt)        # (E, C, D)
    o = _experts(expert_in, blk, cfg, mesh)
    combine = slot * top[:, None, None]
    y = torch.einsum("nec,ecd->nd", combine.to(dt).float(), o.float())
    return y.to(dt).reshape(B, S, D), aux


def _sort_dispatch(xf, sel, E: int, C: int, dt):
    """The capacity buffer (E, C, D) of the sparse routing, made by a
    stable argsort on the expert id and a row scatter, and how to take
    its rows back: (buffer, (order, dst, keep)). Row gathers go through
    index_select, whose backward is an index_add (advanced indexing's
    sorts the indices first)."""
    N, D = xf.shape
    order = torch.argsort(sel, stable=True)
    sel_sorted = sel[order]
    counts = torch.bincount(sel, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=xf.device) - starts[sel_sorted]
    keep = rank < C
    dst = torch.where(keep, sel_sorted * C + rank, E * C)    # E*C: trash
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=xf.device)
    expert_in = buf.index_copy(0, dst, xf.index_select(0, order).to(dt))
    return expert_in[:-1].reshape(E, C, D), (order, dst, keep)


def _sort_combine(o, route, top, dt):
    """The expert outputs o (E, C, D) back in token order, scaled by the
    top gate probability; a dropped token's row is 0."""
    order, dst, keep = route
    E, C, D = o.shape
    o = o.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           o.index_select(0, dst.clamp(max=E * C - 1)),
                           torch.zeros((), dtype=dt, device=o.device))
    y = torch.zeros((order.shape[0], D), dtype=dt,
                    device=o.device).index_copy(0, order, gathered)
    return y * top[:, None].to(dt)


def _moe_mlp_sort(x, blk, cfg: GPTConfig, mesh=None):
    """The sparse routing by a stable argsort and row scatter/gather: the
    same kept tokens (a stable sort keeps position order within an
    expert) without the (N, E, C) one-hot products."""
    B, S, D = x.shape
    E, N = cfg.n_experts, B * S
    dt = cfg.dtype
    xf = x.reshape(N, D)
    top, sel, probs = _moe_gate(xf, blk, cfg)
    aux = _moe_aux_loss(sel, probs, E, mesh)
    expert_in, route = _sort_dispatch(xf, sel, E, _capacity(cfg, N), dt)
    o = _experts(expert_in, blk, cfg, mesh)
    return _sort_combine(o, route, top, dt).reshape(B, S, D), aux


_MOE_DISPATCH = {"dense": _moe_mlp_dense, "sparse": _moe_mlp_sparse,
                 "sort": _moe_mlp_sort, "ep": _moe_mlp_sparse}


def ep_dispatch(xfs, blks, cfg: GPTConfig, a2a, mean, mesh=None):
    """The GShard/Switch expert-parallel MoE (JAX's `_moe_mlp_ep`'s
    `local_fn`) for the ep ranks in a list: rank j's tokens xfs[j] (N_j,
    D), its params blks[j] (the gate, and its E/ep experts in fc_in,
    fc_out and their biases). Each rank routes its tokens into an (E, C,
    D) buffer, C = ceil(moe_capacity N_j / E), by `_sort_dispatch` (the
    sparse routing's kept tokens); `a2a(list, split_dim, concat_dim)`
    regroups the ranks' buffers to (E/ep, ep C, D), each rank's own
    experts' tokens; the experts run (`_experts`, tp-split under `mesh`);
    a second all-to-all brings the rows home for the combine. `mean`
    averages a list of the ranks' routing statistics over every ep rank
    (and, on a mesh, every routing shard): the aux loss comes from those
    means. Returns ([y_j (N_j, D)], [aux_j])."""
    E, dt = cfg.n_experts, cfg.dtype
    routes, bufs, fs, ps = [], [], [], []
    for xf, blk in zip(xfs, blks):
        top, sel, probs = _moe_gate(xf, blk, cfg)
        f, p = _moe_stats(sel, probs, E)
        fs.append(f)
        ps.append(p)
        buf, route = _sort_dispatch(xf, sel, E, _capacity(cfg, xf.shape[0]),
                                    dt)
        bufs.append(buf)
        routes.append((route, top))
    auxes = [E * (f * p).sum() for f, p in zip(mean(fs), mean(ps))]
    outs = [_experts(b, blk, cfg, mesh)
            for b, blk in zip(a2a(bufs, 0, 1), blks)]
    ys = [_sort_combine(o, route, top, dt)
          for o, (route, top) in zip(a2a(outs, 1, 0), routes)]
    return ys, auxes


def virtual_all_to_all(items, split_dim: int, concat_dim: int) -> list:
    """`collectives.all_to_all` over the ranks of a list held in one
    process: rank j gets block j of every rank's `split_dim`, in rank
    order along `concat_dim`."""
    n = len(items)
    blocks = [t.chunk(n, split_dim) for t in items]
    return [torch.cat([blocks[i][j] for i in range(n)], concat_dim)
            for j in range(n)]


def _moe_mlp_ep(x, blk, cfg: GPTConfig, mesh):
    """Expert-parallel Switch MoE on a mesh with an ep axis (JAX's
    `_moe_mlp_ep`): the rank's routing tokens (`_Shards.moe_rows`: its dp
    and cp rows, its ep slice of the sequence) through `ep_dispatch` with
    the ep group's all-to-all (`collectives.all_to_all`); the experts'
    weights never move. Capacity is counted over the rank's tokens, so
    with overflow the dispatch may drop tokens the one-device dispatches
    keep; with none it gives their outputs."""
    from ..parallel.collectives import all_to_all

    E = cfg.n_experts
    if E % mesh.ep:
        raise ValueError(f"moe_impl='ep' needs n_experts ({E}) % ep "
                         f"({mesh.ep}) == 0")
    xs = mesh.moe_rows(x)
    B, S, D = xs.shape
    (y,), (aux,) = ep_dispatch(
        [xs.reshape(B * S, D)], [blk], cfg,
        lambda ts, s, c: [all_to_all(ts[0], s, c, mesh.ep_group)],
        lambda ts: [mesh.moe_mean(ts[0])], mesh)
    return mesh.moe_back(y.reshape(B, S, D)), aux


def _cast_decode_params(params, cfg: GPTConfig):
    """Cast the big weight matrices to the compute dtype ONCE for serving
    (decode is weight-bandwidth-bound); LayerNorm params and biases stay
    f32."""
    p = dict(params)
    for name in ("wte", "wpe", "lm_head"):
        if name in params:
            p[name] = params[name].to(cfg.dtype)
    b = dict(params["blocks"])
    for name in ("qkv", "proj", "fc_in", "fc_out", "fc_gate", "gate"):
        if name in b:
            b[name] = b[name].to(cfg.dtype)
    p["blocks"] = b
    return p


# --------------------------------------------------------------------------
# quantized serving weights and the int8 KV cache


# JAX's serving programs divide by the constants 127 and 7 under jit,
# where XLA rewrites a division by a constant into a product with its f32
# reciprocal; the port multiplies by that reciprocal, so its scales are
# the compiled programs' bit for bit (`_quant_w4` keeps the division for
# QLoRA, whose JAX quantizer runs eagerly)
_INV127 = 1.0 / 127.0
_INV7 = 1.0 / 7.0


def _quant_kv(t):
    """Per-(token, head) symmetric int8 over the hd axis: (..., hd) ->
    int8 values and an f32 scale (..., 1), round half to even (JAX's
    `_quant_kv`)."""
    t32 = t.float()
    s = t32.abs().amax(-1, keepdim=True).clamp(min=1e-8) * _INV127
    return torch.round(t32 / s).clamp(-127, 127).to(torch.int8), s


def _quant_w(w, axis: int):
    """Symmetric per-out-channel int8: {"q8": int8, "s": f32}; `axis` is
    the contraction (input) axis reduced for the scales (JAX's
    `_quant_w`). Each (K, N) matrix of "q8" is stored column-major (its
    transpose contiguous), the layout `torch._int_mm` reads faster on the
    card (`chip_smoke.py` phase 18 times both)."""
    w32 = w.float()
    s = w32.abs().amax(axis, keepdim=True).clamp(min=1e-8) * _INV127
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return {"q8": q.mT.contiguous().mT, "s": s}


def _quant_w4(w, group: int = 128, compiled: bool = False):
    """Group-wise symmetric int4 over the contraction axis (the second to
    last): values in [-7, 7], one f32 scale per `group` rows of that axis
    (all of it when `group` does not divide it), round half to even, two
    consecutive rows packed into one int8 byte, the even row in the low
    nibble; JAX's `_quant_w4`, bit for bit: as it runs eagerly, or with
    `compiled` as it runs inside a jitted program (the scale a product
    with 1/7). Returns {"q4p": int8 (..., K/g, g/2, N), "s4": f32 (...,
    K/g, 1, N)}."""
    K, N = w.shape[-2], w.shape[-1]
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {K}")
    g = group if K % group == 0 else K
    w32 = w.float().reshape(w.shape[:-2] + (K // g, g, N))
    amax = w32.abs().amax(-2, keepdim=True).clamp(min=1e-8)
    s = amax * _INV7 if compiled else amax / 7.0
    q = torch.round(w32 / s).clamp(-7, 7).to(torch.int8)
    lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    return {"q4p": (lo & 0x0F) | (hi << 4), "s4": s}


def dequant_w4(w: dict, dtype) -> torch.Tensor:
    """Inverse of `_quant_w4`: the nibbles unpacked by two arithmetic
    shifts, scaled per group in f32, emitted in `dtype` at the original
    (..., K, N) shape (JAX's `dequant_w4`)."""
    p, s = w["q4p"], w["s4"]
    lo = (p << 4) >> 4                          # sign-extend the low nibble
    hi = p >> 4
    q = torch.stack([lo, hi], dim=-2).reshape(
        p.shape[:-2] + (p.shape[-2] * 2, p.shape[-1]))
    wd = (q.float() * s).to(dtype)
    return wd.reshape(wd.shape[:-3] + (-1, wd.shape[-1]))


def _quant_decode_params(params, cfg: GPTConfig, bits: int = 8):
    """Serving weights (JAX's `_quant_decode_params`). `bits=8`: W8A8,
    per-out-channel int8 body weights and a per-token activation scale
    (`_qdot`); `bits=4`: W4A16, group-wise int4 body weights dequantized
    to the compute dtype on read. Both: the embedding stays in the compute
    dtype, the LM head becomes its own int8 (D, V) matrix "head" (the
    untied `lm_head` is folded into it), norms and biases stay f32, MoE
    expert tensors are cast only."""
    p = dict(params)
    p["wte"] = params["wte"].to(cfg.dtype)
    if "wpe" in params:
        p["wpe"] = params["wpe"].to(cfg.dtype)
    p["head"] = _quant_w(_head_w(params, cfg).T, 0)       # (D, V), s (1, V)
    p.pop("lm_head", None)
    b = dict(params["blocks"])
    for name in ("qkv", "proj", "fc_in", "fc_out", "fc_gate"):
        if name in b and torch.is_tensor(b[name]) and b[name].dim() == 3:
            b[name] = (_quant_w(b[name], 1) if bits == 8
                       else _quant_w4(b[name], compiled=True))
    if "gate" in b:
        b["gate"] = b["gate"].to(cfg.dtype)
    for name in ("fc_in", "fc_out"):          # MoE experts: cast only
        if name in b and torch.is_tensor(b[name]):
            b[name] = b[name].to(cfg.dtype)
    p["blocks"] = b
    return p


QUANT_MODES = (None, "none", "int8", "int8-kv", "int4")


def _check_mode(quant) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")


def _prep_decode_params(params, cfg: GPTConfig, quant):
    """Params for a decode program: prepared trees (the quantized "head"
    marks them) pass through, else quantize for `quant` or cast."""
    if "head" in params:
        return params
    if quant in ("int8", "int8-kv"):
        return _quant_decode_params(params, cfg, bits=8)
    if quant == "int4":
        return _quant_decode_params(params, cfg, bits=4)
    _check_mode(quant)
    return _cast_decode_params(params, cfg)


@torch.no_grad()
def prepare_decode_params(params, cfg: GPTConfig, quant: str | None = None):
    """Quantize or cast training params for serving ONCE, on their device.
    Every serving program accepts the result (pass the same `quant` to
    both); casting prepared params again is free."""
    return _prep_decode_params(params, cfg, quant)


def _int8_mm(xq, q8):
    """xq (M, K) int8 @ q8 (K, N) int8 -> (M, N) int32, exact:
    `torch._int_mm`. Its CUDA shape rules (more than 16 rows, K and N
    multiples of 8) are met by zero padding, which adds nothing to the
    sums; decode has as few as one row."""
    if xq.device.type != "cuda":
        return torch._int_mm(xq, q8)
    M, K = xq.shape
    N = q8.shape[1]
    Mp, Kp, Np = max(32, -(-M // 8) * 8), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        q8 = F.pad(q8, (0, Np - N, 0, Kp - K))
    return torch._int_mm(xq, q8)[:M, :N]


def _qdot(x, w, cfg: GPTConfig, tp=None):
    """Decode matmul (JAX's `_qdot`): a plain compute-dtype dot; W8A8 when
    `w` came from `_quant_w` (x quantized per token, an int8 product summed
    exactly in int32, then rescaled in f32: an f32 result); W4A16 when `w`
    came from `_quant_w4` (dequantized to the compute dtype, then a plain
    dot). The plain and W4A16 products come back in the compute dtype.
    With `tp` (`_ServeTP`; x this rank's part of each row, `w` its rows of
    a row-parallel leaf) W8A8 scales a token by the amax of its whole row,
    the max over the tp ranks, as JAX's program does."""
    if isinstance(w, dict) and "q4p" in w:
        return torch.matmul(x.to(cfg.dtype), dequant_w4(w, cfg.dtype))
    if isinstance(w, dict):
        x32 = x.float()
        xs = x32.abs().amax(-1, keepdim=True)
        if tp is not None:
            xs = tp.amax(xs)
        xs = xs.clamp(min=1e-8) * _INV127
        xq = torch.round(x32 / xs).clamp(-127, 127).to(torch.int8)
        y = _int8_mm(xq.reshape(-1, x.shape[-1]), w["q8"])
        y = y.reshape(x.shape[:-1] + (y.shape[-1],))
        return y.float() * xs * w["s"].reshape(-1)
    return torch.matmul(x, w.to(cfg.dtype))


def _logits(x, params, cfg: GPTConfig):
    """f32 logits of a decode program: the quantized head when the params
    carry one, else `_lm_head`."""
    head = params.get("head")
    return _lm_head(x, params, cfg) if head is None else _qdot(x, head, cfg)


# --------------------------------------------------------------------------
# tensor-parallel serving: a rank runs its kv heads (JAX's GSPMD serving
# over a "tp" mesh axis, with the collectives written out)


class _ServeTP:
    """One rank's tensor-parallel serving context, the one the serving
    bodies take (prepared params sliced for the rank carry it under "tp",
    `_tp_params`): the mesh's "tp" group, its size and this rank's
    coordinate.

    A rank holds KV/tp kv heads, H/tp query heads of the same hd: its
    columns of the kv-group-major qkv are whole kv groups, fc_in and
    fc_gate its columns, proj and fc_out its input rows (`splits`:
    `param_shardings`' Megatron layout). The products of proj and fc_out
    are partial sums, all-reduced in f32 before their biases (`tp_out`; in
    `_mlp` too, through `tp_in` and `tp_out`, `_Shards`' names). W8A8
    scales a token by the amax of its whole row (`amax`), and the ranks
    take tp rank 0's sampled tokens (`tokens`), so that no tie broken
    otherwise desynchronises their schedules. wte, wpe and the head stay
    whole on every rank: each samples from the whole logits."""

    def __init__(self, mesh, cfg: GPTConfig):
        from ..parallel.mesh import mesh_axis

        self.group, self.size, self.rank = mesh_axis(mesh, "tp")
        self.kv = _kv_heads(cfg) // self.size
        specs = param_shardings(mesh, cfg)["blocks"]
        moe = _MOE_LEAVES if cfg.n_experts else ()
        self.splits = {k: sh.dim_of("tp") for k, sh in specs.items()
                       if k not in moe and not isinstance(sh, dict)
                       and sh.dim_of("tp") is not None}

    def tp_in(self, x):
        return x

    def tp_out(self, y):
        """The ranks' partial sums y summed over tp, in f32."""
        from ..parallel.collectives import all_reduce

        if self.size == 1:
            return y
        return all_reduce(y.float().contiguous(), [self.group])

    def amax(self, s):
        from ..parallel.collectives import all_reduce

        return all_reduce(s.contiguous(), [self.group], op="max")

    def tokens(self, t):
        from ..parallel.collectives import broadcast

        return broadcast(t.contiguous(), self.group)


def _local_kv(cfg: GPTConfig, tp) -> int:
    """The kv heads a serving body runs: all, or a tp rank's."""
    return _kv_heads(cfg) if tp is None else tp.kv


def _tp_tokens(tp, t):
    """Sampled tokens `t`, tp rank 0's on every rank under `tp`."""
    return t if tp is None else tp.tokens(t)


def _check_serving_mesh(mesh, cfg: GPTConfig, dp: bool = False) -> None:
    """JAX's refusals of a serving mesh, with its messages (a mesh with dp
    and tp for `make_generate`, a tp axis for the batchers), and the
    splits this port cannot make (JAX's GSPMD pads an uneven split)."""
    names = mesh.mesh_dim_names
    if dp and not {"dp", "tp"} <= set(names):
        raise ValueError(
            "sharded serving needs a mesh with 'dp' and 'tp' axes "
            "(either may have size 1)")
    if "tp" not in names:
        raise ValueError("sharded serving needs a 'tp' mesh axis")
    tp = mesh.size(names.index("tp"))
    if _kv_heads(cfg) % tp:
        raise ValueError("tensor-parallel serving needs kv_heads % tp == 0")
    if not cfg.n_experts and cfg.d_ff % tp:
        raise ValueError(f"tp {tp} does not divide d_ff {cfg.d_ff}")


def _tp_chunk(t, dim: int, tp: _ServeTP):
    return t.tensor_split(tp.size, dim)[tp.rank]


def _tp_w4_rows(w: dict, tp: _ServeTP) -> dict:
    """A rank's rows of an int4 leaf ({"q4p": (..., K/g, g/2, N), "s4":
    (..., K/g, 1, N)}): the packed row pairs of rows r0..r0+K/tp regrouped
    into groups of g (or of K/tp where tp splits one group: each keeps its
    whole group's scale), so `dequant_w4` gives the whole leaf's rows."""
    q, s4 = w["q4p"], w["s4"]
    ng, half, N = q.shape[-3:]
    g, K = 2 * half, ng * 2 * half
    k = K // tp.size
    gl = g if k % g == 0 else k
    if k % 2 or g % gl:
        raise ValueError(f"tp {tp.size} cuts int4 groups of {g} rows "
                         f"unevenly ({K} rows)")
    r0 = tp.rank * k
    lead = q.shape[:-3]
    pairs = q.reshape(lead + (ng * half, N))[..., r0 // 2:(r0 + k) // 2, :]
    groups = torch.arange(r0, r0 + k, gl, device=q.device) // g
    return {"q4p": pairs.reshape(lead + (k // gl, gl // 2, N)).contiguous(),
            "s4": s4[..., groups, :, :].contiguous()}


def _tp_leaf(leaf, dim: int, tp: _ServeTP):
    """A rank's slice of a prepared block leaf split over tp on `dim` (2:
    output columns, 1: input rows, of the stacked (L, in, out) matrix; 1
    of a stacked (L, out) bias). The int8 values keep their column-major
    layout; a row split keeps the whole per-column scales."""
    if not isinstance(leaf, dict):
        return _tp_chunk(leaf, dim, tp).contiguous()
    if "q8" in leaf:
        q8 = _tp_chunk(leaf["q8"], dim, tp).mT.contiguous().mT
        s = leaf["s"] if dim == 1 else _tp_chunk(leaf["s"], 2, tp)
        return {"q8": q8, "s": s.contiguous()}
    if dim == 1:
        return _tp_w4_rows(leaf, tp)
    return {n: _tp_chunk(t, -1, tp).contiguous() for n, t in leaf.items()}


def _tp_params(params, cfg: GPTConfig, tp: _ServeTP):
    """A tp rank's slice of PREPARED params (`prepare_decode_params`: the
    whole tree quantized or cast first, so that the scales are the whole
    weight's, bit for bit JAX's), carrying the context under "tp". The
    embedding, positions, head, norms, the row-parallel biases and MoE
    experts stay whole. A tree that already carries a context passes."""
    if "tp" in params:
        return params
    blocks = {k: (_tp_leaf(v, tp.splits[k], tp) if k in tp.splits else v)
              for k, v in params["blocks"].items()}
    return dict(params, blocks=blocks, tp=tp)


def _tp_adapter(name: str, A, B, tp):
    """A target's stacked adapter factors (A (..., d_in, r), B (..., r,
    d_out)) as a tp rank uses them: B split by columns on a
    column-parallel leaf, A by rows on a row-parallel one (its correction
    then joins the partial sum before the reduce)."""
    dim = None if tp is None else tp.splits.get(name)
    if dim == 2:
        return A, _tp_chunk(B, -1, tp).contiguous()
    if dim == 1:
        return _tp_chunk(A, -2, tp).contiguous(), B
    return A, B


# --------------------------------------------------------------------------
# per-request LoRA adapters (S-LoRA): a stacked tree indexed per row


def _lora_delta(h, ab, name, sel, cfg: GPTConfig):
    """Low-rank correction (h @ A[sel]) @ B[sel] for rows that each name an
    adapter (JAX's `_lora_delta`): `ab` holds ONE layer's stacked adapters
    {name: {"A": (NA, d_in, r), "B": (NA, r, d_out)}} with alpha/r folded
    into B, `sel` (B,) int64 each row's adapter (0: the zero adapter, the
    base model). None when `name` carries no adapter."""
    if ab is None or name not in ab:
        return None
    A = ab[name]["A"][sel].to(cfg.dtype)             # (B, d_in, r)
    Bm = ab[name]["B"][sel].to(cfg.dtype)            # (B, r, d_out)
    return torch.bmm(torch.bmm(h.to(cfg.dtype), A), Bm)


def _ldot(h, blk, name, cfg: GPTConfig, ab=None, sel=None, tp=None):
    """`_qdot` plus the per-row LoRA correction, if any. With `tp` (a
    row-parallel leaf, proj or fc_out, on a tp rank) the product and the
    correction are this rank's partial sums, all-reduced over tp together
    (`_ServeTP.tp_out`: f32)."""
    y = _qdot(h, blk[name], cfg, tp)
    d = _lora_delta(h, ab, name, sel, cfg)
    y = y if d is None else y + d
    return y if tp is None else tp.tp_out(y)


def _layer_ab(adapters, i: int):
    """Layer i's slice of a stacked adapter tree (None stays None)."""
    return None if adapters is None else _layer(adapters, i)


def _decode_qkv(x, blk, cfg: GPTConfig, pos, ab=None, sel=None, tp=None):
    """q (B,KV,G,1,hd), new-token k/v (B,KV,1,hd) for one layer (KV this
    rank's kv heads under `tp`). Under rope, q and k are rotated by their
    positions `pos` (B,) or a 0-d tensor, so keys enter the cache after
    rotation and cached reads need none."""
    h = _layer_norm(x, blk["ln1"], cfg.norm_eps)
    qkv = _badd(_ldot(h, blk, "qkv", cfg, ab, sel), blk, "qkv_b", cfg)
    # grouped-query attention without repeating K/V: the group axis is
    # folded into the query side (G = H/KV queries share a KV head)
    # q (B,1,KV,G,hd), k/v (B,1,KV,hd)
    q, k, v = _unpack_qkv(qkv, cfg, _local_kv(cfg, tp))
    if cfg.pos_emb == "rope":
        cos, sin = _rope_cos_sin(cfg, pos.reshape(-1))  # (B or 1, hd/2)
        q = _apply_rope(q, cos[:, None, None, None], sin[:, None, None, None])
        k = _apply_rope(k, cos[:, None, None], sin[:, None, None])
    return (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3))


def _decode_block(x, blk, q, lk, lv, pos, cfg: GPTConfig, ab=None,
                  sel=None, tp=None):
    """Attention + MLP for a single new token x (B, 1, D) over a gathered
    cache `lk`/`lv` (B, KV, S, hd) that ALREADY holds the new token at
    `pos` ((B,) or 0-d); under `tp` the rank's kv heads. Scores and PV in
    f32; the softmax is cast to the compute dtype before PV, as in JAX."""
    B = x.shape[0]
    hd = cfg.d_model // cfg.n_head
    att = torch.einsum("bkgqd,bksd->bkgqs", q.float(), lk.float())
    att = att / math.sqrt(hd)
    idx = torch.arange(att.shape[-1], device=att.device)
    pos_b = pos.long().reshape(-1, 1, 1, 1, 1)
    keep = idx <= pos_b
    if cfg.window:
        keep &= pos_b - idx < cfg.window
    att = torch.softmax(att.masked_fill(~keep, -1e30), -1).to(cfg.dtype)
    ctx = torch.einsum("bkgqs,bksd->bkgqd", att.float(), lv.float())
    ctx = ctx.to(cfg.dtype).permute(0, 3, 1, 2, 4).reshape(B, 1, -1)
    return _decode_post(x, blk, ctx, cfg, ab, sel, tp)


def _decode_post(x, blk, ctx, cfg: GPTConfig, ab=None, sel=None, tp=None):
    """Post-attention half of a decode block: output projection,
    residual, MLP. `ctx` is the merged-heads attention output (B, 1, D),
    under `tp` the rank's heads (B, 1, D/tp), whose projection is summed
    over tp before its bias."""
    ctx = _ldot(ctx, blk, "proj", cfg, ab, sel, tp)
    x = x + _badd(ctx, blk, "proj_b", cfg)
    return x + _decode_mlp(_layer_norm(x, blk["ln2"], cfg.norm_eps), blk,
                           cfg, ab, sel, tp)


def _decode_mlp(x, blk, cfg: GPTConfig, ab=None, sel=None, tp=None):
    """The serving MLP (JAX's `_decode_mlp`): through `_ldot` when the
    weights are quantized or an adapter targets the MLP, else `_mlp`.
    Under `tp` fc_in and fc_gate hold the rank's columns and fc_out its
    rows, whose product is summed over tp before fc_out's bias; experts
    are held whole on every rank."""
    mlp_lora = ab is not None and any(
        k in ab for k in ("fc_in", "fc_out", "fc_gate"))
    if not (isinstance(blk["fc_in"], dict) or mlp_lora):
        return _mlp(x, blk, cfg, mesh=tp)
    h = _badd(_ldot(x, blk, "fc_in", cfg, ab, sel), blk, "fc_in_b", cfg)
    if cfg.mlp == "swiglu":
        g = _badd(_ldot(x, blk, "fc_gate", cfg, ab, sel), blk, "fc_gate_b",
                  cfg)
        h = (F.silu(g.float()) * h).to(cfg.dtype)
    else:
        h = F.gelu(h, approximate="tanh")
    return _badd(_ldot(h, blk, "fc_out", cfg, ab, sel, tp), blk, "fc_out_b",
                 cfg)


def _kv_names(cache):
    """The cache's K/V tensors: ("k", "v"), with the int8 cache's scales."""
    return ("k", "v", "ks", "vs") if "ks" in cache else ("k", "v")


def _kv_layer(cache, i: int, cfg: GPTConfig):
    """Layer i's K/V (B, KV, S, hd) in the compute dtype; the int8 cache
    is dequantized on read (int8 times scale in the compute dtype)."""
    if "ks" not in cache:
        return cache["k"][i], cache["v"][i]
    return tuple(cache[n][i].to(cfg.dtype) * cache[s][i].to(cfg.dtype)
                 for n, s in (("k", "ks"), ("v", "vs")))


def _kv_entries(k, v, quant_kv: bool):
    """(name, tensor) pairs to store for new K/V: as they are, or int8
    values and scales."""
    if not quant_kv:
        return (("k", k), ("v", v))
    (k8, ks), (v8, vs) = _quant_kv(k), _quant_kv(v)
    return (("k", k8), ("v", v8), ("ks", ks), ("vs", vs))


def _prefill_body(params, cache, prompt, cfg: GPTConfig, ab=None, sel=None,
                  last=None):
    """Batched prefill: ONE pass over the whole prompt (B, P) writes each
    layer's K/V into `cache` (L, B, KV, S>=P, hd; int8 with scales for the
    int8 cache) in place at positions 0..P-1 and returns the f32 logits
    (B, V) of position `last` (an int, a (B,) tensor, or None: P-1) and
    the cache. Bucketed prefill pads the prompt and asks for its true last
    position; the padded tail's K/V are dead (the causal mask keeps real
    positions blind to them and decode overwrites them first). `ab`
    (stacked adapters, leading layer axis) and `sel` (B,) apply per-row
    LoRA corrections. Attention here is plain torch, as it is an einsum
    outside any kernel in JAX. Params sliced for a tp rank (`_tp_params`)
    carry their context: the pass then runs the rank's heads."""
    B, P = prompt.shape
    hd = cfg.d_model // cfg.n_head
    dev = prompt.device
    quant_kv = "ks" in cache
    tp = params.get("tp")
    KV = _local_kv(cfg, tp)
    x = params["wte"][prompt.long()]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][:P]
    x = x.to(cfg.dtype)
    if cfg.pos_emb == "rope":
        r_cos, r_sin = _rope_cos_sin(cfg, torch.arange(P, device=dev))
    iq = torch.arange(P, device=dev)[:, None]
    ik = torch.arange(P, device=dev)[None, :]
    keep = ik <= iq
    if cfg.window:
        keep &= iq - ik < cfg.window
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        ab_l = _layer_ab(ab, i)
        h = _layer_norm(x, blk["ln1"], cfg.norm_eps)
        qkv = _badd(_ldot(h, blk, "qkv", cfg, ab_l, sel), blk, "qkv_b", cfg)
        q, k, v = _unpack_qkv(qkv, cfg, KV)
        if cfg.pos_emb == "rope":      # q/k (B,P,KV,{G,}hd): rotate by P
            q = _apply_rope(q, r_cos[:, None, None], r_sin[:, None, None])
            k = _apply_rope(k, r_cos[:, None], r_sin[:, None])
        q = q.permute(0, 2, 3, 1, 4)                     # (B,KV,G,P,hd)
        k = k.permute(0, 2, 1, 3)                        # (B,KV,P,hd)
        v = v.permute(0, 2, 1, 3)
        att = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float())
        att = att / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~keep, -1e30), -1).to(cfg.dtype)
        ctx = torch.einsum("bkgqs,bksd->bkgqd", att.float(), v.float())
        ctx = ctx.to(cfg.dtype).permute(0, 3, 1, 2, 4).reshape(B, P, -1)
        x = x + _badd(_ldot(ctx, blk, "proj", cfg, ab_l, sel, tp), blk,
                      "proj_b", cfg)
        x = x + _decode_mlp(_layer_norm(x, blk["ln2"], cfg.norm_eps), blk,
                            cfg, ab_l, sel, tp)
        for name, t in _kv_entries(k, v, quant_kv):
            cache[name][i, :, :, :P] = t
    if last is None:
        x_last = x[:, -1]
    elif isinstance(last, int):
        x_last = x[:, last]
    else:
        rows = torch.arange(B, device=dev)
        x_last = x[rows, last.long().to(dev).expand(B)]
    x = _layer_norm(x_last, params["ln_f"], cfg.norm_eps)
    cache["pos"] = cache["pos"] + P
    return _logits(x, params, cfg), cache


def _verify_body(params, cache, tokens, cfg: GPTConfig, ab=None, sel=None):
    """Chunked decode (JAX's `_verify_body`): `tokens` (B, C) go through
    the model in ONE pass starting at cache position `pos` (an int or a 0-d
    tensor): their K/V are written at pos..pos+C-1 in place, and the query
    at pos+i attends cache keys <= pos+i. Speculative verification, suffix
    prefill after a cached prefix and chunked prefill all run it. Returns
    (logits (B, C, V) f32, cache with pos advanced by C)."""
    B, C = tokens.shape
    hd = cfg.d_model // cfg.n_head
    dev = tokens.device
    pos = cache["pos"]
    quant_kv = "ks" in cache
    tp = params.get("tp")
    KV = _local_kv(cfg, tp)
    at = torch.arange(C, device=dev)
    at = at + (pos if isinstance(pos, int) else pos.long())
    x = params["wte"][tokens.long()]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"].index_select(0, at)[None]
    x = x.to(cfg.dtype)
    if cfg.pos_emb == "rope":
        r_cos, r_sin = _rope_cos_sin(cfg, at)                # (C, hd/2)
    S = cache["k"].shape[3]
    keep = torch.arange(S, device=dev)[None, :] <= at[:, None]   # (C, S)
    if cfg.window:
        keep &= at[:, None] - torch.arange(S, device=dev)[None, :] \
            < cfg.window
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        ab_l = _layer_ab(ab, i)
        h = _layer_norm(x, blk["ln1"], cfg.norm_eps)
        qkv = _badd(_ldot(h, blk, "qkv", cfg, ab_l, sel), blk, "qkv_b", cfg)
        q, k, v = _unpack_qkv(qkv, cfg, KV)
        if cfg.pos_emb == "rope":
            q = _apply_rope(q, r_cos[:, None, None], r_sin[:, None, None])
            k = _apply_rope(k, r_cos[:, None], r_sin[:, None])
        q = q.permute(0, 2, 3, 1, 4)                     # (B,KV,G,C,hd)
        k = k.permute(0, 2, 1, 3)                        # (B,KV,C,hd)
        v = v.permute(0, 2, 1, 3)
        for name, t in _kv_entries(k, v, quant_kv):
            cache[name][i].index_copy_(2, at, t)
        lk, lv = _kv_layer(cache, i, cfg)
        att = torch.einsum("bkgqd,bksd->bkgqs", q.float(), lk.float())
        att = att / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~keep, -1e30), -1).to(cfg.dtype)
        ctx = torch.einsum("bkgqs,bksd->bkgqd", att.float(), lv.float())
        ctx = ctx.to(cfg.dtype).permute(0, 3, 1, 2, 4).reshape(B, C, -1)
        x = x + _badd(_ldot(ctx, blk, "proj", cfg, ab_l, sel, tp), blk,
                      "proj_b", cfg)
        x = x + _decode_mlp(_layer_norm(x, blk["ln2"], cfg.norm_eps), blk,
                            cfg, ab_l, sel, tp)
    x = _layer_norm(x, params["ln_f"], cfg.norm_eps)
    cache["pos"] = pos + C
    return _logits(x, params, cfg), cache


# --------------------------------------------------------------------------
# dense KV-cache generation: a (L, B, KV, max_seq, hd) cache per batch


def init_kv_cache(cfg: GPTConfig, batch: int, quant: str | None = None,
                  device=None, tp=None):
    """Per-layer K/V buffers (L, B, KV, max_seq, hd) in the compute dtype
    and the position, a 0-d int32 tensor, on `device` (default
    `config.device`). With GQA the cache is n_head/n_kv_head times smaller.
    With `quant="int8-kv"` K/V are int8 with an f32 scale per (token, head)
    in "ks"/"vs" (..., 1); every other mode keeps the compute dtype. With
    `tp` (`_ServeTP`) KV is the rank's KV/tp heads."""
    _check_mode(quant)
    dev = resolve(config.device if device is None else device)
    hd = cfg.d_model // cfg.n_head
    shape = (cfg.n_layer, batch, _local_kv(cfg, tp), cfg.max_seq, hd)
    if quant == "int8-kv":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev),
                "vs": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _decode_step_body(params, cache, token, cfg: GPTConfig):
    """One decode step on PREPARED params: (params, cache, token (B,)) ->
    (logits (B, V) f32, cache). The new token's K/V are written in place at
    `cache["pos"]`, a device tensor, so a step never waits for the host
    (JAX's `dynamic_update_slice` at `pos`); attention runs over the whole
    cache with positions past `pos` (and outside the window) masked."""
    pos = cache["pos"]
    B = token.shape[0]
    at = pos.view(1).long()
    quant_kv = "ks" in cache
    x = params["wte"][token.long()][:, None, :]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"].index_select(0, at)
    x = x.to(cfg.dtype)
    pos_b = at.repeat(B)
    tp = params.get("tp")
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        q, k_new, v_new = _decode_qkv(x, blk, cfg, pos_b, tp=tp)
        for name, t in _kv_entries(k_new, v_new, quant_kv):
            cache[name][i].index_copy_(2, at, t)
        lk, lv = _kv_layer(cache, i, cfg)
        x = _decode_block(x, blk, q, lk, lv, pos_b, cfg, tp=tp)
    x = _layer_norm(x, params["ln_f"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _logits(x[:, 0], params, cfg), cache


def make_decode_step(cfg: GPTConfig, quant: str | None = None):
    """Single-token decode: (params, cache, token (B,)) -> (logits (B, V),
    cache). The cache is updated in place (JAX donates it). The params are
    quantized or cast for `quant` on each call, as JAX does in-program;
    `prepare_decode_params` once makes that free. `quant="int8"` is W8A8,
    `"int8-kv"` also an int8 cache (`init_kv_cache(..., quant="int8-kv")`),
    `"int4"` W4A16 with an int8 head."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def step(params, cache, token):
        return _decode_step_body(_prep_decode_params(params, cfg, quant),
                                 cache, token, cfg)

    return step


def make_prefill(cfg: GPTConfig, quant: str | None = None):
    """Batched prefill: (params, cache, prompt (B, P)) -> (last-position
    logits (B, V), cache filled through position P-1), in place. Pair with
    `make_decode_step` of the same quant mode."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def pre(params, cache, prompt):
        return _prefill_body(_prep_decode_params(params, cfg, quant), cache,
                             prompt, cfg)

    return pre


def sample_logits(logits, generator: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0, min_p: float = 0.0, rows=None):
    """One sampling step over (B, V) logits -> (B,) int32 tokens, all rows
    at once: greedy at temperature 0 (argmax, the first index on ties),
    else the temperature-scaled logits filtered in JAX's order (min-p, then
    top-k, then top-p; each keeps the top token) and sampled by Gumbel-max,
    as `jax.random.categorical`, with noise from `generator` (on the
    logits' device; None draws from torch's default generator). `rows`
    (start, n): the logits are rows start.. of a batch of n, and the noise
    drawn is the whole batch's (a dp shard samples as the whole batch
    does). No host sync. The draws do not reproduce JAX's bits."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    lt = logits.float() / temperature
    neg = float("-inf")
    if min_p > 0.0:
        probs = torch.softmax(lt, -1)
        lt = lt.masked_fill(probs < min_p * probs.amax(-1, keepdim=True), neg)
    if top_k > 0:
        kth = torch.topk(lt, min(top_k, lt.shape[-1]), -1).values[..., -1:]
        lt = lt.masked_fill(lt < kth, neg)
    if top_p > 0.0:
        sorted_desc = torch.sort(lt, -1, descending=True).values
        probs = torch.softmax(sorted_desc, -1)
        keep = torch.cumsum(probs, -1) - probs < top_p
        cutoff = torch.where(keep, sorted_desc, float("inf")).amin(
            -1, keepdim=True)
        lt = lt.masked_fill(lt < cutoff, neg)
    if rows is None:
        u = torch.rand(lt.shape, generator=generator, device=lt.device)
    else:
        u = torch.rand((rows[1], lt.shape[-1]), generator=generator,
                       device=lt.device)[rows[0]:rows[0] + lt.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return (lt + gumbel).argmax(-1).to(torch.int32)


def _prompt_tensor(prompt, cfg: GPTConfig, max_new: int, dev):
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be (B, P), got {tuple(prompt.shape)}")
    if prompt.shape[1] + max_new > cfg.max_seq:
        raise ValueError(f"prompt length {prompt.shape[1]} + max_new "
                         f"{max_new} exceeds max_seq {cfg.max_seq}")
    return prompt


def make_generate(cfg: GPTConfig, max_new: int, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 0.0, min_p: float = 0.0,
                  repetition_penalty: float = 1.0,
                  quant: str | None = None, mesh=None):
    """Generation that stays on the device: a batched prefill, then
    `max_new` sampled tokens, each fed to a decode step, with no fetch to
    the host between steps (the one sync is the caller's read of the
    result).

    Sampling controls: `temperature`/`top_k`/`top_p`/`min_p` (see
    `sample_logits`) and `repetition_penalty` (CTRL-style: logits of tokens
    already in the prompt or generated so far are divided by the penalty
    when positive, multiplied when negative; 1.0 disables). `quant` as
    `make_decode_step` (the weights quantized once a call, outside the
    loop).

    With `mesh` (a DeviceMesh with "dp" and "tp" axes, either of size 1;
    every rank calls gen with the same whole params and prompt), serving
    runs tensor-parallel, as JAX's: each rank takes its dp rows of the
    batch (B % dp == 0) and its tp slice of the prepared params
    (`_tp_params`: Megatron's layout, kv heads over tp, KV % tp == 0), its
    cache holds those rows and heads, each layer all-reduces proj's and
    fc_out's products over tp, the tp ranks take tp rank 0's tokens, and
    the rows are gathered over dp: every rank returns the whole (B, P +
    max_new). A sampled dp shard draws the whole batch's noise and keeps
    its rows, so with the same generator state the tokens are the
    unsharded program's.

    Returns gen(params, prompt (B, P), generator=None) -> (B, P + max_new)
    int32 on the params' device; P + max_new must fit cfg.max_seq."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)
    tp = dp_group = None
    dp, dp_rank = 1, 0
    if mesh is not None:
        from ..parallel.mesh import mesh_axis

        _check_serving_mesh(mesh, cfg, dp=True)
        tp = _ServeTP(mesh, cfg)
        dp_group, dp, dp_rank = mesh_axis(mesh, "dp")
    rp = repetition_penalty

    @torch.no_grad()
    def gen(params, prompt, generator: torch.Generator | None = None):
        params = _prep_decode_params(params, cfg, quant)  # outside the loop
        if tp is not None:
            params = _tp_params(params, cfg, tp)
        dev = params["wte"].device
        prompt = _prompt_tensor(prompt, cfg, max_new, dev)
        B, P = prompt.shape
        rows = None
        if tp is not None:
            if B % dp:
                raise ValueError(f"dp {dp} does not divide the batch {B}")
            rows = (dp_rank * (B // dp), B)
            prompt = prompt[rows[0]:rows[0] + B // dp]
            B = B // dp
        cache = init_kv_cache(cfg, B, quant=quant, device=dev, tp=tp)
        logits, cache = _prefill_body(params, cache, prompt, cfg)
        out = torch.empty((B, P + max_new), dtype=torch.int32, device=dev)
        out[:, :P] = prompt
        seen = None
        if rp != 1.0:
            seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                               device=dev)
            seen.scatter_(1, prompt.long(), True)
        for t in range(max_new):
            lg = logits
            if seen is not None:
                lg = torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp),
                                 lg)
            nxt = _tp_tokens(tp, sample_logits(lg, generator, temperature,
                                               top_k, top_p, min_p, rows))
            out[:, P + t] = nxt
            if seen is not None:
                seen.scatter_(1, nxt[:, None].long(), True)
            if t + 1 < max_new:      # the last token's logits go unused
                logits, cache = _decode_step_body(params, cache, nxt, cfg)
        if tp is not None:
            from ..parallel.collectives import gather

            out = gather(out, 0, dp_group)
        return out

    return gen


def generate(params, cfg: GPTConfig, prompt, max_new: int,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0):
    """Greedy / temperature / top-k / nucleus sampling with the KV cache,
    JAX's host loop: a batched prefill (`make_prefill`), then one decode
    step (`make_decode_step`) per token, each token fetched to the host.
    Runs on the params' device; returns a (B, P + max_new) int32 numpy
    array."""
    params = prepare_decode_params(params, cfg)     # the steps' casts: free
    decode = make_decode_step(cfg)
    dev = params["wte"].device
    prompt = _prompt_tensor(prompt, cfg, max_new, dev)
    cache = init_kv_cache(cfg, prompt.shape[0], device=dev)
    logits, cache = make_prefill(cfg)(params, cache, prompt)
    out = [prompt.cpu().numpy()]
    for t in range(max_new):
        nxt = sample_logits(logits, generator, temperature, top_k, top_p)
        out.append(nxt.cpu().numpy()[:, None])
        if t + 1 < max_new:
            logits, cache = decode(params, cache, nxt)
    return np.concatenate(out, axis=1)


def make_beam_search(cfg: GPTConfig, max_new: int, n_beams: int,
                     quant: str | None = None):
    """Beam search on the device: a batched prefill, then `max_new` steps,
    each expanding every beam over the vocabulary, keeping the `n_beams`
    highest-scoring continuations per batch row and reordering the KV
    cache (and the int8 cache's scales) to the surviving parents (a
    batch-axis gather, as JAX's).

    Returns search(params, prompt (B, P)) -> (tokens (B, K, P + max_new)
    int32, scores (B, K) f32), beams best first by total log-probability.
    Ties between equal scores go to the lower flat index (beam-major over
    the vocabulary), as `lax.top_k` breaks them: a stable sort."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)
    K = n_beams

    @torch.no_grad()
    def search(params, prompt):
        params = _prep_decode_params(params, cfg, quant)
        dev = params["wte"].device
        prompt = _prompt_tensor(prompt, cfg, max_new, dev)
        B, P = prompt.shape
        V = cfg.vocab_size
        cache = init_kv_cache(cfg, B, quant=quant, device=dev)
        logits, cache = _prefill_body(params, cache, prompt, cfg)
        # replicate to B*K rows, b-major: row = b*K + k
        for n in _kv_names(cache):
            cache[n] = cache[n].repeat_interleave(K, dim=1)
        logits = logits.repeat_interleave(K, dim=0)
        # only beam 0 is live at first (the others are copies of it)
        scores = torch.full((B, K), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        buf = torch.zeros((B, K, max_new), dtype=torch.int32, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        for t in range(max_new):
            logp = torch.log_softmax(logits.float(), -1)
            total = (scores.reshape(B * K, 1) + logp).reshape(B, K * V)
            top_s, top_i = torch.sort(total, stable=True, dim=-1,
                                      descending=True)
            top_s, top_i = top_s[:, :K], top_i[:, :K]
            parent = top_i // V
            token = (top_i % V).to(torch.int32)
            flat = (rows * K + parent).reshape(-1)
            for n in _kv_names(cache):
                cache[n] = cache[n].index_select(1, flat)
            buf = buf[rows, parent]
            buf[:, :, t] = token
            scores = top_s
            if t + 1 < max_new:
                logits, cache = _decode_step_body(params, cache,
                                                  token.reshape(-1), cfg)
        toks = torch.cat([prompt[:, None].expand(B, K, P), buf], dim=2)
        return toks, scores

    return search


def make_speculative_generate(cfg_target: GPTConfig, cfg_draft: GPTConfig,
                              max_new: int, gamma: int = 4,
                              quant: str | None = None,
                              draft_quant: str | None = None):
    """Greedy speculative decoding (one stream, B=1; JAX's
    `make_speculative_generate`): the draft proposes `gamma` tokens by
    decode steps, the target scores all of them in ONE chunked pass
    (`_verify_body`), and the longest matching prefix plus the target's
    own next token is emitted. Rolling back is setting `pos`: the mask
    never reads past it.

    The output is EXACTLY the target's greedy continuation for ANY draft;
    the draft only changes how many target passes it takes. Needs
    prompt_len + max_new + gamma + 1 <= both models' max_seq and a shared
    vocabulary. Each round reads the accepted length back to the host
    once.

    Returns spec(params_target, params_draft, prompt (1, P)) -> (tokens
    (1, P + max_new) int32 on the target's device, n_target_steps), the
    number of verify passes (an int)."""
    for c in (cfg_target, cfg_draft):
        _require_causal(c, "speculative decoding")
    _check_mode(quant)
    _check_mode(draft_quant)

    @torch.no_grad()
    def spec(params_t, params_d, prompt):
        dev = params_t["wte"].device
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
        if prompt.dim() != 2 or prompt.shape[0] != 1:
            raise ValueError("speculative decoding is single-stream (B=1)")
        P = prompt.shape[1]
        if P + max_new + gamma + 1 > min(cfg_target.max_seq,
                                         cfg_draft.max_seq):
            raise ValueError("prompt + max_new + gamma + 1 exceeds max_seq")
        pt = _prep_decode_params(params_t, cfg_target, quant)
        pd = _prep_decode_params(params_d, cfg_draft, draft_quant)
        cache_t = init_kv_cache(cfg_target, 1, quant=quant, device=dev)
        cache_d = init_kv_cache(cfg_draft, 1, quant=draft_quant, device=dev)
        lg_t, cache_t = _prefill_body(pt, cache_t, prompt, cfg_target)
        _, cache_d = _prefill_body(pd, cache_d, prompt, cfg_draft)
        buf = torch.zeros((max_new + gamma + 1,), dtype=torch.int32,
                          device=dev)
        buf[0] = lg_t[0].argmax()
        n, iters = 1, 0
        while n < max_new:
            last = buf[n - 1:n]
            tok, props = last, []
            for _ in range(gamma):
                lg, cache_d = _decode_step_body(pd, cache_d, tok, cfg_draft)
                tok = lg.argmax(-1).to(torch.int32)
                props.append(tok)
            # the draft consumes its last proposal too, so its cache is
            # whole when every proposal is accepted
            _, cache_d = _decode_step_body(pd, cache_d, tok, cfg_draft)
            props = torch.cat(props)                            # (gamma,)
            lg, cache_t = _verify_body(pt, cache_t,
                                       torch.cat([last, props])[None],
                                       cfg_target)
            g = lg[0].argmax(-1).to(torch.int32)                # (gamma+1,)
            match = props == g[:gamma]
            j = torch.where(match.all(), gamma,
                            torch.argmin(match.to(torch.int32)))
            # emit g[0..j]: j accepted and the target's correction (or
            # bonus); what lies past j is overwritten next round
            buf[n:n + gamma + 1] = g
            n += int(j) + 1                                     # the sync
            for c in (cache_t, cache_d):
                c["pos"] = torch.full((), P + n - 1, dtype=torch.int32,
                                      device=dev)
            iters += 1
        return torch.cat([prompt, buf[None, :max_new]], dim=1), iters

    return spec


# --------------------------------------------------------------------------
# dense-slot serving: one (L, n_slots, KV, max_seq, hd) cache, a position
# per slot (continuous batching's `ContinuousBatcher`)


def init_slot_cache(cfg: GPTConfig, n_slots: int, quant: str | None = None,
                    device=None, tp=None):
    """KV cache for slot-based serving: `init_kv_cache`'s layout (the int8
    one for "int8-kv"; a tp rank's heads under `tp`) with a PER-SLOT
    position vector (n_slots,) int32: each slot advances on its own."""
    cache = init_kv_cache(cfg, n_slots, quant=quant, device=device, tp=tp)
    cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                               device=cache["k"].device)
    return cache


def _slot_prefill_run(params, cache, prompt, slots, plen, last, cfg,
                      quant, ab, sel):
    """Prefill `prompt` (m, P) into a fresh mini cache and copy each row's
    whole K/V row (the zeros past P included, as JAX's
    `dynamic_update_slice`) into `slots` (an int or an (m,) tensor);
    pos[slots] = plen."""
    if isinstance(slots, int):
        slots = slice(slots, slots + 1)
    mini = init_kv_cache(cfg, prompt.shape[0], quant=quant,
                         device=prompt.device, tp=params.get("tp"))
    logits, mini = _prefill_body(params, mini, prompt, cfg, ab, sel, last)
    for n in _kv_names(cache):
        cache[n][:, slots] = mini[n]
    cache["pos"][slots] = plen
    return logits, cache


def make_slot_prefill(cfg: GPTConfig, quant: str | None = None,
                      bucketed: bool = False):
    """Per-request prefill for slot serving: (params, cache, prompt (1, P),
    slot) -> (last-position logits (V,), cache with the slot's K/V row
    replaced and pos[slot] = P); other slots are untouched, so a request
    joins a running batch. With `bucketed=True`: (params, cache, prompt
    (1, Pb), plen, slot): the prompt is zero-padded to a bucket Pb and the
    logits are position plen-1's; pos[slot] = plen. Trailing (adapters,
    sel) apply per-request LoRA. The cache is updated in place."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def pre(params, cache, prompt, slot, adapters=None, sel=None):
        params = _prep_decode_params(params, cfg, quant)
        logits, cache = _slot_prefill_run(
            params, cache, prompt, slot, prompt.shape[1], None, cfg, quant,
            adapters, sel)
        return logits[0], cache

    @torch.no_grad()
    def pre_bucketed(params, cache, prompt, plen, slot, adapters=None,
                     sel=None):
        params = _prep_decode_params(params, cfg, quant)
        logits, cache = _slot_prefill_run(
            params, cache, prompt, slot, int(plen), int(plen) - 1, cfg,
            quant, adapters, sel)
        return logits[0], cache

    return pre_bucketed if bucketed else pre


def make_slot_prefill_multi(cfg: GPTConfig, quant: str | None = None):
    """Multi-request prefill for slot serving (grouped admission):
    (params, cache, prompts (m, Pb), plens (m,), slots (m,)) -> (logits
    (m, V) at each row's plen-1, cache with the m slots' rows replaced and
    pos[slots] = plens). One pass reads the weights once for the group.
    Rows padding the group to a power of two replicate row 0 (prompt,
    plen, slot), so their duplicate writes carry the same values."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def pre(params, cache, prompts, plens, slots):
        params = _prep_decode_params(params, cfg, quant)
        return _slot_prefill_run(params, cache, prompts, slots.long(),
                                 plens, plens - 1, cfg, quant, None, None)

    return pre


def make_slot_suffix_prefill(cfg: GPTConfig, quant: str | None = None,
                             bucketed: bool = False):
    """Suffix prefill after a cached prefix (slot serving): (params,
    cache, pk, pv, plen, suffix (1, C), slot) -> (last-position logits
    (V,), cache); with `bucketed=True` (..., plen, suffix (1, Cb), cs,
    slot): the suffix padded to a bucket, true length cs. `pk`/`pv` are
    the prefix's K/V ((L, 1, KV, max_seq, hd), positions < plen valid;
    `scales=(ks, vs)` beside them for the int8 cache). The slot's row
    becomes the prefix's, then the suffix runs as one chunked pass from
    plen (`_verify_body`): the same state as a full prefill of the whole
    prompt for the cost of the suffix. pos[slot] = plen + C."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    def body(params, cache, pk, pv, plen, suffix, slot, cs, last, scales):
        params = _prep_decode_params(params, cfg, quant)
        pre_kv = {"k": pk, "v": pv}
        if scales is not None:
            pre_kv["ks"], pre_kv["vs"] = scales
        row = {}
        for n in _kv_names(cache):
            cache[n][:, slot] = pre_kv[n][:, 0]
            row[n] = cache[n][:, slot:slot + 1]          # views: in place
        row["pos"] = int(plen)
        logits, _ = _verify_body(params, row, suffix, cfg)
        cache["pos"][slot] = int(plen) + cs
        return logits[0, last], cache

    @torch.no_grad()
    def pre(params, cache, pk, pv, plen, suffix, slot, scales=None):
        return body(params, cache, pk, pv, plen, suffix, slot,
                    suffix.shape[1], -1, scales)

    @torch.no_grad()
    def pre_bucketed(params, cache, pk, pv, plen, suffix, cs, slot,
                     scales=None):
        # the caller caps the bucket at max_seq - plen, so the dead tail's
        # writes stay in range
        return body(params, cache, pk, pv, plen, suffix, slot, int(cs),
                    int(cs) - 1, scales)

    return pre_bucketed if bucketed else pre


def make_slot_chunk_prefill(cfg: GPTConfig, quant: str | None = None):
    """Chunked prefill for slot serving (SARATHI-style): (params, cache,
    chunk (1, C), slot, start) -> (logits (V,) at the chunk's last
    position, cache). The chunk continues the slot's own partial K/V: its
    queries attend positions < start and the chunk's causal range
    (`_verify_body`), its K/V land at start..start+C-1, pos[slot] =
    start + C. The scheduler sends aligned chunks and a final chunk of the
    row's LAST C tokens (start = P - C): the overlap rewrites the same
    K/V, so no chunk is padded. Trailing (adapters, sel) serve per-request
    LoRA."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def pre(params, cache, chunk, slot, start, adapters=None, sel=None):
        params = _prep_decode_params(params, cfg, quant)
        row = {n: cache[n][:, slot:slot + 1] for n in _kv_names(cache)}
        row["pos"] = int(start)
        logits, _ = _verify_body(params, row, chunk, cfg, adapters, sel)
        cache["pos"][slot] = int(start) + chunk.shape[1]
        return logits[0, -1], cache

    return pre


def _slot_decode_body(params, cache, tokens, active, cfg: GPTConfig,
                      adapters=None, sel=None):
    """One slot-decode step on PREPARED params (the body of
    `make_slot_decode_step` and `make_slot_decode_many`): each active slot
    writes its K/V at its own position and attends its own causal range;
    inactive slots rewrite their own values and keep their position."""
    pos = cache["pos"]                                   # (B,) int32
    B = tokens.shape[0]
    pos_w = pos.clamp(max=cfg.max_seq - 1)               # clamp idle slots
    pw = pos_w.long()
    x = params["wte"][tokens.long()]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][pw]
    x = x.to(cfg.dtype)[:, None, :]
    bar = torch.arange(B, device=tokens.device)
    keep = active[:, None, None]
    quant_kv = "ks" in cache
    tp = params.get("tp")
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        ab_l = _layer_ab(adapters, i)
        q, k_new, v_new = _decode_qkv(x, blk, cfg, pos, ab_l, sel, tp)
        for name, t in _kv_entries(k_new, v_new, quant_kv):
            c = cache[name][i]
            # two advanced indices split by a slice: (B, KV, last)
            c[bar, :, pw] = torch.where(keep, t[:, :, 0], c[bar, :, pw])
        lk, lv = _kv_layer(cache, i, cfg)
        x = _decode_block(x, blk, q, lk, lv, pos_w, cfg, ab_l, sel, tp)
    x = _layer_norm(x, params["ln_f"], cfg.norm_eps)
    cache["pos"] = torch.where(active, (pos + 1).clamp(max=cfg.max_seq), pos)
    return _logits(x[:, 0], params, cfg), cache


def make_slot_decode_step(cfg: GPTConfig, quant: str | None = None):
    """Decode across slots with PER-SLOT positions (continuous batching):
    (params, cache, tokens (B,), active (B,) bool) -> (logits (B, V) f32,
    cache), the cache updated in place; trailing (adapters, sel) route
    per-slot LoRA adapters."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def step(params, cache, tokens, active, adapters=None, sel=None):
        params = _prep_decode_params(params, cfg, quant)
        return _slot_decode_body(params, cache, tokens, active, cfg,
                                 adapters, sel)

    return step


def _decode_window(k, body, tokens, active, seeds, steps0, temperature,
                   top_k, top_p, min_p, tp=None):
    """k decode steps and per-row sampling without a host read: `body(tok)`
    runs one step and returns its logits. Row b's token at step i is drawn
    from (seeds[b], steps0[b] + i), as the per-step path draws it; under
    `tp` every rank takes tp rank 0's tokens. Returns the (k, B) int32
    tokens on the device."""
    toks = []
    tok = tokens
    for i in range(k):
        logits = body(tok)
        nxt = _tp_tokens(tp, sample_logits_batched(
            logits, seeds, [s + i for s in steps0], temperature, top_k,
            top_p, min_p)).to(torch.int32)
        tok = torch.where(active, nxt, tok)
        toks.append(nxt)
    return torch.stack(toks)


def make_slot_decode_many(cfg: GPTConfig, k: int, quant: str | None = None):
    """k slot-decode steps and per-row sampling in one call with no host
    read between steps (multi-step scheduling): (params, cache, tokens
    (B,), active (B,), seeds, steps0, temperature, top_k, top_p, min_p
    (host sequences of length B)) -> (tokens (k, B) int32 on the device,
    cache). The caller reads the tokens once a window; they are the
    per-step path's exactly (each row's draw depends on its own seed and
    step count and its own causal lane), and the host discards what a row
    emits past its stop, eos or budget."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _check_mode(quant)

    @torch.no_grad()
    def many(params, cache, tokens, active, seeds, steps0, temperature,
             top_k, top_p, min_p, adapters=None, sel=None):
        params = _prep_decode_params(params, cfg, quant)

        def body(tok):
            return _slot_decode_body(params, cache, tok, active, cfg,
                                     adapters, sel)[0]

        return _decode_window(k, body, tokens, active, seeds, steps0,
                              temperature, top_k, top_p, min_p,
                              params.get("tp")), cache

    return many


# --------------------------------------------------------------------------
# paged KV cache (block tables; vLLM-style memory management)


def _paged_mode(quant) -> None:
    """The paged programs take every mode but the int8 cache (JAX's
    refusal, with its message)."""
    _check_mode(quant)
    if quant == "int8-kv":
        raise NotImplementedError("paged serving supports "
                                  "quant=None/'int8'/'int4'")


def init_paged_cache(cfg: GPTConfig, n_blocks: int, block_size: int,
                     n_slots: int, device, tp=None):
    """Block-pool KV cache: K/V live in a shared pool of `n_blocks`
    fixed-size blocks (L, NB, KV, BS, hd) instead of a dense per-slot
    reservation; under `tp` the rank's KV/tp heads, a plain local tensor.
    Block 0 is scratch for inactive decode lanes; the allocator
    (serving.PagedBatcher) never hands it out."""
    dev = resolve(device)
    hd = cfg.d_model // cfg.n_head
    shape = (cfg.n_layer, n_blocks, _local_kv(cfg, tp), block_size, hd)
    return {
        "pk": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pv": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    }


def _mini(cfg: GPTConfig, m: int, S: int, dev, tp=None):
    """A dense (L, m, KV, S, hd) K/V scratch cache in the compute dtype
    (KV the rank's heads under `tp`)."""
    shape = (cfg.n_layer, m, _local_kv(cfg, tp), S,
             cfg.d_model // cfg.n_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": 0}


def _to_blocks(t, BS: int):
    """(L, m, KV, nb*BS, hd) -> (L, m*nb, KV, BS, hd): positions cut into
    blocks, each row's blocks in order."""
    L, m, KV, S, hd = t.shape
    nb = S // BS
    return t.reshape(L, m, KV, nb, BS, hd).permute(0, 1, 3, 2, 4, 5).reshape(
        L, m * nb, KV, BS, hd)


def _from_blocks(t):
    """(L, nb, KV, BS, hd) pool blocks in order -> (L, 1, KV, nb*BS, hd)."""
    L, nb, KV, BS, hd = t.shape
    return t.permute(0, 2, 1, 3, 4).reshape(L, 1, KV, nb * BS, hd)


def _scatter_blocks(cache, mini_k, mini_v, idx, BS: int):
    """Write dense K/V rows into the pool blocks `idx` (one per BS
    positions, rows in order)."""
    for name, src in (("pk", mini_k), ("pv", mini_v)):
        cache[name][:, idx] = _to_blocks(src, BS).to(cache[name].dtype)


def make_paged_prefill(cfg: GPTConfig, block_size: int,
                       quant: str | None = None, bucketed: bool = False):
    """Prefill into pool blocks: (params, cache, prompt (1, P), slot,
    blocks (>= ceil(P/BS),) int) -> (last-position logits (V,), cache).
    One pass computes the prompt's K/V (`_prefill_body`), which is then
    scattered into the first ceil(P/BS) blocks; pos[slot] = P. With
    `bucketed=True`: (params, cache, prompt (1, Pb), plen, slot, blocks):
    `blocks` is padded past its real ceil(plen/BS) entries with scratch
    block 0, where the padded tail's K/V land; pos[slot] = plen. Trailing
    (adapters, sel) apply per-request LoRA. The cache is updated in
    place."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    BS = block_size

    def body(params, cache, prompt, slot, blocks, ab, sel, plen, last):
        params = _prep_decode_params(params, cfg, quant)
        nb = -(-prompt.shape[1] // BS)
        mini = _mini(cfg, 1, max(nb * BS, BS), prompt.device,
                     params.get("tp"))
        logits, mini = _prefill_body(params, mini, prompt, cfg, ab, sel,
                                     last)
        _scatter_blocks(cache, mini["k"], mini["v"], blocks[:nb].long(), BS)
        cache["pos"][slot] = plen
        return logits[0], cache

    @torch.no_grad()
    def pre(params, cache, prompt, slot, blocks, adapters=None, sel=None):
        return body(params, cache, prompt, slot, blocks, adapters, sel,
                    prompt.shape[1], None)

    @torch.no_grad()
    def pre_bucketed(params, cache, prompt, plen, slot, blocks,
                     adapters=None, sel=None):
        return body(params, cache, prompt, slot, blocks, adapters, sel,
                    int(plen), int(plen) - 1)

    return pre_bucketed if bucketed else pre


def make_paged_prefill_multi(cfg: GPTConfig, block_size: int,
                             quant: str | None = None):
    """Multi-request prefill into pool blocks (grouped admission):
    (params, cache, prompts (m, Pb), plens (m,), slots (m,), tables (m,
    ceil(Pb/BS)) int32) -> (logits (m, V) at each row's plen-1, cache).
    One pass computes every row's K/V, which scatter through each row's
    table; entries past a row's real blocks are scratch block 0, and rows
    padding the group replicate row 0 (prompt, plen, slot and table)."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    BS = block_size

    @torch.no_grad()
    def pre(params, cache, prompts, plens, slots, tables):
        params = _prep_decode_params(params, cfg, quant)
        m, P = prompts.shape
        nb = -(-P // BS)
        mini = _mini(cfg, m, max(nb * BS, BS), prompts.device,
                     params.get("tp"))
        logits, mini = _prefill_body(params, mini, prompts, cfg,
                                     last=plens - 1)
        _scatter_blocks(cache, mini["k"][:, :, :, :nb * BS],
                        mini["v"][:, :, :, :nb * BS],
                        tables.reshape(-1).long(), BS)
        cache["pos"][slots.long()] = plens
        return logits, cache

    return pre


def make_paged_suffix_prefill(cfg: GPTConfig, block_size: int,
                              quant: str | None = None,
                              bucketed: bool = False):
    """Suffix prefill after a shared prefix in the block pool: (params,
    cache, suffix (1, C), slot, own_blocks (nb,) int, prefix_blocks (nf,)
    int) -> (last-position logits (V,), cache); with `bucketed=True`
    (params, cache, suffix (1, Cb), cs, slot, own_blocks, prefix_blocks):
    the suffix padded to a bucket, true length cs, own_blocks padded with
    scratch block 0. The prefix's nf FULL blocks are gathered into a dense
    mini cache, the suffix runs from nf*BS (`_verify_body`), and its K/V
    scatter into the request's own blocks; the shared blocks are read,
    never written. pos[slot] = nf*BS + cs."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    BS = block_size

    def body(params, cache, suffix, slot, own, prefix, cs, last):
        params = _prep_decode_params(params, cfg, quant)
        nf, nb = prefix.shape[0], own.shape[0]
        cut = nf * BS
        pad = (0, 0, 0, nb * BS)             # whole blocks cover cut + C
        mini = {"k": F.pad(_from_blocks(cache["pk"][:, prefix.long()]), pad),
                "v": F.pad(_from_blocks(cache["pv"][:, prefix.long()]), pad),
                "pos": cut}
        logits, mini = _verify_body(params, mini, suffix, cfg)
        _scatter_blocks(cache, mini["k"][:, :, :, cut:],
                        mini["v"][:, :, :, cut:], own.long(), BS)
        cache["pos"][slot] = cut + cs
        return logits[0, last], cache

    @torch.no_grad()
    def pre(params, cache, suffix, slot, own_blocks, prefix_blocks):
        return body(params, cache, suffix, slot, own_blocks, prefix_blocks,
                    suffix.shape[1], -1)

    @torch.no_grad()
    def pre_bucketed(params, cache, suffix, cs, slot, own_blocks,
                     prefix_blocks):
        return body(params, cache, suffix, slot, own_blocks, prefix_blocks,
                    int(cs), int(cs) - 1)

    return pre_bucketed if bucketed else pre


def make_paged_chunk_prefill(cfg: GPTConfig, block_size: int,
                             quant: str | None = None):
    """Chunked prefill over the block pool: (params, cache, chunk (1, C),
    slot, start, row (MB,) int32) -> (logits (V,) at the chunk's last
    position, cache). `row` is the slot's FULL table row (unallocated
    entries scratch block 0): the row is gathered into a dense mini cache,
    the chunk runs from `start`, and the row is scattered back (scratch
    block 0 takes whatever its duplicates carry). Trailing (adapters, sel)
    serve per-request LoRA."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    BS = block_size

    @torch.no_grad()
    def pre(params, cache, chunk, slot, start, row, adapters=None,
            sel=None):
        params = _prep_decode_params(params, cfg, quant)
        idx = row.long()
        mini = {"k": _from_blocks(cache["pk"][:, idx]),
                "v": _from_blocks(cache["pv"][:, idx]), "pos": int(start)}
        logits, mini = _verify_body(params, mini, chunk, cfg, adapters, sel)
        _scatter_blocks(cache, mini["k"], mini["v"], idx, BS)
        cache["pos"][slot] = int(start) + chunk.shape[1]
        return logits[0, -1], cache

    return pre


def _kernel_mode(kernel: str) -> None:
    if kernel not in ("auto", "on", "off"):
        raise ValueError(f"kernel must be auto/on/off, got {kernel!r}")


def _refuse_cpu_on(kernel: str, cache) -> None:
    if kernel == "on" and cache["pk"].device.type != "cuda":
        raise ValueError("kernel='on' needs CUDA tensors; on the CPU use "
                         "kernel='auto' (plain version) or 'off'")


def make_paged_decode_step(cfg: GPTConfig, block_size: int,
                           quant: str | None = None, kernel: str = "auto"):
    """Decode over the block pool: (params, cache, tokens (B,), active (B,)
    bool, table (B, MB) int32) -> (logits (B, V) f32, cache); trailing
    (adapters, sel) route per-slot LoRA adapters. The cache is updated in
    place (JAX donates it).

    `table[s, m]` names the pool block holding slot s's logical positions
    [m*BS, (m+1)*BS). Inactive lanes rewrite scratch block 0 with its own
    values and their outputs are discarded.

    `kernel` picks the attention path: "auto" runs the CUDA kernel
    (`ops/paged_attention.py`) for CUDA tensors and its plain version for
    CPU tensors; "on" is the same but refuses CPU tensors; "off" runs the
    gather path (JAX's XLA branch). Quantized weights and adapters keep
    the kernel."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    _kernel_mode(kernel)
    BS = block_size

    @torch.no_grad()
    def step(params, cache, tokens, active, table, adapters=None, sel=None):
        _refuse_cpu_on(kernel, cache)
        params = _prep_decode_params(params, cfg, quant)
        return _paged_decode_body(params, cache, tokens, active, table, cfg,
                                  kernel != "off", BS, adapters, sel)

    return step


def _paged_decode_body(params, cache, tokens, active, table,
                       cfg: GPTConfig, use_kernel: bool, BS: int,
                       adapters=None, sel=None):
    """One paged-decode step on PREPARED params (the body of
    `make_paged_decode_step` and `make_paged_decode_many`). On a tp rank
    the pool holds the rank's kv heads whole, so K11 runs on it as on one
    card, at (B, KV/tp, G, hd)."""
    pos = cache["pos"]                                   # (B,) int32
    B = tokens.shape[0]
    MB = table.shape[1]
    tp = params.get("tp")
    KV = _local_kv(cfg, tp)
    hd = cfg.d_model // cfg.n_head
    pos_w = pos.clamp(max=MB * BS - 1)                   # clamp idle slots
    x = params["wte"][tokens.long()]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][pos_w.clamp(max=cfg.max_seq - 1).long()]
    x = x.to(cfg.dtype)[:, None, :]
    t_long = table.long()
    bar = torch.arange(B, device=tokens.device)
    bid = torch.where(active, t_long[bar, (pos_w // BS).long()], 0)
    off = (pos_w % BS).long()
    keep = active[:, None, None]
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        ab_l = _layer_ab(adapters, i)
        q, k_new, v_new = _decode_qkv(x, blk, cfg, pos, ab_l, sel, tp)
        pk_l, pv_l = cache["pk"][i], cache["pv"][i]
        # two advanced indices split by a slice: the batch axis comes first,
        # (B, KV, hd), matching k_new[:, :, 0]
        pk_l[bid, :, off] = torch.where(keep, k_new[:, :, 0], pk_l[bid, :, off])
        pv_l[bid, :, off] = torch.where(keep, v_new[:, :, 0], pv_l[bid, :, off])
        if use_kernel:
            ctx = paged_attention(q[:, :, :, 0].contiguous(), pk_l, pv_l,
                                  table, pos_w, window=cfg.window)
            # kv-group-major (B, KV, G, hd) == head-major merge
            x = _decode_post(x, blk, ctx.reshape(B, 1, -1), cfg, ab_l, sel,
                             tp)
        else:
            lk = pk_l[t_long].permute(0, 2, 1, 3, 4).reshape(
                B, KV, MB * BS, hd)
            lv = pv_l[t_long].permute(0, 2, 1, 3, 4).reshape(
                B, KV, MB * BS, hd)
            x = _decode_block(x, blk, q, lk, lv, pos_w, cfg, ab_l, sel, tp)
    x = _layer_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(x[:, 0], params, cfg)
    cache["pos"] = torch.where(active, pos + 1, pos)
    return logits, cache


def make_paged_decode_many(cfg: GPTConfig, block_size: int, k: int,
                           quant: str | None = None, kernel: str = "auto"):
    """k paged-decode steps and per-row sampling with no host read between
    them: the paged twin of `make_slot_decode_many`, (params, cache,
    tokens, active, table, seeds, steps0, temperature, top_k, top_p,
    min_p, adapters=None, sel=None) -> (tokens (k, B) int32 on the device,
    cache). The table is FIXED for the window, so the scheduler allocates
    every active slot's blocks through pos+k first (`PagedBatcher`'s
    `_grow_many`). Each step runs `kernel`'s attention path, K11 on the
    card under "auto" and "on", as the per-step program does."""
    _require_causal(cfg, "kv-cache decoding/serving")
    _paged_mode(quant)
    _kernel_mode(kernel)
    BS = block_size

    @torch.no_grad()
    def many(params, cache, tokens, active, table, seeds, steps0,
             temperature, top_k, top_p, min_p, adapters=None, sel=None):
        _refuse_cpu_on(kernel, cache)
        params = _prep_decode_params(params, cfg, quant)

        def body(tok):
            return _paged_decode_body(params, cache, tok, active, table, cfg,
                                      kernel != "off", BS, adapters, sel)[0]

        return _decode_window(k, body, tokens, active, seeds, steps0,
                              temperature, top_k, top_p, min_p,
                              params.get("tp")), cache

    return many


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
    temperature <= 0 is greedy (exact argmax, first index on ties). No
    host sync: the draw is `torch.multinomial`'s for one sample, argmax of
    p / E with E ~ Exp(1) from `generator`, without its validity check
    (which reads the row back)."""
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
        cutoff = torch.where(keep, sorted_desc, float("inf")).amin()
        lt = lt.masked_fill(lt < cutoff, float("-inf"))
    p = torch.softmax(lt, -1)
    e = torch.empty_like(p).exponential_(1, generator=generator)
    return (p / e).argmax()


def sample_logits_batched(logits, seeds, steps, temperature, top_k, top_p,
                          min_p):
    """Per-row sampling over (B, V) logits with PER-ROW controls (host
    sequences of length B) -> (B,) int64 tokens on the logits' device.
    Row b's randomness is a `torch.Generator` seeded from
    (seeds[b], steps[b]), so a request's tokens depend only on its own
    seed and step count, never on its batchmates. No host sync. The draws
    do not reproduce JAX's `fold_in(key(seed), step)` bits; greedy rows
    are exact."""
    out = logits.float().argmax(-1)
    for b, t in enumerate(temperature):
        if t > 0.0:
            g = _row_generator(seeds[b], steps[b], logits.device)
            out[b] = _sample_row(logits[b], g, float(t), int(top_k[b]),
                                 float(top_p[b]), float(min_p[b]))
    return out


# --------------------------------------------------------------------------
# training: forward, loss and the train step


def _use_flash(cfg: GPTConfig, x) -> bool:
    """A flash op unless cfg.flash is "off", or "auto" on the card where
    the kernels cannot take the shape (a head dim above 256, a dtype other
    than f32 and bf16), as JAX's "auto" takes the composite where its
    kernel does not qualify; "on" raises there. Every group size goes to
    the kernels. The ops route by device: the CUDA kernels for CUDA
    tensors, the plain versions, which take any shape, for CPU tensors."""
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


def _split_qkv(qkv, cfg: GPTConfig, B, S, KV: int | None = None):
    """Group-major packed (B, S, W) -> q (B,H,S,hd), k/v (B,H,S,hd), KV
    heads repeated up to H (GQA) for the composite path. `KV`: the kv
    heads qkv holds (a tp shard of whole groups), default all."""
    KV = KV or _kv_heads(cfg)
    H = KV * (cfg.n_head // _kv_heads(cfg))
    hd = cfg.d_model // cfg.n_head
    q, k, v = _unpack_qkv(qkv, cfg, KV)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    return q, k, v


def _proj(out, blk, cfg: GPTConfig, mesh):
    """The attention's output projection; under a mesh proj holds this
    rank's input rows, and the product leaves the tp region before the
    bias."""
    out = _body_dot(out, blk["proj"], cfg)
    if mesh is not None:
        out = mesh.tp_out(out)
    return _badd(out, blk, "proj_b", cfg)


def _attention(x, blk, cfg: GPTConfig, train: bool, seed, mesh=None):
    """Attention sublayer of the training forward (JAX's `_attention`).
    Learned positions without a window take the packed flash op; rope or a
    window split q/k/v out of the packed projection (rotating q and k under
    rope) for the split flash op or, with flash="off", the composite.
    `seed` (an int or None) keys the dropout mask (`keep_mask`) of the
    kernels and of the composite alike, so a checkpointed block redraws
    the same mask when it is recomputed.

    Under a `mesh` (`_Shards`, inside the sharded step) the weights are this
    rank's tp shards and x its rows: each rank runs its H/tp heads. Where
    tp divides the kv heads, the rank's columns of qkv are whole kv groups
    and feed the kernels directly (the packed op with H/tp and KV/tp
    heads, under learned positions, no window and no cp); else qkv is
    gathered over tp and the rank takes its heads. A cp axis runs the
    split layout on the ring (`parallel.ring_flash_attention`) at the
    rows' global positions. Dropout seeds are offset by the rank's dp and
    tp coordinates, as JAX's."""
    if cfg.window and not cfg.causal:
        raise ValueError(
            "cfg.window (sliding-window attention) requires causal=True")
    H = cfg.n_head
    hd = cfg.d_model // H
    KV = _kv_heads(cfg)
    tp = cp = 1
    if mesh is not None:
        x = mesh.tp_in(x)
        tp, cp = mesh.tp, mesh.cp
    B, S, _ = x.shape
    H_l, KV_l = H // tp, (KV // tp if KV % tp == 0 else None)
    tag = _names_policy(cfg, train)
    qkv = _tagged(_badd(_body_dot(x, blk["qkv"], cfg), blk, "qkv_b", cfg),
                  "attn_qkv", tag)
    drop = cfg.dropout if train else 0.0
    if drop > 0.0 and seed is None:
        raise ValueError("dropout in training needs a generator")
    if seed is not None and mesh is not None:
        seed = mesh.seed(seed)
    flash = _use_flash(cfg, x)
    if (flash and cfg.pos_emb == "learned" and not cfg.window
            and KV_l is not None and cp == 1):
        # the packed kernels read head blocks straight from qkv: no split,
        # transpose or GQA-repeat copies
        out = flash_attention_qkv(
            qkv, H_l, KV_l, cfg.causal, None, cfg.flash_block,
            cfg.flash_block, fast_softmax=cfg.flash_softmax == "fast",
            fused_bwd=cfg.flash_bwd == "fused", dropout=drop,
            seed=seed or 0)
        return _proj(out, blk, cfg, mesh)
    if KV_l is not None:
        q, k, v = _split_qkv(qkv, cfg, B, S, KV_l)
    else:       # tp splits kv groups: every rank gathers qkv, keeps its heads
        from ..parallel.collectives import gather

        q, k, v = _split_qkv(gather(qkv, 2, mesh.tp_group), cfg, B, S)
        heads = slice(mesh.tp_rank * H_l, (mesh.tp_rank + 1) * H_l)
        q, k, v = q[:, heads], k[:, heads], v[:, heads]
    off = 0 if mesh is None else mesh.cp_offset(S)
    if cfg.pos_emb == "rope":
        cos, sin = _rope_cos_sin(cfg, torch.arange(off, off + S,
                                                   device=x.device))
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
    q, k, v = (_tagged(t, n, tag) for t, n in zip(
        (q, k, v), ("attn_q", "attn_k", "attn_v")))
    if flash and cp > 1:
        if drop > 0.0:
            raise ValueError(
                "attention dropout is not supported with context "
                "parallelism (cp mesh axis); set dropout=0.0")
        if cfg.window:
            raise ValueError(
                "sliding-window attention is not supported with context "
                "parallelism (cp mesh axis)")
        from ..parallel.ring import ring_flash_attention

        out = ring_flash_attention(q, k, v, mesh.cp_group, cp, cfg.causal)
    elif flash and drop > 0.0:
        out = flash_attention_dropout(q, k, v, seed, cfg.causal, None,
                                      cfg.flash_block, cfg.flash_block, drop,
                                      cfg.window)
    elif flash:
        out = flash_attention(q, k, v, cfg.causal, None, cfg.flash_block,
                              cfg.flash_block, cfg.window)
    else:
        if cp > 1:      # the composite sees every key: gather them over cp
            from ..parallel.collectives import gather

            k, v = (gather(t, 2, mesh.cp_group) for t in (k, v))
        Skv = k.shape[2]
        att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        att = att / math.sqrt(hd)
        if cfg.causal:
            rows = torch.arange(off, off + S, device=x.device)[:, None]
            cols = torch.arange(Skv, device=x.device)[None, :]
            mask = cols <= rows
            if cfg.window:
                mask &= rows - cols < cfg.window
            att = att.masked_fill(~mask, -1e30)
        att = torch.softmax(att, -1).to(cfg.dtype)
        if drop > 0.0:   # the kernels' mask: the routes drop alike
            keep = keep_mask(seed, B, H_l, off + S, Skv, drop,
                             x.device)[:, :, off:]
            att = torch.where(keep, att / (1.0 - drop), 0.0).to(cfg.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", att.float(), v.float())
    out = out.to(cfg.dtype).transpose(1, 2).reshape(B, S, H_l * hd)
    return _proj(out, blk, cfg, mesh)


# --------------------------------------------------------------------------
# remat policies (JAX's `_remat_policy`): what a checkpointed block keeps
# for its backward. PyTorch's selective checkpointing decides op by op, so
# the policies name ops: "flash" the flash forwards' custom ops (JAX saves
# its Pallas and custom-VJP calls' outputs), "dots" the 2-d matmuls (JAX's
# dots without batch dims: q.k and p.v run batched and are recomputed),
# and "names" those of "flash" and the tag op (`_tagged`), a copy of each
# tagged activation and nothing else of the ops that made it, as JAX's
# `save_only_these_names` keeps only the tagged values. Eager PyTorch has
# no dead-code pass, so the recompute still runs the ops that made a
# tagged value (and drops their result for the kept copy): "names" keeps
# JAX's memory, not its saved work.

# JAX's `_MATMUL_INPUT_NAMES`; "ffn_act" is left out there, as here
_MATMUL_INPUT_NAMES = ("ln1_out", "ln2_out", "ffn_pre", "ffn_gate",
                       "attn_q", "attn_k", "attn_v", "attn_qkv")
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


@torch.library.custom_op("neuronika_tpu_torch::checkpoint_tag",
                         mutates_args=())
def _tag_op(x: torch.Tensor) -> torch.Tensor:
    """A copy of x: the op that remat_policy "names" keeps."""
    return x.clone()


@_tag_op.register_fake
def _(x):
    return torch.empty_like(x)


_tag_op.register_autograd(lambda ctx, grad: grad)
_TAG = torch.ops.neuronika_tpu_torch.checkpoint_tag.default


def _names_policy(cfg: GPTConfig, train: bool) -> bool:
    """True where the block runs under a "names" checkpoint."""
    return train and cfg.remat and cfg.remat_policy == "names"


def _tagged(x, name: str, tag: bool):
    """x tagged `name` (JAX's `checkpoint_name`): with `tag` (a "names"
    checkpoint) a copy through the tag op, which that policy keeps; else
    x itself."""
    return _tag_op(x) if tag and name in _MATMUL_INPUT_NAMES else x


@functools.cache
def _remat_context(policy: str):
    """`torch.utils.checkpoint.checkpoint` keywords for `policy`: none
    for "full" (keep only the inputs), else a selective-checkpoint
    context whose policy keeps the ops named above."""
    if policy == "full":
        return {}
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    flash = policy in ("flash", "names", "flash_dots")
    dots = policy in ("dots", "flash_dots")
    names = policy == "names"

    def keep(ctx, op, *args, **kwargs):
        if (flash and op in FWD_OPS or dots and op.overloadpacket in _DOTS
                or names and op == _TAG):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, keep)}


def _block(x, blk, cfg: GPTConfig, train: bool, seed, mesh=None):
    """(x, aux): the block's output and, with experts, its layer's MoE aux
    loss (None without). Under a mesh, `blk` holds this rank's shards of
    the layer, gathered here where the layout splits them over dp (so a
    checkpointed block gathers them again for its backward)."""
    if mesh is not None:
        blk = mesh.layer(blk)
    tag = _names_policy(cfg, train)
    h1 = _tagged(_layer_norm(x, blk["ln1"], cfg.norm_eps), "ln1_out", tag)
    x = x + _attention(h1, blk, cfg, train, seed, mesh)
    h2 = _tagged(_layer_norm(x, blk["ln2"], cfg.norm_eps), "ln2_out", tag)
    if cfg.n_experts:
        m, aux = _moe_mlp(h2, blk, cfg, mesh)
        return x + m, aux
    return x + _mlp(h2, blk, cfg, _body_dot, tag, mesh), None


def hidden_states(params, tokens, cfg: GPTConfig, *, train: bool = False,
                  generator: torch.Generator | None = None, mesh=None):
    """tokens (B, S) int -> final hidden states (B, S, D) in the compute
    dtype. The embedding sum is taken in f32, then cast (as JAX). Layers
    run as a Python loop (`scan_layers` has no effect); with cfg.remat in
    training each block is checkpointed under cfg.remat_policy
    (`_remat_context`). `generator` draws each layer's attention-dropout
    seed. MoE aux losses are dropped here (`_hidden_aux` keeps them).
    `mesh` is the sharded step's per-rank view (`_Shards`): params are then
    this rank's working shards and the result its rows of the hidden
    states (its sequence chunk under seq_parallel or cp)."""
    return _hidden_aux(params, tokens, cfg, train, generator, mesh)[0]


def _embed(params, tokens, cfg: GPTConfig, off: int = 0):
    """Token and (learned) position embeddings of tokens (B, S) at
    positions off.., summed in f32, then cast (as JAX)."""
    x = params["wte"][tokens.long()]
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][off:off + tokens.shape[1]]
    return x.to(cfg.dtype)


def _hidden_aux(params, tokens, cfg: GPTConfig, train: bool = False,
                generator: torch.Generator | None = None, mesh=None):
    """`hidden_states` and the MoE aux losses summed over layers (JAX's
    `hidden_states` pair); the sum is None without experts."""
    if mesh is not None:
        tokens = mesh.rows(tokens)
    x = _embed(params, tokens, cfg,
               0 if mesh is None else mesh.seq_offset(tokens.shape[1]))
    seeds = [None] * cfg.n_layer
    if train and cfg.dropout > 0.0 and generator is not None:
        seeds = torch.randint(0, 2 ** 62, (cfg.n_layer,), generator=generator,
                              device=generator.device).tolist()
    aux = None
    for i in range(cfg.n_layer):
        blk = _layer(params["blocks"], i)
        if cfg.remat and train:
            x, a = torch.utils.checkpoint.checkpoint(
                _block, x, blk, cfg, train, seeds[i], mesh,
                use_reentrant=False, **_remat_context(cfg.remat_policy))
        else:
            x, a = _block(x, blk, cfg, train, seeds[i], mesh)
        if a is not None:
            aux = a if aux is None else aux + a
    return _layer_norm(x, params["ln_f"], cfg.norm_eps), aux


def forward(params, tokens, cfg: GPTConfig, *, train: bool = False,
            generator: torch.Generator | None = None):
    """tokens (B, S) -> logits (B, S, V) in f32 (`_lm_head`)."""
    x = hidden_states(params, tokens, cfg, train=train, generator=generator)
    return _lm_head(x, params, cfg)


def _use_fused_ce(cfg: GPTConfig, rows: int) -> bool:
    """JAX's gate, unchanged: the fused kernels take no ragged shape there,
    and the two paths round differently, so the port fuses where JAX does."""
    if cfg.fused_ce != "on":
        return False
    return rows % 256 == 0 and cfg.vocab_size % 1024 == 0


def loss_fn(params, tokens, targets, cfg: GPTConfig, *, train: bool = False,
            generator: torch.Generator | None = None, mesh=None):
    """Mean token cross-entropy. Under `_use_fused_ce`: the fused linear
    cross-entropy (K8-K10) on the hidden states and the head weight in the
    compute dtype, whatever `logits_dtype` says, as JAX. Otherwise the LM
    head (a compute-dtype GEMM with an f32 result, or a compute-dtype
    result with logits_dtype="compute"), then logsumexp minus the gathered
    target logit on f32 logits. With experts, `moe_aux_weight` times the
    summed aux loss is added.

    Under a `mesh` (the sharded step's per-rank view, `_Shards`) the
    params are this rank's working shards and tokens its rows; the result
    is this rank's share of the global mean, the sum of its positions'
    losses over the global token count (the step sums the shares), and
    with experts its share of the aux term."""
    B, S = tokens.shape
    x, aux = _hidden_aux(params, tokens, cfg, train, generator, mesh)
    if mesh is None and _use_fused_ce(cfg, B * S):
        ce = fused_linear_cross_entropy(
            x.reshape(B * S, cfg.d_model), _head_w(params, cfg).to(cfg.dtype),
            targets.reshape(B * S))
    else:
        if cfg.logits_dtype == "compute":
            logits = torch.matmul(x, _head_w(params, cfg).to(cfg.dtype).T)
        else:
            logits = _lm_head(x, params, cfg)
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, -1)
        if mesh is not None:
            targets = mesh.rows(targets)
        tgt = logits32.gather(-1, targets.long()[..., None])[..., 0]
        ce = ((lse - tgt).mean() if mesh is None
              else (lse - tgt).sum() / mesh.global_rows(lse.numel()))
    if aux is None:
        return ce
    aux = cfg.moe_aux_weight * aux
    if mesh is None:
        return ce + aux
    # the aux is whole on every rank: its value joins the summed loss once
    # (a share a rank), its gradient on each rank is its own tokens' part
    # (`_Shards.moe_mean`)
    return ce + aux + aux.detach() * (1.0 / mesh.global_rows(1) - 1.0)


@functools.lru_cache(maxsize=32)
def make_eval_step(cfg: GPTConfig, *, pad_id: int | None = None):
    """Evaluation step: (params, tokens, targets) -> (summed token CE, token
    count), both f32 0-d tensors. Dropout is off (the config is replaced
    with dropout 0, as JAX does), the LM-head logits are f32, and positions
    whose TARGET equals `pad_id` are left out, so dataset-level perplexity
    is exact under ragged batching. Cached on (cfg, pad_id)."""
    ecfg = dataclasses.replace(cfg, dropout=0.0)

    @torch.no_grad()
    def step(params, tokens, targets):
        B, S = tokens.shape
        x = hidden_states(params, tokens, ecfg, train=False)
        logits = _lm_head(x, params, ecfg)
        lse = torch.logsumexp(logits, -1)
        tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
        per_pos = lse - tgt
        if pad_id is not None:
            w = (targets != pad_id).float()
            return (per_pos * w).sum(), w.sum()
        return per_pos.sum(), torch.tensor(float(B * S), device=lse.device)

    return step


def evaluate(params, cfg: GPTConfig, batches, *, pad_id: int | None = None):
    """Host loop over an iterable of (tokens, targets) batches (arrays or
    tensors, moved to the params' device) -> dict with the dataset-level
    mean token loss, perplexity and token count. One sync per batch."""
    step = make_eval_step(cfg, pad_id=pad_id)
    dev = params["wte"].device
    total = count = 0.0
    for tokens, targets in batches:
        s, n = step(params, torch.as_tensor(tokens, device=dev),
                    torch.as_tensor(targets, device=dev))
        total += float(s)
        count += float(n)
    if count == 0:
        raise ValueError("evaluate() received no tokens")
    loss = total / count
    return {"loss": loss, "perplexity": math.exp(min(loss, 700.0)),
            "tokens": int(count)}


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


# --------------------------------------------------------------------------
# the sharded train step (JAX's `make_sharded_train_step`): one process a
# rank, each running the step on its shards with explicit collectives


SHARDED_AXES = ("dp", "tp", "cp", "ep")
# the MoE's leaves: used on the MoE's routing tokens (`_Shards.moe_rows`)
_MOE_LEAVES = ("gate", "fc_in", "fc_in_b", "fc_out", "fc_out_b")


class _Shards:
    """One rank's view of the mesh inside the sharded step (what JAX's
    `mesh` argument stands for inside its program): each axis's group, size
    and this rank's coordinate, and how the working params are made from
    the rank's shards.

    Tokens are split over dp and cp everywhere, and also over tp in the
    norms, residuals and head under seq_parallel (`token_groups`); ep ranks
    hold the same tokens (JAX splits the batch over dp and cp only) except
    inside the MoE, whose routing tokens are split over dp, cp and ep and
    held alike by the tp ranks (`moe_groups`, `moe_rows`). Every leaf
    enters through `copy_to` over the axes whose ranks hold other tokens
    where it is used and that it is not split over, so its gradient is the
    sum of the ranks' contributions; a dp (FSDP) split is gathered where
    the weight is used (per layer inside the checkpointed block), its
    gradient reduce-scattered; wte and lm_head are gathered over tp for
    the embedding and the head. The tp region of each attention and MLP is
    entered and left by Megatron's conjugate ops, or by an all-gather and
    a reduce-scatter of the sequence under seq_parallel (`tp_in`,
    `tp_out`); an expert FFN's by the conjugate ops alone (`tp_enter`,
    `tp_leave`)."""

    def __init__(self, mesh, cfg: GPTConfig, shardings):
        from ..parallel.mesh import mesh_axis

        self.dp_group, self.dp, self.dp_rank = mesh_axis(mesh, "dp")
        self.tp_group, self.tp, self.tp_rank = mesh_axis(mesh, "tp")
        self.cp_group, self.cp, self.cp_rank = mesh_axis(mesh, "cp")
        self.ep_group, self.ep, self.ep_rank = mesh_axis(mesh, "ep")
        self.has_ep = "ep" in mesh.mesh_dim_names
        self.seq_tp = cfg.seq_parallel and self.tp > 1 and self.cp == 1
        self.token_groups = {"dp": self.dp_group, "cp": self.cp_group}
        if self.seq_tp:
            self.token_groups["tp"] = self.tp_group
        self.moe_groups = {"dp": self.dp_group, "cp": self.cp_group,
                           "ep": self.ep_group}
        self.moe_leaves = _MOE_LEAVES if cfg.n_experts else ()
        self.shardings = shardings
        self.blocks = shardings["blocks"]

    def enter(self, name: str, t, sh, key: str = ""):
        """The working form of a leaf from this rank's shard `t` (laid out
        by `sh`; `key` its name under "blocks"); its gradient reaches `t`
        summed as the layout needs."""
        from ..parallel.collectives import copy_to, gather

        split = {a for a in sh.spec if a is not None}
        groups = (self.moe_groups if key in self.moe_leaves
                  else self.token_groups)
        t = copy_to(t, [g for a, g in groups.items() if a not in split])
        d = sh.dim_of("dp")
        if d is not None and (name != "blocks" or d == 0):
            t = gather(t, d, self.dp_group)
        d = sh.dim_of("tp")
        if d is not None and name != "blocks":
            t = gather(t, d, self.tp_group,
                       "sum" if self.seq_tp else "slice")
        return t

    def working(self, params):
        """The working tree (`enter` on every leaf) of this rank's
        shards."""
        return {name: ({k: tree_map(functools.partial(self.enter, name,
                                                      key=k),
                                    v, self.blocks[k])
                        for k, v in sub.items()} if name == "blocks"
                       else tree_map(functools.partial(self.enter, name),
                                     sub, self.shardings[name]))
                for name, sub in params.items()}

    def layer(self, blk):
        """One layer's block params with their dp splits gathered (a split
        of the layer axis itself was gathered by `enter`)."""
        from ..parallel.collectives import gather

        def leaf(t, sh):
            d = sh.dim_of("dp")
            return gather(t, d - 1, self.dp_group) if d else t

        return tree_map(leaf, blk, self.blocks)

    def tp_in(self, x):
        from ..parallel.collectives import copy_to, gather

        if self.seq_tp:
            return gather(x, 1, self.tp_group)
        return copy_to(x, [self.tp_group])

    def tp_out(self, y):
        from ..parallel.collectives import reduce_from, scatter

        if self.seq_tp:
            return scatter(y, 1, self.tp_group)
        return reduce_from(y, self.tp_group)

    def tp_enter(self, x):
        """x, held alike by the tp ranks, into a tp-split product."""
        from ..parallel.collectives import copy_to

        return copy_to(x, [self.tp_group])

    def tp_leave(self, y):
        """A tp-split product's partial sums, summed over tp."""
        from ..parallel.collectives import reduce_from

        return reduce_from(y, self.tp_group)

    def moe_rows(self, x):
        """The MoE's routing tokens from this rank's rows x (B, S, D): the
        whole sequence over tp under seq_parallel, then this rank's ep
        slice of it (JAX's P("dp", "ep") tokens), held alike by the tp
        ranks."""
        from ..parallel.collectives import gather, split

        if self.seq_tp:
            x = gather(x, 1, self.tp_group, "slice")
        return split(x, 1, self.ep_group)

    def moe_back(self, y):
        """The MoE's output back in this rank's rows (`moe_rows` undone)."""
        from ..parallel.collectives import gather, split

        y = gather(y, 1, self.ep_group, "slice")
        return split(y, 1, self.tp_group) if self.seq_tp else y

    def moe_mean(self, t):
        """The mean of a routing statistic over the routing shards (dp,
        cp, ep): all-reduced forward; the gradient each rank takes is its
        own tokens' part (`loss_fn` adds the aux value once)."""
        from ..parallel.collectives import reduce_from

        n = 1
        for g, size in ((self.dp_group, self.dp), (self.cp_group, self.cp),
                        (self.ep_group, self.ep)):
            t = reduce_from(t, g)
            n *= size
        return t / n

    def all_experts(self, blk):
        """A layer's expert leaves with an ep split gathered (their
        gradients reduce-scattered back)."""
        from ..parallel.collectives import gather

        if self.ep == 1:
            return blk
        out = dict(blk)
        for k in _MOE_LEAVES[1:]:
            if k in blk and self.blocks[k].dim_of("ep") is not None:
                out[k] = gather(blk[k], self.blocks[k].dim_of("ep") - 1,
                                self.ep_group)
        return out

    def rows(self, t):
        """This rank's sequence chunk of a (B, S) batch it holds over tp."""
        return t.chunk(self.tp, 1)[self.tp_rank] if self.seq_tp else t

    def seq_offset(self, S: int) -> int:
        """Global position of this rank's first row (S rows a rank)."""
        if self.cp > 1:
            return self.cp_rank * S
        return self.tp_rank * S if self.seq_tp else 0

    def cp_offset(self, S: int) -> int:
        return self.cp_rank * S

    def seed(self, seed: int) -> int:
        """Dropout seeds decorrelated across shards (JAX's offsets): local
        batch and head indices repeat on every rank."""
        return seed + self.dp_rank * 1000003 + self.tp_rank * 7919

    def global_rows(self, n: int) -> int:
        """Positions over all ranks, this rank holding n of them."""
        return n * math.prod(
            {"dp": self.dp, "cp": self.cp, "tp": self.tp}[a]
            for a in self.token_groups)

    def reduce_loss(self, loss):
        from ..parallel.collectives import all_reduce

        return all_reduce(loss.clone(), list(self.token_groups.values()))


def _check_sharded(mesh, cfg: GPTConfig) -> None:
    names = mesh.mesh_dim_names
    extra = [a for a in names if a not in SHARDED_AXES]
    if extra:
        raise NotImplementedError(
            f"mesh axes {extra}: the sharded step takes dp, tp, cp and ep; "
            f"a pp axis trains through make_pipelined_train_step or "
            f"make_pipelined_train_step_1f1b, as JAX's (a pp axis in the "
            f"sharded step: ROADMAP.md queue 1 item 5)")
    tp = mesh.size(names.index("tp")) if "tp" in names else 1
    for what, n in (("n_head", cfg.n_head), ("d_model", cfg.d_model),
                    ("d_ff", cfg.d_ff), ("qkv width", _qkv_width(cfg))):
        if n % tp:
            raise ValueError(f"tp {tp} does not divide {what} {n}")
    ep = mesh.size(names.index("ep")) if "ep" in names else 1
    if cfg.n_experts and cfg.n_experts % ep:
        raise ValueError(f"ep {ep} does not divide n_experts "
                         f"{cfg.n_experts}")


def make_sharded_train_step(mesh, cfg: GPTConfig, *, fsdp: bool = False,
                            fsdp_min_size: int = 1 << 16):
    """The train step sharded over `mesh` (a DeviceMesh with axes among dp,
    tp, cp and ep): the batch split over dp, Megatron column and row splits
    over tp, the sequence over tp in the residual stream under
    cfg.seq_parallel, over cp with attention on the ring, and with experts
    their expert axis over ep (moe_impl "ep": the all-to-all dispatch,
    `_moe_mlp_ep`; ep ranks hold the same tokens outside the MoE, as JAX's
    batch is split over dp and cp only). It computes what
    `make_train_step` computes (Adam, no clipping or accumulation, as
    JAX's sharded step), with the fused CE off; the MoE's capacity counts
    each rank's routing tokens.

    Returns step(params, opt_state, tokens, targets, lr, generator=None)
    -> (params, opt_state, loss), run by every rank. params and the Adam
    moments come back as DTensors in the stated layout (`param_shardings`,
    or with `fsdp=True` `fsdp_param_shardings(min_size=fsdp_min_size)`:
    ZeRO-3, params, gradients and moments at 1/dp a rank) and are updated
    in place from the second call on; plain tensors passed in (the same
    full value on every rank) or DTensors in another layout are placed
    first. tokens and targets are the global (B, S) batch, the same on
    every rank, or DTensors (`make_global_batch`). The loss is the global
    mean, the same 0-d tensor on every rank. Each rank runs the loss and
    its gradient on its shards with the collectives of `_Shards`; the
    flash kernels run on each rank's heads and rows (K1/K2 on whole kv
    groups, K5-K7 on the split layout and on every ring hop). A pp axis
    is refused: pipelines train through `make_pipelined_train_step` and
    `make_pipelined_train_step_1f1b`."""
    from ..parallel.mesh import NamedSharding, shard_map_compat

    if cfg.fused_ce != "off":
        cfg = dataclasses.replace(cfg, fused_ce="off")
    _check_sharded(mesh, cfg)
    names = mesh.mesh_dim_names
    shard = (fsdp_param_shardings(mesh, cfg, min_size=fsdp_min_size)
             if fsdp else param_shardings(mesh, cfg))
    rep = NamedSharding(mesh, ())
    opt_shard = {"m": shard, "v": shard, "step": rep}
    batch_axes = [a if a in names else None for a in ("dp", "cp")]
    data = NamedSharding(mesh, batch_axes)
    view = _Shards(mesh, cfg, shard)
    split = {a: mesh.size(names.index(a)) for a in names}

    def local_step(params, opt_state, tokens, targets, lr, generator):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        work = view.working(tree_unflatten(params, leaves))
        loss = loss_fn(work, tokens, targets, cfg, train=True,
                       generator=generator, mesh=view)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            loss = view.reduce_loss(loss.detach())
        params, opt_state = adam_update(
            params, tree_unflatten(params, list(grads)), opt_state, lr)
        return params, opt_state, loss

    mapped = shard_map_compat(
        local_step, mesh=mesh,
        in_specs=(shard, opt_shard, data, data, None, None),
        out_specs=(shard, opt_shard, None))

    def step(params, opt_state, tokens, targets, lr, generator=None):
        B, S = tokens.shape
        moe = "ep" if cfg.n_experts else ""
        for a, n, what in (("dp", B, "batch"), ("cp", S, "sequence"),
                           ("tp" if view.seq_tp else "", S, "sequence"),
                           (moe, S // split.get("cp", 1), "MoE's rows")):
            if n % split.get(a, 1):
                raise ValueError(f"{a} {split[a]} does not divide the "
                                 f"{what} {n}")
        return mapped(params, opt_state, tokens, targets, lr, generator)

    return step


# --------------------------------------------------------------------------
# the pipelined train steps (JAX's `make_pipelined_train_step` and
# `make_pipelined_train_step_1f1b`): the stacked blocks split into stages
# over a pp axis, one process a stage, or every stage of a virtual
# pipeline in one process


def _pipeline_parts(mesh, cfg: GPTConfig, n_micro: int, n_stages):
    """(stages, reshape_params, the staged layout's shardings or None)."""
    from ..parallel.mesh import NamedSharding, place
    from ..parallel.pipeline import Stages

    st = Stages(mesh, "pp", n_stages)
    P = st.n
    if not cfg.tied_head:
        raise ValueError("pipeline-parallel steps require tied_head=True "
                         "(embedding/head run replicated on one tensor)")
    if cfg.n_layer % P:
        raise ValueError("n_layer must be divisible by the pp stage count")
    if n_micro < 1:
        raise ValueError(f"n_micro {n_micro}: want >= 1")
    per_stage = cfg.n_layer // P
    shard = None
    if mesh is not None:
        rep = NamedSharding(mesh, ())
        shard = {"wte": rep, "ln_f": ({"scale": rep, "bias": rep}
                                      if cfg.norm == "layer"
                                      else {"scale": rep}),
                 "blocks": tree_map(lambda _: NamedSharding(mesh, ("pp",)),
                                    param_shapes(cfg)["blocks"])}
        if cfg.pos_emb == "learned":
            shard["wpe"] = rep

    def reshape_params(params):
        """The staged layout: block leaves (P, n_layer / P, ...), on a mesh
        each rank holding its own stage (DTensors split over pp; wte, wpe
        and ln_f replicated)."""
        staged = dict(params)
        staged["blocks"] = tree_map(
            lambda l: l.reshape((P, per_stage) + tuple(l.shape[1:])),
            params["blocks"])
        if shard is None:
            return staged
        return tree_map(lambda t, sh: place(t, sh, src_data_rank=None),
                        staged, {k: shard[k] for k in staged})

    return st, reshape_params, shard


def _stage_layers(cfg: GPTConfig, stage_blocks, x):
    """One stage's layers (`_block`, train=False as JAX's: no dropout, no
    remat; the flash ops K1/K2 or K5-K7) -> (y, the MoE aux summed, f32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = tree_leaves(stage_blocks)[0].shape[0]
    for i in range(n):
        x, a = _block(x, _layer(stage_blocks, i), cfg, False, None)
        if a is not None:
            aux = aux + a
    return x, aux


def _head_ce(y, targets, lp, cfg: GPTConfig):
    """ln_f, the tied head (f32 logits) and the mean token CE: JAX's
    pipelined head (the composite logsumexp)."""
    y = _layer_norm(y, lp["ln_f"], cfg.norm_eps)
    logits32 = _lm_head(y, lp, cfg).float()
    tgt = logits32.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits32, -1) - tgt).mean()


def _staged_step(mesh, cfg: GPTConfig, shard, loss_grads):
    """step(staged, opt_state, tokens, targets, lr) -> (staged, opt_state,
    loss) from loss_grads(staged, tokens, targets) -> (loss, grads): Adam
    in place; on a mesh run by every rank on its shards (`shard_map_compat`;
    DTensors in, DTensors out, as `make_sharded_train_step`'s)."""
    from ..parallel.mesh import NamedSharding, shard_map_compat

    def local_step(staged, opt_state, tokens, targets, lr):
        loss, grads = loss_grads(staged, tokens, targets)
        staged, opt_state = adam_update(staged, grads, opt_state, lr)
        return staged, opt_state, loss

    if mesh is None:
        return local_step
    rep = NamedSharding(mesh, ())

    def step(staged, opt_state, tokens, targets, lr):
        sh = {k: shard[k] for k in staged}
        osh = {"m": sh, "v": sh, "step": rep}
        return shard_map_compat(
            local_step, mesh=mesh, in_specs=(sh, osh, None, None, None),
            out_specs=(sh, osh, None))(staged, opt_state, tokens, targets,
                                       lr)

    return step


def _micro(t, n_micro: int):
    B = t.shape[0]
    if B % n_micro:
        raise ValueError(f"n_micro {n_micro} does not divide the batch {B}")
    return t.reshape((n_micro, B // n_micro) + tuple(t.shape[1:]))


def make_pipelined_train_step(mesh, cfg: GPTConfig, n_micro: int, *,
                              n_stages: int | None = None):
    """Pipeline-parallel train step over the `pp` axis of `mesh` (JAX's
    `make_pipelined_train_step`): the stacked blocks split into n_stages =
    the pp size stages of n_layer / n_stages layers, the batch into
    `n_micro` microbatches through the GPipe schedule
    (`parallel.pipeline.pipeline_forward`), differentiated through it.
    Each rank runs its stage (K1 forward, K2 backward for each of its
    layers and live microbatches) and, on the outputs every stage
    receives, the replicated embedding, ln_f, tied head and CE; MoE aux
    losses are dropped (use moe_aux_weight 0, or the 1F1B step). With
    `mesh=None`, one process runs every stage of a virtual pipeline of
    `n_stages`.

    Returns (step_fn, reshape_params): reshape_params turns
    `init_params`' tree into the staged layout (`_pipeline_parts`), and
    step_fn(staged, opt_state, tokens, targets, lr) -> (staged,
    opt_state, loss) takes Adam's step (in place; the moments in the
    staged layout, `opt_init` of the staged tree) on the global batch
    (the same on every rank). The loss is the batch's mean token CE."""
    from ..parallel.pipeline import pipeline_forward

    st, reshape_params, shard = _pipeline_parts(mesh, cfg, n_micro,
                                                n_stages)
    pipe = pipeline_forward(lambda blk, x: _stage_layers(cfg, blk, x)[0],
                            mesh, n_stages=st.n)

    def loss_grads(staged, tokens, targets):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(staged)]
        p = tree_unflatten(staged, leaves)
        B, S = tokens.shape
        micro = _micro(_embed(p, tokens, cfg), n_micro)
        y = pipe(p["blocks"], micro).reshape(B, S, cfg.d_model)
        loss = _head_ce(y, targets, p, cfg)
        return loss.detach(), tree_unflatten(
            staged, list(torch.autograd.grad(loss, leaves)))

    return _staged_step(mesh, cfg, shard, loss_grads), reshape_params


def make_pipelined_train_step_1f1b(mesh, cfg: GPTConfig, n_micro: int, *,
                                   n_stages: int | None = None):
    """Pipeline-parallel train step with the 1F1B schedule (JAX's
    `make_pipelined_train_step_1f1b`, `parallel.pipeline.
    pipeline_train_1f1b`): the activation footprint O(stages), not
    O(microbatches) (each stage keeps its inputs and reruns its forward
    at backward time: K1 twice, K2 once a layer and microbatch); MoE aux
    losses join the objective at moe_aux_weight (aux_weight / n_micro x
    the aux summed over stages and microbatches); the tied wte takes the
    head's gradient from the last stage and the embedding's from the
    microbatch inputs' cotangents. The loss is the mean over microbatches
    of their mean token CE, plus the aux term. Returns (step_fn,
    reshape_params) as `make_pipelined_train_step`."""
    from ..parallel.pipeline import pipeline_train_1f1b

    st, reshape_params, shard = _pipeline_parts(mesh, cfg, n_micro,
                                                n_stages)
    pipe = pipeline_train_1f1b(
        lambda blk, x: _stage_layers(cfg, blk, x),
        lambda y, t, lp: _head_ce(y, t, lp, cfg), mesh,
        aux_weight=cfg.moe_aux_weight, n_stages=st.n)

    def loss_grads(staged, tokens, targets):
        lp = {"wte": staged["wte"], "ln_f": staged["ln_f"]}
        emb = {k: staged[k] for k in ("wte", "wpe") if k in staged}
        leaves = [t.detach().requires_grad_() for t in tree_leaves(emb)]
        with torch.enable_grad():
            micro_x = _micro(_embed(tree_unflatten(emb, leaves), tokens,
                                    cfg), n_micro)
        loss, gblocks, gloss, dmicro = pipe(
            staged["blocks"], lp, micro_x.detach(), _micro(targets, n_micro))
        gemb = tree_unflatten(emb, list(torch.autograd.grad(
            micro_x, leaves, dmicro.to(micro_x.dtype))))
        grads = {"wte": gloss["wte"] + gemb["wte"], "ln_f": gloss["ln_f"],
                 "blocks": gblocks}
        if "wpe" in gemb:
            grads["wpe"] = gemb["wpe"]
        return loss, {k: grads[k] for k in staged}

    return _staged_step(mesh, cfg, shard, loss_grads), reshape_params


def flops_per_token(cfg: GPTConfig, seq: int) -> float:
    """Training FLOPs/token (fwd+bwd ~ 3x fwd; causal attention counted at
    S/2 average keys, the PaLM convention), as the JAX package counts."""
    p_block = 3 * cfg.d_model**2 + cfg.d_model**2 + 2 * cfg.d_model * cfg.d_ff
    p_matmul = cfg.n_layer * p_block + cfg.vocab_size * cfg.d_model
    attn = cfg.n_layer * 2 * seq * cfg.d_model
    return 3.0 * (2.0 * p_matmul + 2.0 * attn)


# --------------------------------------------------------------------------
# the define-by-run tier's GPTs (`build_var_model_batched`, `build_var_model`)
#
# Weights are drawn from `np.random` in the JAX builders' order and with
# their casts, so one `np.random.seed` gives both packages the same
# weights; `device=None` means `config.device`.


def build_var_model_batched(cfg: GPTConfig, batch: int, seq: int,
                            dropout_status=None, device=None):
    """Batched GPT block stack on the Var ops: a fused qkv `matmul`, the
    `flash_attention` Var op (on the card the K1 forward and fused K2
    backward kernels), primitive-op LayerNorm and SiLU MLP, parameters in
    ``cfg.dtype`` and an f32 loss head via `astype`. Returns (params,
    forward_fn), forward_fn mapping float ids (B, S) to f32 logits
    (B, S, V)."""
    import neuronika_tpu_torch as nk

    d, H, L = cfg.d_model, cfg.n_head, cfg.n_layer
    scale = 0.02
    dt = cfg.dtype

    def p(shape):
        return nk.from_ndarray(
            scale * np.random.randn(*shape).astype("float32"), dtype=dt,
            device=device).requires_grad()

    def ones(n):
        return nk.ones(n, dt, device).requires_grad()

    def zeros(n):
        return nk.zeros(n, dt, device).requires_grad()

    wte = p((cfg.vocab_size, d))
    wpe = p((seq, d))
    blocks = []
    for _ in range(L):
        blocks.append({
            "g1": ones(d), "b1": zeros(d), "g2": ones(d), "b2": zeros(d),
            # packed group-major qkv (MHA: groups of [q_h | k_h | v_h])
            "wqkv": p((d, 3 * d)), "wo": p((d, d)),
            "w1": p((d, cfg.d_ff)), "b1m": zeros(cfg.d_ff),
            "w2": p((cfg.d_ff, d)), "b2m": zeros(d),
        })
    gf, bf = ones(d), zeros(d)
    params = [wte, wpe, gf, bf]
    for blk in blocks:
        params.extend(blk.values())

    def layer_norm(x, gamma, beta):
        mu = x.mean(2)
        centered = x - mu
        var = (centered * centered).mean(2)
        return centered / (var + 1e-5).sqrt() * gamma + beta

    def attention(x, blk):
        qkv = x.matmul(blk["wqkv"])
        ctx = qkv.flash_attention(
            H, causal=True, dropout=cfg.dropout,
            status=dropout_status if cfg.dropout > 0.0 else None,
            block=cfg.flash_block)
        return ctx.matmul(blk["wo"])

    def mlp(x, blk):
        h = x.matmul(blk["w1"]) + blk["b1m"]
        h = h.sigmoid() * h  # SiLU from primitive ops
        return h.matmul(blk["w2"]) + blk["b2m"]

    def fwd(ids):
        x = wte.embed(ids) + wpe
        for blk in blocks:
            x = x + attention(layer_norm(x, blk["g1"], blk["b1"]), blk)
            x = x + mlp(layer_norm(x, blk["g2"], blk["b2"]), blk)
        x = layer_norm(x, gf, bf)
        return x.matmul(wte.t()).astype("float32")

    return params, fwd


def build_var_model(cfg: GPTConfig, batch: int, seq: int, device=None):
    """The GPT-2 block stack from the reference's 2-d primitive ops (`mm`,
    `softmax`, `chunks`, `cat`, elementwise), one (S, .) sequence per graph,
    heads chunked along the feature axis, causality by an additive mask, in
    f32. With kernels on, every `mm` runs K3 and every softmax K4. Returns
    (params, forward_fn), forward_fn mapping float ids (S,) to logits
    (S, V)."""
    import neuronika_tpu_torch as nk

    d, H, L = cfg.d_model, cfg.n_head, cfg.n_layer
    hd = d // H
    scale = 0.02

    def p(shape):
        return nk.from_ndarray(scale * _np_randn(shape),
                               device=device).requires_grad()

    def ones(n):
        return nk.ones(n, device=device).requires_grad()

    def zeros(n):
        return nk.zeros(n, device=device).requires_grad()

    wte = p((cfg.vocab_size, d))
    wpe = p((seq, d))
    blocks = []
    for _ in range(L):
        blocks.append({
            "g1": ones(d), "b1": zeros(d), "g2": ones(d), "b2": zeros(d),
            "wq": p((d, d)), "wk": p((d, d)), "wv": p((d, d)), "wo": p((d, d)),
            "w1": p((d, cfg.d_ff)), "b1m": zeros(cfg.d_ff),
            "w2": p((cfg.d_ff, d)), "b2m": zeros(d),
        })
    gf, bf = ones(d), zeros(d)
    params = [wte, wpe, gf, bf]
    for blk in blocks:
        params.extend(blk.values())

    # causal additive mask (S, S): 0 on and below the diagonal, -1e9 above
    mask = nk.from_ndarray(np.where(np.tril(np.ones((seq, seq))) > 0, 0.0,
                                    -1e9).astype(np.float32), device=device)

    def layer_norm(x, gamma, beta):
        mu = x.mean(1)
        centered = x - mu
        var = (centered * centered).mean(1)
        return centered / (var + 1e-5).sqrt() * gamma + beta

    def attention(x, blk):
        q, k, v = x.mm(blk["wq"]), x.mm(blk["wk"]), x.mm(blk["wv"])
        qs, ks, vs = (t.chunks((seq, hd)) for t in (q, k, v))
        heads = []
        for h in range(H):
            att = qs[h].mm(ks[h].t()) * (1.0 / math.sqrt(hd)) + mask
            heads.append(att.softmax(1).mm(vs[h]))
        ctx = heads[0].cat(heads[1:], 1) if H > 1 else heads[0]
        return ctx.mm(blk["wo"])

    def mlp(x, blk):
        h = ((x.mm(blk["w1"]) + blk["b1m"]).sigmoid()
             * (x.mm(blk["w1"]) + blk["b1m"]))
        return h.mm(blk["w2"]) + blk["b2m"]

    def fwd(ids):
        x = wte.embed(ids) + wpe
        for blk in blocks:
            x = x + attention(layer_norm(x, blk["g1"], blk["b1"]), blk)
            x = x + mlp(layer_norm(x, blk["g2"], blk["b2"]), blk)
        x = layer_norm(x, gf, bf)
        return x.mm(wte.t())

    return params, fwd


def _np_randn(shape):
    return np.random.randn(*shape).astype(np.float32)


def load_var_params(params, arrays) -> None:
    """Assign numpy arrays (e.g. `[np.asarray(p.data()) for p in
    jax_params]`, bfloat16 included) to a Var builder's parameters, in
    order, checking each shape and dtype."""
    from ..ops.functional import dtype_name

    if len(params) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for {len(params)} params")
    for i, (p, a) in enumerate(zip(params, arrays)):
        a = np.asarray(a)
        if a.shape != p.shape:
            raise ValueError(f"param {i}: shape {a.shape}, want {p.shape}")
        if a.dtype.name != dtype_name(p.dtype):
            raise TypeError(f"param {i}: dtype {a.dtype.name}, want "
                            f"{dtype_name(p.dtype)}")
        p.assign(a)
