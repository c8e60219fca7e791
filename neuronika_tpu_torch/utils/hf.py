"""Hugging Face checkpoint import and export (counterpart of
`neuronika_tpu/utils/hf.py`): `transformers` causal-LM models <-> the
port's params trees and `GPTConfig`.

`from_huggingface(model)` converts a loaded `GPT2LMHeadModel`,
`LlamaForCausalLM` or `MistralForCausalLM` (any size) into the stacked-
layer layout `models/transformer.py` trains and serves. It reads only
`model.config` and `model.state_dict()`, so it needs no `transformers`
import: any object with those two (a config namespace and a dict of
tensors) converts, on a machine without the package too. The exporters
build `transformers` models and import the package when called.

The conversions are JAX's, in torch:
* GPT-2's `Conv1D` stores weights (in, out), as here; Llama's
  `nn.Linear` stores (out, in) and is transposed;
* the packed qkv projection here is kv-group-major (`_unpack_qkv`): group
  g packs [q_{gG} .. q_{gG+G-1} | k_g | v_g], where HF keeps head-major
  q, k and v projections, kv head g serving q heads [gG, (g+1)G);
  `_pack_qkv` is that permutation and `_unpack_qkv_t` its inverse;
* rotary positions use the half-split convention on both sides, so no
  row shuffle; `rope_theta`, `rms_norm_eps` and Mistral's
  `sliding_window` (cfg.window) ride the config.
Imported params are f32 (the training convention) on `device`, by
default `config.device`; `dtype` sets the compute dtype only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve

__all__ = ["from_huggingface", "from_hf_gpt2", "from_hf_llama",
           "to_huggingface", "to_hf_gpt2", "to_hf_llama"]


def _f32(t, dev):
    return t.detach().to(dev, torch.float32)


def _pack_qkv(q, k, v, H: int, KV: int, hd: int):
    """Head-major q (D, H hd) and k, v (D, KV hd) -> kv-group-major packed
    (D, W). Bias rows too (D = 1)."""
    D = q.shape[0]
    G = H // KV
    return torch.cat([q.reshape(D, KV, G, hd), k.reshape(D, KV, 1, hd),
                      v.reshape(D, KV, 1, hd)], 2).reshape(
                          D, KV * (G + 2) * hd)


def _unpack_qkv_t(w, H: int, KV: int, hd: int):
    """Packed (D, W) -> head-major q (D, H hd), k and v (D, KV hd):
    `_pack_qkv`'s exact inverse (bias rows too)."""
    D = w.shape[0]
    G = H // KV
    t = w.reshape(D, KV, G + 2, hd)
    return (t[:, :, :G].reshape(D, H * hd), t[:, :, G].reshape(D, KV * hd),
            t[:, :, G + 1].reshape(D, KV * hd))


def from_hf_gpt2(model, *, dtype: Any = torch.bfloat16,
                 device=None) -> Tuple[Dict, Any]:
    """GPT2LMHeadModel -> (params, GPTConfig): learned positions,
    LayerNorm, GELU (GPT-2's `gelu_new` is the tanh form), biases, tied
    head."""
    from ..models.transformer import GPTConfig

    dev = resolve(device)
    c = model.config
    sd = model.state_dict()
    H = c.n_head
    hd = c.n_embd // H
    cfg = GPTConfig(
        vocab_size=c.vocab_size, n_layer=c.n_layer, n_head=H,
        d_model=c.n_embd, d_ff=c.n_inner or 4 * c.n_embd,
        max_seq=c.n_positions, pos_emb="learned", norm="layer",
        norm_eps=c.layer_norm_epsilon, mlp="gelu", bias=True,
        tied_head=True, dropout=0.0, dtype=dtype)

    def g(name):
        return _f32(sd[f"transformer.{name}"], dev)

    def stack(fn):
        return torch.stack([fn(f"h.{i}") for i in range(c.n_layer)])

    def qkv(p, name):
        w = g(f"{p}.attn.c_attn.{name}")
        w = w if w.dim() == 2 else w[None]              # bias: one row
        packed = _pack_qkv(*w.chunk(3, dim=1), H, H, hd)
        return packed if name == "weight" else packed[0]

    params = {
        "wte": g("wte.weight"),
        "wpe": g("wpe.weight"),
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        "blocks": {
            "ln1": {"scale": stack(lambda p: g(f"{p}.ln_1.weight")),
                    "bias": stack(lambda p: g(f"{p}.ln_1.bias"))},
            "ln2": {"scale": stack(lambda p: g(f"{p}.ln_2.weight")),
                    "bias": stack(lambda p: g(f"{p}.ln_2.bias"))},
            "qkv": stack(lambda p: qkv(p, "weight")),
            "qkv_b": stack(lambda p: qkv(p, "bias")),
            "proj": stack(lambda p: g(f"{p}.attn.c_proj.weight")),
            "proj_b": stack(lambda p: g(f"{p}.attn.c_proj.bias")),
            "fc_in": stack(lambda p: g(f"{p}.mlp.c_fc.weight")),
            "fc_in_b": stack(lambda p: g(f"{p}.mlp.c_fc.bias")),
            "fc_out": stack(lambda p: g(f"{p}.mlp.c_proj.weight")),
            "fc_out_b": stack(lambda p: g(f"{p}.mlp.c_proj.bias")),
        },
    }
    return params, cfg


def from_hf_llama(model, *, dtype: Any = torch.bfloat16,
                  device=None) -> Tuple[Dict, Any]:
    """LlamaForCausalLM / MistralForCausalLM -> (params, GPTConfig):
    RMSNorm, rotary positions, SwiGLU, grouped attention where the model
    has fewer kv heads, no biases; Mistral's `sliding_window` is
    cfg.window."""
    from ..models.transformer import GPTConfig

    dev = resolve(device)
    c = model.config
    sd = model.state_dict()
    H = c.num_attention_heads
    KV = getattr(c, "num_key_value_heads", None) or H
    hd = c.hidden_size // H
    tied = bool(getattr(c, "tie_word_embeddings", False))
    window = getattr(c, "sliding_window", None) or 0
    cfg = GPTConfig(
        vocab_size=c.vocab_size, n_layer=c.num_hidden_layers, n_head=H,
        n_kv_head=0 if KV == H else KV, d_model=c.hidden_size,
        d_ff=c.intermediate_size, max_seq=c.max_position_embeddings,
        pos_emb="rope", rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        norm="rms", norm_eps=c.rms_norm_eps, mlp="swiglu", bias=False,
        tied_head=tied, window=int(window), dropout=0.0, dtype=dtype)

    def lin(name):      # nn.Linear's (out, in) -> (in, out)
        return _f32(sd[name], dev).T

    def stack(fn):
        return torch.stack([fn(f"model.layers.{i}")
                            for i in range(cfg.n_layer)]).contiguous()

    params = {
        "wte": _f32(sd["model.embed_tokens.weight"], dev),
        "ln_f": {"scale": _f32(sd["model.norm.weight"], dev)},
        "blocks": {
            "ln1": {"scale": stack(lambda p: _f32(
                sd[f"{p}.input_layernorm.weight"], dev))},
            "ln2": {"scale": stack(lambda p: _f32(
                sd[f"{p}.post_attention_layernorm.weight"], dev))},
            "qkv": stack(lambda p: _pack_qkv(
                lin(f"{p}.self_attn.q_proj.weight"),
                lin(f"{p}.self_attn.k_proj.weight"),
                lin(f"{p}.self_attn.v_proj.weight"), H, KV, hd)),
            "proj": stack(lambda p: lin(f"{p}.self_attn.o_proj.weight")),
            "fc_gate": stack(lambda p: lin(f"{p}.mlp.gate_proj.weight")),
            "fc_in": stack(lambda p: lin(f"{p}.mlp.up_proj.weight")),
            "fc_out": stack(lambda p: lin(f"{p}.mlp.down_proj.weight")),
        },
    }
    if not tied:
        params["lm_head"] = _f32(sd["lm_head.weight"], dev)
    return params, cfg


_IMPORTERS = {"gpt2": from_hf_gpt2, "llama": from_hf_llama,
              "mistral": from_hf_llama}


def from_huggingface(model, *, dtype: Any = torch.bfloat16, device=None):
    """A loaded `transformers` causal LM -> (params, cfg), by
    `model.config.model_type` ("gpt2", "llama" or "mistral"); the result
    goes straight into `forward`, `make_train_step`, `make_generate`, LoRA
    and the serving tiers."""
    mt = getattr(model.config, "model_type", None)
    fn = _IMPORTERS.get(mt)
    if fn is None:
        raise ValueError(f"unsupported HF model_type {mt!r}; supported: "
                         f"{sorted(_IMPORTERS)}")
    return fn(model, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# export: params trees -> `transformers` models (the importers' inverse)


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError("exporting to Hugging Face needs the "
                          "`transformers` package, which is not "
                          "installed") from e
    return transformers


def _cpu(t):
    return t.detach().to("cpu", torch.float32).contiguous()


def _require(cfg, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"cannot export this config to HF: {what} "
                         f"(cfg: {cfg})")


def to_hf_gpt2(params, cfg) -> Any:
    """params + GPTConfig of the GPT-2 family (learned positions,
    LayerNorm, gelu, biases, tied head) -> a `GPT2LMHeadModel` on the CPU
    with the same logits (f32). Save with `model.save_pretrained(dir)`."""
    _require(cfg, cfg.pos_emb == "learned" and cfg.norm == "layer"
             and cfg.mlp == "gelu" and cfg.bias and cfg.tied_head,
             "GPT-2 export needs learned positions + LayerNorm + gelu + "
             "biases + tied head (use to_hf_llama for the llama family)")
    _require(cfg, not cfg.n_experts, "MoE blocks have no HF GPT-2 form")
    _require(cfg, not cfg.n_kv_head, "GPT-2 has no grouped-query attention")
    transformers = _transformers()
    H = cfg.n_head
    hd = cfg.d_model // H
    hc = transformers.GPT2Config(
        vocab_size=cfg.vocab_size, n_positions=cfg.max_seq,
        n_embd=cfg.d_model, n_layer=cfg.n_layer, n_head=H,
        n_inner=cfg.d_ff, layer_norm_epsilon=cfg.norm_eps,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    model = transformers.GPT2LMHeadModel(hc).eval()
    sd = model.state_dict()
    b = params["blocks"]

    def put(name, val):
        sd[f"transformer.{name}"] = _cpu(val)

    put("wte.weight", params["wte"])
    put("wpe.weight", params["wpe"])
    put("ln_f.weight", params["ln_f"]["scale"])
    put("ln_f.bias", params["ln_f"]["bias"])
    for i in range(cfg.n_layer):
        p = f"h.{i}"
        put(f"{p}.ln_1.weight", b["ln1"]["scale"][i])
        put(f"{p}.ln_1.bias", b["ln1"]["bias"][i])
        put(f"{p}.ln_2.weight", b["ln2"]["scale"][i])
        put(f"{p}.ln_2.bias", b["ln2"]["bias"][i])
        put(f"{p}.attn.c_attn.weight",
            torch.cat(_unpack_qkv_t(_cpu(b["qkv"][i]), H, H, hd), 1))
        put(f"{p}.attn.c_attn.bias", torch.cat(
            _unpack_qkv_t(_cpu(b["qkv_b"][i])[None], H, H, hd), 1)[0])
        put(f"{p}.attn.c_proj.weight", b["proj"][i])
        put(f"{p}.attn.c_proj.bias", b["proj_b"][i])
        put(f"{p}.mlp.c_fc.weight", b["fc_in"][i])
        put(f"{p}.mlp.c_fc.bias", b["fc_in_b"][i])
        put(f"{p}.mlp.c_proj.weight", b["fc_out"][i])
        put(f"{p}.mlp.c_proj.bias", b["fc_out_b"][i])
    sd["lm_head.weight"] = _cpu(params["wte"])       # tied
    model.load_state_dict(sd)
    return model


def to_hf_llama(params, cfg) -> Any:
    """params + GPTConfig of the llama family (rotary positions, RMSNorm,
    SwiGLU, no biases) -> a `LlamaForCausalLM` on the CPU, or a
    `MistralForCausalLM` when cfg.window is set, with the same logits
    (f32). Save with `model.save_pretrained(dir)`."""
    _require(cfg, cfg.pos_emb == "rope" and cfg.norm == "rms"
             and cfg.mlp == "swiglu" and not cfg.bias,
             "llama export needs rope + RMSNorm + SwiGLU + no biases "
             "(use to_hf_gpt2 for the GPT-2 family)")
    _require(cfg, not cfg.n_experts, "MoE export is not supported")
    transformers = _transformers()
    H = cfg.n_head
    KV = cfg.n_kv_head or H
    hd = cfg.d_model // H
    common = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layer,
        num_attention_heads=H, num_key_value_heads=KV,
        max_position_embeddings=cfg.max_seq, rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=cfg.tied_head,
        attention_dropout=0.0)
    if cfg.window:
        model = transformers.MistralForCausalLM(transformers.MistralConfig(
            sliding_window=cfg.window, **common)).eval()
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            attention_bias=False, **common)).eval()
    sd = model.state_dict()
    b = params["blocks"]
    sd["model.embed_tokens.weight"] = _cpu(params["wte"])
    sd["model.norm.weight"] = _cpu(params["ln_f"]["scale"])
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = _cpu(b["ln1"]["scale"][i])
        sd[f"{p}.post_attention_layernorm.weight"] = _cpu(
            b["ln2"]["scale"][i])
        q, k, v = _unpack_qkv_t(_cpu(b["qkv"][i]), H, KV, hd)
        # back to nn.Linear's (out, in)
        for name, w in (("self_attn.q_proj", q), ("self_attn.k_proj", k),
                        ("self_attn.v_proj", v),
                        ("self_attn.o_proj", b["proj"][i]),
                        ("mlp.gate_proj", b["fc_gate"][i]),
                        ("mlp.up_proj", b["fc_in"][i]),
                        ("mlp.down_proj", b["fc_out"][i])):
            sd[f"{p}.{name}.weight"] = _cpu(w).T.contiguous()
    if not cfg.tied_head:
        sd["lm_head.weight"] = _cpu(params["lm_head"])
    model.load_state_dict(sd)
    return model


def to_huggingface(params, cfg) -> Any:
    """Export a params tree to a `transformers` model, the inverse of
    `from_huggingface`, by the config's family: RMSNorm + rope + SwiGLU ->
    llama or mistral (`window` picks mistral), else GPT-2. Merge LoRA or
    QLoRA adapters first (`lora_merge`, `qlora_merge`)."""
    if cfg.norm == "rms" and cfg.pos_emb == "rope":
        return to_hf_llama(params, cfg)
    return to_hf_gpt2(params, cfg)
