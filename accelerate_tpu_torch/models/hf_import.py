"""HF-checkpoint import: transformers configs and state dicts -> the port's
``(config, params)``, for every family of the JAX package's
``accelerate_tpu/models/hf_import.py``:

- ``llama``: LlamaForCausalLM and the architectures mapped onto it,
  Qwen2ForCausalLM (Q/K/V biases, ``attention_bias=True``),
  MistralForCausalLM (llama-shaped GQA, v0.2+; sliding-window configs
  refused), GemmaForCausalLM (GeGLU, (1 + w) RMSNorm and sqrt(d)
  embeddings through ``hidden_act`` / ``rms_offset`` / ``embed_scale``) and
  Phi3ForCausalLM (fused ``qkv_proj`` / ``gate_up_proj`` split on import),
  with Llama-3.1's ``rope_scaling``;
- ``gpt2``: GPT2LMHeadModel / GPT2Model (HF's Conv1D stores ``[in, out]``,
  the port's layout, so nothing is transposed);
- ``bert``: BertForSequenceClassification / BertModel (the port's GELU is
  the tanh approximation: an erf-GELU checkpoint computes ~1e-3 apart);
- ``t5``: T5ForConditionalGeneration / T5Model (ReLU, tied head; the
  relative bias from block 0 of each stack);
- ``mixtral``: MixtralForCausalLM (experts w1/w3/w2 -> gate/up/down stacked
  ``[L, E, ...]``, the router transposed);
- ``vit``: ViTForImageClassification / ViTModel (the patch conv ``[d, C, p,
  p]`` -> the patchify matmul's ``[p*p*C, d]``);
- ``resnet``: ResNetForImageClassification / ResNetModel (v1.5 blocks, the
  port's; conv kernels OIHW -> HWIO; the BN running statistics come as a
  ``batch_stats`` tree: this family's import returns ``{"params": ...,
  "batch_stats": ...}``).

``config_from_hf`` reads any object with the config's attributes, so it
needs no ``transformers``; ``load_hf_checkpoint`` reads ``config.json`` and
the safetensors weights with the port's own reader.  Params come back as
the family's dict (stacked ``[L, ...]`` layers, projections stored for
``x @ W``) of torch tensors in ``config.param_dtype`` (batch statistics in
fp32).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ..state import resolve_device

__all__ = ["config_from_hf", "import_state_dict", "from_hf", "load_hf_checkpoint"]

_LLAMA_TYPES = ("llama", "qwen2", "mistral", "gemma", "phi3")
_FAMILIES = ("bert", "gpt2", "llama", "mixtral", "resnet", "t5", "vit")
# Architecture-wrapper prefixes stripped before mapping, so ForCausalLM,
# ForSequenceClassification and bare-Model state dicts map alike.
_PREFIXES = {"llama": "model.", "gpt2": "transformer.", "bert": "bert.", "t5": None,
             "mixtral": "model.", "vit": "vit.", "resnet": "resnet."}


def _detect_family(hf_config) -> str:
    mt = getattr(hf_config, "model_type", "")
    if mt in _LLAMA_TYPES:
        # qwen2, mistral, gemma and phi3 are llama-architecture variants;
        # sliding-window, gemma2 and longrope configs are refused below.
        return "llama"
    if mt in _FAMILIES:
        return mt
    raise ValueError(
        f"Unsupported HF model_type {mt!r}; supported: {sorted(_FAMILIES)} (qwen2, mistral, "
        "gemma and phi3 map onto llama)"
    )


def config_from_hf(hf_config, **overrides):
    """The port's config of the checkpoint's family from a transformers
    config (or any object with its attributes), with the JAX package's
    refusals: sliding windows, partial rotary, rope scaling other than
    llama3, activations the native MLP does not compute, T5's untied heads,
    gated MLPs and unequal stacks, ResNet's v1 downsampling and
    non-doubling widths.  ``overrides`` replace fields."""
    c = hf_config
    family = _detect_family(c)
    if family != "llama":
        return _OTHER_CONFIGS[family](c, overrides)
    from .llama import LlamaConfig

    mt = getattr(c, "model_type", "llama")
    if mt == "qwen2" and getattr(c, "use_sliding_window", False):
        raise ValueError(
            "qwen2 import requires use_sliding_window=False: the native "
            "attention paths are full-causal."
        )
    if mt == "mistral" and getattr(c, "sliding_window", None) is not None:
        raise ValueError(
            "mistral import requires sliding_window=null (v0.2+ configs): "
            "the native attention paths are full-causal, so a windowed "
            "checkpoint would silently attend differently."
        )
    if mt == "phi3":
        if getattr(c, "sliding_window", None) is not None:
            raise ValueError(
                "phi3 import requires sliding_window=null: the native "
                "attention paths are full-causal."
            )
        if float(getattr(c, "partial_rotary_factor", 1.0)) != 1.0:
            raise ValueError(
                "phi3 import requires partial_rotary_factor=1.0 (the "
                "native RoPE rotates the full head dim)."
            )
    # qwen2's bias is architectural (transformers hardcodes it), so a stray
    # "attention_bias": false in its config.json does not win.
    bias = True if mt == "qwen2" else bool(getattr(c, "attention_bias", False))
    rs = getattr(c, "rope_scaling", None)
    rope_scaling = None
    if rs:
        rs = dict(rs)
        kind = rs.get("rope_type", rs.get("type"))
        if kind == "default":  # transformers: plain unscaled RoPE
            rs = None
        elif kind != "llama3":
            raise ValueError(
                f"rope_scaling type {kind!r} is not supported (llama3 "
                "long-context rescaling only); importing would silently "
                "rotate positions differently from the checkpoint."
            )
    if rs:
        rope_scaling = ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
                        float(rs["high_freq_factor"]),
                        int(rs["original_max_position_embeddings"]))
    gemma = mt == "gemma"
    if not gemma and getattr(c, "hidden_act", "silu") != "silu":
        raise ValueError(
            f"{mt} import supports hidden_act='silu', got {c.hidden_act!r}; the "
            "native MLP would silently compute a different activation."
        )
    if gemma:
        # transformers maps a legacy hidden_activation=None to
        # gelu_pytorch_tanh; an explicit other value (exact-erf 'gelu')
        # would diverge from the native tanh-approximate path.
        act_explicit = getattr(c, "hidden_activation", None)
        if act_explicit is not None and act_explicit != "gelu_pytorch_tanh":
            raise ValueError(
                "gemma import supports hidden_activation="
                f"'gelu_pytorch_tanh' (or unset), got {act_explicit!r}"
            )
    kw = dict(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_layers=c.num_hidden_layers,
        num_heads=c.num_attention_heads,
        num_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        head_dim=getattr(c, "head_dim", None),
        max_seq_len=c.max_position_embeddings,
        rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        rms_eps=float(c.rms_norm_eps),
        tie_embeddings=bool(getattr(c, "tie_word_embeddings", gemma)),
        attention_bias=bias,
        hidden_act="gelu_tanh" if gemma else "silu",
        rms_offset=gemma,
        embed_scale=gemma,
        rope_scaling=rope_scaling,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _gpt2_config(c, overrides):
    from .gpt2 import GPT2Config

    kw = dict(vocab_size=c.vocab_size, hidden_size=c.n_embd, num_layers=c.n_layer,
              num_heads=c.n_head, max_seq_len=c.n_positions,
              layer_norm_eps=float(c.layer_norm_epsilon))
    return GPT2Config(**{**kw, **overrides})


def _bert_config(c, overrides):
    from .bert import BertConfig

    kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
              num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
              max_seq_len=c.max_position_embeddings, type_vocab_size=c.type_vocab_size,
              num_labels=getattr(c, "num_labels", 2), layer_norm_eps=float(c.layer_norm_eps))
    return BertConfig(**{**kw, **overrides})


def _t5_config(c, overrides):
    from .t5 import T5Config

    # The native T5 always unembeds through the 1/sqrt(d)-scaled shared
    # embedding and applies plain ReLU; a separate lm_head or a gated
    # activation would run but produce wrong logits.
    if not getattr(c, "tie_word_embeddings", True):
        raise ValueError(
            "T5 import requires tie_word_embeddings=True (the native "
            "family unembeds through the shared embedding)."
        )
    ff = getattr(c, "feed_forward_proj", "relu")
    if ff not in ("relu",):
        raise ValueError(
            f"T5 import supports feed_forward_proj='relu' only, got {ff!r} "
            "(gated variants have extra wi_0/wi_1 tensors the native "
            "family does not model)."
        )
    ndl = getattr(c, "num_decoder_layers", None)
    if ndl is not None and ndl != c.num_layers:
        raise ValueError(
            f"T5 import requires num_decoder_layers == num_layers "
            f"(got {ndl} vs {c.num_layers}); the native family uses one "
            "depth per stack."
        )
    kw = dict(vocab_size=c.vocab_size, hidden_size=c.d_model, intermediate_size=c.d_ff,
              num_layers=c.num_layers, num_heads=c.num_heads, head_dim=c.d_kv,
              num_buckets=c.relative_attention_num_buckets,
              max_distance=getattr(c, "relative_attention_max_distance", 128),
              rms_eps=float(c.layer_norm_epsilon))
    return T5Config(**{**kw, **overrides})


def _mixtral_config(c, overrides):
    from .mixtral import MixtralConfig

    kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
              intermediate_size=c.intermediate_size, num_layers=c.num_hidden_layers,
              num_heads=c.num_attention_heads, num_kv_heads=c.num_key_value_heads,
              num_experts=c.num_local_experts, top_k=c.num_experts_per_tok,
              max_seq_len=c.max_position_embeddings,
              rope_theta=float(getattr(c, "rope_theta", 1e6)), rms_eps=float(c.rms_norm_eps))
    return MixtralConfig(**{**kw, **overrides})


def _resnet_config(c, overrides):
    from .resnet import ResNetConfig

    block = {"bottleneck": "bottleneck", "basic": "basic"}.get(
        getattr(c, "layer_type", "bottleneck"))
    if block is None:
        raise ValueError(f"Unsupported resnet layer_type {c.layer_type!r}")
    if getattr(c, "downsample_in_first_stage", False):
        raise ValueError(
            "resnet import requires downsample_in_first_stage=False "
            "(the native family strides stage 0 at 1, torchvision-style)."
        )
    if getattr(c, "downsample_in_bottleneck", False):
        raise ValueError(
            "resnet import requires downsample_in_bottleneck=False: the "
            "native block strides the 3x3 conv (v1.5); a v1-style "
            "checkpoint (stride on the first 1x1) has identical shapes "
            "but different numerics, so it must be refused, not silently "
            "mis-run."
        )
    width = c.embedding_size
    e = 4 if block == "bottleneck" else 1
    expect = [width * (2**s) * e for s in range(len(c.depths))]
    if list(c.hidden_sizes) != expect:
        raise ValueError(
            f"resnet import supports the standard doubling geometry "
            f"(hidden_sizes {expect} for embedding_size {width}); got "
            f"{list(c.hidden_sizes)}."
        )
    kw = dict(block=block, stage_sizes=tuple(c.depths), width=width,
              num_labels=getattr(c, "num_labels", 2), stem="imagenet")
    return ResNetConfig(**{**kw, **overrides})


def _vit_config(c, overrides):
    from .vit import ViTConfig

    kw = dict(image_size=c.image_size, patch_size=c.patch_size, num_channels=c.num_channels,
              hidden_size=c.hidden_size, num_layers=c.num_hidden_layers,
              num_heads=c.num_attention_heads, mlp_ratio=c.intermediate_size // c.hidden_size,
              num_labels=getattr(c, "num_labels", 2), layer_norm_eps=float(c.layer_norm_eps))
    return ViTConfig(**{**kw, **overrides})


_OTHER_CONFIGS = {"gpt2": _gpt2_config, "bert": _bert_config, "t5": _t5_config,
                  "mixtral": _mixtral_config, "resnet": _resnet_config, "vit": _vit_config}


def _f32(t) -> torch.Tensor:
    """A tensor (or array-like) as fp32 torch, detached, where it lies."""
    return torch.as_tensor(t).detach().to(torch.float32)


def _stack(sd: dict, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
    """Per-layer tensors ``fmt.format(i)`` stacked into ``[L, ...]``."""
    mats = [_f32(sd[fmt.format(i)]) for i in range(n)]
    return torch.stack([m.T for m in mats] if transpose else mats)


def _stack_cat(sd: dict, fmts: list, n: int, transpose: bool = False) -> torch.Tensor:
    """Per layer, several tensors concatenated along the last axis (the
    fused QKV layout ``[Wq | Wk | Wv]``), then stacked into ``[L, ...]``."""
    out = []
    for i in range(n):
        mats = [_f32(sd[f.format(i)]) for f in fmts]
        out.append(torch.cat([m.T for m in mats] if transpose else mats, dim=-1))
    return torch.stack(out)


def _head(sd: dict, name: str, d: int, n: int, like: torch.Tensor) -> dict:
    """A classification head ``{w: [d, n], b: [n]}`` from ``name.weight`` /
    ``name.bias``, zeros when the checkpoint has none (a bare model)."""
    if name + ".weight" in sd:
        return {"w": _f32(sd[name + ".weight"]).T, "b": _f32(sd[name + ".bias"])}
    return {"w": like.new_zeros(d, n), "b": like.new_zeros(n)}


def _import_llama(sd: dict, cfg) -> dict:
    L = cfg.num_layers
    pre = "layers.{}."
    if "layers.0.self_attn.qkv_proj.weight" in sd:
        # phi3 fuses the projections ([q|k|v] rows, [gate|up] rows): split
        # per layer back into the separate tensors.
        nq = cfg.num_heads * cfg.head_dim_
        nk = cfg.num_kv_heads * cfg.head_dim_
        f = cfg.intermediate_size
        wq, wk, wv, wg, wu = [], [], [], [], []
        for i in range(L):
            qkv = _f32(sd[f"layers.{i}.self_attn.qkv_proj.weight"])
            wq.append(qkv[:nq].T)
            wk.append(qkv[nq:nq + nk].T)
            wv.append(qkv[nq + nk:].T)
            gu = _f32(sd[f"layers.{i}.mlp.gate_up_proj.weight"])
            wg.append(gu[:f].T)
            wu.append(gu[f:].T)
        attn = {"wq": torch.stack(wq), "wk": torch.stack(wk), "wv": torch.stack(wv),
                "w_gate": torch.stack(wg), "w_up": torch.stack(wu)}
    else:
        attn = {
            "wq": _stack(sd, pre + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, pre + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, pre + "self_attn.v_proj.weight", L, transpose=True),
            "w_gate": _stack(sd, pre + "mlp.gate_proj.weight", L, transpose=True),
            "w_up": _stack(sd, pre + "mlp.up_proj.weight", L, transpose=True),
        }
    params = {
        "embed": _f32(sd["embed_tokens.weight"]),
        "layers": {
            **attn,
            "wo": _stack(sd, pre + "self_attn.o_proj.weight", L, transpose=True),
            "w_down": _stack(sd, pre + "mlp.down_proj.weight", L, transpose=True),
            "ln_attn": _stack(sd, pre + "input_layernorm.weight", L),
            "ln_mlp": _stack(sd, pre + "post_attention_layernorm.weight", L),
        },
        "final_norm": _f32(sd["norm.weight"]),
    }
    if cfg.attention_bias:
        layers = params["layers"]
        layers["bq"] = _stack(sd, pre + "self_attn.q_proj.bias", L)
        layers["bk"] = _stack(sd, pre + "self_attn.k_proj.bias", L)
        layers["bv"] = _stack(sd, pre + "self_attn.v_proj.bias", L)
        # HF llama with attention_bias also biases o_proj; qwen2 does not,
        # and zeros compute as no bias.
        if "layers.0.self_attn.o_proj.bias" in sd:
            layers["bo"] = _stack(sd, pre + "self_attn.o_proj.bias", L)
        else:
            layers["bo"] = torch.zeros(L, cfg.hidden_size, device=params["embed"].device)
    head = sd.get("lm_head.weight")  # consumed even when tied (an alias)
    if not cfg.tie_embeddings:
        params["lm_head"] = _f32(head).T if head is not None else params["embed"].T
    return params


def _import_gpt2(sd: dict, cfg) -> dict:
    sd.get("lm_head.weight")  # the tied alias of wte: consumed
    L = cfg.num_layers
    pre = "h.{}."
    # Conv1D ([in, out] storage) is the port's layout: no transpose.
    return {
        "wte": _f32(sd["wte.weight"]),
        "wpe": _f32(sd["wpe.weight"]),
        "layers": {
            "w_qkv": _stack(sd, pre + "attn.c_attn.weight", L),
            "b_qkv": _stack(sd, pre + "attn.c_attn.bias", L),
            "w_proj": _stack(sd, pre + "attn.c_proj.weight", L),
            "b_proj": _stack(sd, pre + "attn.c_proj.bias", L),
            "w_up": _stack(sd, pre + "mlp.c_fc.weight", L),
            "b_up": _stack(sd, pre + "mlp.c_fc.bias", L),
            "w_down": _stack(sd, pre + "mlp.c_proj.weight", L),
            "b_down": _stack(sd, pre + "mlp.c_proj.bias", L),
            "ln_attn_scale": _stack(sd, pre + "ln_1.weight", L),
            "ln_attn_bias": _stack(sd, pre + "ln_1.bias", L),
            "ln_mlp_scale": _stack(sd, pre + "ln_2.weight", L),
            "ln_mlp_bias": _stack(sd, pre + "ln_2.bias", L),
        },
        "final_ln_scale": _f32(sd["ln_f.weight"]),
        "final_ln_bias": _f32(sd["ln_f.bias"]),
    }


def _encoder_layers(sd: dict, L: int, pre: str, attn: str, ln_attn: str, ln_mlp: str) -> dict:
    """BERT's and ViT's stacked layer tree (fused QKV, projections for
    ``x @ W``) from HF's per-layer ``query``/``key``/``value`` Linears."""
    return {
        "w_qkv": _stack_cat(sd, [pre + f"{attn}.{n}.weight" for n in ("query", "key", "value")],
                            L, transpose=True),
        "b_qkv": _stack_cat(sd, [pre + f"{attn}.{n}.bias" for n in ("query", "key", "value")], L),
        "w_proj": _stack(sd, pre + "attention.output.dense.weight", L, transpose=True),
        "b_proj": _stack(sd, pre + "attention.output.dense.bias", L),
        "w_up": _stack(sd, pre + "intermediate.dense.weight", L, transpose=True),
        "b_up": _stack(sd, pre + "intermediate.dense.bias", L),
        "w_down": _stack(sd, pre + "output.dense.weight", L, transpose=True),
        "b_down": _stack(sd, pre + "output.dense.bias", L),
        "ln_attn_scale": _stack(sd, pre + ln_attn + ".weight", L),
        "ln_attn_bias": _stack(sd, pre + ln_attn + ".bias", L),
        "ln_mlp_scale": _stack(sd, pre + ln_mlp + ".weight", L),
        "ln_mlp_bias": _stack(sd, pre + ln_mlp + ".bias", L),
    }


def _import_bert(sd: dict, cfg) -> dict:
    d = cfg.hidden_size
    word = _f32(sd["embeddings.word_embeddings.weight"])
    params = {
        "embeddings": {
            "word": word,
            "position": _f32(sd["embeddings.position_embeddings.weight"]),
            "token_type": _f32(sd["embeddings.token_type_embeddings.weight"]),
            "ln_scale": _f32(sd["embeddings.LayerNorm.weight"]),
            "ln_bias": _f32(sd["embeddings.LayerNorm.bias"]),
        },
        "layers": _encoder_layers(sd, cfg.num_layers, "encoder.layer.{}.", "attention.self",
                                  "attention.output.LayerNorm", "output.LayerNorm"),
        "pooler": _head(sd, "pooler.dense", d, d, word),
    }
    params["classifier"] = _head(sd, "classifier", d, cfg.num_labels, word)
    return params


def _import_t5_stack(sd: dict, cfg, stack: str) -> dict:
    L = cfg.num_layers
    pre = f"{stack}.block.{{}}."
    out = {
        "wq": _stack(sd, pre + "layer.0.SelfAttention.q.weight", L, transpose=True),
        "wk": _stack(sd, pre + "layer.0.SelfAttention.k.weight", L, transpose=True),
        "wv": _stack(sd, pre + "layer.0.SelfAttention.v.weight", L, transpose=True),
        "wo": _stack(sd, pre + "layer.0.SelfAttention.o.weight", L, transpose=True),
        "ln_attn": _stack(sd, pre + "layer.0.layer_norm.weight", L),
    }
    mlp = 2 if stack == "decoder" else 1
    out["w_up"] = _stack(sd, pre + f"layer.{mlp}.DenseReluDense.wi.weight", L, transpose=True)
    out["w_down"] = _stack(sd, pre + f"layer.{mlp}.DenseReluDense.wo.weight", L, transpose=True)
    out["ln_mlp"] = _stack(sd, pre + f"layer.{mlp}.layer_norm.weight", L)
    if stack == "decoder":
        for n in ("q", "k", "v", "o"):
            out[f"cross_w{n}"] = _stack(sd, pre + f"layer.1.EncDecAttention.{n}.weight", L,
                                        transpose=True)
        out["ln_cross"] = _stack(sd, pre + "layer.1.layer_norm.weight", L)
    return out


def _import_t5(sd: dict, cfg) -> dict:
    # Tied aliases of shared.weight that T5 serializes: consumed.
    for alias in ("lm_head.weight", "encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        sd.get(alias)
    rel = "{}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    return {
        "shared_embed": _f32(sd["shared.weight"]),
        "enc_rel_bias": _f32(sd[rel.format("encoder")]),
        "dec_rel_bias": _f32(sd[rel.format("decoder")]),
        "encoder": _import_t5_stack(sd, cfg, "encoder"),
        "decoder": _import_t5_stack(sd, cfg, "decoder"),
        "enc_final_ln": _f32(sd["encoder.final_layer_norm.weight"]),
        "dec_final_ln": _f32(sd["decoder.final_layer_norm.weight"]),
    }


def _import_mixtral(sd: dict, cfg) -> dict:
    L, E = cfg.num_layers, cfg.num_experts
    pre = "layers.{}."

    def experts(which: str) -> torch.Tensor:  # [L, E, in, out]
        return torch.stack([torch.stack([
            _f32(sd[f"layers.{i}.block_sparse_moe.experts.{j}.{which}.weight"]).T
            for j in range(E)]) for i in range(L)])

    params = {
        "embed": _f32(sd["embed_tokens.weight"]),
        "layers": {
            "wq": _stack(sd, pre + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, pre + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, pre + "self_attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, pre + "self_attn.o_proj.weight", L, transpose=True),
            "router": _stack(sd, pre + "block_sparse_moe.gate.weight", L, transpose=True),
            "w_gate": experts("w1"),
            "w_up": experts("w3"),
            "w_down": experts("w2"),
            "ln_attn": _stack(sd, pre + "input_layernorm.weight", L),
            "ln_mlp": _stack(sd, pre + "post_attention_layernorm.weight", L),
        },
        "final_norm": _f32(sd["norm.weight"]),
    }
    head = sd.get("lm_head.weight")
    params["lm_head"] = _f32(head).T if head is not None else params["embed"].T
    return params


def _import_vit(sd: dict, cfg) -> dict:
    p = cfg.patch_size
    conv = _f32(sd["embeddings.patch_embeddings.projection.weight"])  # [d, C, p, p]
    d = conv.shape[0]
    emb = {
        # The patchify matmul's rows run over (patch row, patch column, channel).
        "patch_w": conv.permute(2, 3, 1, 0).reshape(p * p * cfg.num_channels, d),
        "patch_b": _f32(sd["embeddings.patch_embeddings.projection.bias"]),
        "position": _f32(sd["embeddings.position_embeddings"])[0],
    }
    if cfg.pool == "cls":
        emb["cls"] = _f32(sd["embeddings.cls_token"])
    return {
        "embeddings": emb,
        "layers": _encoder_layers(sd, cfg.num_layers, "encoder.layer.{}.",
                                  "attention.attention", "layernorm_before", "layernorm_after"),
        "final_ln": {"scale": _f32(sd["layernorm.weight"]), "bias": _f32(sd["layernorm.bias"])},
        "classifier": _head(sd, "classifier", d, cfg.num_labels, conv),
    }


def _import_resnet(sd: dict, cfg) -> dict:
    """HF ResNet (v1.5: the stride on the 3x3, the port's block) ->
    ``{"params": ..., "batch_stats": ...}``: the BN running statistics are
    state here, imported beside the weights."""

    def conv(key):  # OIHW -> HWIO
        return _f32(sd[key]).permute(2, 3, 1, 0)

    def bn(prefix, site, params_out, stats_out):
        params_out[f"{site}_scale"] = _f32(sd[prefix + ".weight"])
        params_out[f"{site}_bias"] = _f32(sd[prefix + ".bias"])
        stats_out[f"{site}_mean"] = _f32(sd[prefix + ".running_mean"])
        stats_out[f"{site}_var"] = _f32(sd[prefix + ".running_var"])

    n_convs = 3 if cfg.block == "bottleneck" else 2

    def block(lp):
        p, st = {}, {}
        for j in range(n_convs):
            p[f"conv{j + 1}_w"] = conv(lp + f"layer.{j}.convolution.weight")
            bn(lp + f"layer.{j}.normalization", f"bn{j + 1}", p, st)
        if lp + "shortcut.convolution.weight" in sd:
            p["proj_w"] = conv(lp + "shortcut.convolution.weight")
            bn(lp + "shortcut.normalization", "proj_bn", p, st)
        return p, st

    params: dict = {"stem": {"conv_w": conv("embedder.embedder.convolution.weight")}}
    stats: dict = {"stem": {}}
    bn("embedder.embedder.normalization", "bn", params["stem"], stats["stem"])
    for s, depth in enumerate(cfg.stage_sizes):
        head_p, head_s = block(f"encoder.stages.{s}.layers.0.")
        params[f"stage{s}"], stats[f"stage{s}"] = {"head": head_p}, {"head": head_s}
        if depth > 1:
            tails = [block(f"encoder.stages.{s}.layers.{i}.") for i in range(1, depth)]
            params[f"stage{s}"]["tail"] = {k: torch.stack([t[0][k] for t in tails])
                                           for k in tails[0][0]}
            stats[f"stage{s}"]["tail"] = {k: torch.stack([t[1][k] for t in tails])
                                          for k in tails[0][1]}
    d_out = cfg.stage_channels(len(cfg.stage_sizes) - 1) * cfg.expansion
    params["classifier"] = _head(sd, "classifier.1", d_out, cfg.num_labels,
                                 params["stem"]["conv_w"])
    return {"params": params, "batch_stats": stats}


_IMPORTERS = {"llama": _import_llama, "gpt2": _import_gpt2, "bert": _import_bert,
              "t5": _import_t5, "mixtral": _import_mixtral, "vit": _import_vit,
              "resnet": _import_resnet}


class _RecordingDict(dict):
    """Tracks which checkpoint keys the importer read, so a dropped tensor
    (a bias, an extra head, half of a gated MLP) is a loud error instead of
    a wrong model.  A read also releases the source tensor from this view,
    so the checkpoint shrinks as the params grow."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        v = super().__getitem__(k)
        super().__delitem__(k)
        return v

    def get(self, k, default=None):
        if super().__contains__(k):
            return self[k]
        return default


# Buffers transformers serializes that carry no weights, as anchored
# patterns: strict mode's guarantee depends on them never matching a weight.
_IGNORABLE = tuple(re.compile(p) for p in (
    r"(^|\.)position_ids$",
    r"(^|\.)rotary_emb\.inv_freq$",
    r"(^|\.)attention\.self\.distance_embedding\.weight$",
    r"(^|\.)masked_bias$",
    r"(^|\.)attn\.bias$",  # gpt2's causal-mask buffer
    r"(^|\.)num_batches_tracked$",  # BN bookkeeping (the momentum here is a constant)
))


def _strip_prefix(sd: dict, prefix) -> dict:
    """Drop the family's wrapper prefix (``model.``, ``transformer.``, ...),
    so ForCausalLM and bare-Model state dicts map alike."""
    if prefix and any(k.startswith(prefix) for k in sd):
        return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def import_state_dict(family: str, state_dict: dict, config, strict: bool = True,
                      consume_source: bool = False, device=None) -> dict:
    """A transformers state dict mapped onto the port's params of
    ``family`` (one of ``_FAMILIES``), cast to ``config.param_dtype`` (a
    resnet's batch statistics to fp32), on ``device`` (None: where the
    checkpoint's tensors lie).

    ``strict`` (default) raises if a checkpoint tensor was not consumed by
    the mapping: a dropped tensor means the model computes something else
    than the checkpoint.  ``consume_source`` empties the caller's dict, so
    each source tensor is freed as it is mapped."""
    if family not in _IMPORTERS:
        raise ValueError(f"Unknown family {family!r}; supported: {sorted(_IMPORTERS)}")
    stripped = _strip_prefix(dict(state_dict), _PREFIXES[family])
    if consume_source:
        state_dict.clear()
    sd = _RecordingDict(stripped)
    del stripped
    params = _IMPORTERS[family](sd, config)
    if strict:
        leftover = [k for k in sd
                    if k not in sd.consumed and not any(p.search(k) for p in _IGNORABLE)]
        if leftover:
            raise ValueError(
                f"{family} import left {len(leftover)} checkpoint tensor(s) unmapped (the "
                f"converted model would silently diverge): {sorted(leftover)[:8]}"
                f"{'…' if len(leftover) > 8 else ''}. Pass strict=False to discard them "
                "knowingly."
            )
    dev = None if device is None else resolve_device(device)

    def cast(tree: dict, dtype) -> dict:
        out = {}
        for k in list(tree):  # one leaf at a time: the fp32 staging tree shrinks as it goes
            v = tree.pop(k)
            if isinstance(v, dict):
                out[k] = cast(v, torch.float32 if k == "batch_stats" else dtype)
            else:
                out[k] = v.to(device=dev or v.device, dtype=dtype).contiguous()
        return out

    return cast(params, config.param_dtype)


def load_hf_checkpoint(path: str, strict: bool = True, quantize: Optional[str] = None,
                       device=None, **config_overrides):
    """An HF checkpoint directory (``config.json`` plus ``model.safetensors``,
    its shard index, or a legacy ``pytorch_model.bin``) -> ``(family,
    config, params)``, without building a transformers module; params on
    ``device`` (default ``cuda``).  ``quantize="int8"`` is not ported
    (ROADMAP A8)."""
    from ..checkpointing import read_safetensors_state_dict

    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    if "num_labels" not in raw and isinstance(raw.get("id2label"), dict):
        raw["num_labels"] = len(raw["id2label"])

    class _Cfg:
        def __init__(self, d):
            self.__dict__.update(d)

        def __getattr__(self, name):  # missing keys -> AttributeError
            raise AttributeError(name)

    hf_config = _Cfg(raw)
    family = _detect_family(hf_config)
    cfg = config_from_hf(hf_config, **config_overrides)
    if quantize is not None:
        if quantize != "int8":
            raise ValueError(f"quantize must be 'int8' or None, got {quantize!r}")
        raise NotImplementedError("int8 weight-resident import (quantize_weights) is not "
                                  "ported to accelerate_tpu_torch yet (ROADMAP.md A8)")
    sd = read_safetensors_state_dict(path, "model.safetensors")
    if sd is None:
        legacy = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(legacy):
            raise FileNotFoundError(
                f"No model.safetensors(.index.json) or pytorch_model.bin in {path}")
        sd = torch.load(legacy, map_location="cpu", weights_only=True)
    params = import_state_dict(family, sd, cfg, strict=strict, consume_source=True,
                               device=resolve_device(device))
    return family, cfg, params


def from_hf(model, device=None, **config_overrides):
    """A transformers model -> ``(family, config, params)``, params on
    ``device`` (default ``cuda``)::

        family, cfg, params = from_hf(hf_model, device="cpu")
        logits = llama.apply(params, ids, cfg)
    """
    family = _detect_family(model.config)
    cfg = config_from_hf(model.config, **config_overrides)
    params = import_state_dict(family, model.state_dict(), cfg, device=resolve_device(device))
    return family, cfg, params
