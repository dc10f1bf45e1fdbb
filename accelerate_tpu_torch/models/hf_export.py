"""HF-checkpoint export for the llama family and GPT-2: the port's params
-> a directory transformers' ``from_pretrained`` loads.

The JAX package's ``accelerate_tpu/models/hf_export.py`` for the llama
family and GPT-2: :func:`export_state_dict` maps the params onto
transformers' tensor names and layouts (fp32; llama's projections
``[out, in]``, GPT-2's Conv1D ``[in, out]`` as the port keeps them),
:func:`export_hf_checkpoint` writes ``config.json`` and
``model.safetensors`` with the port's own safetensors writer.  Gemma-
convention configs (``rms_offset``) export as ``GemmaForCausalLM``, the
rest of the llama family as ``LlamaForCausalLM``, GPT-2 as
``GPT2LMHeadModel``.  ``import_state_dict(export_state_dict(p))``
gives ``p`` back bit for bit.  The other families of the JAX module raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import json
import os

import torch

from ..utils import safetensors_io
from .hf_import import _NOT_PORTED, _PORTED, _not_ported

__all__ = ["export_state_dict", "export_hf_checkpoint"]


def _f32(t) -> torch.Tensor:
    return t.detach().to(torch.float32)


def _unstack(leaf, fmt: str, out: dict, transpose: bool = False) -> None:
    a = _f32(leaf)
    for i in range(a.shape[0]):
        out[fmt.format(i)] = (a[i].T if transpose else a[i]).contiguous()


def _export_llama(params: dict, cfg) -> dict:
    # config.json's attention_bias must match whether bias tensors exist, or
    # from_pretrained silently drops or initializes them.
    if ("bq" in params["layers"]) != bool(cfg.attention_bias):
        raise ValueError(
            "attention_bias mismatch: params "
            f"{'contain' if 'bq' in params['layers'] else 'lack'} bias "
            f"tensors but cfg.attention_bias={cfg.attention_bias}; rebuild "
            "the config with the flag matching the params."
        )
    sd: dict = {"model.embed_tokens.weight": _f32(params["embed"]).contiguous()}
    lay = params["layers"]
    pre = "model.layers.{}."
    _unstack(lay["wq"], pre + "self_attn.q_proj.weight", sd, transpose=True)
    _unstack(lay["wk"], pre + "self_attn.k_proj.weight", sd, transpose=True)
    _unstack(lay["wv"], pre + "self_attn.v_proj.weight", sd, transpose=True)
    _unstack(lay["wo"], pre + "self_attn.o_proj.weight", sd, transpose=True)
    _unstack(lay["w_gate"], pre + "mlp.gate_proj.weight", sd, transpose=True)
    _unstack(lay["w_up"], pre + "mlp.up_proj.weight", sd, transpose=True)
    _unstack(lay["w_down"], pre + "mlp.down_proj.weight", sd, transpose=True)
    if "bq" in lay:
        _unstack(lay["bq"], pre + "self_attn.q_proj.bias", sd)
        _unstack(lay["bk"], pre + "self_attn.k_proj.bias", sd)
        _unstack(lay["bv"], pre + "self_attn.v_proj.bias", sd)
        _unstack(lay["bo"], pre + "self_attn.o_proj.bias", sd)
    _unstack(lay["ln_attn"], pre + "input_layernorm.weight", sd)
    _unstack(lay["ln_mlp"], pre + "post_attention_layernorm.weight", sd)
    sd["model.norm.weight"] = _f32(params["final_norm"]).contiguous()
    if "lm_head" in params:
        sd["lm_head.weight"] = _f32(params["lm_head"]).T.contiguous()
    return sd


def _export_gpt2(params: dict, cfg) -> dict:
    sd: dict = {
        "transformer.wte.weight": _f32(params["wte"]).contiguous(),
        "transformer.wpe.weight": _f32(params["wpe"]).contiguous(),
        "transformer.ln_f.weight": _f32(params["final_ln_scale"]).contiguous(),
        "transformer.ln_f.bias": _f32(params["final_ln_bias"]).contiguous(),
    }
    lay = params["layers"]
    pre = "transformer.h.{}."
    # Conv1D layout ([in, out]): no transpose.
    _unstack(lay["w_qkv"], pre + "attn.c_attn.weight", sd)
    _unstack(lay["b_qkv"], pre + "attn.c_attn.bias", sd)
    _unstack(lay["w_proj"], pre + "attn.c_proj.weight", sd)
    _unstack(lay["b_proj"], pre + "attn.c_proj.bias", sd)
    _unstack(lay["w_up"], pre + "mlp.c_fc.weight", sd)
    _unstack(lay["b_up"], pre + "mlp.c_fc.bias", sd)
    _unstack(lay["w_down"], pre + "mlp.c_proj.weight", sd)
    _unstack(lay["b_down"], pre + "mlp.c_proj.bias", sd)
    _unstack(lay["ln_attn_scale"], pre + "ln_1.weight", sd)
    _unstack(lay["ln_attn_bias"], pre + "ln_1.bias", sd)
    _unstack(lay["ln_mlp_scale"], pre + "ln_2.weight", sd)
    _unstack(lay["ln_mlp_bias"], pre + "ln_2.bias", sd)
    return sd


_EXPORTERS = {"llama": _export_llama, "gpt2": _export_gpt2}


def _gpt2_config_dict(cfg, params: dict) -> dict:
    """``config.json`` of GPT-2; the MLP width is read from the weights."""
    return {
        "model_type": "gpt2",
        "architectures": ["GPT2LMHeadModel"],
        "vocab_size": cfg.vocab_size,
        "n_embd": cfg.hidden_size,
        "n_layer": cfg.num_layers,
        "n_head": cfg.num_heads,
        "n_positions": cfg.max_seq_len,
        "n_ctx": cfg.max_seq_len,
        "n_inner": int(params["layers"]["w_up"].shape[-1]),
        "layer_norm_epsilon": cfg.layer_norm_eps,
        "activation_function": "gelu_new",
        "torch_dtype": "float32",
    }


def _hf_config_dict(cfg) -> dict:
    """``config.json`` of the llama family: a gemma config for the full gemma
    convention, a llama config for silu without embedding scale; a mix of
    the two is no HF architecture and raises."""
    common = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim_,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.attention_bias,
        "torch_dtype": "float32",
    }
    if cfg.rope_scaling is not None:
        _, factor, low_f, high_f, orig = cfg.rope_scaling
        common["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": factor,
            "low_freq_factor": low_f,
            "high_freq_factor": high_f,
            "original_max_position_embeddings": orig,
        }
    if cfg.rms_offset:
        # Gemma's semantics under llama's tensor names: a gemma config, so
        # from_pretrained builds the right module.
        if cfg.hidden_act != "gelu_tanh" or not cfg.embed_scale or not cfg.tie_embeddings:
            raise ValueError(
                "rms_offset configs export as gemma and need the full gemma "
                "convention: hidden_act='gelu_tanh', embed_scale=True, "
                "tie_embeddings=True."
            )
        common.update({
            "model_type": "gemma",
            "architectures": ["GemmaForCausalLM"],
            "hidden_act": "gelu_pytorch_tanh",
            "hidden_activation": "gelu_pytorch_tanh",
        })
        return common
    if cfg.hidden_act != "silu" or cfg.embed_scale:
        raise ValueError(
            "llama export supports the silu/no-embed-scale convention or the "
            "full gemma convention (rms_offset=True); this mix is not "
            "representable as an HF architecture."
        )
    common.update({
        "model_type": "llama",
        "architectures": ["LlamaForCausalLM"],
        "hidden_act": "silu",
        "mlp_bias": False,
    })
    return common


def export_state_dict(family: str, params: dict, config) -> dict:
    """The port's params -> a transformers-style state dict of fp32 torch
    tensors (on the params' device)."""
    if family in _NOT_PORTED:
        raise _not_ported(family)
    if family not in _EXPORTERS:
        raise ValueError(f"Export supports {sorted(set(_NOT_PORTED) | set(_PORTED))}; "
                         f"got {family!r}")
    return _EXPORTERS[family](params, config)


def export_hf_checkpoint(family: str, params: dict, config, path: str) -> str:
    """Write ``config.json`` + ``model.safetensors`` that transformers'
    ``from_pretrained(path)`` loads.  Returns ``path``."""
    sd = export_state_dict(family, params, config)
    os.makedirs(path, exist_ok=True)
    hf_config = (_gpt2_config_dict(config, params) if family == "gpt2"
                 else _hf_config_dict(config))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    # The format key: transformers refuses safetensors files without it.
    safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"),
                             metadata={"format": "pt"})
    return path
