"""HF-checkpoint export: the port's params -> a directory transformers'
``from_pretrained`` loads, for every family of the JAX package's
``accelerate_tpu/models/hf_export.py``.

:func:`export_state_dict` maps the params onto transformers' tensor names
and layouts (fp32; Linear weights ``[out, in]``, GPT-2's Conv1D ``[in,
out]`` as the port keeps it, conv kernels OIHW, BERT's and ViT's fused QKV
split into query/key/value), :func:`export_hf_checkpoint` writes
``config.json`` and ``model.safetensors`` with the port's own safetensors
writer.  Gemma-convention configs (``rms_offset``) export as
``GemmaForCausalLM``, the rest of the llama family as ``LlamaForCausalLM``,
GPT-2 as ``GPT2LMHeadModel``, then ``BertForSequenceClassification``,
``T5ForConditionalGeneration``, ``MixtralForCausalLM``,
``ViTForImageClassification`` (``pool="cls"`` only: HF ViT always has the
CLS token) and ``ResNetForImageClassification`` (which takes the
``{"params", "batch_stats"}`` pair the resnet import returns).
``import_state_dict(export_state_dict(p))`` gives ``p`` back bit for bit.
"""

from __future__ import annotations

import json
import os

import torch

from ..utils import safetensors_io

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


def _t(a) -> torch.Tensor:
    return _f32(a).T.contiguous()


def _export_encoder_layers(lay: dict, pre: str, attn: str, ln_attn: str, ln_mlp: str,
                           sd: dict) -> None:
    """BERT's and ViT's stacked layers: the fused QKV split into HF's
    query/key/value Linears."""
    wq, bq = _f32(lay["w_qkv"]), _f32(lay["b_qkv"])
    for i in range(wq.shape[0]):
        for n, w, b in zip(("query", "key", "value"), wq[i].chunk(3, -1), bq[i].chunk(3, -1)):
            sd[pre.format(i) + f"{attn}.{n}.weight"] = w.T.contiguous()
            sd[pre.format(i) + f"{attn}.{n}.bias"] = b.contiguous()
    _unstack(lay["w_proj"], pre + "attention.output.dense.weight", sd, transpose=True)
    _unstack(lay["b_proj"], pre + "attention.output.dense.bias", sd)
    _unstack(lay["w_up"], pre + "intermediate.dense.weight", sd, transpose=True)
    _unstack(lay["b_up"], pre + "intermediate.dense.bias", sd)
    _unstack(lay["w_down"], pre + "output.dense.weight", sd, transpose=True)
    _unstack(lay["b_down"], pre + "output.dense.bias", sd)
    _unstack(lay["ln_attn_scale"], pre + ln_attn + ".weight", sd)
    _unstack(lay["ln_attn_bias"], pre + ln_attn + ".bias", sd)
    _unstack(lay["ln_mlp_scale"], pre + ln_mlp + ".weight", sd)
    _unstack(lay["ln_mlp_bias"], pre + ln_mlp + ".bias", sd)


def _export_bert(params: dict, cfg) -> dict:
    e = params["embeddings"]
    sd: dict = {
        "bert.embeddings.word_embeddings.weight": _f32(e["word"]).contiguous(),
        "bert.embeddings.position_embeddings.weight": _f32(e["position"]).contiguous(),
        "bert.embeddings.token_type_embeddings.weight": _f32(e["token_type"]).contiguous(),
        "bert.embeddings.LayerNorm.weight": _f32(e["ln_scale"]).contiguous(),
        "bert.embeddings.LayerNorm.bias": _f32(e["ln_bias"]).contiguous(),
        "bert.pooler.dense.weight": _t(params["pooler"]["w"]),
        "bert.pooler.dense.bias": _f32(params["pooler"]["b"]).contiguous(),
        "classifier.weight": _t(params["classifier"]["w"]),
        "classifier.bias": _f32(params["classifier"]["b"]).contiguous(),
    }
    _export_encoder_layers(params["layers"], "bert.encoder.layer.{}.", "attention.self",
                           "attention.output.LayerNorm", "output.LayerNorm", sd)
    return sd


def _export_t5_stack(stack: dict, prefix: str, decoder: bool, out: dict) -> None:
    pre = prefix + ".block.{}."
    for n in ("q", "k", "v", "o"):
        _unstack(stack[f"w{n}"], pre + f"layer.0.SelfAttention.{n}.weight", out, transpose=True)
    _unstack(stack["ln_attn"], pre + "layer.0.layer_norm.weight", out)
    mlp = 2 if decoder else 1
    if decoder:
        for n in ("q", "k", "v", "o"):
            _unstack(stack[f"cross_w{n}"], pre + f"layer.1.EncDecAttention.{n}.weight", out,
                     transpose=True)
        _unstack(stack["ln_cross"], pre + "layer.1.layer_norm.weight", out)
    _unstack(stack["w_up"], pre + f"layer.{mlp}.DenseReluDense.wi.weight", out, transpose=True)
    _unstack(stack["w_down"], pre + f"layer.{mlp}.DenseReluDense.wo.weight", out,
             transpose=True)
    _unstack(stack["ln_mlp"], pre + f"layer.{mlp}.layer_norm.weight", out)


def _export_t5(params: dict, cfg) -> dict:
    rel = "{}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    sd: dict = {
        "shared.weight": _f32(params["shared_embed"]).contiguous(),
        rel.format("encoder"): _f32(params["enc_rel_bias"]).contiguous(),
        rel.format("decoder"): _f32(params["dec_rel_bias"]).contiguous(),
        "encoder.final_layer_norm.weight": _f32(params["enc_final_ln"]).contiguous(),
        "decoder.final_layer_norm.weight": _f32(params["dec_final_ln"]).contiguous(),
    }
    _export_t5_stack(params["encoder"], "encoder", False, sd)
    _export_t5_stack(params["decoder"], "decoder", True, sd)
    return sd


def _export_mixtral(params: dict, cfg) -> dict:
    sd: dict = {"model.embed_tokens.weight": _f32(params["embed"]).contiguous()}
    lay = params["layers"]
    pre = "model.layers.{}."
    for n in ("q", "k", "v", "o"):
        _unstack(lay[f"w{n}"], pre + f"self_attn.{n}_proj.weight", sd, transpose=True)
    _unstack(lay["router"], pre + "block_sparse_moe.gate.weight", sd, transpose=True)
    for which, key in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
        a = _f32(lay[key])  # [L, E, in, out]
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                sd[f"model.layers.{i}.block_sparse_moe.experts.{j}.{which}.weight"] = \
                    a[i, j].T.contiguous()
    _unstack(lay["ln_attn"], pre + "input_layernorm.weight", sd)
    _unstack(lay["ln_mlp"], pre + "post_attention_layernorm.weight", sd)
    sd["model.norm.weight"] = _f32(params["final_norm"]).contiguous()
    sd["lm_head.weight"] = _t(params["lm_head"])
    return sd


def _export_vit(params: dict, cfg) -> dict:
    if cfg.pool != "cls":
        raise ValueError(
            "ViT export requires pool='cls': HF ViT always prepends a CLS "
            "token, so a pool='mean' model (no cls token, num_patches "
            "position slots) cannot be represented as a loadable HF "
            "checkpoint."
        )
    e = params["embeddings"]
    p, ch, d = cfg.patch_size, cfg.num_channels, cfg.hidden_size
    sd: dict = {
        # The inverse of the import's permutation: [p*p*C, d] -> [d, C, p, p].
        "vit.embeddings.patch_embeddings.projection.weight":
            _f32(e["patch_w"]).reshape(p, p, ch, d).permute(3, 2, 0, 1).contiguous(),
        "vit.embeddings.patch_embeddings.projection.bias": _f32(e["patch_b"]).contiguous(),
        "vit.embeddings.position_embeddings": _f32(e["position"])[None].contiguous(),
        "vit.embeddings.cls_token": _f32(e["cls"]).contiguous(),
        "vit.layernorm.weight": _f32(params["final_ln"]["scale"]).contiguous(),
        "vit.layernorm.bias": _f32(params["final_ln"]["bias"]).contiguous(),
        "classifier.weight": _t(params["classifier"]["w"]),
        "classifier.bias": _f32(params["classifier"]["b"]).contiguous(),
    }
    _export_encoder_layers(params["layers"], "vit.encoder.layer.{}.", "attention.attention",
                           "layernorm_before", "layernorm_after", sd)
    return sd


def _export_resnet(tree: dict, cfg) -> dict:
    """Takes the ``{"params", "batch_stats"}`` pair the resnet import returns
    (the BN running statistics are state, exported beside the weights)."""
    if not (isinstance(tree, dict) and "params" in tree and "batch_stats" in tree):
        raise ValueError(
            "resnet export takes {'params': ..., 'batch_stats': ...} — the "
            "pair resnet training threads (and hf_import returns)."
        )
    if cfg.stem != "imagenet":
        raise ValueError(
            "resnet export requires stem='imagenet' (HF ResNet has no "
            "CIFAR-stem variant)."
        )
    params, stats = tree["params"], tree["batch_stats"]

    def conv(a):  # HWIO -> OIHW
        return _f32(a).permute(3, 2, 0, 1).contiguous()

    def bn(prefix, site, p, st):
        sd[prefix + ".weight"] = _f32(p[f"{site}_scale"]).contiguous()
        sd[prefix + ".bias"] = _f32(p[f"{site}_bias"]).contiguous()
        sd[prefix + ".running_mean"] = _f32(st[f"{site}_mean"]).contiguous()
        sd[prefix + ".running_var"] = _f32(st[f"{site}_var"]).contiguous()
        sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                          device=st[f"{site}_var"].device)

    n_convs = 3 if cfg.block == "bottleneck" else 2
    sd: dict = {
        "resnet.embedder.embedder.convolution.weight": conv(params["stem"]["conv_w"]),
        "classifier.1.weight": _t(params["classifier"]["w"]),
        "classifier.1.bias": _f32(params["classifier"]["b"]).contiguous(),
    }
    bn("resnet.embedder.embedder.normalization", "bn", params["stem"], stats["stem"])
    for s_i, depth in enumerate(cfg.stage_sizes):
        sp, ss = params[f"stage{s_i}"], stats[f"stage{s_i}"]
        blocks = [(sp["head"], ss["head"])] + [
            ({k: v[i] for k, v in sp["tail"].items()}, {k: v[i] for k, v in ss["tail"].items()})
            for i in range(depth - 1)]
        for i, (p, st) in enumerate(blocks):
            lp = f"resnet.encoder.stages.{s_i}.layers.{i}."
            for j in range(n_convs):
                sd[lp + f"layer.{j}.convolution.weight"] = conv(p[f"conv{j + 1}_w"])
                bn(lp + f"layer.{j}.normalization", f"bn{j + 1}", p, st)
            if "proj_w" in p:
                sd[lp + "shortcut.convolution.weight"] = conv(p["proj_w"])
                bn(lp + "shortcut.normalization", "proj_bn", p, st)
    return sd


_EXPORTERS = {"llama": _export_llama, "gpt2": _export_gpt2, "bert": _export_bert,
              "t5": _export_t5, "mixtral": _export_mixtral, "vit": _export_vit,
              "resnet": _export_resnet}


def _labels(n: int) -> dict:
    return {"num_labels": n, "id2label": {str(i): f"LABEL_{i}" for i in range(n)},
            "label2id": {f"LABEL_{i}": i for i in range(n)}}


def _hf_config_dict(family: str, cfg, params: dict) -> dict:
    """``config.json`` of ``family``.  MLP widths the config does not carry
    (GPT-2, BERT, ViT) are read from the weights."""
    if family == "llama":
        return _llama_config_dict(cfg)
    if family == "gpt2":
        return _gpt2_config_dict(cfg, params)
    if family == "bert":
        return {
            "model_type": "bert",
            "architectures": ["BertForSequenceClassification"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": int(params["layers"]["w_up"].shape[-1]),
            "max_position_embeddings": cfg.max_seq_len,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            **_labels(cfg.num_labels),
            "hidden_act": "gelu",
            "torch_dtype": "float32",
        }
    if family == "t5":
        return {
            "model_type": "t5",
            "architectures": ["T5ForConditionalGeneration"],
            "vocab_size": cfg.vocab_size,
            "d_model": cfg.hidden_size,
            "d_kv": cfg.head_dim,
            "d_ff": cfg.intermediate_size,
            "num_layers": cfg.num_layers,
            "num_decoder_layers": cfg.num_layers,
            "num_heads": cfg.num_heads,
            "relative_attention_num_buckets": cfg.num_buckets,
            "relative_attention_max_distance": cfg.max_distance,
            "layer_norm_epsilon": cfg.rms_eps,
            "feed_forward_proj": "relu",
            "tie_word_embeddings": True,
            "is_encoder_decoder": True,
            "torch_dtype": "float32",
        }
    if family == "mixtral":
        return {
            "model_type": "mixtral",
            "architectures": ["MixtralForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.top_k,
            "max_position_embeddings": cfg.max_seq_len,
            "rms_norm_eps": cfg.rms_eps,
            "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": False,
            "torch_dtype": "float32",
        }
    if family == "resnet":
        e = 4 if cfg.block == "bottleneck" else 1
        return {
            "model_type": "resnet",
            "architectures": ["ResNetForImageClassification"],
            "num_channels": cfg.num_channels,
            "embedding_size": cfg.width,
            "hidden_sizes": [cfg.width * (2**s) * e for s in range(len(cfg.stage_sizes))],
            "depths": list(cfg.stage_sizes),
            "layer_type": cfg.block,
            "downsample_in_first_stage": False,
            **_labels(cfg.num_labels),
            "hidden_act": "relu",
            "torch_dtype": "float32",
        }
    return {  # vit
        "model_type": "vit",
        "architectures": ["ViTForImageClassification"],
        "image_size": cfg.image_size,
        "patch_size": cfg.patch_size,
        "num_channels": cfg.num_channels,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": int(params["layers"]["w_up"].shape[-1]),
        "layer_norm_eps": cfg.layer_norm_eps,
        **_labels(cfg.num_labels),
        "hidden_act": "gelu",
        "torch_dtype": "float32",
    }


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


def _llama_config_dict(cfg) -> dict:
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
    if family not in _EXPORTERS:
        raise ValueError(f"Export supports {sorted(_EXPORTERS)}; got {family!r}")
    return _EXPORTERS[family](params, config)


def export_hf_checkpoint(family: str, params: dict, config, path: str) -> str:
    """Write ``config.json`` + ``model.safetensors`` that transformers'
    ``from_pretrained(path)`` loads.  Returns ``path``."""
    sd = export_state_dict(family, params, config)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config_dict(family, config, params), f, indent=2)
    # The format key: transformers refuses safetensors files without it.
    safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"),
                             metadata={"format": "pt"})
    return path
