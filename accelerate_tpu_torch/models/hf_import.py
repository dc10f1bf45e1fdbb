"""HF-checkpoint import for the llama family and GPT-2: transformers
configs and state dicts -> the port's ``(config, params)``.

The JAX package's ``accelerate_tpu/models/hf_import.py`` for the llama
family, which covers LlamaForCausalLM and the architectures mapped onto it:
Qwen2ForCausalLM (Q/K/V biases, ``attention_bias=True``), MistralForCausalLM
(llama-shaped GQA, v0.2+; sliding-window configs refused),
GemmaForCausalLM (GeGLU, (1 + w) RMSNorm and sqrt(d) embeddings through
``hidden_act`` / ``rms_offset`` / ``embed_scale``) and Phi3ForCausalLM
(fused ``qkv_proj`` / ``gate_up_proj`` split on import), with Llama-3.1's
``rope_scaling``; and GPT2LMHeadModel / GPT2Model onto ``models/gpt2.py``
(HF's Conv1D stores ``[in, out]``, the port's layout, so nothing is
transposed).  The other families of the JAX module (bert, t5, mixtral, vit,
resnet) have no port of their model yet and raise ``NotImplementedError``
naming their ROADMAP item.

``config_from_hf`` reads any object with the config's attributes, so it
needs no ``transformers``; ``load_hf_checkpoint`` reads ``config.json`` and
the safetensors weights with the port's own reader.  Params come back as
the family's dict (stacked ``[L, ...]`` layers, projections stored for
``x @ W``) of torch tensors in ``config.param_dtype``.
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
# Families the JAX module imports whose models the port has not ported yet,
# with the ROADMAP item that brings each.
_NOT_PORTED = {"bert": "A3", "t5": "A3", "mixtral": "A3", "vit": "A3", "resnet": "A3"}
_PORTED = ("gpt2", "llama")
# Architecture-wrapper prefixes stripped before mapping, so ForCausalLM and
# bare-Model state dicts map alike.
_PREFIXES = {"llama": "model.", "gpt2": "transformer."}


def _not_ported(family: str):
    return NotImplementedError(
        f"the {family} family is not ported to accelerate_tpu_torch yet (ROADMAP.md "
        f"{_NOT_PORTED[family]}); its HF import comes with its model")


def _detect_family(hf_config) -> str:
    mt = getattr(hf_config, "model_type", "")
    if mt in _LLAMA_TYPES:
        # qwen2, mistral, gemma and phi3 are llama-architecture variants;
        # sliding-window, gemma2 and longrope configs are refused below.
        return "llama"
    if mt == "gpt2":
        return "gpt2"
    if mt in _NOT_PORTED:
        raise _not_ported(mt)
    raise ValueError(
        f"Unsupported HF model_type {mt!r}; supported: "
        f"{sorted(set(_NOT_PORTED) | set(_PORTED))} (qwen2, mistral, gemma and phi3 map "
        "onto llama)"
    )


def config_from_hf(hf_config, **overrides):
    """The port's ``LlamaConfig`` or ``GPT2Config`` from a transformers
    config (or any object with its attributes), with the JAX package's
    refusals: sliding windows, partial rotary, rope scaling other than
    llama3, and activations the native MLP does not compute.  ``overrides``
    replace fields."""
    from .llama import LlamaConfig

    c = hf_config
    if _detect_family(c) == "gpt2":
        from .gpt2 import GPT2Config

        kw = dict(vocab_size=c.vocab_size, hidden_size=c.n_embd, num_layers=c.n_layer,
                  num_heads=c.n_head, max_seq_len=c.n_positions,
                  layer_norm_eps=float(c.layer_norm_epsilon))
        kw.update(overrides)
        return GPT2Config(**kw)
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


def _f32(t) -> torch.Tensor:
    """A tensor (or array-like) as fp32 torch, detached, where it lies."""
    return torch.as_tensor(t).detach().to(torch.float32)


def _stack(sd: dict, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
    """Per-layer tensors ``fmt.format(i)`` stacked into ``[L, ...]``."""
    mats = [_f32(sd[fmt.format(i)]) for i in range(n)]
    return torch.stack([m.T for m in mats] if transpose else mats)


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


_IMPORTERS = {"llama": _import_llama, "gpt2": _import_gpt2}


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
    r"(^|\.)masked_bias$",
    r"(^|\.)attn\.bias$",  # gpt2's causal-mask buffer
))


def _strip_prefix(sd: dict, prefix: str) -> dict:
    """Drop the family's wrapper prefix (``model.``, ``transformer.``), so
    ForCausalLM and bare-Model state dicts map alike."""
    if any(k.startswith(prefix) for k in sd):
        return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def import_state_dict(family: str, state_dict: dict, config, strict: bool = True,
                      consume_source: bool = False, device=None) -> dict:
    """A transformers state dict mapped onto the port's params of
    ``family`` (``"llama"`` or ``"gpt2"``), cast to ``config.param_dtype``,
    on ``device`` (None: where the checkpoint's tensors lie).

    ``strict`` (default) raises if a checkpoint tensor was not consumed by
    the mapping: a dropped tensor means the model computes something else
    than the checkpoint.  ``consume_source`` empties the caller's dict, so
    each source tensor is freed as it is mapped."""
    if family in _NOT_PORTED:
        raise _not_ported(family)
    if family not in _IMPORTERS:
        raise ValueError(f"Unknown family {family!r}; supported: "
                         f"{sorted(set(_NOT_PORTED) | set(_PORTED))}")
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

    def cast(t):
        return t.to(device=dev or t.device, dtype=config.param_dtype).contiguous()

    out = {k: cast(v) for k, v in params.items() if k != "layers"}
    layers = params.pop("layers")
    out["layers"] = {}
    for k in list(layers):  # one leaf at a time: the fp32 staging tree shrinks as it goes
        out["layers"][k] = cast(layers.pop(k))
    return out


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
