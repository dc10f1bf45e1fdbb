"""Llama-style decoder in PyTorch: the inference path of the JAX package's
``accelerate_tpu/models/llama.py``, with the same parameter tree, numerics
and public contracts.

Parameters are a plain dict of tensors laid out exactly as the JAX pytree:
per-layer weights stacked on a leading ``[L, ...]`` axis and projections
stored for ``x @ W``.  The JAX ``lax.scan`` over layers becomes a Python loop
over that axis.  :class:`LlamaForCausalLM` wraps the dict as an
``nn.Module``.

Covered here: :class:`LlamaConfig`, the building blocks (RMSNorm, gate
activation, RoPE with llama3 rescaling, projections, einsum attention,
embedding and head), :func:`init_params`, the training forward and loss
(:func:`apply_hidden`, :func:`apply`, :func:`loss_fn` with the dense or the
chunked cross-entropy; attention through the einsum path, the blockwise
``flash`` path or the fused ``pallas`` kernels; per-layer activation
checkpointing under ``remat``), the dense KV cache (:func:`init_cache`,
:func:`apply_cached`), the paged serving forward (:func:`apply_paged`) and
greedy :func:`generate`.  fp8, int8 KV, sequence parallelism and
``remat_policy="dots"`` are not part of this port yet; their config fields
raise ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..state import resolve_device
from ..utils.operations import rename_state_dict

__all__ = [
    "LlamaConfig",
    "LlamaForCausalLM",
    "init_params",
    "apply",
    "apply_hidden",
    "attention_block",
    "labels_and_weights",
    "cross_entropy",
    "loss_fn",
    "init_cache",
    "apply_cached",
    "apply_paged",
    "generate",
    "embed_tokens",
    "final_norm",
    "lm_head",
    "unembed",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field for field the JAX ``LlamaConfig``; ``dtype``/``param_dtype``
    are torch dtypes.  ``remat`` checkpoints each layer of the training
    forward (the JAX ``remat_policy="nothing"``); ``attention_impl`` picks
    the training attention path and ``loss_impl``/``loss_chunk_size`` the
    loss (see :func:`attention_block` and :func:`loss_fn`)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_bias: bool = False
    hidden_act: str = "silu"  # "silu" | "gelu_tanh"
    rms_offset: bool = False
    embed_scale: bool = False
    # ("llama3", factor, low_freq_factor, high_freq_factor, original_max)
    rope_scaling: Optional[tuple] = None
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "nothing"
    attention_impl: str = "auto"
    sp_impl: str = "ring"
    fp8: bool = False
    kv_cache_quant: bool = False
    loss_impl: str = "dense"
    loss_chunk_size: int = 4096

    def __post_init__(self):
        if self.rope_scaling is not None and (
            not isinstance(self.rope_scaling, tuple)
            or len(self.rope_scaling) != 5
            or self.rope_scaling[0] != "llama3"
        ):
            raise ValueError(
                "rope_scaling must be None or ('llama3', factor, "
                f"low_freq_factor, high_freq_factor, original_max), got "
                f"{self.rope_scaling!r}"
            )
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"hidden_act must be 'silu' or 'gelu_tanh', got {self.hidden_act!r}"
            )
        if self.attention_impl not in ("auto", "einsum", "flash", "pallas"):
            raise ValueError(
                "attention_impl must be 'auto', 'einsum', 'flash' or 'pallas', "
                f"got {self.attention_impl!r}"
            )
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError(f"remat_policy must be 'nothing' or 'dots', got {self.remat_policy!r}")
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {self.loss_impl!r}")
        unported = {
            "fp8": self.fp8,
            "kv_cache_quant": self.kv_cache_quant,
            "sp_impl": self.sp_impl != "ring",
            "remat_policy": self.remat_policy != "nothing",
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"LlamaConfig.{name}={getattr(self, name)!r} is not ported to "
                    "accelerate_tpu_torch yet (see ROADMAP.md)"
                )

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config."""
        defaults = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            max_seq_len=128,
            remat=False,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
        )
        defaults.update(kw)
        return cls(**defaults)

    def num_params(self) -> int:
        d, f, v, l = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd = self.head_dim_
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        mlp = 3 * d * f
        norms = 2 * d
        embed = v * d * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp + norms) + embed + d


def _param_shapes(config: LlamaConfig) -> dict:
    c = config
    d, f, hd = c.hidden_size, c.intermediate_size, c.head_dim_
    L = c.num_layers
    shapes = {
        "embed": (c.vocab_size, d),
        "layers": {
            "wq": (L, d, c.num_heads * hd),
            "wk": (L, d, c.num_kv_heads * hd),
            "wv": (L, d, c.num_kv_heads * hd),
            "wo": (L, c.num_heads * hd, d),
            "w_gate": (L, d, f),
            "w_up": (L, d, f),
            "w_down": (L, f, d),
            "ln_attn": (L, d),
            "ln_mlp": (L, d),
        },
        "final_norm": (d,),
    }
    if c.attention_bias:
        shapes["layers"]["bq"] = (L, c.num_heads * hd)
        shapes["layers"]["bk"] = (L, c.num_kv_heads * hd)
        shapes["layers"]["bv"] = (L, c.num_kv_heads * hd)
        shapes["layers"]["bo"] = (L, d)
    if not c.tie_embeddings:
        shapes["lm_head"] = (d, c.vocab_size)
    return shapes


def init_params(config: LlamaConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule: norm
    scales one (zero under ``rms_offset``), biases zero, every other weight
    a normal truncated at two standard deviations times ``1/sqrt(fan_in)``
    (the embedding's fan-in is the hidden size).  Drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``); the numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config

    def init_one(name, shape):
        if name in ("ln_attn", "ln_mlp", "final_norm"):
            fill = torch.zeros if c.rms_offset else torch.ones
            return fill(shape, dtype=c.param_dtype, device=dev)
        if name in ("bq", "bk", "bv", "bo"):
            return torch.zeros(shape, dtype=c.param_dtype, device=dev)
        fan_in = c.hidden_size if name == "embed" else shape[-2]
        out = torch.empty(shape, dtype=c.param_dtype, device=dev)
        # One layer at a time: the fp32 draw of a stacked leaf would double
        # the peak memory of a bf16 model.
        for sub in (out if len(shape) == 3 else [out]):
            draw = torch.empty(sub.shape, dtype=torch.float32, device=dev)
            nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sub.copy_(draw * (1.0 / math.sqrt(fan_in)))
        return out

    shapes = _param_shapes(config)
    params = {k: init_one(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: init_one(k, s) for k, s in shapes["layers"].items()}
    return params


class LlamaForCausalLM(nn.Module):
    """The decoder as an ``nn.Module``: holds the parameter dict as
    ``nn.Parameter``s (random from ``seed`` unless ``params`` is given) on
    ``device`` (default ``cuda``).  ``params`` is the dict view the
    functional API takes.

    ``forward(input_ids, cache)`` is :func:`apply_cached` (serving);
    ``forward(input_ids=..., attention_mask=..., labels=...)`` without a
    cache is the training forward and returns ``{"loss": loss_fn(...)}``,
    the shape ``Accelerator.make_train_step`` and ``backward`` read.

    ``state_dict()`` / ``load_state_dict()`` use the JAX package's flat
    parameter names (``embed``, ``final_norm``, ``lm_head``, ``layers.wq``,
    ...), so a ``model.safetensors`` the JAX package saved for a llama loads
    unchanged."""

    def __init__(self, config: LlamaConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        if params is None:
            params = init_params(config, seed=seed, device=dev)
        self.top = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev)) for k, v in params.items() if k != "layers"})
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev)) for k, v in params["layers"].items()})
        rename_state_dict(self, {f"top.{k}": k for k in self.top})

    @property
    def params(self) -> dict:
        return dict(self.top.items(), layers=dict(self.layers.items()))

    def forward(self, input_ids: torch.Tensor, cache: Optional[dict] = None,
                attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        if cache is not None:
            return apply_cached(self.params, input_ids, self.config, cache)
        batch = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
        return {"loss": loss_fn(self.params, batch, self.config)}

    def generate(self, input_ids: torch.Tensor, max_new_tokens: int, **kw) -> torch.Tensor:
        return generate(self.params, input_ids, self.config, max_new_tokens, **kw)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 statistics regardless of compute dtype.
    x32 = x.float()
    rms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def _norm(x: torch.Tensor, scale: torch.Tensor, c) -> torch.Tensor:
    """RMSNorm with gemma's ``(1 + w)`` scale (multiplied in fp32 before the
    downcast) when ``rms_offset``, the plain llama scale otherwise."""
    if c.rms_offset:
        x32 = x.float()
        rms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + c.rms_eps)
        return (x32 * rms * (1.0 + scale.float())).to(x.dtype)
    return _rms_norm(x, scale, c.rms_eps)


def _act(x: torch.Tensor, c) -> torch.Tensor:
    """Gate activation: SwiGLU's silu, or gemma's tanh-approximate GeLU."""
    if c.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _rope_freqs(hd: int, theta: float, scaling, device=None) -> torch.Tensor:
    """Inverse frequencies, with the llama-3.1 long-context rescaling when
    ``scaling`` is ``("llama3", factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings)``."""
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    if scaling is None:
        return freqs
    _, factor, low_f, high_f, orig = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wavelen = orig / low_f
    high_wavelen = orig / high_f
    scaled = freqs / factor
    smooth = (orig / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * scaled + smooth * freqs
    out = torch.where(wavelen > low_wavelen, scaled, freqs)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(mid, smoothed, out)


def _rope(q, k, positions, theta: float, scaling=None):
    """Rotary embeddings (rotate-half layout, angles in fp32) applied to
    ``[B, S, H, hd]`` queries/keys at integer ``positions`` ``[B, S]``."""
    freqs = _rope_freqs(q.shape[-1], theta, scaling, device=q.device)
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)

    return rot(q), rot(k)


def _attention(q, k, v, mask, num_groups: int):
    """Masked GQA attention, ``[B, S, H, hd]`` x ``[B, T, K, hd]`` with a
    boolean ``mask`` ``[B, S, T]``: scores in fp32, probabilities cast to
    the value dtype."""
    b, s, h, hd = q.shape
    kk = k.shape[2]
    q = q.reshape(b, s, kk, num_groups, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() / math.sqrt(hd)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _mm(h: torch.Tensor, w: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    """Projection matmul ``h @ W`` in the compute dtype."""
    return h @ w.to(c.dtype)


def _qkv_proj(h, p, c, b: int, s: int):
    """Q/K/V projections with the optional Qwen2-style biases (present in
    ``p`` iff ``attention_bias``)."""
    hd = c.head_dim_
    q = _mm(h, p["wq"], c)
    k = _mm(h, p["wk"], c)
    v = _mm(h, p["wv"], c)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (
        q.reshape(b, s, c.num_heads, hd),
        k.reshape(b, s, c.num_kv_heads, hd),
        v.reshape(b, s, c.num_kv_heads, hd),
    )


def _out_proj(attn, p, c):
    """Attention output projection (with the optional bias)."""
    b, s = attn.shape[:2]
    out = _mm(attn.reshape(b, s, -1), p["wo"], c)
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out


def _mlp_block(x, p, c):
    """Pre-norm gated MLP with residual."""
    h = _norm(x, p["ln_mlp"], c)
    gate = _act(_mm(h, p["w_gate"], c), c)
    up = _mm(h, p["w_up"], c)
    return x + _mm(gate * up, p["w_down"], c)


def _out_proj_and_mlp(x, attn, p, c):
    """Attention output projection + residual, then the gated MLP block."""
    return _mlp_block(x + _out_proj(attn, p, c), p, c)


def _layer_params(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def embed_tokens(params: dict, input_ids: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Token embedding lookup in the compute dtype; ``embed_scale``
    multiplies by sqrt(d) cast to the compute dtype (gemma convention)."""
    x = F.embedding(input_ids.long(), params["embed"]).to(config.dtype)
    if config.embed_scale:
        x = x * torch.tensor(config.hidden_size**0.5, dtype=config.dtype)
    return x


def final_norm(params: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    return _norm(x, params["final_norm"], config)


def lm_head(params: dict, config: LlamaConfig) -> torch.Tensor:
    """The ``[d, V]`` head matrix in compute dtype (transposed view when tied)."""
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return head.to(config.dtype)


def unembed(params: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Final norm + LM head -> fp32 logits."""
    return (final_norm(params, x, config) @ lm_head(params, config)).float()


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def _flash_block(s: int):
    """Block of the blockwise flash path (None: the einsum path); sequences
    up to 1024 that no ladder entry divides run as one block."""
    from ..ops.flash_attention import pick_block

    return pick_block(s, max_single_block=1024)


def _use_fused(c: LlamaConfig, s: int, head_dim: int, device: torch.device) -> bool:
    """The fused kernels: always for ``attention_impl="pallas"``; for
    ``"auto"`` on CUDA tensors at ``s >= 1024`` when a fused block divides
    ``s`` (the JAX single-device rule, where the kernels run on the
    accelerator; a head dim the kernels do not take raises there).  CPU
    tensors under ``"auto"`` take the flash or einsum path, as JAX does off
    the TPU."""
    from ..ops.flash_attention import pick_block_pallas

    if c.attention_impl == "pallas":
        return True
    return (c.attention_impl == "auto" and device.type == "cuda" and s >= 1024
            and _flash_block(s) is not None and pick_block_pallas(s, head_dim) is not None)


def _attend(q, k, v, c: LlamaConfig, kv_valid):
    """Causal GQA attention of the training forward, by ``attention_impl``
    (the dispatch of the JAX ``attention_block``): the fused kernels, the
    blockwise flash path, or einsum with ``kv_valid`` folded into the mask."""
    b, s = q.shape[:2]
    if _use_fused(c, s, q.shape[-1], q.device):
        from ..ops.flash_attention import pick_block_pallas
        from ..ops.fused_attention import fused_attention

        blk = pick_block_pallas(s, q.shape[-1])
        if blk is None:
            raise ValueError(
                "attention_impl='pallas' needs a sequence length divisible by "
                f"64/128/256/512/1024 or at most 1024; got seq_len={s}"
            )
        return fused_attention(q, k, v, causal=True, block_size=blk, kv_valid=kv_valid)
    if (c.attention_impl == "flash" or (c.attention_impl == "auto" and s >= 1024)) and (
        _flash_block(s) is not None
    ):
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, block_size=_flash_block(s),
                               kv_valid=kv_valid)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril().expand(b, s, s)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return _attention(q, k, v, mask, c.num_heads // c.num_kv_heads)


def attention_block(x, p, c: LlamaConfig, positions, kv_valid=None) -> torch.Tensor:
    """Pre-norm causal attention sub-block with residual; ``kv_valid``
    ``[B, S]`` bool is the padding mask, kept factored so the flash and
    fused paths never build an ``[S, S]`` mask."""
    h = _norm(x, p["ln_attn"], c)
    b, s, _ = h.shape
    q, k, v = _qkv_proj(h, p, c, b, s)
    q, k = _rope(q, k, positions, c.rope_theta, c.rope_scaling)
    return x + _out_proj(_attend(q, k, v, c, kv_valid), p, c)


def _layer(x, p, c: LlamaConfig, positions, kv_valid=None) -> torch.Tensor:
    return _mlp_block(attention_block(x, p, c, positions, kv_valid), p, c)


def apply_hidden(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
                 positions: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trunk forward: token ids ``[B, S]`` -> final-normed hidden ``[B, S,
    d]`` in the compute dtype.  With an ``attention_mask`` the positions
    count real tokens (left padding gets the right RoPE offsets).  Under
    ``config.remat`` each layer runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of stored."""
    c = config
    b, s = input_ids.shape
    kv_valid = attention_mask.bool() if attention_mask is not None else None
    if positions is None:
        if kv_valid is not None:
            positions = torch.clamp(torch.cumsum(kv_valid.int(), dim=-1) - 1, min=0)
        else:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = embed_tokens(params, input_ids, c)
    # One unbind per stacked leaf: its backward stacks the L layer gradients
    # once, where a per-layer select would add a full [L, ...] zero-padded
    # gradient per layer.
    names = list(params["layers"])
    per_layer = list(zip(*(params["layers"][k].unbind(0) for k in names)))

    def layer(x, *weights):
        return _layer(x, dict(zip(names, weights)), c, positions, kv_valid)

    for weights in per_layer:
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x = layer(x, *weights)
    return final_norm(params, x, c)


def apply(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
          positions: Optional[torch.Tensor] = None,
          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward: token ids ``[B, S]`` -> logits ``[B, S, V]`` fp32."""
    hidden = apply_hidden(params, input_ids, config, positions, attention_mask)
    return (hidden @ lm_head(params, config)).float()


def labels_and_weights(batch: dict):
    """Next-token labels and fp32 loss weights of a batch ``{"input_ids":
    [B, S]}`` (+ optional ``"labels"``, negative = ignored, and
    ``"attention_mask"``)."""
    input_ids = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([input_ids[:, 1:], torch.zeros_like(input_ids[:, :1])], dim=1)
        weights = torch.cat([torch.ones_like(input_ids[:, 1:]),
                             torch.zeros_like(input_ids[:, :1])], dim=1).float()
    else:
        weights = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
    if batch.get("attention_mask") is not None:
        weights = weights * batch["attention_mask"].float()
    return labels, weights


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean token cross-entropy in fp32."""
    logp = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (token_loss * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def loss_fn(params: dict, batch: dict, config: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy, fp32, mean over non-padded targets.
    ``config.loss_impl == "chunked"`` streams the LM head over vocabulary
    tiles (``ops/chunked_ce.py``), so the ``[B, S, V]`` logits never exist."""
    labels, weights = labels_and_weights(batch)
    mask = batch.get("attention_mask")
    if config.loss_impl == "chunked":
        from ..ops.chunked_ce import chunked_cross_entropy

        x = apply_hidden(params, batch["input_ids"], config, attention_mask=mask)
        return chunked_cross_entropy(x, lm_head(params, config), labels, weights,
                                     config.loss_chunk_size)
    logits = apply(params, batch["input_ids"], config, attention_mask=mask)
    return cross_entropy(logits, labels, weights)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------


def init_cache(config: LlamaConfig, batch_size: int, max_len: int, device=None) -> dict:
    """Zeroed KV cache: k/v ``[L, B, max_len, K, hd]`` + write index."""
    from .generation import make_kv_cache

    c = config
    return make_kv_cache(
        c.num_layers, batch_size, max_len, c.num_kv_heads, c.head_dim_, c.dtype,
        device=resolve_device(device),
    )


@torch.no_grad()
def apply_cached(params: dict, input_ids: torch.Tensor, config: LlamaConfig, cache: dict):
    """Forward over new tokens with cache read/write.  ``input_ids`` ``[B, S]``
    are the tokens at positions ``cache['index'] .. index+S``; returns
    (logits ``[B, S, V]`` fp32, cache).  The cache tensors are written in
    place (JAX returns updated copies); the returned dict shares them and
    carries the advanced index."""
    from .generation import cache_write, check_cache_room

    c = config
    b, s = input_ids.shape
    index = int(cache["index"])
    max_len = cache["k"].shape[2]
    check_cache_room(index, s, max_len)
    dev = input_ids.device
    positions = (index + torch.arange(s, device=dev)).expand(b, s)
    x = embed_tokens(params, input_ids, c)
    mask = (positions[:, :, None] >= torch.arange(max_len, device=dev)[None, None, :])
    groups = c.num_heads // c.num_kv_heads
    for i in range(c.num_layers):
        p = _layer_params(params, i)
        h = _norm(x, p["ln_attn"], c)
        q, k, v = _qkv_proj(h, p, c, b, s)
        q, k = _rope(q, k, positions, c.rope_theta, c.rope_scaling)
        k_full = cache_write(cache["k"][i], k, index)
        v_full = cache_write(cache["v"][i], v, index)
        attn = _attention(q, k_full, v_full, mask, groups)
        x = _out_proj_and_mlp(x, attn, p, c)
    return unembed(params, x, c), dict(cache, index=index + s)


@torch.no_grad()
def apply_paged(params: dict, input_ids: torch.Tensor, config: LlamaConfig, pool: dict,
                tables: torch.Tensor, starts: torch.Tensor, kernel: bool = False):
    """Forward over new tokens straight against the paged block pool — the
    serving engine's decode, verify and prefill forward.

    tokens ``[B, T]`` sit at positions ``starts[b] .. starts[b]+T-1``; the
    pool is ``{k, v: [L, N, bs, K, hd]}``, tables ``[B, M]`` int32, starts
    ``[B]`` int32.  Returns (logits ``[B, T, V]`` fp32, the rows this
    forward wrote ``{k, v: [B, L, T, K, hd]}``) for the caller's scatter;
    the pool itself is only read.

    ``kernel=True`` sends attention through the paged kernels: the
    single-token one at ``T == 1``, the window one at ``T > 1``.  On CUDA
    tensors they launch the Hopper kernel or raise; on CPU tensors they run
    their plain version.  ``kernel=False`` gathers the context through the
    tables (``paged_cache_write``) and runs the einsum attention."""
    from ..ops.paged_attention import paged_attention, paged_window_attention
    from .generation import pack_paged_pool_for_scan, paged_cache_write, unpack_paged_rows_from_scan

    c = config
    b, t = input_ids.shape
    pk_all, pv_all = pack_paged_pool_for_scan(pool)
    total = tables.shape[1] * pk_all.shape[2]
    dev = input_ids.device
    positions = starts[:, None].long() + torch.arange(t, device=dev)[None]
    x = embed_tokens(params, input_ids, c)
    mask = positions[:, :, None] >= torch.arange(total, device=dev)[None, None, :]
    groups = c.num_heads // c.num_kv_heads
    k_rows, v_rows = [], []
    for i in range(c.num_layers):
        p = _layer_params(params, i)
        pk, pv = pk_all[i], pv_all[i]
        h = _norm(x, p["ln_attn"], c)
        q, k, v = _qkv_proj(h, p, c, b, t)
        q, k = _rope(q, k, positions, c.rope_theta, c.rope_scaling)
        if kernel:
            k_store = k.to(pk.dtype).contiguous()
            v_store = v.to(pv.dtype).contiguous()
            if t == 1:
                attn = paged_attention(
                    q[:, 0].contiguous(), k_store[:, 0], v_store[:, 0], pk, pv, tables, starts
                )[:, None]
            else:
                attn = paged_window_attention(
                    q.contiguous(), k_store, v_store, pk, pv, tables, starts
                )
        else:
            k_store, k_full = paged_cache_write(pk, k, tables, starts)
            v_store, v_full = paged_cache_write(pv, v, tables, starts)
            attn = _attention(q, k_full, v_full, mask, groups)
        x = _out_proj_and_mlp(x, attn, p, c)
        k_rows.append(k_store)
        v_rows.append(v_store)
    return unembed(params, x, c), unpack_paged_rows_from_scan(k_rows, v_rows)


def generate(params: dict, input_ids: torch.Tensor, config: LlamaConfig, max_new_tokens: int,
             temperature: float = 0.0, max_len: Optional[int] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy autoregressive generation: ``[B, S]`` -> ``[B, S +
    max_new_tokens]``.  Sampling (``temperature > 0``) is not ported yet."""
    from .generation import generate_loop

    return generate_loop(
        apply_cached, init_cache, params, input_ids, config, max_new_tokens,
        temperature=temperature, max_len=max_len, prefill_chunk=prefill_chunk,
    )
