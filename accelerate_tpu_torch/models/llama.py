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
:func:`apply_cached`), the paged serving forward (:func:`apply_paged`),
greedy and sampled :func:`generate`, :func:`speculative_generate` and
:func:`generate_beam`; ``kv_cache_quant`` stores the KV cache as int8 codes
with bf16 scales in both the dense cache and the paged pool.

On a mesh with an active ``fsdp`` or ``tp`` axis the training forward and
loss take a :class:`~..parallel.sharding.Layout` (``layout=``) and each
process holds only its shard of each leaf, laid out by
:data:`PARTITION_RULES` (the JAX table): each layer gathers its weights'
``fsdp`` dims where it runs (again when ``remat`` recomputes it; the
backward reduce-scatters the gradients), and under ``tp`` Megatron's pair
sits where the JAX forward constrains its activations: the column-parallel
Q/K/V, gate and up projections take their input through
:func:`~..parallel.collectives.tp_copy`, the row-parallel output and down
projections give theirs through :func:`~..parallel.collectives.tp_reduce`,
the embedding is the JAX one-hot lookup over the local vocabulary rows,
and the loss reduces its max and sum of exponentials over ``tp``.  Head
counts come from the local shapes, so the attention (the fused kernels
too) runs on this process's heads.

On a layout whose ``sp`` axis is active the training forward runs on this
process's chunk of ``S / sp`` tokens: the ids, RoPE positions (the
padding-aware count over the whole row), labels and loss weights are made
for the whole sequence and then sliced, so a chunk's last label is the
next chunk's first token; attention goes through :func:`sp_attention`
(the ring over the fused kernels, the einsum ring for padded batches, or
Ulysses under ``sp_impl="ulysses"``); the loss is this process's weighted
sum over the global weight sum, reported summed over ``sp``, and each
replicated leaf's gradient is its chunk's part, which the optimizer sums
over ``sp``.  :func:`apply_hidden` and :func:`apply` return the sequence
gathered over ``sp``, as JAX returns its global array.  fp8 is not part of
this port yet; its config field raises ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..parallel.collectives import tp_copy, tp_reduce
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
    "speculative_generate",
    "generate_beam",
    "sp_attention",
    "embed_tokens",
    "final_norm",
    "lm_head",
    "unembed",
    "PARTITION_RULES",
    "param_specs",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field for field the JAX ``LlamaConfig``; ``dtype``/``param_dtype``
    are torch dtypes.  ``remat`` checkpoints each layer of the training
    forward: under ``remat_policy="nothing"`` the backward recomputes the
    whole layer, under ``"dots"`` it keeps the products without batch
    dimensions (the seven projections) and recomputes the rest (see
    :func:`apply_hidden`); ``attention_impl`` picks the training attention
    path, ``sp_impl`` the sequence-parallel one (:func:`sp_attention`), and
    ``loss_impl``/``loss_chunk_size`` the loss (see :func:`attention_block`
    and :func:`loss_fn`)."""

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
        if self.fp8:
            raise NotImplementedError(
                f"LlamaConfig.fp8={self.fp8!r} is not ported to accelerate_tpu_torch yet "
                "(see ROADMAP.md)"
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


# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``llama.PARTITION_RULES``: matmul weights split their contraction-free
# dim on ``tp`` (Megatron's layout) and the other on ``fsdp``.
PARTITION_RULES: list = [
    (r"embed", ("tp", "fsdp")),
    (r"layers/wq", (None, "fsdp", "tp")),
    (r"layers/wk", (None, "fsdp", "tp")),
    (r"layers/wv", (None, "fsdp", "tp")),
    (r"layers/wo", (None, "tp", "fsdp")),
    (r"layers/w_gate", (None, "fsdp", "tp")),
    (r"layers/w_up", (None, "fsdp", "tp")),
    (r"layers/w_down", (None, "tp", "fsdp")),
    (r"layers/b[qkv]$", (None, "tp")),
    (r"layers/bo$", (None, "fsdp")),
    (r"layers/ln_", (None, None)),
    (r"final_norm", (None,)),
    (r"lm_head", ("fsdp", "tp")),
]


def param_specs(config: LlamaConfig) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    from ..parallel.sharding import specs_from_rules

    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


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
    unchanged.

    ``Accelerator.prepare`` shards it by :attr:`partition_rules` on a mesh
    with an active ``fsdp`` or ``tp`` axis and sets its ``_layout``, which
    the training forward then passes to :func:`loss_fn`."""

    partition_rules = PARTITION_RULES
    _layout = None

    @staticmethod
    def _family():
        """The module whose functions this class wraps (a subclass in another
        family's module names that module)."""
        return sys.modules[__name__]

    def __init__(self, config: LlamaConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        if params is None:
            params = self._family().init_params(config, seed=seed, device=dev)
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
        fam = self._family()
        if cache is not None:
            _refuse_sharded_serving(self._layout)
            return fam.apply_cached(self.params, input_ids, self.config, cache)
        batch = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
        if self._layout is not None:
            return {"loss": fam.loss_fn(self.params, batch, self.config, layout=self._layout)}
        return {"loss": fam.loss_fn(self.params, batch, self.config)}

    # The llama family's and Mixtral's sharded forwards run this process's
    # chunk of the sequence on an active ``sp`` axis (the Layout reads it).
    splits_sequence = True

    def handles_layout(self) -> bool:
        """Whether the forward realizes a sharded layout itself (the family's
        own loss takes ``layout=``), rather than taking every leaf gathered
        whole: every family with a rule table."""
        return hasattr(self._family(), "PARTITION_RULES")

    def _forward_cast_at_use(self, compute_dtype: torch.dtype, input_ids: torch.Tensor,
                             cache: Optional[dict] = None,
                             attention_mask: Optional[torch.Tensor] = None,
                             labels: Optional[torch.Tensor] = None):
        """:meth:`forward` under a 16-bit ``PreparedModel``, to the values of
        a forward over ``compute_dtype`` copies of every parameter: the
        embedding, norm and head weights are cast here, each layer's
        weights inside its (checkpointed) layer of :func:`apply_hidden`, so
        a layer's 16-bit copy lives only while the layer runs and again
        while the backward recomputes it."""
        fam = self._family()
        params = self.params
        if cache is None and self._layout is not None:
            batch = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
            return {"loss": fam.loss_fn(params, batch, self.config, layer_dtype=compute_dtype,
                                        layout=self._layout)}
        _refuse_sharded_serving(self._layout if cache is not None else None)
        cast = {k: v.to(compute_dtype) for k, v in params.items() if k != "layers"}
        if cache is not None:
            cast["layers"] = {k: v.to(compute_dtype) for k, v in params["layers"].items()}
            return fam.apply_cached(cast, input_ids, self.config, cache)
        cast["layers"] = params["layers"]
        batch = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
        return {"loss": fam.loss_fn(cast, batch, self.config, layer_dtype=compute_dtype)}

    def generate(self, input_ids: torch.Tensor, max_new_tokens: int, **kw) -> torch.Tensor:
        return self._family().generate(self.params, input_ids, self.config, max_new_tokens,
                                       **kw)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in its own dtype where that is wider (fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 statistics regardless of compute dtype (fp64 stays fp64).
    x32 = _wide(x)
    rms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def _norm(x: torch.Tensor, scale: torch.Tensor, c) -> torch.Tensor:
    """RMSNorm with gemma's ``(1 + w)`` scale (multiplied in fp32 before the
    downcast) when ``rms_offset``, the plain llama scale otherwise.  The
    shared helpers read the optional llama fields with their defaults, as
    the JAX ones do, so a config without them (mixtral's) takes the plain
    path."""
    if getattr(c, "rms_offset", False):
        x32 = x.float()
        rms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + c.rms_eps)
        return (x32 * rms * (1.0 + scale.float())).to(x.dtype)
    return _rms_norm(x, scale, c.rms_eps)


def _act(x: torch.Tensor, c) -> torch.Tensor:
    """Gate activation: SwiGLU's silu, or gemma's tanh-approximate GeLU."""
    if getattr(c, "hidden_act", "silu") == "gelu_tanh":
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


def _qkv_proj(h, p, c, b: int, s: int, q_heads=None):
    """Q/K/V projections with the optional Qwen2-style biases (present in
    ``p`` iff ``attention_bias``); the head counts come from the weights'
    widths (this process's heads under ``tp``).  ``q_heads`` (this
    process's first query head and count under ``tp``) with whole K/V
    weights (``tp`` not dividing the kv heads): only the kv heads those
    query heads read (``ih // g``) are projected, and where they do not
    read them in equal groups each query head gets its own copy."""
    hd = c.head_dim_
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    pick = None
    if q_heads is not None and wk.shape[-1] == c.num_kv_heads * hd:
        lo, n = q_heads
        g = c.num_heads // c.num_kv_heads
        klo, khi = lo // g, (lo + n - 1) // g + 1
        cols = slice(klo * hd, khi * hd)
        wk, wv = wk[..., cols], wv[..., cols]
        if bk is not None:
            bk, bv = bk[..., cols], bv[..., cols]
        counts = {j: sum(1 for i in range(lo, lo + n) if i // g == j) for j in range(klo, khi)}
        if len(set(counts.values())) > 1:
            pick = torch.tensor([i // g - klo for i in range(lo, lo + n)], device=h.device)
    q = _mm(h, p["wq"], c)
    k = _mm(h, wk, c)
    v = _mm(h, wv, c)
    if bk is not None:
        q = q + p["bq"].to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    q, k, v = q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd)
    if pick is not None:
        k, v = k[:, :, pick], v[:, :, pick]
    return q, k, v


def _out_proj(attn, p, c, group=None):
    """Attention output projection (with the optional bias); under ``tp``
    (``group``) a row-parallel product whose partial sums ``tp_reduce``
    adds before the bias."""
    b, s = attn.shape[:2]
    out = tp_reduce(_mm(attn.reshape(b, s, -1), p["wo"], c), group)
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out


def _mlp_block(x, p, c, group=None):
    """Pre-norm gated MLP with residual; under ``tp`` (``group``) gate and
    up are column-parallel (their input through ``tp_copy``), down is
    row-parallel (its output through ``tp_reduce``)."""
    h = tp_copy(_norm(x, p["ln_mlp"], c), group)
    gate = _act(_mm(h, p["w_gate"], c), c)
    up = _mm(h, p["w_up"], c)
    return x + tp_reduce(_mm(gate * up, p["w_down"], c), group)


def _out_proj_and_mlp(x, attn, p, c):
    """Attention output projection + residual, then the gated MLP block."""
    return _mlp_block(x + _out_proj(attn, p, c), p, c)


def _layer_params(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def embed_tokens(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
                 layout=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Token embedding lookup in the compute dtype; ``embed_scale``
    multiplies by sqrt(d) cast to the compute dtype (gemma convention).  On
    a model-sharded ``layout``: the table's ``fsdp`` dim gathered in
    ``dtype`` (default the compute dtype), then the JAX one-hot lookup
    over this process's vocabulary rows, summed over ``tp``."""
    if _model_sharded(layout):
        from ..parallel.sharding import vocab_lookup

        table = layout.full(params["embed"], layout.spec("embed"), dtype or config.dtype)
        x = vocab_lookup(table, input_ids, config.dtype, layout)
    else:
        x = F.embedding(input_ids.long(), params["embed"]).to(config.dtype)
    if getattr(config, "embed_scale", False):
        x = x * torch.tensor(config.hidden_size**0.5, dtype=config.dtype)
    return x


def final_norm(params: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    return _norm(x, params["final_norm"], config)


def lm_head(params: dict, config: LlamaConfig, layout=None,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The ``[d, V]`` head matrix in compute dtype (transposed view when
    tied); on a model-sharded ``layout`` its ``fsdp`` dim gathered in
    ``dtype`` (default the compute dtype), its ``tp`` columns local."""
    tied = getattr(config, "tie_embeddings", False)
    name = "embed" if tied else "lm_head"
    head = params[name]
    if _model_sharded(layout):
        head = layout.full(head, layout.spec(name), dtype or config.dtype)
    return (head.T if tied else head).to(config.dtype)


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

    impl = getattr(c, "attention_impl", "auto")
    if impl == "pallas":
        return True
    return (impl == "auto" and device.type == "cuda" and s >= 1024
            and _flash_block(s) is not None and pick_block_pallas(s, head_dim) is not None)


def _sp_active(layout):
    """The mesh of ``layout`` when its ``sp`` axis is active (the sharded
    forward then runs on this process's chunk of the sequence), else
    None."""
    return layout.mesh if layout is not None and layout.sp > 1 else None


def sp_attention(q, k, v, c, *, causal: bool = True, kv_valid=None, mesh=None):
    """The shared sequence-parallel attention of every family, on this
    process's chunk (q ``[B, S/sp, H, hd]``, k/v ``[B, S/sp, K, hd]``,
    ``kv_valid`` the chunk's key validity) over ``mesh``'s ``sp`` axis (the
    live state's by default), with the JAX dispatch: Ulysses under
    ``sp_impl="ulysses"`` (the fused kernels as its local attention where
    :func:`_use_fused` picks them for this process's chunk); else the ring
    over the fused kernels where they are picked and the batch is not
    padded; else the einsum ring.  ``c`` needs no field: ``sp_impl`` and
    ``attention_impl`` default to ``"ring"`` and ``"auto"`` (GPT-2, BERT
    and ViT have no ``attention_impl``)."""
    sp_pallas = _use_fused(c, q.shape[1], q.shape[-1], q.device)
    if getattr(c, "sp_impl", "ring") == "ulysses":
        from ..ops.ulysses_attention import ulysses_attention

        return ulysses_attention(q, k, v, mesh=mesh, axis_name="sp", causal=causal,
                                 kv_valid=kv_valid, impl="pallas" if sp_pallas else None)
    if sp_pallas and kv_valid is None:
        from ..ops.ring_fused import ring_fused_attention

        return ring_fused_attention(q, k, v, mesh=mesh, axis_name="sp", causal=causal)
    from ..ops.ring_attention import ring_attention

    return ring_attention(q, k, v, mesh=mesh, axis_name="sp", causal=causal, kv_valid=kv_valid)


def _refuse_sp_fused() -> None:
    """The fused kernels run on whole sequences: under a live mesh whose
    ``sp`` axis is active they raise (the JAX ``pallas_attention_spmd``'s
    refusal); the sharded forward takes :func:`sp_attention` there."""
    from ..parallel.sharding import _live_mesh

    mesh = _live_mesh()
    if mesh is not None and mesh.shape["sp"] > 1:
        raise ValueError("the fused attention does not shard the sequence axis; use "
                         "ring/ulysses for sp>1 (pass the model's layout)")


def _attend(q, k, v, c: LlamaConfig, kv_valid, sp_mesh=None):
    """Causal GQA attention of the training forward, by ``attention_impl``
    (the dispatch of the JAX ``attention_block``): on ``sp_mesh`` (an active
    ``sp`` axis) :func:`sp_attention`; else the fused kernels, the
    blockwise flash path, or einsum with ``kv_valid`` folded into the mask."""
    if sp_mesh is not None:
        return sp_attention(q, k, v, c, causal=True, kv_valid=kv_valid, mesh=sp_mesh)
    b, s = q.shape[:2]
    if _use_fused(c, s, q.shape[-1], q.device):
        from ..ops.flash_attention import pick_block_pallas
        from ..ops.fused_attention import fused_attention

        _refuse_sp_fused()
        blk = pick_block_pallas(s, q.shape[-1])
        if blk is None:
            raise ValueError(
                "attention_impl='pallas' needs a sequence length divisible by "
                f"64/128/256/512/1024 or at most 1024; got seq_len={s}"
            )
        return fused_attention(q, k, v, causal=True, block_size=blk, kv_valid=kv_valid)
    impl = getattr(c, "attention_impl", "auto")
    if (impl == "flash" or (impl == "auto" and s >= 1024)) and (
        _flash_block(s) is not None
    ):
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, block_size=_flash_block(s),
                               kv_valid=kv_valid)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril().expand(b, s, s)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return _attention(q, k, v, mask, q.shape[2] // k.shape[2])


def attention_block(x, p, c: LlamaConfig, positions, kv_valid=None, group=None,
                    q_heads=None, sp_mesh=None) -> torch.Tensor:
    """Pre-norm causal attention sub-block with residual; ``kv_valid``
    ``[B, S]`` bool is the padding mask, kept factored so the flash and
    fused paths never build an ``[S, S]`` mask.  Under ``tp`` (``group``,
    with ``q_heads`` this process's first query head and count) Q/K/V are
    column-parallel (their input through ``tp_copy``) and the attention
    runs on this process's heads; where ``tp`` does not divide the query
    heads (``q_heads`` None) the caller passes whole weights and every
    process computes every head.  ``sp_mesh``: ``x`` is this process's
    chunk of the sequence and the attention is :func:`sp_attention`."""
    if q_heads is None or group is None:
        group = q_heads = None
    h = tp_copy(_norm(x, p["ln_attn"], c), group)
    b, s, _ = h.shape
    q, k, v = _qkv_proj(h, p, c, b, s, q_heads)
    q, k = _rope(q, k, positions, c.rope_theta, getattr(c, "rope_scaling", None))
    return x + _out_proj(_attend(q, k, v, c, kv_valid, sp_mesh), p, c, group)


def _layer(x, p, c: LlamaConfig, positions, kv_valid=None, group=None,
           q_heads=None, sp_mesh=None) -> torch.Tensor:
    x = attention_block(x, p, c, positions, kv_valid, group, q_heads, sp_mesh)
    return _mlp_block(x, p, c, group)


_Q_LEAVES = ("wq", "wo", "bq")
_KV_LEAVES = ("wk", "wv", "bk", "bv")


def sharded_layers(params: dict, c, layout, layer_dtype=None):
    """The sharded path's per-layer plumbing, for this family and every
    family built on its attention (Mixtral): ``(names, per_layer, prep,
    group, q_heads)``.  ``per_layer`` holds each layer's leaves (one
    ``unbind`` per stacked leaf: its backward stacks the L layer gradients
    once, where a per-layer select would add a full zero-padded gradient
    per layer); ``prep(name, leaf)`` gives a layer's leaf as the layer uses
    it, gathered over ``fsdp`` (cast first to the dtype the use casts to:
    the compute dtype, the norm scales keeping theirs) and, where ``tp``
    does not divide the heads, over ``tp``; ``group`` is the ``tp`` group
    and ``q_heads`` this process's first query head and count (None where
    every process computes every head, or off a sharded layout).  The heads
    ``tp`` does not divide are computed whole (JAX's ``tp_head_axis``
    keeps them off ``tp``): the K/V leaves gathered with a backward that
    sums over ``tp`` where each process reads only the kv heads of its
    query heads, every attention leaf gathered with a backward that keeps
    this process's chunk where it computes every head.  Without a
    model-sharded ``layout``: the leaves as they are, cast to
    ``layer_dtype``."""
    names = list(params["layers"])
    per_layer = list(zip(*(params["layers"][k].unbind(0) for k in names)))
    if not _model_sharded(layout):
        def plain(k, w):
            return w if layer_dtype is None else w.to(layer_dtype)

        return names, per_layer, plain, None, None
    group = layout.tp_group()
    q_heads = layout.heads(c.num_heads)
    gather = {}
    if layout.tp > 1 and q_heads is None:
        gather = dict.fromkeys(_Q_LEAVES + _KV_LEAVES, "slice")
    elif layout.tp > 1 and layout.heads(c.num_kv_heads) is None:
        gather = dict.fromkeys(_KV_LEAVES, "sum")
    use_dtype = layer_dtype or c.dtype
    specs = {k: layout.spec(f"layers/{k}")[1:] for k in names}

    def prep(k, w):
        return layout.full(w, specs[k], layer_dtype if k.startswith("ln_") else use_dtype,
                           tp_grad=gather.get(k))

    return names, per_layer, prep, group, q_heads


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``, the JAX
    ``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without batch dimensions (``h @ W`` on a 3-D ``h`` reaches the
    dispatcher as ``mm``), recompute everything else (``bmm``, the einsum
    attention, the norms, RoPE, and the fused attention kernels, whose
    ``autograd.Function`` launches no aten op the policy could keep)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def apply_hidden(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
                 positions: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 layer_dtype: Optional[torch.dtype] = None, layout=None) -> torch.Tensor:
    """Trunk forward: token ids ``[B, S]`` -> final-normed hidden ``[B, S,
    d]`` in the compute dtype.  With an ``attention_mask`` the positions
    count real tokens (left padding gets the right RoPE offsets).  Under
    ``config.remat`` each layer runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of stored, all of
    them under ``remat_policy="nothing"``, all but the outputs of ``mm`` /
    ``addmm`` under ``"dots"`` (:func:`_save_dots`).  ``layer_dtype``
    casts each layer's weights to it inside the layer (and so inside its
    checkpoint), the mixed-precision wrapper's cast at use.  ``layout``: the
    sharded path (module docstring), on a mesh with an active ``fsdp``,
    ``tp``, ``ep`` or ``sp`` axis; under ``sp`` the hidden is gathered over
    ``sp`` (each process then holds the whole sequence)."""
    x = _trunk(params, input_ids, config, positions, attention_mask, layer_dtype, layout)
    return sp_gather(x, layout)


def sp_gather(x: torch.Tensor, layout) -> torch.Tensor:
    """``x`` (this process's chunk along dim 1) gathered over ``sp`` where
    ``layout``'s ``sp`` axis is active, else ``x``: every process then reads
    the whole, so the backward keeps this process's chunk of the
    gradient."""
    if _sp_active(layout) is None:
        return x
    from ..parallel.collectives import tp_gather

    return tp_gather(x, 1, layout.sp_group(), partial=False, axis="sp")


def sp_inputs(layout, s: int, *tensors):
    """Each ``[B, S, ...]`` tensor of ``tensors`` (None passes through) cut
    to this process's chunk of the sequence where ``layout``'s ``sp`` axis
    is active, else as given."""
    if _sp_active(layout) is None:
        return tensors
    chunk = layout.seq_chunk(s)
    return tuple(None if t is None else t[:, chunk] for t in tensors)


def _positions(input_ids, positions, kv_valid):
    """RoPE positions of the whole row: the padding-aware count of real
    tokens under a mask, else ``0 .. S-1``."""
    if positions is not None:
        return positions
    b, s = input_ids.shape
    if kv_valid is not None:
        return torch.clamp(torch.cumsum(kv_valid.int(), dim=-1) - 1, min=0)
    return torch.arange(s, device=input_ids.device).expand(b, s)


def _trunk(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
           positions: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           layer_dtype: Optional[torch.dtype] = None, layout=None) -> torch.Tensor:
    """:func:`apply_hidden` before the gather: under ``sp`` the final-normed
    hidden of this process's chunk of the sequence."""
    c = config
    kv_valid = attention_mask.bool() if attention_mask is not None else None
    positions = _positions(input_ids, positions, kv_valid)
    input_ids, positions, kv_valid = sp_inputs(layout, input_ids.shape[1], input_ids,
                                                positions, kv_valid)
    sp_mesh = _sp_active(layout)
    names, per_layer, prep, group, q_heads = sharded_layers(params, c, layout, layer_dtype)
    x = embed_tokens(params, input_ids, c, layout, layer_dtype)

    def layer(x, *weights):
        p = {k: prep(k, w) for k, w in zip(names, weights)}
        return _layer(x, p, c, positions, kv_valid, group, q_heads, sp_mesh)

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if c.remat_policy == "dots" else noop_context_fn)
    for weights in per_layer:
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *weights, use_reentrant=False, context_fn=context_fn)
        else:
            x = layer(x, *weights)
    scale = params["final_norm"]
    if _model_sharded(layout):
        scale = layout.full(scale, layout.spec("final_norm"), layer_dtype)
    return _norm(x, scale, c)


def apply(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
          positions: Optional[torch.Tensor] = None,
          attention_mask: Optional[torch.Tensor] = None,
          layer_dtype: Optional[torch.dtype] = None, layout=None) -> torch.Tensor:
    """Training forward: token ids ``[B, S]`` -> logits ``[B, S, V]`` fp32
    (``layer_dtype`` and ``layout`` as in :func:`apply_hidden`: under
    ``sp`` each process's chunk of the logits, gathered; the head's ``tp``
    columns are not gathered, so a ``tp`` layout raises)."""
    if layout is not None and layout.tp > 1:
        raise NotImplementedError("apply on a tp layout: the logits' vocabulary is split; "
                                  "use loss_fn")
    hidden = _trunk(params, input_ids, config, positions, attention_mask, layer_dtype, layout)
    return sp_gather((hidden @ lm_head(params, config, layout, layer_dtype)).float(), layout)


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
                  weights: torch.Tensor, denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean token cross-entropy in fp32; ``denom`` replaces the
    weights' own sum (floored at 1) as the divisor (a sequence chunk's
    share of the whole's mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (token_loss * weights).sum() / _denom(weights, denom)


def _denom(weights: torch.Tensor, denom: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.clamp(weights.sum(), min=1.0) if denom is None else denom


def loss_fn(params: dict, batch: dict, config: LlamaConfig,
            layer_dtype: Optional[torch.dtype] = None, layout=None) -> torch.Tensor:
    """Next-token cross-entropy, fp32, mean over non-padded targets.
    ``config.loss_impl == "chunked"`` streams the LM head over vocabulary
    tiles (``ops/chunked_ce.py``), so the ``[B, S, V]`` logits never exist.
    ``layer_dtype`` and ``layout`` as in :func:`apply_hidden`; under ``tp``
    both losses reduce their statistics over the vocabulary shards."""
    labels, weights = labels_and_weights(batch)
    x = _trunk(params, batch["input_ids"], config, attention_mask=batch.get("attention_mask"),
               layer_dtype=layer_dtype, layout=layout)
    return token_loss(x, params, labels, weights, config, layout, layer_dtype)


def token_loss(x, params: dict, labels, weights, config, layout=None,
               layer_dtype: Optional[torch.dtype] = None, head=None) -> torch.Tensor:
    """The head (:func:`lm_head` unless ``head`` is given: another family's
    ``[d, V]`` head) and the weighted-mean cross-entropy of the final hidden
    ``x``: dense, chunked (``config.loss_impl``), or under ``tp`` over the
    vocabulary shards (:func:`_loss_vocab_parallel`).  Under ``sp`` ``x`` is
    this process's chunk and ``labels`` / ``weights`` the whole sequence's:
    the chunk's weighted sum over the global weight sum, summed over ``sp``
    (:func:`sp_sum`)."""
    if head is None:
        head = lm_head(params, config, layout, layer_dtype)
    labels, weights = sp_inputs(layout, labels.shape[1], labels, weights)
    denom = sp_denominator(weights, layout)
    if layout is not None and layout.tp > 1:
        loss = _loss_vocab_parallel(x, head, labels, weights, config, layout, denom)
    elif config.loss_impl == "chunked":
        from ..ops.chunked_ce import chunked_cross_entropy

        loss = chunked_cross_entropy(x, head, labels, weights, config.loss_chunk_size, denom)
    else:
        loss = cross_entropy((x @ head).float(), labels, weights, denom)
    return sp_sum(loss, layout)


def sp_denominator(weights: torch.Tensor, layout) -> Optional[torch.Tensor]:
    """Under ``sp``: the whole sequence's weight sum (this process's chunk's
    ``weights`` summed over ``sp``, no gradient), floored at 1; else None
    (each loss divides by its own weights' sum)."""
    if _sp_active(layout) is None:
        return None
    from ..parallel.collectives import all_reduce

    total = all_reduce(weights.detach().sum().clone(), group=layout.sp_group(), axis="sp")
    return torch.clamp(total, min=1.0)


def sp_sum(loss: torch.Tensor, layout) -> torch.Tensor:
    """A chunk's part of a loss that sums over the sequence, summed over
    ``sp`` (the value every process reports) with the identity backward (each
    process's gradient stays its chunk's part); ``loss`` itself off
    ``sp``."""
    if _sp_active(layout) is None:
        return loss
    return tp_reduce(loss, layout.sp_group(), "sp")


def _model_sharded(layout) -> bool:
    """Whether ``layout``'s mesh has an active model axis, ``fsdp``, ``tp``
    or ``ep`` (the gate of this module's sharded path)."""
    return layout is not None and any(layout.mesh.shape[a] > 1 for a in ("fsdp", "tp", "ep"))


def _refuse_sharded_serving(layout, params: Optional[dict] = None) -> None:
    """Serving takes whole weights: a layout on a model-sharded mesh, or a
    leaf that is one process's shard, raises."""
    from ..parallel.sharding import _leaves, is_sharded, spec_of

    shards = params is not None and any(is_sharded(spec_of(t))
                                        for t in _leaves(params, torch.Tensor))
    if _model_sharded(layout) or shards:
        raise NotImplementedError(
            "serving (apply_cached / apply_paged) on a model-sharded mesh is not ported to "
            "accelerate_tpu_torch yet (ROADMAP A6 part 5); gather the weights "
            "(Accelerator.unwrap_model or get_state_dict) and serve them whole")


def _loss_vocab_parallel(x, head, labels, weights, c: LlamaConfig, layout, denom=None):
    """:func:`loss_fn`'s cross-entropy under ``tp``: ``head`` holds this
    process's vocabulary columns, and the logits' max and sum of
    exponentials (and the label's logit, on the rank that holds it) are
    reduced over ``tp``."""
    from ..ops.chunked_ce import chunked_ce_stats
    from ..parallel.collectives import all_reduce

    group = layout.tp_group()
    x = tp_copy(x, group)
    v_local = head.shape[1]
    local = labels.long() - layout.tp_rank * v_local
    hit = (local >= 0) & (local < v_local)
    if c.loss_impl == "chunked":
        # The running max stays in the graph, as in the one-process loss:
        # m + log(s) does not depend on it, nor does s * exp(m - top).
        m, s, label_logit = chunked_ce_stats(x, head, torch.where(hit, local, -1),
                                             c.loss_chunk_size)
        top = all_reduce(m.detach().clone(), op="max", group=group, axis="tp")
        total = tp_reduce(s * torch.exp(m - top), group)
    else:
        logits = (x @ head).float()
        top = all_reduce(logits.detach().amax(-1), op="max", group=group, axis="tp")
        total = tp_reduce(torch.exp(logits - top[..., None]).sum(-1), group)
        got = torch.gather(logits, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
        label_logit = torch.where(hit, got, torch.zeros_like(got))
    label_logit = tp_reduce(label_logit, group)
    token_loss = (top + torch.log(total)) - label_logit
    return (token_loss * weights).sum() / _denom(weights, denom)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------


def init_cache(config: LlamaConfig, batch_size: int, max_len: int, device=None) -> dict:
    """Zeroed KV cache: k/v ``[L, B, max_len, K, hd]`` + write index;
    ``config.kv_cache_quant`` stores int8 codes with bf16 scales."""
    from .generation import make_kv_cache

    c = config
    return make_kv_cache(
        c.num_layers, batch_size, max_len, c.num_kv_heads, c.head_dim_, c.dtype,
        device=resolve_device(device), quantized=c.kv_cache_quant,
    )


@torch.no_grad()
def apply_cached(params: dict, input_ids: torch.Tensor, config: LlamaConfig, cache: dict):
    """Forward over new tokens with cache read/write.  ``input_ids`` ``[B, S]``
    are the tokens at positions ``cache['index'] .. index+S``; returns
    (logits ``[B, S, V]`` fp32, cache).  The cache tensors are written in
    place (JAX returns updated copies); the returned dict shares them and
    carries the advanced index."""
    from .generation import check_cache_room

    _refuse_sharded_serving(None, params)
    c = config
    b, s = input_ids.shape
    index = int(cache["index"])
    check_cache_room(index, s, cache["k"].shape[2])
    positions, mask = _cache_positions_and_mask(index, b, s, cache, input_ids.device)
    x = embed_tokens(params, input_ids, c)
    for i in range(c.num_layers):
        p = _layer_params(params, i)
        x = _attention_block_cached(x, p, c, _cache_layer(cache, "k", i),
                                    _cache_layer(cache, "v", i), index, positions, mask)
        x = _mlp_block(x, p, c)
    return unembed(params, x, c), dict(cache, index=index + s)


def _cache_positions_and_mask(index: int, b: int, s: int, cache: dict, device):
    """Positions ``[B, S]`` of ``S`` new tokens written at ``index`` and the
    causal mask ``[B, S, max_len]`` over the dense cache."""
    positions = (index + torch.arange(s, device=device)).expand(b, s)
    max_len = cache["k"].shape[2]
    return positions, positions[:, :, None] >= torch.arange(max_len, device=device)[None, None, :]


def _cache_layer(cache: dict, name: str, i: int):
    """Layer ``i`` of the cache leaf ``name``: a tensor, or (codes, scale)
    of the int8 cache."""
    if "k_scale" in cache:
        return cache[name][i], cache[name + "_scale"][i]
    return cache[name][i]


def _attention_block_cached(x, p, c, ck, cv, index: int, positions, mask) -> torch.Tensor:
    """Pre-norm attention sub-block against the dense cache, with residual
    (shared by llama and mixtral, as in the JAX package): writes the new
    K/V rows at ``index`` into ``ck`` / ``cv`` (layer views of the cache,
    in place) and attends over the whole cache under ``mask``."""
    from .generation import cache_write

    b, s, _ = x.shape
    h = _norm(x, p["ln_attn"], c)
    q, k, v = _qkv_proj(h, p, c, b, s)
    q, k = _rope(q, k, positions, c.rope_theta, getattr(c, "rope_scaling", None))
    k_full = cache_write(ck, k, index, c.dtype)
    v_full = cache_write(cv, v, index, c.dtype)
    return x + _out_proj(_attention(q, k_full, v_full, mask, c.num_heads // c.num_kv_heads), p, c)


@torch.no_grad()
def apply_paged(params: dict, input_ids: torch.Tensor, config: LlamaConfig, pool: dict,
                tables: torch.Tensor, starts: torch.Tensor, kernel: bool = False):
    """Forward over new tokens straight against the paged block pool — the
    serving engine's decode, verify and prefill forward.

    tokens ``[B, T]`` sit at positions ``starts[b] .. starts[b]+T-1``; the
    pool is ``{k, v: [L, N, bs, K, hd]}`` (the int8 pool adds ``k_scale``,
    ``v_scale``: ``[L, N, bs, K]``), tables ``[B, M]`` int32, starts ``[B]``
    int32.  Returns (logits ``[B, T, V]`` fp32, the rows this forward wrote,
    one ``[B, L, T, ...]`` entry per pool leaf) for the caller's scatter;
    the pool itself is only read.

    ``kernel=True`` sends attention of an fp pool through the paged
    kernels: the single-token one at ``T == 1``, the window one at ``T >
    1``.  On CUDA tensors they launch the Hopper kernel or raise; on CPU
    tensors they run their plain version.  An int8 pool takes the plain
    path whatever ``kernel`` says, as in the JAX package, whose kernels
    read fp pools only.  ``kernel=False`` gathers the context through the
    tables (``paged_cache_write``) and runs the einsum attention."""
    from ..ops.paged_attention import paged_attention, paged_window_attention
    from .generation import pack_paged_pool_for_scan, paged_cache_write, unpack_paged_rows_from_scan

    _refuse_sharded_serving(None, params)
    c = config
    b, t = input_ids.shape
    pk_all, pv_all, quant = pack_paged_pool_for_scan(pool)
    use_kernel = kernel and not quant
    total = tables.shape[1] * pool["k"].shape[2]
    dev = input_ids.device
    positions = starts[:, None].long() + torch.arange(t, device=dev)[None]
    x = embed_tokens(params, input_ids, c)
    mask = positions[:, :, None] >= torch.arange(total, device=dev)[None, None, :]
    groups = c.num_heads // c.num_kv_heads
    k_rows, v_rows = [], []
    for i in range(c.num_layers):
        p = _layer_params(params, i)
        if quant:
            pk, pv = (pk_all[0][i], pk_all[1][i]), (pv_all[0][i], pv_all[1][i])
        else:
            pk, pv = pk_all[i], pv_all[i]
        h = _norm(x, p["ln_attn"], c)
        q, k, v = _qkv_proj(h, p, c, b, t)
        q, k = _rope(q, k, positions, c.rope_theta, getattr(c, "rope_scaling", None))
        if use_kernel:
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
            k_store, k_full = paged_cache_write(pk, k, tables, starts, c.dtype)
            v_store, v_full = paged_cache_write(pv, v, tables, starts, c.dtype)
            attn = _attention(q, k_full, v_full, mask, groups)
        x = _out_proj_and_mlp(x, attn, p, c)
        k_rows.append(k_store)
        v_rows.append(v_store)
    return unembed(params, x, c), unpack_paged_rows_from_scan(k_rows, v_rows, quant)


def generate(params: dict, input_ids: torch.Tensor, config: LlamaConfig, max_new_tokens: int,
             temperature: float = 0.0, key=None, max_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 1.0, prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or sampled autoregressive generation:
    ``[B, S]`` -> ``[B, S + max_new_tokens]``.  Sampling takes an explicit
    ``key`` (:class:`~accelerate_tpu_torch.utils.random.PRNGKey`) and the
    ``top_k`` / ``top_p`` filters; the arguments come in the JAX package's
    order."""
    from .generation import generate_loop

    return generate_loop(
        apply_cached, init_cache, params, input_ids, config, max_new_tokens,
        temperature=temperature, key=key, max_len=max_len, top_k=top_k, top_p=top_p,
        prefill_chunk=prefill_chunk,
    )


def speculative_generate(params: dict, draft_params: dict, input_ids: torch.Tensor,
                         config: LlamaConfig, draft_config: LlamaConfig, max_new_tokens: int,
                         num_draft_tokens: int = 4, max_len: Optional[int] = None,
                         return_stats: bool = False, temperature: float = 0.0, key=None):
    """Speculative decoding with a draft llama, up to ``num_draft_tokens +
    1`` tokens per target forward; greedy output is token-identical to
    ``generate(..., temperature=0)``, sampled output (``key``) is
    distributed as target-only sampling.  Batch 1 only (see
    ``generation.speculative_generate_loop``)."""
    from .generation import speculative_generate_loop

    return speculative_generate_loop(
        apply_cached, init_cache, params, config,
        apply_cached, init_cache, draft_params, draft_config,
        input_ids, max_new_tokens, num_draft_tokens=num_draft_tokens, max_len=max_len,
        return_stats=return_stats, temperature=temperature, key=key,
    )


def generate_beam(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  eos_token_id: Optional[int] = None,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Beam-search generation (see ``generation.beam_search``)."""
    from .generation import beam_search

    return beam_search(
        apply_cached, init_cache, params, input_ids, config, max_new_tokens,
        num_beams=num_beams, length_penalty=length_penalty, eos_token_id=eos_token_id,
        max_len=max_len,
    )
