"""Mixtral-style MoE decoder in PyTorch: the JAX package's
``accelerate_tpu/models/mixtral.py`` with the same parameter tree, numerics
and public contracts — llama's attention sub-block and a top-k routed
expert FFN (``ops/moe.py``).

Parameters are a plain dict of tensors laid out as the JAX pytree: per-layer
weights stacked on a leading ``[L, ...]`` axis, expert weights ``[L, E, d,
f]`` / ``[L, E, f, d]``, the router ``[L, d, E]``, projections stored for
``x @ W``.  The JAX ``lax.scan`` over layers is a Python loop over that
axis.  :class:`MixtralForCausalLM` wraps the dict as an ``nn.Module``.

Covered here: :class:`MixtralConfig`, :func:`init_params`, the training
forward and loss (:func:`apply_hidden`, :func:`apply` returning the router
aux losses averaged over layers, :func:`loss_fn` dense or chunked, with
the aux and z terms; attention through llama's ``attention_block``, so the
fused flash kernels at long sequences on CUDA; per-layer activation
checkpointing under ``remat``), the dense KV cache (:func:`init_cache`,
:func:`apply_cached`, int8 under ``kv_cache_quant``), greedy and sampled
:func:`generate`, :func:`speculative_generate` and :func:`generate_beam`.
As in the JAX package there is no ``apply_paged``: the serving engine takes
its dense gather path.  ``fp8`` (ROADMAP A8) and int8-weight layers
(``quantize_weights``, A8) raise.

On a mesh with an active ``fsdp``, ``tp`` or ``ep`` axis the training
forward and loss take a :class:`~..parallel.sharding.Layout` (``layout=``)
and each process holds its shard of each leaf by :data:`PARTITION_RULES`
(the JAX table): llama's sharded layers, attention and vocabulary-parallel
loss, and the experts on ``ep`` (each process runs its ``E / ep`` experts'
slots of the replicated routing and the partial combines are summed over
``ep`` and ``tp``; ``ops/moe.py``).  ``moe_impl="ragged"`` raises under
``ep`` and warns under a sharded batch, as in the JAX package.  Under
``sp`` each process runs llama's sequence-parallel layer on its chunk of
the sequence; the routing capacity is the whole row's, a chunk's slots
follow the earlier chunks' per-expert counts and the aux losses are the
whole row's (``ops/moe.py``, ``seq_group``), so the tokens dropped are
JAX's.  :func:`apply_cached` takes the same ``layout`` (or reads it from
the shards' specs): llama's sharded attention and cache, the experts as
training runs them, the whole logits on every process.

Routing capacity is a function of the sequence length of each forward
(``expert_capacity``), so a chunked prefill routes differently from a
one-shot one: parity between two paths must pin the chunking.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import warnings
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.moe import expert_capacity, moe_ffn, moe_ffn_ragged
from ..state import resolve_device
from . import llama as _llama
from .gpt2 import _dequant_layer
from .llama import labels_and_weights

__all__ = [
    "MixtralConfig",
    "MixtralForCausalLM",
    "init_params",
    "param_specs",
    "PARTITION_RULES",
    "apply",
    "apply_hidden",
    "lm_head",
    "loss_fn",
    "init_cache",
    "apply_cached",
    "generate",
    "speculative_generate",
    "generate_beam",
]

_AUX = ("load_balancing_loss", "router_z_loss", "fraction_dropped")


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    """Field for field the JAX ``MixtralConfig``; ``dtype``/``param_dtype``
    are torch dtypes.  ``moe_impl`` picks the dense Switch dispatch
    (``capacity_factor`` applies) or the exact ragged grouped matmul."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-5
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_impl: str = "dense"
    router_aux_coef: float = 0.01
    router_z_coef: float = 0.001
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    fp8: bool = False
    attention_impl: str = "auto"
    sp_impl: str = "ring"
    kv_cache_quant: bool = False
    loss_impl: str = "dense"
    loss_chunk_size: int = 4096

    def __post_init__(self):
        if self.attention_impl not in ("auto", "einsum", "flash", "pallas"):
            raise ValueError(
                "attention_impl must be 'auto', 'einsum', 'flash' or 'pallas', "
                f"got {self.attention_impl!r}"
            )
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {self.loss_impl!r}")
        if self.moe_impl not in ("dense", "ragged"):
            raise ValueError(f"moe_impl must be 'dense' or 'ragged', got {self.moe_impl!r}")
        if self.fp8:
            raise NotImplementedError(
                f"MixtralConfig.fp8={self.fp8!r} is not ported to accelerate_tpu_torch yet "
                "(ROADMAP.md A8)")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        """Test-sized config."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128, num_experts=4, top_k=2,
                        remat=False)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        defaults = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                        num_layers=32, num_heads=32, num_kv_heads=8, num_experts=8, top_k=2)
        defaults.update(kw)
        return cls(**defaults)

    def _attn_params(self) -> int:
        d, hd = self.hidden_size, self.head_dim_
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def num_params(self) -> int:
        d, f, v, l = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        moe = self.num_experts * 3 * d * f + d * self.num_experts
        return l * (self._attn_params() + moe + 2 * d) + 2 * v * d + d

    def flops_per_token(self) -> float:
        """Active-path FLOPs per token: only top_k experts run per token."""
        d, f, l = self.hidden_size, self.intermediate_size, self.num_layers
        moe_active = self.top_k * 3 * d * f + d * self.num_experts
        return 6.0 * (l * (self._attn_params() + moe_active) + 2 * self.vocab_size * d)


def _param_shapes(c: MixtralConfig) -> dict:
    d, f, hd, L, E = c.hidden_size, c.intermediate_size, c.head_dim_, c.num_layers, c.num_experts
    return {
        "embed": (c.vocab_size, d),
        "layers": {
            "wq": (L, d, c.num_heads * hd),
            "wk": (L, d, c.num_kv_heads * hd),
            "wv": (L, d, c.num_kv_heads * hd),
            "wo": (L, c.num_heads * hd, d),
            "router": (L, d, E),
            "w_gate": (L, E, d, f),
            "w_up": (L, E, d, f),
            "w_down": (L, E, f, d),
            "ln_attn": (L, d),
            "ln_mlp": (L, d),
        },
        "final_norm": (d,),
        "lm_head": (d, c.vocab_size),
    }


# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``mixtral.PARTITION_RULES``: llama's attention and head, the router
# replicated, each expert matrix's expert dim on ``ep``.
PARTITION_RULES: list = [
    (r"embed", ("tp", "fsdp")),
    (r"layers/wq", (None, "fsdp", "tp")),
    (r"layers/wk", (None, "fsdp", "tp")),
    (r"layers/wv", (None, "fsdp", "tp")),
    (r"layers/wo", (None, "tp", "fsdp")),
    (r"layers/router", (None, None, None)),
    (r"layers/w_gate", (None, "ep", "fsdp", "tp")),
    (r"layers/w_up", (None, "ep", "fsdp", "tp")),
    (r"layers/w_down", (None, "ep", "tp", "fsdp")),
    (r"layers/ln_", (None, None)),
    (r"final_norm", (None,)),
    (r"lm_head", ("fsdp", "tp")),
]


def param_specs(config: MixtralConfig) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    from ..parallel.sharding import specs_from_rules

    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


def init_params(config: MixtralConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule: norm
    scales one, every other weight a normal truncated at two standard
    deviations times ``1/sqrt(fan_in)`` (the embedding's fan-in is the
    hidden size, an expert matrix's its input width).  Drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``), one expert matrix at a time straight into
    ``config.param_dtype``, so a bf16 tree never has its fp32 twin; the
    numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config

    def init_one(name, shape):
        if name in ("ln_attn", "ln_mlp", "final_norm"):
            return torch.ones(shape, dtype=c.param_dtype, device=dev)
        fan_in = c.hidden_size if name == "embed" else shape[-2]
        out = torch.empty(shape, dtype=c.param_dtype, device=dev)
        for sub in out.reshape(-1, *shape[-2:]):
            draw = torch.empty(sub.shape, dtype=torch.float32, device=dev)
            nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sub.copy_(draw * (1.0 / math.sqrt(fan_in)))
        return out

    shapes = _param_shapes(config)
    params = {k: init_one(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: init_one(k, s) for k, s in shapes["layers"].items()}
    return params


class MixtralForCausalLM(_llama.LlamaForCausalLM):
    """The MoE decoder as an ``nn.Module``: ``LlamaForCausalLM`` over this
    module's functions.  The parameter dict as ``nn.Parameter``s on
    ``device`` (default ``cuda``), random from ``seed`` unless ``params`` is
    given; ``forward(input_ids, cache)`` is :func:`apply_cached`,
    ``forward(input_ids=..., attention_mask=..., labels=...)`` returns
    ``{"loss": loss_fn(...)}``; ``state_dict()`` uses the JAX package's flat
    names.  ``Accelerator.prepare`` shards it by :attr:`partition_rules`
    on a mesh with model axes, as the llama family's."""

    partition_rules = PARTITION_RULES

    @staticmethod
    def _family():
        return sys.modules[__name__]


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def _mesh_of(layout):
    if layout is not None:
        return layout.mesh
    from ..parallel.sharding import _live_mesh

    return _live_mesh()


def _check_moe_impl(c: MixtralConfig, layout=None) -> None:
    """The JAX ``_check_moe_impl`` on ``layout``'s mesh (the live state's by
    default): ``moe_impl="ragged"`` raises under an active ``ep`` axis (its
    group sizes depend on each shard's data) and warns under sharded batch
    axes (it routes every token of its process's batch; use the dense
    dispatch there)."""
    if c.moe_impl != "ragged":
        return
    from ..parallel.mesh import data_axes

    mesh = _mesh_of(layout)
    if mesh is not None and mesh.shape["ep"] > 1:
        raise ValueError(
            "moe_impl='ragged' cannot run under an ep>1 mesh: ragged "
            "group sizes are data-dependent per shard.  Use "
            "moe_impl='dense' for expert-parallel meshes."
        )
    batch_axes = data_axes(mesh) if mesh is not None else ()
    if batch_axes:
        warnings.warn(
            f"moe_impl='ragged' under a mesh with sharded batch axes "
            f"{batch_axes}: the ragged grouped-matmul sorts and bins the "
            "GLOBAL token set, so XLA all-gathers the full batch onto every "
            "device before routing — the per-device work does not shrink "
            "with the mesh.  Use moe_impl='dense' for dp/fsdp meshes (its "
            "dispatch einsum partitions over the batch axes)."
        )


def _expert_group(layout):
    """``(group, axes, first expert)``: the group over the active ``ep`` and
    ``tp`` axes whose processes each hold part of the experts' output
    (their experts, their columns of the FFN width), and this process's
    first expert; ``(None, None, 0)`` off such a mesh."""
    if layout is None:
        return None, None, 0
    axes = tuple(a for a in ("ep", "tp") if layout.mesh.shape[a] > 1)
    if not axes:
        return None, None, 0
    return layout.mesh.group(axes), axes, layout.ep_rank


def _moe(h, p, c: MixtralConfig, capacity: int, experts=(None, None, 0), seq_group=None):
    """The expert FFN by ``moe_impl``: the dense dispatch or the ragged
    grouped matmul; ``experts`` is :func:`_expert_group`'s, ``seq_group``
    the ``sp`` group where ``h`` is this process's chunk of the
    sequence."""
    group, axes, ep_rank = experts
    if c.moe_impl == "ragged":
        return moe_ffn_ragged(h, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                              top_k=c.top_k, compute_dtype=c.dtype, group=group, axis=axes,
                              seq_group=seq_group)
    return moe_ffn(h, p["router"], p["w_gate"], p["w_up"], p["w_down"], top_k=c.top_k,
                   capacity=capacity, compute_dtype=c.dtype, group=group, axis=axes,
                   first_expert=ep_rank * p["w_gate"].shape[0], seq_group=seq_group)


def _layer(x, p, c: MixtralConfig, positions, kv_valid, capacity: int, group=None,
           q_heads=None, experts=(None, None, 0), sp_layout=None):
    sp_mesh = _llama._sp_active(sp_layout)
    x = _llama.attention_block(x, p, c, positions, kv_valid, group, q_heads, sp_mesh)
    seq_group = None if sp_mesh is None else sp_layout.sp_group()
    y, aux = _moe(_llama._rms_norm(x, p["ln_mlp"], c.rms_eps), p, c, capacity, experts,
                  seq_group)
    return x + y, aux


def lm_head(params: dict, config: MixtralConfig) -> torch.Tensor:
    """The ``[d, V]`` head in the compute dtype."""
    return params["lm_head"].to(config.dtype)


def apply_hidden(params: dict, input_ids: torch.Tensor, config: MixtralConfig,
                 positions: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 layer_dtype: Optional[torch.dtype] = None, layout=None):
    """Trunk forward: token ids ``[B, S]`` -> (final-normed hidden ``[B, S,
    d]`` in the compute dtype, aux losses averaged over layers).  Positions
    are ``0 .. S-1`` whatever the mask says (as in the JAX package);
    ``attention_mask`` removes padded keys.  Under ``config.remat`` each
    layer runs under ``torch.utils.checkpoint`` (recomputed in the
    backward); ``layer_dtype`` casts each layer's weights to it inside the
    layer.  ``layout``: the sharded path (module docstring); under ``sp`` the
    hidden is gathered over ``sp``, the aux losses are the whole
    sequence's."""
    hidden, aux = _trunk(params, input_ids, config, positions, attention_mask, layer_dtype,
                         layout)
    return _llama.sp_gather(hidden, layout), _sp_aux(aux, layout)


def _sp_aux(aux: dict, layout) -> dict:
    """The whole sequence's aux losses from this process's parts under
    ``sp`` (the fraction dropped is the whole's already)."""
    return {k: v if k == "fraction_dropped" else _llama.sp_sum(v, layout)
            for k, v in aux.items()}


def _trunk(params: dict, input_ids: torch.Tensor, config: MixtralConfig,
           positions: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           layer_dtype: Optional[torch.dtype] = None, layout=None):
    """:func:`apply_hidden` before the gather: under ``sp`` the hidden of
    this process's chunk and its part of the load-balance and z losses (the
    fraction dropped is the whole's)."""
    c = config
    _check_moe_impl(c, layout)
    b, s = input_ids.shape
    if positions is None:
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
    kv_valid = attention_mask.bool() if attention_mask is not None else None
    input_ids, positions, kv_valid = _llama.sp_inputs(layout, s, input_ids, positions,
                                                      kv_valid)
    x = _llama.embed_tokens(params, input_ids, c, layout, layer_dtype)
    # The whole row's capacity, also where this process holds a chunk.
    capacity = expert_capacity(s, c.num_experts, c.top_k, c.capacity_factor)
    _dequant_layer(params["layers"])
    names, per_layer, prep, group, q_heads = _llama.sharded_layers(params, c, layout,
                                                                   layer_dtype)
    experts = _expert_group(layout)

    def layer(x, *weights):
        p = {k: prep(k, w) for k, w in zip(names, weights)}
        return _layer(x, p, c, positions, kv_valid, capacity, group, q_heads, experts, layout)

    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in _AUX}
    for weights in per_layer:
        if c.remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x, a = layer(x, *weights)
        aux = {k: aux[k] + a[k] for k in _AUX}
    aux = {k: v / c.num_layers for k, v in aux.items()}
    scale = params["final_norm"]
    if _llama._model_sharded(layout):
        scale = layout.full(scale, layout.spec("final_norm"), layer_dtype)
    return _llama._rms_norm(x, scale, c.rms_eps), aux


def apply(params: dict, input_ids: torch.Tensor, config: MixtralConfig,
          positions: Optional[torch.Tensor] = None,
          attention_mask: Optional[torch.Tensor] = None,
          layer_dtype: Optional[torch.dtype] = None, layout=None):
    """Training forward: token ids ``[B, S]`` -> (logits ``[B, S, V]`` fp32,
    mean aux losses); ``layout`` as in :func:`apply_hidden` (its head
    whole: off ``tp``; under ``sp`` each process's chunk of the logits,
    gathered)."""
    hidden, aux = _trunk(params, input_ids, config, positions, attention_mask, layer_dtype,
                         layout)
    return _llama.sp_gather((hidden @ lm_head(params, config)).float(), layout), _sp_aux(
        aux, layout)


def loss_fn(params: dict, batch: dict, config: MixtralConfig,
            layer_dtype: Optional[torch.dtype] = None, layout=None) -> torch.Tensor:
    """Next-token cross-entropy plus the router aux losses (``router_aux_coef``
    times the load-balance loss, ``router_z_coef`` times the z-loss).
    ``config.loss_impl == "chunked"`` streams the head over vocabulary tiles
    (``ops/chunked_ce.py``), so the ``[B, S, V]`` logits never exist; under
    ``tp`` the loss is llama's over the vocabulary shards."""
    labels, weights = labels_and_weights(batch)
    hidden, aux = _trunk(params, batch["input_ids"], config,
                         attention_mask=batch.get("attention_mask"), layer_dtype=layer_dtype,
                         layout=layout)
    ce = _llama.token_loss(hidden, params, labels, weights, config, layout, layer_dtype)
    return ce + _llama.sp_sum(config.router_aux_coef * aux["load_balancing_loss"]
                              + config.router_z_coef * aux["router_z_loss"], layout)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------


def init_cache(config: MixtralConfig, batch_size: int, max_len: int, device=None,
               layout=None) -> dict:
    """Zeroed KV cache (llama's layout: the attention is shared code);
    ``config.kv_cache_quant`` stores int8 codes with bf16 scales; on a
    model-sharded ``layout`` this process's kv heads (llama's
    ``kv_head_ids``)."""
    return _llama.init_cache(config, batch_size, max_len, device, layout)


@torch.no_grad()
def apply_cached(params: dict, input_ids: torch.Tensor, config: MixtralConfig, cache: dict,
                 layout=None):
    """Forward over new tokens at positions ``cache['index'] .. index+S``
    with cache read/write; returns (logits ``[B, S, V]`` fp32, cache).  The
    router aux losses are not accumulated.  The expert capacity is that of
    an ``S``-token forward.  The cache tensors are written in place (JAX
    returns updated copies); the returned dict shares them and carries the
    advanced index.

    ``layout`` (or the specs kept on sharded leaves: llama's
    ``serving_layout``): llama's sharded attention on this process's heads
    and cache, and the expert FFN as training runs it on ``ep`` and ``tp``
    (this process's experts' slots of the replicated routing, the partial
    combines summed over the group); every process returns the whole
    logits."""
    from .generation import check_cache_room

    c = config
    layout = _llama.serving_layout(params, layout)
    _check_moe_impl(c, layout)
    b, s = input_ids.shape
    index = int(cache["index"])
    check_cache_room(index, s, cache["k"].shape[2])
    _llama._check_cache_heads(cache["k"], len(_llama.kv_head_ids(c, layout)))
    positions, mask = _llama._cache_positions_and_mask(index, b, s, cache, input_ids.device)
    x = _llama.embed_tokens(params, input_ids, c, layout)
    capacity = expert_capacity(s, c.num_experts, c.top_k, c.capacity_factor)
    _dequant_layer(params["layers"])
    names, per_layer, prep, group, q_heads = _llama.serving_layers(params, c, layout)
    experts = _expert_group(layout)
    for i, weights in enumerate(per_layer):
        p = {k: prep(k, w) for k, w in zip(names, weights)}
        y = _llama._attention_block_cached(x, p, c, _llama._cache_layer(cache, "k", i),
                                           _llama._cache_layer(cache, "v", i), index,
                                           positions, mask, group, q_heads)
        ffn, _ = _moe(_llama._rms_norm(y, p["ln_mlp"], c.rms_eps), p, c, capacity, experts)
        x = y + ffn
    return _llama.unembed(params, x, c, layout), dict(cache, index=index + s)


def generate(params: dict, input_ids: torch.Tensor, config: MixtralConfig, max_new_tokens: int,
             temperature: float = 0.0, key=None, max_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 1.0, prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or sampled autoregressive generation:
    ``[B, S]`` -> ``[B, S + max_new_tokens]`` (see
    ``generation.generate_loop``).  ``prefill_chunk`` changes the routing
    capacity of the prompt's forwards, and so may change the output.  On
    shards every forward is the sharded one."""
    from .generation import generate_loop

    return generate_loop(
        apply_cached, _llama.serving_init_cache(init_cache, params), params, input_ids,
        config, max_new_tokens,
        temperature=temperature, key=key, max_len=max_len, top_k=top_k, top_p=top_p,
        prefill_chunk=prefill_chunk,
    )


def speculative_generate(params: dict, draft_params: dict, input_ids: torch.Tensor,
                         config: MixtralConfig, draft_config: MixtralConfig,
                         max_new_tokens: int, num_draft_tokens: int = 4,
                         max_len: Optional[int] = None, return_stats: bool = False,
                         temperature: float = 0.0, key=None):
    """Speculative decoding with a (smaller) Mixtral draft (see
    ``generation.speculative_generate_loop``).  The verify window's forward
    routes ``num_draft_tokens + 1`` tokens at that window's capacity.  Batch
    1 only."""
    from .generation import speculative_generate_loop

    return speculative_generate_loop(
        apply_cached, _llama.serving_init_cache(init_cache, params), params, config,
        apply_cached, _llama.serving_init_cache(init_cache, draft_params), draft_params,
        draft_config,
        input_ids, max_new_tokens, num_draft_tokens=num_draft_tokens, max_len=max_len,
        return_stats=return_stats, temperature=temperature, key=key,
    )


def generate_beam(params: dict, input_ids: torch.Tensor, config: MixtralConfig,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  eos_token_id: Optional[int] = None,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Beam-search generation (see ``generation.beam_search``)."""
    from .generation import beam_search

    return beam_search(
        apply_cached, _llama.serving_init_cache(init_cache, params), params, input_ids,
        config, max_new_tokens,
        num_beams=num_beams, length_penalty=length_penalty, eos_token_id=eos_token_id,
        max_len=max_len,
    )
