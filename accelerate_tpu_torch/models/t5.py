"""T5-style encoder-decoder in PyTorch: the JAX package's
``accelerate_tpu/models/t5.py`` with the same parameter tree, numerics and
public contracts.

Relative-position bias (no absolute or rotary positions, one table per
stack, read from its first block), RMSNorm without bias, a ReLU MLP,
cross-attention, no 1/sqrt(d) in the attention scores, and a head tied to
the shared embedding and scaled by 1/sqrt(d).  Parameters are a plain dict
of tensors laid out as the JAX pytree: each stack's weights stacked on a
leading ``[L, ...]`` axis, projections stored for ``x @ W``.

The head is the compute-dtype embedding divided by sqrt(d) in fp32: the JAX
package divides by a numpy scalar, which promotes to fp32, so its logits
come from an fp32 product even under bf16 compute.  This module does the
same.  Where the JAX module computes in fp32 (the head, the attention
scores, the relative bias), this one computes in fp32 or the compute
dtype if that is wider, so an fp64 model is fp64 throughout.

Covered here: :class:`T5Config`, :func:`init_params`, the training forward
and loss (:func:`apply_hidden`, :func:`apply`, :func:`loss_fn`, dense or
chunked), :func:`encode`, the decoder cache (:func:`init_decoder_cache`:
self-attention K/V, int8 under ``kv_cache_quant``, and the cross-attention
K/V computed once in full precision; :func:`decode_cached`), and T5's own
:func:`generate`, :func:`generate_beam` and :func:`speculative_generate`.
Attention is the einsum path, as in the JAX package: no kernel of this
module is hand-written.  Int8-weight layers (``quantize_weights``) raise
(ROADMAP A8).

On a mesh with an active ``fsdp`` or ``tp`` axis the training forward and
loss take a :class:`~..parallel.sharding.Layout` (``layout=``) and each
process holds its shard of each leaf by :data:`PARTITION_RULES` (the JAX
table): each stack's layers gather their ``fsdp`` dims where they run;
under ``tp`` the self- and cross-attention's q/k/v are column-parallel over
heads (their inputs, the encoder output among them, through ``tp_copy``),
``wo`` / ``cross_wo`` and the MLP's down projection row-parallel; the
replicated relative-bias tables enter through ``tp_copy``, of which each
process reads its heads' columns; the shared embedding and the tied head
are vocabulary-parallel, and so is the loss (llama's).  Where ``tp`` does
not divide the heads every process computes every head from the whole
weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import tp_copy, tp_reduce
from ..parallel.sharding import TpView, leaf, specs_from_rules, vocab_lookup
from ..state import resolve_device
from .gpt2 import _dequant_layer
from .llama import _loss_vocab_parallel, _rms_norm, _wide, cross_entropy
from .bert import _run_layers

__all__ = [
    "T5Config",
    "init_params",
    "param_specs",
    "PARTITION_RULES",
    "apply",
    "apply_hidden",
    "lm_head",
    "loss_fn",
    "encode",
    "init_decoder_cache",
    "decode_cached",
    "generate",
    "generate_beam",
    "speculative_generate",
]


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Field for field the JAX ``T5Config``; ``dtype``/``param_dtype`` are
    torch dtypes.  ``num_layers`` is the depth of each stack."""

    vocab_size: int = 32128
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    head_dim: int = 64
    num_buckets: int = 32
    max_distance: int = 128
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False
    kv_cache_quant: bool = False
    loss_impl: str = "dense"
    loss_chunk_size: int = 4096

    def __post_init__(self):
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {self.loss_impl!r}")

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, head_dim=16, num_buckets=8, max_distance=32)
        defaults.update(kw)
        return cls(**defaults)


# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``t5.PARTITION_RULES``.
PARTITION_RULES: list = [
    (r"shared_embed", ("tp", "fsdp")),
    (r"/(wq|wk|wv|cross_wq|cross_wk|cross_wv)", (None, "fsdp", "tp")),
    (r"/(wo|cross_wo)", (None, "tp", "fsdp")),
    (r"/w_up", (None, "fsdp", "tp")),
    (r"/w_down", (None, "tp", "fsdp")),
    (r"rel_bias", (None, None)),
    (r"final_ln", (None,)),
    (r"/ln_", (None, None)),
]

_ATTN_COLS = ("wq", "wk", "wv", "cross_wq", "cross_wk", "cross_wv")
_ATTN_ROWS = ("wo", "cross_wo")


def _stack_shapes(c: T5Config, decoder: bool) -> dict:
    d, f, L, hd, h = c.hidden_size, c.intermediate_size, c.num_layers, c.head_dim, c.num_heads
    shapes = {
        "wq": (L, d, h * hd),
        "wk": (L, d, h * hd),
        "wv": (L, d, h * hd),
        "wo": (L, h * hd, d),
        "w_up": (L, d, f),
        "w_down": (L, f, d),
        "ln_attn": (L, d),
        "ln_mlp": (L, d),
    }
    if decoder:
        shapes.update({
            "cross_wq": (L, d, h * hd),
            "cross_wk": (L, d, h * hd),
            "cross_wv": (L, d, h * hd),
            "cross_wo": (L, h * hd, d),
            "ln_cross": (L, d),
        })
    return shapes


def _param_shapes(c: T5Config) -> dict:
    return {
        "shared_embed": (c.vocab_size, c.hidden_size),
        "enc_rel_bias": (c.num_buckets, c.num_heads),
        "dec_rel_bias": (c.num_buckets, c.num_heads),
        "encoder": _stack_shapes(c, decoder=False),
        "decoder": _stack_shapes(c, decoder=True),
        "enc_final_ln": (c.hidden_size,),
        "dec_final_ln": (c.hidden_size,),
    }


def param_specs(config: T5Config) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


def init_params(config: T5Config, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule: RMSNorm
    scales one, relative-bias tables zero, every other weight normal over
    sqrt(fan_in) (``shape[-2]``; the shared embedding's is the vocabulary),
    on ``device`` (default ``cuda``), one layer at a time; the numbers
    differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config

    def one(name, shape):
        if name.startswith("ln_") or name.endswith("_final_ln"):
            return torch.ones(shape, dtype=c.param_dtype, device=dev)
        if name.endswith("_rel_bias"):
            return torch.zeros(shape, dtype=c.param_dtype, device=dev)
        out = torch.empty(shape, dtype=c.param_dtype, device=dev)
        for sub in out.reshape(-1, *shape[-2:]):
            draw = torch.empty(sub.shape, dtype=torch.float32, device=dev)
            sub.copy_(draw.normal_(0.0, 1.0, generator=gen) / math.sqrt(shape[-2]))
        return out

    return {k: ({n: one(n, s) for n, s in v.items()} if isinstance(v, dict) else one(k, v))
            for k, v in _param_shapes(c).items()}


def _relative_buckets(rel_pos: torch.Tensor, num_buckets: int, max_distance: int,
                      bidirectional: bool) -> torch.Tensor:
    """T5 relative-position bucketing (log-spaced beyond the exact range)."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(rel_pos.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def _rel_bias_at(table: torch.Tensor, q_positions: torch.Tensor, k_len: int, c: T5Config,
                 bidirectional: bool = False) -> torch.Tensor:
    """The ``[H, T, k_len]`` fp32 bias of queries at ``q_positions`` ``[T]``
    against keys ``0 .. k_len-1``."""
    mem = torch.arange(k_len, device=table.device)[None, :]
    buckets = _relative_buckets(mem - q_positions[:, None], c.num_buckets, c.max_distance,
                                bidirectional)
    return _wide(table)[buckets].permute(2, 0, 1)


def _rel_bias(table, q_len: int, k_len: int, c: T5Config, bidirectional: bool):
    return _rel_bias_at(table, torch.arange(q_len, device=table.device), k_len, c, bidirectional)


def _heads(h, w, c: T5Config):
    b, s, _ = h.shape
    return (h @ w.to(c.dtype)).reshape(b, s, -1, c.head_dim)


def _attend(q, k, v, bias, mask):
    """T5 attention: scores in fp32 without 1/sqrt(d), plus ``bias`` ``[H,
    S, T]``, ``mask`` (against ``[B, H, S, T]``) entries at -1e30."""
    b, s, h, hd = q.shape
    scores = _wide(torch.einsum("bshd,bthd->bhst", q, k))
    if bias is not None:
        scores = scores + bias[None]
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * hd)


def _mha(h_q, h_kv, p, prefix: str, c: T5Config, bias, mask, tp=None):
    """Multi-head attention of ``h_q`` over ``h_kv``; under ``tp`` (a
    :class:`~..parallel.sharding.TpView`) over this process's heads, the
    output projection's partial sums added over ``tp``."""
    group = (tp or _NO_TP).attn
    hq = tp_copy(h_q, group)
    hkv = hq if h_kv is h_q else tp_copy(h_kv, group)
    q = _heads(hq, p[prefix + "wq"], c)
    k = _heads(hkv, p[prefix + "wk"], c)
    v = _heads(hkv, p[prefix + "wv"], c)
    out = _attend(q, k, v, bias, None if mask is None else mask[:, None]) @ \
        p[prefix + "wo"].to(c.dtype)
    return tp_reduce(out, group)


def _mlp(x, p, c: T5Config, tp=None):
    group = (tp or _NO_TP).group
    h = tp_copy(_rms_norm(x, p["ln_mlp"], c.rms_eps), group)
    return x + tp_reduce(F.relu(h @ p["w_up"].to(c.dtype)) @ p["w_down"].to(c.dtype), group)


def _enc_layer(x, p, c: T5Config, bias, mask, tp=None):
    h = _rms_norm(x, p["ln_attn"], c.rms_eps)
    return _mlp(x + _mha(h, h, p, "", c, bias, mask, tp), p, c, tp)


def _dec_layer(x, p, c: T5Config, bias, self_mask, enc_out, cross_mask, tp=None):
    h = _rms_norm(x, p["ln_attn"], c.rms_eps)
    x = x + _mha(h, h, p, "", c, bias, self_mask, tp)
    h = _rms_norm(x, p["ln_cross"], c.rms_eps)
    return _mlp(x + _mha(h, enc_out, p, "cross_", c, None, cross_mask, tp), p, c, tp)


def _embed(params: dict, ids: torch.Tensor, c: T5Config, layout=None) -> torch.Tensor:
    """The shared embedding in the compute dtype; on a ``layout`` its
    ``fsdp`` dim gathered and the lookup over this process's vocabulary
    rows (:func:`~..parallel.sharding.embed_lookup`)."""
    if layout is None:
        return F.embedding(ids.long(), params["shared_embed"]).to(c.dtype)
    return vocab_lookup(leaf(params, "shared_embed", layout, c.dtype), ids, c.dtype, layout)


def lm_head(params: dict, config: T5Config, layout=None) -> torch.Tensor:
    """The tied ``[d, V]`` head: the shared embedding in the compute dtype,
    divided by sqrt(d) in fp32 (the JAX package's promotion); on a
    ``layout`` its ``fsdp`` dim gathered, its ``tp`` columns local."""
    table = leaf(params, "shared_embed", layout, config.dtype)
    return _wide(table.T.to(config.dtype)) / math.sqrt(config.hidden_size)


def _rel_table(params: dict, name: str, layout, tp):
    """A relative-bias table ``[buckets, H]`` as the attention reads it:
    under ``tp`` this process's heads' columns (through ``tp_copy``)."""
    table = leaf(params, name, layout)
    return table if tp.heads is None else tp.chunk(table, -1)


def _stack(name: str, c: T5Config, layout, tp) -> dict:
    """``_run_layers``'s gather arguments for the stack ``name``: the
    attention leaves gathered over ``tp`` where it does not divide the
    heads."""
    return dict(layout=layout, path=name, dtype=c.dtype,
                tp_grad=tp.head_gathers(split=_ATTN_COLS, rows=_ATTN_ROWS))


_NO_TP = TpView()


def encode(params: dict, input_ids: torch.Tensor, config: T5Config,
           attention_mask: Optional[torch.Tensor] = None, layout=None) -> torch.Tensor:
    """Encoder stack only -> final-normed ``[B, S, d]`` in the compute
    dtype; ``attention_mask`` masks padded keys and queries.  ``layout``:
    the sharded path (module docstring)."""
    c = config
    s = input_ids.shape[1]
    mask = None
    if attention_mask is not None:
        valid = attention_mask.bool()
        mask = valid[:, None, :] & valid[:, :, None]
    tp = TpView(layout, c.num_heads)
    bias = _rel_bias(_rel_table(params, "enc_rel_bias", layout, tp), s, s, c, bidirectional=True)
    x = _run_layers(_embed(params, input_ids, c, layout), _dequant_layer(params["encoder"]),
                    c.remat, lambda x, p: _enc_layer(x, p, c, bias, mask, tp),
                    **_stack("encoder", c, layout, tp))
    return _rms_norm(x, leaf(params, "enc_final_ln", layout), c.rms_eps)


def apply_hidden(params: dict, input_ids: torch.Tensor, decoder_input_ids: torch.Tensor,
                 config: T5Config, attention_mask: Optional[torch.Tensor] = None, layout=None):
    """Encoder + decoder -> final-normed decoder hidden ``[B, T, d]``."""
    c = config
    b, s = input_ids.shape
    t = decoder_input_ids.shape[1]
    enc_out = encode(params, input_ids, c, attention_mask, layout)
    dev = input_ids.device
    tp = TpView(layout, c.num_heads)
    bias = _rel_bias(_rel_table(params, "dec_rel_bias", layout, tp), t, t, c,
                     bidirectional=False)
    self_mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril().expand(b, t, t)
    cross_mask = None
    if attention_mask is not None:
        cross_mask = attention_mask.bool()[:, None, :].expand(b, t, s)
    y = _run_layers(_embed(params, decoder_input_ids, c, layout),
                    _dequant_layer(params["decoder"]), c.remat,
                    lambda y, p: _dec_layer(y, p, c, bias, self_mask, enc_out, cross_mask, tp),
                    **_stack("decoder", c, layout, tp))
    return _rms_norm(y, leaf(params, "dec_final_ln", layout), c.rms_eps)


def apply(params: dict, input_ids: torch.Tensor, decoder_input_ids: torch.Tensor,
          config: T5Config, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(encoder ids ``[B, S]``, decoder ids ``[B, T]``) -> fp32 logits ``[B,
    T, V]``."""
    hidden = apply_hidden(params, input_ids, decoder_input_ids, config, attention_mask)
    head = lm_head(params, config)
    return hidden.to(head.dtype) @ head


def loss_fn(params: dict, batch: dict, config: T5Config, layout=None) -> torch.Tensor:
    """Seq2seq cross-entropy over ``input_ids``, ``decoder_input_ids`` and
    ``labels`` (negative = ignored), with an optional ``attention_mask``;
    ``config.loss_impl == "chunked"`` streams the head over vocabulary
    tiles; on a ``layout`` under ``tp``, llama's loss over the vocabulary
    shards."""
    labels = batch["labels"]
    weights = (labels >= 0).float()
    labels = labels.clamp(min=0)
    if layout is not None or config.loss_impl == "chunked":
        hidden = apply_hidden(params, batch["input_ids"], batch["decoder_input_ids"], config,
                              attention_mask=batch.get("attention_mask"), layout=layout)
        head = lm_head(params, config, layout)
        if layout is not None and layout.tp > 1:
            return _loss_vocab_parallel(hidden.to(head.dtype), head, labels, weights, config,
                                        layout)
        if config.loss_impl == "chunked":
            from ..ops.chunked_ce import chunked_cross_entropy

            return chunked_cross_entropy(hidden.to(head.dtype), head, labels, weights,
                                         config.loss_chunk_size)
        return cross_entropy(hidden.to(head.dtype) @ head, labels, weights)
    logits = apply(params, batch["input_ids"], batch["decoder_input_ids"], config,
                   attention_mask=batch.get("attention_mask"))
    return cross_entropy(logits, labels, weights)


# ---------------------------------------------------------------------------
# Encoder-decoder KV-cache inference
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_decoder_cache(params: dict, enc_out: torch.Tensor, config: T5Config,
                       max_len: int) -> dict:
    """The decoder's self-attention KV cache (int8 under ``kv_cache_quant``)
    plus each layer's cross-attention K/V of ``enc_out``, computed once, in
    the compute dtype: ``cross_k`` / ``cross_v`` ``[L, B, S, H, hd]``."""
    from .generation import make_kv_cache

    c = config
    b = enc_out.shape[0]
    layers = _dequant_layer(params["decoder"])
    cache = make_kv_cache(c.num_layers, b, max_len, c.num_heads, c.head_dim, c.dtype,
                          device=enc_out.device, quantized=c.kv_cache_quant)
    cache["cross_k"] = torch.stack([_heads(enc_out, w, c) for w in layers["cross_wk"]])
    cache["cross_v"] = torch.stack([_heads(enc_out, w, c) for w in layers["cross_wv"]])
    return cache


@torch.no_grad()
def decode_cached(params: dict, decoder_input_ids: torch.Tensor, config: T5Config, cache: dict,
                  attention_mask: Optional[torch.Tensor] = None, num_beams: int = 1):
    """Decoder forward over new tokens at positions ``index .. index+T``
    with self-attention cache read/write (in place) and the precomputed
    cross K/V; returns (logits ``[B, T, V]`` fp32, cache with the advanced
    index).  ``num_beams > 1``: the decoder batch is ``B * num_beams`` while
    the cross K/V and ``attention_mask`` stay at batch ``B`` (the beams fold
    into the cross attention as a grouped einsum)."""
    from .generation import cache_write, check_cache_room
    from .llama import _cache_layer

    c = config
    b, t = decoder_input_ids.shape
    hd, nh = c.head_dim, c.num_heads
    index = int(cache["index"])
    max_len = cache["k"].shape[2]
    check_cache_room(index, t, max_len)
    s = cache["cross_k"].shape[2]
    if b % num_beams:
        raise ValueError(f"decoder batch {b} not divisible by num_beams {num_beams}")
    b0 = b // num_beams
    dev = decoder_input_ids.device
    positions = index + torch.arange(t, device=dev)
    bias = _rel_bias_at(params["dec_rel_bias"], positions, max_len, c)
    self_mask = (positions[:, None] >= torch.arange(max_len, device=dev)[None, :])[None, None]
    cross_mask = None
    if attention_mask is not None:
        cross_mask = attention_mask.bool()[:, None, None, None, :].expand(b0, 1, 1, t, s)
    layers = _dequant_layer(params["decoder"])
    x = _embed(params, decoder_input_ids, c)
    for i in range(c.num_layers):
        p = {k: v[i] for k, v in layers.items()}
        h = _rms_norm(x, p["ln_attn"], c.rms_eps)
        k_full = cache_write(_cache_layer(cache, "k", i), _heads(h, p["wk"], c), index, c.dtype)
        v_full = cache_write(_cache_layer(cache, "v", i), _heads(h, p["wv"], c), index, c.dtype)
        x = x + _attend(_heads(h, p["wq"], c), k_full, v_full, bias, self_mask) @ \
            p["wo"].to(c.dtype)
        h = _rms_norm(x, p["ln_cross"], c.rms_eps)
        q = _heads(h, p["cross_wq"], c).reshape(b0, num_beams, t, nh, hd)
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        scores = _wide(torch.einsum("bkthd,bshd->bkhts", q, xk))
        if cross_mask is not None:
            scores = torch.where(cross_mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(xv.dtype)
        attn = torch.einsum("bkhts,bshd->bkthd", probs, xv).reshape(b, t, nh * hd)
        x = _mlp(x + attn @ p["cross_wo"].to(c.dtype), p, c)
    x = _rms_norm(x, params["dec_final_ln"], c.rms_eps)
    head = lm_head(params, c)
    return x.to(head.dtype) @ head, dict(cache, index=index + t)


def _start(input_ids: torch.Tensor, decoder_start_token_id: int) -> torch.Tensor:
    return torch.full((input_ids.shape[0], 1), decoder_start_token_id, dtype=torch.int32,
                      device=input_ids.device)


@torch.no_grad()
def generate(params: dict, input_ids: torch.Tensor, config: T5Config, max_new_tokens: int,
             decoder_start_token_id: int = 0, temperature: float = 0.0, key=None,
             attention_mask: Optional[torch.Tensor] = None, top_k: int = 0,
             top_p: float = 1.0) -> torch.Tensor:
    """Seq2seq generation: encode once, then decode with the self-attention
    cache and the precomputed cross K/V, greedy or sampled (see
    ``generation.generate_loop``).  Returns decoder ids ``[B, 1 +
    max_new_tokens]`` (leading start token)."""
    from .generation import generate_loop

    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1 for seq2seq generation")
    c = config
    enc_out = encode(params, input_ids, c, attention_mask)

    def _init_cache(cfg, batch_size, max_len, device=None):
        return init_decoder_cache(params, enc_out, cfg, max_len)

    def _apply_cached(p, ids, cfg, cache):
        return decode_cached(p, ids, cfg, cache, attention_mask)

    return generate_loop(_apply_cached, _init_cache, params,
                         _start(input_ids, decoder_start_token_id), c, max_new_tokens,
                         temperature=temperature, key=key, top_k=top_k, top_p=top_p)


@torch.no_grad()
def generate_beam(params: dict, input_ids: torch.Tensor, config: T5Config, max_new_tokens: int,
                  num_beams: int = 4, length_penalty: float = 1.0,
                  eos_token_id: Optional[int] = None, decoder_start_token_id: int = 0,
                  attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Seq2seq beam search (``generation.beam_search``): encode once; only the
    self-attention cache is tiled per beam, the cross K/V and the source
    mask stay at batch ``B`` and the beams fold into the cross attention.
    Returns decoder ids ``[B, 1 + max_new_tokens]``."""
    from .generation import beam_search

    c = config
    b = input_ids.shape[0]
    enc_out = encode(params, input_ids, c, attention_mask)
    cross: dict = {}

    def _init_cache(cfg, batch_size, max_len, device=None):
        cache = init_decoder_cache(params, enc_out, cfg, max_len)
        # Out of the cache beam_search tiles and reorders: every beam of a
        # row reads the same encoder output.
        cross["cross_k"] = cache.pop("cross_k")
        cross["cross_v"] = cache.pop("cross_v")
        return cache

    def _apply_cached(p, ids, cfg, cache):
        # The prefill runs at batch B (the shared start token), decode at B*K.
        beams = 1 if ids.shape[0] == b else num_beams
        logits, new_cache = decode_cached(p, ids, cfg, dict(cache, **cross), attention_mask,
                                          num_beams=beams)
        return logits, {k: v for k, v in new_cache.items() if k not in cross}

    return beam_search(_apply_cached, _init_cache, params, _start(input_ids,
                                                                  decoder_start_token_id),
                       c, max_new_tokens, num_beams=num_beams, length_penalty=length_penalty,
                       eos_token_id=eos_token_id)


@torch.no_grad()
def speculative_generate(params: dict, draft_params: dict, input_ids: torch.Tensor,
                         config: T5Config, draft_config: T5Config, max_new_tokens: int,
                         num_draft_tokens: int = 4, decoder_start_token_id: int = 0,
                         attention_mask: Optional[torch.Tensor] = None,
                         return_stats: bool = False, temperature: float = 0.0, key=None):
    """Speculative seq2seq decoding: both models encode the source once, the
    draft decoder proposes and the target decoder verifies (see
    ``generation.speculative_generate_loop``).  Greedy output is
    token-identical to ``generate(..., temperature=0)``.  Batch 1 only."""
    from .generation import speculative_generate_loop

    enc_out = encode(params, input_ids, config, attention_mask)
    d_enc_out = encode(draft_params, input_ids, draft_config, attention_mask)

    def _init_cache(cfg, batch_size, max_len, device=None):
        return init_decoder_cache(params, enc_out, cfg, max_len)

    def _d_init_cache(cfg, batch_size, max_len, device=None):
        return init_decoder_cache(draft_params, d_enc_out, cfg, max_len)

    def _apply_cached(p, ids, cfg, cache):
        return decode_cached(p, ids, cfg, cache, attention_mask)

    return speculative_generate_loop(
        _apply_cached, _init_cache, params, config,
        _apply_cached, _d_init_cache, draft_params, draft_config,
        _start(input_ids, decoder_start_token_id), max_new_tokens,
        num_draft_tokens=num_draft_tokens, return_stats=return_stats,
        temperature=temperature, key=key)
