"""GPT-2-style decoder in PyTorch: the JAX package's
``accelerate_tpu/models/gpt2.py`` with the same parameter tree, numerics and
public contracts.

GPT-2 differs from llama everywhere it matters: learned absolute positions
(no RoPE), LayerNorm with bias, multi-head attention (one kv head per query
head), a tanh-approximate GELU MLP, and a head tied to the token embedding.
Parameters are a plain dict of tensors laid out as the JAX pytree: per-layer
weights stacked on a leading ``[L, ...]`` axis, projections stored for
``x @ W`` (HF's Conv1D ``[in, out]`` layout), the fused QKV projection
``[L, d, 3d]`` split as ``(3, H, hd)``.  The JAX ``lax.scan`` over layers is
a Python loop over that axis.

Covered here: :class:`GPT2Config`, :func:`init_params`, the training
forward and loss (:func:`apply_hidden`, :func:`apply`, :func:`loss_fn`,
dense or chunked; per-layer activation checkpointing under ``remat``), the
dense KV cache (:func:`init_cache`, :func:`apply_cached`), the paged
serving forward (:func:`apply_paged`, whose decode runs the paged kernels
under ``kernel=True``), greedy and sampled :func:`generate`,
:func:`speculative_generate` and :func:`generate_beam`; ``kv_cache_quant``
stores the KV cache as int8 codes with bf16 scales.  int8-weight layers
(``quantize_weights``, ROADMAP A8) raise ``NotImplementedError``.

On a mesh with an active ``fsdp`` or ``tp`` axis the training forward and
loss take a :class:`~..parallel.sharding.Layout` (``layout=``; a
``FunctionalModel`` with ``handles_layout`` passes it) and each process
holds its shard of each leaf by :data:`PARTITION_RULES` (the JAX table):
each layer gathers its leaves' ``fsdp`` dims where it runs, and under
``tp`` Megatron's pair splits the attention by heads and the MLP by width.
The fused QKV's ``tp`` shard is a contiguous chunk of its ``3 * H * hd``
columns, not a set of heads, so the layer gathers it whole over ``tp``
(the backward sums its gradient over ``tp`` and keeps this process's
chunk) and takes its heads' q, k and v columns; a replicated bias enters
through ``tp_copy`` before its chunk is taken.  Where ``tp`` does not
divide the heads, every process computes every head from the whole
weights.  The tied embedding is vocabulary-parallel, and so is the loss
(llama's).  Under ``sp`` (a ``FunctionalModel`` with
``splits_sequence=True``) each process runs its chunk of the sequence:
the learned positions are the chunk's global ones, the attention is
llama's :func:`~.llama.sp_attention` (causal, the padding mask's chunk
riding the ring), and the loss is llama's chunk-and-sum.  The cached and
paged serving forwards take the same ``layout`` (or read it from the
shards' specs): each rank computes and caches its heads (every head where
``tp`` does not divide them) and returns the whole logits.

The learned position table has ``max_seq_len`` rows, so a dense cache or a
block table longer than that raises: GPT-2 serving needs
``max_blocks_per_seq * block_size <= max_seq_len``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import tp_copy, tp_reduce
from ..parallel.sharding import TpView, layer_leaves, leaf, specs_from_rules, vocab_lookup
from ..state import resolve_device
from .llama import (
    _check_cache_heads,
    _model_sharded,
    _sp_active,
    cross_entropy,
    labels_and_weights,
    sp_attention,
    sp_gather,
    sp_inputs,
    serving_init_cache,
    serving_layout,
    token_loss,
    vocab_gather,
)

__all__ = [
    "GPT2Config",
    "init_params",
    "param_specs",
    "PARTITION_RULES",
    "apply",
    "apply_hidden",
    "lm_head",
    "loss_fn",
    "init_cache",
    "apply_cached",
    "apply_paged",
    "generate",
    "speculative_generate",
    "generate_beam",
]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Field for field the JAX ``GPT2Config``; ``dtype``/``param_dtype``
    are torch dtypes.  ``remat`` checkpoints each layer of the training
    forward (the backward recomputes it); ``loss_impl="chunked"`` streams
    the tied head's loss over vocabulary tiles."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    loss_impl: str = "dense"
    loss_chunk_size: int = 4096
    sp_impl: str = "ring"
    kv_cache_quant: bool = False

    def __post_init__(self):
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"loss_impl must be 'dense' or 'chunked', got {self.loss_impl!r}")
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """Test-sized config."""
        defaults = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                        max_seq_len=128, remat=False)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt2_small(cls, **kw) -> "GPT2Config":
        return cls(**kw)

    def num_params(self) -> int:
        d, v, l = self.hidden_size, self.vocab_size, self.num_layers
        attn = 3 * d * d + 3 * d + d * d + d  # qkv + proj with biases
        mlp = d * 4 * d + 4 * d + 4 * d * d + d
        norms = 4 * d
        return l * (attn + mlp + norms) + v * d + self.max_seq_len * d + 2 * d


def _param_shapes(c: GPT2Config) -> dict:
    d, L = c.hidden_size, c.num_layers
    return {
        "wte": (c.vocab_size, d),
        "wpe": (c.max_seq_len, d),
        "layers": {
            "w_qkv": (L, d, 3 * d),
            "b_qkv": (L, 3 * d),
            "w_proj": (L, d, d),
            "b_proj": (L, d),
            "w_up": (L, d, 4 * d),
            "b_up": (L, 4 * d),
            "w_down": (L, 4 * d, d),
            "b_down": (L, d),
            "ln_attn_scale": (L, d),
            "ln_attn_bias": (L, d),
            "ln_mlp_scale": (L, d),
            "ln_mlp_bias": (L, d),
        },
        "final_ln_scale": (d,),
        "final_ln_bias": (d,),
    }


# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``gpt2.PARTITION_RULES``: the vocabulary on ``tp``, the fused QKV and up
# projections column-parallel, the output and down projections row-parallel.
PARTITION_RULES: list = [
    (r"wte", ("tp", "fsdp")),
    (r"wpe", (None, "fsdp")),
    (r"layers/w_qkv", (None, "fsdp", "tp")),
    (r"layers/w_proj", (None, "tp", "fsdp")),
    (r"layers/w_up", (None, "fsdp", "tp")),
    (r"layers/w_down", (None, "tp", "fsdp")),
    (r"layers/(b_|ln_)", (None, None)),
    (r"final_ln", (None,)),
]


def param_specs(config: GPT2Config) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


def init_params(config: GPT2Config, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule (GPT-2's):
    LayerNorm scales one, biases zero, every weight normal(0, 0.02).  Drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``); the numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config

    def init_one(name, shape):
        # By name, as the JAX init: a shape test would zero the (max_seq_len,
        # d) position table whenever max_seq_len == num_layers.
        if name.endswith("_scale"):
            return torch.ones(shape, dtype=c.param_dtype, device=dev)
        if name.startswith("b_") or name.endswith("_bias"):
            return torch.zeros(shape, dtype=c.param_dtype, device=dev)
        out = torch.empty(shape, dtype=c.param_dtype, device=dev)
        # One layer at a time: the fp32 draw of a stacked leaf would double
        # the peak memory of a bf16 model.
        for sub in (out if len(shape) == 3 else [out]):
            draw = torch.empty(sub.shape, dtype=torch.float32, device=dev)
            draw.normal_(0.0, 0.02, generator=gen)
            sub.copy_(draw)
        return out

    shapes = _param_shapes(config)
    params = {k: init_one(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: init_one(k, s) for k, s in shapes["layers"].items()}
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _dequant_layer(layers: dict) -> dict:
    """The JAX per-layer hook that dequantizes int8-weight leaves
    (``quantize_weights``).  Every leaf here must be a tensor: int8-weight
    storage is not ported yet (ROADMAP A8)."""
    for name, leaf in layers.items():
        if not isinstance(leaf, torch.Tensor):
            raise NotImplementedError(
                f"layer leaf {name!r} is a {type(leaf).__name__}: int8-weight layers "
                "(quantize_weights) are not ported to accelerate_tpu_torch yet (ROADMAP.md A8)")
    return layers


def _layer_norm(x, scale, bias, eps):
    """LayerNorm with fp32 statistics; the normalised value is cast to
    ``x.dtype`` before scale and bias are applied in that dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def _qkv(x, p, c: GPT2Config, tp=None):
    """Pre-norm fused QKV projection -> q, k, v ``[B, S, H, hd]``; under
    ``tp`` (a :class:`~..parallel.sharding.TpView`) this process's heads,
    from the whole fused weight (module docstring)."""
    b, s, _ = x.shape
    tp = tp or _NO_TP
    hn = tp_copy(_layer_norm(x, p["ln_attn_scale"], p["ln_attn_bias"], c.layer_norm_eps),
                 tp.attn)
    w = tp.head_chunk(p["w_qkv"], 3)
    bias = p["b_qkv"] if tp.heads is None else tp.head_chunk(tp_copy(p["b_qkv"], tp.group), 3)
    qkv = hn @ w.to(c.dtype) + bias.to(c.dtype)
    q, k, v = qkv.reshape(b, s, 3, -1, c.head_dim).unbind(2)
    return q, k, v


def _attend(q, k, v, mask, c: GPT2Config):
    """Masked softmax attention; ``mask`` broadcasts against ``[B, H, Sq,
    Sk]``.  Scores in the compute dtype, then fp32 over sqrt(hd); masked
    entries -1e30; probabilities cast to the value dtype."""
    b, s = q.shape[:2]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(c.head_dim)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, -1)


def _mlp_block(x, p, c: GPT2Config, tp=None):
    """Pre-norm GELU (tanh approximation, HF's ``gelu_new``) MLP with
    residual; under ``tp`` up column-parallel, down row-parallel."""
    tp = tp or _NO_TP
    hn = tp_copy(_layer_norm(x, p["ln_mlp_scale"], p["ln_mlp_bias"], c.layer_norm_eps),
                 tp.group)
    u = F.gelu(hn @ p["w_up"].to(c.dtype) + tp.chunk(p["b_up"]).to(c.dtype),
               approximate="tanh")
    return x + tp_reduce(u @ p["w_down"].to(c.dtype), tp.group) + p["b_down"].to(c.dtype)


def _proj_and_mlp(x, attn, p, c: GPT2Config, tp=None):
    """Attention output projection + residual, then the MLP block; under
    ``tp`` the projection row-parallel (over this process's heads)."""
    out = tp_reduce(attn @ p["w_proj"].to(c.dtype), (tp or _NO_TP).attn)
    return _mlp_block(x + out + p["b_proj"].to(c.dtype), p, c, tp)


def _layer(x, p, c: GPT2Config, mask, tp=None, sp_mesh=None, kv_valid=None):
    q, k, v = _qkv(x, p, c, tp)
    if sp_mesh is not None:
        # This process's chunk: the shared ring / Ulysses dispatch, causal
        # by global positions, the validity chunk riding the ring.
        b, s = q.shape[:2]
        attn = sp_attention(q, k, v, c, causal=True, kv_valid=kv_valid,
                            mesh=sp_mesh).reshape(b, s, -1)
    else:
        attn = _attend(q, k, v, mask[:, None], c)
    return _proj_and_mlp(x, attn, p, c, tp)


def _embed(params: dict, input_ids: torch.Tensor, positions: torch.Tensor,
           c: GPT2Config, layout=None) -> torch.Tensor:
    """Token plus position embeddings in the compute dtype; ``positions``
    broadcasts against ``input_ids``.  On a ``layout``: the tables'
    ``fsdp`` dims gathered, the token lookup over this process's
    vocabulary rows (:func:`~..parallel.sharding.embed_lookup`)."""
    if layout is None:
        return (F.embedding(input_ids.long(), params["wte"]).to(c.dtype)
                + params["wpe"].to(c.dtype)[positions])
    tok = vocab_lookup(leaf(params, "wte", layout, c.dtype), input_ids, c.dtype, layout)
    return tok + leaf(params, "wpe", layout, c.dtype)[positions]


def _final(params: dict, x: torch.Tensor, c: GPT2Config, layout=None) -> torch.Tensor:
    return _layer_norm(x, leaf(params, "final_ln_scale", layout, c.dtype),
                       leaf(params, "final_ln_bias", layout, c.dtype), c.layer_norm_eps)


def lm_head(params: dict, config: GPT2Config, layout=None) -> torch.Tensor:
    """The tied ``[d, V]`` head (``wte`` transposed) in the compute dtype;
    on a ``layout`` its ``fsdp`` dim gathered, its ``tp`` columns (this
    process's vocabulary rows) local."""
    return leaf(params, "wte", layout, config.dtype).to(config.dtype).T


_NO_TP = TpView()


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def apply_hidden(params: dict, input_ids: torch.Tensor, config: GPT2Config,
                 attention_mask: Optional[torch.Tensor] = None, layout=None) -> torch.Tensor:
    """Trunk forward: token ids ``[B, S]`` -> final-LN hidden ``[B, S, d]``
    in the compute dtype.  Positions are ``0 .. S-1`` whatever the mask says
    (as in the JAX package); ``attention_mask`` removes padded keys.  Under
    ``config.remat`` each layer runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of stored.
    ``layout``: the sharded path (module docstring); under ``sp`` the
    hidden is gathered over ``sp``."""
    return sp_gather(_trunk(params, input_ids, config, attention_mask, layout), layout)


def _trunk(params: dict, input_ids: torch.Tensor, config: GPT2Config,
           attention_mask: Optional[torch.Tensor] = None, layout=None) -> torch.Tensor:
    """:func:`apply_hidden` before the gather: under ``sp`` this process's
    chunk of the sequence, at its global positions, and no ``[S, S]``
    mask."""
    c = config
    b, s = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(s, device=dev)[None]
    kv_valid = None if attention_mask is None else attention_mask.bool()
    sp_mesh = _sp_active(layout)
    mask = None
    if sp_mesh is None:
        mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril().expand(b, s, s)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
    input_ids, positions, kv_valid = sp_inputs(layout, s, input_ids, positions, kv_valid)
    x = _embed(params, input_ids, positions, c, layout)
    tp = TpView(layout, c.num_heads)
    names, per_layer, prep = layer_leaves(
        _dequant_layer(params["layers"]), layout, "layers", c.dtype,
        tp.head_gathers(fused=("w_qkv",), rows=("w_proj",)))

    def layer(x, *weights):
        return _layer(x, {k: prep(k, w) for k, w in zip(names, weights)}, c, mask, tp,
                      sp_mesh, kv_valid)

    for weights in per_layer:
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x = layer(x, *weights)
    return _final(params, x, c, layout)


def apply(params: dict, input_ids: torch.Tensor, config: GPT2Config,
          attention_mask: Optional[torch.Tensor] = None, layout=None) -> torch.Tensor:
    """Token ids ``[B, S]`` -> fp32 logits ``[B, S, V]`` (tied head);
    ``layout`` as in :func:`apply_hidden` (the head whole: off ``tp``;
    under ``sp`` each process's chunk of the logits, gathered)."""
    hidden = _trunk(params, input_ids, config, attention_mask, layout)
    return sp_gather((hidden @ lm_head(params, config, layout)).float(), layout)


def loss_fn(params: dict, batch: dict, config: GPT2Config, layout=None) -> torch.Tensor:
    """Next-token cross-entropy, fp32, mean over non-padded targets (the
    llama family's ``labels_and_weights`` and ``cross_entropy``);
    ``config.loss_impl == "chunked"`` streams the head over vocabulary tiles
    (``ops/chunked_ce.py``), so the ``[B, S, V]`` logits never exist.  On a
    ``layout`` under ``tp``: llama's loss over the vocabulary shards; under
    ``sp``: this process's chunk's part, summed over ``sp``."""
    labels, weights = labels_and_weights(batch)
    mask = batch.get("attention_mask")
    if layout is None and config.loss_impl != "chunked":
        logits = apply(params, batch["input_ids"], config, attention_mask=mask)
        return cross_entropy(logits, labels, weights)
    hidden = _trunk(params, batch["input_ids"], config, attention_mask=mask, layout=layout)
    return token_loss(hidden, params, labels, weights, config, layout,
                      head=lm_head(params, config, layout))


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------


def init_cache(config: GPT2Config, batch_size: int, max_len: int, device=None,
               layout=None) -> dict:
    """Zeroed KV cache: k/v ``[L, B, max_len, H, hd]`` + write index;
    ``config.kv_cache_quant`` stores int8 codes with bf16 scales.  On a
    model-sharded ``layout`` ``H`` is the heads this process computes
    (``H / tp`` where ``tp`` divides them, else every head)."""
    from .generation import make_kv_cache

    c = config
    return make_kv_cache(
        c.num_layers, batch_size, max_len, _cache_heads(c, layout if _model_sharded(layout) else None),
        c.head_dim, c.dtype, device=resolve_device(device), quantized=c.kv_cache_quant,
    )


def _cache_heads(c: GPT2Config, layout) -> int:
    heads = TpView(layout, c.num_heads).heads
    return c.num_heads if heads is None else heads[1]


def _serving_layers(params: dict, c: GPT2Config, layout):
    """``(tp, names, per_layer, prep)`` of a serving forward: the training
    forward's ``TpView`` and per-layer leaves on ``layout`` (None: whole
    weights, one process's view); each leaf gathered in its own dtype."""
    tp = TpView(layout, c.num_heads)
    names, per_layer, prep = layer_leaves(
        _dequant_layer(params["layers"]), layout, "layers", None,
        tp.head_gathers(fused=("w_qkv",), rows=("w_proj",)))
    return tp, names, per_layer, prep


def _serving_logits(params: dict, x, c: GPT2Config, layout) -> torch.Tensor:
    """The final LN and the tied head -> fp32 logits, on ``layout`` this
    process's vocabulary columns gathered over ``tp``."""
    x = _final(params, x, c, layout)
    return vocab_gather((x @ lm_head(params, c, layout)).float(), layout)


def _check_positions(extent: int, c: GPT2Config, what: str) -> None:
    if extent > c.max_seq_len:
        raise ValueError(
            f"{what} {extent} exceeds max_seq_len {c.max_seq_len} "
            "(GPT-2's learned position table)")


@torch.no_grad()
def apply_cached(params: dict, input_ids: torch.Tensor, config: GPT2Config, cache: dict,
                 layout=None):
    """Forward over new tokens at positions ``cache['index'] .. index+S``
    with cache read/write; returns (logits ``[B, S, V]`` fp32, cache).  The
    cache tensors are written in place (JAX returns updated copies); the
    returned dict shares them and carries the advanced index.  A cache
    longer than ``max_seq_len`` raises.

    ``layout`` (or the specs kept on sharded leaves: llama's
    ``serving_layout``): the training forward's plumbing, each layer's
    leaves gathered over ``fsdp``; under ``tp`` the fused QKV split by this
    process's heads (every head where ``tp`` does not divide them), the
    MLP column / row parallel, the cache holding the heads this process
    computes, and the tied head's vocabulary columns gathered, so every
    process returns the whole logits."""
    from .generation import cache_write, check_cache_room

    c = config
    layout = serving_layout(params, layout)
    b, s = input_ids.shape
    index = int(cache["index"])
    max_len = cache["k"].shape[2]
    check_cache_room(index, s, max_len)
    _check_positions(max_len, c, "cache length")
    _check_cache_heads(cache["k"], _cache_heads(c, layout))
    tp, names, per_layer, prep = _serving_layers(params, c, layout)
    dev = input_ids.device
    positions = index + torch.arange(s, device=dev)
    x = _embed(params, input_ids, positions[None], c, layout)
    mask = (positions[:, None] >= torch.arange(max_len, device=dev)[None, :])[None, None]
    quant = "k_scale" in cache

    def layer_leaf(name, i):
        return (cache[name][i], cache[name + "_scale"][i]) if quant else cache[name][i]

    for i, weights in enumerate(per_layer):
        p = {k: prep(k, w) for k, w in zip(names, weights)}
        q, k, v = _qkv(x, p, c, tp)
        k_full = cache_write(layer_leaf("k", i), k, index, c.dtype)
        v_full = cache_write(layer_leaf("v", i), v, index, c.dtype)
        x = _proj_and_mlp(x, _attend(q, k_full, v_full, mask, c), p, c, tp)
    return _serving_logits(params, x, c, layout), dict(cache, index=index + s)


@torch.no_grad()
def apply_paged(params: dict, input_ids: torch.Tensor, config: GPT2Config, pool: dict,
                tables: torch.Tensor, starts: torch.Tensor, kernel: bool = False, layout=None):
    """Forward over new tokens straight against the paged block pool — the
    serving engine's decode, verify and prefill forward.

    tokens ``[B, T]`` sit at positions ``starts[b] .. starts[b]+T-1``; the
    pool is ``{k, v: [L, N, bs, H, hd]}`` (the int8 pool adds ``k_scale``,
    ``v_scale``), tables ``[B, M]`` int32, starts ``[B]`` int32.  Returns
    (logits ``[B, T, V]`` fp32, the rows this forward wrote, one ``[B, L, T,
    ...]`` entry per pool leaf) for the caller's scatter; the pool itself is
    only read.  A table extent ``M * bs`` beyond ``max_seq_len`` raises;
    chunked-prefill padding past the table reads the last position row, as
    the JAX gather clamps (those rows' outputs are discarded).

    ``kernel=True`` sends attention of an fp pool through the paged
    kernels: the single-token one at ``T == 1``, the window one at ``T >
    1``.  On CUDA tensors they launch the Hopper kernel or raise; on CPU
    tensors they run their plain version.  An int8 pool takes the plain
    path whatever ``kernel`` says, as in the JAX package.  ``layout``: the
    sharded forward of :func:`apply_cached`, the pool holding the heads this
    process computes (built from :func:`init_cache` on the same layout)."""
    from ..ops import paged_attention as pa
    from .generation import pack_paged_pool_for_scan, paged_cache_write, unpack_paged_rows_from_scan

    c = config
    layout = serving_layout(params, layout)
    b, t = input_ids.shape
    _check_cache_heads(pool["k"], _cache_heads(c, layout))
    pk_all, pv_all, quant = pack_paged_pool_for_scan(pool)
    total = tables.shape[1] * pool["k"].shape[2]
    _check_positions(total, c, "block table extent")
    tp, names, per_layer, prep = _serving_layers(params, c, layout)
    use_kernel = kernel and not quant
    dev = input_ids.device
    positions = starts[:, None].long() + torch.arange(t, device=dev)[None]
    x = _embed(params, input_ids, positions.clamp(max=c.max_seq_len - 1), c, layout)
    mask = (positions[:, :, None] >= torch.arange(total, device=dev)[None, None, :])[:, None]
    k_rows, v_rows = [], []
    for i, weights in enumerate(per_layer):
        p = {k: prep(k, w) for k, w in zip(names, weights)}
        if quant:
            pk, pv = (pk_all[0][i], pk_all[1][i]), (pv_all[0][i], pv_all[1][i])
        else:
            pk, pv = pk_all[i], pv_all[i]
        q, k, v = _qkv(x, p, c, tp)
        if use_kernel:
            k_store = k.to(pk.dtype).contiguous()
            v_store = v.to(pv.dtype).contiguous()
            if t == 1:
                attn = pa.paged_attention(
                    q[:, 0].contiguous(), k_store[:, 0], v_store[:, 0], pk, pv, tables, starts
                )[:, None]
            else:
                attn = pa.paged_window_attention(
                    q.contiguous(), k_store, v_store, pk, pv, tables, starts)
            attn = attn.reshape(b, t, -1)
        else:
            k_store, k_full = paged_cache_write(pk, k, tables, starts, c.dtype)
            v_store, v_full = paged_cache_write(pv, v, tables, starts, c.dtype)
            attn = _attend(q, k_full, v_full, mask, c)
        x = _proj_and_mlp(x, attn, p, c, tp)
        k_rows.append(k_store)
        v_rows.append(v_store)
    return (_serving_logits(params, x, c, layout),
            unpack_paged_rows_from_scan(k_rows, v_rows, quant))


def generate(params: dict, input_ids: torch.Tensor, config: GPT2Config, max_new_tokens: int,
             temperature: float = 0.0, key=None, max_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 1.0, prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or sampled autoregressive generation:
    ``[B, S]`` -> ``[B, S + max_new_tokens]`` (see
    ``generation.generate_loop``); the cache must fit the position table.
    On shards every forward is the sharded one."""
    from .generation import generate_loop

    return generate_loop(
        apply_cached, serving_init_cache(init_cache, params), params, input_ids, config,
        max_new_tokens,
        temperature=temperature, key=key, max_len=max_len, top_k=top_k, top_p=top_p,
        prefill_chunk=prefill_chunk,
    )


def speculative_generate(params: dict, draft_params: dict, input_ids: torch.Tensor,
                         config: GPT2Config, draft_config: GPT2Config, max_new_tokens: int,
                         num_draft_tokens: int = 4, max_len: Optional[int] = None,
                         return_stats: bool = False, temperature: float = 0.0, key=None):
    """Speculative decoding with a draft GPT-2 (see
    ``generation.speculative_generate_loop``): greedy output is
    token-identical to ``generate(..., temperature=0)``.  Batch 1 only; the
    cache slack (prompt + new + ``num_draft_tokens``) must fit the position
    table."""
    from .generation import speculative_generate_loop

    return speculative_generate_loop(
        apply_cached, serving_init_cache(init_cache, params), params, config,
        apply_cached, serving_init_cache(init_cache, draft_params), draft_params, draft_config,
        input_ids, max_new_tokens, num_draft_tokens=num_draft_tokens, max_len=max_len,
        return_stats=return_stats, temperature=temperature, key=key,
    )


def generate_beam(params: dict, input_ids: torch.Tensor, config: GPT2Config,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  eos_token_id: Optional[int] = None,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Beam-search generation (see ``generation.beam_search``)."""
    from .generation import beam_search

    return beam_search(
        apply_cached, serving_init_cache(init_cache, params), params, input_ids, config,
        max_new_tokens,
        num_beams=num_beams, length_penalty=length_penalty, eos_token_id=eos_token_id,
        max_len=max_len,
    )
