"""BERT-style bidirectional encoder in PyTorch: the JAX package's
``accelerate_tpu/models/bert.py`` with the same parameter tree, numerics and
public contracts.

Post-LN transformer layers (residual, then LayerNorm with bias), learned
position and token-type embeddings, a tanh pooler over the first token and
a classification head.  Parameters are a plain dict of tensors laid out as
the JAX pytree: per-layer weights stacked on a leading ``[L, ...]`` axis,
projections stored for ``x @ W``, the fused QKV projection ``[L, d, 3d]``
split as ``(3, H, hd)``.  The GELU is the tanh approximation
(``jax.nn.gelu``'s default), not BERT's erf.

Attention is the einsum path, as in the JAX package off its sequence-
parallel mesh: no kernel of this module is hand-written.  A padding mask
removes padded keys and padded queries alike (the dense JAX path).

Under ``sp`` (a ``FunctionalModel`` with ``splits_sequence=True``) each
process runs its chunk of the sequence through llama's
:func:`~.llama.sp_attention` (bidirectional: the ring, or Ulysses under
``sp_impl="ulysses"``), the padding mask removing padded keys only, as the
JAX sp path does (padded query rows attend normally, and nothing reads
them).  The pooler reads token 0, which lies in ``sp`` rank 0's chunk: the
loss is that rank's, the others' part is zero (multiplied out, so every
rank's backward runs the same collectives), summed over ``sp``.

On a mesh with an active ``fsdp`` or ``tp`` axis :func:`apply` and the
loss take a :class:`~..parallel.sharding.Layout` (``layout=``) and each
process holds its shard of each leaf by :data:`PARTITION_RULES` (the JAX
table): GPT-2's split of the layers (the fused QKV gathered over ``tp``,
each process taking its heads' columns), the pooler column-parallel and
the classifier row-parallel, whose partial logits are summed over ``tp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import tp_copy, tp_reduce
from ..parallel.sharding import TpView, layer_leaves, leaf, specs_from_rules
from ..state import resolve_device
from .gpt2 import _layer_norm
from .llama import _sp_active, sp_attention, sp_gather, sp_inputs, sp_sum

__all__ = ["BertConfig", "init_params", "param_specs", "PARTITION_RULES", "apply",
           "classification_loss_fn"]

# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``bert.PARTITION_RULES``.
PARTITION_RULES: list = [
    (r"embeddings/", (None, "fsdp")),
    (r"layers/w_qkv", (None, "fsdp", "tp")),
    (r"layers/w_proj", (None, "tp", "fsdp")),
    (r"layers/w_up", (None, "fsdp", "tp")),
    (r"layers/w_down", (None, "tp", "fsdp")),
    (r"pooler/w", ("fsdp", "tp")),
    (r"classifier/w", ("tp", None)),
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Field for field the JAX ``BertConfig``; ``dtype``/``param_dtype`` are
    torch dtypes.  ``remat`` checkpoints each layer of the forward."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False
    sp_impl: str = "ring"

    def __post_init__(self):
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        defaults = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64)
        defaults.update(kw)
        return cls(**defaults)


def _param_shapes(c: BertConfig) -> dict:
    d, L = c.hidden_size, c.num_layers
    return {
        "embeddings": {
            "word": (c.vocab_size, d),
            "position": (c.max_seq_len, d),
            "token_type": (c.type_vocab_size, d),
            "ln_scale": (d,),
            "ln_bias": (d,),
        },
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
        "pooler": {"w": (d, d), "b": (d,)},
        "classifier": {"w": (d, c.num_labels), "b": (c.num_labels,)},
    }


def _init_normal_tree(shapes: dict, dtype, device, seed: int, std: float, ones, zeros) -> dict:
    """A nested dict of tensors for a nested dict of shapes: ``ones(name)``
    leaves one, ``zeros(name)`` leaves zero, the rest normal(0, ``std``)
    drawn in fp32 from one ``torch.Generator`` seeded with ``seed``, each
    2-D slice of a leaf at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(name, shape):
        if ones(name):
            return torch.ones(shape, dtype=dtype, device=device)
        if zeros(name):
            return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for sub in out.reshape(-1, *shape[-2:]) if len(shape) >= 2 else [out]:
            draw = torch.empty(sub.shape, dtype=torch.float32, device=device)
            sub.copy_(draw.normal_(0.0, std, generator=gen))
        return out

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(k, v) for k, v in tree.items()}

    return walk(shapes)


def param_specs(config: BertConfig) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


def init_params(config: BertConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule:
    LayerNorm scales one, biases zero, every weight normal(0, 0.02), on
    ``device`` (default ``cuda``); the numbers differ from ``jax.random``'s."""
    return _init_normal_tree(
        _param_shapes(config), config.param_dtype, resolve_device(device), seed, 0.02,
        ones=lambda n: n.endswith("scale"),
        zeros=lambda n: n.startswith("b_") or n.endswith("bias") or n == "b")


def _attend(q, k, v, mask=None):
    """Softmax attention over ``[B, S, H, hd]``: scores in the compute dtype,
    then fp32 over sqrt(hd), ``mask`` (broadcast against ``[B, H, S, T]``)
    entries out at -1e30, probabilities cast to the value dtype.  Returns
    ``[B, S, H*hd]``."""
    b, s, h, hd = q.shape
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * hd)


def _qkv_heads(x, p, c, tp=None):
    """The fused QKV projection split into q, k, v ``[B, S, H, hd]``; under
    ``tp`` (a :class:`~..parallel.sharding.TpView`) this process's heads of
    the whole fused weight, its input through ``tp_copy``."""
    b, s, _ = x.shape
    tp = tp or _NO_TP
    x = tp_copy(x, tp.attn)
    w = tp.head_chunk(p["w_qkv"], 3)
    bias = p["b_qkv"] if tp.heads is None else tp.head_chunk(tp_copy(p["b_qkv"], tp.group), 3)
    qkv = x @ w.to(c.dtype) + bias.to(c.dtype)
    return qkv.reshape(b, s, 3, -1, c.head_dim).unbind(2)


def _run_layers(x, layers: dict, remat: bool, layer_fn, layout=None, path: str = "layers",
                dtype=None, tp_grad=None):
    """``layer_fn(x, p)`` over the stacked ``[L, ...]`` layers, each layer under
    ``torch.utils.checkpoint`` when ``remat`` and gradients are on; on a
    ``layout`` each layer's leaves gathered where it runs
    (:func:`~..parallel.sharding.layer_leaves`, ``path`` the stack's place
    in the spec tree)."""
    names, per_layer, prep = layer_leaves(layers, layout, path, dtype, tp_grad)

    def layer(x, *weights):
        return layer_fn(x, {k: prep(k, w) for k, w in zip(names, weights)})

    for weights in per_layer:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x = layer(x, *weights)
    return x


def _layer(x, p, c: BertConfig, mask, tp=None, sp_mesh=None, kv_valid=None):
    tp = tp or _NO_TP
    q, k, v = _qkv_heads(x, p, c, tp)
    if sp_mesh is not None:
        # Bidirectional over the whole sequence; padded keys only.
        b, s = q.shape[:2]
        attn = sp_attention(q, k, v, c, causal=False, kv_valid=kv_valid,
                            mesh=sp_mesh).reshape(b, s, -1)
    else:
        attn = _attend(q, k, v, mask[:, None])
    # Post-LN (original BERT): residual then LayerNorm.
    x = _layer_norm(x + tp_reduce(attn @ p["w_proj"].to(c.dtype), tp.attn)
                    + p["b_proj"].to(c.dtype), p["ln_attn_scale"], p["ln_attn_bias"],
                    c.layer_norm_eps)
    u = F.gelu(tp_copy(x, tp.group) @ p["w_up"].to(c.dtype) + tp.chunk(p["b_up"]).to(c.dtype),
               approximate="tanh")
    return _layer_norm(x + tp_reduce(u @ p["w_down"].to(c.dtype), tp.group)
                       + p["b_down"].to(c.dtype), p["ln_mlp_scale"], p["ln_mlp_bias"],
                       c.layer_norm_eps)


def _stack_gathers(tp) -> dict:
    """The ``tp`` gathers of a GPT-2-style layer (fused QKV, row-parallel
    output projection)."""
    return tp.head_gathers(fused=("w_qkv",), rows=("w_proj",))


def apply(params: dict, input_ids: torch.Tensor, config: BertConfig,
          attention_mask: Optional[torch.Tensor] = None,
          token_type_ids: Optional[torch.Tensor] = None, layout=None):
    """Token ids ``[B, S]`` -> (sequence output ``[B, S, d]`` in the compute
    dtype, pooled ``[B, d]`` fp32).  ``attention_mask`` ``[B, S]`` masks
    padded keys and queries.  ``layout``: the sharded path (module
    docstring); under ``tp`` ``pooled`` holds this process's columns; under
    ``sp`` the sequence output is gathered over ``sp`` and ``pooled`` is
    ``sp`` rank 0's on every process."""
    x, pooled = _trunk(params, input_ids, config, attention_mask, token_type_ids, layout)
    if _sp_active(layout) is not None:
        # Rank 0's pooled features on every process (a gather, then the
        # first entry: the others' backward gets zero).
        pooled = sp_gather(pooled[:, None], layout)[:, 0]
    return sp_gather(x, layout), pooled


def _trunk(params: dict, input_ids: torch.Tensor, config: BertConfig,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None, layout=None):
    """:func:`apply` before the gathers: under ``sp`` this process's chunk
    and the pooler over its first token (the whole row's token 0 on ``sp``
    rank 0)."""
    c = config
    b, s = input_ids.shape
    dev = input_ids.device
    sp_mesh = _sp_active(layout)
    mask = valid = None
    if attention_mask is None:
        if sp_mesh is None:
            mask = torch.ones((b, s, s), dtype=torch.bool, device=dev)
    else:
        valid = attention_mask.bool()
        if sp_mesh is None:
            mask = valid[:, None, :] & valid[:, :, None]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    e = {k: leaf(params, f"embeddings/{k}", layout, c.dtype) for k in params["embeddings"]}
    positions = e["position"].to(c.dtype)[:s][None]
    input_ids, token_type_ids, positions, valid = sp_inputs(
        layout, s, input_ids, token_type_ids, positions, valid)
    x = (F.embedding(input_ids.long(), e["word"]).to(c.dtype) + positions
         + e["token_type"].to(c.dtype)[token_type_ids.long()])
    x = _layer_norm(x, e["ln_scale"], e["ln_bias"], c.layer_norm_eps)
    tp = TpView(layout, c.num_heads)
    x = _run_layers(x, params["layers"], c.remat,
                    lambda x, p: _layer(x, p, c, mask, tp, sp_mesh, valid),
                    layout, "layers", c.dtype, _stack_gathers(tp))
    first = tp_copy(x[:, 0].float(), tp.group)
    pooled = torch.tanh(first @ leaf(params, "pooler/w", layout).float()
                        + tp.chunk(leaf(params, "pooler/b", layout)))
    return x, pooled


def _classify(params: dict, pooled: torch.Tensor, labels: torch.Tensor, layout=None,
              tp=None) -> torch.Tensor:
    """Mean cross-entropy of the fp32 classifier head over ``pooled``; under
    ``tp`` ``pooled`` holds this process's features, the head's rows, and
    the partial logits are summed over ``tp``."""
    w = leaf(params, "classifier/w", layout).float()
    logits = tp_reduce(pooled @ w, (tp or _NO_TP).group) + leaf(params, "classifier/b", layout)
    return -torch.log_softmax(logits, -1).gather(-1, labels.long()[:, None]).mean()


def classification_loss_fn(params: dict, batch: dict, config: BertConfig,
                           layout=None) -> torch.Tensor:
    """Sequence-classification cross-entropy over ``batch["labels"]`` [B];
    under ``sp`` ``sp`` rank 0's loss (module docstring)."""
    _, pooled = _trunk(params, batch["input_ids"], config,
                       attention_mask=batch.get("attention_mask"),
                       token_type_ids=batch.get("token_type_ids"), layout=layout)
    loss = _classify(params, pooled, batch["labels"], layout, TpView(layout, config.num_heads))
    return first_chunk_loss(loss, layout)


def first_chunk_loss(loss: torch.Tensor, layout) -> torch.Tensor:
    """Under ``sp``: ``loss`` where this process holds the sequence's first
    chunk, zero (``loss`` times 0, so the backward still runs) elsewhere,
    summed over ``sp``; off ``sp``, ``loss``."""
    if _sp_active(layout) is None:
        return loss
    return sp_sum(loss * float(layout.sp_rank == 0), layout)


_NO_TP = TpView()
