"""ViT in PyTorch: the JAX package's ``accelerate_tpu/models/vit.py`` with the
same parameter tree, numerics and public contracts.

The patch embedding is a reshape + ``[p*p*C, d]`` matmul (a strided conv
computes the same), pre-LN transformer blocks, learned position
embeddings, CLS-token or mean pooling and a classification head.  Pixels
are channels-last ``[B, H, W, C]``, as in the JAX package (transpose NCHW
inputs before calling).  Parameters are a plain dict of tensors laid out as
the JAX pytree (per-layer weights stacked on a leading ``[L, ...]`` axis,
projections stored for ``x @ W``); the GELU is the tanh approximation.

Attention is the einsum path, as in the JAX package off its sequence-
parallel mesh: no kernel of this module is hand-written.  Under ``sp`` (a
``FunctionalModel`` with ``splits_sequence=True``) each process runs its
chunk of the patches through llama's
:func:`~.llama.sp_attention` (bidirectional: the ring, or Ulysses under
``sp_impl="ulysses"``); ``pool="cls"`` raises there, with JAX's message,
and ``"mean"`` pools over every process's tokens (the chunk sums added
over ``sp`` both ways, :func:`~..parallel.collectives.data_sum`), the
loss ``sp`` rank 0's (BERT's ``first_chunk_loss``).

On a mesh with an active ``fsdp`` or ``tp`` axis :func:`apply` and the
loss take a :class:`~..parallel.sharding.Layout` (``layout=``) and each
process holds its shard of each leaf by :data:`PARTITION_RULES` (the JAX
table): BERT's split of the layers, and the classifier row-parallel on the
replicated pooled features (each process multiplies its chunk of them,
then the partial logits are summed over ``tp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..parallel.collectives import tp_copy, tp_reduce
from ..parallel.sharding import TpView, leaf, specs_from_rules
from ..state import resolve_device
from .bert import (_NO_TP, _attend, _classify, _init_normal_tree, _qkv_heads, _run_layers,
                   _stack_gathers, first_chunk_loss)
from .gpt2 import _layer_norm
from .llama import _sp_active, sp_attention, sp_gather, sp_inputs

__all__ = ["ViTConfig", "init_params", "param_specs", "PARTITION_RULES", "apply",
           "classification_loss_fn"]

# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``vit.PARTITION_RULES``.
PARTITION_RULES: list = [
    (r"embeddings/patch_w", (None, "fsdp")),
    (r"embeddings/position", (None, "fsdp")),
    (r"layers/w_qkv", (None, "fsdp", "tp")),
    (r"layers/w_proj", (None, "tp", "fsdp")),
    (r"layers/w_up", (None, "fsdp", "tp")),
    (r"layers/w_down", (None, "tp", "fsdp")),
    (r"classifier/w", ("tp", None)),
]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Field for field the JAX ``ViTConfig``; ``dtype``/``param_dtype`` are
    torch dtypes."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_labels: int = 1000
    pool: str = "cls"  # "cls" | "mean"
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False
    sp_impl: str = "ring"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} must be divisible by patch_size {self.patch_size}"
            )
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {self.pool!r}")
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.pool == "cls" else 0)

    def num_params(self) -> int:
        def count(tree):
            return sum(count(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

        return count(_param_shapes(self))

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        defaults = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                        num_heads=4, num_labels=10)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def vit_base_16(cls, **kw) -> "ViTConfig":
        return cls(**kw)  # the defaults are ViT-B/16

    @classmethod
    def vit_large_16(cls, **kw) -> "ViTConfig":
        defaults = dict(hidden_size=1024, num_layers=24, num_heads=16)
        defaults.update(kw)
        return cls(**defaults)


def _param_shapes(c: ViTConfig) -> dict:
    d, L, m = c.hidden_size, c.num_layers, c.mlp_ratio
    emb = {
        "patch_w": (c.patch_size * c.patch_size * c.num_channels, d),
        "patch_b": (d,),
        "position": (c.seq_len, d),
    }
    if c.pool == "cls":
        emb["cls"] = (1, 1, d)
    return {
        "embeddings": emb,
        "layers": {
            "w_qkv": (L, d, 3 * d),
            "b_qkv": (L, 3 * d),
            "w_proj": (L, d, d),
            "b_proj": (L, d),
            "w_up": (L, d, m * d),
            "b_up": (L, m * d),
            "w_down": (L, m * d, d),
            "b_down": (L, d),
            "ln_attn_scale": (L, d),
            "ln_attn_bias": (L, d),
            "ln_mlp_scale": (L, d),
            "ln_mlp_bias": (L, d),
        },
        "final_ln": {"scale": (d,), "bias": (d,)},
        "classifier": {"w": (d, c.num_labels), "b": (c.num_labels,)},
    }


def param_specs(config: ViTConfig) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES` (all None where no rule matches)."""
    return specs_from_rules(_param_shapes(config), PARTITION_RULES)


def init_params(config: ViTConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule:
    LayerNorm scales one; biases, LayerNorm biases and the CLS token zero;
    position embeddings and weights normal(0, 0.02); on ``device`` (default
    ``cuda``); the numbers differ from ``jax.random``'s."""
    return _init_normal_tree(
        _param_shapes(config), config.param_dtype, resolve_device(device), seed, 0.02,
        ones=lambda n: n.endswith("_scale") or n == "scale",
        zeros=lambda n: (n.startswith("b_") or n.endswith("_bias")
                         or n in ("bias", "b", "patch_b", "cls")))


def _patchify(pixels: torch.Tensor, c: ViTConfig) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, N, p*p*C]``, rows in (patch row, patch
    column, channel) order."""
    b, hgt, wid, ch = pixels.shape
    p = c.patch_size
    x = pixels.reshape(b, hgt // p, p, wid // p, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hgt // p) * (wid // p), p * p * ch)


def _layer(x, p, c: ViTConfig, tp=None, sp_mesh=None):
    tp = tp or _NO_TP
    n = _layer_norm(x, p["ln_attn_scale"], p["ln_attn_bias"], c.layer_norm_eps)
    q, k, v = _qkv_heads(n, p, c, tp)
    if sp_mesh is not None:
        b, s = q.shape[:2]
        attn = sp_attention(q, k, v, c, causal=False, mesh=sp_mesh).reshape(b, s, -1)
    else:
        attn = _attend(q, k, v)
    x = x + tp_reduce(attn @ p["w_proj"].to(c.dtype), tp.attn) + p["b_proj"].to(c.dtype)
    n = tp_copy(_layer_norm(x, p["ln_mlp_scale"], p["ln_mlp_bias"], c.layer_norm_eps), tp.group)
    u = F.gelu(n @ p["w_up"].to(c.dtype) + tp.chunk(p["b_up"]).to(c.dtype), approximate="tanh")
    return x + tp_reduce(u @ p["w_down"].to(c.dtype), tp.group) + p["b_down"].to(c.dtype)


def apply(params: dict, pixels: torch.Tensor, config: ViTConfig, layout=None):
    """Channels-last pixels ``[B, H, W, C]`` -> (token features ``[B, S, d]``
    in the compute dtype, pooled ``[B, d]`` fp32).  ``layout``: the sharded
    path (BERT's layers; module docstring); under ``sp`` the token features
    are gathered over ``sp`` and ``pooled`` is the whole's mean."""
    x, pooled = _trunk(params, pixels, config, layout)
    return sp_gather(x, layout), pooled


def _trunk(params: dict, pixels: torch.Tensor, config: ViTConfig, layout=None):
    """:func:`apply` before the gather: under ``sp`` this process's chunk of
    the patches, and the mean over every process's."""
    c = config
    sp_mesh = _sp_active(layout)
    if sp_mesh is not None and c.pool == "cls":
        raise ValueError(
            "ViT with pool='cls' cannot run sequence-parallel: the CLS token "
            "makes the token count num_patches+1, indivisible by the sp axis. "
            "Use ViTConfig(pool='mean')."
        )
    e = {k: leaf(params, f"embeddings/{k}", layout, c.dtype) for k in params["embeddings"]}
    patches = _patchify(pixels.to(c.dtype), c)
    positions = e["position"].to(c.dtype)[None]
    patches, positions = sp_inputs(layout, patches.shape[1], patches, positions)
    x = patches @ e["patch_w"].to(c.dtype) + e["patch_b"].to(c.dtype)
    if c.pool == "cls":
        cls = e["cls"].to(c.dtype).expand(x.shape[0], 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + positions
    tp = TpView(layout, c.num_heads)
    x = _run_layers(x, params["layers"], c.remat, lambda x, p: _layer(x, p, c, tp, sp_mesh),
                    layout, "layers", c.dtype, _stack_gathers(tp))
    x = _layer_norm(x, leaf(params, "final_ln/scale", layout, c.dtype),
                    leaf(params, "final_ln/bias", layout, c.dtype), c.layer_norm_eps)
    xf = x.float()
    if c.pool == "cls":
        return x, xf[:, 0]
    if sp_mesh is None:
        return x, xf.mean(1)
    from ..parallel.collectives import data_sum

    # The whole's mean: every process's sum, added over sp both ways (each
    # process's tokens move the pooled features every process's loss reads).
    total = data_sum(xf.sum(1), layout.sp_group(), "sp")
    return x, total / (xf.shape[1] * layout.sp)


def classification_loss_fn(params: dict, batch: dict, config: ViTConfig,
                           layout=None) -> torch.Tensor:
    """Image-classification cross-entropy over ``batch["pixel_values"]``
    ``[B, H, W, C]`` and ``batch["labels"]`` ``[B]``; on a ``layout`` under
    ``tp`` the classifier row-parallel over the pooled features' chunks;
    under ``sp`` ``sp`` rank 0's loss (BERT's ``first_chunk_loss``)."""
    _, pooled = _trunk(params, batch["pixel_values"], config, layout)
    tp = TpView(layout, config.num_heads)
    loss = _classify(params, tp.chunk(pooled), batch["labels"], layout, tp)
    return first_chunk_loss(loss, layout)
