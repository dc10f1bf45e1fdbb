"""ResNet in PyTorch: the JAX package's ``accelerate_tpu/models/resnet.py``
with the same parameter tree, numerics and public contracts.

Layouts.  The tree holds the JAX layouts so conversion stays a checked
copy: conv kernels HWIO ``[kh, kw, cin, cout]``, per-channel BN vectors,
each stage's first block under ``head`` and its other blocks stacked
``[n-1, ...]`` under ``tail``.  Activations are channels-last ``[B, H, W,
C]`` tensors, as in the JAX package; each convolution hands ``F.conv2d``
(cuDNN on the card) the NCHW view of that memory and an OIHW view of the
kernel, so no activation is copied into another layout.  Convolutions are
library calls, as they are XLA ops in the JAX package: no kernel of this
module is hand-written.

Padding is explicit and symmetric, ``(k-1)//2`` (torch's ``padding=k//2``,
not XLA's SAME).  Batch norm is written out as the JAX package writes it,
in fp32: normalize with the biased batch variance, update the running
estimate with the unbiased one, ``running = m * running + (1 - m) *
batch`` with ``bn_momentum`` m (0.9: the reverse of torch's convention).
The running statistics live in an explicit ``batch_stats`` tree that
:func:`apply` returns updated; they are no parameters and carry no
gradient.

Over several processes the batch statistics are the global batch's, as
they are under GSPMD in the JAX package (its answer to SyncBatchNorm): each
process's per-channel sums, then its sums of squared deviations from the
global mean, are added over the data axes by
:func:`~..parallel.collectives.data_sum`, whose backward adds the
gradients too.  On a mesh with an active ``fsdp`` or ``tp`` axis the
forward and loss take a :class:`~..parallel.sharding.Layout` (``layout=``)
and each process holds its shard of each leaf by :data:`PARTITION_RULES`
(the JAX table): the convolutions' output channels on ``fsdp``, gathered
where each runs, and the classifier's classes on ``tp``, its logits
gathered over ``tp`` before the loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import data_sum, tp_copy, tp_gather
from ..parallel.sharding import TpView, leaf, spec_from_rules
from ..state import resolve_device
from .bert import _classify

__all__ = ["ResNetConfig", "init_params", "init_batch_stats", "apply", "classification_loss_fn",
           "PARTITION_RULES", "param_specs"]

# Mesh-axis layout of every parameter (path regex -> spec), the JAX
# ``resnet.PARTITION_RULES``: each convolution's output channels on
# ``fsdp``, the classifier's classes on ``tp``.
PARTITION_RULES: list = [
    (r"stem/conv", (None, None, None, "fsdp")),
    (r"/conv\d_w$", (None, None, None, "fsdp")),
    (r"/proj_w$", (None, None, None, "fsdp")),
    (r"classifier/w", (None, "tp")),
]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Field for field the JAX ``ResNetConfig``; ``dtype``/``param_dtype``
    are torch dtypes."""

    block: str = "bottleneck"  # "basic" (18/34) | "bottleneck" (50/101/152)
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64  # first-stage channel width
    num_channels: int = 3
    num_labels: int = 1000
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9  # running = m*running + (1-m)*batch
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    stem: str = "imagenet"  # 7x7/2 + maxpool | "cifar": 3x3/1, no pool
    remat: bool = False

    def __post_init__(self):
        if self.block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {self.block!r}")
        if self.stem not in ("imagenet", "cifar"):
            raise ValueError(f"stem must be 'imagenet' or 'cifar', got {self.stem!r}")

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1

    def stage_channels(self, stage: int) -> int:
        return self.width * (2**stage)

    def num_params(self) -> int:
        def count(tree):
            return sum(count(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

        return count(_param_shapes(self))

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        defaults = dict(block="basic", stage_sizes=(2, 2), width=8, num_labels=10, stem="cifar")
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def resnet18(cls, **kw) -> "ResNetConfig":
        return cls(**{"block": "basic", "stage_sizes": (2, 2, 2, 2), **kw})

    @classmethod
    def resnet34(cls, **kw) -> "ResNetConfig":
        return cls(**{"block": "basic", "stage_sizes": (3, 4, 6, 3), **kw})

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(**kw)  # the defaults are ResNet-50

    @classmethod
    def resnet101(cls, **kw) -> "ResNetConfig":
        return cls(**{"stage_sizes": (3, 4, 23, 3), **kw})

    @classmethod
    def resnet152(cls, **kw) -> "ResNetConfig":
        return cls(**{"stage_sizes": (3, 8, 36, 3), **kw})


def _block_shapes(c: ResNetConfig, cin: int, cout: int) -> dict:
    """One residual block from ``cin`` to ``cout * expansion`` channels (the
    caller adds the projection shortcut of a shape-changing block)."""
    if c.block == "basic":
        convs = [(3, cin, cout), (3, cout, cout)]
    else:
        convs = [(1, cin, cout), (3, cout, cout), (1, cout, cout * 4)]
    out = {}
    for j, (k, i, o) in enumerate(convs, start=1):
        out[f"conv{j}_w"] = (k, k, i, o)
        out[f"bn{j}_scale"] = (o,)
        out[f"bn{j}_bias"] = (o,)
    return out


def _param_shapes(c: ResNetConfig) -> dict:
    e = c.expansion
    stem_k = 7 if c.stem == "imagenet" else 3
    out: dict = {"stem": {"conv_w": (stem_k, stem_k, c.num_channels, c.width),
                          "bn_scale": (c.width,), "bn_bias": (c.width,)}}
    cin = c.width
    for s, n in enumerate(c.stage_sizes):
        cout = c.stage_channels(s)
        head = _block_shapes(c, cin, cout)
        # Projection shortcut only where the residual shapes change
        # (torchvision: a basic-block stage 0 keeps the identity).
        if s > 0 or cin != cout * e:
            head["proj_w"] = (1, 1, cin, cout * e)
            head["proj_bn_scale"] = (cout * e,)
            head["proj_bn_bias"] = (cout * e,)
        stage: dict = {"head": head}
        if n > 1:
            stage["tail"] = {k: (n - 1, *v) for k, v in _block_shapes(c, cout * e, cout).items()}
        out[f"stage{s}"] = stage
        cin = cout * e
    out["classifier"] = {"w": (cin, c.num_labels), "b": (c.num_labels,)}
    return out


def _stats_shapes(c: ResNetConfig) -> dict:
    """A ``{site}_mean`` / ``{site}_var`` pair per BN site, mirroring the
    parameter tree."""

    def per_site(shapes: dict) -> dict:
        out = {}
        for k, v in shapes.items():
            if k.endswith("_scale"):
                out[f"{k[:-6]}_mean"] = v
                out[f"{k[:-6]}_var"] = v
        return out

    params = _param_shapes(c)
    out: dict = {"stem": per_site(params["stem"])}
    for s in range(len(c.stage_sizes)):
        out[f"stage{s}"] = {k: per_site(v) for k, v in params[f"stage{s}"].items()}
    return out


def param_specs(config: ResNetConfig) -> dict:
    """The spec tree of :func:`init_params`' structure under
    :data:`PARTITION_RULES`, as the JAX ``param_specs`` builds it: a stacked
    ``tail`` leaf matches the rules at its block's rank, behind a
    replicated leading dim."""
    from ..parallel.sharding import _tree_map

    def one(path, shape):
        ndim = len(shape)
        if "tail" in path.split("/"):
            spec = spec_from_rules(path, ndim - 1, PARTITION_RULES)
            return (None,) + spec if spec is not None else (None,) * ndim
        spec = spec_from_rules(path, ndim, PARTITION_RULES)
        return spec if spec is not None else (None,) * ndim

    return _tree_map(one, _param_shapes(config))


def init_params(config: ResNetConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rule: each
    residual branch's last BN scale zero (every block starts as the
    identity), the other BN scales one, biases zero, conv kernels and the
    classifier He-normal (std sqrt(2 / fan_in), fan_in = kh*kw*cin), on
    ``device`` (default ``cuda``); the numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config
    last_bn = "bn3" if c.block == "bottleneck" else "bn2"

    def one(top, name, shape):
        if name.endswith("_scale"):
            zero = name.startswith(last_bn) and top.startswith("stage")
            return (torch.zeros if zero else torch.ones)(shape, dtype=c.param_dtype, device=dev)
        if name.endswith("_bias") or name == "b":
            return torch.zeros(shape, dtype=c.param_dtype, device=dev)
        fan_in = math.prod(shape[-4:-1]) if len(shape) >= 4 else shape[-2]
        draw = torch.empty(shape, dtype=torch.float32, device=dev)
        return draw.normal_(0.0, math.sqrt(2.0 / max(fan_in, 1)), generator=gen).to(c.param_dtype)

    def walk(top, tree):
        return {k: walk(top, v) if isinstance(v, dict) else one(top, k, v)
                for k, v in tree.items()}

    return {k: walk(k, v) for k, v in _param_shapes(c).items()}


def init_batch_stats(config: ResNetConfig, device=None) -> dict:
    """Running means zero and variances one, fp32, on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (torch.ones if k.endswith("_var") else torch.zeros)(v, device=dev)
                for k, v in tree.items()}

    return walk(_stats_shapes(config))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, c: ResNetConfig) -> torch.Tensor:
    """NHWC ``x`` through the HWIO kernel ``w``, explicit symmetric padding
    ``(k-1)//2``: ``F.conv2d`` on the NCHW view, back to NHWC."""
    pad = (w.shape[0] - 1) // 2
    xc = x.permute(0, 3, 1, 2)
    if xc.device.type == "cpu":
        # The CPU's conv2d backward computes a wrong, run-to-run varying
        # gradient for a channels-last input to a strided 1x1 kernel (torch
        # 2.13, and it corrupts the heap): there the NCHW copy goes in.
        xc = xc.contiguous()
    y = F.conv2d(xc, w.to(c.dtype).permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _batch_norm(x, scale, bias, mean, var, new_stats: dict, site: str, c: ResNetConfig,
                train: bool, data=(None, None, 1)):
    """Normalize over (N, H, W) in fp32 and write ``new_stats[site_mean /
    site_var]``: the momentum update of the running statistics when
    ``train``, the given ones otherwise.  ``data`` is ``(group, axes,
    shards)`` of the data axes: with a group the statistics are the global
    batch's (module docstring)."""
    if train:
        xf = x.float()
        group, axes, shards = data
        n = x.shape[0] * x.shape[1] * x.shape[2]
        if group is None:
            bmean = xf.mean((0, 1, 2))
            bvar = (xf - bmean).square().mean((0, 1, 2))
        else:
            n = n * shards
            bmean = data_sum(xf.sum((0, 1, 2)), group, axes) / n
            bvar = data_sum((xf - bmean).square().sum((0, 1, 2)), group, axes) / n
        m = c.bn_momentum
        with torch.no_grad():
            unbiased = bvar * (n / max(n - 1, 1))
            new_stats[f"{site}_mean"] = m * mean + (1.0 - m) * bmean
            new_stats[f"{site}_var"] = m * var + (1.0 - m) * unbiased
        use_mean, use_var = bmean, bvar
    else:
        new_stats[f"{site}_mean"], new_stats[f"{site}_var"] = mean, var
        use_mean, use_var = mean, var
    inv = torch.rsqrt(use_var + c.bn_eps) * scale.float()
    return ((x.float() - use_mean) * inv + bias.float()).to(c.dtype)


def _block(x, p, stats, c: ResNetConfig, stride: int, train: bool, data=(None, None, 1)):
    """One residual block -> (out, the block's new stats)."""
    ns: dict = {}

    def bn(h, site, relu):
        h = _batch_norm(h, p[f"{site}_scale"], p[f"{site}_bias"], stats[f"{site}_mean"],
                        stats[f"{site}_var"], ns, site, c, train, data)
        return F.relu(h) if relu else h

    if c.block == "basic":
        h = bn(_conv(x, p["conv1_w"], stride, c), "bn1", True)
        h = bn(_conv(h, p["conv2_w"], 1, c), "bn2", False)
    else:
        h = bn(_conv(x, p["conv1_w"], 1, c), "bn1", True)
        h = bn(_conv(h, p["conv2_w"], stride, c), "bn2", True)
        h = bn(_conv(h, p["conv3_w"], 1, c), "bn3", False)
    shortcut = x
    if "proj_w" in p:
        shortcut = bn(_conv(x, p["proj_w"], stride, c), "proj_bn", False)
    return F.relu(h + shortcut), ns


def _data_group(layout):
    """``(group, axes, shards)`` of the data axes of ``layout``'s mesh (the
    live state's without one): the processes whose rows make up the
    global batch; ``(None, None, 1)`` with one such shard."""
    from ..parallel.mesh import data_axes
    from ..parallel.sharding import _live_mesh

    mesh = layout.mesh if layout is not None else _live_mesh()
    axes = data_axes(mesh) if mesh is not None else ()
    if not axes or mesh.device_mesh is None:
        return None, None, 1
    return mesh.group(axes), axes, mesh.span(axes)


def apply(params: dict, batch_stats: dict, pixels: torch.Tensor, config: ResNetConfig,
          train: bool = False, layout=None):
    """Channels-last pixels ``[B, H, W, C]`` -> (pooled features ``[B,
    C_out]`` fp32, new batch stats).  In eval (``train=False``) the returned
    stats are the given ones.  Over several data shards the training
    statistics are the global batch's; ``layout``: the sharded path (module
    docstring)."""
    c = config
    data = _data_group(layout) if train else (None, None, 1)

    def gathered(path, tree):
        if layout is None:
            return tree
        return {k: gathered(f"{path}/{k}", v) if isinstance(v, dict) else
                leaf(params, f"{path}/{k}", layout) for k, v in tree.items()}

    new_stats: dict = {"stem": {}}
    s = gathered("stem", params["stem"])
    x = _conv(pixels.to(c.dtype), s["conv_w"], 2 if c.stem == "imagenet" else 1, c)
    st = batch_stats["stem"]
    x = F.relu(_batch_norm(x, s["bn_scale"], s["bn_bias"], st["bn_mean"], st["bn_var"],
                           new_stats["stem"], "bn", c, train, data))
    if c.stem == "imagenet":
        # torch MaxPool2d(3, stride=2, padding=1): symmetric -inf padding.
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)

    def run(fn, x, *args):
        if c.remat and torch.is_grad_enabled():
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)

    for si, n in enumerate(c.stage_sizes):
        sp, ss = params[f"stage{si}"], batch_stats[f"stage{si}"]
        stride = 1 if si == 0 else 2

        # The stride is bound now: the backward's recompute runs after the
        # loop.  Each block gathers its leaves where it runs.
        def head_fn(x, p, st, stride=stride, si=si):
            return _block(x, gathered(f"stage{si}/head", p), st, c, stride, train, data)

        x, head = run(head_fn, x, sp["head"], ss["head"])
        sns = {"head": head}
        if n > 1:
            tails = []
            for i in range(n - 1):
                p = {k: v[i] for k, v in sp["tail"].items()}
                st = {k: v[i] for k, v in ss["tail"].items()}

                def tail_fn(x, p, st, si=si):
                    return _block(x, _tail_leaves(p, f"stage{si}/tail", layout), st, c, 1,
                                  train, data)

                x, ns = run(tail_fn, x, p, st)
                tails.append(ns)
            sns["tail"] = {k: torch.stack([t[k] for t in tails]) for k in tails[0]}
        new_stats[f"stage{si}"] = sns
    return x.float().mean((1, 2)), new_stats


def _tail_leaves(p: dict, path: str, layout):
    """One tail block's leaves (each a slice of its stacked leaf), gathered
    by the stacked leaf's spec without its leading dim."""
    if layout is None:
        return p
    return {k: layout.full(v, layout.spec(f"{path}/{k}")[1:]) for k, v in p.items()}


def classification_loss_fn(params: dict, batch_stats: dict, batch: dict, config: ResNetConfig,
                           train: bool = True, layout=None):
    """Cross-entropy over ``batch["pixel_values"]`` ``[B, H, W, C]`` and
    ``batch["labels"]`` ``[B]`` -> ``(loss, new_batch_stats)``; thread the
    stats like optimizer state.  On a ``layout`` under ``tp`` each process
    computes its classes' logits, gathered over ``tp`` before the loss."""
    pooled, new_stats = apply(params, batch_stats, batch["pixel_values"], config, train=train,
                              layout=layout)
    if layout is None or layout.tp == 1:
        return _classify(params, pooled, batch["labels"], layout), new_stats
    tp = TpView(layout)
    w = leaf(params, "classifier/w", layout).float()
    part = tp_copy(pooled, tp.group) @ w + tp.chunk(leaf(params, "classifier/b", layout))
    logits = tp_gather(part, part.dim() - 1, tp.group, partial=False)
    loss = -torch.log_softmax(logits, -1).gather(-1, batch["labels"].long()[:, None]).mean()
    return loss, new_stats
