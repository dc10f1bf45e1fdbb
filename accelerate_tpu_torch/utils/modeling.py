"""Model wrappers of the port: :class:`PreparedModel`, what
``Accelerator.prepare`` returns for a model under a 16-bit
``mixed_precision`` (the JAX package keeps its ``PreparedModel`` in
``accelerate_tpu/accelerator.py``).  It sits here, below the accelerator,
so that :func:`~accelerate_tpu_torch.utils.other.extract_model_from_parallel`
can unwrap it without importing the accelerator."""

from __future__ import annotations

import torch
from torch import nn

from .operations import convert_to_fp32, recursively_apply

__all__ = ["PreparedModel"]


class PreparedModel(nn.Module):
    """What ``prepare`` returns for a model under a 16-bit policy (the JAX
    ``PreparedModel``'s ``_cast`` and ``_forward``): the forward runs
    ``module`` through ``torch.func.functional_call`` with a
    ``policy.compute_dtype`` copy of every floating parameter and buffer,
    and casts floating outputs to fp32.  Floating tensor inputs are cast
    too: torch multiplies no fp32 tensor by a bf16 one, where ``jnp``
    promotes the product to fp32.  The copies are differentiable
    ``.to()`` casts, so gradients land in the fp32 parameters the optimizer
    holds; the ``Parameter`` objects stay the module's own (so ``prepare``
    pairs an optimizer with the model by identity), and ``state_dict`` /
    ``load_state_dict`` are the module's, fp32 under its names.  A buffer
    the forward updates in place (batch-norm statistics) is copied back.
    Other attributes read through to ``module``;
    :meth:`Accelerator.unwrap_model` returns it.

    The copies are made once, before the module's forward, which the
    wrapper cannot see into, so a model that passes its weights into a
    checkpointed region as inputs would keep their 16-bit copies alive
    until the backward has recomputed that region.  Such a model casts
    at use instead: a module with a ``_forward_cast_at_use(compute_dtype,
    *args, **kwargs)`` method (``LlamaForCausalLM``) is called through it
    with its fp32 parameters, and casts each weight to ``compute_dtype``
    where it uses it, to the same values; every other module gets the
    copies made here.

    A module ``prepare`` sharded whose forward does not realize the layout
    itself carries it as ``_gather_layout``: each of its leaves is then
    gathered whole over ``fsdp`` (cast to ``compute_dtype`` first) before
    ``functional_call``, and the backward reduce-scatters the gradients
    (:meth:`~..parallel.sharding.Layout.full`); a leaf split over another
    axis raises."""

    def __init__(self, module: nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.module = module
        self.compute_dtype = compute_dtype

    def forward(self, *args, **kwargs):
        module, dt = self.module, self.compute_dtype
        layout = getattr(module, "_gather_layout", None)
        cast_at_use = getattr(module, "_forward_cast_at_use", None)
        if cast_at_use is not None and layout is None:
            args, kwargs = recursively_apply(
                lambda t: t.to(dt) if t.is_floating_point() else t, (args, kwargs))
            return convert_to_fp32(cast_at_use(dt, *args, **kwargs))
        if layout is not None:
            from ..parallel.sharding import spec_of

            casted = {n: layout.full(p, spec_of(p), dt if p.is_floating_point() else None,
                                     keep=())
                      for n, p in module.named_parameters()}
        else:
            casted = {n: p.to(dt) if p.is_floating_point() else p
                      for n, p in module.named_parameters()}
        buffers = {n: (b, b.to(dt)) for n, b in module.named_buffers() if b.is_floating_point()}
        casted.update({n: c for n, (_, c) in buffers.items()})
        args, kwargs = recursively_apply(
            lambda t: t.to(dt) if t.is_floating_point() else t, (args, kwargs))
        out = torch.func.functional_call(module, casted, args, kwargs)
        with torch.no_grad():  # kernels that update a buffer do not all bump its version
            for b, c in buffers.values():
                if c is not b and not torch.equal(c, b.to(dt)):
                    b.copy_(c)
        return convert_to_fp32(out)

    def state_dict(self, *args, **kwargs):
        return self.module.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return self.module.load_state_dict(state_dict, strict=strict, assign=assign)

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["module"], name)
