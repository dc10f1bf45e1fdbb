"""Optimizer wrapper with the JAX package's update semantics.

:class:`AcceleratedOptimizer` wraps a ``torch.optim.Optimizer`` so a
training loop keeps its ``optimizer.step()`` / ``zero_grad()`` shape:
both are no-ops while gradients are accumulating (``sync_gradients`` is
False), and a real step runs :func:`_update_body`, the update of the JAX
``optimizer._update_body``:

- the pre-clip global norm is the health verdict, ANDed with the loss being
  finite when the caller knows it (the fused step does); a failed verdict
  leaves the parameters and the optimizer's state untouched, its step count
  included;
- the value clip (elementwise) comes first, then the norm clip with scale
  ``min(1, clip_norm / max(gnorm, 1e-12))`` on the post-value-clip norm
  (not ``torch.nn.utils.clip_grad_norm_``'s ``norm + 1e-6``);
- a negative clip disables it; 0 is a real clip.

Under the NaN fault (``ACCELERATE_TPU_FAULT_NAN_STEP``,
:mod:`.resilience.faultinject`) the gradients of the armed update are
multiplied by a device scalar (NaN on an armed step, else 1) before the
gate: one ``_foreach_mul``, no host sync.  Unarmed, nothing is added.

With several processes a real step first averages the gradients over the
data-parallel group, one all-reduce per gradient tensor (the JAX package
gets them reduced from its sharded program; per tensor rather than one flat
bucket, so no second copy of the gradients is held on the card at large
widths, and the sharded step below scatters per tensor too).  ``no_sync``
and ``accumulate`` hold back the step, and so the sync, by construction;
inside :class:`~.local_sgd.LocalSGD` the gradients stay local.  On a mesh
with an active dp axis both norms take the canonical dp-chunked association
(:func:`~.parallel.zero.chunked_global_norm`, the JAX ``norm_ndp``), in the
replicated and the sharded step alike.  Once ``make_train_step(zero=True)``
shards the update (:meth:`AcceleratedOptimizer._enable_zero`), the torch
optimizer holds one shard per parameter: each step reduce-scatters the
gradients, updates the shards and all-gathers the parameters, and
``state_dict`` gathers the state to full shapes.  torch's ``AdamW`` is optax's ``adamw`` when both
use ``betas=(0.9, 0.999)``, ``eps=1e-8`` and the same ``weight_decay``
(torch defaults to 1e-2, optax to 1e-4).

On a mesh with model axes (:mod:`.parallel.sharding`) the parameters are
this process's shards: a leaf sharded on ``fsdp`` arrives with its
gradient summed over ``fsdp`` already (its gather's backward
reduce-scattered it), so only the other data axes reduce it before the
division by the data degree; nothing is reduced over ``tp`` or ``ep``,
which are no data axes.  The norms
then count each distinct shard once (:func:`sharded_global_norm`), the
optimizer updates the shards, and ``state_dict`` gathers the state to full
shapes.  ``Accelerator.clip_grad_norm_`` averages the gradients early (in
place on a sync step) to return the norm the update will clip.

With telemetry on, a real ``step()`` runs under the ``optimizer.step`` span,
counts one dispatch and records one completed step (step time, MFU, device
memory gauges): host-side bookkeeping only, no further device sync than the
update's own verdict read.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .state import GradientState
from .telemetry import get_telemetry as _get_telemetry
from .telemetry import span as _span

__all__ = ["AcceleratedOptimizer", "global_norm", "sharded_global_norm"]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``: one sum per tensor, then the sum over tensors)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def _shaped_like(v, p: torch.Tensor) -> bool:
    """Whether ``v`` is a state tensor shaped like the shard ``p`` (not a
    scalar such as Adam's ``step``)."""
    return isinstance(v, torch.Tensor) and v.dim() > 0 and tuple(v.shape) == tuple(p.shape)


def sharded_global_norm(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                        mesh) -> torch.Tensor:
    """The global 2-norm of gradients whose leaves may be shards: the sums
    of squares of the leaves split over one set of axes are added, then
    all-reduced over those axes (each distinct shard counted once), in a
    fixed order of the sets; a leaf replicated on every axis counts once,
    from this process's copy."""
    from .parallel import collectives
    from .parallel.sharding import spec_axes, spec_of

    parts: dict = {}
    for p, g in zip(params, grads):
        axes = tuple(a for a in spec_axes(spec_of(p)) if mesh.shape[a] > 1)
        sq = g.float().square().sum()
        parts[axes] = sq if axes not in parts else parts[axes] + sq
    total = None
    for axes in sorted(parts, key=lambda t: (len(t), t)):
        v = parts[axes]
        if axes:
            v = collectives.all_reduce(v.clone(), group=mesh.group(axes), axis=axes)
        total = v if total is None else total + v
    return torch.sqrt(total)


def _update_body(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                 grads: List[torch.Tensor], clip_norm: float, clip_value: float,
                 health_ok: Optional[torch.Tensor] = None,
                 norm_fn: Optional[Callable] = None):
    """Health gate, value clip, norm clip, then ``optimizer.step()`` on
    ``params`` with ``grads`` as their ``.grad``.  Returns ``(gnorm,
    health_norm, ok)``: the post-value-clip norm the clip used, the pre-clip
    norm (NaN when ``health_ok`` is False) and the verdict, all device
    scalars.  Reading the verdict to skip the update is one host sync.
    ``norm_fn(grads)`` replaces :func:`global_norm` (the dp-chunked norm).
    The clips write into the contiguous ``grads`` in place, on a skipped
    step too (no second copy of the gradients on the card); an expanded
    gradient, as autograd gives for a broadcast parameter, is copied."""
    norm_fn = norm_fn or global_norm
    gnorm = norm_fn(grads)
    ok = torch.isfinite(gnorm)
    health_norm = gnorm
    if health_ok is not None:
        ok = ok & health_ok
        health_norm = torch.where(health_ok, gnorm, torch.nan)
    if clip_value >= 0:
        grads = [g.clamp_(-clip_value, clip_value) if g.is_contiguous() else
                 g.clamp(-clip_value, clip_value) for g in grads]
        gnorm = norm_fn(grads)
    if clip_norm >= 0:
        limit = torch.tensor(clip_norm, dtype=torch.float32, device=gnorm.device)
        scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [g.mul_(scale) if g.is_contiguous() else g * scale for g in grads]
    if bool(ok):
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
    return gnorm, health_norm, ok


class AcceleratedOptimizer:
    """A prepared ``torch.optim.Optimizer`` paired with its model.

    ``step()`` is a no-op while accumulating and runs :func:`_update_body`
    on every parameter holding a gradient otherwise; ``zero_grad()`` clears
    gradients only on a sync step.  The one-shot clips armed by
    ``Accelerator.clip_grad_norm_``/``clip_grad_value_`` apply to the next
    real update only."""

    def __init__(self, optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                 gradient_state: GradientState, mesh=None,
                 sync_dtype: Optional[torch.dtype] = None):
        self.optimizer = optimizer
        self.model = model
        self.gradient_state = gradient_state
        self.mesh = mesh
        self.sync_dtype = sync_dtype
        self._zero = None
        self._full_params: Optional[List[torch.Tensor]] = None
        # Checkpoint-manifest record of the state's layout (make_train_step
        # sets it, as the JAX fused step does).
        self._opt_state_layout = {"kind": "replicated", "axes": [], "degree": 1}
        self._clip_norm_once: Optional[float] = None
        self._clip_value_once: Optional[float] = None
        # A clip every update takes (a DeepSpeed or Megatron config's
        # gradient_clipping); -1 is off.
        self._clip_norm = -1.0
        self._grads_synced = False
        self._step_count = 0
        self._step_was_skipped = False
        self._last_grad_norm = None
        self._last_health_norm = None
        self._poison_scalars = None

    @property
    def params(self) -> List[torch.Tensor]:
        """The model parameters the optimizer updates (full ones, also when
        its groups hold ZeRO shards)."""
        if self._full_params is not None:
            return list(self._full_params)
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    # -- data parallelism ------------------------------------------------------

    @property
    def dp_degree(self) -> int:
        """Processes the gradients are averaged over: the product of the
        mesh's active data axes, ``fsdp`` included (1: none)."""
        from .parallel.mesh import data_degree

        return data_degree(self.mesh)

    def _dp_group(self):
        from .parallel.mesh import data_axes

        return self.mesh.group(data_axes(self.mesh))

    def _splits_sequence(self) -> bool:
        """Whether the model's forward runs on this process's chunk of the
        sequence (its layout's ``sp`` is above 1: the model declared
        ``splits_sequence`` and the mesh's ``sp`` axis is active): each
        replicated leaf's gradient is then its chunk's part of the
        whole."""
        model = getattr(self.model, "module", self.model)
        layout = getattr(model, "_layout", None)
        return layout is not None and layout.sp > 1

    def _sync_axes(self) -> tuple:
        """The axes the gradients are reduced over: the data axes (averaged;
        none under LocalSGD), then ``sp`` where the forward split the
        sequence (summed)."""
        from .parallel.mesh import data_axes

        if self.mesh is None:
            return ()
        axes = () if self.gradient_state.local_sgd else data_axes(self.mesh)
        return axes + (("sp",) if self._splits_sequence() else ())

    def _needs_sync(self) -> bool:
        return self.mesh is not None and self.mesh.span(self._sync_axes()) > 1

    def _sync_grads(self, params: List[torch.Tensor],
                    grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every gradient averaged over the data axes, in place: one
        all-reduce (sum) per tensor, in bf16 under a bf16 ``comm_hook``,
        then divided by the data degree.  A leaf sharded on ``fsdp`` already
        holds the sum over ``fsdp`` (its gather's backward reduce-scattered
        it), so only the other data axes reduce it; no leaf is reduced over
        ``tp`` or ``ep``, whose ranks hold either their own shard's gradient or the
        same full one.  Where the forward split the sequence over ``sp``,
        the same all-reduce also sums over ``sp`` (each process holds its
        chunk's part), before the division by the data degree."""
        from .parallel import collectives
        from .parallel.mesh import model_axes
        from .parallel.sharding import spec_axes, spec_of

        mesh = self.mesh
        axes = self._sync_axes()
        n = self.dp_degree if not self.gradient_state.local_sgd else 1
        named = bool(model_axes(mesh)) or "sp" in axes
        out = []
        for p, g in zip(params, grads):
            sharded_on = spec_axes(spec_of(p))
            red = tuple(a for a in axes if a not in sharded_on)
            work = g.contiguous() if self.sync_dtype is None else g.to(self.sync_dtype)
            if mesh.span(red) > 1:
                collectives.all_reduce(work, group=mesh.group(red), axis=red if named else None)
            out.append(work.div_(n).to(g.dtype))
        return out

    def _norm_fn(self, params: Sequence[torch.Tensor]) -> Optional[Callable]:
        """The global norm of the averaged gradients, the one the gate and
        the clip read: with a sharded leaf, the sum of squares of each
        distinct shard (:func:`sharded_global_norm`); on a replicated data-
        parallel mesh the canonical dp-chunked association; else None
        (:func:`global_norm`)."""
        from .parallel.sharding import is_sharded, spec_of

        if self.mesh is not None and any(is_sharded(spec_of(p)) for p in params):
            mesh = self.mesh
            return lambda gs: sharded_global_norm(gs, params, mesh)  # noqa: E731
        degree = self.dp_degree
        if degree > 1 and not self.gradient_state.local_sgd:
            from .parallel.zero import chunked_global_norm

            return lambda gs: chunked_global_norm(gs, degree)  # noqa: E731
        return None

    def _grad_norm_now(self) -> Optional[torch.Tensor]:
        """The global norm of the gradients the next update will take: on a
        sync step they are averaged over the data axes here, in place (the
        update then does not sync them again); while accumulating, copies
        are.  None without gradients."""
        params = [p for p in self.params if p.grad is not None]
        if not params:
            return None
        grads = [p.grad for p in params]
        if self._needs_sync() and not self._grads_synced:
            if self.gradient_state.sync_gradients:
                grads = self._sync_grads(params, grads)
                for p, g in zip(params, grads):
                    p.grad = g
                self._grads_synced = True
            else:
                grads = self._sync_grads(params, [g.clone() for g in grads])
        return (self._norm_fn(params) or global_norm)(grads)

    def _enable_zero(self, mesh=None) -> None:
        """Shard the update over the dp group (:class:`~.parallel.zero.ZeroShards`):
        the torch optimizer's groups take each parameter's shard in its
        place, and its state (if any) is cut to this process's shards."""
        from .parallel.zero import ZeroShards

        if self._zero is not None:
            return
        if mesh is not None:
            self.mesh = mesh
        full = self.params
        zs = ZeroShards(full, self.dp_degree, self._dp_group(), sync_dtype=self.sync_dtype)
        state = self.optimizer.state
        for p in full:
            if p in state:
                st = state.pop(p)
                state[zs.shard_of(p)] = {k: zs.slice_like(p, v) if zs.is_full_state(p, v) else v
                                         for k, v in st.items()}
        for group in self.optimizer.param_groups:
            group["params"] = [zs.shard_of(p) for p in group["params"]]
        self._full_params = full
        self._zero = zs

    @property
    def step_was_skipped(self) -> bool:
        return self._step_was_skipped

    @property
    def param_groups(self) -> list:
        return self.optimizer.param_groups

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        """Write ``lr`` into every parameter group, only when the groups
        share one LR: distinct group LRs are a per-group schedule that its
        torch scheduler advances itself."""
        groups = self.optimizer.param_groups
        if len({float(g["lr"]) for g in groups}) <= 1:
            for group in groups:
                group["lr"] = lr

    def state_dict(self) -> dict:
        """The torch optimizer's own ``state_dict()`` (live tensors, not
        copies) and the count of updates taken.  Under ZeRO, and for the
        shards of a sharded model (the FSDP ``FULL_STATE_DICT``), the state
        is gathered to full shapes (new tensors; a collective, so every
        process calls it), the layout of the replicated optimizer's."""
        sd = self.optimizer.state_dict()
        zs = self._zero
        if zs is not None:
            order = [p for group in self.optimizer.param_groups for p in group["params"]]
            by_shard = {id(zs.shard_of(p)): p for p in zs.params}
            full = {}
            for idx, st in sd["state"].items():
                p = by_shard[id(order[idx])]
                full[idx] = {k: zs.gather_like(p, v) if zs.is_sharded_state(p, v) else v
                             for k, v in st.items()}
            sd = {**sd, "state": full}
        elif self._sharded_params():
            from .parallel.sharding import gather_full, spec_of

            order = self.params
            full = {}
            for idx, st in sd["state"].items():
                p = order[idx]
                full[idx] = {k: gather_full(v, spec_of(p), self.mesh)
                             if _shaped_like(v, p) else v for k, v in st.items()}
            sd = {**sd, "state": full}
        return {"optimizer": sd, "step_count": self._step_count}

    def _sharded_params(self) -> bool:
        from .parallel.sharding import is_sharded, spec_of

        return self.mesh is not None and any(is_sharded(spec_of(p)) for p in self.params)

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`'s output; torch moves each state
        tensor to its parameter's device.  Under ZeRO each process keeps
        its shards of the full-shape state."""
        sd = state_dict["optimizer"]
        zs = self._zero
        if zs is not None:
            order = [p for group in self.optimizer.param_groups for p in group["params"]]
            by_shard = {id(zs.shard_of(p)): p for p in zs.params}
            cut = {}
            for idx, st in sd["state"].items():
                p = by_shard[id(order[int(idx)])]
                cut[idx] = {k: zs.slice_like(p, v) if zs.is_full_state(p, v) else v
                            for k, v in st.items()}
            sd = {**sd, "state": cut}
        elif self._sharded_params():
            from .parallel.sharding import local_slice, spec_of

            order = self.params
            cut = {}
            for idx, st in sd["state"].items():
                p = order[int(idx)]
                full_shape = getattr(p, "_full_shape", None)
                cut[idx] = {k: local_slice(v, spec_of(p), self.mesh).contiguous()
                            if isinstance(v, torch.Tensor) and full_shape is not None
                            and tuple(v.shape) == full_shape else v for k, v in st.items()}
            sd = {**sd, "state": cut}
        self.optimizer.load_state_dict(sd)
        self._step_count = int(state_dict.get("step_count", 0))

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.gradient_state.sync_gradients:
            self._grads_synced = False
            self.optimizer.zero_grad(set_to_none=set_to_none)
            for p in self._full_params or ():
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.zero_()

    def _resolve_clips(self, clip_norm: Optional[float] = None,
                       clip_value: Optional[float] = None):
        """One-shot clips first (consumed here), then the caller's; -1 (off)
        without either."""
        norm = self._clip_norm_once if self._clip_norm_once is not None else (
            clip_norm if clip_norm is not None else self._clip_norm)
        value = self._clip_value_once if self._clip_value_once is not None else (
            clip_value if clip_value is not None else -1.0)
        self._clip_norm_once = self._clip_value_once = None
        return norm, value

    def _poison_scale(self) -> torch.Tensor:
        """The NaN fault's device scalar for the coming update: NaN when
        :func:`~.resilience.faultinject.grad_poison_scale` fires for it,
        else 1.  Both scalars are made once, so a step picks one and copies
        nothing to the device."""
        from .resilience import faultinject

        if self._poison_scalars is None:
            dev = self.params[0].device
            self._poison_scalars = (torch.ones((), device=dev),
                                    torch.full((), float("nan"), device=dev))
        fires = faultinject.grad_poison_scale(self._step_count + 1) is not None
        return self._poison_scalars[int(fires)]

    def _apply_update(self, params, grads, health_ok=None, clip_norm=None, clip_value=None,
                      poison: Optional[torch.Tensor] = None):
        if poison is not None:
            grads = torch._foreach_mul(grads, poison)
        norm, value = self._resolve_clips(clip_norm, clip_value)
        targets = params
        zs = self._zero
        synced, self._grads_synced = self._grads_synced, False
        if zs is not None:
            if synced:  # averaged already (clip_grad_norm_): each process takes its chunks
                targets = [zs.shard_of(p) for p in params]
                grads = [g if zs.dim_of(p) is None else zs.slice_like(p, g)
                         for p, g in zip(params, grads)]
            else:
                targets, grads = zs.scatter(params, grads)
            norm_fn = lambda gs: zs.global_norm(gs, params)  # noqa: E731
        else:
            if not synced and self._needs_sync():
                grads = self._sync_grads(params, grads)
            norm_fn = self._norm_fn(params)
        gnorm, health_norm, ok = _update_body(self.optimizer, targets, grads, norm, value,
                                              health_ok=health_ok, norm_fn=norm_fn)
        if zs is not None:
            for t in targets:
                t.grad = None
            if bool(ok):  # the verdict is global: every process gathers or none
                zs.gather(params)
        self._last_grad_norm = gnorm
        self._last_health_norm = health_norm
        self._step_was_skipped = False
        self._step_count += 1
        return gnorm, health_norm

    def step(self, closure: Optional[Callable] = None):
        """One update on a sync step.  A ``closure`` (which recomputes the
        loss and its gradients) runs first, under ``torch.enable_grad()``,
        and its loss is returned: torch's ``Optimizer.step(closure)``
        contract, which the JAX ``AcceleratedOptimizer.step`` accepts and
        ignores (optax has no closure).  The port follows torch because a
        torch loop that passes a closure relies on the gradients it computes.
        While gradients accumulate the closure does not run, as the step
        does not."""
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = True
            return None
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for p in self.params if p.grad is not None]
        if not params:
            self._step_was_skipped = True
            return loss
        from .resilience import faultinject

        with _span("optimizer.step"):
            _get_telemetry().count_dispatch()  # the update
            poison = self._poison_scale() if faultinject.nan_armed() else None
            self._apply_update(params, [p.grad for p in params], poison=poison)
        # A completed step is the telemetry heartbeat: step-time histogram,
        # tokens/sec + MFU gauges, device memory gauges, watchdog beat.
        _get_telemetry().record_step()
        return loss
