"""Mixture-of-Experts routing and expert FFN: the JAX package's
``accelerate_tpu/ops/moe.py`` with the same numerics.

- **Dense dispatch** (Switch-Transformer style): routing is two einsums
  against a ``[B, S, E, C]`` dispatch/combine tensor.  Each expert takes at
  most ``C = ceil(S * k * cf / E)`` tokens of a batch row; the overflow is
  dropped (it contributes zero and the residual carries it).
- **Ragged** (:func:`moe_ffn_ragged`): the tokens sorted by expert and each
  expert's contiguous rows through its own matmuls, ``S * k`` rows in all
  and no token dropped; the JAX ``lax.ragged_dot``.

The router runs in fp32, the experts in ``compute_dtype``.  These are
``torch`` ops, as the JAX ones are XLA ops: no kernel of this module is
hand-written.

Expert parallelism (``group``): the JAX module constrains the dispatched
activations' expert dim to ``ep`` and lets GSPMD place the collectives.
Here every process of ``group`` (the active ``ep`` and ``tp`` axes) holds
the same tokens, since neither is a data axis, and computes the same
routing and dispatch/combine tensors; it runs the slots of its own
experts (from ``first_expert``, as many as its ``w_gate`` holds) over its
columns of the FFN width, and the partial outputs are summed over the
group (:func:`~..parallel.collectives.tp_reduce`).  Each process's
backward reaches only its experts' columns of the combine tensor and a
part of the input's gradient, so the input and the combine tensor enter
through :func:`~..parallel.collectives.tp_copy` (the router's gradient,
which flows through the combine weights, is then whole on every
process); the aux losses read the whole routing, computed alike on every
process.  No all-to-all is needed for the dense result.

Aux losses follow the Switch/Mixtral recipe: the load-balance loss (router
probability mass times token fraction per expert) and the router z-loss.

Sequence parallelism (``seq_group``, the ``sp`` group): each process holds
its chunk of every row, in rank order.  The capacity comes from the whole
row's length (the caller's), a token's slot is its position in the whole
row's per-expert ``cumsum``, so a chunk's slots start after the earlier
chunks' per-expert counts (an exclusive prefix of the counts gathered over
``sp``, one gather per top-k round), and the aux losses are the whole
row's: each process returns its chunk's part of them (the per-expert
token counts summed over ``sp`` first), whose sum over ``sp`` is the
whole's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_gather, all_reduce, tp_copy, tp_reduce

__all__ = ["router", "dispatch_combine", "moe_ffn", "moe_ffn_ragged", "expert_capacity"]


def expert_capacity(seq_len: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Tokens-per-expert budget for one routing group (= one batch row)."""
    return max(1, int(math.ceil(seq_len * top_k * capacity_factor / num_experts)))


def router(x: torch.Tensor, w_router: torch.Tensor):
    """Routing probabilities.  x: ``[B, S, d]``, w_router: ``[d, E]`` ->
    (probs, logits), both ``[B, S, E]`` in fp32."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    return torch.softmax(logits, dim=-1), logits


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest routing probabilities and their experts, ties to the
    lower expert index as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order for ties): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(probs: torch.Tensor, top_k: int):
    """Top-k gates renormalized to sum to one per token (Mixtral) and their
    experts."""
    gates, idx = _top_k(probs, top_k)
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx


def _seq_size(seq_group) -> int:
    from ..parallel.collectives import world_size

    return 1 if seq_group is None else world_size(seq_group)


def dispatch_combine(probs: torch.Tensor, top_k: int, capacity: int, seq_group=None):
    """Dispatch/combine tensors from routing probabilities ``[B, S, E]``:
    (dispatch ``[B, S, E, C]`` 0/1 fp32, combine ``[B, S, E, C]`` fp32, aux
    dict).  A position in an expert's buffer is assigned greedily in
    sequence order, one top-k slot at a time: slot 0 of every token before
    slot 1 of any token.  ``seq_group``: ``probs`` is this process's chunk
    of each row (module docstring)."""
    from ..parallel.collectives import rank as group_rank

    b, s, e = probs.shape
    gates, idx = _gates(probs, top_k)
    dev = probs.device
    dispatch = torch.zeros((b, s, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((b, s, e, capacity), dtype=torch.float32, device=dev)
    count = torch.zeros((b, e), dtype=torch.float32, device=dev)  # tokens admitted per expert
    kept_gate_mass = torch.zeros((), dtype=torch.float32, device=dev)
    for slot in range(top_k):
        onehot = F.one_hot(idx[..., slot], e).float()  # [B, S, E]
        pos = torch.cumsum(onehot, dim=1) - 1.0 + count[:, None, :]
        if seq_group is not None:
            # The earlier chunks' tokens of each expert come first.
            every = all_gather(onehot.sum(1)[None].contiguous(), group=seq_group, axis="sp")
            pos = pos + every[:group_rank(seq_group)].sum(0)[:, None, :]
        keep = (pos < capacity).float() * onehot
        if seq_group is None:
            count = count + keep.sum(1)
        else:
            # What the whole row admits: every token up to the capacity.
            count = torch.minimum(count + every.sum(0), torch.full_like(count, capacity))
        pos_idx = pos.clamp(0, capacity - 1).long()
        slot_dispatch = keep[..., None] * F.one_hot(pos_idx, capacity).float()
        dispatch = dispatch + slot_dispatch
        combine = combine + gates[..., slot, None, None] * slot_dispatch
        kept_gate_mass = kept_gate_mass + (gates[..., slot] * keep.sum(-1)).sum()
    n = _seq_size(seq_group)
    if seq_group is not None:
        kept_gate_mass = all_reduce(kept_gate_mass.detach().clone(), group=seq_group, axis="sp")
    # Gate mass lost to capacity overflow, in [0, 1].
    return dispatch, combine, {"fraction_dropped": 1.0 - kept_gate_mass / float(b * s * n)}


def load_balancing_loss(probs: torch.Tensor, dispatch: torch.Tensor,
                        seq_group=None) -> torch.Tensor:
    """Switch-Transformer load-balance loss: E * sum_e f_e * p_e, where f_e is
    the fraction of tokens dispatched to expert e and p_e the mean router
    probability.  ``seq_group``: this chunk's part of the whole row's."""
    return _balance(probs, dispatch.sum((1, 3)), seq_group)


def _balance(probs: torch.Tensor, tokens_per_expert: torch.Tensor,
             seq_group=None) -> torch.Tensor:
    e = probs.shape[-1]
    n = _seq_size(seq_group)
    if seq_group is not None:
        tokens_per_expert = all_reduce(tokens_per_expert.detach().clone(), group=seq_group,
                                       axis="sp")
    f = tokens_per_expert / torch.clamp_min(tokens_per_expert.sum(-1, keepdim=True), 1.0)
    mean = probs.mean(1) if seq_group is None else probs.sum(1) / (probs.shape[1] * n)
    return e * (f * mean).sum(-1).mean()


def router_z_loss(logits: torch.Tensor, seq_group=None) -> torch.Tensor:
    """Penalizes large router logits (ST-MoE).  ``seq_group``: this chunk's
    part of the whole row's."""
    z = torch.logsumexp(logits, dim=-1).square()
    return z.mean() if seq_group is None else z.sum() / (z.numel() * _seq_size(seq_group))


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
            capacity: Optional[int] = None, compute_dtype=torch.bfloat16, group=None,
            axis=None, first_expert: int = 0, seq_group=None):
    """SwiGLU expert FFN with top-k routing through the dense dispatch.

    x: ``[B, S, d]``; w_router: ``[d, E]``; w_gate/w_up: ``[E, d, f]``;
    w_down: ``[E, f, d]``.  Returns (y ``[B, S, d]`` in ``x.dtype``, aux
    losses).  ``group`` (``axis`` its mesh axes): the expert weights are
    this process's experts from ``first_expert`` and its columns of ``f``
    (module docstring).  ``seq_group``: ``x`` is this process's chunk of
    each row over ``sp`` (module docstring; ``capacity`` then comes from
    the whole row's length, ``S`` times the group's size by default)."""
    s = x.shape[1] * _seq_size(seq_group)
    e = w_router.shape[-1]
    if capacity is None:
        capacity = expert_capacity(s, e, top_k, capacity_factor)
    cd = compute_dtype
    probs, logits = router(x, w_router)
    dispatch, combine, aux = dispatch_combine(probs, top_k, capacity, seq_group)
    aux = dict(aux, load_balancing_loss=load_balancing_loss(probs, dispatch, seq_group),
               router_z_loss=router_z_loss(logits, seq_group))
    mine = slice(first_expert, first_expert + w_gate.shape[0])
    xe = torch.einsum("bsec,bsd->becd", dispatch[:, :, mine].to(cd),
                      tp_copy(x, group, axis).to(cd))
    gate = F.silu(torch.einsum("becd,edf->becf", xe, w_gate.to(cd)))
    up = torch.einsum("becd,edf->becf", xe, w_up.to(cd))
    ye = torch.einsum("becf,efd->becd", gate * up, w_down.to(cd))
    y = torch.einsum("bsec,becd->bsd", tp_copy(combine, group, axis)[:, :, mine].to(cd), ye)
    return tp_reduce(y, group, axis).to(x.dtype), aux


def moe_ffn_ragged(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
                   compute_dtype=torch.bfloat16, group=None, axis=None, seq_group=None):
    """Exact MoE FFN over the tokens grouped by expert (the JAX
    ``lax.ragged_dot`` path): ``S * k`` rows, no capacity padding, no token
    dropped.  Same contract as :func:`moe_ffn` minus the capacity knobs;
    ``fraction_dropped`` is zero.  ``group`` is the ``tp`` group only (every
    expert on every process, its columns of ``f``): the ragged groups
    depend on the data, so ``ep`` takes the dense dispatch.

    The group sizes come to the host to slice the sorted rows: one
    synchronisation per MoE layer.  Each token's k expert outputs are summed
    in fp32 in slot order, a fixed order whatever device runs it (the JAX
    scatter-add; with k = 2 the two orders give the same bits).
    ``seq_group``: ``x`` is this process's chunk of each row over ``sp``;
    the FFN is per token, the aux losses are this chunk's part of the
    whole row's."""
    b, s, d = x.shape
    e = w_gate.shape[0]
    cd = compute_dtype
    probs, logits = router(x, w_router)
    gates, idx = _gates(probs, top_k)
    n = b * s * top_k
    expert_of = idx.reshape(n)
    order = torch.argsort(expert_of, stable=True)
    token_of = torch.arange(b * s, device=x.device).repeat_interleave(top_k)
    rows = tp_copy(x, group, axis).reshape(b * s, d).to(cd)[token_of[order]]  # by expert
    sizes = torch.bincount(expert_of, minlength=e).tolist()  # the host sync
    outs = []
    for j, r in enumerate(rows.split(sizes)):
        gate = F.silu(r @ w_gate[j].to(cd))
        outs.append((gate * (r @ w_up[j].to(cd))) @ w_down[j].to(cd))
    weighted = torch.cat(outs).float() * tp_copy(gates, group, axis).reshape(n)[order][:, None]
    # Back to (token, slot) order, then the k outputs of a token summed.
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n, device=x.device)
    y = tp_reduce(weighted[inverse].reshape(b * s, top_k, d).sum(1), group, axis)
    # Every routed token is kept: the dispatch mass is the top-k assignment.
    tokens_per_expert = F.one_hot(idx, e).float().sum(2).sum(1)  # [B, E]
    aux = {
        "load_balancing_loss": _balance(probs, tokens_per_expert, seq_group),
        "router_z_loss": router_z_loss(logits, seq_group),
        "fraction_dropped": torch.zeros((), dtype=torch.float32, device=x.device),
    }
    return y.reshape(b, s, d).to(x.dtype), aux
