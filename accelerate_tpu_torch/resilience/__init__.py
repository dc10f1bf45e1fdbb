"""Resilience: checkpoint integrity (:mod:`.manifest`) and preemption-safe
stepping for one process (:class:`PreemptionGuard`)."""

from .preemption import PreemptionGuard

__all__ = ["PreemptionGuard"]
