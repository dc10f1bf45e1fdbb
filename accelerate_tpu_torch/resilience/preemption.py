"""Preemption-safe stepping: SIGTERM/SIGINT as a flag, agreed across
processes.

The port of the JAX package's ``resilience/preemption.py``.  :class:`PreemptionGuard` turns an asynchronous kill signal into a
decision taken at a step boundary: the handler only sets a flag; the
training loop asks ``accelerator.check_preemption()`` once per step (which
writes one final verified checkpoint), and a serving engine with the guard
installed drains at its next tick.

Nothing is installed unless :meth:`PreemptionGuard.install` runs.  With
several processes the guard is coordinated by default: ``should_stop`` is
any process's flag, agreed on every ``coordinate_every``-th call (counted
per call, so every process takes part on the same step), so a signal to
one process stops all of them at the same step and the final checkpoint
is written by all together.  The agreement runs over the process group's
store with a deadline (:func:`.fleet.agree`, ``agree_timeout_s``), which
stays answerable while part of the fleet is dying; only a group without a
store falls back to an all-reduce.  A failed agreement leaves each process
its local flag.
"""

from __future__ import annotations

import logging
import os
import signal
from typing import Callable, Optional, Sequence

from ..telemetry import get_telemetry

logger = logging.getLogger(__name__)

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers that request a graceful stop.

    >>> guard = accelerator.enable_preemption_handling(save_dir="ckpts")
    >>> for batch in dl:
    ...     train_step(batch)
    ...     if accelerator.check_preemption(step=global_step):
    ...         break  # final verified checkpoint already written

    The handler records the signal, runs the registered callbacks, then
    chains to the Python handler installed before it.  A second delivery of
    the same signal restores the default disposition and re-raises it, so a
    run stuck in its final checkpoint can still be killed.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT),
                 coordinated: Optional[bool] = None, coordinate_every: Optional[int] = None,
                 agree_timeout_s: Optional[float] = None):
        self.signals = tuple(signals)
        # On by default only with several processes; resolved at the first
        # should_stop, so constructing a guard touches no process group.
        self._coordinated = coordinated
        if coordinate_every is None:
            coordinate_every = int(os.environ.get("ACCELERATE_TPU_PREEMPT_EVERY", "10"))
        self.coordinate_every = max(1, int(coordinate_every))
        # The agreement's deadline: a fleet losing members mid-drain falls
        # back to the local flag loudly instead of hanging the drain.
        if agree_timeout_s is None:
            agree_timeout_s = float(os.environ.get("ACCELERATE_TPU_PREEMPT_AGREE_TIMEOUT_S", "60"))
        self.agree_timeout_s = agree_timeout_s
        self._should_stop_calls = 0
        self._agreed = False
        self._installed = False
        self._prev_handlers: dict = {}
        self._in_signal: dict = {}
        self._flag = False
        self._signum: Optional[int] = None
        self._callbacks: list = []
        self.final_checkpoint_saved = False
        self.save_dir: Optional[str] = None
        self._signal_noted = False

    # -- signal plumbing -----------------------------------------------------

    def _handler(self, signum, frame):
        if not self._installed:
            # Uninstalled but still chained behind an outer handler: keep the
            # chain firing, and never swallow a kill when it is the
            # registered handler over the default disposition.
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL and signal.getsignal(signum) == self._handler:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        if self._in_signal.get(signum):
            return  # re-entered through a handler cycle, not a second kill
        if self._flag and self._signum == signum:
            # Second delivery: get out of the way of a determined kill.
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self._in_signal[signum] = True
        try:
            # Flags only: the interrupted thread may hold any lock.
            self._flag = True
            self._signum = signum
            for cb in self._callbacks:
                try:
                    cb(signum)
                except Exception:
                    logger.exception("PreemptionGuard callback failed")
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                try:
                    prev(signum, frame)
                except Exception:
                    logger.exception("chained previous signal handler failed")
        finally:
            self._in_signal[signum] = False

    def _note_signal_in_telemetry(self) -> None:
        """Deferred signal bookkeeping, run from the training thread (a safe,
        non-handler context) the first time the flag is observed."""
        if self._signal_noted or not self._flag:
            return
        self._signal_noted = True
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("resilience.preempt_signals").inc()
            tel.event("resilience.preempt_signal", signum=int(self._signum or 0))

    def install(self) -> "PreemptionGuard":
        """Install the handlers (idempotent).  Must run on the main thread,
        where CPython delivers signals."""
        if self._installed:
            return self
        for signum in self.signals:
            self._prev_handlers[signum] = signal.signal(signum, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previous handlers (idempotent), only where the
        registration is still this guard's: a handler installed over it
        keeps its chain, and the inert guard passes signals through."""
        if not self._installed:
            return
        self._installed = False
        for signum in list(self._prev_handlers):
            if signal.getsignal(signum) != self._handler:
                continue
            try:
                signal.signal(signum, self._prev_handlers[signum])
            except (ValueError, TypeError, OSError):
                continue  # off the main thread: keep the entry for pass-through
            self._prev_handlers.pop(signum)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.uninstall()
        return False

    def add_callback(self, fn: Callable[[int], None]) -> None:
        """Register ``fn(signum)`` to run inside the signal handler; keep it
        to setting flags or writing a line."""
        self._callbacks.append(fn)

    # -- queries -------------------------------------------------------------

    @property
    def installed(self) -> bool:
        return self._installed

    def preempted_locally(self) -> bool:
        """THIS process received a signal (uncoordinated view)."""
        return self._flag

    def _coordination_on(self) -> bool:
        if self._coordinated is not None:
            return self._coordinated
        from ..parallel import collectives

        return collectives.world_size() > 1

    def should_stop(self) -> bool:
        """Whether to stop at this step boundary: the local flag, or, when
        coordinated, whether any process's flag is set, agreed on every
        ``coordinate_every``-th call (the same answer on every process at
        the same step): over the group's store with ``agree_timeout_s``
        (:func:`.fleet.agree`), else by an all-reduce.  A missed deadline
        or a failing agreement falls back to the local flag, logged."""
        self._note_signal_in_telemetry()
        if not self._coordination_on():
            return self._flag
        if self._agreed:
            return True
        self._should_stop_calls += 1
        if (self._should_stop_calls - 1) % self.coordinate_every != 0:
            return False
        from . import fleet

        try:
            if fleet.fleet_client() is not None:
                # Over the store, with a hard deadline: unlike a collective,
                # it stays answerable while part of the fleet is dying,
                # which is exactly when a coordinated drain runs.
                flags = fleet.agree("preempt", bool(self._flag), timeout_s=self.agree_timeout_s)
            else:
                flags = [bool(self._all_reduce_flag())]
        except fleet.FleetError:
            # A dead member mid-drain: the deadline fired instead of hanging.
            # The local flag still drives this process's own checkpoint and exit.
            logger.exception("preemption fleet agreement timed out; using local flag")
            return self._flag
        except Exception:
            # The coordination path itself failing (a process already died)
            # must not mask the local signal.
            logger.exception("preemption flag agreement failed; using local flag")
            return self._flag
        self._agreed = any(flags)
        return self._agreed

    def _all_reduce_flag(self) -> int:
        """The max of every process's flag over the group (a group with no
        store)."""
        import torch

        from ..parallel import collectives
        from ..state import PartialState

        dev = PartialState().device if PartialState._shared_state else torch.device("cpu")
        flag = torch.tensor([int(self._flag)], dtype=torch.int32, device=dev)
        collectives.all_reduce(flag, op="max")
        return int(flag[0])

    def reset(self) -> None:
        """Clear the flag (tests, loops that survive several preemptions)."""
        self._flag = False
        self._signum = None
        self.final_checkpoint_saved = False
        self._signal_noted = False
        self._agreed = False
        self._should_stop_calls = 0
