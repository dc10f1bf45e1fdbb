"""Numerical-health guard: NaN/Inf detection, automatic skip/rewind, and
bad-batch quarantine.

The port of the JAX package's ``resilience/health.py``, the same policy on
the same observables.  A single NaN/Inf gradient silently poisons the
parameters and every step after it is wasted until a human notices; the
large-scale training recipes skip the anomalous step, rewind to a
known-good checkpoint on repeated divergence, and drop the data that keeps
breaking.

The guard is split across two layers:

- **detection + zero-delta skip, on the device** — ``optimizer._update_body``
  computes the finiteness of the *pre-clip* global gradient norm (a value
  clip would mask an Inf into a finite number), and a failed verdict leaves
  the parameters and the optimizer's state untouched.  The fused
  ``make_train_step`` additionally folds every micro-batch loss's
  finiteness into the same gate.  Nothing is added to the step: its flash
  kernel launches and its one counted dispatch stay as they are with the
  guard enabled (``chip_smoke.py`` Phase 15 and ``health_smoke`` prove it).
- **policy, on the host** — :class:`HealthGuard` reads the resulting
  ``health_norm`` scalar once per step, skips up to ``max_skips``
  *consecutive* anomalous steps, then rewinds to the newest
  manifest-complete checkpoint via ``resume_from_latest`` (optionally
  backing off the LR), and raises :class:`NumericalDivergenceError` after
  ``max_rewinds`` rewinds.  A batch whose step goes non-finite
  ``quarantine_after`` times (it was replayed after a rewind and broke
  again) is fingerprinted by ``(epoch, batch index)``, recorded to a JSONL
  file next to the telemetry trace log, and skipped by the data loader on
  every later pass.

Telemetry: counters ``health.nonfinite_grads`` / ``health.skipped_steps`` /
``health.rewinds`` / ``health.quarantined_batches``, gauge
``health.last_grad_norm``, events ``health.skip`` / ``health.rewind``.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from ..logging import get_logger
from ..telemetry import get_telemetry as _get_telemetry
from ..telemetry import span as _tspan

logger = get_logger(__name__)

__all__ = ["HealthGuard", "HealthVerdict", "NumericalDivergenceError"]


class NumericalDivergenceError(RuntimeError):
    """Training diverged past the guard's rewind budget (or there was no
    checkpoint to rewind to).  Raised from :meth:`HealthGuard.check` — by the
    time this propagates, skipping and rewinding have both failed to restore
    finite numerics, which is a run-ending condition a human must look at."""


@dataclass
class HealthVerdict:
    """What the guard decided about the step that just ran."""

    anomalous: bool = False   # loss/grad norm went NaN/Inf this step
    skipped: bool = False     # absorbed: the on-device gate applied a zero delta
    rewound: bool = False     # rewound to a checkpoint: break the epoch loop and re-enter
    resumed_step: Optional[int] = None  # step to continue from after a rewind
    grad_norm: Optional[float] = None   # pre-clip global grad norm (NaN/Inf on anomaly)
    quarantined: tuple = field(default_factory=tuple)  # (epoch, index) newly quarantined

    def __bool__(self):  # `if accelerator.check_health(...):` reads as "anomaly?"
        return self.anomalous


def _as_float(value) -> Optional[float]:
    if value is None:
        return None
    try:
        detached = value.detach() if hasattr(value, "detach") else value
        return float(detached)
    except (TypeError, ValueError):
        return None


class HealthGuard:
    """Host-side skip/rewind/quarantine policy over the on-device gate.

    Call :meth:`check` once per optimizer step, right after
    ``optimizer.step()`` (eager) or ``step_fn(batch)`` (fused)::

        guard = accelerator.enable_health_guard(checkpoint_dir="ckpts")
        for batch in dataloader:
            loss = step_fn(batch)
            verdict = accelerator.check_health(step=global_step, loss=loss)
            if verdict.rewound:
                global_step = verdict.resumed_step
                break            # re-enter the dataloader: position was restored
            global_step += 1

    ``max_skips`` bounds *consecutive* anomalous steps absorbed by the
    zero-delta gate before the guard rewinds; one healthy step resets the
    streak.  ``max_rewinds`` bounds rewinds for the whole run.  ``lr_backoff``
    (e.g. ``0.5``) multiplies the learning rate after each rewind — the
    PaLM-style "restart just before the spike with a gentler schedule".
    """

    def __init__(
        self,
        accelerator,
        optimizer=None,
        dataloader=None,
        max_skips: int = 3,
        max_rewinds: int = 2,
        lr_backoff: Optional[float] = None,
        checkpoint_dir: Optional[str] = None,
        quarantine_after: int = 2,
        quarantine_log: Optional[str] = None,
    ):
        if max_skips < 0:
            raise ValueError(f"max_skips must be >= 0, got {max_skips}")
        if max_rewinds < 0:
            raise ValueError(f"max_rewinds must be >= 0, got {max_rewinds}")
        if quarantine_after < 1:
            raise ValueError(f"quarantine_after must be >= 1, got {quarantine_after}")
        self.accelerator = accelerator
        self.optimizer = optimizer
        self.dataloader = dataloader
        self.max_skips = max_skips
        self.max_rewinds = max_rewinds
        self.lr_backoff = lr_backoff
        self.checkpoint_dir = checkpoint_dir
        self.quarantine_after = quarantine_after
        self.quarantine_log = quarantine_log
        self.consecutive_anomalies = 0
        self.rewind_count = 0
        self.quarantined: set = set()
        self._nonfinite_counts: dict = {}
        # Dataloader position at the previous check: the batches consumed
        # since then are the ones this step trained on (covers accumulation
        # windows without any per-batch bookkeeping).
        self._pos_mark: Optional[tuple] = None

    # -- observables -----------------------------------------------------------

    def _read_health_norm(self) -> Optional[float]:
        opt = self.optimizer
        if opt is None:
            return None
        return _as_float(getattr(opt, "_last_health_norm", None))

    def _step_fingerprints(self) -> list:
        """(epoch, batch index) of every batch consumed since the last check."""
        dl = self.dataloader
        if dl is None:
            return []
        epoch = int(getattr(dl, "iteration", 0))
        yielded = int(getattr(dl, "_yielded", 0))
        start = 0
        if self._pos_mark is not None and self._pos_mark[0] == epoch:
            start = min(self._pos_mark[1], yielded)
        self._pos_mark = (epoch, yielded)
        return [(epoch, i) for i in range(start, yielded)]

    def _quarantine_log_path(self) -> Optional[str]:
        if self.quarantine_log is not None:
            return self.quarantine_log
        tel = _get_telemetry()
        if tel.enabled and tel.dir is not None:
            return os.path.join(tel.dir, f"health_quarantine_p{tel._process_index()}.jsonl")
        return None

    def _record_quarantine(self, fingerprint: tuple, count: int, step: Optional[int]):
        path = self._quarantine_log_path()
        if path is None:
            return
        record = {
            "kind": "quarantine",
            "epoch": fingerprint[0],
            "batch_index": fingerprint[1],
            "nonfinite_count": count,
            "step": step,
            "t": time.time(),
        }
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError as e:  # quarantine still applies; only the audit line is lost
            logger.warning(f"could not append quarantine record to {path}: {e}")

    def _push_quarantine(self):
        dl = self.dataloader
        if dl is not None and hasattr(dl, "quarantine") and self.quarantined:
            dl.quarantine(self.quarantined)

    # -- policy ----------------------------------------------------------------

    def check(self, step: Optional[int] = None, loss=None) -> HealthVerdict:
        """Judge the step that just completed and enforce the policy.

        Reads the on-device health norm (one scalar — the only host<->device
        traffic the guard adds), folds in an optional host-side ``loss``
        finiteness check for the eager path, and returns a
        :class:`HealthVerdict`.  Raises :class:`NumericalDivergenceError`
        when the rewind budget is exhausted or no checkpoint exists to rewind
        to."""
        norm = self._read_health_norm()
        loss_value = _as_float(loss)
        anomalous = (norm is not None and not math.isfinite(norm)) or (
            loss_value is not None and not math.isfinite(loss_value)
        )
        fingerprints = self._step_fingerprints()
        verdict = HealthVerdict(anomalous=anomalous, grad_norm=norm)

        tel = _get_telemetry()
        if tel.enabled and norm is not None and math.isfinite(norm):
            tel.registry.gauge("health.last_grad_norm").set(norm)

        if not anomalous:
            self.consecutive_anomalies = 0
            return verdict

        # -- anomalous step: the on-device gate already applied a zero delta --
        self.consecutive_anomalies += 1
        if self.optimizer is not None:
            self.optimizer._step_was_skipped = True
        if tel.enabled:
            tel.registry.counter("health.nonfinite_grads").inc()
        newly_quarantined = []
        for fp in fingerprints:
            count = self._nonfinite_counts.get(fp, 0) + 1
            self._nonfinite_counts[fp] = count
            if count >= self.quarantine_after and fp not in self.quarantined:
                self.quarantined.add(fp)
                newly_quarantined.append(fp)
                self._record_quarantine(fp, count, step)
                if tel.enabled:
                    tel.registry.counter("health.quarantined_batches").inc()
                logger.warning(
                    f"health: quarantined batch (epoch={fp[0]}, index={fp[1]}) "
                    f"after {count} non-finite steps"
                )
        verdict.quarantined = tuple(newly_quarantined)
        if newly_quarantined:
            self._push_quarantine()

        if self.consecutive_anomalies <= self.max_skips:
            verdict.skipped = True
            if tel.enabled:
                tel.registry.counter("health.skipped_steps").inc()
                # Narrate the skip through event() (the rewind branch already
                # does): the flight recorder mirrors events, so a postmortem
                # of a died run shows which steps the zero-delta gate absorbed.
                tel.event(
                    "health.skip",
                    step=step,
                    grad_norm=repr(norm),
                    streak=self.consecutive_anomalies,
                )
            logger.warning(
                f"health: non-finite step (grad norm {norm!r}, loss {loss_value!r}) "
                f"— zero delta applied, skip {self.consecutive_anomalies}/{self.max_skips}"
            )
            return verdict

        # -- skip budget exhausted: rewind --------------------------------------
        self.rewind_count += 1
        if self.rewind_count > self.max_rewinds:
            raise NumericalDivergenceError(
                f"training diverged: {self.consecutive_anomalies} consecutive "
                f"non-finite steps and the rewind budget ({self.max_rewinds}) is "
                f"spent (step={step})"
            )
        with _tspan("health.rewind"):
            resumed = self.accelerator.resume_from_latest(self.checkpoint_dir)
        if resumed is None:
            raise NumericalDivergenceError(
                f"training diverged at step {step} and no manifest-complete "
                f"checkpoint exists under "
                f"{self.checkpoint_dir or 'the project checkpoint dir'} to rewind to"
            )
        if self.lr_backoff is not None and self.optimizer is not None:
            lr = self.optimizer.learning_rate
            if lr is not None:
                self.optimizer.set_learning_rate(lr * self.lr_backoff)
                logger.warning(
                    f"health: learning rate backed off {lr} -> {lr * self.lr_backoff}"
                )
        # The restored loader position predates the fingerprinted batches;
        # re-arm the skip list so the replay drops quarantined data.
        self._push_quarantine()
        self._pos_mark = None
        self.consecutive_anomalies = 0
        if tel.enabled:
            tel.registry.counter("health.rewinds").inc()
            tel.event(
                "health.rewind", step=step, resumed_step=resumed,
                rewind=self.rewind_count,
            )
        logger.warning(
            f"health: rewound to checkpoint step {resumed} "
            f"(rewind {self.rewind_count}/{self.max_rewinds})"
        )
        verdict.rewound = True
        verdict.resumed_step = int(resumed)
        return verdict
