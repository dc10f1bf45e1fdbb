"""Bounded-retry smoke runner: quarantine for known-flaky smoke subprocesses.

The port of the JAX package's ``resilience/smoke_retry.py``.  A smoke whose
failures are sometimes environmental (a child killed under host memory
pressure) is not looped until green — that hides real regressions — but run
**with exactly one bounded retry**, and the retry is *loud*: a
``smoke.retried`` telemetry event plus an unmissable stderr line, so a CI
history query can count exactly how often the quarantine fired.

Usage::

    python -m accelerate_tpu_torch.resilience.smoke_retry --label resilience-smoke \
        -- python -m accelerate_tpu_torch.resilience.smoke

A second failure is a real failure: the child's rc propagates.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

DEFAULT_ATTEMPTS = 2


def _log_retry_event(label: str, attempt: int, rc: int) -> None:
    """Make the retry visible: always stderr, plus a durable ``smoke.retried``
    telemetry event — into ``$ACCELERATE_TPU_TELEMETRY_DIR`` when the caller
    configured one, else a stable per-label path under the system temp dir
    (announced on stderr) so CI history can count quarantine fires either
    way."""
    print(
        f"[smoke_retry] {label}: attempt {attempt} failed rc={rc}; "
        "retrying once (quarantined as a known environmental flake)",
        file=sys.stderr,
        flush=True,
    )
    try:
        import tempfile

        from .. import telemetry

        sink = os.environ.get("ACCELERATE_TPU_TELEMETRY_DIR")
        if not sink:
            sink = os.path.join(
                tempfile.gettempdir(), f"atpu_smoke_retry_{label}".replace("/", "_")
            )
            print(f"[smoke_retry] logging smoke.retried event to {sink}",
                  file=sys.stderr, flush=True)
        tel = telemetry.enable(dir=sink)
        tel.event("smoke.retried", label=label, attempt=attempt, rc=rc)
        telemetry.disable()
    except Exception:
        pass  # visibility plumbing must never mask the smoke's own verdict


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.resilience.smoke_retry",
        description="Run a smoke command with one bounded retry, loudly.",
    )
    parser.add_argument("--attempts", type=int, default=DEFAULT_ATTEMPTS)
    parser.add_argument("--label", default="smoke")
    parser.add_argument("--backoff-s", type=float, default=2.0)
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- command to run (everything after --)")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (pass it after --)")
    attempts = max(1, args.attempts)
    rc = 1
    for attempt in range(1, attempts + 1):
        rc = subprocess.run(cmd).returncode
        if rc == 0:
            if attempt > 1:
                print(
                    f"[smoke_retry] {args.label}: PASSED on retry "
                    f"(attempt {attempt}/{attempts})",
                    file=sys.stderr,
                    flush=True,
                )
            return 0
        if attempt < attempts:
            _log_retry_event(args.label, attempt, rc)
            time.sleep(args.backoff_s)
    print(
        f"[smoke_retry] {args.label}: FAILED after {attempts} attempts (rc={rc})",
        file=sys.stderr,
        flush=True,
    )
    return rc


if __name__ == "__main__":
    sys.exit(main())
