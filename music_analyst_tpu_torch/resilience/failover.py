"""Backend failover: one structured re-init and retry on a lost backend.

Counterpart of ``music_analyst_tpu/resilience/failover.py``.  The
watchdog taxonomy can *name* a dead tunnel or a stalled device; this
module is what *acts* on the name.  An engine wraps its device-dependent
block in :func:`run_with_failover`:

1. the block runs; on success nothing else happens;
2. a failure classified as backend loss (``tunnel_dead`` /
   ``device_stall`` / a transient injected fault) triggers ONE re-init of
   the backend (caller-supplied ``reinit``) and one retry;
3. if the retry fails too, the failure is counted and raised.

The one intended difference from JAX: there is no ``degrade`` path.  JAX
finishes a run whose device is lost on a CPU/numpy equivalent and stamps
``degraded: true`` in the run manifest; the port never carries on on the
CPU when the card fails, so a lost card stays a loud failure.  A caller
with its own re-init path (the server's batcher, whose hook reloads the
model on the same card) asks :func:`should_failover` directly.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from music_analyst_tpu_torch.resilience.policy import classify_retryable
from music_analyst_tpu_torch.telemetry import get_telemetry

# Kinds that mean "the backend, not the program": worth a re-init.
FAILOVER_KINDS = frozenset(
    {"tunnel_dead", "device_stall", "fault_injected"}
)


def should_failover(exc: BaseException) -> bool:
    """True when ``exc`` reads as recoverable backend loss."""
    retryable, kind = classify_retryable(exc)
    return retryable and kind in FAILOVER_KINDS


def run_with_failover(
    fn: Callable[[], Any],
    *,
    site: str,
    reinit: Optional[Callable[[], None]] = None,
) -> Any:
    """Run ``fn``; on classified backend loss re-init once and retry.

    Returns ``fn``'s result.  Anything not classified as backend loss —
    and any :class:`InjectedFatal` — propagates unchanged so logic errors
    keep failing fast.  A retry that fails counts
    ``failover.<site>.failed``, emits ``failover_failed`` and raises the
    retry's exception.
    """
    tel = get_telemetry()
    try:
        return fn()
    except Exception as exc:
        if not should_failover(exc):
            raise
        _, kind = classify_retryable(exc)
        tel.count(f"failover.{site}.retries")
        tel.event(
            "failover_retry",
            site=site,
            kind=kind,
            error=str(exc)[:200],
        )
        if reinit is not None:
            try:
                reinit()
            except Exception as reinit_exc:
                tel.event(
                    "failover_reinit_failed",
                    site=site,
                    error=str(reinit_exc)[:200],
                )
        try:
            result = fn()
        except Exception as retry_exc:
            _, retry_kind = classify_retryable(retry_exc)
            tel.count(f"failover.{site}.failed")
            tel.event(
                "failover_failed",
                site=site,
                kind=retry_kind,
                error=str(retry_exc)[:200],
            )
            raise
        tel.count(f"failover.{site}.recoveries")
        tel.event("failover_recovered", site=site)
        return result
