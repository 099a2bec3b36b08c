"""Backend failover verdicts: is this failure a lost backend?

Counterpart of ``should_failover`` in ``music_analyst_tpu/resilience/
failover.py``.  The watchdog taxonomy can *name* a dead tunnel or a
stalled device; a caller with a re-init path (the server's batcher, whose
hook reloads the model on the same card) asks :func:`should_failover`
whether to take it.  The JAX module's ``run_with_failover`` also
degrades to a CPU path; the port has no such path, so a lost card stays
a loud failure.
"""

from __future__ import annotations

from music_analyst_tpu_torch.resilience.policy import classify_retryable

# Kinds that mean "the backend, not the program": worth a re-init.
FAILOVER_KINDS = frozenset(
    {"tunnel_dead", "device_stall", "fault_injected"}
)


def should_failover(exc: BaseException) -> bool:
    """True when ``exc`` reads as recoverable backend loss."""
    retryable, kind = classify_retryable(exc)
    return retryable and kind in FAILOVER_KINDS
