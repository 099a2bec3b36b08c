"""Retry policy for the Ollama backend: exponential backoff, full
jitter, a cap.

Partial counterpart of ``music_analyst_tpu/resilience/policy.py``:
``RetryPolicy``, ``classify_retryable`` and ``resolve_http_retries``.  The
JAX module classifies through its run-report taxonomy and honours fault
injection, the bench deadline and the watchdog; none of those is ported
yet, so the classification here keeps only the verdicts that the
exceptions an HTTP client meets get there: timeouts, connection errors
and transport-level ``OSError`` are retried, input-level ``OSError``
(missing file, permission) and logic errors are not.
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Callable, Optional, Tuple

# OSError subtypes that are verdicts about the input, not the transport.
_PERMANENT_OS_ERRORS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)


def classify_retryable(exc: BaseException) -> Tuple[bool, Optional[str]]:
    """``(retryable?, kind)`` for an exception."""
    text = f"{type(exc).__name__}: {exc}".lower()
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True, "attempt_timeout"
    if isinstance(exc, OSError) and not isinstance(exc, _PERMANENT_OS_ERRORS):
        return True, None
    if "timed out" in text or "timeout" in text:
        return True, "attempt_timeout"
    return False, "unknown_error"


class RetryPolicy:
    """Exponential backoff + full jitter + cap.

    ``retries`` is the number of re-attempts after the first try; the
    sleep before re-attempt ``k`` is ``uniform(0, min(cap_s, base_s *
    2^(k-1)))``.  ``classify(exc) -> (retryable, kind)`` decides which
    failures are worth another attempt.
    """

    def __init__(
        self,
        retries: int = 2,
        base_s: float = 0.05,
        cap_s: float = 2.0,
        rng: Optional[Any] = None,
        sleep: Callable[[float], None] = time.sleep,
        classify: Callable[
            [BaseException], Tuple[bool, Optional[str]]
        ] = classify_retryable,
    ) -> None:
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = int(retries)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._classify = classify

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter sleep before re-attempt ``attempt`` (1-based)."""
        ceiling = min(self.cap_s, self.base_s * (2 ** (attempt - 1)))
        return self._rng.uniform(0.0, ceiling)

    def call(self, fn: Callable[..., Any], *args: Any, site: str = "retry",
             **kwargs: Any) -> Any:
        """Run ``fn`` under the policy; raises the last error on give-up.
        ``site`` names the call in the JAX package's accounting and is
        accepted for the same call sites."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                retryable, _ = self._classify(exc)
                if not retryable or attempt > self.retries:
                    raise
                sleep_s = self.backoff_s(attempt)
                if sleep_s > 0.0:
                    self._sleep(sleep_s)


def resolve_http_retries(value: Optional[Any] = None, default: int = 2) -> int:
    """Validated ``MUSICAAL_HTTP_RETRIES`` (the Ollama re-attempt count):
    an explicit value wins, then the environment, then ``default``;
    garbage raises ``ValueError``."""
    source = "http retries"
    if value is None:
        raw = os.environ.get("MUSICAAL_HTTP_RETRIES", "").strip()
        if not raw:
            return default
        source = "MUSICAAL_HTTP_RETRIES"
        value = raw
    try:
        retries = int(str(value).strip())
    except ValueError:
        raise ValueError(
            f"{source} must be an integer >= 0, got {value!r}"
        ) from None
    if retries < 0:
        raise ValueError(f"{source} must be >= 0, got {retries}")
    return retries
