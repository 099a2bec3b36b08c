"""Ollama HTTP backend: the reference's live path, unchanged in contract.

Counterpart of ``music_analyst_tpu/models/ollama.py``: the same endpoint
(``$OLLAMA_ENDPOINT/api/generate``, default ``http://localhost:11434``),
prompt template and 4,000-character truncation as the on-card Llama
(``models/llama.py``), a 120 s timeout, and first-word label
normalisation, with the reference's empty-response crash fixed.  Transient
failures are retried (``resilience/policy.py``, whose sleeps are clamped
by the armed retry deadline and the active watchdog timeout), each
attempt opening with the ``ollama.request`` fault seam; a 4xx answer
other than 408/429 is a verdict and is not.  It has no device work.
"""

from __future__ import annotations

import os
import time
from typing import List, Sequence, Tuple

from music_analyst_tpu_torch.engines.sentiment import ClassifierBackend
from music_analyst_tpu_torch.models.llama import (
    LYRICS_TRUNCATION,
    PROMPT_TEMPLATE,
)
from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.resilience.policy import (
    RetryPolicy,
    classify_retryable,
    resolve_http_retries,
)
from music_analyst_tpu_torch.telemetry import get_telemetry
from music_analyst_tpu_torch.utils.labels import normalise_label

DEFAULT_ENDPOINT = "http://localhost:11434"


class OllamaClassifier(ClassifierBackend):
    name = "ollama"

    def __init__(
        self,
        model: str = "llama3",
        endpoint: str | None = None,
        timeout: float = 120.0,
        retries: int | None = None,
        backoff_seconds: float = 0.5,
    ) -> None:
        try:
            import requests  # noqa: F401
        except ImportError as exc:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "The 'requests' package is required for the Ollama backend. "
                "Install it or use --mock."
            ) from exc
        self.model = model
        self.endpoint = endpoint or os.environ.get(
            "OLLAMA_ENDPOINT", DEFAULT_ENDPOINT
        )
        self.timeout = timeout
        self.retries = resolve_http_retries(retries)
        self.backoff_seconds = backoff_seconds
        self._retry = RetryPolicy(
            retries=self.retries,
            base_s=self.backoff_seconds,
            cap_s=min(30.0, max(self.backoff_seconds, timeout / 4.0)),
            classify=self._classify_exc,
        )
        # Measured request seconds of the last batch, one per song.
        self.last_latencies: List[float] = []

    @staticmethod
    def _classify_exc(exc: BaseException):
        """HTTP-aware retryability: 4xx (bar 408/429) is a verdict."""
        import requests

        if isinstance(exc, requests.RequestException):
            status = getattr(
                getattr(exc, "response", None), "status_code", None
            )
            if (status is not None and 400 <= status < 500
                    and status not in (408, 429)):
                return False, "http_client_error"
            return True, "http_error"
        return classify_retryable(exc)

    def _classify_one(self, lyrics: str) -> Tuple[str, float]:
        import requests

        lyrics = lyrics.strip()
        if not lyrics:
            return "Neutral", 0.0  # the reference's empty-lyric rule
        payload = {
            "model": self.model,
            "prompt": PROMPT_TEMPLATE.format(lyrics=lyrics[:LYRICS_TRUNCATION]),
            "stream": False,
        }

        def request() -> Tuple[str, float]:
            fault_point("ollama.request", model=self.model)
            start = time.perf_counter()
            response = requests.post(
                f"{self.endpoint}/api/generate",
                json=payload,
                timeout=self.timeout,
            )
            elapsed = time.perf_counter() - start
            response.raise_for_status()
            raw_output = response.json().get("response", "").strip()
            get_telemetry().observe("ollama.request_seconds", elapsed)
            return normalise_label(raw_output), elapsed

        return self._retry.call(request, site="ollama.request")

    def classify_batch(self, texts: Sequence[str]) -> List[str]:
        labels: List[str] = []
        self.last_latencies = []
        with get_telemetry().span("ollama_batch", rows=len(texts)):
            for text in texts:
                label, latency = self._classify_one(text)
                labels.append(label)
                self.last_latencies.append(latency)
        return labels
