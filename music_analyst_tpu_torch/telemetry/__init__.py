"""Unified run telemetry: spans, counters, histograms, a JSONL event log.

Counterpart of ``music_analyst_tpu/telemetry/``.  Usage:

    from music_analyst_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    with tel.run_scope("serve", None):
        with tel.span("ingest") as sp:
            ...
            sp.set(bytes=n_bytes)
        tel.count("songs_ingested", n)

The run manifest (``telemetry/introspect.py``) is not ported yet.
"""

from music_analyst_tpu_torch.telemetry.core import (
    DEFAULT_BUCKETS,
    Histogram,
    Span,
    Telemetry,
    configure,
    get_telemetry,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Histogram",
    "Span",
    "Telemetry",
    "configure",
    "get_telemetry",
]
