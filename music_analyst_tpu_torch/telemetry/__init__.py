"""Unified run telemetry: spans, counters, histograms, a JSONL event log.

Counterpart of ``music_analyst_tpu/telemetry/``.  Usage (every engine
follows this shape):

    from music_analyst_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    with tel.run_scope("wordcount", output_dir):      # owns the sinks
        with tel.span("ingest") as sp:
            ...
            sp.set(bytes=n_bytes)
        tel.count("songs_ingested", n)

Artifacts (when a sink directory resolves — ``--telemetry-dir`` or the
engine's output dir): ``telemetry.jsonl`` (append-only, one event per
line) and ``run_manifest.json`` (device, kernel-build, version and
counter digest; ``telemetry/introspect.py``).
"""

from music_analyst_tpu_torch.telemetry.core import (
    DEFAULT_BUCKETS,
    Histogram,
    Span,
    Telemetry,
    configure,
    get_telemetry,
)
from music_analyst_tpu_torch.telemetry.introspect import (
    collect_device_info,
    git_describe,
    write_run_manifest,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Histogram",
    "Span",
    "Telemetry",
    "configure",
    "get_telemetry",
    "collect_device_info",
    "git_describe",
    "write_run_manifest",
]
