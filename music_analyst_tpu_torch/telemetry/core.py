"""Process-wide run telemetry: spans, counters, gauges, histograms, sinks.

The reference's only observability is hand-printed wall-clock timestamps
in one JSON file (SURVEY.md §5 "Tracing/profiling: wall-clock only").
This registry is the framework-wide replacement: every engine opens
hierarchical **spans** (start/end wall + monotonic time, parent linkage,
thread-safe), bumps **counters/gauges** (songs ingested, rows classified,
HTTP retries, …), and the registry fans the stream out to two sinks —

* an append-only JSONL event log (``<dir>/telemetry.jsonl``, one event
  per line, both clocks on every line), and
* a run manifest written when the owning scope exits
  (``<dir>/run_manifest.json`` — see ``telemetry/introspect.py``).

Counterpart of ``music_analyst_tpu/telemetry/core.py``; the JAX module's
``jax.monitoring`` harvest (``record_jax_event``) has no counterpart:
:meth:`Telemetry.compile_stats` reports the kernel builds and library
loads of ``music_analyst_tpu_torch/kernels.py`` instead.

Design rules:

* **No device imports** — this module imports neither torch nor the
  kernels at import time.
* **Cheap when disabled** — every public entry point no-ops off one flag
  so engines instrument unconditionally.
* **One registry per process** — mirrors the reference's one-metrics-file
  worldview and keeps the CLI/engine/library entry points coherent; the
  owning :func:`Telemetry.run_scope` resets per-run state so back-to-back
  runs in one process (the sweep engine, the test suite) don't bleed
  counters into each other's manifests.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from music_analyst_tpu_torch.profiling.collectives import emit_stage_table

# Latency-shaped default buckets (seconds): spans from sub-ms device
# dispatches up to the Ollama client's 120 s HTTP timeout.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0,
)

# Raw spans kept in memory per run — aggregates are unbounded-safe, the
# raw list is a debugging convenience and must not grow with corpus size.
_MAX_RAW_SPANS = 10_000


class Span:
    """One completed (or in-flight) named region."""

    __slots__ = (
        "name", "span_id", "parent_id", "thread", "t_wall", "t_mono",
        "duration_s", "attrs",
    )

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 thread: str, t_wall: float, t_mono: float) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.t_wall = t_wall
        self.t_mono = t_mono
        self.duration_s = 0.0
        self.attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (row counts, byte counts, …) to the span."""
        self.attrs.update(attrs)
        return self

    def as_event(self) -> Dict[str, Any]:
        event: Dict[str, Any] = {
            "type": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "t_wall": round(self.t_wall, 6),
            "t_mono": round(self.t_mono, 6),
            "dur_s": round(self.duration_s, 9),
        }
        if self.attrs:
            event["attrs"] = self.attrs
        return event


class _NullSpan:
    """Shared do-nothing span handle for the disabled path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


# Reservoir size for streaming quantiles.  Exact below the cap; above it
# a seeded uniform reservoir keeps quantile error ~1/sqrt(cap) — plenty
# for p99 latency reporting, and deterministic for a fixed value stream.
_QUANTILE_SAMPLE_CAP = 4096

# The quantiles every histogram summary exports (serving latency
# reporting reads these; telemetry-report renders them).
QUANTILES: Tuple[Tuple[str, float], ...] = (
    ("p50", 0.50), ("p95", 0.95), ("p99", 0.99),
)


class Histogram:
    """Fixed-bucket latency histogram (upper-bound buckets + overflow)
    with streaming min/max and reservoir-sampled p50/p95/p99."""

    __slots__ = ("buckets", "counts", "total", "n", "vmin", "vmax",
                 "_sample", "_rng")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._sample: List[float] = []
        # Seeded per histogram: the same value stream always yields the
        # same quantile estimates (reproducible manifests).
        self._rng = random.Random(0x5EED)

    def observe(self, value: float) -> None:
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += value
        self.n += 1
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if len(self._sample) < _QUANTILE_SAMPLE_CAP:
            self._sample.append(value)
        else:
            j = self._rng.randrange(self.n)
            if j < _QUANTILE_SAMPLE_CAP:
                self._sample[j] = value

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the (reservoir) sample; exact while
        fewer than ``_QUANTILE_SAMPLE_CAP`` values have been observed."""
        if not self._sample:
            return None
        ordered = sorted(self._sample)
        rank = max(0, math.ceil(q * len(ordered)) - 1)
        return ordered[min(rank, len(ordered) - 1)]

    def quantiles(self) -> Dict[str, Optional[float]]:
        ordered = sorted(self._sample)
        out: Dict[str, Optional[float]] = {}
        for name, q in QUANTILES:
            if not ordered:
                out[name] = None
                continue
            rank = max(0, math.ceil(q * len(ordered)) - 1)
            out[name] = ordered[min(rank, len(ordered) - 1)]
        return out

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "buckets_le": list(self.buckets) + ["inf"],
            "counts": list(self.counts),
            "count": self.n,
            "sum_s": round(self.total, 9),
        }
        if self.n:
            out["min_s"] = round(self.vmin, 9)
            out["max_s"] = round(self.vmax, 9)
            out["avg_s"] = round(self.total / self.n, 9)
            for name, value in self.quantiles().items():
                out[f"{name}_s"] = (
                    None if value is None else round(value, 9)
                )
        return out


def _unmoved(path: str) -> str:
    return path


class Telemetry:
    """Thread-safe span/counter registry with an optional JSONL sink."""

    def __init__(self, enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.enabled = enabled
        self.directory: Optional[str] = None  # explicit --telemetry-dir
        # Where a path written now will be read: a staged mesh run
        # (``parallel/launch.py:Staging``) moves its files on success.
        self.published: Callable[[str], str] = _unmoved
        # Event taps (observability flight recorder): process-lifetime
        # observers, deliberately OUTSIDE _reset_run_state so a recorder
        # installed once keeps seeing events across runs/configure().
        self._taps: List = []
        self._reset_run_state()

    # ---------------------------------------------------------- run state

    def _reset_run_state(self) -> None:
        self._ids = itertools.count(1)
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, Any] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.spans: List[Span] = []
        self.span_aggregates: Dict[str, List[float]] = {}  # name -> [n, total, max]
        self.context: Dict[str, Any] = {}  # annotate() → manifest fields
        self.pipelines: Dict[str, Any] = {}  # record_pipeline() → manifest
        self.events = 0
        self._sink = None
        self._sink_path: Optional[str] = None
        self._run_depth = 0
        self._run_started_mono: Optional[float] = None

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # --------------------------------------------------------------- sink

    def open_sink(self, directory: str) -> None:
        """Open (or keep) the append-only JSONL log in ``directory``."""
        with self._lock:
            if self._sink is not None:
                return
            os.makedirs(directory, exist_ok=True)
            self._sink_path = os.path.join(directory, "telemetry.jsonl")
            self._sink = open(self._sink_path, "a", encoding="utf-8")

    def close_sink(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    def add_tap(self, fn) -> None:
        """Register a process-lifetime event observer (called with every
        emitted event dict).  Survives run resets and ``configure()`` —
        the flight recorder's ring must keep filling across runs."""
        with self._lock:
            if fn not in self._taps:
                self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    def _emit(self, event: Dict[str, Any]) -> None:
        """Count the event and append it to the JSONL sink if one is open.

        Callers hold no lock; this takes it once per event.
        """
        with self._lock:
            self.events += 1
            if self._sink is not None:
                self._sink.write(json.dumps(event, default=str) + "\n")
                self._sink.flush()
            taps = list(self._taps) if self._taps else None
        if taps:
            # Outside the lock: a tap may itself emit (re-entrancy) and
            # must never be able to wedge the registry.
            for tap in taps:
                try:
                    tap(event)
                except Exception:
                    pass

    # -------------------------------------------------------------- spans

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Any]:
        """Hierarchical timed region; nests via a thread-local stack."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        with self._lock:
            span_id = next(self._ids)
        sp = Span(
            name,
            span_id,
            stack[-1].span_id if stack else None,
            threading.current_thread().name,
            time.time(),
            time.monotonic(),
        )
        sp.attrs.update(attrs)
        stack.append(sp)
        start = time.perf_counter()
        try:
            yield sp
        finally:
            sp.duration_s = time.perf_counter() - start
            stack.pop()
            self._record_span(sp)

    def record_span(self, name: str, duration_s: float, **attrs: Any) -> None:
        """Record an already-measured region (hot loops, worker threads)."""
        if not self.enabled:
            return
        stack = self._stack()
        with self._lock:
            span_id = next(self._ids)
        sp = Span(
            name,
            span_id,
            stack[-1].span_id if stack else None,
            threading.current_thread().name,
            time.time() - duration_s,
            time.monotonic() - duration_s,
        )
        sp.duration_s = duration_s
        sp.attrs.update(attrs)
        self._record_span(sp)

    def _record_span(self, sp: Span) -> None:
        with self._lock:
            agg = self.span_aggregates.setdefault(sp.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += sp.duration_s
            agg[2] = max(agg[2], sp.duration_s)
            if len(self.spans) < _MAX_RAW_SPANS:
                self.spans.append(sp)
        self._emit(sp.as_event())

    # ----------------------------------------------- counters/gauges/hist

    def count(self, name: str, n: int = 1) -> None:
        """Bump a monotonic counter.  Totals land in the manifest and the
        run-end ``counters`` event — per-increment events would swamp the
        log on million-row runs."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        if not self.enabled:
            return
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram(buckets)
            hist.observe(value)

    def event(self, name: str, **attrs: Any) -> None:
        """A discrete point-in-time event (run_start, retry, …)."""
        if not self.enabled:
            return
        payload: Dict[str, Any] = {
            "type": "event",
            "name": name,
            "t_wall": round(time.time(), 6),
            "t_mono": round(time.monotonic(), 6),
        }
        if attrs:
            payload["attrs"] = attrs
        self._emit(payload)

    def annotate(self, **context: Any) -> None:
        """Attach run-level context (mesh shape, backend name, …) that the
        manifest should carry verbatim."""
        if not self.enabled:
            return
        with self._lock:
            self.context.update(context)

    def record_pipeline(self, name: str, summary: Dict[str, Any]) -> None:
        """Store a prefetch pipeline's end-of-run stats (depth, per-stage
        stall/backpressure seconds, queue-depth high-water marks) under its
        pipeline name — the run manifest's ``pipeline`` section."""
        if not self.enabled:
            return
        with self._lock:
            self.pipelines[name] = summary

    def pipeline_summary(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.pipelines)

    # ----------------------------------------------------------- readouts

    def compile_stats(self) -> Dict[str, Any]:
        """Kernel builds of this process: ``count`` is the number of CUDA
        kernel libraries ``kernels.py`` built with nvcc or loaded, and
        ``seconds`` the wall time they took.  This is the port's
        counterpart of the JAX package's XLA compile count; eager PyTorch
        compiles nothing else."""
        from music_analyst_tpu_torch.kernels import build_stats

        stats = build_stats()
        return {"count": stats["count"], "seconds": round(stats["seconds"], 6)}

    def top_spans(self, n: int = 3) -> List[Dict[str, Any]]:
        with self._lock:
            ranked = sorted(
                self.span_aggregates.items(), key=lambda kv: -kv[1][1]
            )[:n]
        return [
            {
                "name": name,
                "count": int(count),
                "total_s": round(total, 6),
                "max_s": round(peak, 6),
            }
            for name, (count, total, peak) in ranked
        ]

    # ---------------------------------------------------------- run scope

    @contextmanager
    def run_scope(
        self,
        engine: str,
        output_dir: Optional[str] = None,
        argv: Optional[List[str]] = None,
    ) -> Iterator[None]:
        """One engine run: the outermost scope owns the sinks.

        The owner resets per-run state, opens the JSONL sink (explicit
        ``--telemetry-dir`` wins over the engine's ``output_dir``), emits
        ``run_start``/``run_end`` events (the latter carrying the wall
        time), and writes the run manifest on exit.  Nested scopes (the joint pipeline calling the wordcount and
        sentiment engines, the sweep looping over analyses) degrade to a
        plain ``engine:<name>`` span under the owner.
        """
        if not self.enabled:
            yield
            return
        with self._lock:
            self._run_depth += 1
            owner = self._run_depth == 1
        directory = None
        if owner:
            self._reset_run_state()
            self._run_depth = 1  # _reset_run_state cleared it
            self._run_started_mono = time.monotonic()
            directory = self.directory or output_dir
            if directory:
                self.open_sink(directory)
            import sys

            self.annotate(engine=engine)
            self.event(
                "run_start", engine=engine,
                argv=list(argv) if argv is not None else list(sys.argv[1:]),
            )
        try:
            with self.span(f"engine:{engine}"):
                yield
        finally:
            if owner:
                wall = time.monotonic() - (self._run_started_mono or 0.0)
                # Per-stage collective table: one event next to the
                # per-call ``collective`` stream (and reset, so the next
                # run starts clean).
                emit_stage_table()
                with self._lock:
                    counters = dict(self.counters)
                    gauges = dict(self.gauges)
                self.event("run_end", engine=engine, counters=counters,
                           gauges=gauges, wall_seconds=round(wall, 6))
                if directory:
                    from music_analyst_tpu_torch.telemetry.introspect import (
                        write_run_manifest,
                    )

                    write_run_manifest(self, directory, wall_seconds=wall)
                self.close_sink()
            with self._lock:
                self._run_depth = max(0, self._run_depth - 1)


# ------------------------------------------------------- process registry

_TELEMETRY = Telemetry(enabled=True)


def get_telemetry() -> Telemetry:
    """The process-wide registry (always callable; may be disabled)."""
    return _TELEMETRY


def configure(
    enabled: bool = True, directory: Optional[str] = None,
    published: Optional[Callable[[str], str]] = None,
) -> Telemetry:
    """(Re)configure the process-wide registry — the CLI's entry point.

    ``directory`` pins the sink location for the whole run (the
    ``--telemetry-dir`` flag); ``None`` lets each run scope default to the
    engine's output directory.  ``published`` maps a path of a staged run
    to where it lands (the manifest's ``telemetry_log``, flight records).
    """
    tel = _TELEMETRY
    tel.close_sink()
    tel.enabled = enabled
    tel.directory = directory
    tel.published = published or _unmoved
    tel._reset_run_state()
    return tel
