"""Per-request distributed tracing with tail-latency attribution.

Counterpart of ``music_analyst_tpu/telemetry/reqtrace.py``, copied with its imports
renamed; the port keeps its own copy.

Aggregate telemetry (histograms, counters) says *that* p99 degraded;
this module says *why one request* was slow.  A trace context —
``{"id": <trace id>, "parent": <parent span id>, "span": <this
process's span id>}`` — is minted at admission (or adopted from the
``ndjson/v1`` wire's optional ``"trace"`` field; absent ⇒ new root) and
carried in ``ServeRequest.meta["trace"]`` across every seam: router
dispatch and requeue hops, WFQ wait and the shed ladder, slot claim,
chunked prefill, decode/verify ticks, preemption + O(1) resume, the
journal group-commit barrier, and the reply write.

**Phases vs details.**  Spans come in two categories.  ``phase`` spans
are a *contiguous partition* of the request's wall time inside one
process (``admit → queue → prefill → decode → commit → reply`` on the
decode path; ``admit → queue → downstream → commit → reply`` in a
router front end), maintained by a per-request wall-clock cursor in
``meta["trace_t"]`` — so their sum covers the wire latency by
construction and ``trace-report`` can attribute the critical path
exactly.  ``detail`` spans (per-chunk prefill, ``journal.sync``) overlap
the phases and never enter the attribution sum.

**Sampling.**  Head sampling is a deterministic function of the trace
id (``crc32(id) / 2^32 < sample``) so every process in the fleet makes
the same decision with zero coordination; tail sampling *always* keeps
a request that was shed, failed, preempted, requeued, or breached its
TTFT/TPOT SLO (the worker's reply carries ``trace_keep`` so the front
end keeps its half of the waterfall too).  Kept traces flush as one
JSON line each into ``<dir>/request_traces.jsonl`` (single appended
``write`` — multi-process safe) plus a Chrome-trace artifact at close;
a flush failure (fault site ``reqtrace.flush``) degrades to a counted
``trace_drops`` and never blocks the reply path.

Disabled (no ``--profile-dir`` / ``$MUSICAAL_TRACE_DIR``) the recorder
is inert: one attribute check per seam, no minting, no extra reply
fields — byte-for-byte the untraced wire.

Host-side only, no device imports.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional

DEFAULT_TRACE_SAMPLE = 0.0
TRACE_FILE = "request_traces.jsonl"

_ENV_SAMPLE = "MUSICAAL_TRACE_SAMPLE"
_ENV_DIR = "MUSICAAL_TRACE_DIR"

# Bounded per-process buffers: live traces (in-flight requests) and the
# flushed-trace ring behind exemplars + the Chrome artifact.  Overflow
# drops the *oldest* (a leaked live trace from a client that vanished
# must not pin memory) and is counted, never silent.
_MAX_LIVE = 4096
_MAX_SPANS = 512
_MAX_FINISHED = 4096
_MAX_CHROME_EVENTS = 50_000

# Phase names that partition wall time (the attribution set).  Anything
# else in a trace is a detail span; trace-report uses the same set.
PHASE_NAMES = frozenset((
    "admit", "queue", "batch", "prefill", "decode", "gap.preempt",
    "hop.requeue", "downstream", "commit", "reply",
))


def resolve_trace_sample(value: Optional[Any] = None) -> float:
    """Head-sampling probability: explicit flag > $MUSICAAL_TRACE_SAMPLE
    > 0.0.  A malformed/out-of-range flag raises (usage error); a
    malformed env var falls back to the default, like every other
    ``resolve_*`` in serving/batcher.py."""
    if value is not None:
        try:
            sample = float(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"--trace-sample expects a float in [0, 1], got {value!r}"
            )
        if not 0.0 <= sample <= 1.0:
            raise ValueError(
                f"--trace-sample expects a float in [0, 1], got {sample!r}"
            )
        return sample
    raw = os.environ.get(_ENV_SAMPLE)
    if raw:
        try:
            sample = float(raw)
        except ValueError:
            return DEFAULT_TRACE_SAMPLE
        if 0.0 <= sample <= 1.0:
            return sample
    return DEFAULT_TRACE_SAMPLE


def resolve_trace_dir(value: Optional[str] = None) -> Optional[str]:
    """Trace output directory: explicit (``--profile-dir``) >
    $MUSICAAL_TRACE_DIR > None (tracing disabled)."""
    if value:
        return value
    return os.environ.get(_ENV_DIR) or None


class RequestTraceRecorder:
    """One process's half of the fleet's request traces."""

    def __init__(self, sample: float = 0.0,
                 directory: Optional[str] = None,
                 role: str = "server") -> None:
        self.sample = float(sample)
        self.directory = directory
        self.role = role
        self.enabled = directory is not None
        self.path = (
            os.path.join(directory, TRACE_FILE) if directory else None
        )
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0
        # trace id -> {"spans": [...], "keep": reason|None, "dropped": n}
        self._live: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._finished: List[Dict[str, Any]] = []
        self._chrome: List[Dict[str, Any]] = []
        self._chrome_tids: Dict[str, int] = {}
        self._stats = {
            "started": 0, "flushed": 0, "discarded": 0, "tail_kept": 0,
            "trace_drops": 0, "spans_dropped": 0, "live_evicted": 0,
        }
        self._closed = False

    # ------------------------------------------------------------ context

    def mint(self, wire: Optional[Any] = None) -> Dict[str, Any]:
        """Adopt the wire's trace context, or mint a new root.

        Every process gets its own ``span`` id (the id downstream hops
        name as their ``parent``); the trace id itself is shared by the
        whole request across the fleet."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        span = f"{os.getpid():x}-{seq:x}"
        if isinstance(wire, dict) and isinstance(wire.get("id"), str):
            parent = wire.get("span")
            return {
                "id": wire["id"][:64],
                "parent": parent if isinstance(parent, str) else None,
                "span": span,
            }
        return {
            "id": os.urandom(8).hex(),
            "parent": None,
            "span": span,
        }

    def sampled(self, trace_id: str) -> bool:
        """Deterministic head-sampling: every process in the fleet makes
        the same call for the same trace id, no coordination."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode("utf-8", "replace"))
                / 4294967296.0) < self.sample

    def set_pending(self, trace: Dict[str, Any], t_admit: float) -> None:
        """Stash the freshly minted wire context for the ``submit`` the
        parser is about to make on this same thread; ``begin_request``
        consumes it (programmatic submitters skip this and mint there)."""
        self._local.pending = (trace, t_admit)

    def _take_pending(self):
        pend = getattr(self._local, "pending", None)
        self._local.pending = None
        return pend

    def begin_request(self, req: Any) -> None:
        """Attach the trace context + wall-clock cursor to one admitted
        (or about-to-be-shed) request.  Called from every ``submit``
        right after the ``ServeRequest`` is built — *before* the shed
        ladder, so sheds carry trace ids too."""
        if not self.enabled:
            return
        pend = self._take_pending()
        now = time.time()
        trace = req.meta.get("trace")
        t_admit = now
        if trace is None:
            if pend is not None:
                trace, t_admit = pend
            else:
                trace = self.mint()
            req.meta["trace"] = trace
        tt = req.meta.setdefault("trace_t", {})
        tt.setdefault("admit", t_admit)
        tt["cursor"] = now
        with self._lock:
            if trace["id"] not in self._live:
                self._stats["started"] += 1
                self._live[trace["id"]] = {
                    "spans": [], "keep": None, "dropped": 0,
                }
                while len(self._live) > _MAX_LIVE:
                    self._live.popitem(last=False)
                    self._stats["live_evicted"] += 1
        self.phase(req, "admit", t_admit, now, op=req.op,
                   tenant=req.tenant, priority=req.priority)

    # -------------------------------------------------------------- spans

    def _span(self, trace_id: str, name: str, t0: float, t1: float,
              cat: str, attrs: Dict[str, Any]) -> None:
        span = {
            "name": name,
            "cat": cat,
            "t": round(t0, 6),
            "dur": round(max(t1 - t0, 0.0), 6),
        }
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            entry = self._live.get(trace_id)
            if entry is None:
                # Late span (trace already flushed) or a keep() that
                # arrived before begin: resurrect a bounded entry.
                entry = self._live[trace_id] = {
                    "spans": [], "keep": None, "dropped": 0,
                }
                while len(self._live) > _MAX_LIVE:
                    self._live.popitem(last=False)
                    self._stats["live_evicted"] += 1
            if len(entry["spans"]) >= _MAX_SPANS:
                entry["dropped"] += 1
                self._stats["spans_dropped"] += 1
                return
            entry["spans"].append(span)

    def phase(self, req: Any, name: str, t0: Optional[float],
              t1: Optional[float], **attrs: Any) -> None:
        """One attribution phase (see PHASE_NAMES): a slice of the
        cursor partition.  No-op for untraced requests."""
        if not self.enabled:
            return
        trace = req.meta.get("trace")
        if trace is None or t0 is None or t1 is None:
            return
        self._span(trace["id"], name, t0, t1, "phase", attrs)

    def detail(self, req: Any, name: str, t0: Optional[float],
               t1: Optional[float], **attrs: Any) -> None:
        """One overlapping detail span (never enters attribution)."""
        if not self.enabled:
            return
        trace = req.meta.get("trace")
        if trace is None or t0 is None or t1 is None:
            return
        self._span(trace["id"], name, t0, t1, "detail", attrs)

    def advance(self, req: Any, name: str, **attrs: Any) -> Optional[float]:
        """Record the phase from the request's cursor to now, then move
        the cursor — the one-liner the hot seams use.  Returns the new
        cursor (now) for callers that chain."""
        if not self.enabled:
            return None
        trace = req.meta.get("trace")
        if trace is None:
            return None
        tt = req.meta.setdefault("trace_t", {})
        now = time.time()
        t0 = tt.get("cursor", now)
        self._span(trace["id"], name, t0, now, "phase", attrs)
        tt["cursor"] = now
        return now

    def keep(self, req: Any, reason: str) -> None:
        """Tail-sampling mark: this request's trace flushes regardless
        of the head-sampling coin (shed / SLO breach / preemption /
        requeue)."""
        if not self.enabled:
            return
        trace = req.meta.get("trace")
        if trace is None:
            return
        with self._lock:
            entry = self._live.get(trace["id"])
            if entry is None:
                entry = self._live[trace["id"]] = {
                    "spans": [], "keep": None, "dropped": 0,
                }
            if entry["keep"] is None:
                entry["keep"] = str(reason)[:80]
                self._stats["tail_kept"] += 1

    def keep_reason(self, req: Any) -> Optional[str]:
        """The tail-keep reason (None when only head-sampled)."""
        if not self.enabled:
            return None
        trace = req.meta.get("trace")
        if trace is None:
            return None
        with self._lock:
            entry = self._live.get(trace["id"])
            return entry["keep"] if entry is not None else None

    # ----------------------------------------------------------- settling

    def on_complete(self, req: Any, payload: Dict[str, Any]) -> None:
        """``ServeRequest.complete`` hook — ONE place that covers every
        settle path (succeed, every shed kind, failures, router replies):
        stamps the reply with the trace id, records the settle wall
        clock, and tail-keeps failures + downstream keep marks."""
        trace = req.meta.get("trace")
        if trace is None:
            return
        payload.setdefault("trace_id", trace["id"])
        tt = req.meta.setdefault("trace_t", {})
        tt["settle"] = time.time()
        downstream_keep = payload.get("trace_keep")
        if isinstance(downstream_keep, str):
            self.keep(req, downstream_keep)
        elif not payload.get("ok"):
            error = payload.get("error")
            kind = (error or {}).get("kind") if isinstance(error, dict) \
                else None
            self.keep(req, kind or "failed")

    def annotate_reply(self, req: Any) -> None:
        """Right before the reply line is written: carry the tail-keep
        verdict on the wire so an upstream router keeps its half of the
        waterfall for a request its worker found interesting."""
        if not self.enabled:
            return
        reason = self.keep_reason(req)
        if reason and isinstance(req.response, dict):
            req.response.setdefault("trace_keep", reason)

    def finish_request(self, req: Any) -> None:
        """The reply left this process: decide keep-vs-discard and flush
        this process's span record as one JSONL line.  Never raises —
        the reply path is already done and must not be re-entered."""
        if not self.enabled:
            return
        trace = req.meta.get("trace")
        if trace is None:
            return
        with self._lock:
            entry = self._live.pop(trace["id"], None)
        if entry is None:
            return
        kept = entry["keep"]
        if kept is None and not self.sampled(trace["id"]):
            with self._lock:
                self._stats["discarded"] += 1
            return
        tt = req.meta.get("trace_t") or {}
        spans = entry["spans"]
        record: Dict[str, Any] = {
            "schema": 1,
            "trace_id": trace["id"],
            "span": trace.get("span"),
            "parent": trace.get("parent"),
            "pid": os.getpid(),
            "role": self.role,
            "req_id": str(req.id),
            "op": req.op,
            "tenant": req.tenant,
            "priority": req.priority,
            "kept": kept or "head",
            "spans": spans,
        }
        t_admit, t_settle = tt.get("admit"), tt.get("settle")
        if t_admit is not None and t_settle is not None:
            record["wire_s"] = round(max(t_settle - t_admit, 0.0), 6)
        if entry["dropped"]:
            record["spans_dropped"] = entry["dropped"]
        try:
            self._flush(record)
        except Exception:  # noqa: BLE001 — never block the reply path
            with self._lock:
                self._stats["trace_drops"] += 1
            return
        with self._lock:
            self._stats["flushed"] += 1
            self._finished.append({
                "trace_id": trace["id"],
                "wire_s": record.get("wire_s"),
                "kept": record["kept"],
                "op": req.op,
                "t": round(time.time(), 6),
            })
            if len(self._finished) > _MAX_FINISHED:
                del self._finished[: len(self._finished) - _MAX_FINISHED]
            self._remember_chrome(record)

    def _flush(self, record: Dict[str, Any]) -> None:
        """One appended write per trace: atomic enough for concurrent
        replica processes sharing the file.  The fault gate sits INSIDE
        so an injected failure exercises the real degradation path."""
        from music_analyst_tpu_torch.resilience.faults import fault_point

        fault_point("reqtrace.flush", trace_id=record["trace_id"])
        os.makedirs(self.directory, exist_ok=True)
        line = json.dumps(record, separators=(",", ":"), default=str)
        fd = os.open(self.path,
                     os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, (line + "\n").encode("utf-8"))
        finally:
            os.close(fd)

    # ----------------------------------------------------- chrome + stats

    def _remember_chrome(self, record: Dict[str, Any]) -> None:
        """Caller holds ``_lock``.  Chrome ``X`` events, one tid per
        trace (profiling/trace.py's shape, µs timestamps)."""
        if len(self._chrome) >= _MAX_CHROME_EVENTS:
            return
        tid = self._chrome_tids.get(record["trace_id"])
        if tid is None:
            tid = len(self._chrome_tids) + 1
            self._chrome_tids[record["trace_id"]] = tid
            self._chrome.append({
                "name": "thread_name", "ph": "M", "pid": os.getpid(),
                "tid": tid,
                "args": {"name": f"trace {record['trace_id'][:12]}"},
            })
        for span in record["spans"]:
            self._chrome.append({
                "name": span["name"],
                "cat": span.get("cat", "phase"),
                "ph": "X",
                "ts": round(span["t"] * 1e6, 3),
                "dur": round(span["dur"] * 1e6, 3),
                "pid": os.getpid(),
                "tid": tid,
                "args": {
                    k: str(v)
                    for k, v in (span.get("attrs") or {}).items()
                },
            })

    def write_chrome(self, path: Optional[str] = None) -> Optional[str]:
        """The flushed traces as one chrome://tracing-loadable artifact
        (per process — the pid suffix keeps replica workers from
        clobbering the front end's file)."""
        if not self.enabled:
            return None
        with self._lock:
            events = list(self._chrome)
        if not events:
            return None
        if path is None:
            path = os.path.join(
                self.directory,
                f"request_traces_chrome.{os.getpid()}.json",
            )
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(
                    {"traceEvents": events, "displayTimeUnit": "ms"}, fh
                )
        except OSError:
            return None
        return path

    def close(self) -> Optional[str]:
        """End of serving: write the Chrome artifact once."""
        if self._closed:
            return None
        self._closed = True
        return self.write_chrome()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["live"] = len(self._live)
        out["sample"] = self.sample
        out["directory"] = self.directory
        return out

    def exemplars(self) -> Dict[str, Any]:
        """Tail exemplars for the latency quantile blocks: the flushed
        trace nearest each wire-latency quantile, so "show me p99"
        dereferences to an actual request in request_traces.jsonl."""
        with self._lock:
            finished = [
                f for f in self._finished
                if isinstance(f.get("wire_s"), (int, float))
            ]
        if not finished:
            return {}
        finished.sort(key=lambda f: f["wire_s"])
        n = len(finished)

        def pick(p: float) -> Dict[str, Any]:
            f = finished[min(n - 1, int(round(p * (n - 1))))]
            return {"trace_id": f["trace_id"],
                    "wire_s": round(f["wire_s"], 6),
                    "kept": f["kept"]}

        return {
            "serving.request_seconds": {
                "n": n,
                "p50": pick(0.50),
                "p95": pick(0.95),
                "p99": pick(0.99),
            }
        }

    def nearest_kept(self, t_wall: Optional[float] = None
                     ) -> Optional[Dict[str, Any]]:
        """The tail-kept flushed trace nearest wall-clock ``t_wall`` —
        what a burn-rate alert embeds so the breach dereferences to a
        request waterfall.  Falls back to head-sampled traces when
        nothing was tail-kept, and to the newest flush when no
        timestamp is given."""
        with self._lock:
            finished = list(self._finished)
        if not finished:
            return None
        kept = [f for f in finished if f.get("kept") not in (None, "head")]
        pool = kept or finished
        if t_wall is None:
            return pool[-1]
        return min(
            pool, key=lambda f: abs((f.get("t") or 0.0) - float(t_wall))
        )


_DISABLED = RequestTraceRecorder()
_RECORDER: RequestTraceRecorder = _DISABLED


def get_reqtrace() -> RequestTraceRecorder:
    return _RECORDER


def configure_reqtrace(
    sample: Optional[Any] = None,
    directory: Optional[str] = None,
    role: str = "server",
) -> RequestTraceRecorder:
    """Install the process recorder.  When enabled, the resolved dir and
    sample are exported to the environment so spawned replica workers
    inherit the fleet's tracing configuration without extra plumbing."""
    global _RECORDER
    resolved_sample = resolve_trace_sample(sample)
    resolved_dir = resolve_trace_dir(directory)
    recorder = RequestTraceRecorder(
        resolved_sample, resolved_dir, role=role
    )
    if recorder.enabled:
        os.environ[_ENV_DIR] = resolved_dir
        os.environ[_ENV_SAMPLE] = repr(resolved_sample)
    _RECORDER = recorder
    return recorder
