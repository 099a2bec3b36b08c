"""Resident inference server: newline-delimited JSON over a unix socket.

Counterpart of ``music_analyst_tpu/serving/server.py``: the same
``ndjson/v1`` protocol, op table, journal replay and graceful drain, over
the port's backends on the requested device (CUDA by default).  One
deliberate difference: the response-cache fingerprint also folds in
``framework="torch"`` and the device's name, so a cache directory shared
with the JAX package never answers one framework with the other's bytes.
One repair: the ``shutdown`` op's drain begins only once its reply is
queued (JAX begins it while parsing, so the writer can see the drain with
that reply not yet queued and end the stream without it).
Tensor parallelism (``--tp > 1``) is not ported yet; the replica router
(``serving/router.py``) sits in the batcher seat of this same server.

The reference's sentiment path is one process per invocation; this is
the shape of a production stack instead — a process that loads the model
once (``serving/residency.py``), keeps it warm, and answers requests as
they arrive through the dynamic batcher (``serving/batcher.py``).

**Protocol** (``ndjson/v1``, loopback-only by construction — a unix
socket or the process's own stdio; nothing here can reach a network):

* request: ``{"id": <any>, "op": "sentiment"|"wordcount"|"generate",
  "text": ...}`` (``op`` defaults to ``sentiment``; a missing ``id``
  gets an ``auto-<n>`` one).  Control ops: ``ping``, ``stats``,
  ``shutdown``.  ``generate`` (generative backends only) additionally
  accepts ``max_new_tokens`` and rides the continuous-batching decode
  runtime (``serving/decode_loop.py``) instead of the dynamic batcher:
  its reply is ``{"text":…, "label":…, "tokens":…}`` and it can
  overlap with sentiment/wordcount batches on the same connection.
  Every submit op also accepts the SLO/isolation fields
  (``serving/slo.py``): ``tenant`` (string fair-queue identity),
  ``priority`` (integer class, higher first), ``deadline_ms``
  (arrival-relative TTFT deadline; defaults to the configured
  ``--ttft-slo-ms`` when one is set).
* response: one JSON line per request, **in request arrival order per
  connection**: ``{"id":…, "ok": true, "op":…, …payload}`` or
  ``{"id":…, "ok": false, "error": {"kind":…, "detail":…}}``.
  Structured error kinds: ``queue_full`` (admission shed — retry with
  backoff), ``slo_unattainable`` (the drain estimate already blows the
  request's deadline; both sheds carry ``retry_after_ms``),
  ``bad_request``, ``request_failed`` (that request's model row raised;
  the server lives on), ``draining``.

**Graceful drain**: SIGTERM/SIGINT (or the ``shutdown`` op, or stdin
EOF in ``--stdio`` mode) stops admission, finishes every in-flight and
queued batch, writes the remaining replies, dumps a flight record
(``observability/flight.py``) so the drain is a diagnosable artifact,
and exits 0.  The heartbeat watchdog covers the dispatch edge with the
``serve`` kind (taxonomy ``serve_stall``), and per-request spans +
queue-depth/occupancy gauges flow through telemetry into the run
manifest's ``serving`` section.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.serving.batcher import (
    DynamicBatcher,
    ServeRequest,
    resolve_max_batch,
    resolve_max_queue,
    resolve_max_wait_ms,
    resolve_tp,
)
from music_analyst_tpu_torch.serving.journal import (
    RequestJournal,
    resolve_journal_dir,
)
from music_analyst_tpu_torch.serving.residency import ModelResidency
from music_analyst_tpu_torch.serving.response_cache import (
    ResponseCache,
    backend_fingerprint,
    checkpoint_stamp,
    resolve_response_cache_dir,
)
from music_analyst_tpu_torch.telemetry import get_telemetry
from music_analyst_tpu_torch.observability.metrics_plane import (
    configure_metrics,
    get_metrics_plane,
)
from music_analyst_tpu_torch.telemetry.reqtrace import (
    configure_reqtrace,
    get_reqtrace,
)

PROTOCOL = "ndjson/v1"

# The live server (for the run manifest's ``serving`` section): stats only
# exist once a server has run, so serve-free runs keep their key set.  A
# weak reference, unlike JAX's: a module global must not keep a drained
# server's model (gigabytes on the card) alive.
_LAST_SERVER: Optional["weakref.ref[SentimentServer]"] = None


def serving_stats() -> Dict[str, Any]:
    """Stats of the most recent live server in this process ({} if none)."""
    server = _LAST_SERVER() if _LAST_SERVER is not None else None
    return server.stats_snapshot() if server is not None else {}

_EOF = object()  # reader→writer sentinel: the stream ended

def _wordcount_batch(texts: List[str]) -> List[Dict[str, Any]]:
    """Per-request word counts with the serial per-song tool's tokenizer
    semantics (``data/tokenizer.tokenize_latin1``) and the golden ranking
    (count desc, then strcmp asc)."""
    from music_analyst_tpu_torch.data.tokenizer import tokenize_latin1

    out: List[Dict[str, Any]] = []
    for text in texts:
        counts = collections.Counter(tokenize_latin1(text))
        ranked = dict(
            sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        )
        out.append({
            "counts": ranked,
            "total_words": int(sum(counts.values())),
        })
    return out


def build_ops(clf) -> Dict[str, Any]:
    """The batcher op table for a resident classifier backend."""
    def sentiment(texts: List[str]) -> List[Dict[str, Any]]:
        return [{"label": label} for label in clf.classify_batch(texts)]

    return {"sentiment": sentiment, "wordcount": _wordcount_batch}


def build_resident_ops(residency: ModelResidency) -> Dict[str, Any]:
    """Op table that resolves the backend through ``residency`` PER CALL,
    so a failover :meth:`ModelResidency.reload` swaps the model under the
    live batcher instead of pinning the poisoned instance."""
    def sentiment(texts: List[str]) -> List[Dict[str, Any]]:
        labels = residency.current().classify_batch(texts)
        return [{"label": label} for label in labels]

    return {"sentiment": sentiment, "wordcount": _wordcount_batch}


class SentimentServer:
    """Wire protocol + connection lifecycle around a DynamicBatcher."""

    def __init__(
        self,
        batcher: DynamicBatcher,
        residency: Optional[ModelResidency] = None,
        mode: str = "stdio",
        decode=None,
        journal: Optional[RequestJournal] = None,
        router=None,
    ) -> None:
        self.batcher = batcher
        self.residency = residency
        # Durable request journal (serving/journal.py): admitted records
        # write ahead of dispatch, replied records fsync ahead of the
        # wire, and re-dispatched ids settle from the dedup index instead
        # of recomputing.  None = the historical non-durable behavior.
        self.journal = journal
        # Optional ContinuousScheduler hosting the ``generate`` op; None
        # when the backend has no slot runtime (e.g. --mock) — generate
        # requests then settle as bad_request instead of crashing.
        self.decode = decode
        # Scale-out mode (serving/router.py): the ReplicaRouter sitting in
        # the batcher seat, kept separately so stats_snapshot can surface
        # the fleet view (per-replica dispatch counts, health transitions)
        # as the manifest's ``serving.router`` section.
        self.router = router
        self.mode = mode
        self.drain_event = threading.Event()
        self.drain_reason: Optional[str] = None
        self._drain_lock = threading.Lock()
        self._drained = False
        self._auto_ids = 0
        self._started_mono = time.monotonic()
        # Kernel launch counts when the server became ready (set by
        # run_server); ``stats`` then reports the launches since, so a
        # router's workers can each count their own.
        self.launches_at_ready: Optional[Dict[str, int]] = None
        global _LAST_SERVER
        _LAST_SERVER = weakref.ref(self)

    # ------------------------------------------------------------- control

    def request_drain(self, reason: str, record: bool = True) -> None:
        """Begin a graceful drain (idempotent): stop admission, flush the
        queues, and (for signals/shutdown — not a routine stdio EOF) leave
        a flight record naming the reason."""
        if self.drain_event.is_set():
            return
        self.drain_reason = reason
        self.drain_event.set()
        tel = get_telemetry()
        tel.event("serve_drain", reason=reason)
        if not record:
            return
        try:
            from music_analyst_tpu_torch.observability.flight import (
                get_flight_recorder,
            )

            get_flight_recorder().dump(
                reason=f"serve_drain:{reason}",
                detail=(
                    f"graceful drain ({reason}); queued requests flushed, "
                    "admission closed"
                ),
            )
        except Exception:
            pass

    def _drain_batcher(self) -> None:
        with self._drain_lock:
            if not self._drained:
                self.batcher.drain()
                if self.decode is not None:
                    self.decode.drain()
                self._drained = True

    # ------------------------------------------------------------ protocol

    def _control(self, rid: Any, op: str) -> Dict[str, Any]:
        if op == "ping":
            return {"id": rid, "ok": True, "op": "ping",
                    "protocol": PROTOCOL}
        if op == "stats":
            return {"id": rid, "ok": True, "op": "stats",
                    "stats": self.stats_snapshot()}
        # shutdown: the reader requests the drain once this reply is
        # queued (``handle_stream``), so it goes out first, in order.
        return {"id": rid, "ok": True, "op": "shutdown", "draining": True}

    def _parse_submit(self, line: str) -> ServeRequest:
        """One wire line → an admitted/settled ServeRequest (parse errors
        settle immediately as ``bad_request`` so ordering still holds)."""
        t0_w = time.time()
        self._auto_ids += 1
        fallback_id = f"auto-{self._auto_ids}"
        try:
            payload = json.loads(line)
            if not isinstance(payload, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            req = ServeRequest(fallback_id, "invalid", "")
            req.fail("bad_request", f"unparseable request: {exc}"[:200])
            return req
        rid = payload.get("id", fallback_id)
        op = payload.get("op", "sentiment")
        if op in ("ping", "stats", "shutdown"):
            req = ServeRequest(rid, op, "")
            req.complete(self._control(rid, op))
            return req
        text = payload.get("text")
        if not isinstance(text, str):
            req = ServeRequest(rid, op, "")
            req.fail("bad_request", "missing/non-string 'text' field")
            return req
        tenant = payload.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            req = ServeRequest(rid, op, text)
            req.fail("bad_request", "'tenant' must be a string")
            return req
        priority = payload.get("priority")
        if priority is not None and (
            isinstance(priority, bool) or not isinstance(priority, int)
        ):
            req = ServeRequest(rid, op, text)
            req.fail("bad_request", "'priority' must be an integer")
            return req
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None and (
            isinstance(deadline_ms, bool)
            or not isinstance(deadline_ms, (int, float))
        ):
            req = ServeRequest(rid, op, text)
            req.fail("bad_request", "'deadline_ms' must be a number")
            return req
        slo = {"tenant": tenant, "priority": priority,
               "deadline_ms": deadline_ms}
        budget = None
        if op == "generate":
            if self.decode is None:
                req = ServeRequest(rid, op, text)
                req.fail(
                    "bad_request",
                    "generate requires a generative backend with a slot "
                    "runtime (not available on this server)",
                )
                return req
            budget = payload.get("max_new_tokens")
            if budget is not None and not isinstance(budget, int):
                req = ServeRequest(rid, op, text)
                req.fail("bad_request",
                         "'max_new_tokens' must be an integer")
                return req
        if self.journal is not None:
            # Exactly-once at the wire: a re-dispatched id whose reply is
            # journaled settles from the dedup index — nothing recomputes.
            deduped = self.journal.lookup_reply(rid)
            if deduped is not None:
                req = ServeRequest(rid, op, text)
                deduped["id"] = rid
                req.complete(deduped)
                return req
        rt = get_reqtrace()
        trace = None
        if rt.enabled:
            # Adopt the wire's optional "trace" field (absent ⇒ new
            # root: ndjson/v1 stays backward-compatible) and hand it to
            # the submit below on this same thread, clocked from the
            # moment the line arrived.
            trace = rt.mint(payload.get("trace"))
            rt.set_pending(trace, t0_w)
        if self.journal is not None:
            meta: Dict[str, Any] = {}
            if budget is not None:
                meta["max_new_tokens"] = budget
            if trace is not None:
                # Crash replay re-adopts the same trace id, so the
                # waterfall survives a restart (_replay_journal).
                meta["trace"] = trace
            self.journal.record_admitted(
                rid, op, text, tenant=tenant, priority=priority,
                deadline_ms=deadline_ms, meta=meta,
            )
        # Post-admit crash seam: admission journaled, no reply yet — a
        # SIGKILL here must replay the request on restart.
        fault_point("serve.admit", op=op)
        if op == "generate":
            return self.decode.submit(rid, text, max_new_tokens=budget,
                                      **slo)
        return self.batcher.submit(rid, op, text, **slo)

    # ---------------------------------------------------------- stream I/O

    def handle_stream(self, rfile, wfile, drain_on_eof: bool = False) -> int:
        """Serve one NDJSON stream: replies in request arrival order.

        A reader thread admits requests as fast as the peer sends them
        (so a whole burst coalesces); this thread writes each settled
        reply in order.  Returns the number of replies written.
        """
        tel = get_telemetry()
        rt = get_reqtrace()
        order: "queue.Queue" = queue.Queue()
        stop_reading = threading.Event()

        def read_loop() -> None:
            try:
                for line in rfile:
                    if stop_reading.is_set() or self.drain_event.is_set():
                        break
                    line = line.strip()
                    if not line:
                        continue
                    req = self._parse_submit(line)
                    order.put(req)
                    if req.op == "shutdown":
                        # Only now: a drain requested while parsing let
                        # the writer see it with this reply not yet
                        # queued, and end the stream without it.
                        self.request_drain("shutdown_op")
            except (OSError, ValueError):
                pass  # peer vanished mid-line: the writer flushes and exits
            finally:
                order.put(_EOF)

        reader = threading.Thread(
            target=read_loop, name="serve-reader", daemon=True
        )
        reader.start()

        written = 0
        eof = False
        pending: "collections.deque[ServeRequest]" = collections.deque()

        def _pull(block: bool) -> None:
            """Drain the reader's queue into ``pending`` (arrival order
            preserved), folding the EOF sentinel into the flag."""
            nonlocal eof
            try:
                item = order.get(timeout=0.05) if block else \
                    order.get_nowait()
            except queue.Empty:
                return
            while True:
                if item is _EOF:
                    eof = True
                    if drain_on_eof:
                        self.request_drain("eof", record=False)
                        self._drain_batcher()
                else:
                    pending.append(item)
                try:
                    item = order.get_nowait()
                except queue.Empty:
                    return

        while True:
            if self.drain_event.is_set():
                # Admission is closed; everything already queued settles
                # once the batcher finishes its flush.
                self._drain_batcher()
            _pull(block=not pending)
            if not pending:
                if eof or (self.drain_event.is_set() and order.empty()):
                    break
                continue
            req: ServeRequest = pending.popleft()
            # Bounded waits so a drain can't strand the writer; the
            # batcher answers every admitted request on drain.
            while not req.wait(timeout=0.2):
                if self.drain_event.is_set():
                    self._drain_batcher()
            # Group commit: the settled head plus every already-settled
            # successor (one dynamic batch usually settles together)
            # journal their replies under ONE fsync, then the lines go
            # out in arrival order — the per-reply durability barrier
            # (record durable BEFORE its line hits the wire, so any
            # reply a client ever saw is deduplicable after a crash,
            # and one a crash ate is recomputed, never duplicated) at
            # amortized fsync cost.
            batch = [req]
            while pending and pending[0].done:
                batch.append(pending.popleft())
            journaled = False
            t_sync0 = time.time() if rt.enabled else None
            for settled in batch:
                # Pre-reply crash seam, then the durability barrier.
                fault_point("serve.reply", op=settled.op)
                if self.journal is not None and settled.op not in (
                    "ping", "stats", "shutdown", "invalid",
                ):
                    self.journal.record_replied(
                        settled.id, settled.response, sync=False
                    )
                    journaled = True
            if journaled:
                self.journal.sync()
            if rt.enabled:
                # The group-commit barrier is shared: every settled
                # request's ``commit`` phase runs settle → barrier end,
                # with the fsync itself an overlapping detail span.
                t_sync1 = time.time()
                for settled in batch:
                    tt = settled.meta.get("trace_t")
                    if tt is None:
                        continue
                    rt.phase(settled, "commit",
                             tt.get("cursor", t_sync0), t_sync1,
                             journaled=journaled, group=len(batch))
                    if journaled:
                        rt.detail(settled, "journal.sync",
                                  t_sync0, t_sync1)
                    tt["cursor"] = t_sync1
            for settled in batch:
                if rt.enabled:
                    rt.annotate_reply(settled)
                with tel.span("serve.reply", op=settled.op):
                    wfile.write(json.dumps(settled.response) + "\n")
                    wfile.flush()
                if rt.enabled:
                    rt.advance(settled, "reply", op=settled.op)
                    rt.finish_request(settled)
                written += 1
        stop_reading.set()
        return written

    # ------------------------------------------------------------- sockets

    def serve_unix(self, path: str) -> int:
        """Accept loop on a unix stream socket (thread per connection);
        returns the number of connections served after a drain."""
        import os
        import socket

        try:
            os.unlink(path)
        except OSError:
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(path)
        sock.listen(16)
        sock.settimeout(0.2)
        conns: List[threading.Thread] = []
        served = 0
        try:
            while not self.drain_event.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                served += 1

                def _one(conn=conn) -> None:
                    with conn:
                        rfile = conn.makefile("r", encoding="utf-8")
                        wfile = conn.makefile("w", encoding="utf-8")
                        try:
                            self.handle_stream(rfile, wfile)
                        except (OSError, ValueError):
                            pass

                thread = threading.Thread(
                    target=_one, name=f"serve-conn-{served}", daemon=True
                )
                thread.start()
                conns.append(thread)
        finally:
            self._drain_batcher()
            for thread in conns:
                thread.join(timeout=5.0)
            sock.close()
            try:
                os.unlink(path)
            except OSError:
                pass
        return served

    # ------------------------------------------------------------ readouts

    def kernel_launches_since_ready(self) -> Dict[str, int]:
        """Kernel launches of this session, warmup excluded."""
        at_ready = self.launches_at_ready or {}
        return {name: n - at_ready.get(name, 0)
                for name, n in kernels.launches().items()}

    def stats_snapshot(self, include_metrics: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "protocol": PROTOCOL,
            "mode": self.mode,
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
            "draining": self.drain_event.is_set(),
            "drain_reason": self.drain_reason,
            "requests": self.batcher.stats(),
        }
        if self.decode is not None:
            out["decode"] = self.decode.stats()
        if self.residency is not None:
            out["residency"] = self.residency.snapshot()
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        if self.router is not None:
            out["router"] = self.router.stats()
        if self.launches_at_ready is not None:
            out["kernel_launches"] = self.kernel_launches_since_ready()
        # Response cache (serving/response_cache.py) — one instance is
        # shared by whichever admission edges exist; only-when-used.
        for edge in (self.batcher, self.decode, self.router):
            cache = getattr(edge, "response_cache", None)
            if cache is not None:
                out["response_cache"] = cache.stats()
                break
        rt = get_reqtrace()
        if rt.enabled:
            out["reqtrace"] = rt.stats()
        # SLO layer (serving/slo.py) — only-when-used, like the
        # corpus-cache manifest section: empty snapshots stay out.
        slo: Dict[str, Any] = {}
        snap = getattr(self.batcher, "slo_snapshot", None)
        if callable(snap):
            slo.update(snap() or {})
        if self.decode is not None:
            snap = getattr(self.decode, "slo_snapshot", None)
            if callable(snap):
                decode_slo = snap() or {}
                if decode_slo:
                    slo["decode"] = decode_slo
        if slo:
            out["slo"] = slo
        # Metrics plane (observability/metrics_plane.py) — only when
        # sampling is on.  The plane's own sampler scrapes with
        # ``include_metrics=False`` so the series never nests itself.
        if include_metrics:
            plane = get_metrics_plane()
            if plane.enabled:
                out["metrics"] = plane.snapshot()
        return out


# ----------------------------------------------------------------- CLI glue


def _replay_journal(journal: RequestJournal, batcher, decode,
                    unanswered: List[Dict[str, Any]]) -> int:
    """Answer every admitted-but-unanswered journaled request before
    taking live traffic.  Ops are pure functions of their text, so the
    recompute is byte-identical to the reply the crash ate; journaling
    it makes a reconnecting client's re-submit settle from the dedup
    index."""
    if not unanswered:
        return 0
    rt = get_reqtrace()
    reqs: List[ServeRequest] = []
    for record in unanswered:
        rid = record.get("id")
        op = record.get("op")
        text = record.get("text") or ""
        meta = record.get("meta") or {}
        if rt.enabled and isinstance(meta.get("trace"), dict):
            # Continue the journaled trace (same id; the crashed
            # process's span becomes the parent) so the waterfall spans
            # the restart.
            rt.set_pending(rt.mint(meta["trace"]), time.time())
        slo = dict(
            tenant=record.get("tenant"),
            priority=record.get("priority"),
            deadline_ms=None,  # the journaled deadline already elapsed
        )
        if op == "generate":
            if decode is None:
                req = ServeRequest(rid, op, text)
                req.fail(
                    "request_failed",
                    "journaled generate request replayed on a server "
                    "without a decode runtime",
                )
            else:
                req = decode.submit(
                    rid, text,
                    max_new_tokens=meta.get("max_new_tokens"), **slo,
                )
        else:
            req = batcher.submit(rid, op or "invalid", text, **slo)
        reqs.append(req)
    for req in reqs:
        req.wait(timeout=60.0)
        if req.done:
            journal.record_replied(req.id, req.response)
    get_telemetry().count("journal.replayed", len(reqs))
    return len(reqs)


def _stale_flight_witness() -> bool:
    """The second unclean witness: a flight record already in the
    telemetry dir from a PREVIOUS process whose reason was not a
    graceful drain (SIGKILL writes none, but a fatal crash/watchdog dump
    survives the restart)."""
    directory = get_telemetry().directory
    if not directory:
        return False
    path = os.path.join(directory, "flight_record.json")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return False
    reason = str(record.get("reason") or "")
    return not reason.startswith("serve_drain")


def serve_mesh(tp: Optional[int]):
    """Mesh for ``--tp N``: None for the one-device layout; a width above
    1 (tensor-parallel serving: a follower loop on every rank but the
    coordinator) is not ported yet."""
    width = resolve_tp(tp)
    if width <= 1:
        return None
    raise NotImplementedError(
        f"--tp {width} (tensor-parallel serving) is not yet ported to "
        "music_analyst_tpu_torch"
    )


def device_identity(backend) -> str:
    """Name of the device a backend computes on, for the response-cache
    fingerprint: the card's name for CUDA, else the device type (a
    host-only backend has none)."""
    device = getattr(backend, "device", None)
    if device is None:
        return "host"
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run_server(
    model: str = "mock",
    mock: bool = False,
    weight_quant: Optional[str] = None,
    stdio: bool = False,
    socket_path: Optional[str] = None,
    max_batch: Optional[int] = None,
    max_wait_ms: Optional[float] = None,
    max_queue: Optional[int] = None,
    warmup: bool = True,
    backend=None,
    quiet: bool = False,
    slots: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
    max_new_tokens: int = 16,
    page_size: Optional[int] = None,
    kv_pages: Optional[int] = None,
    kv_quant: Optional[str] = None,
    speculate_k: Optional[int] = None,
    tp: Optional[int] = None,
    ttft_slo_ms: Optional[float] = None,
    tpot_slo_ms: Optional[float] = None,
    tenant_budget: Optional[float] = None,
    priority: Optional[int] = None,
    response_cache_dir: Optional[str] = None,
    use_response_cache: bool = True,
    journal_dir: Optional[str] = None,
    trace_sample: Optional[Any] = None,
    trace_dir: Optional[str] = None,
    metrics_interval_ms: Optional[Any] = None,
    device: str = "cuda",
) -> int:
    """The ``serve`` subcommand: load, warm, then serve until drained.

    Startup chatter goes to stderr only — in ``--stdio`` mode stdout *is*
    the reply channel and must carry nothing but NDJSON responses.
    """
    tel = get_telemetry()
    # Request tracing (telemetry/reqtrace.py): enabled iff a directory
    # resolves (--profile-dir here, $MUSICAAL_TRACE_DIR in replica
    # workers the router spawned).  Disabled = inert.
    reqtrace = configure_reqtrace(
        trace_sample, directory=trace_dir, role="server"
    )
    # Metrics plane (observability/metrics_plane.py): enabled iff an
    # interval resolves (--metrics-interval-ms here,
    # $MUSICAAL_METRICS_INTERVAL_MS in spawned replicas).  Disabled =
    # zero wire effect.
    metrics = configure_metrics(
        metrics_interval_ms, directory=trace_dir, role="server"
    )
    resolved_batch = resolve_max_batch(max_batch)
    with tel.run_scope("serve", None):
        # Crash-consistency first: open the journal (replaying its state)
        # and check both unclean witnesses BEFORE any work this run could
        # overwrite them — the journal's missing clean marker (SIGKILL
        # writes no flight record, so the journal is the witness) and a
        # stale non-drain flight record from the previous process.
        journal: Optional[RequestJournal] = None
        unanswered: List[Dict[str, Any]] = []
        stale_flight = _stale_flight_witness()
        journal_path = resolve_journal_dir(journal_dir)
        if journal_path:
            journal = RequestJournal(journal_path)
            unanswered = journal.recover()
        unclean_journal = (
            journal is not None and journal.stats()["unclean_start"]
        )
        if unclean_journal or stale_flight:
            witness = "journal" if unclean_journal else "flight_record"
            tel.annotate(
                unclean_shutdown=True,
                unclean_witness=witness,
            )
            tel.event("unclean_shutdown_detected", witness=witness,
                      replayed=len(unanswered))
            if not quiet:
                print(
                    f"serve: unclean shutdown detected ({witness}); "
                    f"{len(unanswered)} journaled request(s) to replay",
                    file=sys.stderr,
                )
        serve_mesh(tp)
        residency = ModelResidency(
            model=model, mock=mock, weight_quant=weight_quant,
            backend=backend, device=device,
        )
        clf = residency.acquire()
        # Response cache (serving/response_cache.py): ONE instance shared
        # by every admission edge this server stands up.  The fingerprint
        # folds in everything that changes reply bytes — model identity,
        # checkpoint stamp, quant schemes, the decode budget clamp — so a
        # cache dir shared across configurations can never cross replies;
        # ``device`` (with the framework backend_fingerprint adds) keeps
        # this package's entries apart from the JAX package's.
        rc_dir = resolve_response_cache_dir(
            response_cache_dir, use_response_cache
        )
        response_cache = None
        if rc_dir is not None:
            response_cache = ResponseCache(
                rc_dir,
                fingerprint=backend_fingerprint(
                    model=model,
                    backend=getattr(clf, "name", "injected"),
                    mock=bool(mock),
                    weight_quant=weight_quant or "none",
                    kv_quant=kv_quant or "none",
                    max_new_tokens=int(max_new_tokens),
                    tp=resolve_tp(tp),
                    checkpoint=checkpoint_stamp(),
                    device=device_identity(clf),
                ),
            )
        if warmup:
            record = residency.warmup(resolved_batch)
            if not quiet:
                print(
                    f"serve: warmed {len(record['sizes'])} bucket shape(s) "
                    f"in {record['seconds']:.2f}s "
                    f"({record['compiles']} kernel build(s))",
                    file=sys.stderr,
                )
        batcher = DynamicBatcher(
            build_resident_ops(residency),
            max_batch=resolved_batch,
            max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            failover=lambda exc: residency.reload() is not None,
            ttft_slo_ms=ttft_slo_ms,
            tenant_budget=tenant_budget,
            priority=priority,
            response_cache=response_cache,
            device=getattr(clf, "device", None),
        ).start()
        # Continuous decode runtime for the ``generate`` op — only when
        # the backend exposes a slot runtime (capability probe) and slots
        # weren't explicitly disabled with --slots=0.
        decode = None
        if hasattr(clf, "slot_runtime") and (slots is None or slots > 0):
            from music_analyst_tpu_torch.serving.decode_loop import (
                ContinuousScheduler,
            )

            decode = ContinuousScheduler(
                clf,
                n_slots=slots,
                prefill_chunk=prefill_chunk,
                max_new_tokens=max_new_tokens,
                max_queue=max_queue,
                page_size=page_size,
                kv_pages=kv_pages,
                kv_quant=kv_quant,
                speculate_k=speculate_k,
                ttft_slo_ms=ttft_slo_ms,
                tpot_slo_ms=tpot_slo_ms,
                tenant_budget=tenant_budget,
                priority=priority,
                response_cache=response_cache,
                # Engine ledger: flushes to the same profile dir on the
                # metrics cadence ($MUSICAAL_LEDGER_* override either).
                ledger_dir=trace_dir,
            )
            if warmup:
                record = residency.warmup_decode(decode)
                if not quiet:
                    print(
                        f"serve: warmed decode runtime "
                        f"({record['n_slots']} slot(s)) in "
                        f"{record['seconds']:.2f}s "
                        f"({record['compiles']} kernel build(s))",
                        file=sys.stderr,
                    )
            decode.start()
        server = SentimentServer(
            batcher, residency, mode="stdio" if stdio else "unix",
            decode=decode, journal=journal,
        )
        if metrics.enabled:
            metrics.attach(
                lambda: server.stats_snapshot(include_metrics=False)
            )
            metrics.start()
        # Replay BEFORE live traffic: every journaled-but-unanswered
        # request settles (and its reply journals) so reconnecting
        # clients dedup instead of recomputing.
        if journal is not None and unanswered:
            replayed = _replay_journal(journal, batcher, decode, unanswered)
            if not quiet:
                print(
                    f"serve: replayed {replayed} journaled request(s)",
                    file=sys.stderr,
                )
        tel.annotate(
            backend=getattr(clf, "name", "injected"),
            serve_mode=server.mode,
            max_batch=batcher.max_batch,
            max_wait_ms=batcher.max_wait_ms,
            max_queue=batcher.max_queue,
            decode_slots=(decode.plan.n_slots if decode is not None else 0),
            serve_tp=resolve_tp(tp),
            journal_dir=journal_path,
            response_cache_dir=rc_dir,
        )

        # Graceful SIGTERM/SIGINT: drain instead of dying.  The flight
        # recorder's own handlers were installed by the CLI before this;
        # replacing them here means a signal drains the server (and the
        # drain itself dumps the flight record), rather than chaining to
        # the process-killing default.  Restored on exit.
        import signal

        previous: Dict[int, Any] = {}

        def _on_signal(signum, frame) -> None:
            try:
                name = signal.Signals(signum).name
            except ValueError:  # pragma: no cover
                name = str(signum)
            server.request_drain(f"signal:{name}")

        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[signum] = signal.signal(signum, _on_signal)
            except (ValueError, OSError):  # non-main thread (tests)
                pass
        # Kernel launches are reported per session: warmup's are not the
        # traffic's.
        server.launches_at_ready = kernels.launches()
        try:
            if stdio:
                if not quiet:
                    print(
                        f"serve: ready on stdio (max_batch="
                        f"{batcher.max_batch}, max_wait_ms="
                        f"{batcher.max_wait_ms}, max_queue="
                        f"{batcher.max_queue})",
                        file=sys.stderr,
                    )
                server.handle_stream(sys.stdin, sys.stdout,
                                     drain_on_eof=True)
            else:
                if not socket_path:
                    raise ValueError(
                        "serve: --socket PATH (or --stdio) is required"
                    )
                if not quiet:
                    print(
                        f"serve: listening on {socket_path}",
                        file=sys.stderr,
                    )
                server.serve_unix(socket_path)
        finally:
            server._drain_batcher()
            for signum, prev in previous.items():
                try:
                    signal.signal(signum, prev)
                except (ValueError, OSError):
                    pass
            # Graceful shutdown compacts the journal and writes the clean
            # marker — the exact step a SIGKILL cannot take, which is how
            # the next start detects it.
            if journal is not None:
                journal.close()
            # Final metrics sample (baseline + final bracket even the
            # shortest run), then the Chrome artifact, exactly once.
            metrics.close()
            reqtrace.close()
            stats = server.stats_snapshot()
            tel.gauge("serving.requests_total",
                      stats["requests"]["admitted"])
            tel.gauge("serving.shed_total", stats["requests"]["shed"])
            if not quiet:
                reqs = stats["requests"]
                print(
                    f"serve: drained ({server.drain_reason or 'eof'}): "
                    f"{reqs['completed']} completed, {reqs['shed']} shed, "
                    f"{reqs['batches']} batch(es), occupancy "
                    f"{reqs['occupancy']}",
                    file=sys.stderr,
                )
                served = server.kernel_launches_since_ready()
                print(f"serve: kernel launches since ready "
                      f"{json.dumps(served, sort_keys=True)}",
                      file=sys.stderr)
    return 0
