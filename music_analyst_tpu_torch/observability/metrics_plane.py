"""Fleet metrics plane: windowed time-series + SLO burn-rate alerting.

Counterpart of ``music_analyst_tpu/observability/metrics_plane.py``, copied with its imports
renamed; the port keeps its own copy.

Request traces (``telemetry/reqtrace.py``) answer *why one request* was slow; this module is
the macro half — a continuous, windowed record of every serving signal
the fleet already computes (queue depth, TPOT/TTFT EWMAs, sheds by
reason, page-pool occupancy, prefix-cache hit rate, speculation
acceptance, journal fsync latency, respawns) so a burn-rate alert can
say *the fleet* is eating its error budget, and point at the trace that
shows why.

**Sampling.**  :class:`MetricsPlane` owns a daemon timer that, every
``--metrics-interval-ms`` (``$MUSICAAL_METRICS_INTERVAL_MS``; default
off — zero wire effect when disabled), scrapes one stats snapshot from
its attached source (``SentimentServer.stats_snapshot`` — the same dict
the ``stats`` wire op returns), flattens it into dotted scalar keys, and
appends the sample to a bounded ring.  Each sample also lands as one
crash-safe O_APPEND line in ``<profile-dir>/metrics.jsonl`` (the same
single-``write`` discipline as ``request_traces.jsonl`` — multi-process
safe, never torn) and refreshes a Prometheus-style text exposition file
(``metrics.<pid>.prom``, atomic replace).

**Fleet merge.**  The replica router's existing stats poll doubles as
the fleet scraper: every poll reply is fed to :meth:`ingest_replica`,
which keeps a per-replica breakdown and merges the fresh replicas into
one fleet view — histograms merged *exactly* (bucket counts, totals and
min/max fold; quantiles re-derived from the merged buckets), rates and
counters summed.  A failed scrape (fault site ``metrics.scrape``) marks
that replica's series stale and bumps ``scrape_errors``; stale replicas
are excluded from the fleet merge and serving replies are never
affected — the same degrade-don't-die contract as every other seam.

**Burn-rate alerts.**  Multi-window SLO burn: over a fast (1 min) and a
slow (10 min) window the plane differences the cumulative per-tenant
shed ledger and the decode TTFT/TPOT miss counters, normalises by the
offered load, and divides by the error budget (1%).  An alert fires
only when BOTH windows burn above the fast-burn threshold (14× budget —
the SRE page threshold) and resolves only when the fast window drops
below half of it: hysteresis, so steady state stays silent and a
recovering fleet doesn't flap.  Fired alerts are structured records on
``metrics.jsonl`` carrying the ``trace_id`` of the kept request-trace exemplar
nearest the breach, so "the SLO is burning" dereferences to an actual
request waterfall.

Host-side only, no device imports.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_METRICS_INTERVAL_MS = 0.0  # off: zero wire effect, no thread
METRICS_FILE = "metrics.jsonl"

_ENV_INTERVAL = "MUSICAAL_METRICS_INTERVAL_MS"
_ENV_DIR = "MUSICAAL_METRICS_DIR"

# Ring bound: at a 1 s interval this holds ~68 min of series — the slow
# burn window (10 min) always fits; beyond the bound the OLDEST sample
# is evicted and counted, never silently.
_MAX_SAMPLES = 4096
# Alert history kept in memory (the JSONL file holds everything).
_MAX_ALERTS = 256
# Flatten recursion guard: stats snapshots are shallow; a pathological
# self-referencing payload must not wedge the sampler.
_MAX_DEPTH = 8

# Burn-rate calibration (SRE multi-window, multi-burn paging alert):
# error budget 1% of offered load; page when BOTH windows burn at >= 14x
# budget; resolve when the fast window falls under half the threshold.
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0
SLO_BUDGET = 0.01
BURN_FIRE = 14.0
BURN_RESOLVE = BURN_FIRE / 2.0


def resolve_metrics_interval_ms(value: Optional[Any] = None) -> float:
    """Sampling interval in ms: explicit flag > $MUSICAAL_METRICS_INTERVAL_MS
    > 0 (off).  A malformed/negative explicit flag raises (usage error);
    a malformed env var falls back to off, like every other serving
    ``resolve_*`` knob (serving/batcher.py)."""
    if value is not None:
        try:
            interval = float(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"--metrics-interval-ms expects a number >= 0, got {value!r}"
            ) from None
        if not math.isfinite(interval) or interval < 0.0:
            raise ValueError(
                f"--metrics-interval-ms expects a number >= 0, got {value!r}"
            )
        return interval
    raw = os.environ.get(_ENV_INTERVAL, "").strip()
    if raw:
        try:
            interval = float(raw)
        except ValueError:
            return DEFAULT_METRICS_INTERVAL_MS
        if math.isfinite(interval) and interval >= 0.0:
            return interval
    return DEFAULT_METRICS_INTERVAL_MS


def resolve_metrics_dir(value: Optional[str] = None) -> Optional[str]:
    """Series output directory: explicit (``--profile-dir``) >
    $MUSICAAL_METRICS_DIR > $MUSICAAL_TRACE_DIR (one profile dir feeds
    both planes) > None (in-memory ring only)."""
    if value:
        return value
    return (os.environ.get(_ENV_DIR)
            or os.environ.get("MUSICAAL_TRACE_DIR") or None)


# ----------------------------------------------------------- flattening


def _is_histogram(value: Any) -> bool:
    return (isinstance(value, dict)
            and isinstance(value.get("buckets_le"), list)
            and isinstance(value.get("counts"), list)
            and len(value["counts"]) == len(value["buckets_le"]))


def flatten_stats(
    snap: Any, prefix: str = "",
    out: Optional[Dict[str, float]] = None,
    hists: Optional[Dict[str, Dict[str, Any]]] = None,
    depth: int = 0,
) -> Tuple[Dict[str, float], Dict[str, Dict[str, Any]]]:
    """A stats snapshot → (dotted scalar series, histogram dicts).

    Numeric leaves keep their dotted path (``requests.rates.req_s``,
    ``slo.tenants.gold.shed``); bools count as 0/1; strings, lists and
    None are dropped (the series is numbers only).  Histogram-shaped
    dicts (``telemetry.core.Histogram.as_dict``) are captured whole for
    the exact fleet merge AND have their scalar summary fields (count,
    sum_s, p50_s, …) flattened like everything else.
    """
    if out is None:
        out = {}
    if hists is None:
        hists = {}
    if depth > _MAX_DEPTH or not isinstance(snap, dict):
        return out, hists
    for key, value in snap.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, bool):
            out[path] = float(value)
        elif isinstance(value, (int, float)):
            if math.isfinite(value):
                out[path] = float(value)
        elif isinstance(value, dict):
            if _is_histogram(value):
                hists[path] = value
            flatten_stats(value, path, out, hists, depth + 1)
    return out, hists


# ----------------------------------------------------- exact fleet merge


def _bucket_quantile(
    buckets_le: List[Any], counts: List[int], q: float
) -> Optional[float]:
    """Upper-bound quantile estimate from merged bucket counts: the
    bound of the first bucket whose cumulative count reaches ``q``.
    The overflow bin reports the histogram's max (the only finite bound
    we have for it)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    seen = 0
    for bound, count in zip(buckets_le, counts):
        seen += count
        if seen >= rank:
            return None if bound == "inf" else float(bound)
    return None


def merge_histograms(
    hists: List[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """Exact merge of same-bucket histogram dicts: counts summed
    elementwise, count/sum summed, min/max folded — every value each
    process observed is accounted for exactly.  Quantiles are re-derived
    from the merged buckets (upper-bound estimates; the per-process
    reservoirs cannot be merged exactly and are not pretended to be).
    Mismatched bucket layouts refuse to merge (None)."""
    hists = [h for h in hists if _is_histogram(h)]
    if not hists:
        return None
    buckets = hists[0]["buckets_le"]
    if any(h["buckets_le"] != buckets for h in hists[1:]):
        return None
    counts = [0] * len(buckets)
    total = 0.0
    n = 0
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    for h in hists:
        for i, c in enumerate(h["counts"]):
            counts[i] += int(c)
        n += int(h.get("count") or 0)
        total += float(h.get("sum_s") or 0.0)
        for src, fold in (("min_s", min), ("max_s", max)):
            v = h.get(src)
            if isinstance(v, (int, float)):
                prev = vmin if src == "min_s" else vmax
                folded = v if prev is None else fold(prev, v)
                if src == "min_s":
                    vmin = folded
                else:
                    vmax = folded
    out: Dict[str, Any] = {
        "buckets_le": list(buckets),
        "counts": counts,
        "count": n,
        "sum_s": round(total, 9),
    }
    if n:
        if vmin is not None:
            out["min_s"] = round(vmin, 9)
        if vmax is not None:
            out["max_s"] = round(vmax, 9)
        out["avg_s"] = round(total / n, 9)
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            est = _bucket_quantile(buckets, counts, q)
            if est is None and vmax is not None:
                est = vmax  # overflow bin: max is the only finite bound
            out[f"{name}_s"] = None if est is None else round(est, 9)
    return out


# Leaf names that add across replicas: monotonic counters and capacity/
# depth gauges (two replicas each holding 3 queued requests ARE 6
# queued requests fleet-wide).  Everything else (EWMAs, ratios,
# quantiles, configuration) stays per-replica only — averaging them
# would invent numbers no process measured.
_SUM_LEAVES = frozenset((
    "admitted", "shed", "completed", "failed", "batches", "rows",
    "padded_rows", "dedup_folded", "queue_depth", "queue_depth_max",
    "shed_queue_full", "shed_slo_unattainable", "shed_tenant_budget",
    "shed_evicted", "sheds", "preemptions", "resumes", "requeues",
    "requeued", "dispatched", "respawns", "respawned", "in_flight",
    "ttft_slo_misses", "tpot_slo_misses", "active_slots", "free_slots",
    "prefill_backlog", "pages_free", "pages_total", "scrape_errors",
    "trace_drops", "flushed", "tail_kept", "started", "discarded",
    "fsyncs", "appended", "replayed", "dispatches", "fallbacks",
    "plain_ticks", "count",
))

# Engine-ledger merge (serving.decode.ledger): attribution seconds and
# per-tenant chip-seconds are additive chip-time across replicas, so
# every leaf under these subtrees sums; the scalar ledger counters sum
# by leaf name.  Fractions/coverage/goodput stay per-replica (they'd be
# meaningless added) — recompute fleet fractions from the merged
# seconds against the merged engine_wall_s.
_LEDGER_SUM_SUBTREES = (
    ".ledger.seconds.", ".ledger.chip_seconds.", ".ledger.prefill_chunks.",
)
_LEDGER_SUM_LEAVES = frozenset((
    "ticks", "idle_ticks", "engine_wall_s", "tokens_committed",
    "flushes", "ledger_drops",
))


def _summable(key: str) -> bool:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "window_s":
        return False
    dotted = f".{key}."
    if ".rates." in dotted:
        return True  # req_s / tokens_s / shed_s fleet rate = sum
    if ".ledger." in dotted:
        if any(sub in dotted for sub in _LEDGER_SUM_SUBTREES):
            return True
        return leaf in _LEDGER_SUM_LEAVES
    return leaf in _SUM_LEAVES


def merge_flat(flats: List[Dict[str, float]]) -> Dict[str, float]:
    """Fleet view of per-replica scalar series: summable leaves (rates,
    counters, depths — see ``_SUM_LEAVES``) added across replicas."""
    fleet: Dict[str, float] = {}
    for flat in flats:
        for key, value in flat.items():
            if _summable(key):
                fleet[key] = fleet.get(key, 0.0) + value
    return {k: round(v, 6) for k, v in fleet.items()}


# --------------------------------------------------------------- plane


class MetricsPlane:
    """Per-process ring-buffer time-series store + burn-rate alerting."""

    def __init__(self, interval_ms: float = 0.0,
                 directory: Optional[str] = None,
                 role: str = "server",
                 max_samples: int = _MAX_SAMPLES) -> None:
        self.interval_ms = float(interval_ms)
        self.directory = directory
        self.role = role
        self.enabled = self.interval_ms > 0.0
        self.path = (
            os.path.join(directory, METRICS_FILE) if directory else None
        )
        self.prom_path = (
            os.path.join(directory, f"metrics.{os.getpid()}.prom")
            if directory else None
        )
        self.max_samples = int(max_samples)
        self.stale = False  # last local scrape failed
        self._source: Optional[Callable[[], Dict[str, Any]]] = None
        self._lock = threading.Lock()
        self._series: "deque[Dict[str, Any]]" = deque()
        self._hists: Dict[str, Dict[str, Any]] = {}
        self._replicas: Dict[str, Dict[str, Any]] = {}
        self._alert_state: Dict[Tuple[str, str], bool] = {}
        self._alerts: List[Dict[str, Any]] = []
        self._stats = {
            "samples": 0, "evicted": 0, "scrape_errors": 0,
            "flush_errors": 0, "alerts_fired": 0, "alerts_resolved": 0,
        }
        self._cost_ewma_s = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._closed = False

    # ---------------------------------------------------------- lifecycle

    def attach(self, source: Callable[[], Dict[str, Any]]) -> None:
        """Install the stats source (``SentimentServer.stats_snapshot``
        or any zero-arg callable returning a stats-shaped dict)."""
        self._source = source

    def start(self) -> None:
        """Take a baseline sample and start the interval timer.  The
        baseline makes the very first window delta well-defined even
        when the run is shorter than one interval."""
        if not self.enabled or self._thread is not None:
            return
        self.sample_now()
        self._thread = threading.Thread(
            target=self._run, name="metrics-plane", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        interval_s = self.interval_ms / 1000.0
        while not self._stop_evt.wait(interval_s):
            self.sample_now()

    def close(self) -> None:
        """End of serving: stop the timer and take one final sample so
        short runs still land a complete series (baseline + final)."""
        if self._closed:
            return
        self._closed = True
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.enabled:
            self.sample_now()

    # ----------------------------------------------------------- sampling

    def sample_now(self) -> Optional[Dict[str, Any]]:
        """One scrape: snapshot → flatten → ring + JSONL + exposition +
        alert evaluation.  A failed scrape (fault site
        ``metrics.scrape``) degrades to a stale-marked series and a
        counted ``scrape_errors`` — nothing is written, the file is
        never torn, and serving is never touched."""
        if self._source is None:
            return None
        t0 = time.perf_counter()
        try:
            from music_analyst_tpu_torch.resilience.faults import fault_point

            fault_point("metrics.scrape", role=self.role)
            flat, hists = flatten_stats(self._source())
        except Exception:
            with self._lock:
                self._stats["scrape_errors"] += 1
            self.stale = True
            return None
        self.stale = False
        sample = {
            "type": "sample",
            "t": round(time.time(), 6),
            "pid": os.getpid(),
            "role": self.role,
            "metrics": flat,
        }
        with self._lock:
            if len(self._series) >= self.max_samples:
                self._series.popleft()
                self._stats["evicted"] += 1
            self._series.append(sample)
            self._stats["samples"] += 1
            self._hists = hists
        alerts = self._evaluate_alerts(sample)
        self._append_line(sample)
        for record in alerts:
            self._append_line(record)
        self._write_prom(flat, hists)
        cost = time.perf_counter() - t0
        self._cost_ewma_s = (
            cost if self._cost_ewma_s == 0.0
            else 0.8 * self._cost_ewma_s + 0.2 * cost
        )
        return sample

    def _append_line(self, record: Dict[str, Any]) -> None:
        """One appended write per record — same multi-process-safe
        discipline as ``reqtrace._flush``; a failure degrades to a
        counted ``flush_errors``, never a raise."""
        if self.path is None:
            return
        try:
            os.makedirs(self.directory, exist_ok=True)
            line = json.dumps(record, separators=(",", ":"), default=str)
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, (line + "\n").encode("utf-8"))
            finally:
                os.close(fd)
        except Exception:  # noqa: BLE001 — degrade, don't die
            with self._lock:
                self._stats["flush_errors"] += 1

    def _write_prom(self, flat: Dict[str, float],
                    hists: Dict[str, Dict[str, Any]]) -> None:
        """Prometheus text exposition, atomically replaced per sample."""
        if self.prom_path is None:
            return
        lines: List[str] = []
        for key in sorted(flat):
            name = _prom_name(key)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {flat[key]:g}")
        for key in sorted(hists):
            hist = hists[key]
            name = _prom_name(key)
            lines.append(f"# TYPE {name} histogram")
            cumulative = 0
            for bound, count in zip(hist["buckets_le"], hist["counts"]):
                cumulative += int(count)
                le = "+Inf" if bound == "inf" else f"{float(bound):g}"
                lines.append(f'{name}_bucket{{le="{le}"}} {cumulative}')
            lines.append(f"{name}_sum {float(hist.get('sum_s') or 0.0):g}")
            lines.append(f"{name}_count {int(hist.get('count') or 0)}")
        try:
            tmp = f"{self.prom_path}.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write("\n".join(lines) + "\n")
            os.replace(tmp, self.prom_path)
        except Exception:  # noqa: BLE001 — degrade, don't die
            with self._lock:
                self._stats["flush_errors"] += 1

    # -------------------------------------------------------- fleet merge

    def ingest_replica(self, name: str, stats: Any) -> None:
        """One replica's stats-poll reply → its series slot.  The
        router's poll loop is the fleet scraper; a scrape that trips the
        fault site (or hands back junk) marks the replica stale and
        counts ``scrape_errors`` — it never touches dispatch."""
        try:
            from music_analyst_tpu_torch.resilience.faults import fault_point

            fault_point("metrics.scrape", replica=name)
            if not isinstance(stats, dict):
                raise TypeError(f"replica {name} stats: {type(stats)!r}")
            flat, hists = flatten_stats(stats)
        except Exception:
            with self._lock:
                self._stats["scrape_errors"] += 1
                entry = self._replicas.setdefault(name, {})
                entry["stale"] = True
            return
        with self._lock:
            self._replicas[name] = {
                "stale": False,
                "t": round(time.time(), 6),
                "flat": flat,
                "hists": hists,
            }

    def mark_replica_stale(self, name: str) -> None:
        """A replica the router already knows is unreachable (dead
        socket, respawning) keeps its last series, marked stale."""
        with self._lock:
            entry = self._replicas.setdefault(name, {})
            entry["stale"] = True

    def fleet_snapshot(self) -> Dict[str, Any]:
        """Fleet-level merge with per-replica breakdown.  Stale replicas
        are listed but EXCLUDED from the merged view — a dead replica's
        frozen counters must not be double-counted as live capacity."""
        with self._lock:
            replicas = {
                name: dict(entry) for name, entry in self._replicas.items()
            }
        fresh = {
            name: entry for name, entry in replicas.items()
            if not entry.get("stale") and entry.get("flat") is not None
        }
        hist_keys = sorted({
            key for entry in fresh.values()
            for key in (entry.get("hists") or {})
        })
        merged_hists = {}
        for key in hist_keys:
            merged = merge_histograms([
                entry["hists"][key] for entry in fresh.values()
                if key in (entry.get("hists") or {})
            ])
            if merged is not None:
                merged_hists[key] = merged
        return {
            "replica_count": len(replicas),
            "fresh_count": len(fresh),
            "stale": sorted(
                name for name, entry in replicas.items()
                if entry.get("stale")
            ),
            "merged": merge_flat(
                [entry["flat"] for entry in fresh.values()]
            ),
            "histograms": merged_hists,
            "replicas": {
                name: {
                    "stale": bool(entry.get("stale")),
                    "t": entry.get("t"),
                    "metrics": entry.get("flat") or {},
                }
                for name, entry in replicas.items()
            },
        }

    # ------------------------------------------------- burn-rate alerting

    def _window_burn(self, bad_key: str, total_keys: List[str],
                     window_s: float, now: float) -> float:
        """Burn rate over one window: (Δbad / Δoffered) / budget, from
        the cumulative counters in the ring.  Caller holds no lock."""
        with self._lock:
            series = list(self._series)
        if len(series) < 2:
            return 0.0
        cutoff = now - window_s
        base = series[0]
        for sample in series:
            if sample["t"] >= cutoff:
                base = sample
                break
        newest = series[-1]
        if base is newest:
            return 0.0

        def delta(key: str) -> float:
            return max(
                (newest["metrics"].get(key) or 0.0)
                - (base["metrics"].get(key) or 0.0),
                0.0,
            )

        bad = delta(bad_key)
        total = sum(delta(k) for k in total_keys)
        if total <= 0.0:
            return 0.0
        return (bad / total) / SLO_BUDGET

    def _signals(self, flat: Dict[str, float]) -> List[Dict[str, Any]]:
        """The burn signals live in this sample: one per tenant ledger
        (shed rate) plus the fleet-level decode TTFT/TPOT miss rates."""
        signals: List[Dict[str, Any]] = []
        for key in flat:
            m = re.fullmatch(r"slo\.tenants\.(.+)\.shed", key)
            if m:
                tenant = m.group(1)
                signals.append({
                    "alert": "shed_burn_rate",
                    "tenant": tenant,
                    "bad": key,
                    "total": [key, f"slo.tenants.{tenant}.admitted"],
                })
        for alert, bad in (("ttft_slo_burn", "decode.ttft_slo_misses"),
                           ("tpot_slo_burn", "decode.tpot_slo_misses")):
            if bad in flat:
                signals.append({
                    "alert": alert,
                    "tenant": None,
                    "bad": bad,
                    "total": ["requests.admitted"],
                })
        return signals

    def _evaluate_alerts(
        self, sample: Dict[str, Any]
    ) -> List[Dict[str, Any]]:
        """Multi-window evaluation with hysteresis: fire when both the
        fast and slow windows burn >= BURN_FIRE, resolve when the fast
        window falls under BURN_RESOLVE.  Returns the records to flush
        (the caller appends them after the sample line)."""
        now = sample["t"]
        records: List[Dict[str, Any]] = []
        for sig in self._signals(sample["metrics"]):
            fast = self._window_burn(
                sig["bad"], sig["total"], FAST_WINDOW_S, now
            )
            slow = self._window_burn(
                sig["bad"], sig["total"], SLOW_WINDOW_S, now
            )
            key = (sig["alert"], sig["tenant"] or "")
            active = self._alert_state.get(key, False)
            if not active and fast >= BURN_FIRE and slow >= BURN_FIRE:
                self._alert_state[key] = True
                records.append(
                    self._alert_record(sig, "firing", fast, slow, now)
                )
            elif active and fast < BURN_RESOLVE:
                self._alert_state[key] = False
                records.append(
                    self._alert_record(sig, "resolved", fast, slow, now)
                )
        if records:
            with self._lock:
                for record in records:
                    if record["state"] == "firing":
                        self._stats["alerts_fired"] += 1
                    else:
                        self._stats["alerts_resolved"] += 1
                    self._alerts.append(record)
                if len(self._alerts) > _MAX_ALERTS:
                    del self._alerts[: len(self._alerts) - _MAX_ALERTS]
        return records

    def _alert_record(self, sig: Dict[str, Any], state: str,
                      fast: float, slow: float,
                      now: float) -> Dict[str, Any]:
        record: Dict[str, Any] = {
            "type": "alert",
            "schema": 1,
            "alert": sig["alert"],
            "state": state,
            "severity": "page",
            "t": round(now, 6),
            "pid": os.getpid(),
            "role": self.role,
            "tenant": sig["tenant"],
            "burn_fast": round(fast, 3),
            "burn_slow": round(slow, 3),
            "threshold": BURN_FIRE,
            "budget": SLO_BUDGET,
            "window_fast_s": FAST_WINDOW_S,
            "window_slow_s": SLOW_WINDOW_S,
        }
        # Join to the request traces: the kept trace exemplar nearest the breach —
        # "the SLO is burning" comes with a waterfall to pull.
        try:
            from music_analyst_tpu_torch.telemetry.reqtrace import get_reqtrace

            exemplar = get_reqtrace().nearest_kept(now)
            if exemplar:
                record["trace_id"] = exemplar["trace_id"]
                record["trace_kept"] = exemplar["kept"]
        except Exception:  # noqa: BLE001 — alerting must not raise
            pass
        return record

    # ----------------------------------------------------------- readouts

    def alerts(self, active_only: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            alerts = list(self._alerts)
            state = dict(self._alert_state)
        if not active_only:
            return alerts
        active = {key for key, on in state.items() if on}
        return [
            a for a in alerts
            if a["state"] == "firing"
            and (a["alert"], a["tenant"] or "") in active
        ]

    def overhead_fraction(self) -> Optional[float]:
        """Measured sampling cost as a fraction of the interval — the
        plane's whole decode-path overhead (sampling runs off-path; the
        only shared cost is the source's stats locks)."""
        if not self.enabled or self._cost_ewma_s == 0.0:
            return None
        return self._cost_ewma_s / (self.interval_ms / 1000.0)

    def series(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._series)

    def snapshot(self) -> Dict[str, Any]:
        """The ``metrics`` section of the ``stats`` op and the run
        manifest: counters, the newest sample, active alerts, and the
        fleet merge when this process scrapes replicas."""
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            newest = self._series[-1] if self._series else None
            series_len = len(self._series)
            have_replicas = bool(self._replicas)
        out.update(
            interval_ms=self.interval_ms,
            role=self.role,
            stale=self.stale,
            series_len=series_len,
            path=self.path,
        )
        overhead = self.overhead_fraction()
        if overhead is not None:
            out["overhead_fraction"] = round(overhead, 6)
        if newest is not None:
            out["last"] = newest
        active = self.alerts(active_only=True)
        if active:
            out["active_alerts"] = active
        if have_replicas:
            out["fleet"] = self.fleet_snapshot()
        return out


def _prom_name(key: str) -> str:
    return "musicaal_" + re.sub(r"[^a-zA-Z0-9_]", "_", key)


# ------------------------------------------------------- process registry

_DISABLED = MetricsPlane()
_PLANE: MetricsPlane = _DISABLED


def get_metrics_plane() -> MetricsPlane:
    return _PLANE


def configure_metrics(
    interval_ms: Optional[Any] = None,
    directory: Optional[str] = None,
    role: str = "server",
) -> MetricsPlane:
    """Install the process plane.  When enabled, the resolved interval
    and directory are exported to the environment so spawned replica
    workers inherit the fleet's metrics configuration without extra
    plumbing — the same contract as ``configure_reqtrace``."""
    global _PLANE
    resolved_interval = resolve_metrics_interval_ms(interval_ms)
    resolved_dir = resolve_metrics_dir(directory)
    _PLANE.close()
    plane = MetricsPlane(resolved_interval, resolved_dir, role=role)
    if plane.enabled:
        os.environ[_ENV_INTERVAL] = repr(resolved_interval)
        if resolved_dir:
            os.environ[_ENV_DIR] = resolved_dir
    _PLANE = plane
    return plane
