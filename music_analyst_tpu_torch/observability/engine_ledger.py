"""Engine goodput ledger: per-tick decode timeline + occupancy accounting.

Counterpart of ``music_analyst_tpu/observability/engine_ledger.py``, copied with its imports
renamed; the port keeps its own copy.

Request traces answer *why one request* was slow and the metrics plane
says *the fleet* is
burning its SLO budget — this module answers "what is the *chip* doing?"
Every continuous-scheduler tick's wall time is classified into an
exhaustive attribution set that tiles to ~100% of engine wall:

* ``decode_useful``   — committed-token verify/decode dispatch time;
* ``prefill``         — prompt-chunk dispatch time (chunk counters split
  shared-hit vs cold alongside);
* ``spec_waste``      — drafted-but-rejected verify work (the slice of a
  verify dispatch whose rows produced no committed token);
* ``preempt_overhead``— checkpoint/restore/steal bookkeeping;
* ``host_gap``        — scheduler/readback host time between dispatches
  (the residual of an occupied tick);
* ``idle_bubble``     — ticks and loop waits with every slot empty.

The ledger keeps a running cursor so inter-tick gaps are attributed too
(to ``host_gap`` when the engine is occupied, ``idle_bubble`` when not):
bucket seconds sum to the engine wall span by construction.  Per-tenant
chip-seconds accumulate the same way — each accounted second lands on
the tenants occupying slots at that instant (slot-share split), or on
the reserved ``(idle)`` tenant — so tenant chip-seconds also sum to
engine wall, the cost-attribution number the SLO ledgers were missing.

Recording is always on: the hot path is a handful of float adds under
one lock, no device work, no readbacks, no per-tick allocation (a reused
scratch dict for tenant shares).  The ledger measures its *own* cost
(``overhead_fraction``) so the ≤1% claim is a reported number, not a
promise.  Flushing rides the metrics-plane cadence: every
``$MUSICAAL_LEDGER_INTERVAL_MS`` (default: the metrics interval) one
cumulative snapshot lands as a crash-safe O_APPEND line in
``<profile-dir>/engine_ledger.jsonl`` — single-``write`` discipline,
never torn; a flush failure (fault site ``ledger.flush``) degrades to a
counted ``ledger_drops``, never a failed reply.

Host-side only, no device imports.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

LEDGER_FILE = "engine_ledger.jsonl"
IDLE_TENANT = "(idle)"

_ENV_INTERVAL = "MUSICAAL_LEDGER_INTERVAL_MS"
_ENV_DIR = "MUSICAAL_LEDGER_DIR"

# The exhaustive attribution set — every accounted second lands in
# exactly one class (PERFORMANCE.md "Reading the engine ledger").
CLASSES = (
    "decode_useful",
    "prefill",
    "spec_waste",
    "preempt_overhead",
    "host_gap",
    "idle_bubble",
)


def resolve_ledger_interval_ms(value: Optional[Any] = None) -> float:
    """Flush cadence in ms: explicit flag > $MUSICAAL_LEDGER_INTERVAL_MS
    > the metrics-plane cadence ($MUSICAAL_METRICS_INTERVAL_MS) > 0 (no
    file flush; the in-memory ledger still records).  A malformed
    explicit flag raises; a malformed env var falls back, like every
    other serving ``resolve_*`` knob."""
    if value is not None:
        try:
            interval = float(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"--ledger-interval-ms expects a number >= 0, got {value!r}"
            ) from None
        if not math.isfinite(interval) or interval < 0.0:
            raise ValueError(
                f"--ledger-interval-ms expects a number >= 0, got {value!r}"
            )
        return interval
    raw = os.environ.get(_ENV_INTERVAL, "").strip()
    if raw:
        try:
            interval = float(raw)
        except ValueError:
            interval = None
        if interval is not None and math.isfinite(interval) and interval >= 0.0:
            return interval
    from music_analyst_tpu_torch.observability.metrics_plane import (
        resolve_metrics_interval_ms,
    )

    return resolve_metrics_interval_ms(None)


def resolve_ledger_dir(value: Optional[str] = None) -> Optional[str]:
    """Ledger output directory: explicit (``--profile-dir``) >
    $MUSICAAL_LEDGER_DIR > the metrics/trace profile dir > None (no
    file; the ledger still surfaces through ``stats``)."""
    if value:
        return value
    explicit = os.environ.get(_ENV_DIR)
    if explicit:
        return explicit
    from music_analyst_tpu_torch.observability.metrics_plane import resolve_metrics_dir

    return resolve_metrics_dir(None)


class EngineLedger:
    """Per-tick goodput recorder for one continuous scheduler."""

    def __init__(
        self,
        n_slots: int,
        interval_ms: Optional[Any] = None,
        directory: Optional[str] = None,
        role: str = "server",
    ) -> None:
        self.n_slots = max(1, int(n_slots))
        self.interval_ms = resolve_ledger_interval_ms(interval_ms)
        self.directory = resolve_ledger_dir(directory)
        self.path = (
            os.path.join(self.directory, LEDGER_FILE)
            if self.directory and self.interval_ms > 0.0 else None
        )
        self.role = role
        self._lock = threading.Lock()
        # Attribution accumulators (seconds per class).
        self._s: Dict[str, float] = {c: 0.0 for c in CLASSES}
        # Engine-wall span cursors (perf_counter domain): every instant
        # between _t_first and _cursor is attributed to exactly one
        # class, so bucket fractions tile to ~100% by construction.
        self._t_first: Optional[float] = None
        self._cursor: Optional[float] = None
        self.ticks = 0
        self.idle_ticks = 0
        self.tokens_committed = 0
        self.prefill_chunks_cold = 0
        self.prefill_chunks_shared = 0
        # Per-tenant chip-seconds (IDLE_TENANT collects empty-engine time).
        self._chip: Dict[str, float] = {}
        self._scratch: Dict[str, int] = {}  # reused per tick — no alloc
        # Self-measured recording cost (overhead_fraction).
        self._overhead_s = 0.0
        self.flushes = 0
        self.ledger_drops = 0
        self._t_last_flush = time.monotonic()
        self._occ_source: Optional[Callable[[], Dict[str, Any]]] = None
        self._pid = os.getpid()

    # ------------------------------------------------------------ wiring

    def attach_occupancy(self, fn: Callable[[], Dict[str, Any]]) -> None:
        """Register the (possibly O(pool)) occupancy sampler; called only
        at flush/stats time, never on the per-tick hot path."""
        self._occ_source = fn

    # ------------------------------------------------------------ hot path

    def record_tick(
        self,
        t_start: float,
        t_end: float,
        prefill_s: float = 0.0,
        chunks_cold: int = 0,
        chunks_shared: int = 0,
        decode_s: float = 0.0,
        useful_frac: float = 1.0,
        committed: int = 0,
        preempt_s: float = 0.0,
        slots: Optional[list] = None,
        shares: Optional[Dict[str, int]] = None,
    ) -> None:
        """Account one scheduler tick.  ``shares`` is the tenant→slot-count
        map captured right after admission (borrowed, not copied) — the
        authoritative attribution, since settle frees slots mid-tick.
        ``slots`` is the fallback: the live slot list, tenants read off
        occupied entries at record time."""
        o0 = time.perf_counter()
        with self._lock:
            if self._t_first is None:
                self._t_first = t_start
                self._cursor = t_start
            gap = max(0.0, t_start - self._cursor)
            wall = max(0.0, t_end - t_start)
            self._cursor = max(self._cursor, t_end)
            self.ticks += 1
            self.tokens_committed += committed
            self.prefill_chunks_cold += chunks_cold
            self.prefill_chunks_shared += chunks_shared
            if shares is None:
                # Tenant slot shares (scratch dict reused across ticks).
                shares = self._scratch
                shares.clear()
                if slots:
                    for s in slots:
                        if s is None:
                            continue
                        tenant = s.req.tenant
                        shares[tenant] = shares.get(tenant, 0) + 1
            n_occ = sum(shares.values())
            worked = (
                n_occ > 0 or decode_s > 0.0 or prefill_s > 0.0
                or preempt_s > 0.0 or committed > 0
                or chunks_cold > 0 or chunks_shared > 0
            )
            total = gap + wall
            if not worked:
                self.idle_ticks += 1
                self._s["idle_bubble"] += total
                self._chip[IDLE_TENANT] = (
                    self._chip.get(IDLE_TENANT, 0.0) + total
                )
            else:
                useful_frac = min(1.0, max(0.0, useful_frac))
                useful = decode_s * useful_frac
                self._s["decode_useful"] += useful
                self._s["spec_waste"] += decode_s - useful
                self._s["prefill"] += prefill_s
                self._s["preempt_overhead"] += preempt_s
                self._s["host_gap"] += gap + max(
                    0.0, wall - prefill_s - decode_s - preempt_s
                )
                chip = self._chip
                if n_occ > 0:
                    for tenant, n in shares.items():
                        chip[tenant] = (
                            chip.get(tenant, 0.0) + total * n / n_occ
                        )
                else:
                    # Work with no captured tenant (caller passed no
                    # shares and slots already settled) — keep the
                    # chip-second tiling exact rather than lose the time.
                    chip[IDLE_TENANT] = chip.get(IDLE_TENANT, 0.0) + total
            self._overhead_s += time.perf_counter() - o0

    def idle_wait(self, t_start: float, t_end: float) -> None:
        """Account one empty-engine wait in the threaded loop.  Counts
        from the cursor, not ``t_start``: the loop only waits after an
        empty tick, so the lock-acquisition gap between that tick's end
        and the wait start is idle engine time too — dropping it leaks
        ~100µs per iteration on a contended host."""
        with self._lock:
            if self._t_first is None:
                self._t_first = t_start
                self._cursor = t_start
            total = max(0.0, t_end - self._cursor)
            self._cursor = max(self._cursor, t_end)
            self._s["idle_bubble"] += total
            self._chip[IDLE_TENANT] = self._chip.get(IDLE_TENANT, 0.0) + total

    # ------------------------------------------------------------ reading

    def chip_seconds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._chip)

    def snapshot(self, occupancy: bool = True) -> Dict[str, Any]:
        """The ``serving.decode.ledger`` block: cumulative counters plus
        derived fractions against the engine-wall span."""
        with self._lock:
            wall = (
                (self._cursor - self._t_first)
                if self._t_first is not None else 0.0
            )
            seconds = {c: round(v, 6) for c, v in self._s.items()}
            covered = sum(self._s.values())
            out: Dict[str, Any] = {
                "ticks": self.ticks,
                "idle_ticks": self.idle_ticks,
                "engine_wall_s": round(wall, 6),
                "seconds": seconds,
                "fractions": {
                    c: round(v / wall, 6) if wall > 0.0 else 0.0
                    for c, v in self._s.items()
                },
                "coverage": round(covered / wall, 6) if wall > 0.0 else 0.0,
                "goodput_fraction": (
                    round(self._s["decode_useful"] / wall, 6)
                    if wall > 0.0 else 0.0
                ),
                "tokens_committed": self.tokens_committed,
                "prefill_chunks": {
                    "cold": self.prefill_chunks_cold,
                    "shared_hit": self.prefill_chunks_shared,
                },
                "chip_seconds": {
                    t: round(v, 6) for t, v in sorted(self._chip.items())
                },
                "overhead_fraction": (
                    round(self._overhead_s / wall, 6) if wall > 0.0 else 0.0
                ),
                "interval_ms": self.interval_ms,
                "path": self.path,
                "flushes": self.flushes,
                "ledger_drops": self.ledger_drops,
            }
        if occupancy and self._occ_source is not None:
            try:
                out["occupancy"] = self._occ_source()
            except Exception:  # noqa: BLE001 — a torn sample never raises
                out["occupancy"] = {}
        else:
            out["occupancy"] = {}
        return out

    # ------------------------------------------------------------ flushing

    def maybe_flush(self, force: bool = False) -> bool:
        """Append one cumulative snapshot line when the cadence is due.
        Cheap when idle (one monotonic read); any failure — injected
        (``ledger.flush``) or real — degrades to a counted drop."""
        if self.path is None:
            return False
        now = time.monotonic()
        if not force and (now - self._t_last_flush) * 1000.0 < self.interval_ms:
            return False
        self._t_last_flush = now
        record = {
            "type": "ledger",
            "t": time.time(),
            "pid": self._pid,
            "role": self.role,
            "ledger": self.snapshot(),
        }
        from music_analyst_tpu_torch.resilience.faults import fault_point

        try:
            fault_point("ledger.flush", path=self.path)
            line = json.dumps(
                record, separators=(",", ":"), default=str
            ) + "\n"
            os.makedirs(self.directory, exist_ok=True)
            fd = os.open(
                self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
            )
            try:
                os.write(fd, line.encode("utf-8"))
            finally:
                os.close(fd)
            with self._lock:
                self.flushes += 1
            return True
        except Exception:  # noqa: BLE001 — degrade, never block the loop
            with self._lock:
                self.ledger_drops += 1
            return False

    def close(self) -> None:
        """Final flush on drain so short runs still land one record."""
        if self.path is not None and self.ticks:
            self.maybe_flush(force=True)
