"""Analytic collective-traffic accounting.

The port's copy of ``music_analyst_tpu/profiling/collectives.py``, with
the same formulas, counters, events and stage table.  The collectives are
few and regular — the word-count histogram's merges, the distributed
word count's all-reduces, ring attention's neighbour sends — so the bytes
each participant moves are computable from the participant count and the
payload; no device counters are read.  Estimators follow the standard
ring-algorithm costs per participant:

* all-reduce (``psum``):    ``2 · (N-1)/N · payload``  (reduce-scatter +
  all-gather halves),
* ``all_gather``:           ``(N-1) · shard``  (each participant receives
  every other shard),
* all-to-all:               ``(N-1)/N · payload``  (each keeps its own 1/N),
* ``ppermute``:             ``payload``  (one neighbour send per hop).

:func:`record_collective` turns an estimate into telemetry: cumulative
``collectives.<kind>_bytes`` / ``collectives.total_bytes`` counters (they
land in the run manifest) and one ``collective`` event per call site; the
run scope's end emits the per-stage totals as one
``collective_stage_table`` event (:func:`emit_stage_table`).

No torch import here: estimators are pure arithmetic.
"""

from __future__ import annotations

import threading
from typing import Dict, List


def psum_bytes(payload_bytes: int, n_devices: int) -> int:
    """Ring all-reduce bytes moved per participant."""
    if n_devices <= 1:
        return 0
    return int(2 * (n_devices - 1) * payload_bytes // n_devices)


def all_gather_bytes(shard_bytes: int, n_devices: int) -> int:
    """Bytes received per participant gathering every other shard."""
    if n_devices <= 1:
        return 0
    return int((n_devices - 1) * shard_bytes)


def all_to_all_bytes(payload_bytes: int, n_devices: int) -> int:
    """Bytes sent per participant; 1/N of the payload stays local."""
    if n_devices <= 1:
        return 0
    return int((n_devices - 1) * payload_bytes // n_devices)


def ppermute_bytes(payload_bytes: int) -> int:
    """One neighbour send: the payload itself."""
    return int(payload_bytes)


_ESTIMATORS = {
    "psum": psum_bytes,
    "all_gather": all_gather_bytes,
    "all_to_all": all_to_all_bytes,
}

# Per-stage accumulator behind the "collective_stage_table" event: rows
# keyed by stage name, cleared at each run's end by emit_stage_table.
_STAGE_TOTALS: Dict[str, Dict[str, object]] = {}
_STAGE_LOCK = threading.Lock()


def stage_table() -> List[Dict[str, object]]:
    """Snapshot of per-stage collective totals accumulated so far."""
    with _STAGE_LOCK:
        return [
            {"stage": stage, **row} for stage, row in _STAGE_TOTALS.items()
        ]


def emit_stage_table(reset: bool = True) -> List[Dict[str, object]]:
    """Emit the per-stage table as one ``collective_stage_table`` event.

    The run scope calls this at run end so ``telemetry.jsonl`` carries a
    single table next to the per-call ``collective`` events; ``reset``
    clears the accumulator so back-to-back runs don't bleed rows.
    """
    rows = stage_table()
    if rows:
        from music_analyst_tpu_torch.telemetry import get_telemetry

        get_telemetry().event("collective_stage_table", rows=rows)
    if reset:
        with _STAGE_LOCK:
            _STAGE_TOTALS.clear()
    return rows


def record_collective(
    stage: str,
    kind: str,
    *,
    payload_bytes: int,
    n_devices: int,
    axis: str = "dp",
    count: int = 1,
) -> int:
    """Account one collective call site; returns bytes/participant it moves.

    ``stage`` names the engine stage (the table's row key), ``kind`` is
    ``psum`` | ``all_gather`` | ``all_to_all`` | ``ppermute``; ``count``
    multiplies repeated issues of the same collective (ring hops).
    Disabled telemetry still returns the estimate.
    """
    if kind == "ppermute":
        per_device = ppermute_bytes(payload_bytes)
    else:
        try:
            per_device = _ESTIMATORS[kind](payload_bytes, n_devices)
        except KeyError:
            raise ValueError(
                f"unknown collective kind {kind!r} "
                f"(expected one of {sorted(_ESTIMATORS) + ['ppermute']})"
            )
    total = per_device * count
    from music_analyst_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    tel.count(f"collectives.{kind}_bytes", total)
    tel.count("collectives.total_bytes", total)
    with _STAGE_LOCK:
        row = _STAGE_TOTALS.setdefault(
            stage, {"kind": kind, "axis": axis, "calls": 0, "bytes": 0}
        )
        row["calls"] += count
        row["bytes"] += total
    tel.event(
        "collective",
        stage=stage,
        kind=kind,
        axis=axis,
        devices=n_devices,
        payload_bytes=int(payload_bytes),
        bytes_per_device=per_device,
        count=count,
        total_bytes=total,
    )
    return per_device
