"""The perf-regression gate: ``profile-diff``.

The port's copy of ``music_analyst_tpu/profiling/diff.py``.  Compares two
runs — each a ``run_manifest.json`` (of either package), a bench JSON
line, or a ``BENCH_r*.json`` bench capture — and exits nonzero on
regression, so a script can gate on perf instead of eyeballing it.

What counts as a regression (each guarded by its own threshold):

* **throughput** (bench lines): B's ``value`` dropping more than
  ``threshold`` below A's,
* **wall** (manifests): B's ``wall_seconds`` growing more than
  ``wall_threshold`` over A's,
* **recompiles** (manifests, informational by default): B recompiling
  where A did not usually explains the wall regression; always printed
  (the port compiles no programs, so its manifests read 0).

Exit codes: 0 = within thresholds, 1 = regression, 2 = unusable input
(missing file, no comparable metric — a gate must fail loudly, not pass
vacuously).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple


def _parse_payload(payload: Dict[str, Any], origin: str) -> Dict[str, Any]:
    """Normalize one loaded JSON object into a comparable record."""
    # Bench capture ({"n", "cmd", "rc", "tail", "parsed"}): unwrap.
    if "parsed" in payload and "rc" in payload:
        parsed = payload.get("parsed")
        if not isinstance(parsed, dict):
            raise ValueError(
                f"{origin}: bench capture has no parsed bench line "
                f"(rc={payload.get('rc')})"
            )
        return _parse_payload(parsed, origin)
    if "metric" in payload and "value" in payload:
        return {
            "kind": "bench",
            "origin": origin,
            "metric": payload["metric"],
            "value": float(payload["value"]),
            "unit": payload.get("unit"),
            "error": payload.get("error"),
        }
    if "wall_seconds" in payload and "schema" in payload:
        counters = payload.get("counters") or {}
        compile_info = payload.get("compile") or {}
        return {
            "kind": "manifest",
            "origin": origin,
            "engine": payload.get("engine"),
            "wall_seconds": float(payload["wall_seconds"]),
            "compile_seconds": float(compile_info.get("seconds") or 0.0),
            "compile_count": int(compile_info.get("count") or 0),
            "recompiles": int(counters.get("profiling.recompiles", 0)),
            "collective_bytes": int(
                counters.get("collectives.total_bytes", 0)
            ),
        }
    raise ValueError(
        f"{origin}: neither a bench line, a bench capture, nor a "
        "run manifest (keys: " + ", ".join(sorted(payload)[:8]) + ")"
    )


def load_metrics(source: str) -> Dict[str, Any]:
    """Load + normalize one comparand: a file path or a literal JSON line."""
    text: Optional[str] = None
    if os.path.exists(source):
        with open(source, "r", encoding="utf-8") as fh:
            text = fh.read()
        origin = source
    else:
        text = source
        origin = "<inline json>"
    try:
        payload = json.loads(text)
    except json.JSONDecodeError as exc:
        raise ValueError(f"{origin}: not JSON ({exc})") from exc
    if not isinstance(payload, dict):
        raise ValueError(f"{origin}: expected a JSON object")
    return _parse_payload(payload, origin)


def compare(
    a: Dict[str, Any],
    b: Dict[str, Any],
    threshold: float = 0.1,
    wall_threshold: float = 0.25,
) -> Tuple[bool, list]:
    """Returns ``(regressed, report_lines)`` for two normalized records."""
    lines = []
    regressed = False
    if a["kind"] != b["kind"]:
        raise ValueError(
            f"cannot compare a {a['kind']} against a {b['kind']} "
            f"({a['origin']} vs {b['origin']})"
        )
    if a["kind"] == "bench":
        if a.get("metric") != b.get("metric"):
            raise ValueError(
                f"metric mismatch: {a.get('metric')} vs {b.get('metric')}"
            )
        va, vb = a["value"], b["value"]
        if va <= 0:
            raise ValueError(
                f"{a['origin']}: baseline value {va} is not a usable "
                "throughput" + (f" (error: {a['error']})" if a.get("error")
                                else "")
            )
        ratio = vb / va
        drop = 1.0 - ratio
        verdict = "REGRESSION" if drop > threshold else "ok"
        regressed = drop > threshold
        lines.append(
            f"throughput {a['metric']}: {va:.1f} -> {vb:.1f} "
            f"({ratio:.3f}x, threshold -{threshold:.0%}) {verdict}"
        )
        if b.get("error"):
            lines.append(f"  note: B carries an error: {b['error']}")
    else:
        wa, wb = a["wall_seconds"], b["wall_seconds"]
        if wa > 0:
            growth = wb / wa - 1.0
            verdict = "REGRESSION" if growth > wall_threshold else "ok"
            regressed |= growth > wall_threshold
            lines.append(
                f"wall_seconds: {wa:.3f} -> {wb:.3f} "
                f"({growth:+.1%}, threshold +{wall_threshold:.0%}) {verdict}"
            )
        else:
            lines.append(f"wall_seconds: {wa:.3f} -> {wb:.3f} (no baseline)")
        lines.append(
            f"compile: {a['compile_count']} compiles/"
            f"{a['compile_seconds']:.2f}s -> {b['compile_count']}/"
            f"{b['compile_seconds']:.2f}s"
        )
        ra, rb = a["recompiles"], b["recompiles"]
        if rb > ra:
            lines.append(
                f"recompiles: {ra} -> {rb} "
                "(new recompile activity — likely shape instability)"
            )
        else:
            lines.append(f"recompiles: {ra} -> {rb}")
        ca, cb = a["collective_bytes"], b["collective_bytes"]
        if ca or cb:
            lines.append(f"collective bytes/device: {ca} -> {cb}")
    return regressed, lines


def run_profile_diff(
    a_source: str,
    b_source: str,
    threshold: float = 0.1,
    wall_threshold: float = 0.25,
) -> int:
    """CLI entry: compare A (baseline) against B (candidate)."""
    import sys

    try:
        a = load_metrics(a_source)
        b = load_metrics(b_source)
        regressed, lines = compare(
            a, b, threshold=threshold, wall_threshold=wall_threshold
        )
    except ValueError as exc:
        print(f"profile-diff: {exc}", file=sys.stderr)
        return 2
    print(f"A: {a['origin']} ({a['kind']})")
    print(f"B: {b['origin']} ({b['kind']})")
    for line in lines:
        print(line)
    print("verdict:", "REGRESSION" if regressed else "ok")
    return 1 if regressed else 0
