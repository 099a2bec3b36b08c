"""Device-time capture: profiler traces + a span-level Chrome trace.

Counterpart of ``music_analyst_tpu/profiling/trace.py``.  Two
granularities:

* :func:`maybe_trace` / :func:`annotate` — the raw ``torch.profiler``
  capture (per-kernel device time, with the CUDA activity when the run is
  on the card), exported as a Chrome trace into the directory;
* :func:`profile_run` — the ``--profile-dir`` flag's backing: wraps a run
  in the same profiler **and** renders this run's telemetry spans into
  ``<dir>/trace_spans.json``, a self-contained Chrome-trace artifact
  (``chrome://tracing`` / Perfetto) that lands even where the device
  profiler cannot start.

A profiler that fails to start is recorded (:func:`profiler_status`, the
run manifest's ``profiling.profiler``) and the run goes on, on the device
it was given: the profiler never moves a run to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# File name of the device profiler's Chrome trace in a profile/trace dir.
DEVICE_TRACE_FILE = "torch_trace.json"

# The active profile_run's profiler outcome, for the run manifest (the
# registry's per-run context is reset when the run scope opens, inside
# profile_run, so the status lives here).
_PROFILER_STATUS: Optional[Dict[str, Any]] = None


def profiler_status() -> Optional[Dict[str, Any]]:
    """The active ``profile_run``'s profiler outcome, or None."""
    return None if _PROFILER_STATUS is None else dict(_PROFILER_STATUS)


def _activities(device: Optional[str]) -> List[Any]:
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device is not None and str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    return activities


def _start_profiler(device: Optional[str]):
    import torch.profiler

    prof = torch.profiler.profile(activities=_activities(device))
    prof.start()
    return prof


def _stop_profiler(prof, directory: str) -> str:
    prof.stop()
    path = os.path.join(directory, DEVICE_TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str],
                device: Optional[str] = "cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``trace_dir`` when set
    (CUDA activity included when ``device`` is a CUDA device)."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    prof = _start_profiler(device)
    try:
        yield
    finally:
        _stop_profiler(prof, trace_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up on the profiler timeline."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def force_readback(value: Any) -> np.ndarray:
    """Synchronize the value's device, then materialize it on the host.

    The timing barrier: a CUDA tensor's stream is synchronized before the
    clock reads, and its bytes are copied to host memory."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
        return value.detach().cpu().numpy()
    return np.asarray(value)


def spans_to_chrome_trace(tel) -> Dict[str, Any]:
    """Render a registry's recorded spans as Chrome-trace JSON.

    Complete events (``ph: "X"``) on the monotonic clock, one ``tid`` per
    thread name; span attributes ride along in ``args``.  Raw spans cap at
    the registry's in-memory bound, so huge runs render their head — the
    aggregate table in the manifest stays exact.
    """
    with tel._lock:
        spans = list(tel.spans)
    if spans:
        base = min(sp.t_mono for sp in spans)
    else:
        base = 0.0
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        event: Dict[str, Any] = {
            "name": sp.name,
            "ph": "X",
            "ts": round((sp.t_mono - base) * 1e6, 3),
            "dur": round(sp.duration_s * 1e6, 3),
            "pid": 1,
            "tid": tid,
        }
        if sp.attrs:
            event["args"] = {k: str(v) for k, v in sp.attrs.items()}
        events.append(event)
    events.extend(
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": thread}}
        for thread, tid in tids.items()
    )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tel, path: str) -> str:
    payload = spans_to_chrome_trace(tel)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
        fh.write("\n")
    return path


@contextlib.contextmanager
def profile_run(profile_dir: Optional[str],
                device: Optional[str] = "cuda") -> Iterator[None]:
    """``--profile-dir``: device profiler capture + span Chrome trace.

    The profiler start/stop is best-effort: a profiler that refuses is
    recorded as ``unavailable`` and the run still produces its analysis on
    its own device; the span-level ``trace_spans.json`` always lands
    because it is rendered purely from host-side telemetry.
    """
    global _PROFILER_STATUS
    if not profile_dir:
        yield
        return
    from music_analyst_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    os.makedirs(profile_dir, exist_ok=True)
    prof = None
    try:
        prof = _start_profiler(device)
        _PROFILER_STATUS = {
            "status": "recording",
            "activities": [a.name for a in _activities(device)],
            "trace": os.path.join(profile_dir, DEVICE_TRACE_FILE),
        }
    except Exception as exc:
        _PROFILER_STATUS = {"status": "unavailable",
                            "error": str(exc)[:200]}
        tel.event("profiler_trace_unavailable", error=str(exc)[:200])
    try:
        yield
    finally:
        _PROFILER_STATUS = None
        if prof is not None:
            try:
                _stop_profiler(prof, profile_dir)
            except Exception as exc:
                tel.event("profiler_trace_stop_failed", error=str(exc)[:200])
        try:
            write_chrome_trace(
                tel, os.path.join(profile_dir, "trace_spans.json")
            )
        except Exception as exc:
            tel.event("span_trace_write_failed", error=str(exc)[:200])
