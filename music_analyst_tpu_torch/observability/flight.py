"""Flight recorder: a bounded ring of recent telemetry + crash dumps.

Counterpart of ``music_analyst_tpu/observability/flight.py``, copied with its imports
renamed; the port keeps its own copy.

``BENCH_r05.json`` is the motivating failure: the bench died on a device
probe timeout and left nothing behind — no thread stacks, no event
timeline, no way to tell a tunnel hang from a compile hang after the
process was gone.  The recorder fixes that class of blindness: it taps
the process telemetry registry (``telemetry/core.py``) into a bounded
in-memory ring (so a crashing run always has its last ~512 events even
when no JSONL sink was open), and dumps ``flight_record.json`` — ring +
process vitals + ``faulthandler`` stacks of every thread — on:

* an unhandled exception (``sys.excepthook`` chain),
* SIGTERM / SIGINT (handler chain; the previous disposition still runs,
  so a SIGTERM'd process still dies — it just leaves a post-mortem),
* a watchdog trip (``observability/watchdog.py`` calls :meth:`dump`),
* bench-deadline expiry (``bench.py`` dumps before its terminal line).

Zero hard deps on jax — installable before ``tests/conftest.py`` forces
the CPU platform, and cheap enough for ``bench.py --probe``.

Dump location: explicit ``directory`` > ``$MUSICAAL_FLIGHT_RECORD_DIR`` >
the open telemetry sink's directory > the system temp dir.  The file name
is always ``flight_record.json`` (overwritten — the *latest* failure is
the one being diagnosed); readers that care about staleness check mtime
(``bench.py`` does).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from music_analyst_tpu_torch.telemetry import get_telemetry

DEFAULT_CAPACITY = 512

_START_MONO = time.monotonic()


def _thread_stacks() -> str:
    """Every thread's stack as text, via faulthandler (needs a real fd)."""
    import faulthandler

    try:
        with tempfile.TemporaryFile(mode="w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            return fh.read()
    except Exception:
        pass
    # No usable fd (exotic embedding): pure-Python fallback.
    try:
        import traceback

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        parts = []
        for tid, frame in frames.items():
            parts.append(
                f"Thread {names.get(tid, tid)}:\n"
                + "".join(traceback.format_stack(frame))
            )
        return "\n".join(parts)
    except Exception:
        return "<thread stacks unavailable>"


def _vitals() -> Dict[str, Any]:
    """Cheap process health snapshot taken at dump time."""
    out: Dict[str, Any] = {
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _START_MONO, 3),
        "thread_count": threading.active_count(),
        "thread_names": sorted(t.name for t in threading.enumerate())[:64],
        "python_version": sys.version.split()[0],
    }
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        out["peak_rss_bytes"] = ru.ru_maxrss * 1024  # Linux: KiB
        out["cpu_user_s"] = round(ru.ru_utime, 3)
        out["cpu_system_s"] = round(ru.ru_stime, 3)
    except Exception:  # pragma: no cover - non-POSIX
        pass
    return out


class FlightRecorder:
    """Bounded event ring + post-mortem dumper.  One per process."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._prev_handlers: Dict[int, Any] = {}
        self.last_dump_path: Optional[str] = None
        self.dump_count = 0

    # ----------------------------------------------------------- recording

    def record(self, event: Dict[str, Any]) -> None:
        """Telemetry tap target: keep the most recent events, drop the
        oldest.  Events are append-only dicts; no copy needed."""
        with self._lock:
            self._ring.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # -------------------------------------------------------- installation

    def install(self, signals: bool = True, excepthook: bool = True
                ) -> "FlightRecorder":
        """Tap telemetry + hook crash paths.  Idempotent.

        Signal handlers chain to the previous disposition (a SIGTERM'd
        process still terminates; Ctrl-C still raises KeyboardInterrupt)
        and can only be installed from the main thread — elsewhere the
        tap + excepthook still install and signals are skipped.
        """
        if self._installed:
            return self
        self._installed = True
        get_telemetry().add_tap(self.record)
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        if signals:
            for signum in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[signum] = signal.signal(
                        signum, self._signal_handler
                    )
                except (ValueError, OSError):  # non-main thread / exotic os
                    pass
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        get_telemetry().remove_tap(self.record)
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    @property
    def installed(self) -> bool:
        return self._installed

    # --------------------------------------------------------- crash hooks

    def _excepthook(self, exc_type, exc, tb) -> None:
        taxonomy = None
        if isinstance(exc, MemoryError):
            taxonomy = "host_oom"
        self.dump(
            reason="unhandled_exception",
            taxonomy=taxonomy,
            detail=f"{exc_type.__name__}: {exc}"[:500],
        )
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _signal_handler(self, signum, frame) -> None:
        try:
            name = signal.Signals(signum).name
        except ValueError:  # pragma: no cover
            name = str(signum)
        self.dump(reason=f"signal:{name}", detail=f"received {name}")
        prev = self._prev_handlers.get(signum, signal.SIG_DFL)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # Re-deliver under the default disposition so the process
            # status the parent sees (killed-by-SIGTERM) is unchanged.
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        # SIG_IGN: swallow, like the previous handler would have.

    # --------------------------------------------------------------- dumps

    def _resolve_dir(self, directory: Optional[str]) -> str:
        if directory:
            return directory
        env = os.environ.get("MUSICAAL_FLIGHT_RECORD_DIR", "").strip()
        if env:
            return env
        tel = get_telemetry()
        if tel.sink_path:
            # A staged run's failure record goes where its outputs would
            # have gone: the staging directory is removed on failure.
            return os.path.dirname(tel.published(tel.sink_path))
        return tempfile.gettempdir()

    def dump(
        self,
        reason: str,
        taxonomy: Optional[str] = None,
        detail: str = "",
        directory: Optional[str] = None,
    ) -> Optional[str]:
        """Write ``flight_record.json``; never raises (returns None).

        Called from signal handlers, excepthooks, and the watchdog monitor
        thread — any failure here must not mask the original problem.
        """
        with self._dump_lock:
            try:
                tel = get_telemetry()
                with tel._lock:
                    counters = dict(tel.counters)
                    gauges = dict(tel.gauges)
                record: Dict[str, Any] = {
                    "schema": 1,
                    "reason": reason,
                    "taxonomy": taxonomy,
                    "detail": detail,
                    "t_wall": round(time.time(), 6),
                    "t_mono": round(time.monotonic(), 6),
                    "argv": list(sys.argv),
                    "vitals": _vitals(),
                    "counters": counters,
                    "gauges": gauges,
                    "events": self.events(),
                    "thread_stacks": _thread_stacks(),
                }
                try:
                    from music_analyst_tpu_torch.observability.watchdog import (
                        get_watchdog,
                    )

                    wd = get_watchdog()
                    if wd is not None:
                        record["watchdog"] = wd.snapshot()
                except Exception:
                    pass
                out_dir = self._resolve_dir(directory)
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, "flight_record.json")
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(record, fh, indent=2, default=str)
                    fh.write("\n")
                os.replace(tmp, path)
                self.last_dump_path = path
                self.dump_count += 1
            except Exception:
                return None
        # Outside the dump lock: the emit feeds the ring via the tap, and
        # a same-thread re-dump must not deadlock.
        try:
            get_telemetry().event(
                "flight_record_dumped",
                path=path, reason=reason, taxonomy=taxonomy,
            )
        except Exception:
            pass
        return path


# ------------------------------------------------------- process singleton

_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def install_flight_recorder(
    signals: bool = True, excepthook: bool = True
) -> FlightRecorder:
    """Install (idempotently) and return the process flight recorder."""
    return _RECORDER.install(signals=signals, excepthook=excepthook)
