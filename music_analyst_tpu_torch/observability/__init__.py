"""Crash forensics, stall classification, the metrics plane and the
engine ledger.

Counterpart of ``music_analyst_tpu/observability/``: :mod:`flight`
(``flight_record.json``), :mod:`watchdog` (the heartbeat monitor and its
stall taxonomy), :mod:`metrics_plane` and :mod:`engine_ledger`.  The
cross-run ``telemetry-report`` (``report.py``) and the live ``monitor``
are not ported yet.
"""
