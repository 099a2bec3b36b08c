"""Crash forensics, stall classification, the metrics plane and the
engine ledger.

Counterpart of ``music_analyst_tpu/observability/``: :mod:`flight`
(``flight_record.json``), :mod:`watchdog` (the heartbeat monitor and its
stall taxonomy), :mod:`metrics_plane`, :mod:`engine_ledger`, and the
host-only tools :mod:`report` (``telemetry-report``, ``trace-report``) and
:mod:`monitor` (``monitor``).
"""
