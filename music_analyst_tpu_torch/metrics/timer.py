"""Wall-clock stage timers.

The port's counterpart of ``music_analyst_tpu/metrics/timer.py``.  The
reference brackets compute and total with ``MPI_Wtime``
(``src/parallel_spotify.c:850-851,1000,1067-1068``); here the host drives
the card, so a stage is host wall-clock around work that ends in a host
copy of its result (the synchronisation point).  The JAX timer also opens
a telemetry span per stage; the port has no telemetry yet.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator


class StageTimer:
    """Accumulates named wall-clock stage durations.

    ``self.seconds`` is the sole source for ``performance_metrics.json``'s
    stage breakdown.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def total(self, *names: str) -> float:
        if not names:
            return sum(self.seconds.values())
        return sum(self.seconds.get(n, 0.0) for n in names)
