"""Device-level profiling layered on the telemetry registry.

Counterpart of ``music_analyst_tpu/profiling/``:

* ``profiling/trace.py`` — device-time capture: ``torch.profiler`` traces
  (the CUDA activity when the run is on the card) plus a Chrome-trace
  artifact rendered from this run's telemetry spans (``--profile-dir``,
  ``--trace-dir``);
* ``profiling/collectives.py`` — analytic per-participant byte estimates
  for ``psum`` / ``all_gather`` / all-to-all / ``ppermute``
  (``collectives.*_bytes`` counters, one ``collective`` event per call
  site, and the per-stage table the run scope emits at its end);
* ``profiling/diff.py`` — the regression gate behind
  ``python -m music_analyst_tpu_torch profile-diff A B``.

Not here: JAX's ``profiling/compile.py`` wraps ``jax.jit`` (eager PyTorch
compiles no programs).

Import discipline: this package imports neither torch nor any device
module at import time; ``trace.py`` imports torch inside the functions
that profile.
"""

from music_analyst_tpu_torch.profiling.collectives import (
    all_gather_bytes,
    all_to_all_bytes,
    emit_stage_table,
    ppermute_bytes,
    psum_bytes,
    record_collective,
    stage_table,
)
from music_analyst_tpu_torch.profiling.diff import load_metrics, run_profile_diff

__all__ = [
    "all_gather_bytes",
    "all_to_all_bytes",
    "emit_stage_table",
    "ppermute_bytes",
    "psum_bytes",
    "record_collective",
    "stage_table",
    "load_metrics",
    "run_profile_diff",
]
