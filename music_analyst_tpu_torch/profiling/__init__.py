"""Device-level profiling layered on the telemetry registry.

Counterpart of ``music_analyst_tpu/profiling/``:

* ``profiling/trace.py`` — device-time capture: ``torch.profiler`` traces
  (the CUDA activity when the run is on the card) plus a Chrome-trace
  artifact rendered from this run's telemetry spans (``--profile-dir``,
  ``--trace-dir``);
* ``profiling/diff.py`` — the regression gate behind
  ``python -m music_analyst_tpu_torch profile-diff A B``.

Not here: JAX's ``profiling/compile.py`` wraps ``jax.jit`` (eager PyTorch
compiles no programs), and ``profiling/collectives.py`` waits for the
multi-card work; nothing imports them, and the run scope's collective
table hook stays a guarded no-op (``telemetry/core.py``).

Import discipline: this package imports neither torch nor any device
module at import time; ``trace.py`` imports torch inside the functions
that profile.
"""

from music_analyst_tpu_torch.profiling.diff import load_metrics, run_profile_diff

__all__ = [
    "load_metrics",
    "run_profile_diff",
]
