"""Device introspection + the run-manifest sink.

Counterpart of ``music_analyst_tpu/telemetry/introspect.py``.  The
manifest has the JAX package's ``schema`` and key set, so either
package's ``telemetry-report`` and ``profile-diff`` read both, with two
changes:

* ``torch_version`` and ``cuda_version`` stand where JAX writes
  ``jax_version`` and ``jaxlib_version``;
* ``compile`` and ``jax_events`` are written empty, as JAX writes them
  for a run that compiled nothing: eager PyTorch builds no programs.  The
  CUDA kernel libraries ``kernels.py`` built or loaded are listed under
  ``profiling.kernel_builds`` instead.

Nothing here imports torch unless the run already did: a host-only run
(``split``, ``wordcount-per-song``) reports the CPU without paying for
the import.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Dict, Optional

from music_analyst_tpu_torch.telemetry.core import Telemetry

_GIT_DESCRIBE: Optional[str] = None
_GIT_PROBED = False


def git_describe() -> Optional[str]:
    """``git describe --always --dirty`` of the repo, cached per process."""
    global _GIT_DESCRIBE, _GIT_PROBED
    if _GIT_PROBED:
        return _GIT_DESCRIBE
    _GIT_PROBED = True
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=repo_root, capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0:
            _GIT_DESCRIBE = out.stdout.strip() or None
    except Exception:
        _GIT_DESCRIBE = None
    return _GIT_DESCRIBE


def peak_rss_bytes() -> Optional[int]:
    try:
        import resource

        # Linux reports ru_maxrss in KiB.
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # pragma: no cover - non-POSIX
        return None


def _cuda_memory_stats(torch, index: int) -> Dict[str, int]:
    """The card's allocator numbers under the names JAX's
    ``Device.memory_stats()`` uses."""
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(index)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
        "bytes_reserved": int(torch.cuda.memory_reserved(index)),
        "bytes_limit": int(
            torch.cuda.get_device_properties(index).total_memory
        ),
    }


def collect_device_info() -> Dict[str, Any]:
    """Platform, device count, kinds and per-device memory stats.

    ``gpu`` when this process put work on the card (its CUDA context
    exists), else ``cpu``: a ``--device cpu`` run on a machine with a card
    is a CPU run.  The CPU has no memory stats (None), as in JAX."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        count = torch.cuda.device_count()
        return {
            "platform": "gpu",
            "count": count,
            "kinds": sorted({torch.cuda.get_device_name(i)
                             for i in range(count)}),
            "memory_stats": [_cuda_memory_stats(torch, i)
                             for i in range(count)],
        }
    return {
        "platform": "cpu",
        "count": 1,
        "kinds": ["cpu"],
        "memory_stats": [None],
    }


def _versions() -> Dict[str, Optional[str]]:
    torch = sys.modules.get("torch")
    if torch is None:
        try:
            import torch
        except Exception:  # pragma: no cover - torch is a dependency
            return {"torch_version": None, "cuda_version": None}
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def write_run_manifest(
    tel: Telemetry, directory: str, wall_seconds: float = 0.0
) -> str:
    """Write ``<directory>/run_manifest.json`` from the registry's state.

    The one-glance answer to "what ran, where, and what did it cost": CLI
    argv, device platform/count/memory, torch/CUDA versions, git describe,
    peak RSS, and the final counter/gauge/histogram/span aggregates.
    """
    from music_analyst_tpu_torch.kernels import build_stats

    with tel._lock:
        context = dict(tel.context)
        counters = dict(tel.counters)
        gauges = dict(tel.gauges)
        histograms = {k: h.as_dict() for k, h in tel.histograms.items()}
        events = tel.events
        pipelines = dict(tel.pipelines)
    manifest: Dict[str, Any] = {
        "schema": 1,
        "engine": context.pop("engine", None),
        "argv": list(sys.argv[1:]),
        "wall_seconds": round(wall_seconds, 6),
        "python_version": sys.version.split()[0],
        **_versions(),
        "git_describe": git_describe(),
        "device": collect_device_info(),
        "peak_rss_bytes": peak_rss_bytes(),
        "compile": {"count": 0, "seconds": 0.0},
        "jax_events": {},
        "context": context,
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "spans": tel.top_spans(n=20),
        "pipeline": pipelines,
        "event_count": events,
        "telemetry_log": tel.sink_path,
    }
    # Failover degradation and an unclean previous shutdown are headline
    # facts about the run, hoisted out of the annotation context; absent
    # on healthy runs, so those keep the original key set.
    if context.get("degraded"):
        manifest["degraded"] = True
        for key in ("degraded_site", "degraded_reason"):
            if key in context:
                manifest[key] = context[key]
    if context.get("unclean_shutdown"):
        manifest["unclean_shutdown"] = True
        if "unclean_witness" in context:
            manifest["unclean_witness"] = context["unclean_witness"]
    try:
        # Fault-injection + retry digest: only when something tripped or
        # retried, so fault-free runs keep the original key set.
        from music_analyst_tpu_torch.resilience.faults import fault_stats
        from music_analyst_tpu_torch.resilience.policy import retry_stats

        faults = fault_stats()
        retries = {
            site: counts
            for site, counts in retry_stats().items()
            if counts.get("retries") or counts.get("gave_up")
        }
        if faults or retries:
            resilience: Dict[str, Any] = {}
            if faults:
                resilience["faults"] = faults
            if retries:
                resilience["retries"] = retries
            manifest["resilience"] = resilience
    except Exception:
        pass
    try:
        # Persistent-corpus-cache hit/miss/bytes-saved, once consulted.
        from music_analyst_tpu_torch.data.corpus_cache import cache_stats

        corpus_stats = cache_stats()
        if any(corpus_stats.values()):
            manifest["corpus_cache"] = corpus_stats
    except Exception:
        pass
    try:
        # Quantized-checkpoint cache stats and the last streaming load.
        from music_analyst_tpu_torch.engines.checkpoint import last_load_stats
        from music_analyst_tpu_torch.engines.wq_cache import (
            cache_stats as wq_stats,
        )

        stats = wq_stats()
        load = last_load_stats()
        if any(stats.values()) or load:
            manifest["wq_cache"] = dict(stats)
            if load:
                manifest["wq_cache"]["last_load"] = load
    except Exception:
        pass
    profiling: Dict[str, Any] = {
        "scope": "process",
        # JAX lists its XLA compiles here; eager PyTorch has none.
        "compiles": [],
        "kernel_builds": build_stats(),
    }
    try:
        # --profile-dir's device profiler: recording, or why it could not.
        from music_analyst_tpu_torch.profiling.trace import profiler_status

        status = profiler_status()
        if status is not None:
            profiling["profiler"] = status
    except Exception:
        pass
    manifest["profiling"] = profiling
    try:
        # Serving-layer snapshot, only when a server ran in this process.
        from music_analyst_tpu_torch.serving.server import serving_stats

        serving = serving_stats()
        if serving:
            manifest["serving"] = serving
    except Exception:
        pass
    try:
        # Request-trace digest + tail exemplars, only when tracing was on.
        from music_analyst_tpu_torch.telemetry.reqtrace import get_reqtrace

        rt = get_reqtrace()
        if rt.enabled:
            manifest["reqtrace"] = rt.stats()
            exemplars = rt.exemplars()
            if exemplars:
                manifest["trace_exemplars"] = exemplars
    except Exception:
        pass
    try:
        # Metrics plane digest, only when sampling was on.
        from music_analyst_tpu_torch.observability.metrics_plane import (
            get_metrics_plane,
        )

        plane = get_metrics_plane()
        if plane.enabled:
            manifest["metrics"] = plane.snapshot()
    except Exception:
        pass
    try:
        # Watchdog verdicts + flight-record pointer, when there are any.
        from music_analyst_tpu_torch.observability.flight import (
            get_flight_recorder,
        )
        from music_analyst_tpu_torch.observability.watchdog import (
            get_watchdog,
        )

        obs: Dict[str, Any] = {}
        wd = get_watchdog()
        if wd is not None:
            obs["watchdog"] = wd.snapshot()
        rec = get_flight_recorder()
        if rec.last_dump_path:
            obs["flight_record"] = rec.last_dump_path
        if obs:
            manifest["observability"] = obs
    except Exception:
        pass
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "run_manifest.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2, default=str)
        fh.write("\n")
    return path

