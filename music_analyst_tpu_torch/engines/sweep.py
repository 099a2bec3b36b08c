"""Scaling-sweep driver (the reference's ``run_performance.sh``, fixed).

Counterpart of ``music_analyst_tpu/engines/sweep.py``: runs the word count
(``engines/wordcount.py:run_analysis``) once per device count, archives
each run's metrics as ``performance_metrics_np{N}.json`` and writes
``sweep_summary.json`` with wall-clock seconds and speedup per point.  The
default counts are those of (1, 2, 4, 8) that fit the cards present
(``torch.cuda.device_count()``), or 1 on the CPU; a larger requested count
prints ``skipping np=N: only M devices``.  A count above 1 that fits
reaches ``parallel/mesh.py``, which refuses it: a mesh of N devices is N
ranks (``analyze --devices N`` launches them), and a sweep over ranks is
not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional, Sequence

import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines.wordcount import run_analysis
from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh
from music_analyst_tpu_torch.telemetry import get_telemetry

DEFAULT_COUNTS = (1, 2, 4, 8)


def run_sweep(
    dataset_path: str,
    device_counts: Optional[Sequence[int]] = None,
    output_dir: str = "output",
    ingest_backend: str = "auto",
    quiet: bool = True,
    corpus_cache_dir: Optional[str] = None,
    use_corpus_cache: bool = True,
    chunk_songs=None,
    device: DeviceLike = "cuda",
) -> dict:
    dev = resolve_device(device)
    tel = get_telemetry()
    os.makedirs(output_dir, exist_ok=True)
    n_available = torch.cuda.device_count() if dev.type == "cuda" else 1
    if device_counts is None:
        device_counts = [n for n in DEFAULT_COUNTS if n <= n_available]
    summary: dict = {"dataset": dataset_path, "runs": []}
    with tel.run_scope("sweep", output_dir):
        _sweep_points(
            tel, summary, dataset_path, device_counts, n_available,
            output_dir, ingest_backend, quiet, corpus_cache_dir,
            use_corpus_cache, chunk_songs, dev,
        )
    with open(os.path.join(output_dir, "sweep_summary.json"), "w",
              encoding="utf-8") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    return summary


def _sweep_points(
    tel, summary, dataset_path, device_counts, n_available, output_dir,
    ingest_backend, quiet, corpus_cache_dir, use_corpus_cache, chunk_songs,
    dev,
) -> None:
    def _profile_counters() -> dict:
        with tel._lock:
            return {
                k: v for k, v in tel.counters.items()
                if k.startswith(("profiling.", "collectives."))
            }

    base_wall = None
    for n in device_counts:
        if n > n_available:
            print(f"skipping np={n}: only {n_available} devices")
            continue
        mesh = data_parallel_mesh(n, device=dev)
        before = _profile_counters()
        start = time.perf_counter()
        with tel.span("sweep_point", devices=n):
            # With the corpus cache on, the first point ingests cold and
            # stores; every later point is a warm hit, so the wall times
            # measure device scaling, not repeated parsing.
            run_analysis(
                dataset_path,
                output_dir=output_dir,
                mesh=mesh,
                write_split=(n == device_counts[0]),  # split artifacts once
                ingest_backend=ingest_backend,
                quiet=quiet,
                corpus_cache_dir=corpus_cache_dir,
                use_corpus_cache=use_corpus_cache,
                chunk_songs=chunk_songs,
                device=dev,
            )
        wall = time.perf_counter() - start
        tel.count("sweep_points")
        # Each point's own profiling counters, not the running totals.
        after = _profile_counters()
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        tel.event("sweep_point_profile", devices=n,
                  wall_seconds=round(wall, 6), **delta)
        # Archive this point's metrics (the reference overwrites them).
        src = os.path.join(output_dir, "performance_metrics.json")
        dst = os.path.join(output_dir, f"performance_metrics_np{n}.json")
        shutil.copyfile(src, dst)
        if base_wall is None:
            base_wall = wall
        summary["runs"].append({
            "devices": n,
            "wall_seconds": round(wall, 6),
            "speedup_vs_first": round(base_wall / wall, 3),
            "metrics_file": os.path.basename(dst),
        })
        if not quiet:
            print(f"np={n}: {wall:.3f}s")
