"""Scaling-sweep driver (the reference's ``run_performance.sh``, fixed).

Counterpart of ``music_analyst_tpu/engines/sweep.py``: runs the word count
(``engines/wordcount.py:run_analysis``) once per device count, archives
each run's metrics as ``performance_metrics_np{N}.json`` and writes
``sweep_summary.json`` with wall-clock seconds and speedup per point.  The
default counts are those of (1, 2, 4, 8) that fit the cards present
(``torch.cuda.device_count()``), or 1 on the CPU; counts given
explicitly run whatever the cards present, since ranks may share a card.

A point of N devices is an N-rank mesh, as ``analyze --devices N`` is:
this process is rank 0 and ranks 1..N-1 run the matching ``analyze``
command (``parallel/launch.py:run_ranks``), each point in a process
group of its own.  The mesh is built before the clock starts, as JAX
builds it before its clock, so a point's ``wall_seconds`` leaves out the
ranks' start-up.  Each point writes into a staging directory that is
published only once every rank of the point has exited 0: a point whose
rank fails publishes nothing and ends the sweep with exit code 1, before
the summary is written; earlier points' files stay.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import List, Optional, Sequence

import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines.wordcount import run_analysis
from music_analyst_tpu_torch.parallel import launch
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
    inject_faults: Optional[str] = None,
) -> dict:
    """``inject_faults`` is the ``--inject-faults`` spec that each point's
    ranks 1..N-1 are started with (this process's own injector is set up
    by its caller)."""
    dev = resolve_device(device)
    tel = get_telemetry()
    if device_counts is None:
        n_available = torch.cuda.device_count() if dev.type == "cuda" else 1
        device_counts = [n for n in DEFAULT_COUNTS if n <= n_available]
    bad = [n for n in device_counts if n < 1]
    if bad:
        raise ValueError(f"device counts must be >= 1, got {bad}")
    os.makedirs(output_dir, exist_ok=True)
    summary: dict = {"dataset": dataset_path, "runs": []}
    with tel.run_scope("sweep", output_dir):
        _sweep_points(
            tel, summary, dataset_path, device_counts, output_dir,
            ingest_backend, quiet, corpus_cache_dir, use_corpus_cache,
            chunk_songs, str(torch.device(device)), inject_faults,
        )
    with open(os.path.join(output_dir, "sweep_summary.json"), "w",
              encoding="utf-8") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    return summary


def _rank_argv(dataset_path, n, device, output_dir, ingest_backend,
               corpus_cache_dir, use_corpus_cache, chunk_songs,
               inject_faults) -> List[str]:
    """The ``analyze`` command a point's ranks 1..N-1 run: the collectives
    of ``run_analysis`` depend on the dataset, the mesh, the ingest, the
    cache and the chunking, which it names as the sweep has them, and the
    ranks inject the sweep's faults."""
    argv = ["analyze", dataset_path, "--devices", str(n), "--device", device,
            "--ingest", ingest_backend, "--output-dir", output_dir]
    if not use_corpus_cache:
        argv.append("--no-corpus-cache")
    elif corpus_cache_dir is not None:
        argv += ["--corpus-cache-dir", corpus_cache_dir]
    if chunk_songs is not None:
        argv += ["--chunk-songs", str(chunk_songs)]
    if inject_faults:
        argv += ["--inject-faults", inject_faults]
    return argv


def _sweep_points(
    tel, summary, dataset_path, device_counts, output_dir, ingest_backend,
    quiet, corpus_cache_dir, use_corpus_cache, chunk_songs, device,
    inject_faults,
) -> None:
    def _profile_counters() -> dict:
        with tel._lock:
            return {
                k: v for k, v in tel.counters.items()
                if k.startswith(("profiling.", "collectives."))
            }

    base_wall = None
    for n in device_counts:
        staging = launch.Staging(output_dir)
        walls = []

        def point() -> int:
            mesh = data_parallel_mesh(n, device=device)
            before = _profile_counters()
            start = time.perf_counter()
            with tel.span("sweep_point", devices=n):
                # With the corpus cache on, the first point ingests cold
                # and stores; every later point is a warm hit, so the wall
                # times measure device scaling, not repeated parsing.
                run_analysis(
                    dataset_path,
                    output_dir=staging.path,
                    mesh=mesh,
                    write_split=(n == device_counts[0]),  # split once
                    ingest_backend=ingest_backend,
                    quiet=quiet,
                    corpus_cache_dir=corpus_cache_dir,
                    use_corpus_cache=use_corpus_cache,
                    chunk_songs=chunk_songs,
                    device=device,
                )
            walls.append(time.perf_counter() - start)
            tel.count("sweep_points")
            # Each point's own profiling counters, not the running totals.
            after = _profile_counters()
            delta = {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
            tel.event("sweep_point_profile", devices=n,
                      wall_seconds=round(walls[0], 6), **delta)
            # Archive this point's metrics (the reference overwrites them).
            shutil.copyfile(
                os.path.join(staging.path, "performance_metrics.json"),
                os.path.join(staging.path,
                             f"performance_metrics_np{n}.json"))
            return 0

        launch.run_ranks(
            launch.module_command(_rank_argv(
                dataset_path, n, device, output_dir, ingest_backend,
                corpus_cache_dir, use_corpus_cache, chunk_songs,
                inject_faults)),
            n, device, point, staging=staging)
        wall = walls[0]
        if base_wall is None:
            base_wall = wall
        summary["runs"].append({
            "devices": n,
            "wall_seconds": round(wall, 6),
            "speedup_vs_first": round(base_wall / wall, 3),
            "metrics_file": f"performance_metrics_np{n}.json",
        })
        if not quiet:
            print(f"np={n}: {wall:.3f}s")
