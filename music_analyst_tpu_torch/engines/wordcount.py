"""The word/artist-count analysis engine (``bin/parallel_spotify`` parity).

The counterpart of ``music_analyst_tpu/engines/wordcount.py``, with the
same stages (cf. the reference call stack, SURVEY.md §3.1):

1. ``split`` — header labels + column split artifacts
   (``output/split_columns/<artist>.csv``, ``<text>.csv``), like rank 0 of
   the reference (``src/parallel_spotify.c:778-828``);
2. ``ingest`` — C++/Python tokenizer builds vocab + dense id arrays
   (replaces the per-rank byte-slice read loops, ``:918-998``);
3. ``device_compute`` — the word and artist histograms on the card, in one
   of three layouts (``ops/histogram.py``): host-shard counts merged on the
   card, device-resident ids, or streamed chunks;
4. ``aggregate_export`` — count-desc/strcmp-asc sorted CSVs, the console
   report, and ``performance_metrics.json`` with per-chip timings
   (``:1027-1053,1084-1109``).

Telemetry as in JAX: the ``wordcount`` run scope, a span per stage, the
``songs_ingested`` / ``words_counted`` counters, and profiler annotations
around the histograms.  Resilience as in JAX: ``device_compute`` runs
inside the ``wordcount.device_compute`` watchdog scope (kind ``device``)
and :func:`run_with_failover`, which on a classified device loss rebuilds
the default mesh once and re-runs the histograms.  The JAX engine's
degrade to a host ``np.bincount`` when the retry fails too is
deliberately not ported: a second failure on the card raises.

On a mesh of ranks (``analyze --devices N``) every rank ingests (or reads
the corpus cache) and counts its ``dp`` shard; the histograms merge over
``dp`` and only the coordinator (rank 0) writes the split columns, the
CSVs and ``performance_metrics.json`` (one ``per_chip`` row per rank).
A multi-rank mesh is not rebuilt on a failover: every rank would have to
rebuild it together.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from music_analyst_tpu_torch.data.corpus_cache import resolve_cache_dir
from music_analyst_tpu_torch.data.csv_io import (
    sort_count_entries,
    write_count_csv,
)
from music_analyst_tpu_torch.data.ingest import IngestResult, ingest_dataset
from music_analyst_tpu_torch.data.splitter import (
    read_header_labels,
    sanitize_header_name,
    split_dataset_columns,
)
from music_analyst_tpu_torch.device import DeviceLike
from music_analyst_tpu_torch.metrics.perf import (
    TimeStats,
    device_platform,
    per_chip_rows,
    write_performance_metrics,
)
from music_analyst_tpu_torch.metrics.timer import StageTimer
from music_analyst_tpu_torch.observability import watchdog
from music_analyst_tpu_torch.ops.histogram import (
    resolve_chunk_songs,
    sharded_histogram,
    sharded_histogram_hostlocal_timed,
    sharded_histogram_streaming,
)
from music_analyst_tpu_torch.parallel import multihost
from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh
from music_analyst_tpu_torch.profiling.trace import annotate
from music_analyst_tpu_torch.resilience.failover import run_with_failover
from music_analyst_tpu_torch.telemetry import get_telemetry

COUNT_MODES = ("host-shard", "device-ids")


@dataclasses.dataclass
class AnalysisResult:
    word_entries: List[Tuple[str, int]]    # sorted count-desc, tie bytewise-asc
    artist_entries: List[Tuple[str, int]]
    total_songs: int
    total_words: int
    timings: dict
    output_paths: dict
    # Measured per-chip compute seconds — identical to the metrics file's
    # per_chip column and the samples behind compute_time (ingest share +
    # the chip's own count/merge time).
    per_chip_compute: List[float] = dataclasses.field(default_factory=list)


def _device_counts(corpus: IngestResult, mesh, count_mode: str, chunk: int):
    """Word and artist histograms (host numpy) and per-chip compute
    seconds (``None`` when the layout is one lock-stepped program)."""
    word_vocab = max(1, len(corpus.word_vocab))
    artist_vocab = max(1, len(corpus.artist_vocab))
    if chunk > 0:
        # The word stream walks bounded chunks; its wall-clock is every
        # shard's share.  The artist histogram is O(songs), too small for
        # chunking to pay, and stays host-local with per-shard timing.
        with annotate("wordcount.word_histogram"):
            t0 = time.perf_counter()
            word_counts = sharded_histogram_streaming(
                corpus.word_ids, corpus.word_offsets, word_vocab, mesh,
                chunk_songs=chunk,
            )
            word_wall = time.perf_counter() - t0
        with annotate("wordcount.artist_histogram"):
            artist_counts, artist_times = sharded_histogram_hostlocal_timed(
                corpus.artist_ids, artist_vocab, mesh
            )
        per_chip = [word_wall + a for a in artist_times.per_chip_seconds()]
    elif count_mode == "host-shard":
        with annotate("wordcount.word_histogram"):
            word_counts, word_times = sharded_histogram_hostlocal_timed(
                corpus.word_ids, word_vocab, mesh
            )
        with annotate("wordcount.artist_histogram"):
            artist_counts, artist_times = sharded_histogram_hostlocal_timed(
                corpus.artist_ids, artist_vocab, mesh
            )
        # Shard i's measured compute: its own count phases plus the merges
        # every device sits in together.
        per_chip = [
            w + a
            for w, a in zip(word_times.per_chip_seconds(),
                            artist_times.per_chip_seconds())
        ]
    else:
        # .cpu() is the synchronisation point of each histogram.
        with annotate("wordcount.word_histogram"):
            word_counts = sharded_histogram(
                corpus.word_ids, word_vocab, mesh).cpu().numpy()
        with annotate("wordcount.artist_histogram"):
            artist_counts = sharded_histogram(
                corpus.artist_ids, artist_vocab, mesh).cpu().numpy()
        per_chip = None
    return word_counts, artist_counts, per_chip


def run_analysis(
    dataset_path: str,
    output_dir: str = "output",
    word_limit: int = 0,
    artist_limit: int = 0,
    limit: Optional[int] = None,
    mesh=None,
    write_split: bool = True,
    ingest_backend: str = "auto",
    count_mode: str = "host-shard",
    quiet: bool = False,
    corpus: Optional[IngestResult] = None,
    ingest_seconds: float = 0.0,
    corpus_cache_dir: Optional[str] = None,
    use_corpus_cache: bool = True,
    chunk_songs=None,
    device: DeviceLike = "cuda",
) -> AnalysisResult:
    """Run the full analysis and write the reference's output artifacts.

    ``corpus`` supplies an already-ingested dataset (the joint pipeline
    parses once and shares it); ``ingest_seconds`` is then the caller's
    measured ingest time, folded into the timing stats as an in-engine
    ingest would be.  ``corpus_cache_dir``/``use_corpus_cache`` control the
    persistent ingest cache; ``chunk_songs`` selects the streaming path
    (``None`` = auto by corpus size, ``0`` = off, ``N`` = songs per chunk).
    Every combination writes byte-identical CSVs.  ``mesh`` defaults to
    the one-device mesh on ``device`` (``"cuda"``; ``"cpu"`` for tests).
    """
    if count_mode not in COUNT_MODES:
        raise ValueError(f"unknown count mode {count_mode!r}")
    default_mesh = mesh is None
    if default_mesh:
        mesh = data_parallel_mesh(device=device)
    cache_dir = resolve_cache_dir(corpus_cache_dir, use_corpus_cache)
    tel = get_telemetry()
    timer = StageTimer()
    if multihost.is_coordinator():
        os.makedirs(output_dir, exist_ok=True)
    split_dir = os.path.join(output_dir, "split_columns")

    with tel.run_scope("wordcount", output_dir):
        return _run_analysis_instrumented(
            tel, timer, dataset_path, output_dir, split_dir, word_limit,
            artist_limit, limit, mesh, write_split, ingest_backend,
            count_mode, quiet, corpus, ingest_seconds, cache_dir,
            chunk_songs, default_mesh,
        )


def _run_analysis_instrumented(
    tel, timer, dataset_path, output_dir, split_dir, word_limit,
    artist_limit, limit, mesh, write_split, ingest_backend, count_mode,
    quiet, corpus, ingest_seconds, cache_dir, chunk_songs, default_mesh,
) -> AnalysisResult:
    coordinator = multihost.is_coordinator()
    quiet = quiet or not coordinator
    with timer.stage("split"):
        if write_split and coordinator:
            artist_label, text_label = read_header_labels(dataset_path)
            split_dataset_columns(
                dataset_path,
                split_dir,
                sanitize_header_name(artist_label),
                sanitize_header_name(text_label),
                artist_label,
                text_label,
            )

    if corpus is None:
        with timer.stage("ingest"):
            corpus = ingest_dataset(
                dataset_path, limit=limit, backend=ingest_backend,
                cache_dir=cache_dir,
            )
    else:
        timer.seconds["ingest"] = ingest_seconds

    chunk = resolve_chunk_songs(
        chunk_songs, corpus.song_count, corpus.token_count
    )
    tel.count("songs_ingested", corpus.song_count)
    tel.count("words_counted", corpus.token_count)
    tel.annotate(mesh_shape=mesh.shape, count_mode=count_mode,
                 chunk_songs=chunk)
    if mesh.size > 1:
        tel.annotate(mesh_backend=multihost.backend())

    def _reinit_mesh():
        # The port caches no compiled programs or histogram state; the
        # re-init rebuilds the default mesh, which re-resolves the device
        # and touches its context.  A caller-supplied mesh is left alone.
        nonlocal mesh
        if default_mesh and mesh.size == 1:
            mesh = data_parallel_mesh(device=mesh.device)

    with timer.stage("device_compute"), watchdog.watch(
        "wordcount.device_compute", kind="device"
    ):
        # Classified device loss (device_stall / injected transient) gets
        # one re-init-and-retry; a second failure raises (no degrade).
        word_counts, artist_counts, per_chip_compute = run_with_failover(
            lambda: _device_counts(corpus, mesh, count_mode, chunk),
            site="wordcount.device_compute",
            reinit=_reinit_mesh,
        )
    if per_chip_compute is None:
        per_chip_compute = [timer.seconds["device_compute"]] * mesh.size
    total_words = corpus.token_count
    total_songs = corpus.song_count

    with timer.stage("aggregate_export"):
        word_entries = sort_count_entries(
            corpus.word_vocab.counts_to_entries(word_counts)
        )
        artist_entries = sort_count_entries(
            corpus.artist_vocab.counts_to_entries(artist_counts)
        )
        word_path = os.path.join(output_dir, "word_counts.csv")
        artist_path = os.path.join(output_dir, "top_artists.csv")
        if coordinator:
            write_count_csv(word_path, "word", word_entries, word_limit)
            write_count_csv(artist_path, "artist", artist_entries,
                            artist_limit)

    # Reference timing semantics (src/parallel_spotify.c:850-851,1000,1068):
    # compute = local read + count; total = compute + aggregation/export.
    # Each chip's compute is the shared host ingest plus its own measured
    # count/merge time.
    ingest_seconds = timer.seconds.get("ingest", 0.0)
    export_seconds = timer.seconds.get("aggregate_export", 0.0)
    per_chip_compute = [ingest_seconds + c for c in per_chip_compute]
    metrics_path = os.path.join(output_dir, "performance_metrics.json")
    if coordinator:
        write_performance_metrics(
            metrics_path,
            processes=mesh.size,
            total_songs=total_songs,
            total_words=total_words,
            compute_time=TimeStats.from_samples(per_chip_compute),
            total_time=TimeStats.from_samples(
                [c + export_seconds for c in per_chip_compute]
            ),
            per_chip=per_chip_rows(mesh.devices, per_chip_compute),
            stages=dict(timer.seconds),
            device_platform=device_platform(mesh.devices[0]),
        )

    if not quiet:
        print("=== Parallel Spotify Analysis ===")
        print(f"Total songs processed: {total_songs}")
        print(f"Total words counted: {total_words}")
        preview_words = word_entries[:10]
        print(f"Top {len(preview_words)} words:")
        for key, value in preview_words:
            print(f"  {key}: {value}")
        preview_artists = artist_entries[:10]
        print(f"Top {len(preview_artists)} artists:")
        for key, value in preview_artists:
            print(f"  {key}: {value} songs")

    return AnalysisResult(
        word_entries=word_entries,
        artist_entries=artist_entries,
        total_songs=total_songs,
        total_words=total_words,
        timings=dict(timer.seconds),
        output_paths={
            "word_counts": word_path,
            "top_artists": artist_path,
            "performance_metrics": metrics_path,
            "split_dir": split_dir,
        },
        per_chip_compute=list(per_chip_compute),
    )
