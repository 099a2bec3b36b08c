"""Joint pipeline: word/artist histogram + sentiment from ONE ingest pass.

The counterpart of ``music_analyst_tpu/engines/joint.py`` (BASELINE.json
config[4], ``analyze --with-sentiment``).  The native ingest parses the
file once with record capture: the dense id arrays feed the histograms on
the card and the captured ``(artist, song, text)`` records feed the
classifier batches — one parse, one parser, one song count across all
five artifacts.

Parser note: the fused run classifies exactly the records the exact
(reference-C-semantics) parser accepts.  A standalone ``sentiment`` run
keeps the reference script's ``csv.DictReader`` semantics, so on datasets
with short or malformed rows the two standalone tools can disagree with
each other, as the reference's do; the joint run cannot.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from music_analyst_tpu_torch.data.corpus_cache import resolve_cache_dir
from music_analyst_tpu_torch.data.ingest import ingest_dataset
from music_analyst_tpu_torch.device import DeviceLike
from music_analyst_tpu_torch.engines.sentiment import (
    SentimentResult,
    run_sentiment,
)
from music_analyst_tpu_torch.engines.wordcount import (
    AnalysisResult,
    run_analysis,
)
from music_analyst_tpu_torch.metrics.perf import (
    TimeStats,
    device_platform,
    per_chip_rows,
    write_performance_metrics,
)
from music_analyst_tpu_torch.metrics.timer import StageTimer
from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh


@dataclasses.dataclass
class JointResult:
    analysis: AnalysisResult
    sentiment: SentimentResult
    songs_per_second: float


def run_joint(
    dataset_path: str,
    output_dir: str = "output",
    model: str = "mock",
    mock: bool = False,
    word_limit: int = 0,
    artist_limit: int = 0,
    limit: Optional[int] = None,
    batch_size: int = 4096,
    mesh=None,
    write_split: bool = True,
    ingest_backend: str = "auto",
    quiet: bool = False,
    prefetch_depth: Optional[int] = None,
    corpus_cache_dir: Optional[str] = None,
    use_corpus_cache: bool = True,
    chunk_songs=None,
    device: DeviceLike = "cuda",
) -> JointResult:
    if mesh is None:
        mesh = data_parallel_mesh(device=device)
    timer = StageTimer()
    with timer.stage("ingest"):
        # capture_records=True keys its own cache entries (the record
        # arena rides along), so a warm hit restores the classifier input.
        corpus = ingest_dataset(
            dataset_path,
            limit=limit,
            backend=ingest_backend,
            capture_records=True,
            cache_dir=resolve_cache_dir(corpus_cache_dir, use_corpus_cache),
        )
    with timer.stage("wordcount"):
        analysis = run_analysis(
            dataset_path,
            output_dir=output_dir,
            word_limit=word_limit,
            artist_limit=artist_limit,
            limit=limit,
            mesh=mesh,
            write_split=write_split,
            quiet=quiet,
            corpus=corpus,
            ingest_seconds=timer.seconds["ingest"],
            chunk_songs=chunk_songs,
        )
    with timer.stage("sentiment"):
        sentiment = run_sentiment(
            dataset_path,
            model=model,
            mock=mock,
            output_dir=output_dir,
            batch_size=batch_size,
            quiet=quiet,
            songs=corpus.iter_records(),
            prefetch_depth=prefetch_depth,
            device=mesh.devices[0],
        )
    total = timer.total("ingest", "wordcount", "sentiment")
    songs_per_second = analysis.total_songs / total if total > 0 else 0.0

    # One parse ⇒ one song count everywhere.
    if sum(sentiment.counts.values()) != analysis.total_songs:
        raise RuntimeError(
            "fused pipeline produced inconsistent song counts: "
            f"{sum(sentiment.counts.values())} classified, "
            f"{analysis.total_songs} counted"
        )

    # Re-emit the metrics file with the joint stage breakdown layered in:
    # per-chip compute is the wordcount engine's measured per-shard time
    # (which already holds the shared ingest) plus the classifier stage,
    # which every device spends together.
    sentiment_seconds = timer.seconds["sentiment"]
    per_chip_total = [c + sentiment_seconds for c in analysis.per_chip_compute]
    write_performance_metrics(
        os.path.join(output_dir, "performance_metrics.json"),
        processes=mesh.size,
        total_songs=analysis.total_songs,
        total_words=analysis.total_words,
        compute_time=TimeStats.from_samples(per_chip_total),
        total_time=TimeStats.uniform(total),
        per_chip=per_chip_rows(mesh.devices, per_chip_total),
        stages={
            **analysis.timings,
            "ingest": timer.seconds["ingest"],
            "sentiment": sentiment_seconds,
        },
        device_platform=device_platform(mesh.devices[0]),
    )
    if not quiet:
        print(
            f"Joint pipeline: {analysis.total_songs} songs in {total:.2f}s "
            f"({songs_per_second:.0f} songs/s)"
        )
    return JointResult(analysis, sentiment, songs_per_second)
