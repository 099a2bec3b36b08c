"""Batched sentiment pipeline (``sentiment_classifier.py`` parity).

Counterpart of ``music_analyst_tpu/engines/sentiment.py``: songs stream
from the CSV in batches through a bounded prefetch pipeline (tokenize →
transfer + launch) to a classifier backend on the card, and the reference
artifacts are written byte for byte: ``sentiment_totals.json``
(label→count, 2-space JSON) and ``sentiment_details.csv``
(``artist,song,label,latency_seconds`` with 4-decimal latency).

Backends ported so far: ``mock`` (keyword-scan kernel), ``distilbert*``
(encoder classifier with the flash-attention kernel) and ``llama*``
(zero-shot decoder; its continuous generation decodes through the
paged-attention kernel).  Residency,
failover, the watchdog and telemetry are not part of the port yet.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from music_analyst_tpu_torch.data.csv_io import iter_songs
from music_analyst_tpu_torch.device import DeviceLike
from music_analyst_tpu_torch.runtime import (
    PrefetchPipeline,
    Stage,
    resolve_prefetch_depth,
)
from music_analyst_tpu_torch.utils.atomic import atomic_write
from music_analyst_tpu_torch.utils.labels import SUPPORTED_LABELS


@dataclasses.dataclass
class SentimentRow:
    artist: str
    song: str
    label: str
    latency_seconds: float


@dataclasses.dataclass
class SentimentResult:
    counts: Dict[str, int]
    rows: List[SentimentRow]
    output_paths: Dict[str, str]
    songs_per_second: float


class ClassifierBackend:
    """Interface all sentiment backends implement.

    The engine runs ``prepare`` (host tokenize + planning), then
    ``transfer`` + ``launch`` (H2D copy and enqueue of the device work,
    without waiting for it) in pipeline stages ahead of the consumer, which
    blocks in ``collect``.  The defaults collapse all of it into
    ``classify_batch``, so a backend that implements only that works.
    """

    name = "base"
    # Whether per-song latency is meaningful: the reference's mock path
    # records 0.0; device backends report amortized batch latency.
    reports_latency = True

    def classify_batch(self, texts: Sequence[str]) -> List[str]:
        """Labels for a batch of raw lyric strings."""
        raise NotImplementedError

    def prepare(self, texts: Sequence[str]):
        """Host-only work; must not touch the device."""
        return texts

    def transfer(self, prepared):
        """Ship the prepared payload host→device."""
        return prepared

    def launch(self, transferred):
        """Enqueue device work; returns the handle ``collect`` blocks on."""
        return self.submit(transferred)

    def submit(self, texts: Sequence[str]):
        return self.classify_batch(texts)

    def collect(self, handle) -> List[str]:
        return handle


def _has_buckets(length_buckets) -> bool:
    """Whether a ``length_buckets`` value requests bucketing (``None`` and
    empty sequences do not; strings defer to the classifier's check)."""
    if length_buckets is None:
        return False
    if isinstance(length_buckets, str):
        return True
    try:
        return len(length_buckets) > 0
    except TypeError:
        raise TypeError(
            "length_buckets must be a string ('auto') or a sequence of "
            f"ints, got {type(length_buckets).__name__}"
        ) from None


def get_backend(
    model: str,
    mock: bool = False,
    length_buckets: Optional[Sequence[int]] = None,
    weight_quant: Optional[str] = None,
    device: DeviceLike = "cuda",
    **kwargs,
) -> ClassifierBackend:
    """Resolve the ``--model``/``--mock`` flag surface to a backend
    (``--mock`` wins over ``--model``, as in the reference)."""
    if _has_buckets(length_buckets) and (
        mock or not model.startswith("distilbert")
    ):
        raise ValueError(
            "length_buckets is an encoder-classifier option; "
            f"model {model!r} does not support it"
        )
    has_wq = weight_quant not in (None, "none")
    if has_wq and (
        mock or not (model.startswith("distilbert")
                     or model.startswith("llama"))
    ):
        raise ValueError(
            "weight_quant is an on-device model option; "
            f"model {model!r} does not support it"
        )
    if has_wq:
        raise NotImplementedError(
            "weight_quant is not yet ported to music_analyst_tpu_torch"
        )
    if mock or model == "mock":
        from music_analyst_tpu_torch.models.mock import MockKeywordClassifier

        return MockKeywordClassifier(device=device, **kwargs)
    if model.startswith("distilbert"):
        from music_analyst_tpu_torch.models.distilbert import (
            DistilBertClassifier,
        )

        if _has_buckets(length_buckets):
            kwargs["length_buckets"] = (
                length_buckets if isinstance(length_buckets, str)
                else tuple(int(b) for b in length_buckets)
            )
        return DistilBertClassifier.from_pretrained_or_random(
            model, device=device, **kwargs
        )
    if model.startswith("llama"):
        from music_analyst_tpu_torch.models.llama import (
            LlamaZeroShotClassifier,
        )

        return LlamaZeroShotClassifier.from_pretrained_or_random(
            model, device=device, **kwargs
        )
    if model.startswith("ollama"):
        raise NotImplementedError(
            f"model {model!r} is not yet ported to music_analyst_tpu_torch"
        )
    raise ValueError(
        f"unknown model {model!r}: expected 'mock', 'distilbert*' or 'llama*'"
    )


def _read_completed_details(details_path: str) -> Tuple[int, Dict[str, int]]:
    """Rows already classified in a previous (partial) run + their counts.

    A torn final row (kill mid-write) is truncated away first: a newline
    is a row boundary iff the quote count of the prefix ending there is
    even (a newline inside an open quoted field is row content).
    """
    with open(details_path, "rb+") as raw:
        keep = 0
        quotes = 0
        size = 0
        while chunk := raw.read(1 << 22):
            start = 0
            while (nl := chunk.find(b"\n", start)) >= 0:
                quotes += chunk.count(b'"', start, nl)
                if quotes % 2 == 0:
                    keep = size + nl + 1
                start = nl + 1
            quotes += chunk.count(b'"', start)
            size += len(chunk)
        if keep != size:
            raw.truncate(keep)
    done = 0
    counts: Dict[str, int] = {label: 0 for label in SUPPORTED_LABELS}
    with open(details_path, newline="", encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            label = row.get("label", "")
            if label in counts:
                counts[label] += 1
            done += 1
    return done, counts


def run_sentiment(
    dataset_path: str,
    model: str = "mock",
    mock: bool = False,
    limit: Optional[int] = None,
    output_dir: str = "output",
    batch_size: int = 4096,
    backend: Optional[ClassifierBackend] = None,
    quiet: bool = False,
    resume: bool = False,
    songs: Optional[Iterable[Tuple[str, str, str]]] = None,
    length_buckets: Optional[Sequence[int]] = None,
    prefetch_depth: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> SentimentResult:
    """Classify the dataset and write the reference output artifacts.

    Rows stream into ``sentiment_details.csv`` as each batch completes, so
    a killed run leaves a valid prefix; ``resume=True`` continues from it.
    ``songs`` replaces the dataset read with ``(artist, song, text)`` rows.
    ``prefetch_depth`` bounds how many batches ride ahead of the device
    (default 2, ``$MUSICAAL_PREFETCH_DEPTH``; 0 = no overlap).  ``backend``
    injects a constructed backend; otherwise one is built on ``device``.
    """
    if songs is not None and resume:
        raise ValueError("resume=True cannot be combined with songs=")
    if backend is not None and _has_buckets(length_buckets):
        raise ValueError(
            "length_buckets= configures backend construction and cannot be "
            "combined with an explicit backend="
        )
    os.makedirs(output_dir, exist_ok=True)
    depth = resolve_prefetch_depth(prefetch_depth)
    clf = backend if backend is not None else get_backend(
        model, mock=mock, length_buckets=length_buckets, device=device
    )

    totals_path = os.path.join(output_dir, "sentiment_totals.json")
    details_path = os.path.join(output_dir, "sentiment_details.csv")

    skip = 0
    counts: Dict[str, int] = {label: 0 for label in SUPPORTED_LABELS}
    if resume and os.path.exists(details_path):
        skip, counts = _read_completed_details(details_path)

    rows: List[SentimentRow] = []  # rows classified by THIS run
    start = time.perf_counter()

    # Duck-typed backends (test doubles, user plugins) may implement only
    # submit/collect, as the JAX engine allows: missing staged hooks fall
    # back to that, with everything done in the launch stage.
    clf_prepare = getattr(clf, "prepare", None) or (lambda texts: texts)
    clf_transfer = getattr(clf, "transfer", None) or (lambda prepared: prepared)
    clf_launch = getattr(clf, "launch", None) or clf.submit

    def tokenize_stage(rows_batch):
        return rows_batch, clf_prepare([text for _, _, text in rows_batch])

    def h2d_stage(item):
        rows_batch, prepared = item
        t0 = time.perf_counter()
        return rows_batch, clf_launch(clf_transfer(prepared)), t0

    def batches(source):
        batch: List[Tuple[str, str, str]] = []
        for idx, row in enumerate(source):
            if idx < skip:
                continue
            batch.append(row)
            if len(batch) >= batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    pipe = PrefetchPipeline(
        [Stage("tokenize", tokenize_stage), Stage("h2d", h2d_stage)],
        depth=depth,
    )
    source = songs if songs is not None else iter_songs(dataset_path, limit=limit)
    with open(
        details_path, "a" if skip else "w", newline="", encoding="utf-8"
    ) as details_fh:
        writer = csv.DictWriter(
            details_fh, fieldnames=["artist", "song", "label", "latency_seconds"]
        )
        if not skip:
            writer.writeheader()
        # closing(): a collect()/write error must cancel and join the
        # pipeline threads, not leave them prefetching into a dead run.
        with contextlib.closing(pipe.run(batches(source))) as results:
            for rows_batch, handle, t_submit in results:
                labels = clf.collect(handle)
                # Submit→collect wall time per batch, amortized per song.
                elapsed = time.perf_counter() - t_submit
                per_song = (
                    elapsed / max(1, len(rows_batch))
                    if clf.reports_latency else 0.0
                )
                for (artist, song, text), label in zip(rows_batch, labels):
                    latency = 0.0 if not text.strip() else per_song
                    counts[label] += 1
                    rows.append(SentimentRow(artist, song, label, latency))
                    writer.writerow({
                        "artist": artist,
                        "song": song,
                        "label": label,
                        "latency_seconds": f"{latency:.4f}",
                    })
                details_fh.flush()
    wall = time.perf_counter() - start

    with atomic_write(totals_path) as fh:
        json.dump(counts, fh, indent=2)

    if not quiet:
        print("Sentiment summary:")
        for label in SUPPORTED_LABELS:
            print(f"  {label}: {counts[label]}")
        print(f"Detailed results -> {details_path}")
        print(f"Aggregated counts -> {totals_path}")

    return SentimentResult(
        counts=counts,
        rows=rows,
        output_paths={"totals": totals_path, "details": details_path},
        songs_per_second=(len(rows) / wall if wall > 0 else 0.0),
    )
