"""Batched sentiment pipeline (``sentiment_classifier.py`` parity).

Counterpart of ``music_analyst_tpu/engines/sentiment.py``: songs stream
from the CSV in batches through a bounded prefetch pipeline (tokenize →
transfer + launch) to a classifier backend on the card, and the reference
artifacts are written byte for byte: ``sentiment_totals.json``
(label→count, 2-space JSON) and ``sentiment_details.csv``
(``artist,song,label,latency_seconds`` with 4-decimal latency).

Backends: ``mock`` (keyword-scan kernel), ``distilbert*`` (encoder
classifier with the flash-attention kernel; ``-int8`` and ``weight_quant``
quantize its projections), ``llama*`` (zero-shot decoder; its continuous
generation decodes through the paged-attention kernel; ``-int8`` and
``weight_quant`` as for DistilBERT) and ``ollama[:tag]`` (the reference's
HTTP path, whose per-song request latency is written as measured).
Telemetry is JAX's: the ``sentiment`` run scope, the ``backend_init``,
``ingest``, ``compute`` and ``write`` spans (the backend loads through
``serving/residency.py``, as in JAX), the ``rows_classified`` counter and
the pipeline's stage accounting.  Resilience as in JAX: the ``h2d`` stage
opens with the ``h2d.transfer`` fault seam (the prefetch stage retry
re-runs the whole stage), and ``collect`` runs inside the
``sentiment.collect`` watchdog scope (kind ``device``) and
:func:`run_with_failover`, whose re-init reloads the backend through the
residency (when this engine built it) and re-submits the batch.  There is
no degrade: a second failure raises.

``mesh=`` (``sentiment --devices N``) hands a ``parallel/mesh.DeviceMesh``
to the on-device model families (:func:`mesh_capable`); the keyword
kernel and Ollama take none, as in JAX.  Every rank runs this engine on
the same batches (the backend splits each batch's rows and gathers the
labels); only the coordinator writes ``sentiment_details.csv`` and
``sentiment_totals.json``, and its ``--resume`` skip count is broadcast
so every rank skips the same rows.
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
from music_analyst_tpu_torch.engines.families import mesh_capable
from music_analyst_tpu_torch.observability import watchdog
from music_analyst_tpu_torch.parallel import multihost
from music_analyst_tpu_torch.resilience.failover import run_with_failover
from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.runtime import (
    PrefetchPipeline,
    Stage,
    resolve_prefetch_depth,
)
from music_analyst_tpu_torch.telemetry import get_telemetry
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
    (``--mock`` wins over ``--model``, as in the reference).  A ``mesh``
    is dropped for the families that take none."""
    if not mesh_capable(model, mock):
        kwargs.pop("mesh", None)
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
    if mock or model == "mock":
        from music_analyst_tpu_torch.models.mock import MockKeywordClassifier

        return MockKeywordClassifier(device=device, **kwargs)
    if model.startswith("ollama:") or model == "ollama":
        from music_analyst_tpu_torch.models.ollama import OllamaClassifier

        tag = model.split(":", 1)[1] if ":" in model else "llama3"
        return OllamaClassifier(model=tag, **kwargs)
    if has_wq:
        kwargs["weight_quant"] = weight_quant
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
    weight_quant: Optional[str] = None,
    mesh=None,
) -> SentimentResult:
    """Classify the dataset and write the reference output artifacts.

    Rows stream into ``sentiment_details.csv`` as each batch completes, so
    a killed run leaves a valid prefix; ``resume=True`` continues from it.
    ``songs`` replaces the dataset read with ``(artist, song, text)`` rows.
    ``prefetch_depth`` bounds how many batches ride ahead of the device
    (default 2, ``$MUSICAAL_PREFETCH_DEPTH``; 0 = no overlap).  ``backend``
    injects a constructed backend; otherwise one is built on ``device``
    (``weight_quant`` "int8"/"int4" stores the model's kernels quantized).
    A backend that measures each song (``last_latencies``, Ollama) has its
    latencies written as measured; others get the batch's amortized time.
    ``mesh`` runs the model over a mesh of ranks (see the module notes).
    """
    if songs is not None and resume:
        raise ValueError("resume=True cannot be combined with songs=")
    tel = get_telemetry()
    with tel.run_scope("sentiment", output_dir):
        return _run_sentiment_impl(
            tel, dataset_path, model, mock, limit, output_dir, batch_size,
            backend, quiet, resume, songs, length_buckets, prefetch_depth,
            device, weight_quant, mesh,
        )


def _timed_source(tel, source):
    """Yield rows from ``source`` while accumulating pure read time; the
    total lands as ONE ``ingest`` span (per-row spans would swamp the log
    on million-row datasets)."""
    read_s = 0.0
    n = 0
    it = iter(source)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            break
        read_s += time.perf_counter() - t0
        n += 1
        yield item
    tel.record_span("ingest", read_s, rows=n)


def _run_sentiment_impl(
    tel, dataset_path, model, mock, limit, output_dir, batch_size, backend,
    quiet, resume, songs, length_buckets, prefetch_depth, device,
    weight_quant, mesh,
) -> SentimentResult:
    if backend is not None and (
            mesh is not None or _has_buckets(length_buckets)
            or weight_quant not in (None, "none")):
        raise ValueError(
            "mesh=/length_buckets=/weight_quant= configure backend "
            "construction and cannot be combined with an explicit backend="
        )
    coordinator = multihost.is_coordinator()
    quiet = quiet or not coordinator
    if coordinator:
        os.makedirs(output_dir, exist_ok=True)
    depth = resolve_prefetch_depth(prefetch_depth)
    # One owner for the backend's lifetime, as in JAX: the residency
    # loads it (its ``serve.load`` span) on the requested device.
    from music_analyst_tpu_torch.serving.residency import ModelResidency

    extra = {} if mesh is None else {"mesh": mesh}
    residency = ModelResidency(
        model=model, mock=mock, weight_quant=weight_quant, backend=backend,
        device=device, length_buckets=length_buckets, **extra,
    )
    with tel.span("backend_init", model=model, mock=bool(mock)):
        clf = residency.acquire()
    tel.annotate(backend=clf.name, batch_size=batch_size, prefetch_depth=depth)
    if mesh is not None and mesh_capable(model, mock):
        tel.annotate(mesh_shape=mesh.shape, mesh_backend=multihost.backend())

    totals_path = os.path.join(output_dir, "sentiment_totals.json")
    details_path = os.path.join(output_dir, "sentiment_details.csv")

    skip = 0
    counts: Dict[str, int] = {label: 0 for label in SUPPORTED_LABELS}
    if resume and coordinator and os.path.exists(details_path):
        skip, counts = _read_completed_details(details_path)
    # Every rank must skip the coordinator's rows: the batches (and the
    # collectives inside them) line up across ranks.
    skip = multihost.broadcast_from_coordinator(skip)

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
        # Injected h2d.transfer faults recover via the prefetch stage
        # retry (the whole stage body re-runs; launch is idempotent).
        fault_point("h2d.transfer", rows=len(rows_batch))
        t0 = time.perf_counter()
        handle = clf_launch(clf_transfer(prepared))
        # Snapshot measured latencies now: a synchronous backend (Ollama)
        # classifies inside launch and overwrites them on the next batch.
        measured = getattr(clf, "last_latencies", None)
        return rows_batch, handle, t0, list(measured) if measured else None

    def collect(rows_batch, handle):
        # collect() is the edge that blocks on the card; the watchdog
        # classifies a hang there as device_stall.  On a classified device
        # loss the batch is re-submitted once — through a freshly loaded
        # backend when this engine owns its construction — before the
        # failure propagates.
        state = {"handle": handle}

        def _collect():
            with watchdog.watch("sentiment.collect", kind="device"):
                return clf.collect(state["handle"])

        def _reinit():
            nonlocal clf
            if backend is None:
                clf = residency.reload()
            state["handle"] = clf.submit([text for _, _, text in rows_batch])

        return run_with_failover(
            _collect, site="sentiment.collect", reinit=_reinit
        )

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
    source = _timed_source(
        tel,
        songs if songs is not None else iter_songs(dataset_path, limit=limit),
    )
    with (open(details_path, "a" if skip else "w", newline="",
               encoding="utf-8") if coordinator
          else open(os.devnull, "w")) as details_fh:
        writer = csv.DictWriter(
            details_fh, fieldnames=["artist", "song", "label", "latency_seconds"]
        )
        if not skip:
            writer.writeheader()
        # closing(): a collect()/write error must cancel and join the
        # pipeline threads, not leave them prefetching into a dead run.
        with contextlib.closing(pipe.run(batches(source))) as results:
            for rows_batch, handle, t_submit, measured in results:
                with tel.span("compute", rows=len(rows_batch)):
                    labels = collect(rows_batch, handle)
                # Submit→collect wall time per batch, amortized per song,
                # unless the backend measured each song.
                elapsed = time.perf_counter() - t_submit
                tel.observe("sentiment.batch_seconds", elapsed)
                tel.count("rows_classified", len(rows_batch))
                per_song = (
                    elapsed / max(1, len(rows_batch))
                    if clf.reports_latency else 0.0
                )
                exact = measured and len(measured) == len(rows_batch)
                with tel.span("write", rows=len(rows_batch)):
                    for i, ((artist, song, text), label) in enumerate(
                            zip(rows_batch, labels)):
                        if exact:
                            latency = measured[i]
                        else:
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

    if coordinator:
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
