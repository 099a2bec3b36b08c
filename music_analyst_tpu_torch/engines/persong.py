"""Per-song word counts (``wordcount-per-song``): the serial reference tool.

Counterpart of ``music_analyst_tpu/engines/persong.py`` (reference
``scripts/word_count_per_song.py``).  It writes the same two files byte
for byte: ``word_counts_by_song.csv`` (``artist,song,word,count`` in row
order, each song's words in first-appearance order) and
``word_counts_global.csv`` (``word,count`` ranked by count, ties in
first-seen order — not the parallel engine's alphabetical tie-break; the
reference differs there too).  Tokens follow the reference script's
Latin-1 regex (``data/tokenizer.py:tokenize_latin1``).

Words get dense first-seen ids and fold into a flat count list; the
global ranking is one stable sort on ``-count``.  Tokenization runs on a
multi-worker stage of the prefetch pipeline with results folded in
submission order.  Host-only: no device work.  The run scope, spans and
counters are JAX's (``persong``), and so are the watchdog hooks: the fold
runs inside the ``persong.fold`` scope (kind ``host``) and beats once per
chunk, so a wedged fold or writer classifies as ``host_stall``.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from music_analyst_tpu_torch.data.csv_io import sniff_delimiter
from music_analyst_tpu_torch.data.tokenizer import tokenize_latin1
from music_analyst_tpu_torch.observability import watchdog
from music_analyst_tpu_torch.runtime import PrefetchPipeline, Stage
from music_analyst_tpu_torch.telemetry import get_telemetry

# Rows per tokenize task.
_CHUNK_ROWS = 512
# Chunks in flight ahead of the fold, per worker.
_WINDOW_PER_WORKER = 2

# One song's counts: (artist, song, ((word, count), ...)) in
# first-appearance order, or None when the lyric has no tokens.
_SongCounts = Optional[Tuple[str, str, Tuple[Tuple[str, int], ...]]]


@dataclass
class _DenseHistogram:
    """Insertion-ordered word → count accumulator: dense first-seen ids
    and a flat count list."""

    ids: Dict[str, int] = field(default_factory=dict)
    counts: List[int] = field(default_factory=list)

    def add(self, word: str, n: int) -> None:
        idx = self.ids.setdefault(word, len(self.counts))
        if idx == len(self.counts):
            self.counts.append(n)
        else:
            self.counts[idx] += n

    def ranked(self) -> Iterator[Tuple[str, int]]:
        """Count-descending; ties keep first-seen order (stable sort)."""
        order = sorted(range(len(self.counts)), key=lambda i: -self.counts[i])
        words = list(self.ids)
        return ((words[i], self.counts[i]) for i in order)

    @property
    def total(self) -> int:
        return sum(self.counts)


def _tokenize_chunk(rows: Sequence[Tuple[str, str, str]]) -> List[_SongCounts]:
    """Tokenize a block of ``(artist, song, text)`` rows; records one
    ``tokenize`` span per block (from the pool thread: the registry is
    thread-safe)."""
    start = time.perf_counter()
    out: List[_SongCounts] = []
    for artist, song, text in rows:
        per_song: Dict[str, int] = {}
        for token in tokenize_latin1(text):
            per_song[token] = per_song.get(token, 0) + 1
        out.append((artist, song, tuple(per_song.items())) if per_song else None)
    get_telemetry().record_span(
        "tokenize", time.perf_counter() - start, rows=len(rows)
    )
    return out


def _iter_chunks(
    reader: Iterable[Dict[str, str]], chunk_rows: int
) -> Iterator[List[Tuple[str, str, str]]]:
    chunk: List[Tuple[str, str, str]] = []
    for row in reader:
        # Short rows give None for missing columns: treated as empty.
        chunk.append((
            (row.get("artist") or "").strip(),
            (row.get("song") or "").strip(),
            row.get("text") or "",
        ))
        if len(chunk) >= chunk_rows:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def run_per_song_wordcount(
    csv_path: str,
    output_dir: str = "output/serial_word_counts",
    encoding: str = "utf-8-sig",
    delimiter: Optional[str] = None,
    workers: int = 0,
    quiet: bool = False,
    chunk_rows: int = _CHUNK_ROWS,
) -> Tuple[Path, Path, int]:
    """Write both files; returns ``(global_path, per_song_path, rows)``.

    ``workers`` (0 = one per CPU) tokenize ``chunk_rows``-row blocks in
    parallel; the output does not depend on either.
    """
    src = Path(csv_path)
    if not src.exists():
        raise FileNotFoundError(str(src))
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    global_path = out / "word_counts_global.csv"
    per_song_path = out / "word_counts_by_song.csv"
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    n_workers = workers if workers > 0 else max(1, os.cpu_count() or 1)
    histogram = _DenseHistogram()
    tel = get_telemetry()
    with tel.run_scope("persong", str(out)):
        total_rows = _persong_stream(src, per_song_path, global_path,
                                     encoding, delimiter, n_workers,
                                     histogram, tel, chunk_rows)
        tel.count("rows_processed", total_rows)
        tel.count("distinct_words", len(histogram.counts))
        tel.count("words_counted", histogram.total)
    if not quiet:
        print(
            f"Processed {total_rows} row(s); "
            f"{len(histogram.counts)} distinct words, {histogram.total} total."
        )
        print(f"  global ranking: {global_path}")
        print(f"  per-song rows:  {per_song_path}")
    return global_path, per_song_path, total_rows


def _persong_stream(src, per_song_path, global_path, encoding, delimiter,
                    n_workers, histogram, tel, chunk_rows) -> int:
    total_rows = 0
    with tel.span("ingest", workers=n_workers), \
            open(src, "r", encoding=encoding, newline="") as fh:
        delim = delimiter or sniff_delimiter(fh.read(65536))
        fh.seek(0)
        reader = csv.DictReader(fh, delimiter=delim)
        missing = {"artist", "song", "text"} - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                "CSV is missing expected columns: " + ", ".join(sorted(missing))
            )
        with open(per_song_path, "w", encoding="utf-8", newline="") as ps_fh:
            by_song = csv.writer(ps_fh)
            by_song.writerow(["artist", "song", "word", "count"])

            def fold(chunk_result: List[_SongCounts]) -> None:
                nonlocal total_rows
                # Per-chunk heartbeat: a healthy fold beats often; a wedged
                # writer or reader goes silent and the enclosing watch
                # classifies it as host_stall.
                watchdog.beat("persong.fold")
                for song_counts in chunk_result:
                    total_rows += 1
                    if song_counts is None:
                        continue
                    artist, song, items = song_counts
                    for word, count in items:
                        histogram.add(word, count)
                        by_song.writerow([artist, song, word, count])

            # _tokenize_chunk records its own "tokenize" spans, so the
            # stage does not (record_spans=False).
            pipe = PrefetchPipeline(
                [Stage("tokenize", _tokenize_chunk, workers=n_workers,
                       record_spans=False)],
                depth=_WINDOW_PER_WORKER, name="persong", sink_name="fold",
            )
            # closing(): the pipeline is cancelled and joined before the
            # reader's file goes away.
            with contextlib.closing(
                pipe.run(_iter_chunks(reader, chunk_rows))
            ) as results, watchdog.watch("persong.fold", kind="host"):
                for chunk_result in results:
                    fold(chunk_result)
    with tel.span("write", rows=total_rows), \
            open(global_path, "w", encoding="utf-8", newline="") as g_fh:
        ranked = csv.writer(g_fh)
        ranked.writerow(["word", "count"])
        ranked.writerows(histogram.ranked())
    return total_rows
