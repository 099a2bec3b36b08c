"""Corpus ingest: dataset file → dense id arrays for the card.

The port's copy of ``music_analyst_tpu/data/ingest.py``.  The host half of
the word/artist-count pipeline produces the aggregates the reference's
per-rank loops feed into hash tables (``src/parallel_spotify.c:918-998``),
as dense id arrays:

* word ids: every >=3-byte token of every lyric, C-tokenizer semantics;
* artist ids: one id per record with a non-empty artist, ``-1`` otherwise
  (empty-artist records still count toward the song total — SURVEY.md §5
  contract #3);
* vocabularies mapping ids back to strings for the host-side sort/export.

Backends: ``python`` (reference-exact oracle, this module) and ``native``
(multithreaded C++, ``data/native.py``); ``auto`` prefers native and
parses in Python when the library cannot be built — a host path with
identical ids.  The JAX package's ingest retry and fault-injection seam
are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from music_analyst_tpu_torch.data.csv_io import iter_dataset_fields
from music_analyst_tpu_torch.data.tokenizer import tokenize_ascii
from music_analyst_tpu_torch.data.vocab import Vocab


@dataclasses.dataclass
class IngestResult:
    """Dense host-side corpus representation."""

    word_vocab: Vocab
    word_ids: np.ndarray       # int32 [total_tokens]
    word_offsets: np.ndarray   # int64 [songs+1] — song s owns ids[off[s]:off[s+1]]
    artist_vocab: Vocab
    artist_ids: np.ndarray     # int32 [songs], -1 for empty artist
    song_count: int
    # Optional captured records (``capture_records=True``): cleaned
    # artist/song/text bytes concatenated in record order; ``record_offsets``
    # holds 3*songs+1 cumulative field ends.  One arena + offsets, not
    # per-record Python strings; rows decode lazily.
    records_blob: Optional[bytes] = None
    record_offsets: Optional[np.ndarray] = None

    @property
    def token_count(self) -> int:
        return int(self.word_ids.shape[0])

    def tokens_per_song(self) -> np.ndarray:
        return np.diff(self.word_offsets)

    @property
    def has_records(self) -> bool:
        return self.records_blob is not None

    def record(self, i: int) -> Tuple[str, str, str]:
        """Decoded ``(artist, song, text)`` for song ``i``."""
        if not self.has_records:
            raise ValueError(
                "records were not captured; ingest with capture_records=True"
            )
        off = self.record_offsets
        start = int(off[3 * i])
        a_end, s_end, t_end = (int(off[3 * i + f + 1]) for f in range(3))
        blob = self.records_blob
        return (
            blob[start:a_end].decode("utf-8", errors="replace"),
            blob[a_end:s_end].decode("utf-8", errors="replace"),
            blob[s_end:t_end].decode("utf-8", errors="replace"),
        )

    def iter_records(self) -> Iterator[Tuple[str, str, str]]:
        """Lazily decode every captured ``(artist, song, text)`` row."""
        if not self.has_records:
            raise ValueError(
                "records were not captured; ingest with capture_records=True"
            )
        for i in range(self.song_count):
            yield self.record(i)


def ingest_python(
    data: bytes,
    limit: Optional[int] = None,
    capture_records: bool = False,
) -> IngestResult:
    """Pure-Python reference-exact ingest (oracle for the native path)."""
    word_vocab = Vocab()
    artist_vocab = Vocab()
    word_add = word_vocab.add
    ids: List[int] = []
    offsets: List[int] = [0]
    artist_ids: List[int] = []
    blob = bytearray() if capture_records else None
    rec_offsets: List[int] = [0] if capture_records else []
    for parsed, (artist_raw, song_raw, text_raw) in enumerate(
        iter_dataset_fields(data)
    ):
        if limit is not None and parsed >= limit:
            break
        ids.extend(word_add(tok) for tok in tokenize_ascii(text_raw))
        offsets.append(len(ids))
        if artist_raw:
            artist = artist_raw.decode("utf-8", errors="replace")
            artist_ids.append(artist_vocab.add(artist))
        else:
            artist_ids.append(-1)
        if capture_records:
            for field in (artist_raw, song_raw, text_raw):
                blob.extend(field)
                rec_offsets.append(len(blob))
    return IngestResult(
        word_vocab=word_vocab,
        word_ids=np.asarray(ids, dtype=np.int32),
        word_offsets=np.asarray(offsets, dtype=np.int64),
        artist_vocab=artist_vocab,
        artist_ids=np.asarray(artist_ids, dtype=np.int32),
        song_count=len(artist_ids),
        records_blob=bytes(blob) if capture_records else None,
        record_offsets=(
            np.asarray(rec_offsets, dtype=np.int64)
            if capture_records
            else None
        ),
    )


def ingest_dataset(
    path: str,
    limit: Optional[int] = None,
    backend: str = "auto",
    num_threads: int = 0,
    capture_records: bool = False,
    cache_dir: Optional[str] = None,
) -> IngestResult:
    """Ingest a dataset CSV with the requested backend.

    ``capture_records=True`` also keeps every cleaned ``(artist, song,
    text)`` row in an arena (see ``IngestResult``), so the joint pipeline
    feeds sentiment from the same single parse.

    ``cache_dir`` (already resolved — see
    ``data/corpus_cache.resolve_cache_dir``) enables the persistent corpus
    cache: a hit skips the parse and maps the id arrays back read-only; a
    miss ingests then stores.  The key includes the backend actually used,
    so a ``python`` request is never served by a native-written entry.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown ingest backend: {backend}")
    if backend in ("auto", "native"):
        from music_analyst_tpu_torch.data import native

        if native.available():
            return native.ingest_native(
                path,
                limit=limit,
                num_threads=num_threads,
                capture_records=capture_records,
                cache_dir=cache_dir,
            )
        if backend == "native":
            raise RuntimeError(
                "native ingest requested but the C++ library is "
                f"unavailable ({native.unavailable_reason()})"
            )
    from music_analyst_tpu_torch.data import corpus_cache

    if cache_dir:
        cached = corpus_cache.load(
            cache_dir, path, limit, capture_records, "python"
        )
        if cached is not None:
            return cached
    with open(path, "rb") as fh:
        data = fh.read()
    result = ingest_python(data, limit=limit, capture_records=capture_records)
    if cache_dir:
        corpus_cache.store(
            cache_dir, path, limit, capture_records, "python", result
        )
    return result
