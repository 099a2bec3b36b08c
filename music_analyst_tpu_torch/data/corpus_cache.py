"""Persistent on-disk corpus cache: content-addressed ``IngestResult``.

The port's copy of ``music_analyst_tpu/data/corpus_cache.py``.  The key,
the on-disk format, :func:`resolve_cache_dir` and
``$MUSICAAL_CORPUS_CACHE`` are unchanged, so an entry written by either
package loads in the other.

* **Content-addressed key** — (schema version, backend, file size,
  BLAKE2b content hash, limit, capture flag).  Renames and mtime churn
  don't invalidate; any byte change does.
* **Zero-copy load** — the dense arrays are stored as ``.npy`` and come
  back via ``np.load(..., mmap_mode="r")``: read-only maps.  A consumer
  that makes a tensor of one copies it first (``torch.from_numpy`` of a
  read-only array would alias memory torch believes writable).
* **Length-prefixed vocab blobs** — concatenated UTF-8 token bytes plus
  an int32 length per token: artist names may contain newlines.
* **Atomic writes** — entries are staged in a tmp dir and published with
  one ``os.rename``; concurrent writers race benignly.
* **Corruption-tolerant** — any load failure (truncated ``.npy``, stale
  schema, meta mismatch) deletes the entry and counts as a miss, so the
  caller re-ingests.  The cache never fails a run.

The JAX package's telemetry counters, publish retry and fault-injection
seam are not ported; :func:`cache_stats` keeps the counts.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

SCHEMA_VERSION = 1

_META_NAME = "meta.json"
_HASH_CHUNK = 1 << 22  # 4 MiB reads: streaming hash, bounded memory

# Process-lifetime stats (the port has no telemetry to mirror them into).
_STATS_LOCK = threading.Lock()
_STATS: Dict[str, int] = {
    "hits": 0,
    "misses": 0,
    "stores": 0,
    "corrupt": 0,
    "bytes_saved": 0,
}


def _bump(name: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[name] += n


def cache_stats() -> Dict[str, int]:
    """Snapshot of this process's hit/miss/store/corrupt/bytes-saved."""
    with _STATS_LOCK:
        return dict(_STATS)


def resolve_cache_dir(
    cache_dir: Optional[str] = None, use_cache: Optional[bool] = None
) -> Optional[str]:
    """The directory to cache under, or ``None`` when caching is off.

    ``use_cache=False`` (the ``--no-corpus-cache`` flag) always wins;
    then an explicit ``cache_dir`` (``--corpus-cache-dir``), then
    ``$MUSICAAL_CORPUS_CACHE`` (``0``/``off``/``false`` disables), then
    the user-level default.
    """
    if use_cache is False:
        return None
    if cache_dir:
        return cache_dir
    env = os.environ.get("MUSICAAL_CORPUS_CACHE", "").strip()
    if env.lower() in ("0", "off", "false", "no"):
        return None
    if env:
        return env
    return os.path.expanduser("~/.cache/musicaal_corpus")


def _content_hash(path: str) -> str:
    digest = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_HASH_CHUNK)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def corpus_key(
    path: str,
    limit: Optional[int],
    capture_records: bool,
    backend: str,
) -> str:
    """Content-addressed entry name.  Hashing the file is the warm-path
    cost floor (~GB/s) — orders of magnitude under re-parsing it."""
    size = os.path.getsize(path)
    return (
        f"v{SCHEMA_VERSION}-{backend}-{size}-{_content_hash(path)}"
        f"-limit{'all' if limit is None else int(limit)}"
        f"-rec{int(bool(capture_records))}"
    )


def _vocab_paths(entry: str, kind: str) -> tuple:
    return (
        os.path.join(entry, f"{kind}_vocab.bin"),
        os.path.join(entry, f"{kind}_vocab_lens.npy"),
    )


def _write_vocab(entry: str, kind: str, tokens: List[str]) -> int:
    blob_path, lens_path = _vocab_paths(entry, kind)
    encoded = [t.encode("utf-8", errors="surrogatepass") for t in tokens]
    lens = np.asarray([len(e) for e in encoded], dtype=np.int32)
    with open(blob_path, "wb") as fh:
        for e in encoded:
            fh.write(e)
    np.save(lens_path, lens)
    return int(lens.sum()) if len(encoded) else 0


def _read_vocab(entry: str, kind: str, expected: int) -> List[str]:
    blob_path, lens_path = _vocab_paths(entry, kind)
    lens = np.load(lens_path)
    if lens.shape[0] != expected:
        raise ValueError(
            f"{kind} vocab length mismatch: {lens.shape[0]} != {expected}"
        )
    with open(blob_path, "rb") as fh:
        blob = fh.read()
    if len(blob) != int(lens.sum() if lens.size else 0):
        raise ValueError(f"{kind} vocab blob truncated")
    tokens: List[str] = []
    pos = 0
    for n in lens.tolist():
        tokens.append(blob[pos : pos + n].decode("utf-8", "surrogatepass"))
        pos += n
    return tokens


def store(
    cache_dir: str,
    path: str,
    limit: Optional[int],
    capture_records: bool,
    backend: str,
    result: Any,
) -> bool:
    """Persist ``result`` (an ``IngestResult``) atomically; never raises.

    Staged under ``<key>.tmp-<pid>-<uuid>`` then published with one
    ``rename``; a concurrent writer that won the race just costs this
    writer its discarded tmp dir.
    """
    try:
        key = corpus_key(path, limit, capture_records, backend)
        final = os.path.join(cache_dir, key)
        if os.path.isdir(final):
            return True
        os.makedirs(cache_dir, exist_ok=True)
        tmp = os.path.join(
            cache_dir, f"{key}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        os.makedirs(tmp)
        try:
            np.save(os.path.join(tmp, "word_ids.npy"),
                    np.ascontiguousarray(result.word_ids, dtype=np.int32))
            np.save(os.path.join(tmp, "word_offsets.npy"),
                    np.ascontiguousarray(result.word_offsets, dtype=np.int64))
            np.save(os.path.join(tmp, "artist_ids.npy"),
                    np.ascontiguousarray(result.artist_ids, dtype=np.int32))
            _write_vocab(tmp, "word", result.word_vocab.tokens)
            _write_vocab(tmp, "artist", result.artist_vocab.tokens)
            if capture_records and result.has_records:
                with open(os.path.join(tmp, "records.bin"), "wb") as fh:
                    fh.write(result.records_blob)
                np.save(os.path.join(tmp, "record_offsets.npy"),
                        np.ascontiguousarray(result.record_offsets,
                                             dtype=np.int64))
            meta = {
                "schema": SCHEMA_VERSION,
                "backend": backend,
                "file_size": os.path.getsize(path),
                "limit": limit,
                "capture_records": bool(capture_records),
                "song_count": int(result.song_count),
                "token_count": int(result.token_count),
                "word_vocab_size": len(result.word_vocab),
                "artist_vocab_size": len(result.artist_vocab),
                "source_path": os.path.abspath(path),
            }
            with open(os.path.join(tmp, _META_NAME), "w",
                      encoding="utf-8") as fh:
                json.dump(meta, fh)
            try:
                os.rename(tmp, final)
            except OSError:
                # Lost the publish race — the winner's entry is equivalent
                # (content-addressed), so dropping ours is correct.
                shutil.rmtree(tmp, ignore_errors=True)
                return os.path.isdir(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _bump("stores")
        return True
    except Exception:
        # Cache is an optimization only; never fail an ingest over it.
        return False


def load(
    cache_dir: str,
    path: str,
    limit: Optional[int],
    capture_records: bool,
    backend: str,
) -> Optional[Any]:
    """Return a cached ``IngestResult`` or ``None`` (miss/corruption).

    Id arrays come back memory-mapped read-only (zero-copy); a corrupt
    entry is deleted and treated as a miss so the caller re-ingests.
    """
    from music_analyst_tpu_torch.data.ingest import IngestResult
    from music_analyst_tpu_torch.data.vocab import Vocab

    try:
        key = corpus_key(path, limit, capture_records, backend)
    except OSError:
        return None
    entry = os.path.join(cache_dir, key)
    if not os.path.isdir(entry):
        _bump("misses")
        return None
    try:
        with open(os.path.join(entry, _META_NAME), encoding="utf-8") as fh:
            meta = json.load(fh)
        if meta.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"stale schema {meta.get('schema')} != {SCHEMA_VERSION}"
            )
        songs = int(meta["song_count"])
        tokens = int(meta["token_count"])
        word_ids = np.load(os.path.join(entry, "word_ids.npy"), mmap_mode="r")
        word_offsets = np.load(
            os.path.join(entry, "word_offsets.npy"), mmap_mode="r"
        )
        artist_ids = np.load(
            os.path.join(entry, "artist_ids.npy"), mmap_mode="r"
        )
        if (word_ids.shape[0] != tokens
                or word_offsets.shape[0] != songs + 1
                or artist_ids.shape[0] != songs
                or (tokens and int(word_offsets[-1]) != tokens)):
            raise ValueError("id array shapes disagree with meta")
        word_vocab = Vocab(
            _read_vocab(entry, "word", int(meta["word_vocab_size"]))
        )
        artist_vocab = Vocab(
            _read_vocab(entry, "artist", int(meta["artist_vocab_size"]))
        )
        records_blob = None
        record_offsets = None
        if capture_records:
            if not meta.get("capture_records"):
                raise ValueError("entry lacks captured records")
            with open(os.path.join(entry, "records.bin"), "rb") as fh:
                records_blob = fh.read()
            record_offsets = np.load(
                os.path.join(entry, "record_offsets.npy"), mmap_mode="r"
            )
            if record_offsets.shape[0] != 3 * songs + 1 or (
                songs and int(record_offsets[-1]) != len(records_blob)
            ):
                raise ValueError("record arena disagrees with meta")
        result = IngestResult(
            word_vocab=word_vocab,
            word_ids=word_ids,
            word_offsets=word_offsets,
            artist_vocab=artist_vocab,
            artist_ids=artist_ids,
            song_count=songs,
            records_blob=records_blob,
            record_offsets=record_offsets,
        )
    except Exception:
        _bump("corrupt")
        _bump("misses")
        shutil.rmtree(entry, ignore_errors=True)
        return None
    _bump("hits")
    try:
        _bump("bytes_saved", os.path.getsize(path))
    except OSError:
        pass
    return result
