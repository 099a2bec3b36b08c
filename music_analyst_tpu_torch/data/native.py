"""ctypes binding to the repo's C++ host library (``native/ingest.cpp``).

The port's own copy of the bindings it needs from
``music_analyst_tpu/data/native.py``: batch hash tokenization, the
multithreaded corpus ingest (:func:`ingest_native`, with record capture),
the dataset column split (:func:`split_columns_native`) and the
record-exact byte ranges (:func:`record_range`).  The library is compiled
with the host C++ compiler at first use into ``build/torch_kernels/`` (file
name keyed by a hash of the source), apart from the JAX package's build.
Where no compiler is found or the build fails, :func:`available` is False:
the tokenizers then run in Python and ``ingest_dataset(backend="auto")``
parses in Python — host paths with identical ids, never a device one —
while ``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from music_analyst_tpu_torch.kernels import BUILD_DIR

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SOURCE = os.path.join(_REPO_ROOT, "native", "ingest.cpp")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _library_path() -> str:
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmusicaal-{digest.hexdigest()[:12]}.so")


def _build(target: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, _SOURCE], check=True,
                       capture_output=True, timeout=600)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the signature of every entry point the port calls (raises
    AttributeError if one is absent)."""
    _vp, _i, _ll, _cp = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_char_p)
    signatures = {
        # name: (restype, argtypes)
        "man_hash_tokenize_batch": (None, [
            _cp, _vp, _ll,                 # blob, offsets int64[n+1], n_rows
            _i, _i, _i, _i, _i, _i, _i,    # max_len vocab cls sep pad reserved threads
            _vp, _vp,                      # out ids, out lens
        ]),
        "man_ingest_v2": (_vp, [_cp, _ll, _i, _i]),  # path limit threads capture
        "man_error": (_cp, [_vp]),
        "man_song_count": (_ll, [_vp]),
        "man_token_count": (_ll, [_vp]),
        "man_word_vocab_size": (_i, [_vp]),
        "man_artist_vocab_size": (_i, [_vp]),
        "man_word_vocab_bytes": (_ll, [_vp]),
        "man_artist_vocab_bytes": (_ll, [_vp]),
        "man_copy_word_ids": (None, [_vp, _vp]),
        "man_copy_word_offsets": (None, [_vp, _vp]),
        "man_copy_artist_ids": (None, [_vp, _vp]),
        # Vocab wire format: concatenated UTF-8 bytes + an int32 length
        # per token (artist names may contain newlines).
        "man_copy_word_vocab": (None, [_vp, _vp, _vp]),
        "man_copy_artist_vocab": (None, [_vp, _vp, _vp]),
        "man_records_bytes": (_ll, [_vp]),
        "man_copy_records": (None, [_vp, _vp, _vp]),
        "man_free": (None, [_vp]),
        # dataset, artist out, text out, artist label, text label, threads
        "man_split_columns": (_i, [_cp, _cp, _cp, _cp, _cp, _i]),
        # path, n_procs, p, threads, out int64[3]
        "man_record_ranges": (_ll, [_cp, _i, _i, _i, _vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None when it cannot
    be built (the reason is kept in :func:`load_error`)."""
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            target = _library_path()
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as exc:
            _load_error = str(exc)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def load_error() -> Optional[str]:
    return _load_error


def unavailable_reason() -> str:
    load()
    return _load_error or "unknown"


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def hash_tokenize_batch(
    texts: Sequence[str],
    max_len: int,
    vocab_size: int,
    cls_id: int,
    sep_id: int,
    pad_id: int,
    reserved: int,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """C++ batch hash tokenization (spec: models/tokenization.py)."""
    lib = _require()
    encoded = [t.encode("utf-8", errors="replace") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    blob = b"".join(encoded)
    n = len(encoded)
    out = np.empty((n, max_len), dtype=np.int32)
    lens = np.empty(n, dtype=np.int32)
    lib.man_hash_tokenize_batch(
        blob, offsets.ctypes.data, n, max_len, vocab_size, cls_id, sep_id,
        pad_id, reserved, num_threads, out.ctypes.data, lens.ctypes.data,
    )
    return out, lens


def split_columns_native(
    dataset_path: str,
    artist_path: str,
    text_path: str,
    artist_header: str,
    text_header: str,
    num_threads: int = 0,
) -> bool:
    """C++ column split; returns False when the library is unavailable."""
    lib = load()
    if lib is None:
        return False
    rc = lib.man_split_columns(
        dataset_path.encode("utf-8"),
        artist_path.encode("utf-8"),
        text_path.encode("utf-8"),
        artist_header.encode("utf-8"),
        text_header.encode("utf-8"),
        num_threads,
    )
    if rc != 1:
        raise RuntimeError(f"native column split failed for {dataset_path}")
    return True


def record_range(
    path: str, n_procs: int, p: int, num_threads: int = 0
) -> Tuple[int, int, int, int]:
    """Process ``p``'s record-exact slice of the dataset's data records.

    Returns ``(header_end, begin, end, n_records)`` byte offsets: the
    header record is ``[0, header_end)`` and the slice ``[begin, end)``.
    """
    lib = _require()
    out = (ctypes.c_longlong * 3)()
    n = lib.man_record_ranges(
        path.encode("utf-8"), n_procs, p, num_threads, out,
    )
    if n < 0:
        raise RuntimeError(f"native record scan failed to read {path!r}")
    return int(out[0]), int(out[1]), int(out[2]), int(n)


def _read_vocab(handle, count: int, total_bytes: int, copy_fn) -> list:
    if count == 0:
        return []
    buf = ctypes.create_string_buffer(max(1, total_bytes))
    lens = np.empty(count, dtype=np.int32)
    copy_fn(handle, buf, lens.ctypes.data)
    blob = buf.raw[:total_bytes]
    tokens = []
    pos = 0
    for n in lens.tolist():
        tokens.append(blob[pos : pos + n].decode("utf-8", errors="replace"))
        pos += n
    return tokens


def ingest_native(
    path: str,
    limit: Optional[int] = None,
    num_threads: int = 0,
    capture_records: bool = False,
    cache_dir: Optional[str] = None,
):
    """Run the C++ ingest and wrap the results as an ``IngestResult``.

    ``cache_dir`` plugs this backend into the persistent corpus cache
    (``data/corpus_cache.py``): a hit returns memory-mapped arrays without
    touching the C++ parser, a miss parses then stores under the
    ``native``-keyed entry.
    """
    from music_analyst_tpu_torch.data import corpus_cache
    from music_analyst_tpu_torch.data.ingest import IngestResult
    from music_analyst_tpu_torch.data.vocab import Vocab

    lib = _require()
    if cache_dir:
        cached = corpus_cache.load(
            cache_dir, path, limit, capture_records, "native"
        )
        if cached is not None:
            return cached
    handle = lib.man_ingest_v2(
        path.encode("utf-8"), -1 if limit is None else limit, num_threads,
        1 if capture_records else 0,
    )
    if not handle:
        raise RuntimeError("native ingest failed to allocate")
    try:
        err = lib.man_error(handle)
        if err:
            raise RuntimeError(f"native ingest: {err.decode()}")
        songs = lib.man_song_count(handle)
        tokens = lib.man_token_count(handle)
        word_ids = np.empty(tokens, dtype=np.int32)
        word_offsets = np.empty(songs + 1, dtype=np.int64)
        artist_ids = np.empty(songs, dtype=np.int32)
        if tokens:
            lib.man_copy_word_ids(handle, word_ids.ctypes.data)
        lib.man_copy_word_offsets(handle, word_offsets.ctypes.data)
        if songs:
            lib.man_copy_artist_ids(handle, artist_ids.ctypes.data)
        word_tokens = _read_vocab(
            handle, lib.man_word_vocab_size(handle),
            lib.man_word_vocab_bytes(handle), lib.man_copy_word_vocab,
        )
        artist_tokens = _read_vocab(
            handle, lib.man_artist_vocab_size(handle),
            lib.man_artist_vocab_bytes(handle), lib.man_copy_artist_vocab,
        )
        records_blob = None
        record_offsets = None
        if capture_records:
            n_bytes = lib.man_records_bytes(handle)
            buf = ctypes.create_string_buffer(max(1, n_bytes))
            record_offsets = np.empty(3 * songs + 1, dtype=np.int64)
            lib.man_copy_records(handle, buf, record_offsets.ctypes.data)
            records_blob = buf.raw[:n_bytes]
    finally:
        lib.man_free(handle)
    result = IngestResult(
        word_vocab=Vocab(word_tokens),
        word_ids=word_ids,
        word_offsets=word_offsets,
        artist_vocab=Vocab(artist_tokens),
        artist_ids=artist_ids,
        song_count=int(songs),
        records_blob=records_blob,
        record_offsets=record_offsets,
    )
    if cache_dir:
        corpus_cache.store(
            cache_dir, path, limit, capture_records, "native", result
        )
    return result
