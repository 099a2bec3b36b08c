"""ctypes binding to the repo's C++ host library (``native/ingest.cpp``).

The port's own copy of the one binding it needs from
``music_analyst_tpu/data/native.py``: batch hash tokenization.  The library
is compiled with the host C++ compiler at first use into
``build/torch_kernels/`` (file name keyed by a hash of the source), apart
from the JAX package's build.  Where no compiler is found or the build
fails, :func:`available` is False and callers tokenize in Python — a host
fallback with identical ids, never a device one.
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
            lib.man_hash_tokenize_batch.restype = None
            lib.man_hash_tokenize_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
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
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
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
