"""Build, load and count the port's hand-written CUDA kernels.

Sources live in ``music_analyst_tpu_torch/csrc/``.  At first use each one
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface under ``build/torch_kernels/`` in the checkout, and loaded with
``ctypes``.  A library's file name carries a hash of its source and flags,
so an edited source never loads a stale build.  Nothing is downloaded.

Every kernel wrapper calls :func:`count_launch` right where it launches,
so a run can show that its path went through the kernels:
:func:`reset_launches` before the run, :func:`launches` after.
:func:`build_stats` counts the libraries this process built or loaded
(the port's counterpart of an XLA compile count).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# name -> (source file, its one exported C function, that function's argtypes)
_KERNELS = {
    "flash_attention": (
        "flash_attention.cu",
        "flash_attention_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,           # q k v o m l len qs ks
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,       # B S KV H Hkv D qo ko c r
         ctypes.c_float, _I, _P],                      # scale dtype stream
    ),
    "keyword_scan": (
        "keyword_scan.cu",
        "keyword_scan_fwd",
        [_P, ctypes.c_longlong, _I, _P, _P, _P, _I, _P, _P, _P],
    ),
    "paged_attention": (
        "paged_attention.cu",
        "paged_attention_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,   # q kp vp ks vs tab mask o scratch
         _I, _I, _I, _I, _I, _I, _I,                   # n H n_kv D P pps total
         _I, _I, _I,                                   # chunk splits quant
         ctypes.c_float, _P],                          # scale stream
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, Callable] = {}
_launches: Dict[str, int] = {name: 0 for name in _KERNELS}
_builds = {"count": 0, "seconds": 0.0}


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (called by its wrapper only)."""
    with _lock:
        _launches[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def launches() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def build_stats() -> Dict[str, Any]:
    """Kernel libraries built (nvcc) or loaded by this process, and the
    seconds that took; a warm process adds nothing."""
    with _lock:
        return dict(_builds)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use"
        )
    return path


def library_path(name: str) -> str:
    source = os.path.join(CSRC_DIR, _KERNELS[name][0])
    with open(source, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process, tmp, target)`` or None."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp-{os.getpid()}-{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, _KERNELS[name][0])]
    with open(target[:-3] + ".log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, target


def build(names: List[str] = None, timeout: float = 600.0) -> List[str]:
    """Compile every named kernel library that is not built yet, all nvcc
    processes started together; returns the library paths.  Raises with the
    compiler's log when a build fails."""
    names = list(_KERNELS) if names is None else list(names)
    started = {name: _start_build(name) for name in names}
    errors = []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, target = job
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = -1
        if rc == 0:
            os.replace(tmp, target)
        else:
            with open(target[:-3] + ".log") as fh:
                errors.append(f"{name}: nvcc exit {rc}\n{fh.read()}")
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return [library_path(name) for name in names]


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v`` resource usage) of the current
    build of ``name``; empty when it was built elsewhere."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def kernel(name: str) -> Callable:
    """The C entry point of ``name``, building its library on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            t0 = time.perf_counter()
            path = build([name])[0]
            _, symbol, argtypes = _KERNELS[name]
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
            _builds["count"] += 1
            _builds["seconds"] += time.perf_counter() - t0
    return fn


def check(name: str, status: int) -> None:
    """Raise when a launch returned a CUDA error (refused launch, bad
    argument): such a launch never ran and synchronising would not say so."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")
