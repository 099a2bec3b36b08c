"""Warm model residency: load once, warm once, answer forever.

Counterpart of ``music_analyst_tpu/serving/residency.py``.  A server pays
model load once over its lifetime; this manager owns that lifetime:

* **load once** — the backend resolves through the port's
  ``engines/sentiment.get_backend`` on the requested device, so
  ``--weight-quant`` streams a checkpoint through the quantized cache
  exactly like a batch run;
* **pin for the server lifetime** — the classifier (and its weights on
  the card) is held here until :meth:`release`;
* **warm explicitly** — :meth:`warmup` runs one dummy batch at every
  power-of-two bucket size the batcher can emit.  There is no compile
  cache to fill: the runs load the CUDA kernels and let cuBLAS create its
  handles, so the first real request pays dispatch cost only.

:meth:`reload` drops the backend and loads a fresh one on the same device
(the batcher's failover hook); it never moves the model to the CPU.

``mesh=`` (``--tp N``: a ``tp`` mesh over the server's ranks) is passed to
``get_backend``, as JAX's residency does; the families that take no mesh
drop it there.  Under a mesh every rank holds a residency of its own, and
the server runs :meth:`acquire`, :meth:`reload`, :meth:`warmup` and
:meth:`classify_batch` on all of them through its dispatch stream
(``serving/tp_dispatch.py``), so a reload rebuilds every rank's shard.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from music_analyst_tpu_torch.device import DeviceLike
from music_analyst_tpu_torch.telemetry import get_telemetry


def warmup_sizes(max_batch: int) -> List[int]:
    """The power-of-two bucket ladder the batcher pads into: 1, 2, 4, …
    up to (and including) the bucket covering ``max_batch``."""
    sizes: List[int] = []
    size = 1
    while size < max_batch:
        sizes.append(size)
        size <<= 1
    sizes.append(size)
    return sizes


def _synchronize(backend) -> None:
    device = getattr(backend, "device", None)
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)


class ModelResidency:
    """Load-once, warm-once holder for a classifier backend."""

    def __init__(
        self,
        model: str = "mock",
        mock: bool = False,
        weight_quant: Optional[str] = None,
        backend=None,
        device: DeviceLike = "cuda",
        mesh=None,
        **backend_kwargs: Any,
    ) -> None:
        self.model = model
        self.mock = mock
        self.weight_quant = weight_quant
        self.device = device
        self.mesh = mesh
        # Extra get_backend() options pinned at construction so a reload
        # rebuilds the same backend.
        self.backend_kwargs = backend_kwargs
        self._backend = backend  # injected (tests, chip_smoke.py) — skips loading
        self._lock = threading.Lock()
        self._state: Dict[str, Any] = {
            "model": model,
            "mock": bool(mock),
            "weight_quant": weight_quant or "none",
            "loaded": backend is not None,
            "load_seconds": 0.0,
            "warm": False,
            "warmup": None,
            "reloads": 0,
        }

    # ------------------------------------------------------------- loading

    def acquire(self):
        """The resident backend, loading it on first call (thread-safe)."""
        with self._lock:
            if self._backend is not None:
                return self._backend
            tel = get_telemetry()
            from music_analyst_tpu_torch.engines.sentiment import get_backend

            t0 = time.perf_counter()
            with tel.span("serve.load", model=self.model,
                          weight_quant=self.weight_quant or "none"):
                self._backend = get_backend(
                    self.model,
                    mock=self.mock,
                    weight_quant=self.weight_quant,
                    device=self.device,
                    **({} if self.mesh is None else {"mesh": self.mesh}),
                    **self.backend_kwargs,
                )
            load_s = time.perf_counter() - t0
            self._state.update(
                loaded=True,
                backend=getattr(self._backend, "name", "injected"),
                load_seconds=round(load_s, 6),
            )
            try:
                from music_analyst_tpu_torch.engines.checkpoint import (
                    last_load_stats,
                )

                load_stats = last_load_stats()
                if load_stats:
                    self._state["wq_load"] = load_stats
            except Exception:
                pass
            return self._backend

    # ------------------------------------------------------------- warmup

    def warmup(self, max_batch: int) -> Dict[str, Any]:
        """Run one dummy batch at every batcher bucket size.

        Dummy rows are empty strings (empty lyric → Neutral, so this is
        inert for every backend).  Returns and records ``{sizes, seconds,
        compiles, compile_seconds}``; ``compiles`` counts the CUDA kernel
        libraries the warmup built or loaded (``kernels.py``), the port's
        counterpart of the JAX package's XLA compile count.
        """
        clf = self.acquire()
        tel = get_telemetry()
        sizes = warmup_sizes(max_batch)
        before = tel.compile_stats()
        t0 = time.perf_counter()
        with tel.span("serve.warmup", sizes=sizes):
            for size in sizes:
                clf.collect(clf.submit([""] * size))
            _synchronize(clf)
        warm_s = time.perf_counter() - t0
        after = tel.compile_stats()
        record = {
            "sizes": sizes,
            "seconds": round(warm_s, 6),
            "compiles": after["count"] - before["count"],
            "compile_seconds": round(
                after["seconds"] - before["seconds"], 6
            ),
        }
        with self._lock:
            self._state["warm"] = True
            self._state["warmup"] = record
        tel.annotate(serve_warmup=record)
        return record

    def warmup_decode(self, scheduler) -> Dict[str, Any]:
        """Run every continuous-decode dispatch once before the first
        ``generate`` request (``ContinuousScheduler.warmup``)."""
        tel = get_telemetry()
        with tel.span("serve.warmup_decode"):
            record = scheduler.warmup()
        with self._lock:
            self._state["decode_warmup"] = record
        return record

    def release(self) -> None:
        with self._lock:
            self._backend = None
            self._state["loaded"] = False

    def current(self):
        """The resident backend (loading lazily) — resolve PER CALL so a
        :meth:`reload` swaps the backend under live ops."""
        backend = self._backend
        return backend if backend is not None else self.acquire()

    def classify_batch(self, texts):
        """Labels of ``texts`` from the resident backend (the batcher's
        ``sentiment`` op)."""
        return self.current().classify_batch(texts)

    def reload(self):
        """Drop the (poisoned) backend and load a fresh one on the same
        device: the batcher's failover hook calls this when a dispatch
        failure classifies as device loss, then retries the batch."""
        tel = get_telemetry()
        with self._lock:
            self._backend = None
            self._state["loaded"] = False
            self._state["warm"] = False
            self._state["reloads"] += 1
        tel.count("serving.residency_reloads")
        tel.event("residency_reload", model=self.model)
        return self.acquire()

    # ------------------------------------------------------------ readouts

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._state)
