"""Bounded-depth staged pipeline executor (host↔device overlap).

Trimmed copy of ``music_analyst_tpu/runtime/prefetch.py`` (the port keeps
its own; watchdog, fault injection, stage retries and stage accounting stay
out).  A source iterator feeds a chain of stages, each in its own
thread, joined by bounded queues; the consumer iterates results **in
submission order** while up to ``depth`` items per hop are in flight ahead
of it.  ``depth`` is the backpressure knob: a fast producer blocks instead
of buffering the corpus, and the card holds at most ``depth + 1`` staged
batches.

Failure contract: an exception in any stage (or in the source) is carried
down the chain and re-raised in the consumer promptly; closing the
consumer generator early cancels the pipeline, drains the queues and joins
every thread.  ``depth=0`` runs the same stages inline (no threads).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Sequence

DEFAULT_PREFETCH_DEPTH = 2

# Cancellation poll period for blocking queue ops.
_POLL_S = 0.05
# Thread-join grace at shutdown; a stage fn that ignores the cancel longer
# is left to finish as a daemon rather than hanging the caller.
_JOIN_S = 5.0

_DONE = object()          # end-of-stream sentinel
_CANCELLED = object()     # internal: a queue op gave up on cancellation


class _Failure:
    """Poison pill carrying a stage's exception down the chain."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


@dataclass
class Stage:
    """One pipeline hop: ``fn(item) -> item`` under a stable ``name``.
    ``workers > 1`` runs ``fn`` on a pool of that many threads with up to
    ``2 * workers`` items in flight; results still leave in order."""

    name: str
    fn: Callable[[Any], Any]
    workers: int = 1


def resolve_prefetch_depth(
    value: Any = None, default: int = DEFAULT_PREFETCH_DEPTH
) -> int:
    """Resolve a ``--prefetch-depth`` value: explicit argument wins, then
    ``$MUSICAAL_PREFETCH_DEPTH``, then the default.  0 = no overlap."""
    if value is None:
        raw = os.environ.get("MUSICAAL_PREFETCH_DEPTH", "").strip()
        if not raw:
            return default
        value = raw
    try:
        depth = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"prefetch depth must be an integer >= 0, got {value!r}"
        ) from None
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth}")
    return depth


class PrefetchPipeline:
    """Run ``source → stages… → consumer`` with ``depth`` items per hop.

    One-shot: build, then iterate :meth:`run`.
    """

    def __init__(
        self,
        stages: Sequence[Stage],
        depth: int = DEFAULT_PREFETCH_DEPTH,
        name: str = "pipeline",
    ) -> None:
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.stages = list(stages)
        for stage in self.stages:
            if stage.workers < 1:
                raise ValueError(
                    f"stage {stage.name!r}: workers must be >= 1, got "
                    f"{stage.workers}")
        self.depth = depth
        self.name = name
        self._cancel = threading.Event()
        self._threads: List[threading.Thread] = []
        self._queues: List[queue.Queue] = []

    def _put(self, q: queue.Queue, item: Any) -> bool:
        """Blocking put that respects cancellation; False on cancel."""
        while not self._cancel.is_set():
            try:
                q.put(item, timeout=_POLL_S)
            except queue.Full:
                continue
            return True
        return False

    def _get(self, q: queue.Queue) -> Any:
        """Blocking get that respects cancellation; ``_CANCELLED`` on
        cancel."""
        while not self._cancel.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return _CANCELLED

    def _pump(self, source: Iterable[Any], q_out: queue.Queue) -> None:
        it = iter(source)
        while True:
            try:
                item = next(it)
            except StopIteration:
                self._put(q_out, _DONE)
                return
            except BaseException as exc:  # forwarded, re-raised in consumer
                self._put(q_out, _Failure(exc))
                return
            if not self._put(q_out, item):
                return

    @staticmethod
    def _call(stage: Stage, item: Any) -> Any:
        try:
            return stage.fn(item)
        except BaseException as exc:  # forwarded, re-raised in consumer
            return _Failure(exc)

    def _stage_loop(
        self, stage: Stage, q_in: queue.Queue, q_out: queue.Queue
    ) -> None:
        pool = (ThreadPoolExecutor(max_workers=stage.workers,
                                   thread_name_prefix=f"{self.name}-{stage.name}")
                if stage.workers > 1 else None)
        window: deque = deque()

        def emit(result) -> bool:
            """Forward one result; False ends the loop (cancelled, or a
            failure that poisons the chain)."""
            return self._put(q_out, result) and not isinstance(result,
                                                               _Failure)

        try:
            while True:
                item = self._get(q_in)
                if item is _CANCELLED:
                    return
                if item is _DONE or isinstance(item, _Failure):
                    while window:
                        if not emit(window.popleft().result()):
                            return
                    self._put(q_out, item)
                    return
                if pool is None:
                    if not emit(self._call(stage, item)):
                        return
                    continue
                window.append(pool.submit(self._call, stage, item))
                if len(window) >= 2 * stage.workers:
                    if not emit(window.popleft().result()):
                        return
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _shutdown(self) -> None:
        """Cancel, drain, join.  Idempotent; never raises."""
        self._cancel.set()
        for q in self._queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for thread in self._threads:
            thread.join(timeout=_JOIN_S)

    def run(self, source: Iterable[Any]) -> Iterator[Any]:
        """Yield each source item after it has passed through every stage,
        in source order.  A stage/source exception re-raises here; closing
        the generator cancels and joins the pipeline."""
        if self.depth == 0:
            yield from self._run_inline(source)
            return
        self._queues = [
            queue.Queue(maxsize=self.depth)
            for _ in range(len(self.stages) + 1)
        ]
        self._threads = [
            threading.Thread(
                target=self._pump, args=(source, self._queues[0]),
                name=f"{self.name}-source", daemon=True,
            )
        ]
        for i, stage in enumerate(self.stages):
            self._threads.append(
                threading.Thread(
                    target=self._stage_loop,
                    args=(stage, self._queues[i], self._queues[i + 1]),
                    name=f"{self.name}-{stage.name}",
                    daemon=True,
                )
            )
        for thread in self._threads:
            thread.start()
        try:
            while True:
                item = self._get(self._queues[-1])
                if item is _DONE or item is _CANCELLED:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            self._shutdown()

    def _run_inline(self, source: Iterable[Any]) -> Iterator[Any]:
        """depth=0: same stages, no threads, no overlap."""
        for item in source:
            for stage in self.stages:
                item = self._call(stage, item)
                if isinstance(item, _Failure):
                    raise item.exc
            yield item
