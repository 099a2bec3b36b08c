"""The dispatch stream of a tensor-parallel server: one order for N ranks.

This module has no counterpart in the JAX package.  JAX serves ``--tp
N`` from one process that drives every device of a ``tp`` mesh
(``music_analyst_tpu/serving/server.py:serve_mesh``); each call into the
model is one program over all of them.  In the port each device is a rank,
a process of its own, and requests reach rank 0 only.  So rank 0 runs the
whole server (wire, batcher, continuous scheduler, journal, response
cache), and every call that touches the model's shards goes through
:class:`DispatchStream`: under one process-wide lock it broadcasts a small
descriptor to ranks 1..N-1, then runs the call itself.  Each follower
(:func:`follow`) receives the descriptors in that order and runs each on
its own shard, so the collectives inside a call meet their partners, and
two threads of rank 0 (the batcher's and the scheduler's) cannot
interleave their collectives differently on two ranks.

A descriptor is ``(seq, released, raised, target, method, args,
kwargs)``, pickled:

* an object that a dispatch returned (a decode runtime, the KV caches,
  step inputs uploaded to the card, a slot's snapshot, a pending batch)
  travels as a *handle*: every rank keeps its own equal copy under the
  same handle, so no device value crosses the stream and rank 0 never
  waits for the card to send one.  Handles are numbered ``(seq, i)``,
  the ``i``-th new object of dispatch ``seq``'s result, on every rank
  alike; a rank-0 object already named keeps its handle.  When rank 0's
  object is garbage-collected its handle rides the next descriptor as
  released, and the followers drop their copies;
* the objects both sides were built with (``roots``: the residency, a
  backend) travel by name;
* host values travel by value: numpy arrays and Python values as pickle
  writes them, tensors as dtype, shape and bytes (a tensor on the card
  that no dispatch made costs a copy to the host, counted in
  :meth:`DispatchStream.stats` as ``shipped_device_bytes``);
* ``raised`` says how rank 0's previous call ended (it raised, or it
  returned).  A follower whose own replay of that call ended otherwise
  has a shard that no longer matches rank 0's (a call that changes the
  caches in place and holds no collective fails on one rank alone): it
  raises :class:`StreamDiverged` before it replays anything more, and
  exits non-zero, so the launcher ends every rank.

Each descriptor is one ``multihost.broadcast_bytes``.  A follower waits
for the next descriptor inside a broadcast whose timeout is the group's;
an idle rank 0 sends a no-op every ``heartbeat_s`` (a quarter of the
group timeout), so an idle server trips no timeout, while every
collective inside a dispatch keeps its finite one, and a follower learns
how rank 0's last call ended within ``heartbeat_s``.  A broadcast or a
collective that fails breaks the stream for good: every later call
raises :class:`StreamBroken`, and ``on_break`` (the server's: end every
rank, exit 1) runs once.  A call that raises anything else leaves the
stream as it was, on every rank that raised alike.
"""

from __future__ import annotations

import collections
import io
import pickle
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from music_analyst_tpu_torch.parallel import multihost

STOP = "__stop__"
NOOP = "__noop__"

# Methods that run through the stream, by the kind of object; every other
# attribute of a Remote is this rank's own.  The decode runtimes'
# (ops/kv_pages.py, ops/kv_slots.py) device calls, the classifiers' device
# calls, and the residency's loads and warm-up.
RUNTIME_METHODS = frozenset({
    "upload", "init_caches", "prefill_chunk", "decode_step", "verify_block",
    "copy_page", "free_pages", "free_slots", "snapshot_slot", "restore_slot",
})
BACKEND_METHODS = frozenset({
    "classify_batch", "submit", "collect", "paged_runtime", "slot_runtime",
})
RESIDENCY_METHODS = frozenset({"acquire", "reload", "warmup",
                               "classify_batch"})
# Methods whose result is itself an object every rank holds.
_RESULT_METHODS = {
    "paged_runtime": RUNTIME_METHODS, "slot_runtime": RUNTIME_METHODS,
    "acquire": BACKEND_METHODS, "reload": BACKEND_METHODS,
}
# Leaves that travel by value and are never named by handle.
_VALUES = (type(None), bool, int, float, complex, str, bytes, np.generic,
           np.ndarray, torch.dtype, torch.device, slice, range)


class StreamBroken(RuntimeError):
    """The dispatch stream lost a rank: no call can be replayed."""


class StreamDiverged(StreamBroken):
    """A follower's replay of a call ended otherwise than rank 0's call."""


def _leaves(value) -> Iterator[Any]:
    """The objects of a result or an argument list that handles may name:
    every leaf under tuples, lists and dict values that is not a plain
    value, in a fixed order."""
    if isinstance(value, (tuple, list)):
        for item in value:
            yield from _leaves(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _leaves(item)
    elif not isinstance(value, _VALUES):
        yield value


def _fresh(seq: int, result, known: Callable[[Any], bool]):
    """``(handle, leaf)`` for each leaf of dispatch ``seq``'s result that
    no handle names yet, numbered ``(seq, i)`` alike on every rank; a leaf
    that takes no weak reference keeps its number but no handle (it
    travels by value)."""
    i = 0
    for leaf in _leaves(result):
        if known(leaf):
            continue
        handle = (seq, i)
        i += 1
        try:
            weakref.ref(leaf)
        except TypeError:
            continue
        yield handle, leaf


def _collective_error(exc: BaseException) -> bool:
    """Whether ``exc`` came out of a collective (a peer died, a timeout)."""
    dist_error = getattr(dist, "DistError", None)
    if dist_error is not None and isinstance(exc, dist_error):
        return True
    text = str(exc)
    return isinstance(exc, RuntimeError) and any(
        mark in text for mark in ("gloo", "NCCL", "Connection closed by peer"))


def _tensor_bytes(tensor: torch.Tensor) -> bytes:
    host = tensor.detach().to("cpu").contiguous().reshape(-1)
    return host.view(torch.uint8).numpy().tobytes()


def _tensor_from(dtype: str, shape, data: bytes,
                 device: Optional[torch.device]) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if data:
        flat = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        value = flat.view(dt).reshape(shape)
    else:
        value = torch.empty(shape, dtype=dt)
    return value if device is None else value.to(device)


class Remote:
    """Rank 0's view of an object every rank holds: the methods in
    ``methods`` run through the stream (this rank's object runs the call
    once the descriptor is out); every other attribute is this rank's
    own."""

    __slots__ = ("_stream", "_target", "_methods")

    def __init__(self, stream: "DispatchStream", target,
                 methods: frozenset) -> None:
        self._stream = stream
        self._target = target
        self._methods = methods

    def __getattr__(self, name: str):
        attr = getattr(self._target, name)
        if name not in self._methods:
            return attr
        wrap = _RESULT_METHODS.get(name)

        def dispatched(*args, **kwargs):
            result = self._stream.call(self._target, name, *args, **kwargs)
            return result if wrap is None else Remote(self._stream, result,
                                                      wrap)

        return dispatched


class _Pickler(pickle.Pickler):
    def __init__(self, buf, stream: "DispatchStream") -> None:
        super().__init__(buf, protocol=pickle.HIGHEST_PROTOCOL)
        self._stream = stream

    def persistent_id(self, obj):
        return self._stream._persistent_id(obj)


class DispatchStream:
    """Rank 0's side: every call through :meth:`call` runs on every rank
    of the process group, in one order.

    ``roots`` names the objects each rank built for itself (the followers
    pass the same names to :func:`follow`).  The stream stays silent for
    at most ``heartbeat_s``, a quarter of the group timeout.
    ``on_break(reason)`` runs once if a broadcast or a collective fails
    (with the stream's lock held: it must not call the stream).
    """

    def __init__(self, roots: Dict[str, Any],
                 on_break: Optional[Callable[[str], None]] = None) -> None:
        self._roots = dict(roots)
        self._root_names = {id(obj): name for name, obj in roots.items()}
        # id(obj) -> (handle, weak reference); a dead object's handle waits
        # in _released for the next descriptor.
        self._live: Dict[int, Tuple[Tuple[int, int], weakref.ref]] = {}
        self._released: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._seq = 0
        self._on_break = on_break
        self._broken: Optional[str] = None
        self._closed = False
        # How the last call ended here; each descriptor carries it.
        self._raised = False
        self._last_send = time.monotonic()
        self._stats: Dict[str, Any] = {
            "dispatches": 0, "noops": 0, "descriptor_bytes": 0,
            "descriptor_bytes_max": 0,
            "send_seconds": 0.0, "call_seconds": 0.0,
            "shipped_device_bytes": 0, "by_method": {},
        }
        # method -> [dispatches, send seconds, call seconds]
        self._timing: Dict[str, list] = {}
        self.heartbeat_s = multihost.group_timeout().total_seconds() / 4.0
        self._stop_beat = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat,
                                      name="tp-dispatch-heartbeat",
                                      daemon=True)
        self._beat.start()

    # ------------------------------------------------------------ encoding

    def _ref(self, obj):
        """``obj``'s name on every rank: a root's name or a live handle
        (``None`` when it has neither)."""
        if isinstance(obj, Remote):
            obj = obj._target
        name = self._root_names.get(id(obj))
        if name is not None:
            return ("root", name)
        handle = self._handle(obj)
        return None if handle is None else ("handle", handle)

    def _handle(self, obj):
        """``obj``'s live handle, or ``None``."""
        entry = self._live.get(id(obj))
        return entry[0] if entry is not None and entry[1]() is obj else None

    def _persistent_id(self, obj):
        """How ``obj`` travels in a descriptor: by name, as a tensor's
        dtype, shape and bytes, or (``None``) pickled by value."""
        ref = self._ref(obj)
        if ref is not None or not isinstance(obj, torch.Tensor):
            return ref
        on_card = obj.device.type != "cpu"
        if on_card:
            self._stats["shipped_device_bytes"] += (obj.numel()
                                                    * obj.element_size())
        return ("tensor", str(obj.dtype).rpartition(".")[2],
                tuple(obj.shape), on_card, _tensor_bytes(obj))

    def _check_travels(self, value) -> None:
        for leaf in _leaves(value):
            if isinstance(leaf, torch.Tensor) or self._ref(leaf) is not None:
                continue
            raise TypeError(
                f"dispatch: a {type(leaf).__name__} is neither a handle nor "
                "a root, and does not travel by value")

    def _encode(self, seq, target, method, args, kwargs) -> bytes:
        if method not in (STOP, NOOP):
            if self._ref(target) is None:
                raise TypeError(f"dispatch: the target of {method!r} is "
                                "neither a handle nor a root")
            self._check_travels((args, kwargs))
        released = []
        while self._released:
            released.append(self._released.popleft())
        buf = io.BytesIO()
        try:
            _Pickler(buf, self).dump((seq, tuple(released), self._raised,
                                      target, method, args, kwargs))
        except BaseException:
            self._released.extend(released)  # they ride the next one
            raise
        return buf.getvalue()

    def _register(self, seq: int, result) -> None:
        for handle, leaf in _fresh(seq, result,
                                   lambda leaf: self._handle(leaf) is not None):
            key = id(leaf)
            self._live[key] = (handle,
                               weakref.ref(leaf, self._dropper(key, handle)))

    def _dropper(self, key: int, handle):
        def drop(_ref) -> None:
            entry = self._live.get(key)
            if entry is not None and entry[0] == handle:
                del self._live[key]
            self._released.append(handle)
        return drop

    # ------------------------------------------------------------ the calls

    def _break(self, reason: str) -> None:
        if self._broken is None:
            self._broken = reason
            sys.stderr.write(f"tp dispatch: stream broken: {reason}\n")
            sys.stderr.flush()
            if self._on_break is not None:
                self._on_break(reason)

    def _post(self, seq, target, method, args, kwargs) -> float:
        """Encode and broadcast one descriptor (the lock held); returns
        the seconds the broadcast took."""
        payload = self._encode(seq, target, method, args, kwargs)
        t0 = time.perf_counter()
        try:
            multihost.broadcast_bytes(payload)
        except BaseException as exc:
            self._break(f"sending {method}: {exc}")
            raise StreamBroken(self._broken) from exc
        self._last_send = time.monotonic()
        sent = time.perf_counter() - t0
        st = self._stats
        st["send_seconds"] += sent
        st["descriptor_bytes"] += len(payload)
        st["descriptor_bytes_max"] = max(st["descriptor_bytes_max"],
                                         len(payload))
        return sent

    def call(self, target, method: str, *args, **kwargs):
        """Run ``target.method(*args, **kwargs)`` on every rank (each on
        its own copy of ``target``); returns this rank's result."""
        if isinstance(target, Remote):
            target = target._target
        with self._lock:
            if self._broken is not None:
                raise StreamBroken(self._broken)
            if self._closed:
                raise RuntimeError("dispatch: the stream is closed")
            self._seq += 1
            seq = self._seq
            sent = self._post(seq, target, method, args, kwargs)
            t0 = time.perf_counter()
            self._raised = True
            try:
                result = getattr(target, method)(*args, **kwargs)
            except BaseException as exc:
                if _collective_error(exc):
                    self._break(f"{method}: {exc}")
                    raise StreamBroken(self._broken) from exc
                raise
            else:
                self._raised = False
            finally:
                spent = time.perf_counter() - t0
                st = self._stats
                st["dispatches"] += 1
                st["call_seconds"] += spent
                st["by_method"][method] = st["by_method"].get(method, 0) + 1
                timing = self._timing.setdefault(method, [0, 0.0, 0.0])
                timing[0] += 1
                timing[1] += sent
                timing[2] += spent
            self._register(seq, result)
            return result

    def remote(self, target, methods: frozenset) -> Remote:
        """``target`` with ``methods`` routed through this stream."""
        return Remote(self, target, methods)

    def _heartbeat(self) -> None:
        while not self._stop_beat.wait(self.heartbeat_s / 2.0):
            if time.monotonic() - self._last_send < self.heartbeat_s:
                continue
            with self._lock:
                if self._closed or self._broken is not None:
                    return
                if time.monotonic() - self._last_send < self.heartbeat_s:
                    continue
                self._seq += 1
                try:
                    self._post(self._seq, None, NOOP, (), {})
                except StreamBroken:
                    return
                self._stats["noops"] += 1

    def close(self) -> None:
        """Send ``stop`` (the followers return 0) unless the stream broke;
        idempotent."""
        self._stop_beat.set()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._broken is None:
                self._seq += 1
                try:
                    self._post(self._seq, None, STOP, (), {})
                except StreamBroken:
                    pass
        self._beat.join(timeout=5.0)

    @property
    def broken(self) -> Optional[str]:
        return self._broken

    def stats(self) -> Dict[str, Any]:
        """Counters of the stream: dispatches, no-ops, descriptor bytes
        and the seconds spent broadcasting against the seconds of the
        calls themselves, in all and per method."""
        st = dict(self._stats, by_method=dict(self._stats["by_method"]),
                  live_handles=len(self._live))
        n = max(1, st["dispatches"])
        st["descriptor_bytes_mean"] = st["descriptor_bytes"] / max(
            1, st["dispatches"] + st["noops"])
        st["send_ms_per_dispatch"] = st["send_seconds"] * 1e3 / n
        st["call_ms_per_dispatch"] = st["call_seconds"] * 1e3 / n
        # Per method: the broadcast's ms beside the call's own (which
        # includes the collectives inside it) for one dispatch.
        st["ms_by_method"] = {
            m: {"send_ms": t[1] * 1e3 / t[0], "call_ms": t[2] * 1e3 / t[0]}
            for m, t in list(self._timing.items())}
        return st


class _Unpickler(pickle.Unpickler):
    def __init__(self, data: bytes, roots, table, device) -> None:
        super().__init__(io.BytesIO(data))
        self._roots, self._table, self._device = roots, table, device

    def persistent_load(self, pid):
        kind = pid[0]
        if kind == "root":
            return self._roots[pid[1]]
        if kind == "handle":
            return self._table[pid[1]]
        _, dtype, shape, on_card, data = pid
        return _tensor_from(dtype, shape, data,
                            self._device if on_card else None)


def follow(roots: Dict[str, Any], device=None) -> int:
    """A follower's loop: replay rank 0's descriptors in order on this
    rank's own objects (``roots``, then every object a replayed call
    returned) until ``stop``; returns 0.  ``device`` is where tensors that
    rank 0 sent from its card are put.  A broadcast that fails (rank 0
    gone, or silent past the group timeout) raises, as does a collective
    inside a replayed call, and a replay that ended otherwise than rank 0's
    call (:class:`StreamDiverged`, at the next descriptor)."""
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    # Rank 0's serving threads run under inference mode (batcher.py,
    # decode_loop.py); so does the replay.
    with torch.inference_mode():
        return _replay(roots, device)


def _replay(roots: Dict[str, Any], device) -> int:
    table: Dict[Tuple[int, int], Any] = {}
    named: Dict[int, Tuple[int, int]] = {}  # id(obj) -> handle
    last: Optional[Tuple[str, Optional[BaseException]]] = None
    while True:
        seq, released, raised, target, method, args, kwargs = _Unpickler(
            multihost.broadcast_bytes(None), roots, table, device).load()
        if last is not None and raised != (last[1] is not None):
            mine = (f"raised {type(last[1]).__name__}: {last[1]}"
                    if last[1] is not None else "returned")
            theirs = "raised" if raised else "returned"
            raise StreamDiverged(f"replayed {last[0]} {mine} here; on rank 0 "
                                 f"it {theirs}") from last[1]
        for handle in released:
            obj = table.pop(handle, None)
            if obj is not None and named.get(id(obj)) == handle:
                del named[id(obj)]
        if method == STOP:
            return 0
        if method == NOOP:
            continue
        try:
            result = getattr(target, method)(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — the next descriptor judges
            if _collective_error(exc):
                raise
            last = (method, exc)
            sys.stderr.write(f"tp dispatch: replayed {method} raised "
                             f"{type(exc).__name__}: {exc}\n")
            sys.stderr.flush()
            continue
        last = (method, None)
        for handle, leaf in _fresh(seq, result, lambda leaf: id(leaf) in named):
            table[handle] = leaf
            named[id(leaf)] = handle
