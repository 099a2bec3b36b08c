"""Durable request journal: write-ahead log for crash-consistent serving.

Counterpart of ``music_analyst_tpu/serving/journal.py``, copied with its imports
renamed; the port keeps its own copy.

Every robustness layer before this PR ends at the process boundary — a
SIGKILL of a server loses every admitted-but-unanswered request, and a
router requeue after worker death can re-execute a request whose reply
was already computed.  This module is the recovery primitive under both:
an append-only, CRC-framed, fsync-batched journal of ``admitted`` and
``replied`` records, consulted on server start to

* **replay** admitted-but-unanswered requests (the restart answers them
  instead of silently forgetting them), and
* serve a bounded **reply-dedup index** so a re-dispatched request id
  returns the journaled reply instead of recomputing — exactly-once at
  the wire, at-most-once on the device.

Format (one segment = ``journal-<seq>.log``)::

    record := u32 length | u32 crc32(payload) | payload  (big-endian)
    payload := JSON: {"kind": "admitted", "id", "op", "text", "tenant",
                       "priority", "deadline_ms", "meta"}
             | JSON: {"kind": "replied", "id", "response"}

A torn tail (crash mid-``write``) or bit-rot fails the length/CRC check;
replay counts it (``corrupt_truncated``), abandons that segment's tail,
and carries on — corruption degrades to recompute, never to a wrong or
duplicate answer (ops are pure functions of their text, so recompute is
byte-identical; the chaos suite drills this at the ``journal.append``
fault site).

Durability protocol: ``admitted`` records batch (one fsync per
``sync_every`` appends); a ``replied`` record is fsync'd *before* the
reply line reaches the wire — group-committed, so replies settled in the
same batch share one fsync.  A reply the client saw is therefore always
deduplicable after a crash; a reply the journal lost was never sent, and
recomputing it is invisible.  Rotation seals the active segment at
``rotate_bytes``; compaction collapses sealed history into one fresh
segment holding only the live state (unanswered admits + the dedup
window) via the repo's tmp+rename pattern with real fsyncs
(``utils/atomic.py`` ``durable=True``).

A ``clean`` marker (written by :meth:`close` after final compaction,
removed on open) is the dirty bit: segments on disk without the marker
mean the previous process never ran its shutdown path — SIGKILL can
never write a flight record, so the journal is the witness the
``unclean_shutdown`` manifest stamp rides on.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.telemetry import get_telemetry
from music_analyst_tpu_torch.utils.atomic import atomic_write, fsync_dir

_HEADER = struct.Struct(">II")
_SEGMENT_PREFIX = "journal-"
_SEGMENT_SUFFIX = ".log"
_CLEAN_MARKER = "clean"

# Defaults: one fsync per 8 admits keeps journal overhead inside the
# ≤10% serving-throughput budget; 4096 remembered replies bound the
# dedup index (a re-dispatched id older than that recomputes — pure ops
# make that correct, just not free); 1 MiB segments keep compaction
# cheap and the unclean-shutdown scan fast.
DEFAULT_SYNC_EVERY = 8
DEFAULT_DEDUP_LIMIT = 4096
DEFAULT_ROTATE_BYTES = 1 << 20


def resolve_journal_dir(value: Any = None) -> Optional[str]:
    """``--journal-dir`` wins; else ``$MUSICAAL_SERVE_JOURNAL``; else None
    (journaling off — the historical, non-durable behavior)."""
    if value is not None and str(value).strip():
        return str(value)
    env = os.environ.get("MUSICAAL_SERVE_JOURNAL", "").strip()
    return env or None


def _key(rid: Any) -> str:
    """Canonical index key for a wire id (any JSON value, not always
    hashable as-is)."""
    try:
        return json.dumps(rid, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return repr(rid)


class RequestJournal:
    """One serving process's write-ahead request journal."""

    def __init__(
        self,
        directory: str,
        *,
        sync_every: int = DEFAULT_SYNC_EVERY,
        dedup_limit: int = DEFAULT_DEDUP_LIMIT,
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
    ) -> None:
        self.directory = os.path.abspath(directory)
        self.sync_every = max(int(sync_every), 1)
        self.dedup_limit = max(int(dedup_limit), 1)
        self.rotate_bytes = max(int(rotate_bytes), 4096)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.RLock()
        self._fh = None
        self._seq = 0
        self._unsynced = 0
        self._closed = False
        # id-key → reply payload, LRU-bounded (the dedup index).
        self._replies: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # id-key → admitted record, for ids not yet replied.
        self._open_admits: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._stats: Dict[str, Any] = {
            "admitted": 0, "replied": 0, "syncs": 0, "rotations": 0,
            "compactions": 0, "replayed": 0, "deduped": 0,
            "corrupt_truncated": 0, "append_errors": 0,
            "unclean_start": False,
        }

    # ------------------------------------------------------------- segments

    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            if (name.startswith(_SEGMENT_PREFIX)
                    and name.endswith(_SEGMENT_SUFFIX)):
                seq_text = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
                try:
                    out.append((int(seq_text), name))
                except ValueError:
                    continue
        return sorted(out)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}{seq:08d}{_SEGMENT_SUFFIX}"
        )

    def _open_active(self, seq: int) -> None:
        self._seq = seq
        self._fh = open(self._segment_path(seq), "ab")

    # -------------------------------------------------------------- recover

    def recover(self) -> List[Dict[str, Any]]:
        """Scan the journal, rebuild the dedup index, and return the
        admitted-but-unanswered records (oldest first) for re-dispatch.

        Must be called exactly once, before the first append.  Detects
        the unclean-shutdown dirty bit (segments without the ``clean``
        marker) and removes the marker so *this* process's crash is
        detectable by the next one.
        """
        with self._lock:
            segments = self._segments()
            marker = os.path.join(self.directory, _CLEAN_MARKER)
            had_marker = os.path.exists(marker)
            if segments and not had_marker:
                self._stats["unclean_start"] = True
            if had_marker:
                try:
                    os.unlink(marker)
                except OSError:
                    pass
            for _, name in segments:
                self._scan_segment(os.path.join(self.directory, name))
            unanswered = list(self._open_admits.values())
            self._stats["replayed"] = len(unanswered)
            next_seq = (segments[-1][0] + 1) if segments else 0
            self._open_active(next_seq)
            if unanswered or self._stats["unclean_start"]:
                get_telemetry().event(
                    "journal_recovered",
                    replayed=len(unanswered),
                    corrupt_truncated=self._stats["corrupt_truncated"],
                    unclean=self._stats["unclean_start"],
                )
            return unanswered

    def _scan_segment(self, path: str) -> None:
        """Apply one segment's records; a torn/corrupt frame abandons the
        segment's tail (everything before it already applied)."""
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            self._stats["corrupt_truncated"] += 1
            return
        offset = 0
        total = len(data)
        while offset < total:
            if offset + _HEADER.size > total:
                self._stats["corrupt_truncated"] += 1
                return
            length, crc = _HEADER.unpack_from(data, offset)
            start = offset + _HEADER.size
            end = start + length
            if length > total - start:
                self._stats["corrupt_truncated"] += 1
                return
            payload = data[start:end]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self._stats["corrupt_truncated"] += 1
                return
            try:
                record = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self._stats["corrupt_truncated"] += 1
                return
            self._apply(record)
            offset = end

    def _apply(self, record: Dict[str, Any]) -> None:
        kind = record.get("kind")
        key = _key(record.get("id"))
        if kind == "admitted":
            if key not in self._replies:
                self._open_admits[key] = record
        elif kind == "replied":
            self._open_admits.pop(key, None)
            self._remember(key, record.get("response") or {})

    def _remember(self, key: str, response: Dict[str, Any]) -> None:
        self._replies[key] = response
        self._replies.move_to_end(key)
        while len(self._replies) > self.dedup_limit:
            self._replies.popitem(last=False)

    # --------------------------------------------------------------- append

    def _append(self, record: Dict[str, Any]) -> bool:
        """Frame + buffer one record (caller holds the lock); False when
        the write failed — the server keeps serving, just un-journaled."""
        fault_point("journal.append", kind=record.get("kind"))
        payload = json.dumps(
            record, separators=(",", ":"), sort_keys=True
        ).encode("utf-8")
        frame = _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        self._fh.write(frame + payload)
        return True

    def _sync(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._unsynced = 0
        self._stats["syncs"] += 1

    def _maybe_rotate(self) -> None:
        if self._fh.tell() < self.rotate_bytes:
            return
        self._sync()
        self._fh.close()
        self._stats["rotations"] += 1
        self._open_active(self._seq + 1)
        # Collapse the sealed history so the directory stays two files
        # and restart replay stays O(live state), not O(all traffic).
        self._compact_locked()

    def record_admitted(self, rid: Any, op: str, text: str, *,
                        tenant: Optional[str] = None,
                        priority: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        meta: Optional[Dict[str, Any]] = None) -> None:
        """Write-ahead the admission (batched fsync: one per
        ``sync_every`` admits).  ``None`` SLO fields journal as null so a
        replay re-submits with the server's own defaults."""
        if self._closed:
            return
        record = {
            "kind": "admitted", "id": rid, "op": op, "text": text,
            "tenant": tenant, "priority": priority,
            "deadline_ms": deadline_ms, "meta": dict(meta or {}),
        }
        with self._lock:
            if self._fh is None:
                raise RuntimeError("journal used before recover()")
            try:
                self._append(record)
                self._open_admits[_key(rid)] = record
                self._stats["admitted"] += 1
                self._unsynced += 1
                if self._unsynced >= self.sync_every:
                    self._sync()
                self._maybe_rotate()
            except Exception:  # noqa: BLE001 — journal must not kill serve
                self._stats["append_errors"] += 1

    def record_replied(self, rid: Any, response: Dict[str, Any], *,
                       sync: bool = True) -> None:
        """Journal the reply and fsync — called BEFORE the reply line is
        written to the wire, so a reply the client saw always survives
        into the dedup index.

        ``sync=False`` is the group-commit half: the caller appends a
        whole batch of settled replies, then calls :meth:`sync` ONCE
        before any of their lines reach the wire — the same durability
        barrier at a fraction of the fsync count."""
        if self._closed:
            return
        record = {"kind": "replied", "id": rid, "response": response}
        with self._lock:
            if self._fh is None:
                raise RuntimeError("journal used before recover()")
            try:
                self._append(record)
                self._stats["replied"] += 1
                if sync:
                    self._sync()
                else:
                    self._unsynced += 1
                self._maybe_rotate()
            except Exception:  # noqa: BLE001
                self._stats["append_errors"] += 1
            key = _key(rid)
            self._open_admits.pop(key, None)
            self._remember(key, response)

    def sync(self) -> None:
        """The group-commit barrier: fsync every appended-but-unsynced
        record.  A failure counts (``append_errors``) instead of raising —
        the server keeps serving, just un-durably."""
        with self._lock:
            if self._fh is None or self._closed:
                return
            try:
                self._sync()
            except Exception:  # noqa: BLE001
                self._stats["append_errors"] += 1

    # ---------------------------------------------------------------- dedup

    def lookup_reply(self, rid: Any) -> Optional[Dict[str, Any]]:
        """The journaled reply for a re-dispatched id, or None.  A hit is
        the exactly-once path: the wire answer replays, nothing
        recomputes."""
        with self._lock:
            response = self._replies.get(_key(rid))
            if response is not None:
                self._stats["deduped"] += 1
                get_telemetry().count("journal.deduped")
                return dict(response)
        return None

    def open_requests(self) -> int:
        with self._lock:
            return len(self._open_admits)

    # ----------------------------------------------------------- compaction

    def _compact_locked(self) -> None:
        """Rewrite live state (open admits + dedup window) into one fresh
        segment and drop every older one.  tmp+rename with real fsyncs:
        a crash at ANY point leaves either the old segments or old+new —
        both replay to the same state (records are idempotent upserts)."""
        old = self._segments()
        if self._fh is not None:
            self._sync()
            self._fh.close()
            self._fh = None
        new_seq = (old[-1][0] + 1) if old else self._seq + 1
        path = self._segment_path(new_seq)
        with atomic_write(path, mode="wb", encoding=None,
                          durable=True) as fh:
            for record in self._open_admits.values():
                payload = json.dumps(
                    record, separators=(",", ":"), sort_keys=True
                ).encode("utf-8")
                fh.write(_HEADER.pack(
                    len(payload), zlib.crc32(payload) & 0xFFFFFFFF
                ) + payload)
            for key, response in self._replies.items():
                try:
                    rid = json.loads(key)
                except ValueError:  # non-JSON id (programmatic caller)
                    continue
                record = {
                    "kind": "replied", "id": rid,
                    "response": response,
                }
                payload = json.dumps(
                    record, separators=(",", ":"), sort_keys=True
                ).encode("utf-8")
                fh.write(_HEADER.pack(
                    len(payload), zlib.crc32(payload) & 0xFFFFFFFF
                ) + payload)
        # The mid-compaction crash seam: the compacted segment is
        # published, the sealed history not yet dropped.
        fault_point("journal.compact", segments=len(old))
        for _, name in old:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass
        fsync_dir(self.directory)
        self._stats["compactions"] += 1
        self._open_active(new_seq + 1)

    def compact(self) -> None:
        with self._lock:
            if self._fh is None or self._closed:
                return
            try:
                self._compact_locked()
            except Exception:  # noqa: BLE001
                self._stats["append_errors"] += 1
                if self._fh is None:
                    self._open_active(self._seq + 1)

    # ---------------------------------------------------------------- close

    def close(self) -> None:
        """Graceful shutdown: final compaction + the ``clean`` marker.
        A SIGKILL never gets here — which is exactly how the next start
        knows."""
        with self._lock:
            if self._closed or self._fh is None:
                return
            try:
                self._compact_locked()
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._fh = None
            self._closed = True
            try:
                marker = os.path.join(self.directory, _CLEAN_MARKER)
                with atomic_write(marker, durable=True) as fh:
                    fh.write("clean\n")
            except OSError:
                pass

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """The run manifest's ``serving.journal`` section."""
        with self._lock:
            out = dict(self._stats)
            out.update(
                directory=self.directory,
                sync_every=self.sync_every,
                dedup_limit=self.dedup_limit,
                open_requests=len(self._open_admits),
                dedup_index=len(self._replies),
            )
        return out
