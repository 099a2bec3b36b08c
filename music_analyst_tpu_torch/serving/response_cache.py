"""Request-level response cache: content-addressed, cross-restart.

Counterpart of ``music_analyst_tpu/serving/response_cache.py``, copied with its imports
renamed; the port keeps its own copy.

Sentiment, wordcount and greedy generation are pure functions of
(request text, op, generation budget, backend) — yet before this module
every repeat of a popular song re-ran the chip.  The in-flight dedup
tiers (batcher row folding, decode slot folding) only collapse
*simultaneous* identical requests; at catalog scale most repeats arrive
seconds or days apart.  This cache memoizes settled replies across
requests AND across restarts, and is consulted at every admission edge
*before* tenant metering and the shed ladder, so a hit costs one hash +
one dict/file probe, is never charged to token buckets or WFQ, never
occupies a queue slot, and never bills engine-ledger chip-seconds.

Design (the proven ``data/corpus_cache.py`` / ``engines/wq_cache.py``
pattern, applied to replies):

* **Content-addressed key** — BLAKE2b over (schema version, normalized
  text, op, generation budget, backend fingerprint).  The fingerprint
  folds in model family, checkpoint identity, weight-quant and kv-quant
  scheme and any output-relevant config, so a cache shared between
  configurations can never serve a reply computed by a different
  backend.
* **Two tiers** — a bounded in-memory LRU front (``OrderedDict``) for
  the steady-state hit path, and an on-disk tier (one JSON file per
  entry, CRC32-guarded) that survives restarts: a rebooted server warms
  from the catalog its predecessor computed.
* **Atomic publish** — entries are staged as ``<key>.tmp-<pid>-<uuid>``
  and published with one ``os.rename``; concurrent writers race
  benignly (first rename wins, losers discard).
* **Corruption-tolerant, never-fail** — a truncated/CRC-flipped entry
  counts ``corrupt``, is evicted, and reads as a miss so the caller
  recomputes; injected ``response_cache.read``/``response_cache.write``
  faults degrade to recompute the same way.  The cache can never fail a
  request and can never serve a wrong answer — only a recomputed one.
* **Byte-identity** — the stored payload is the settled reply minus its
  ``id`` (insertion order preserved), so a hit rebuilt as
  ``{"id": ...} + payload`` is byte-for-byte what the compute path
  would have written.  The ``cached`` stamp rides in stats and the
  request trace, never in the reply payload.
* **LRU byte-bounded disk tier** — ``max_bytes`` caps the on-disk
  footprint; eviction drops oldest-access entries first (reads touch
  mtime, so a hot catalog survives).

Request identity is :func:`normalize_text` — whitespace runs collapsed,
ends stripped — shared with the in-flight dedup tiers so all
repeat-detection layers agree on what "identical request" means.  For
the whitespace-delimited ASCII tokenizers (sentiment/wordcount) the
collapse is provably output-invariant; for generate it is the serving
layer's declared identity contract: whitespace variants fold onto one
canonical compute, exactly as the decode slot-folding tier does.

Resolution: explicit ``cache_dir`` (``--response-cache-dir``) wins,
then ``$MUSICAAL_RESPONSE_CACHE`` (a directory, or ``0``/``off`` to
disable), then ``~/.cache/musicaal_responses``.  ``--no-response-cache``
/ ``use_cache=False`` opts out.  Stats land in the run manifest's
``serving.response_cache`` section and the metrics plane's series.

Host-side only: no device imports, no device work on any path.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Any, Dict, Optional

from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.serving.slo import RateMeter
from music_analyst_tpu_torch.telemetry import get_telemetry
from music_analyst_tpu_torch.telemetry.reqtrace import get_reqtrace

SCHEMA_VERSION = 1

# Ops whose replies are pure functions of (text, budget, backend) and
# therefore safe to memoize.  Control/introspection ops (ping, stats,
# drain) never reach an admission edge; anything not listed here passes
# through uncached.
CACHEABLE_OPS = frozenset({"sentiment", "wordcount", "generate"})

# Process-lifetime aggregate (mirrored into telemetry counters as they
# happen) — the chaos/bench suites and tests read this without a server
# handle; per-instance counters live on ResponseCache.
_STATS_LOCK = threading.Lock()
_STATS: Dict[str, int] = {
    "lookups": 0,
    "hits": 0,
    "mem_hits": 0,
    "disk_hits": 0,
    "misses": 0,
    "stores": 0,
    "corrupt": 0,
    "evictions": 0,
    "read_fallbacks": 0,
    "write_errors": 0,
}


def _bump(name: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[name] += n
    try:
        get_telemetry().count(f"response_cache.{name}", n)
    except Exception:
        pass


# Pre-rendered telemetry names for the hit path's counter burst — the
# hit path is the whole point of the cache, so its bookkeeping stays
# O(µs): one lock pass, no string formatting.
_MEM_HIT_NAMES = ("lookups", "hits", "mem_hits")
_MEM_HIT_TEL = tuple(f"response_cache.{n}" for n in _MEM_HIT_NAMES)


def _bump_mem_hit() -> None:
    with _STATS_LOCK:
        for name in _MEM_HIT_NAMES:
            _STATS[name] += 1
    try:
        tel = get_telemetry()
        for name in _MEM_HIT_TEL:
            tel.count(name)
    except Exception:
        pass


def cache_stats() -> Dict[str, int]:
    """Process-wide lookup/hit/store/corrupt/eviction aggregate."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_cache_stats() -> None:
    """Zero the process-wide aggregate (test/bench isolation)."""
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def resolve_response_cache_dir(
    cache_dir: Optional[str] = None, use_cache: Optional[bool] = None
) -> Optional[str]:
    """The directory to cache replies under, or ``None`` when off.

    ``use_cache=False`` (the ``--no-response-cache`` flag) always wins;
    then an explicit ``cache_dir`` (``--response-cache-dir``), then
    ``$MUSICAAL_RESPONSE_CACHE`` (``0``/``off``/``false`` disables),
    then the user-level default next to the corpus cache.
    """
    if use_cache is False:
        return None
    if cache_dir:
        return cache_dir
    env = os.environ.get("MUSICAAL_RESPONSE_CACHE", "").strip()
    if env.lower() in ("0", "off", "false", "no"):
        return None
    if env:
        return env
    return os.path.expanduser("~/.cache/musicaal_responses")


def normalize_text(text: str) -> str:
    """Canonical request-identity form shared by every repeat-detection
    tier (in-batch dedup, decode slot folding, this cache): whitespace
    runs collapse to one space, ends strip.  Provably token-invariant
    for the whitespace-delimited ASCII tokenizers; the declared identity
    contract for generate prompts (variants fold onto one compute)."""
    return " ".join(text.split())


FRAMEWORK = "torch"


def backend_fingerprint(**parts: Any) -> str:
    """Canonical fingerprint string from backend identity parts.

    ``None`` values drop out (absent ≠ empty), everything else is
    stringified and key-sorted, so two servers agree on the fingerprint
    iff they agree on every output-relevant knob they set.  Unlike the
    JAX package's, it always folds in ``framework="torch"`` (and the
    server passes the device's name as ``device``): a cache directory
    shared by both packages must never answer one framework with the
    other's bytes.
    """
    parts["framework"] = FRAMEWORK
    kept = sorted(
        (k, str(v)) for k, v in parts.items() if v is not None
    )
    return ";".join(f"{k}={v}" for k, v in kept)


def checkpoint_stamp() -> Optional[str]:
    """Identity stamp for the real-weight checkpoints the ``MUSICAAL_*``
    env vars point at: path + size + mtime per configured artifact (a
    swapped checkpoint at the same path re-keys the cache without
    hashing gigabytes on startup).  ``None`` when no real weights are
    configured — the mock/synthetic backends are fully described by the
    model-name part of the fingerprint."""
    parts = []
    for var in (
        "MUSICAAL_LLAMA_CKPT",
        "MUSICAAL_LLAMA_TOKENIZER",
        "MUSICAAL_DISTILBERT_CKPT",
        "MUSICAAL_BERT_VOCAB",
    ):
        val = os.environ.get(var, "").strip()
        if not val:
            continue
        try:
            st = os.stat(val)
            parts.append(f"{var}:{val}:{st.st_size}:{int(st.st_mtime)}")
        except OSError:
            parts.append(f"{var}:{val}")
    return ";".join(parts) or None


def response_key(
    text: str, op: str, budget: Optional[int], fingerprint: str
) -> str:
    """Content-addressed entry name for one (request, backend) pair.

    The hash material is a flat ``\\x1f``-joined record with the
    normalized text LAST: every other field is fixed-format (version,
    op name, integer budget, server-controlled fingerprint), so with
    the prefix fixed the key is injective in the text — no framing
    needed, and no JSON encoder on the hot hit path."""
    material = (
        f"{SCHEMA_VERSION}\x1f{op}\x1f{budget}\x1f{fingerprint}\x1f"
        f"{normalize_text(text)}"
    )
    digest = hashlib.blake2b(
        material.encode("utf-8", errors="surrogatepass"), digest_size=16
    )
    return f"v{SCHEMA_VERSION}-{op}-{digest.hexdigest()}"


def _payload_crc(payload: Dict[str, Any]) -> int:
    blob = json.dumps(
        payload, separators=(",", ":"), sort_keys=True
    ).encode("utf-8", errors="surrogatepass")
    return zlib.crc32(blob) & 0xFFFFFFFF


class ResponseCache:
    """Two-tier (memory LRU + disk) content-addressed reply store.

    ``cache_dir=None`` disables the disk tier (memory-only: still folds
    repeats within one process, nothing survives a restart).  All
    methods are thread-safe and never raise — the cache is an
    optimization, not a dependency.
    """

    def __init__(
        self,
        cache_dir: Optional[str] = None,
        fingerprint: str = "",
        mem_entries: int = 4096,
        max_bytes: int = 64 << 20,
    ) -> None:
        self.cache_dir = cache_dir
        self.fingerprint = fingerprint
        self.mem_entries = max(1, int(mem_entries))
        self.max_bytes = int(max_bytes)
        self._mem: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hit_meter = RateMeter()
        self.lookup_meter = RateMeter()
        self._stats: Dict[str, int] = {
            k: 0 for k in (
                "lookups", "hits", "mem_hits", "disk_hits", "misses",
                "stores", "corrupt", "evictions", "read_fallbacks",
                "write_errors", "bytes", "bytes_saved",
            )
        }

    # ------------------------------------------------------------- keys

    def key_for(self, op: str, text: str, budget: Optional[int] = None) -> str:
        return response_key(text, op, budget, self.fingerprint)

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._stats[name] += n
        if name in _STATS:
            _bump(name, n)

    # ----------------------------------------------------------- lookup

    def lookup(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored reply payload (id-less, insertion-ordered) or
        ``None``.  Memory tier first; a disk hit is promoted.  Any read
        failure — injected fault, unreadable file, CRC/schema mismatch —
        degrades to a miss (corrupt entries are evicted first)."""
        self.lookup_meter.mark()
        with self._lock:
            cached = self._mem.get(key)
            if cached is not None:
                self._mem.move_to_end(key)
                self._stats["lookups"] += 1
                self._stats["hits"] += 1
                self._stats["mem_hits"] += 1
        if cached is not None:
            _bump_mem_hit()
            self.hit_meter.mark()
            return dict(cached)
        self._count("lookups")
        payload = self._disk_lookup(key)
        if payload is None:
            self._count("misses")
            return None
        self._mem_put(key, payload)
        self._count("hits")
        self._count("disk_hits")
        self.hit_meter.mark()
        return dict(payload)

    def _disk_lookup(self, key: str) -> Optional[Dict[str, Any]]:
        if not self.cache_dir:
            return None
        path = os.path.join(self.cache_dir, f"{key}.json")
        try:
            fault_point("response_cache.read", key=key)
            with open(path, "r", encoding="utf-8") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return None
        except Exception:
            # Fault-injected or an I/O error: fall back to compute.  The
            # entry stays — a transient read may succeed next time; only
            # *structurally corrupt* entries are evicted below.
            self._count("read_fallbacks")
            return None
        try:
            record = json.loads(raw)
            if record.get("schema") != SCHEMA_VERSION:
                raise ValueError("stale schema")
            payload = record["payload"]
            if not isinstance(payload, dict) or not payload.get("ok"):
                raise ValueError("payload is not an ok reply")
            if int(record["crc"]) != _payload_crc(payload):
                raise ValueError("crc mismatch")
        except Exception:
            # Corrupt entries are evicted, never served: recompute is
            # the only way a wrong answer stays impossible.
            self._count("corrupt")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path, None)  # LRU touch for byte-bounded eviction
        except OSError:
            pass
        return payload

    # ------------------------------------------------------------ store

    def _mem_put(self, key: str, payload: Dict[str, Any]) -> None:
        with self._lock:
            self._mem[key] = dict(payload)
            self._mem.move_to_end(key)
            while len(self._mem) > self.mem_entries:
                self._mem.popitem(last=False)

    def put(self, key: str, payload: Dict[str, Any]) -> bool:
        """Persist one settled reply payload; never raises.

        Only ``ok`` replies are cacheable (errors are circumstance, not
        content).  The ``id`` field is stripped — identity belongs to
        the request, not the answer.  Returns True when the entry is
        available (stored now or already present).
        """
        try:
            if not isinstance(payload, dict) or not payload.get("ok"):
                return False
            stored = {k: v for k, v in payload.items() if k != "id"}
            with self._lock:
                already = key in self._mem
            self._mem_put(key, stored)
            if already or not self.cache_dir:
                return True
            return self._disk_put(key, stored)
        except Exception:
            # Cache is an optimization only; never fail a settle over it.
            return False

    def _disk_put(self, key: str, stored: Dict[str, Any]) -> bool:
        final = os.path.join(self.cache_dir, f"{key}.json")
        if os.path.exists(final):
            return True
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            tmp = os.path.join(
                self.cache_dir,
                f"{key}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}",
            )
            record = {
                "schema": SCHEMA_VERSION,
                "key": key,
                "crc": _payload_crc(stored),
                "payload": stored,
            }
            blob = json.dumps(record, separators=(",", ":"))
            fault_point("response_cache.write", key=key)
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(blob)
            try:
                os.rename(tmp, final)
            except OSError:
                # Lost the publish race — the winner's entry is
                # equivalent (content-addressed), drop ours.
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return os.path.exists(final)
            self._count("stores")
            self._count("bytes", len(blob))
            self._evict_over_budget()
            return True
        except Exception:
            self._count("write_errors")
            return False

    def _evict_over_budget(self) -> None:
        """Drop oldest-access entries until the disk tier fits
        ``max_bytes``.  Best-effort: races with concurrent evictors and
        readers are benign (unlink of a missing file is ignored)."""
        try:
            entries = []
            total = 0
            with os.scandir(self.cache_dir) as it:
                for ent in it:
                    if not ent.name.endswith(".json"):
                        continue
                    try:
                        st = ent.stat()
                    except OSError:
                        continue
                    entries.append((st.st_mtime, st.st_size, ent.path))
                    total += st.st_size
            if total <= self.max_bytes:
                return
            for _, size, path in sorted(entries):
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                self._count("evictions")
        except Exception:
            pass

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, Any]:
        """Manifest/metrics snapshot for this instance."""
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["mem_entries"] = len(self._mem)
        lookups = out["lookups"]
        out["hit_rate"] = round(
            out["hits"] / lookups, 6) if lookups else 0.0
        # Average answers served per unique compute: how much repeat
        # traffic the catalog actually carries.
        stores = max(out["stores"], out["mem_entries"], 1)
        out["dedup_factor"] = round(
            (out["hits"] + stores) / stores, 6)
        out["hits_per_s"] = self.hit_meter.rate()
        out["lookups_per_s"] = self.lookup_meter.rate()
        return out


def try_answer(
    cache: Optional[ResponseCache],
    req: Any,
    budget: Optional[int] = None,
) -> bool:
    """Consult ``cache`` for ``req`` at an admission edge; returns True
    when the request was settled from cache.

    Runs *before* the shed ladder and tenant metering by contract: a
    hit is rebuilt as ``{"id": req.id} + stored payload`` (byte-for-byte
    the compute path's reply), stamped ``cached`` in ``req.meta`` (and
    the request trace) but never in the payload, and completed on the
    spot — no queue slot, no token-bucket charge, no chip-seconds.  On
    a miss the key is parked in ``req.meta`` so the settle path can
    populate the entry, and the request proceeds unchanged.
    """
    if cache is None or req.op not in CACHEABLE_OPS:
        return False
    try:
        key = cache.key_for(req.op, req.text, budget)
    except Exception:
        return False
    t0 = time.monotonic()
    payload = cache.lookup(key)
    t1 = time.monotonic()
    try:
        get_reqtrace().detail(
            req, "cache.lookup", t0, t1, hit=payload is not None
        )
    except Exception:
        pass
    if payload is None:
        req.meta["rcache"] = cache
        req.meta["rcache_key"] = key
        return False
    req.meta["cached"] = True
    reply = {"id": req.id}
    reply.update(payload)
    req.complete(reply)
    return True


def populate_from_settle(req: Any) -> None:
    """Settle-path hook: store a freshly computed ok reply under the key
    parked by :func:`try_answer`'s miss.  Called from
    ``ServeRequest.complete`` so every settle route (batch dispatch,
    decode slot, dedup fan-out, router read-loop) populates through ONE
    seam.  Never raises."""
    try:
        meta = req.meta
        if meta.get("cached"):
            return
        cache = meta.get("rcache")
        key = meta.get("rcache_key")
        if cache is None or not key:
            return
        payload = req.response
        if isinstance(payload, dict) and payload.get("ok"):
            cache.put(key, payload)
    except Exception:
        pass
