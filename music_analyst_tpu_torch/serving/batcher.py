"""Serving knobs and the request object of the continuous scheduler.

Counterpart of the parts of ``music_analyst_tpu/serving/batcher.py`` that
``serving/decode_loop.py`` reads: ``ServeRequest`` and the resolvers of
the slot count, prefill chunk, page size, pool size, KV quantization and
queue bound.  The environment variables and defaults are the JAX
package's; an explicit value wins and raises when malformed, a malformed
environment value falls back to the default.  The dynamic batcher, SLO
knobs and the threaded server are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

from music_analyst_tpu_torch.utils.shapes import round_pow2

DEFAULT_MAX_QUEUE = 1024
DEFAULT_SLOTS = 8
DEFAULT_PREFILL_CHUNK = 64
DEFAULT_PAGE_SIZE = 16
DEFAULT_KV_PAGES = 0
DEFAULT_KV_QUANT = "none"
KV_QUANT_CHOICES = ("none", "int8")


def _resolve(value: Any, env: str, default: float, *, integer: bool,
             minimum: float) -> float:
    if value is None:
        raw = os.environ.get(env, "").strip()
        if not raw:
            return default
        try:
            parsed = float(raw)
        except ValueError:
            return default
        if not math.isfinite(parsed) or parsed < minimum:
            return default
        return int(parsed) if integer else parsed
    try:
        parsed = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"expected a number >= {minimum}, got {value!r}"
        ) from None
    if not math.isfinite(parsed) or parsed < minimum:
        raise ValueError(f"expected a number >= {minimum}, got {value!r}")
    return int(parsed) if integer else parsed


def resolve_max_queue(value: Any = None) -> int:
    return int(_resolve(value, "MUSICAAL_SERVE_MAX_QUEUE",
                        DEFAULT_MAX_QUEUE, integer=True, minimum=1))


def resolve_slots(value: Any = None) -> int:
    """Decode slot count (``$MUSICAAL_SERVE_SLOTS``), rounded up to a
    power of two."""
    return round_pow2(
        int(_resolve(value, "MUSICAAL_SERVE_SLOTS",
                     DEFAULT_SLOTS, integer=True, minimum=1)),
        1,
    )


def resolve_prefill_chunk(value: Any = None) -> int:
    """Prefill chunk width (``$MUSICAAL_SERVE_PREFILL_CHUNK``)."""
    return int(_resolve(value, "MUSICAAL_SERVE_PREFILL_CHUNK",
                        DEFAULT_PREFILL_CHUNK, integer=True, minimum=1))


def resolve_page_size(value: Any = None) -> int:
    """KV page size in tokens (``$MUSICAAL_SERVE_PAGE_SIZE``): a power of
    two, or 0 for the monolithic per-slot cache."""
    page = int(_resolve(value, "MUSICAAL_SERVE_PAGE_SIZE",
                        DEFAULT_PAGE_SIZE, integer=True, minimum=0))
    if page and (page & (page - 1)):
        if value is not None:
            raise ValueError(
                f"page size must be a power of two (or 0 for the "
                f"monolithic cache), got {value!r}"
            )
        return DEFAULT_PAGE_SIZE
    return page


def resolve_kv_quant(value: Any = None) -> str:
    """KV-page quantization (``$MUSICAAL_SERVE_KV_QUANT``): none or int8."""
    if value is None:
        raw = os.environ.get("MUSICAAL_SERVE_KV_QUANT", "").strip().lower()
        return raw if raw in KV_QUANT_CHOICES else DEFAULT_KV_QUANT
    scheme = str(value).strip().lower()
    if scheme not in KV_QUANT_CHOICES:
        raise ValueError(
            f"kv_quant must be one of {'/'.join(KV_QUANT_CHOICES)}, "
            f"got {value!r}"
        )
    return scheme


def resolve_kv_pages(value: Any = None, n_slots: Optional[int] = None) -> int:
    """KV pool size in pages (``$MUSICAAL_SERVE_KV_PAGES``); 0 sizes it to
    one full sequence per slot.  It must cover one page per slot."""
    pages = int(_resolve(value, "MUSICAAL_SERVE_KV_PAGES",
                         DEFAULT_KV_PAGES, integer=True, minimum=0))
    if pages and n_slots and pages < n_slots:
        if value is not None:
            raise ValueError(
                f"kv pages ({pages}) must cover at least one page per "
                f"slot ({n_slots} slots); pass 0 to auto-size"
            )
        return DEFAULT_KV_PAGES
    return pages


class ServeRequest:
    """One admitted (or shed) request and its settled reply dict."""

    __slots__ = ("id", "op", "text", "response", "meta")

    def __init__(self, rid: Any, op: str, text: str,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.id = rid
        self.op = op
        self.text = text
        self.response: Optional[Dict[str, Any]] = None
        self.meta: Dict[str, Any] = meta or {}

    def complete(self, payload: Dict[str, Any]) -> None:
        self.response = payload

    def succeed(self, **fields: Any) -> None:
        out: Dict[str, Any] = {"id": self.id, "ok": True, "op": self.op}
        out.update(fields)
        self.complete(out)

    def fail(self, kind: str, detail: str = "", **extra: Any) -> None:
        error: Dict[str, Any] = {"kind": kind, "detail": detail}
        error.update(extra)
        self.complete({"id": self.id, "ok": False, "op": self.op,
                       "error": error})

    @property
    def done(self) -> bool:
        return self.response is not None
