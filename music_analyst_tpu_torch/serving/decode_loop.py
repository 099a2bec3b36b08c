"""Continuous-batching scheduler: admit → prefill → decode over KV pages.

Counterpart of ``music_analyst_tpu/serving/decode_loop.py``, synchronous
use only (``submit`` then :meth:`ContinuousScheduler.run_until_idle`).
``n_slots`` sequences decode side by side; an admitted request claims a
free slot, its prompt is prefilled one chunk per tick between decode
dispatches, and EOS or its token budget frees the slot at once.

The KV cache is paged (``ops/kv_pages.py``).  At admission a radix tree
keyed on the prompt's token ids finds the longest cached prefix: shared
full pages are pinned and mapped, the partly filled boundary page is
copied (copy-on-write), fully shared chunks are skipped, and the rest of
the row is freshly allocated, evicting cold unpinned pages when the pool
is full.  A completed prefill's pages are adopted into the tree;
completion unpins.  A failed lookup falls back to a full prefill, and a
request whose prefill raises fails alone.

Not ported yet: the threaded loop and server, SLO / tenants / fair
queueing, preemption and checkpoints, speculation, in-batch dedup, the
response cache, the journal, the watchdog, fault points, telemetry and
the engine ledger.  ``page_size=0`` (the monolithic slot cache) raises.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from music_analyst_tpu_torch.ops.kv_pages import PagePool, RadixIndex
from music_analyst_tpu_torch.serving.batcher import (
    ServeRequest,
    resolve_kv_pages,
    resolve_kv_quant,
    resolve_max_queue,
    resolve_page_size,
    resolve_prefill_chunk,
    resolve_slots,
)
from music_analyst_tpu_torch.utils.labels import normalise_label


class _Slot:
    """Host-side state of one occupied slot."""

    __slots__ = ("req", "ids", "plen", "next_chunk", "budget", "steps",
                 "tokens", "carry", "done", "active", "pages",
                 "kv_shared", "skipped")

    def __init__(self, req: ServeRequest, ids: np.ndarray, plen: int,
                 budget: int) -> None:
        self.req = req
        self.ids = ids
        self.plen = int(plen)
        self.next_chunk = 0        # next prefill chunk offset; -1 = prefilled
        self.budget = int(budget)
        self.steps = 0             # decode steps taken
        self.tokens: List[int] = []
        self.carry = 0             # input token of the next step
        self.done = False          # emitted EOS
        self.active = False        # in the decode phase
        self.pages: Optional[List[int]] = None   # this slot's table row
        self.kv_shared = 0         # tokens served from shared pages
        self.skipped = 0           # prefill chunks skipped by the hit


class ContinuousScheduler:
    """Admit→prefill→decode loop over a backend's paged runtime.

    ``backend`` exposes ``paged_runtime(...)`` and ``tokenizer``
    (``models/llama.py``'s zero-shot classifier).
    """

    def __init__(
        self,
        backend,
        n_slots: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prompt_region: Optional[int] = None,
        max_new_tokens: int = 16,
        decode_span: int = 4,
        max_queue: Optional[int] = None,
        page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
        kv_quant: Optional[str] = None,
        prefix_cache: bool = True,
    ) -> None:
        self.backend = backend
        self.n_slots = resolve_slots(n_slots)
        self.prefill_chunk = resolve_prefill_chunk(prefill_chunk)
        self.max_queue = resolve_max_queue(max_queue)
        page = resolve_page_size(page_size)
        if not page:
            raise NotImplementedError(
                "page_size=0 (the monolithic slot cache, ops/kv_slots.py) is "
                "not yet ported to music_analyst_tpu_torch"
            )
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.runtime = backend.paged_runtime(
            n_slots=self.n_slots,
            prefill_chunk=self.prefill_chunk,
            max_new_tokens=max_new_tokens,
            prompt_region=prompt_region,
            decode_span=decode_span,
            page_size=page,
            kv_pages=resolve_kv_pages(kv_pages, self.n_slots),
            kv_quant=self.kv_quant,
        )
        self.plan = plan = self.runtime.plan
        self.device = self.runtime.device
        self.caches = self.runtime.init_caches()
        self._pool = PagePool(plan.n_pages)
        self._radix: Optional[RadixIndex] = (
            RadixIndex(plan.page_size) if prefix_cache else None)
        # Free slots' rows point every entry at the trash page.
        self._table = np.full((plan.n_slots, plan.pages_per_slot),
                              plan.trash_page, np.int32)
        self._prefix: Dict[str, int] = {
            "lookups": 0, "hits": 0, "tokens_shared": 0, "pages_shared": 0,
            "chunks_skipped": 0, "cow_copies": 0, "evictions": 0,
            "adopted_pages": 0, "fallbacks": 0, "deferred": 0,
            "fresh_pages": 0,
        }
        self._slots: List[Optional[_Slot]] = [None] * plan.n_slots
        self._queue: "collections.deque[ServeRequest]" = collections.deque()
        self._stats: Dict[str, Any] = {
            "admitted": 0, "shed": 0, "completed": 0, "failed": 0,
            "tokens_generated": 0, "prefill_dispatches": 0,
            "prefill_tokens": 0, "prefill_seconds": 0.0,
            "decode_dispatches": 0, "decode_steps": 0,
            "decode_seconds": 0.0, "queue_depth_max": 0,
        }

    # ----------------------------------------------------------- admission

    def submit(self, rid: Any, text: str, op: str = "generate",
               max_new_tokens: Optional[int] = None) -> ServeRequest:
        """Queue one generation request, or shed it (``queue_full``) when
        the queue holds ``max_queue`` requests."""
        budget = int(max_new_tokens or self.plan.max_new)
        budget = max(1, min(budget, self.plan.max_new))
        req = ServeRequest(rid, op, text, meta={"max_new_tokens": budget})
        if len(self._queue) >= self.max_queue:
            req.fail("queue_full",
                     f"decode admission queue full "
                     f"({len(self._queue)}/{self.max_queue})")
            self._stats["shed"] += 1
            return req
        self._queue.append(req)
        self._stats["admitted"] += 1
        self._stats["queue_depth_max"] = max(self._stats["queue_depth_max"],
                                             len(self._queue))
        return req

    def run_until_idle(self, max_ticks: int = 1_000_000) -> None:
        """Tick until the queue and the slots are empty."""
        for _ in range(max_ticks):
            if not self._tick() and not self._queue and not self._occupied():
                return
        raise RuntimeError("run_until_idle exceeded its tick bound")

    def _occupied(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _tick(self) -> bool:
        """Admit into free slots, advance every mid-prefill slot by one
        chunk, run one decode dispatch, settle completions."""
        did = self._admit()
        did = self._prefill_tick() or did
        did = self._decode_tick() or did
        return did

    def _admit(self) -> bool:
        did = False
        while self._queue:
            free = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if free is None:
                return did
            req = self._queue.popleft()
            try:
                ids, plen = self.backend.tokenizer.encode(
                    req.text, self.plan.prompt_region)
            except Exception as exc:  # noqa: BLE001 — fails alone
                req.fail("request_failed", f"{type(exc).__name__}: {exc}"[:300])
                self._stats["failed"] += 1
                continue
            slot = _Slot(req, np.asarray(ids, np.int32), plen,
                         req.meta.get("max_new_tokens", self.plan.max_new))
            if not self._map_pages(free, slot):
                # Not even eviction frees enough pages: wait for running
                # sequences to release theirs.
                self._queue.appendleft(req)
                self._prefix["deferred"] += 1
                return did
            self._slots[free] = slot
            did = True
        return did

    def _map_pages(self, idx: int, slot: _Slot) -> bool:
        """Build the slot's table row, sharing what the radix tree holds:
        pin matched full pages, copy the partly filled boundary page,
        allocate the rest (evicting cold pages).  Returns False when the
        pool cannot cover the row."""
        plan = self.plan
        pool = self._pool
        shared: List[int] = []
        cow_src: Optional[int] = None
        kv_shared = 0
        if self._radix is not None:
            try:
                match = self._radix.match(slot.ids[:slot.plen])
                shared = list(match.pages)
                kv_shared = match.tokens
                if match.partial_tokens:
                    cow_src = match.partial_phys
            except Exception:  # noqa: BLE001 — cache-miss semantics
                shared, cow_src, kv_shared = [], None, 0
                self._prefix["fallbacks"] += 1
        bp = len(shared)
        for phys in shared:
            pool.pin(phys)
        if cow_src is not None:
            pool.pin(cow_src)
        needed = plan.pages_per_slot - bp
        if pool.free_count < needed and self._radix is not None:
            self._prefix["evictions"] += self._radix.evict(
                pool, needed - pool.free_count)
        fresh = pool.alloc(needed)
        if fresh is None and (shared or cow_src is not None):
            # The match pins exactly what eviction would need: drop it and
            # retry as a full prefill (same bytes, no savings).
            for phys in shared:
                pool.unpin(phys)
            if cow_src is not None:
                pool.unpin(cow_src)
            shared, cow_src, kv_shared, bp = [], None, 0, 0
            needed = plan.pages_per_slot
            if pool.free_count < needed and self._radix is not None:
                self._prefix["evictions"] += self._radix.evict(
                    pool, needed - pool.free_count)
            fresh = pool.alloc(needed)
            if fresh is not None:
                self._prefix["fallbacks"] += 1
        if fresh is None:
            for phys in shared:
                pool.unpin(phys)
            if cow_src is not None:
                pool.unpin(cow_src)
            return False
        for phys in fresh:
            pool.pin(phys)
        row = shared + fresh
        self._table[idx] = np.asarray(row, np.int32)
        slot.pages = row
        slot.kv_shared = kv_shared
        if cow_src is not None:
            self.caches = self.runtime.copy_page(self.caches, cow_src, row[bp])
            pool.unpin(cow_src)
        # Skip fully shared chunks; the boundary chunk and the last chunk
        # always run, so the first token comes from the same computation
        # as a cold prefill.
        C = plan.prefill_chunk
        eff = min(kv_shared, max(slot.plen, 1) - 1)
        slot.next_chunk = (eff // C) * C
        slot.skipped = slot.next_chunk // C
        p = self._prefix
        p["lookups"] += 1
        p["hits"] += int(kv_shared > 0)
        p["tokens_shared"] += kv_shared
        p["pages_shared"] += bp
        p["chunks_skipped"] += slot.skipped
        p["fresh_pages"] += len(fresh)
        p["cow_copies"] += int(cow_src is not None)
        return True

    def _adopt(self, slot: _Slot) -> None:
        """Offer a completed prefill's prompt pages to the radix tree."""
        try:
            n = min(slot.plen, self.plan.prompt_region)
            adopted = self._radix.insert(slot.ids[:n], slot.pages, self._pool)
        except Exception:  # noqa: BLE001 — cache trouble must not fail a request
            return
        self._prefix["adopted_pages"] += adopted

    # ------------------------------------------------------------ prefill

    def _device_prefill(self, idx: int, slot: _Slot):
        """One prefill chunk of one slot; the first token stays on the
        device until every slot of the tick has dispatched."""
        start = slot.next_chunk
        C = self.plan.prefill_chunk
        is_last = start + C >= min(max(slot.plen, 1), self.plan.prompt_region)
        chunk = torch.as_tensor(slot.ids[start:start + C],
                                dtype=torch.long).to(self.device)
        length_after = min(start + C, self.plan.prompt_region)
        last_index = max(0, min(slot.plen - 1 - start, C - 1))
        caches, first = self.runtime.prefill_chunk(
            self.caches, self._table[idx], idx, chunk, start, length_after,
            last_index)
        return caches, first, is_last

    def _prefill_tick(self) -> bool:
        did = False
        t0 = time.perf_counter()
        finishing = []
        for idx, slot in enumerate(self._slots):
            if slot is None or slot.next_chunk < 0:
                continue
            did = True
            try:
                caches, first, is_last = self._device_prefill(idx, slot)
            except Exception as exc:  # noqa: BLE001 — the prompt fails alone
                slot.req.fail("request_failed",
                              f"{type(exc).__name__}: {exc}"[:300])
                self._stats["failed"] += 1
                self._free([idx], zero=True)
                continue
            self.caches = caches
            self._stats["prefill_dispatches"] += 1
            self._stats["prefill_tokens"] += self.plan.prefill_chunk
            if is_last:
                finishing.append((idx, slot, first))
            else:
                slot.next_chunk += self.plan.prefill_chunk
        if finishing:
            firsts = torch.stack([f for _, _, f in finishing]).cpu().tolist()
            for (idx, slot, _), first in zip(finishing, firsts):
                slot.next_chunk = -1
                if self._radix is not None:
                    self._adopt(slot)
                slot.carry = int(first)
                if slot.carry == self.runtime.eos_id:
                    self._settle(idx, slot)   # empty generation
                else:
                    slot.active = True
        if did:
            if self.device.type == "cuda":
                # Chunks still queued on the card would be charged to the
                # next decode dispatch; finish them so prefill_seconds is
                # the prefill's own time.
                torch.cuda.synchronize(self.device)
            self._stats["prefill_seconds"] += time.perf_counter() - t0
        return did

    # ------------------------------------------------------------- decode

    def _decode_tick(self) -> bool:
        occupied = [(i, s) for i, s in enumerate(self._slots)
                    if s is not None and s.active]
        if not occupied:
            return False
        n = self.plan.n_slots
        tokens = np.zeros(n, np.int32)
        plens = np.zeros(n, np.int32)
        steps = np.zeros(n, np.int32)
        budgets = np.ones(n, np.int32)
        done = np.zeros(n, bool)
        active = np.zeros(n, bool)
        for i, s in occupied:
            tokens[i], plens[i], steps[i] = s.carry, s.plen, s.steps
            budgets[i], done[i], active[i] = s.budget, s.done, True
        t0 = time.perf_counter()
        dev = self.device
        try:
            caches, tok_out, steps_out, done_out, emitted = (
                self.runtime.decode_step(
                    self.caches, torch.from_numpy(self._table).to(dev),
                    *(torch.from_numpy(a).to(dev)
                      for a in (tokens, plens, steps, budgets, done, active))))
            emitted, tok_out, steps_out, done_out = (
                t.cpu().numpy() for t in (emitted, tok_out, steps_out, done_out))
        except Exception as exc:  # noqa: BLE001 — every resident fails, the loop lives
            detail = f"{type(exc).__name__}: {exc}"[:300]
            for i, s in occupied:
                s.req.fail("request_failed", detail)
            self._stats["failed"] += len(occupied)
            self._free([i for i, _ in occupied], zero=True)
            return True
        self.caches = caches
        self._stats["decode_seconds"] += time.perf_counter() - t0
        self._stats["decode_dispatches"] += 1
        self._stats["decode_steps"] += self.plan.decode_span
        freed: List[int] = []
        for i, s in occupied:
            emitted_n = int(steps_out[i]) - s.steps
            s.tokens.extend(int(t) for t in emitted[:emitted_n, i])
            s.steps = int(steps_out[i])
            s.carry = int(tok_out[i])
            s.done = bool(done_out[i])
            self._stats["tokens_generated"] += emitted_n
            saw_eos = (emitted_n > 0
                       and self.runtime.eos_id in s.tokens[-emitted_n:])
            if saw_eos or s.steps >= s.budget:
                freed.append(i)
        for i in freed:
            self._settle(i, self._slots[i])
        return True

    # ------------------------------------------------------------- settle

    def _settle(self, idx: int, slot: _Slot) -> None:
        """Reply with the generated text and its label; free the slot."""
        eos = self.runtime.eos_id
        toks = slot.tokens
        if eos in toks:
            toks = toks[:toks.index(eos)]
        toks = toks[:slot.budget]
        text = self.backend.tokenizer.decode(toks)
        slot.req.succeed(
            text=text,
            label=normalise_label(text) if text.strip() else "Neutral",
            tokens=len(toks),
        )
        self._stats["completed"] += 1
        self._free([idx])

    def _free(self, indices: List[int], zero: bool = False) -> None:
        """Release slots: unpin their pages and point their table rows at
        the trash page.  Normal completion needs no device work (prefill
        overwrites every prompt row it attends to, decode writes a row
        before reading it, the rest is masked); ``zero=True`` (failure
        paths) also zeroes the pages the slot owned alone."""
        mask = np.zeros(self.plan.n_slots, bool)
        released: List[int] = []
        for i in indices:
            mask[i] = True
            slot = self._slots[i]
            if slot is not None and slot.pages is not None:
                released.extend(slot.pages)
                self._table[i] = self.plan.trash_page
            self._slots[i] = None
        pool = self._pool
        for phys in released:
            pool.unpin(phys)
        if zero:
            page_mask = np.zeros(self.plan.n_pages + 1, bool)
            for phys in released:
                if pool.slot_refs[phys] == 0 and not pool.in_tree[phys]:
                    page_mask[phys] = True
            dev = self.device
            self.caches = self.runtime.free_pages(
                self.caches, torch.from_numpy(page_mask).to(dev),
                torch.from_numpy(mask).to(dev))

    # ----------------------------------------------------------- readouts

    def stats(self) -> Dict[str, Any]:
        """Counters, geometry and the prefix cache's effect."""
        plan = self.plan
        out: Dict[str, Any] = dict(self._stats)
        out.update(
            n_slots=plan.n_slots, prefill_chunk=plan.prefill_chunk,
            prompt_region=plan.prompt_region, max_new_tokens=plan.max_new,
            decode_span=plan.decode_span, page_size=plan.page_size,
            kv_pages=plan.n_pages, pages_per_slot=plan.pages_per_slot,
            kv_backend="paged", kv_quant=self.kv_quant,
            active_slots=sum(1 for s in self._slots if s is not None and s.active),
            free_slots=plan.n_slots - self._occupied(),
            pool_bytes=self.runtime.pool_bytes(),
        )
        prefix = dict(self._prefix)
        lookups, hits = prefix["lookups"], prefix["hits"]
        prefix.update(
            enabled=self._radix is not None,
            misses=lookups - hits,
            hit_rate=round(hits / lookups, 4) if lookups else None,
            bytes_saved=prefix["tokens_shared"] * self.runtime.kv_token_bytes(),
            tree_pages=self._radix.page_count() if self._radix is not None else 0,
            pages_free=self._pool.free_count,
        )
        out["prefix_cache"] = prefix
        return out
