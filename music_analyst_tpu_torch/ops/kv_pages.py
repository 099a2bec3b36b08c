"""Prefix-shared paged KV cache for the continuous decode scheduler.

Counterpart of ``music_analyst_tpu/ops/kv_pages.py``.  The KV cache is a
fixed device pool of power-of-two pages per layer, ``[n_pages + 1, P,
n_kv, D]`` (row ``n_pages`` is the trash page free slots point at); a
slot's cache is a view through its row of an int32 page table, so two
prompts with a common token prefix can map the same physical pages.

Device half (:class:`PagedDecodeRuntime`), eager PyTorch:

* ``prefill_chunk`` gathers one slot's pages into a contiguous ``[1,
  max_total]`` view, runs one prompt chunk through the model over it (dense
  attention, as in the JAX package), and writes the pages the chunk
  touched back (int8 pools re-quantize them row by row);
* ``decode_step`` runs ``decode_span`` one-token steps over every slot,
  threading :class:`~music_analyst_tpu_torch.ops.paged_attention.PagedAttnView`
  caches through the model: each step writes its K/V row into its
  physical page and attends through the paged kernel, so no view is
  gathered;
* ``verify_block`` scores a drafted block for speculative decoding as
  teacher-forced runs of the same 1-wide step;
* ``free_pages`` zeroes pages (the failure path), ``copy_page`` copies one
  page (copy-on-write of a prefix hit's boundary page).

The pools are updated in place.  Host half (:class:`PagePool`,
:class:`RadixIndex`, :class:`PrefixMatch`): refcounted pages and a radix
tree over page-sized token runs, plain Python as in the JAX package.

Sharing keeps the bytes: K/V at position ``p`` depend only on tokens
``0..p``, so a matched page holds what a fresh prefill would write; the
chunk that straddles the shared boundary is recomputed, and rows at or
past the boundary land only in copied or fresh pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from music_analyst_tpu_torch.models.layers import KVCache
from music_analyst_tpu_torch.ops.kv_slots import upload_arrays
from music_analyst_tpu_torch.ops.paged_attention import PagedAttnView
from music_analyst_tpu_torch.ops.quant import quantize_kv_pair
from music_analyst_tpu_torch.parallel.sharding import local_kv_heads

KV_QUANT_SCHEMES = ("none", "int8")


def _is_pow2(n: int) -> bool:
    return n >= 1 and not (n & (n - 1))


@dataclasses.dataclass
class QuantizedKVPages:
    """int8 page pool of one layer: codes ``[n_pages + 1, P, n_kv, D]``,
    f32 per-(page, row) scales ``[n_pages + 1, P]`` for K and V, and the
    ``[n_slots]`` write offsets kept for bookkeeping."""

    keys: torch.Tensor
    values: torch.Tensor
    key_scale: torch.Tensor
    value_scale: torch.Tensor
    length: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Static geometry of one paged runtime."""

    n_slots: int        # pow2 — rows in the page table
    prefill_chunk: int  # tokens written per prefill dispatch
    prompt_region: int  # buffer rows for the prompt (multiple of chunk & page)
    max_new: int        # decode rows per slot (largest per-request budget)
    decode_span: int    # greedy steps per decode dispatch
    page_size: int      # pow2 — tokens per physical KV page
    n_pages: int        # allocatable pool size (excludes the trash page)

    def __post_init__(self):
        if not _is_pow2(self.n_slots):
            raise ValueError(f"n_slots must be a power of two, got {self.n_slots}")
        if not _is_pow2(self.page_size):
            raise ValueError(
                f"page_size must be a power of two, got {self.page_size}"
            )
        if self.prompt_region % self.prefill_chunk:
            raise ValueError(
                f"prompt_region ({self.prompt_region}) must be a multiple of "
                f"prefill_chunk ({self.prefill_chunk})"
            )
        if self.prompt_region % self.page_size:
            raise ValueError(
                f"prompt_region ({self.prompt_region}) must be a multiple of "
                f"page_size ({self.page_size})"
            )
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.decode_span < 1:
            raise ValueError(f"decode_span must be >= 1, got {self.decode_span}")
        floor = max(self.n_slots, self.pages_per_slot)
        if self.n_pages < floor:
            raise ValueError(
                f"n_pages ({self.n_pages}) must be >= "
                f"max(n_slots, pages_per_slot) = {floor} — the pool must hold "
                "one page per slot and one full resident sequence"
            )

    @property
    def max_total(self) -> int:
        return self.prompt_region + self.max_new

    @property
    def prompt_pages(self) -> int:
        return self.prompt_region // self.page_size

    @property
    def decode_pages(self) -> int:
        return -(-self.max_new // self.page_size)

    @property
    def pages_per_slot(self) -> int:
        return self.prompt_pages + self.decode_pages

    @property
    def slot_span(self) -> int:
        return self.pages_per_slot * self.page_size

    @property
    def trash_page(self) -> int:
        """Physical page every entry of a free slot's table row points at:
        the decode step writes a row for every slot, and a free slot's
        writes must not land in recycled pages.  Never allocated, never
        read through an active mask."""
        return self.n_pages


class PagedDecodeRuntime:
    """Paged prefill / decode / free / copy over one model.  Holds no
    request state: the table, refcounts and radix tree live in the
    scheduler."""

    def __init__(self, model, config, plan: PagePlan, eos_id: int,
                 kv_quant: str = "none", mesh=None) -> None:
        if kv_quant not in KV_QUANT_SCHEMES:
            raise ValueError(
                f"kv_quant must be one of {KV_QUANT_SCHEMES}, got {kv_quant!r}"
            )
        if plan.max_total > config.max_seq_len:
            raise ValueError(
                f"prompt_region + max_new ({plan.max_total}) exceeds the "
                f"model's max_seq_len ({config.max_seq_len})"
            )
        self.model = model
        self.config = config
        self.plan = plan
        self.eos_id = int(eos_id)
        self.kv_quant = kv_quant
        self.quantized = kv_quant == "int8"
        # The dtype the pool stores (unquantized) or dequantizes to.
        self.compute_dtype = torch.bfloat16
        self.device = next(model.parameters()).device
        # Under tensor parallelism each rank's pool holds its own
        # n_kv_heads / tp heads (parallel/sharding.py:kv_cache_spec): a
        # per-rank allocation, never a head slice of a full pool.
        self.n_kv_heads = local_kv_heads(mesh, config.n_kv_heads)
        # int8 page rows take one scale over every rank's heads.
        self.mesh = mesh

    # -------------------------------------------------------------- state

    def init_caches(self) -> List:
        """A zeroed pool per layer, with ``[n_slots]`` write offsets."""
        cfg, plan = self.config, self.plan
        shape = (plan.n_pages + 1, plan.page_size, self.n_kv_heads,
                 cfg.dim // cfg.n_heads)
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        length = lambda: zeros((plan.n_slots,), torch.int32)  # noqa: E731
        if self.quantized:
            sshape = shape[:2]
            return [QuantizedKVPages(zeros(shape, torch.int8),
                                     zeros(shape, torch.int8),
                                     zeros(sshape, torch.float32),
                                     zeros(sshape, torch.float32), length())
                    for _ in range(cfg.n_layers)]
        return [KVCache(zeros(shape, self.compute_dtype),
                        zeros(shape, self.compute_dtype), length())
                for _ in range(cfg.n_layers)]

    def kv_token_bytes(self) -> int:
        """Device bytes one cached token costs across layers (K + V); int8
        counts its codes plus one f32 scale each for K and V."""
        cfg = self.config
        row = self.n_kv_heads * (cfg.dim // cfg.n_heads)
        if self.quantized:
            return 2 * cfg.n_layers * (row + 4)
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return 2 * cfg.n_layers * row * itemsize

    def kv_token_bytes_unquantized(self) -> int:
        """What the same token costs without KV quantization."""
        cfg = self.config
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return (2 * cfg.n_layers * self.n_kv_heads * (cfg.dim // cfg.n_heads)
                * itemsize)

    def page_bytes(self) -> int:
        return self.plan.page_size * self.kv_token_bytes()

    def pool_bytes(self) -> int:
        """The whole pool across layers, the trash page included."""
        return (self.plan.n_pages + 1) * self.page_bytes()

    def upload(self, *arrays) -> List[torch.Tensor]:
        """A dispatch's host inputs on this runtime's device
        (``kv_slots.upload_arrays``)."""
        return upload_arrays(self.device, *arrays)

    def compiled_variants(self) -> int:
        """Programs compiled for this runtime: none, eager PyTorch traces
        nothing (the JAX runtime counts its jitted programs here)."""
        return 0

    def prompt_chunks(self, n_tokens: int) -> Sequence[int]:
        """Chunk start offsets covering a prompt of ``n_tokens`` tokens."""
        n = max(1, min(int(n_tokens), self.plan.prompt_region))
        C = self.plan.prefill_chunk
        return range(0, ((n + C - 1) // C) * C, C)

    # ------------------------------------------------------------ prefill

    def _view(self, c, row: torch.Tensor, start: int) -> KVCache:
        """Contiguous ``[1, max_total]`` copy of the rows behind ``row``
        (int8 codes dequantized to the compute dtype)."""
        total = self.plan.max_total
        keys, values = c.keys[row], c.values[row]          # [pps, P, kv, D]
        if self.quantized:
            keys = (keys.float() * c.key_scale[row][..., None, None]).to(
                self.compute_dtype)
            values = (values.float() * c.value_scale[row][..., None, None]).to(
                self.compute_dtype)
        shape = (1, self.plan.slot_span) + tuple(keys.shape[-2:])
        return KVCache(keys.reshape(shape)[:, :total].contiguous(),
                       values.reshape(shape)[:, :total].contiguous(), start)

    @torch.no_grad()
    def prefill_chunk(self, caches, page_row, slot: int,
                      chunk_ids: torch.Tensor, start: int, length_after: int,
                      last_index: int):
        """Write ``prefill_chunk`` prompt tokens through one slot's pages.

        ``page_row`` is the slot's host table row; ``chunk_ids`` ``[C]`` on
        the device; ``start`` the chunk's offset; ``last_index`` the
        chunk-local index of the prompt's last token.  Returns ``(caches,
        first)`` with ``first`` the greedy token after the chunk (a device
        scalar, read by the caller)."""
        plan = self.plan
        C, P = plan.prefill_chunk, plan.page_size
        total, span, pps = plan.max_total, plan.slot_span, plan.pages_per_slot
        dev = self.device
        row = torch.as_tensor(page_row, dtype=torch.long).to(dev)
        views = [self._view(c, row, start) for c in caches]
        positions = (start + torch.arange(C, device=dev))[None, :]
        kv_pos = torch.arange(total, device=dev)[None, None, :]
        mask = (kv_pos <= positions[:, :, None])[:, None, :, :]
        logits, views = self.model(
            chunk_ids[None, :], positions, mask, views,
            last_position=torch.full((1,), last_index, dtype=torch.long,
                                     device=dev))
        first = logits[0, 0].argmax()
        # Pages a chunk can touch: one leading partial page + full pages.
        lp0 = start // P
        touched = sorted({min(max(lp0 + j, 0), pps - 1)
                          for j in range((C - 1) // P + 2)})
        phys = torch.as_tensor([int(page_row[lp]) for lp in touched],
                               dtype=torch.long).to(dev)
        lps = torch.as_tensor(touched, dtype=torch.long).to(dev)
        for c, v in zip(caches, views):
            # The view's slack tail past max_total is written as zeros.
            vk = F.pad(v.keys, (0, 0, 0, 0, 0, span - total))
            vv = F.pad(v.values, (0, 0, 0, 0, 0, span - total))
            pk = vk[0].reshape((pps, P) + vk.shape[2:])[lps]
            pv = vv[0].reshape((pps, P) + vv.shape[2:])[lps]
            if self.quantized:
                (pk, sk), (pv, sv) = quantize_kv_pair(pk, pv, self.mesh)
                c.key_scale[phys] = sk
                c.value_scale[phys] = sv
            c.keys[phys] = pk
            c.values[phys] = pv
            c.length[slot] = length_after
        return caches, first

    # ------------------------------------------------------------- decode

    def _views(self, caches, page_table):
        plan = self.plan
        return [PagedAttnView(
            keys=c.keys, values=c.values,
            key_scale=c.key_scale if self.quantized else None,
            value_scale=c.value_scale if self.quantized else None,
            table=page_table, length=c.length, page_size=plan.page_size,
            total=plan.max_total, mesh=self.mesh) for c in caches]

    def _step(self, views, tokens, prompt_lens, steps, kv_pos):
        """One 1-wide step over every slot through the paged kernel: write
        row ``R + step`` (clamped to the last row) into its physical page,
        attend under ``prompt_part | decode_part``.  Returns the greedy
        next tokens and the advanced views."""
        R, total = self.plan.prompt_region, self.plan.max_total
        offsets = torch.clamp(R + steps, max=total - 1)
        views = [dataclasses.replace(v, length=offsets) for v in views]
        prompt_part = kv_pos < prompt_lens[:, None, None, None]
        decode_part = (kv_pos >= R) & (kv_pos - R <= steps[:, None, None, None])
        logits, views = self.model(
            tokens[:, None], (prompt_lens + steps)[:, None],
            prompt_part | decode_part, views)
        return logits[:, -1].argmax(dim=-1).to(tokens.dtype), views

    @torch.no_grad()
    def decode_step(self, caches, page_table, tokens, prompt_lens, steps,
                    budgets, done, active):
        """``decode_span`` greedy steps over every slot.

        All arguments after ``caches`` are ``[n_slots]`` device tensors
        (``page_table`` ``[n_slots, pps]`` int32).  A slot advances while
        ``active`` and under its budget; its step ``t`` writes row ``R +
        t`` of its decode pages (never a shared prompt page) at position
        ``prompt_len + t``.  Free slots' rows point at the trash page.
        Returns ``(caches, tokens, steps, done, emitted [span, n_slots])``.
        """
        eos = self.eos_id
        views = self._views(caches, page_table)
        kv_pos = torch.arange(self.plan.max_total,
                              device=tokens.device)[None, None, None, :]
        emitted = []
        for _ in range(self.plan.decode_span):
            adv = active & (steps < budgets)
            nxt, views = self._step(views, tokens, prompt_lens, steps, kv_pos)
            new_done = done | (tokens == eos)
            nxt = torch.where(new_done, torch.full_like(nxt, eos), nxt)
            emitted.append(tokens)
            tokens = torch.where(adv, nxt, tokens)
            steps = torch.where(adv, steps + 1, steps)
            done = torch.where(adv, new_done, done)
        return caches, tokens, steps, done, torch.stack(emitted)

    @torch.no_grad()
    def verify_block(self, caches, page_table, tokens_blk, prompt_lens,
                     steps):
        """Score a ``[n_slots, K]`` drafted block (column 0 the carry,
        columns ``1..K-1`` drafts); returns ``(caches, preds [n_slots,
        K])``, the greedy token after consuming each prefix.

        K teacher-forced runs of :meth:`_step`, the same 1-wide
        kernel-backed step as :meth:`decode_step` at the same shapes: a
        K-wide scoring pass would reduce in another order and flip argmax
        near-ties, and speculative text must equal plain decode byte for
        byte.  Rejected drafts' rows stay in the decode pages unread (the
        masks follow the host-committed ``steps``); shared prompt pages are
        never written (write offsets ``>= R``).
        """
        views = self._views(caches, page_table)
        kv_pos = torch.arange(self.plan.max_total,
                              device=tokens_blk.device)[None, None, None, :]
        preds = []
        for j in range(tokens_blk.shape[1]):
            nxt, views = self._step(views, tokens_blk[:, j], prompt_lens,
                                    steps, kv_pos)
            preds.append(nxt)
            steps = steps + 1
        return caches, torch.stack(preds, dim=1)

    # ------------------------------------------------------ free and copy

    @torch.no_grad()
    def free_pages(self, caches, page_mask: torch.Tensor,
                   slot_mask: torch.Tensor):
        """Zero the masked physical pages (their int8 scales too) and the
        masked slots' offsets: the failure path's hard isolation."""
        pages = page_mask.nonzero()[:, 0]
        for c in caches:
            c.keys[pages] = 0
            c.values[pages] = 0
            if self.quantized:
                c.key_scale[pages] = 0.0
                c.value_scale[pages] = 0.0
            c.length.masked_fill_(slot_mask, 0)
        return caches

    @torch.no_grad()
    def copy_page(self, caches, src: int, dst: int):
        """Copy physical page ``src`` to ``dst`` in every layer (int8
        scales ride along)."""
        for c in caches:
            c.keys[dst] = c.keys[src]
            c.values[dst] = c.values[src]
            if self.quantized:
                c.key_scale[dst] = c.key_scale[src]
                c.value_scale[dst] = c.value_scale[src]
        return caches


# ====================================================================== host


class PagePool:
    """Free list + refcounts over the physical pages of one pool.

    A page is free iff no slot maps it (``slot_refs == 0``) and the radix
    index does not hold it (``in_tree`` false).  ``alloc`` hands out free
    pages in ascending order; releasing the last reference frees a page.
    """

    def __init__(self, n_pages: int) -> None:
        self.n_pages = int(n_pages)
        self.slot_refs = [0] * self.n_pages
        self.in_tree = [False] * self.n_pages
        self._free = list(range(self.n_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, k: int) -> Optional[List[int]]:
        if k > len(self._free):
            return None
        return [self._free.pop() for _ in range(k)]

    def pin(self, phys: int) -> None:
        self.slot_refs[phys] += 1

    def unpin(self, phys: int) -> None:
        refs = self.slot_refs[phys] - 1
        if refs < 0:
            raise ValueError(f"unpin of unpinned page {phys}")
        self.slot_refs[phys] = refs
        self._maybe_free(phys)

    def pin_row(self, pages: Sequence[int]) -> None:
        """Pin every page of one table row: a checkpoint's own reference,
        so the row survives the slot's release (and the zeroing failure
        path, which only touches unreferenced pages)."""
        for phys in pages:
            self.pin(phys)

    def unpin_row(self, pages: Sequence[int]) -> None:
        """Release one reference from every page of a table row."""
        for phys in pages:
            self.unpin(phys)

    def tree_add(self, phys: int) -> None:
        if self.in_tree[phys]:
            raise ValueError(f"page {phys} already in the radix index")
        self.in_tree[phys] = True

    def tree_drop(self, phys: int) -> None:
        if not self.in_tree[phys]:
            raise ValueError(f"page {phys} not in the radix index")
        self.in_tree[phys] = False
        self._maybe_free(phys)

    def _maybe_free(self, phys: int) -> None:
        if self.slot_refs[phys] == 0 and not self.in_tree[phys]:
            self._free.append(phys)

    def check(self) -> None:
        """Invariant audit: the free list is exactly the unreferenced
        pages, with no duplicates."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages in the free list")
        for p in range(self.n_pages):
            should_be_free = self.slot_refs[p] == 0 and not self.in_tree[p]
            if should_be_free != (p in free):
                raise AssertionError(
                    f"page {p}: refs={self.slot_refs[p]} "
                    f"in_tree={self.in_tree[p]} free={p in free}"
                )


class _RadixNode:
    __slots__ = ("tokens", "phys", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], phys: Optional[int],
                 parent: Optional["_RadixNode"]) -> None:
        self.tokens = tokens          # the page's valid tokens
        self.phys = phys              # physical page (None only at root)
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.last_used = 0

    @property
    def n_valid(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class PrefixMatch:
    """Result of a radix lookup for one prompt."""

    pages: List[int]             # full shared pages, in slot-local order
    full_tokens: int             # len(pages) * page_size
    partial_phys: Optional[int]  # boundary page to copy-on-write (or None)
    partial_tokens: int          # tokens matched inside the boundary page

    @property
    def tokens(self) -> int:
        return self.full_tokens + self.partial_tokens


class RadixIndex:
    """Radix tree over page-sized token runs.

    A child is keyed by its page's valid tokens (full pages hold exactly
    ``page_size``; a leaf may be partial, and only full pages extend a
    path).  ``match`` walks exact full-page children, then takes the
    longest common prefix among the frontier's children; ``insert`` adopts
    a completed prefill's pages; ``evict`` drops least-recently-used
    leaves that no slot maps.
    """

    def __init__(self, page_size: int) -> None:
        if not _is_pow2(page_size):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        self.page_size = int(page_size)
        self.root = _RadixNode((), None, None)
        self._clock = 0

    def _touch(self, node: _RadixNode) -> None:
        self._clock += 1
        while node is not None and node is not self.root:
            node.last_used = self._clock
            node = node.parent

    def match(self, ids: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``ids`` (never more than ``len(ids)``
        tokens)."""
        ids = [int(t) for t in ids]
        P = self.page_size
        node = self.root
        pages: List[int] = []
        i = 0
        while len(ids) - i >= P:
            child = node.children.get(tuple(ids[i:i + P]))
            if child is None or child.n_valid != P:
                break
            pages.append(child.phys)
            node = child
            i += P
        best: Optional[_RadixNode] = None
        best_k = 0
        remaining = ids[i:]
        if remaining:
            for child in node.children.values():
                k = 0
                for a, b in zip(child.tokens, remaining):
                    if a != b:
                        break
                    k += 1
                if k > best_k:
                    best, best_k = child, k
        if pages or best is not None:
            self._touch(best if best is not None else node)
        if node is not self.root:
            self._touch(node)
        return PrefixMatch(
            pages=pages,
            full_tokens=i,
            partial_phys=best.phys if best is not None else None,
            partial_tokens=best_k,
        )

    def insert(self, ids: Sequence[int], phys_pages: Sequence[int],
               pool: PagePool) -> int:
        """Adopt the pages of one completed prefill (``ids`` the prompt's
        tokens, ``phys_pages`` the slot's table row); runs already present
        are left alone.  Returns the number of pages adopted."""
        ids = [int(t) for t in ids]
        P = self.page_size
        n_full, rem = divmod(len(ids), P)
        node = self.root
        adopted = 0
        for pi in range(n_full):
            seg = tuple(ids[pi * P:(pi + 1) * P])
            child = node.children.get(seg)
            if child is None:
                child = _RadixNode(seg, int(phys_pages[pi]), node)
                node.children[seg] = child
                pool.tree_add(child.phys)
                adopted += 1
            node = child
        if rem:
            seg = tuple(ids[n_full * P:n_full * P + rem])
            if seg not in node.children:
                child = _RadixNode(seg, int(phys_pages[n_full]), node)
                node.children[seg] = child
                pool.tree_add(child.phys)
                adopted += 1
        if node is not self.root or adopted:
            self._touch(node)
        return adopted

    def _leaves(self) -> List[_RadixNode]:
        out: List[_RadixNode] = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, pool: PagePool, need: int) -> int:
        """Free at least ``need`` pages by dropping cold unpinned leaves
        (LRU); returns how many were freed (fewer iff the rest is
        pinned)."""
        freed = 0
        while freed < need:
            candidates = [leaf for leaf in self._leaves()
                          if pool.slot_refs[leaf.phys] == 0]
            if not candidates:
                break
            victim = min(candidates, key=lambda n: n.last_used)
            del victim.parent.children[victim.tokens]
            pool.tree_drop(victim.phys)
            freed += 1
        return freed

    def page_count(self) -> int:
        n = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def node_count(self) -> int:
        """Nodes of the tree (the engine ledger's occupancy); one per
        page."""
        return self.page_count()

    def token_count(self) -> int:
        """Valid tokens the tree keeps resident for future prefix hits."""
        n = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            n += node.n_valid
            stack.extend(node.children.values())
        return n
