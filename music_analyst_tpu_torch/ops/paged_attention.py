"""Paged decode attention: the CUDA kernel's wrapper, its plain versions,
and the cache-shaped view the decoder threads through its layers.

Counterpart of ``music_analyst_tpu/ops/paged_attention.py``.  Its two
Pallas bodies compute one function in two reduction orders: the streaming
body (``_stream_body``, the TPU's) and the exact batched body
(``_exact_body``, interpret mode).  Here:

* on a CUDA tensor, :func:`paged_attention` launches
  ``csrc/paged_attention.cu`` (split-K over the keys as :func:`split_plan`
  lays them out, f32 softmax per split, a fixed-order combine, one bf16
  rounding of the result) or raises;
* on a CPU tensor it runs :func:`paged_attention_plain`, the exact body's
  order: gather the slot views through the table, then
  ``models/layers.dot_product_attention``'s ops verbatim, so paged decode
  on the CPU is bitwise equal to dense attention over the gathered view;
* :func:`paged_attention_reference` is the f32 oracle both are held to;
  :func:`paged_attention_split_reference` is the kernel's split-then-combine
  order in plain f32 (the combine step's plain version; no path calls it).

Layouts are the JAX function's: ``q [n, 1, H, D]``; pools ``[n_pages + 1,
P, n_kv, D]`` (bf16, or int8 codes with ``[n_pages + 1, P]`` f32 scales;
row ``n_pages`` is the trash page); ``table [n, pps]`` int32; ``mask [n,
total]`` bool with ``total <= pps * P``.

:class:`PagedAttnView` stands in for ``models/layers.KVCache`` during
decode: ``update`` writes the step's K/V row into its physical page (in
place; int8 rows are quantized one by one) and ``attend`` calls
:func:`paged_attention`, so no contiguous view is built on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.models.layers import dot_product_attention
from music_analyst_tpu_torch.ops.quant import quantize_kv_pair

_HEAD_DIMS = (64, 128)
_MAX_GROUP_COLUMNS = 8 * 128   # G * D the kernel's registers hold
NEG_INF = -1e30

# Keys per split, the most the kernel's shared memory holds: at the
# Llama-3-8B decode shape (8 slots x 8 kv heads, 1,040 keys) 17 splits and
# 1,088 blocks, a few for each SM.
SPLIT_KEYS = 64


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Key ranges of the kernel's splits: split ``z`` owns keys
    ``[z * chunk, min((z + 1) * chunk, total))``."""

    chunk: int
    total: int

    @property
    def splits(self) -> int:
        return -(-self.total // self.chunk)

    @property
    def ranges(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((z * self.chunk, min((z + 1) * self.chunk, self.total))
                     for z in range(self.splits))


def split_plan(total: int, page_size: int) -> SplitPlan:
    """How the kernel splits ``total`` keys: :data:`SPLIT_KEYS` keys a
    split, cut to whole pages when a page fits in it.  Every key below
    ``total`` lies in exactly one range, and no range is empty."""
    if total <= 0 or page_size <= 0:
        raise ValueError(f"split_plan needs a positive total and page size, "
                         f"got {total}, {page_size}")
    chunk = SPLIT_KEYS
    if page_size <= chunk:
        chunk -= chunk % page_size
    return SplitPlan(chunk=chunk, total=total)


def _geometry(q, key_pages, table, mask):
    n, q_len, H, D = q.shape
    if q_len != 1:
        raise ValueError(
            f"paged_attention is a decode kernel (q_len == 1), got {q_len}"
        )
    P, n_kv = key_pages.shape[1], key_pages.shape[2]
    if key_pages.shape[3] != D:
        raise ValueError(
            f"head_dim mismatch: q has {D}, pages have {key_pages.shape[3]}"
        )
    if H % n_kv:
        raise ValueError(f"n_heads ({H}) not divisible by n_kv ({n_kv})")
    pps = table.shape[1]
    total = mask.shape[-1]
    if total > pps * P:
        raise ValueError(
            f"mask width ({total}) exceeds slot span ({pps * P})"
        )
    return n, H, n_kv, D, P, pps, total


def _check_scales(key_scale, value_scale) -> bool:
    quantized = key_scale is not None
    if quantized != (value_scale is not None):
        raise ValueError("key_scale and value_scale must be passed together")
    return quantized


def _gather(pages, scale, table, total, dtype):
    """Slot views ``[n, total, n_kv, D]`` through the table; int8 codes
    dequantize to ``dtype`` (codes x scale in f32, then rounded)."""
    idx = table.long()
    rows = pages[idx]                                  # [n, pps, P, kv, D]
    if scale is not None:
        rows = (rows.float() * scale[idx][..., None, None]).to(dtype)
    n, pps, P = rows.shape[:3]
    return rows.reshape(n, pps * P, *rows.shape[3:])[:, :total]


def paged_attention_plain(q, key_pages, value_pages, table, mask,
                          key_scale=None, value_scale=None):
    """The exact-order plain version: gather, then dense attention's ops
    (``repeat_interleave`` GQA, einsum in the input dtype, ``.float() *
    D**-0.5``, ``finfo.min`` masking, f32 softmax cast back, einsum)."""
    quantized = _check_scales(key_scale, value_scale)
    n, H, n_kv, D, P, pps, total = _geometry(q, key_pages, table, mask)
    k = _gather(key_pages, key_scale if quantized else None, table, total,
                q.dtype)
    v = _gather(value_pages, value_scale if quantized else None, table,
                total, q.dtype)
    return dot_product_attention(q, k, v, mask[:, None, None, :])


def paged_attention_reference(q, key_pages, value_pages, table, mask,
                              key_scale=None, value_scale=None):
    """Naive f32 oracle: gather, dequantize, broadcast kv heads over their
    query groups, full-precision softmax; returns f32."""
    quantized = _check_scales(key_scale, value_scale)
    n, H, n_kv, D, P, pps, total = _geometry(q, key_pages, table, mask)
    k = _gather(key_pages, key_scale if quantized else None, table, total,
                torch.float32).float()
    v = _gather(value_pages, value_scale if quantized else None, table,
                total, torch.float32).float()
    group = H // n_kv
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (D ** -0.5)
    logits = logits.masked_fill(~mask[:, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def paged_attention_split_reference(q, key_pages, value_pages, table, mask,
                                    key_scale=None, value_scale=None,
                                    plan: Optional[SplitPlan] = None):
    """The kernel's order in plain f32: per split of ``plan`` (default
    :func:`split_plan`) the split's max ``m``, sum ``l`` and unnormalised
    V sum over its valid keys; then the splits combined in order, a split
    with no valid key skipped.  A slot with no valid key gives zeros."""
    quantized = _check_scales(key_scale, value_scale)
    n, H, n_kv, D, P, pps, total = _geometry(q, key_pages, table, mask)
    plan = plan or split_plan(total, P)
    group = H // n_kv
    k = _gather(key_pages, key_scale if quantized else None, table, total,
                torch.float32).float().repeat_interleave(group, dim=2)
    v = _gather(value_pages, value_scale if quantized else None, table,
                total, torch.float32).float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (D ** -0.5)
    parts = []
    for start, end in plan.ranges:
        valid = mask[:, None, None, start:end]
        s = logits[..., start:end].masked_fill(~valid, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)                  # [n, H, 1, 1]
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        o = torch.einsum("bhqk,bkhd->bhqd", p, v[:, start:end])
        parts.append((m, p.sum(dim=-1, keepdim=True), o))
    m_all = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        m_all = torch.where(l > 0, torch.maximum(m_all, m), m_all)
    o_all = torch.zeros_like(parts[0][2])
    l_all = torch.zeros_like(parts[0][1])
    for m, l, o in parts:
        w = torch.where(l > 0, torch.exp(m - m_all), torch.zeros_like(m))
        o_all = o_all + w * o
        l_all = l_all + w * l
    out = o_all / torch.where(l_all == 0, torch.ones_like(l_all), l_all)
    return out.permute(0, 2, 1, 3)                        # [n, 1, H, D]


def paged_attention(q, key_pages, value_pages, table, mask, *,
                    key_scale=None, value_scale=None):
    """Paged decode attention ``[n, 1, H, D]`` in ``q.dtype``.

    CUDA tensors launch ``csrc/paged_attention.cu``: q bf16, pools bf16 or
    int8 with f32 scales, head dim 64 or 128, ``G * D <= 1024``, all
    contiguous; anything else raises.  CPU tensors run
    :func:`paged_attention_plain`.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, key_pages, value_pages, table, mask,
                                     key_scale, value_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    quantized = _check_scales(key_scale, value_scale)
    n, H, n_kv, D, P, pps, total = _geometry(q, key_pages, table, mask)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_attention kernel takes bf16 q, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if key_pages.dtype != want or value_pages.dtype != want:
        raise TypeError(
            f"paged_attention kernel takes {want} pools here, got "
            f"{key_pages.dtype}, {value_pages.dtype}"
        )
    if value_pages.shape != key_pages.shape:
        raise ValueError("key and value pools differ in shape")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dim 64 or 128, got {D}")
    if (H // n_kv) * D > _MAX_GROUP_COLUMNS:
        raise ValueError(f"paged_attention kernel takes G * D <= 1024, got "
                         f"{H // n_kv} * {D}")
    if table.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("paged_attention kernel takes an int32 table and a "
                        "bool mask")
    tensors = [("q", q), ("key_pages", key_pages), ("value_pages", value_pages),
               ("table", table), ("mask", mask)]
    if quantized:
        if key_scale.dtype != torch.float32 or value_scale.dtype != torch.float32:
            raise TypeError("int8 pools take f32 scales")
        if key_scale.shape != key_pages.shape[:2] or value_scale.shape != key_scale.shape:
            raise ValueError("scales must be [n_pages + 1, page_size]")
        tensors += [("key_scale", key_scale), ("value_scale", value_scale)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel needs contiguous {name}")
    for name, t in tensors[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel needs 16-byte aligned {name}")
    plan = split_plan(total, P)
    out = torch.empty_like(q)
    # This call's own scratch, on its stream: f32 partials o [n, n_kv,
    # splits, G, D] and (m, l) [.., G, 2], then int32 tickets [n, n_kv].
    scratch = torch.empty(n * H * plan.splits * (D + 2) + n * n_kv,
                          dtype=torch.float32, device=q.device)
    fn = kernels.kernel("paged_attention")
    with torch.cuda.device(q.device):  # launch on q's card, its stream
        status = fn(
            q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(),
            key_scale.data_ptr() if quantized else None,
            value_scale.data_ptr() if quantized else None,
            table.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, H, n_kv, D, P, pps, total, plan.chunk,
            plan.splits, int(quantized), float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("paged_attention", status)
    kernels.count_launch("paged_attention")
    return out


@dataclasses.dataclass
class PagedAttnView:
    """``KVCache``-shaped binding of one decode step to the page pool.

    ``keys``/``values`` are the pool itself (``[n_pages + 1, P, n_kv,
    D]``), ``key_scale``/``value_scale`` its int8 scales or None, ``table``
    ``[n_slots, pps]`` int32 and ``length`` ``[n_slots]`` write offsets.
    The model's attention calls ``update`` (writes land in the pool, in
    place) and then ``attend``.  Under tensor parallelism ``mesh`` is the
    model's: the pool holds this rank's KV heads, and an int8 row's scale
    is taken over every rank's (``quantize_kv_pair``).
    """

    keys: torch.Tensor
    values: torch.Tensor
    key_scale: Optional[torch.Tensor]
    value_scale: Optional[torch.Tensor]
    table: torch.Tensor
    length: torch.Tensor
    page_size: int = 16
    total: int = 0
    mesh: object = None

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "PagedAttnView":
        """Write the step's row of each slot into physical page
        ``table[slot, off // P]``, row ``off % P``.  Free slots' rows all
        point at the trash page: their duplicate writes land there, which
        no active mask reads (plain assignment, no accumulation)."""
        if k_new.shape[1] != 1:
            raise ValueError(
                "PagedAttnView writes one decode token per step "
                f"(got {k_new.shape[1]}); chunked prefill goes through a "
                "gathered view (ops/kv_pages.py)"
            )
        P = self.page_size
        off = self.length.long()
        rows = torch.arange(self.table.shape[0], device=off.device)
        phys = self.table[rows, off // P].long()
        r = off % P
        if self.key_scale is None:
            self.keys[phys, r] = k_new[:, 0].to(self.keys.dtype)
            self.values[phys, r] = v_new[:, 0].to(self.values.dtype)
        else:
            (qk, sk), (qv, sv) = quantize_kv_pair(k_new[:, 0], v_new[:, 0],
                                                  self.mesh)
            self.keys[phys, r] = qk
            self.values[phys, r] = qv
            self.key_scale[phys, r] = sk
            self.value_scale[phys, r] = sv
        return dataclasses.replace(self, length=self.length + 1)

    def attend(self, q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Decode attention for ``q [n, 1, H, D]`` under ``mask [n, 1, 1,
        total]``."""
        return paged_attention(
            q, self.keys, self.values, self.table, mask[:, 0, 0, :],
            key_scale=self.key_scale, value_scale=self.value_scale,
        )
