"""Ring attention: sequence-parallel attention across processes.

The port's counterpart of ``music_analyst_tpu/ops/ring_attention.py``.
JAX runs the ring under ``shard_map`` over the ``sp`` mesh axis and
rotates K/V with ``ppermute``; here each rank of a ``torch.distributed``
process group holds one sequence shard, and the K/V blocks rotate by
``batch_isend_irecv`` (a send to ``rank + 1``, a receive from
``rank - 1``).  Queries stay resident; after ``n`` hops every query has
seen every key, with an online softmax (running max / normaliser /
weighted accumulator) across hops and only neighbour traffic.

Each hop is either the dense online-softmax step
(:func:`_block_attn_update`, plain PyTorch) or, with ``use_flash=True``,
one launch of the flash kernel (``ops/flash_attention.py``) in its
residual mode with global ``q_offset``/``kv_offset``; the hop's
``(o, m, l)`` merges with JAX's algebra, where a fully masked hop
(``m = NEG_INF``, ``l = 0``) gets no weight.

Transfers follow the group's backend.  The rotating blocks (K and V at
their compact ``Hkv`` heads, and the segment ids when given) travel as
one ``uint8`` buffer.  Under gloo, whose send and receive read host
memory, a rank whose tensors lie on a card stages the buffer through
pinned host memory: one copy off the card before the first hop, one onto
it after each receive.  Under NCCL the device buffer is sent as it is.
The next block's transfer is posted before the hop's attention is
launched, so the two overlap; the last hop sends nothing (JAX's loop
rotates once more, back to the start).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from music_analyst_tpu_torch.ops.flash_attention import NEG_INF, flash_attention
from music_analyst_tpu_torch.parallel.multihost import transport_device
from music_analyst_tpu_torch.profiling.collectives import record_collective


def _block_attn_update(q, k_blk, v_blk, q_pos, kv_pos, causal, m, l, o,
                       q_seg=None, kv_seg=None):
    """One online-softmax accumulation step against a K/V block
    (``[B, S, H, D]`` inputs, f32 ``m``/``l`` ``[B, H, Q]`` and ``o``
    ``[B, H, Q, D]``)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    allowed = None
    if causal:
        allowed = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
    if q_seg is not None:
        # Block-diagonal over packed documents: same-segment pairs only.
        seg_ok = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        allowed = seg_ok if allowed is None else (allowed & seg_ok)
    if allowed is not None:
        logits = torch.where(allowed, logits, NEG_INF)
    new_m = torch.maximum(m, logits.amax(dim=-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    if allowed is not None:
        # NEG_INF is finite, so a fully masked row's exp() is 1, not 0:
        # zero the masked probabilities explicitly.
        p = torch.where(allowed, p, 0.0)
    new_l = l * correction + p.sum(dim=-1)
    new_o = o * correction[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float()
    )
    return new_m, new_l, new_o


def _group_shape(group) -> Tuple[int, int]:
    """``(size, rank)`` of ``group`` (the default world when ``None``);
    ``(1, 0)`` outside any process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, back to back, in one ``uint8`` buffer."""
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``buf`` shaped as ``like``.  K and V come first, and at
    the flash kernel's head dims (64, 128) each is a multiple of 128
    bytes long, so views of a fresh buffer keep the 16-byte alignment the
    kernel's TMA loads need (``flash_attention.py`` raises otherwise)."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).view(t.shape))
        off += n
    return out


def rotate(send: torch.Tensor, recv: torch.Tensor, group=None) -> list:
    """Post one ring hop: ``send`` to rank + 1, ``recv`` from rank - 1.
    Returns the requests to wait on."""
    n, idx = _group_shape(group)
    ops = [
        dist.P2POp(dist.isend, send, _peer(group, (idx + 1) % n), group),
        dist.P2POp(dist.irecv, recv, _peer(group, (idx - 1) % n), group),
    ]
    return dist.batch_isend_irecv(ops)


def ring_attention_local(q, k, v, segment_ids=None, *, group=None,
                         causal: bool = False, use_flash: bool = False):
    """Per-rank body: ``q, k, v [B, S/n, H|Hkv, D]`` are this rank's
    sequence shard (rank ``idx`` holds positions ``[idx·S/n,
    (idx+1)·S/n)``); returns its ``[B, S/n, H, D]`` output.

    ``segment_ids`` ``[B, S/n]`` (this rank's shard) restricts attention
    to same-segment pairs; the kv-side copy travels with its K/V block,
    so segments that cross a rank boundary mask exactly.
    """
    n, idx = _group_shape(group)
    B, S_loc, H, D = q.shape
    # GQA: the rotating blocks keep their compact Hkv heads; the dense
    # path repeats them to H only inside each hop, and the flash kernel
    # maps query head h to kv head h // (H // Hkv) itself.
    rep = H // k.shape[2]
    dev = q.device
    q_pos = idx * S_loc + torch.arange(S_loc, device=dev)

    m = torch.full((B, H, S_loc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S_loc), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, S_loc, D), dtype=torch.float32, device=dev)

    segmented = segment_ids is not None
    # This rank's own (query-side) segment shard never rotates.
    q_seg = segment_ids.to(torch.int32).contiguous() if segmented else None
    blocks = [k.contiguous(), v.contiguous()] + ([q_seg] if segmented else [])

    if n > 1:
        record_collective(
            "ring_attention.kv_rotate", "ppermute",
            payload_bytes=sum(t.numel() * t.element_size() for t in blocks),
            n_devices=n, axis="sp", count=n - 1,
        )
        staged = dev.type != transport_device(group).type
        cur = _pack(blocks)
        if staged:
            cur = torch.empty(cur.shape, dtype=torch.uint8,
                              pin_memory=True).copy_(cur)
        nxt = torch.empty(cur.shape, dtype=torch.uint8, device=cur.device,
                          pin_memory=staged)

    for step in range(n):
        # After `step` rotations this rank holds the block first owned by
        # rank idx - step.
        owner = (idx - step) % n
        pending = rotate(cur, nxt, group) if step < n - 1 else []
        k_blk, v_blk = blocks[0], blocks[1]
        seg_blk = blocks[2] if segmented else None
        if use_flash:
            o_i, m_i, l_i = flash_attention(
                q, k_blk, v_blk, causal=causal,
                q_offset=idx * S_loc, kv_offset=owner * S_loc,
                return_residuals=True,
                q_segment_ids=q_seg, kv_segment_ids=seg_blk,
            )
            o_i = o_i.permute(0, 2, 1, 3)                  # [B,H,Q,D]
            m_new = torch.maximum(m, m_i)
            c_prev = torch.exp(m - m_new)
            # A fully masked hop has m_i = NEG_INF and l_i = 0: weight 0.
            c_hop = torch.where(m_i > NEG_INF / 2, torch.exp(m_i - m_new),
                                torch.zeros_like(m_i))
            l = l * c_prev + l_i * c_hop
            o = o * c_prev[..., None] + o_i * c_hop[..., None]
            m = m_new
        else:
            kv_pos = owner * S_loc + torch.arange(S_loc, device=dev)
            m, l, o = _block_attn_update(
                q, k_blk.repeat_interleave(rep, dim=2),
                v_blk.repeat_interleave(rep, dim=2), q_pos, kv_pos, causal,
                m, l, o, q_seg=q_seg, kv_seg=seg_blk,
            )
        if pending:
            for req in pending:
                req.wait()
            cur, nxt = nxt, cur
            blocks = _unpack(cur.to(dev) if staged else cur, blocks)
    out = o / l.clamp(min=1e-30)[..., None]                # [B,H,Q,D]
    return out.permute(0, 2, 1, 3).to(q.dtype)             # [B,Q,H,D]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = False,
    use_flash: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over the ranks of ``group``.

    Every rank passes the global ``[B, S, H, D]`` q and ``[B, S, Hkv, D]``
    k/v (and ``[B, S]`` ``segment_ids``), as JAX's caller passes the
    global array; rank ``i`` of ``n`` takes positions ``[i·S/n,
    (i+1)·S/n)``, runs :func:`ring_attention_local`, and the shards'
    outputs are all-gathered in rank order, so every rank returns the
    global ``[B, S, H, D]`` output.
    """
    n, idx = _group_shape(group)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} is not a multiple of {n} ranks")
    shard = slice(idx * (S // n), (idx + 1) * (S // n))
    local = ring_attention_local(
        q[:, shard].contiguous(), k[:, shard].contiguous(),
        v[:, shard].contiguous(),
        None if segment_ids is None else segment_ids[:, shard],
        group=group, causal=causal, use_flash=use_flash,
    )
    if n == 1:
        return local
    rows = local.contiguous().view(torch.uint8)            # bytes, any dtype
    record_collective(
        "ring_attention.output_gather", "all_gather",
        payload_bytes=rows.numel(), n_devices=n, axis="sp",
    )
    rows = rows.to(transport_device(group))
    parts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(parts, rows, group=group)
    return torch.cat(parts, dim=1).to(q.device).view(q.dtype)
