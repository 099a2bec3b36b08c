"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``music_analyst_tpu/ops/flash_attention.py:flash_attention``,
whose Pallas body (``_flash_kernel``) becomes
``csrc/flash_attention.cu:flash_fwd_kernel``.  The signature and the
``[B, S, H, D]`` layout are the JAX function's, so the two packages are
compared like with like.

Masks compose as on the TPU: per-row kv ``lengths`` (global positions),
``causal`` with global ``q_offset``/``kv_offset``, and block-diagonal
``q_segment_ids``/``kv_segment_ids`` (packed batches).  GQA maps query head
``h`` to kv head ``h // (H // Hkv)``.  A query with no valid key outputs
zeros.  ``return_residuals=True`` returns ``(o_unnormalized f32 [B,S,H,D],
m [B,H,S], l [B,H,S])`` for cross-shard combination.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_reference` only for CPU tensors.  The kernel has no
block-size arguments: it tiles by 64 rows (bf16: 128 query rows per block,
64-row K/V tiles through TMA, QK^T and PV on wgmma; f32: CUDA cores) and
masks ragged edges itself.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from music_analyst_tpu_torch import kernels

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

IntLike = Union[int, torch.Tensor]


def _segments(q, k, q_segment_ids, kv_segment_ids):
    B, S = q.shape[:2]
    KV = k.shape[1]
    if q_segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids given without q_segment_ids")
        return None, None
    if kv_segment_ids is None:
        if KV != S:
            raise ValueError(
                "kv_segment_ids is required when KV length differs from "
                "the query length"
            )
        kv_segment_ids = q_segment_ids
    if tuple(q_segment_ids.shape) != (B, S):
        raise ValueError(
            f"q_segment_ids must be [B, S]={B, S}, got "
            f"{tuple(q_segment_ids.shape)}"
        )
    if tuple(kv_segment_ids.shape) != (B, KV):
        raise ValueError(
            f"kv_segment_ids must be [B, KV]={B, KV}, got "
            f"{tuple(kv_segment_ids.shape)}"
        )
    return q_segment_ids, kv_segment_ids


def _check_heads(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B,S,H,D] and k/v [B,KV,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v differ in batch or head dim")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )


def _lengths(lengths, B, KV, kv_offset, device):
    if lengths is None:
        # Lengths are *global* positions: with a kv_offset the local shard
        # covers [kv_offset, kv_offset + KV).
        return torch.full((B,), KV + kv_offset, dtype=torch.int32,
                          device=device)
    return lengths.to(device=device, dtype=torch.int32)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    return_residuals: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the kernel: the same masks and sentinels,
    with the whole ``[B, H, S, KV]`` score tensor materialised in f32."""
    _check_heads(q, k, v)
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    B, S, H, D = q.shape
    KV, Hkv = k.shape[1], k.shape[2]
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    dev = q.device
    group = H // Hkv
    qf = q.float() * (D ** -0.5)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    kv_pos = kv_offset + torch.arange(KV, device=dev)
    lens = _lengths(lengths, B, KV, kv_offset, dev)
    valid = (kv_pos[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(S, device=dev)
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])[None, None]
    if q_seg is not None:
        valid = valid & (
            q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        )
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    if return_residuals:
        return o, m[..., 0], l[..., 0]
    denom = l.clamp(min=1e-30).permute(0, 2, 1, 3)        # [B, S, H, 1]
    return (o / denom).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    return_residuals: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
):
    """Attention over ``[B, S, H, D]`` without materialising the logits.

    CUDA tensors launch ``csrc/flash_attention.cu`` (q/k/v contiguous, one
    of float32/bfloat16, head dim 64 or 128) or raise; CPU tensors
    run :func:`flash_attention_reference`.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, lengths=lengths, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, return_residuals=return_residuals,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_heads(q, k, v)
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    B, S, H, D = q.shape
    KV, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes one of {list(_DTYPE_CODES)} for "
            f"q, k and v alike, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim 64 or 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous {name}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            # The bf16 kernel reads through TMA tensor maps.
            raise ValueError(f"flash_attention kernel needs 16-byte aligned {name}")
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    lens = _lengths(lengths, B, KV, kv_offset, q.device).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"lengths must be [B]={B}, got {tuple(lens.shape)}")
    if q_seg is not None:
        q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
        kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
    if return_residuals:
        out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
        m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
        m = l = None
    if out.numel() == 0:
        if return_residuals:
            return out, m.fill_(NEG_INF), l.zero_()
        return out
    fn = kernels.kernel("flash_attention")
    with torch.cuda.device(q.device):  # launch on q's card, its stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr() if m is not None else None,
            l.data_ptr() if l is not None else None,
            lens.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            kv_seg.data_ptr() if kv_seg is not None else None,
            B, S, KV, H, Hkv, D, q_offset, kv_offset, int(bool(causal)),
            int(bool(return_residuals)), float(D ** -0.5),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("flash_attention", status)
    kernels.count_launch("flash_attention")
    if return_residuals:
        return out, m, l
    return out
