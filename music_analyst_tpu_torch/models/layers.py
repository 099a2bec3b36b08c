"""Attention and MLP building blocks (PyTorch).

Counterpart of ``music_analyst_tpu/models/layers.py``:
``dot_product_attention`` (GQA included), ``MultiHeadAttention`` (dense
and flash paths, optional biases, GQA, RoPE, a KV cache), ``KVCache``,
``RMSNorm``, ``SwiGLU``, ``GeluMLP``, ``rope_frequencies``/``apply_rope``
and the ``causal_mask``/``padding_mask``/``segment_mask`` helpers.  The
quantized projections are not ported yet.

Layouts follow the JAX package at the function boundaries (``[B, S, H, D]``
attention tensors, boolean masks broadcastable to ``[B, H, S, KV]``); the
projections are ``nn.Linear`` (weights ``[out, in]``), which the models'
``params_from_jax`` map from Flax's ``[in, out]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from music_analyst_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention ``[B, S, H, D]`` with an f32 softmax.

    The JAX formulation step for step: logits in the input dtype, cast to
    f32 and scaled, masked with ``finfo(f32).min``, softmaxed in f32, cast
    back, then contracted with ``v``.  GQA broadcasts kv heads over their
    query-head groups.
    """
    n_q_heads, n_kv_heads = q.shape[2], k.shape[2]
    out_dtype = q.dtype
    # Mixed inputs (an f32 model over a bf16 cache) compute in the wider
    # type, as jnp's promotion does; the cast is exact.
    dtype = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if n_kv_heads != n_q_heads:
        group = n_q_heads // n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def causal_mask(q_len: int, kv_len: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """``[1, 1, q_len, kv_len]`` causal mask with a cache offset."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, None, :, :]


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B, 1, 1, max_len]`` key-padding mask from per-row lengths."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None])[:, None, None, :]


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, 1, S, S]`` block-diagonal mask: token pairs attend iff they
    share a segment id (packed batches)."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def rope_frequencies(head_dim: int, max_positions: int,
                     theta: float = 10_000.0, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables ``[max_positions, head_dim / 2]`` in f32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    positions = torch.arange(max_positions, dtype=torch.float32,
                             device=device)
    angles = torch.outer(positions, inv_freq)
    return torch.cos(angles), torch.sin(angles)


_ROPE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(head_dim, max_positions, theta, device):
    """One table pair per geometry and device, shared by every layer."""
    key = (head_dim, max_positions, float(theta), str(device))
    tables = _ROPE_TABLES.get(key)
    if tables is None:
        tables = _ROPE_TABLES[key] = rope_frequencies(
            head_dim, max_positions, theta, device)
    return tables


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by the angles at ``positions [B, S]``:
    contiguous halves (HF's ``rotate_half``), f32 arithmetic, result in
    ``x``'s dtype."""
    pos = positions.long()
    cos_p = cos[pos][:, :, None, :]
    sin_p = sin[pos][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat(
        (x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p), dim=-1
    )
    return rotated.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer decode cache; keys/values ``[B, max_len, n_kv_heads, D]``.

    ``length`` is the write offset: an int shared by every row (static
    batch decode), or a ``[B]`` tensor giving each row its own (slot
    views).  ``update`` writes into the buffers in place and returns the
    cache advanced past the new tokens; offsets clamp so the new tokens
    fit, as ``dynamic_update_slice`` does.
    """

    keys: torch.Tensor
    values: torch.Tensor
    length: Union[int, torch.Tensor]

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
              dtype: torch.dtype = torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, max_len, n_kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        S = k_new.shape[1]
        limit = self.keys.shape[1] - S
        k_new = k_new.to(self.keys.dtype)
        v_new = v_new.to(self.values.dtype)
        if isinstance(self.length, torch.Tensor) and self.length.dim() == 1:
            start = self.length.long().clamp(0, limit)
            rows = torch.arange(self.keys.shape[0], device=start.device)[:, None]
            cols = start[:, None] + torch.arange(S, device=start.device)
            self.keys[rows, cols] = k_new
            self.values[rows, cols] = v_new
        else:
            start = min(max(int(self.length), 0), limit)
            self.keys[:, start:start + S] = k_new
            self.values[:, start:start + S] = v_new
        return KVCache(self.keys, self.values, self.length + S)


class RMSNorm(nn.Module):
    """Root-mean-square norm with f32 statistics and an f32 scale, output
    in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(
            x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and f32 parameters, output in the
    input's dtype (Flax ``LayerNorm(dtype=bf16)`` semantics)."""

    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """MHA/GQA self-attention with per-Q/K/V/O projections, optional RoPE
    and an optional KV cache.

    ``attn_impl="flash"`` runs the flash-attention kernel
    (``ops/flash_attention.py``) with masking from ``lengths`` and
    ``segment_ids``; ``"dense"`` takes a boolean ``mask`` array and
    materialises the logits.  With a ``cache`` the new K/V rows are written
    first and attention runs over the whole cache (dense), or, for a cache
    that has an ``attend`` method (``ops/paged_attention.PagedAttnView``),
    through that method; ``forward`` then returns ``(out, new_cache)``.
    """

    def __init__(
        self,
        dim: int,
        n_heads: int,
        attn_impl: str = "dense",
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        n_kv_heads: Optional[int] = None,
        head_dim: Optional[int] = None,
        use_rope: bool = False,
        rope_theta: float = 10_000.0,
        max_positions: int = 4096,
    ) -> None:
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense/flash, got {attn_impl!r}")
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = head_dim or dim // n_heads
        self.attn_impl = attn_impl
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.max_positions = max_positions
        q_dim = self.n_heads * self.head_dim
        kv_dim = self.n_kv_heads * self.head_dim
        self.q_proj = nn.Linear(dim, q_dim, bias=use_bias, dtype=dtype)
        self.k_proj = nn.Linear(dim, kv_dim, bias=use_bias, dtype=dtype)
        self.v_proj = nn.Linear(dim, kv_dim, bias=use_bias, dtype=dtype)
        self.o_proj = nn.Linear(q_dim, dim, bias=use_bias, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache=None,
    ):
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(B, S, self.n_kv_heads, self.head_dim)
        v = self.v_proj(x).view(B, S, self.n_kv_heads, self.head_dim)
        if self.use_rope:
            if positions is None:
                positions = torch.arange(S, device=x.device).expand(B, S)
            cos, sin = _rope_tables(self.head_dim, self.max_positions,
                                    self.rope_theta, x.device)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        new_cache = None
        paged = False
        if cache is not None:
            new_cache = cache.update(k, v)
            paged = hasattr(new_cache, "attend")
            if not paged:
                k, v = new_cache.keys, new_cache.values
        if paged:
            out = new_cache.attend(q, mask)
        elif self.attn_impl == "flash" and cache is None:
            # The kernel masks only through lengths / segments; an
            # arbitrary mask array cannot reach it, so refuse one outright.
            if mask is not None:
                raise ValueError(
                    "attn_impl='flash' cannot apply a mask array; pass "
                    "mask=None with lengths= (padding) and/or segment_ids=, "
                    "or use attn_impl='dense'"
                )
            out = flash_attention(q, k, v, lengths=lengths,
                                  q_segment_ids=segment_ids)
        else:
            if segment_ids is not None:
                raise ValueError(
                    "segment_ids is the flash path's masking vocabulary; "
                    "dense callers pass a block-diagonal mask array"
                )
            out = dot_product_attention(q, k, v, mask)
        out = self.o_proj(out.reshape(B, S, self.n_heads * self.head_dim))
        if cache is not None:
            return out, new_cache
        return out


class SwiGLU(nn.Module):
    """Llama-style gated MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden_dim, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(dim, hidden_dim, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(hidden_dim, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class GeluMLP(nn.Module):
    """BERT-style 2-layer MLP with biases and exact (erf) GELU."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim, dtype=dtype)
        self.lin2 = nn.Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))
