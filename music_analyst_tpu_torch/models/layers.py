"""Attention and MLP building blocks (PyTorch).

Counterpart of the encoder pieces of ``music_analyst_tpu/models/layers.py``:
``dot_product_attention`` (GQA included), ``MultiHeadAttention`` (dense
and flash paths, optional biases), ``GeluMLP``, ``padding_mask`` and
``segment_mask``.  RoPE, KV caches and the quantized projections wait for
the decoder slice.

Layouts follow the JAX package at the function boundaries (``[B, S, H, D]``
attention tensors, boolean masks broadcastable to ``[B, H, S, KV]``); the
projections are ``nn.Linear`` (weights ``[out, in]``), which
``models/distilbert.py:params_from_jax`` maps from Flax's ``[in, out]``.
"""

from __future__ import annotations

from typing import Optional

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
    if n_kv_heads != n_q_heads:
        group = n_q_heads // n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B, 1, 1, max_len]`` key-padding mask from per-row lengths."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None])[:, None, None, :]


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, 1, S, S]`` block-diagonal mask: token pairs attend iff they
    share a segment id (packed batches)."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


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
    """Multi-head self-attention with fused per-Q/K/V/O projections.

    ``attn_impl="flash"`` runs the flash-attention kernel
    (``ops/flash_attention.py``) with masking from ``lengths`` and
    ``segment_ids``; ``"dense"`` takes a boolean ``mask`` array and
    materialises the logits.  (GQA, RoPE, causal masking and KV caches
    arrive with the decoder.)
    """

    def __init__(
        self,
        dim: int,
        n_heads: int,
        attn_impl: str = "dense",
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense/flash, got {attn_impl!r}")
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.attn_impl = attn_impl
        self.q_proj = nn.Linear(dim, dim, bias=use_bias, dtype=dtype)
        self.k_proj = nn.Linear(dim, dim, bias=use_bias, dtype=dtype)
        self.v_proj = nn.Linear(dim, dim, bias=use_bias, dtype=dtype)
        self.o_proj = nn.Linear(dim, dim, bias=use_bias, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        B, S, D = x.shape
        heads = (B, S, self.n_heads, self.head_dim)
        q = self.q_proj(x).view(heads)
        k = self.k_proj(x).view(heads)
        v = self.v_proj(x).view(heads)
        if self.attn_impl == "flash":
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
        return self.o_proj(out.reshape(B, S, D))


class GeluMLP(nn.Module):
    """BERT-style 2-layer MLP with biases and exact (erf) GELU."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim, dtype=dtype)
        self.lin2 = nn.Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))
