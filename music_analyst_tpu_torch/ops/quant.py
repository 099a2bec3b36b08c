"""int8 KV-page quantization for the paged decode cache.

Counterpart of the KV-page part of ``music_analyst_tpu/ops/quant.py``
(``quantize_kv_page`` / ``dequantize_kv_page``).  KV rows are quantized
symmetrically per (page, row): one f32 scale covers one token's
``(n_kv_heads, head_dim)`` K or V block, so writing a decode token never
re-scales a row written earlier.  The dequant (codes x scale, rounded to
the compute dtype) runs inside the paged-attention kernel's load.

Round trip: a row dequantized to f32 quantizes back to the same codes;
through bf16 a code can move by +-1 once, after which the result is a
fixed point.  The paged prefill rewrites its boundary page, so a row
already written can move by one code once: inside the int8 contract.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_page(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., n_kv, D]`` → ``(codes int8 [..., n_kv, D], scale f32
    [...])`` with ``scale = max(|row|, 1e-8) / 127``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(-2, -1))
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(x32 / scale[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_page(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_page`: ``codes [..., n_kv, D]`` x
    ``scale [...]`` → ``dtype`` rows."""
    return (q.float() * scale[..., None, None]).to(dtype)
