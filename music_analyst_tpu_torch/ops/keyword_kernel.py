"""Keyword scan: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``music_analyst_tpu/ops/pallas_keyword.py``: its Pallas
body ``_scan_kernel`` becomes ``csrc/keyword_scan.cu:keyword_scan_kernel``.
Semantics are the reference ``--mock`` heuristic
(``scripts/sentiment_classifier.py:66-83``): ASCII-lowercase a padded
uint8 lyric row, test substring containment of five positive and five
negative keywords, score = #positive present - #negative present.

:func:`keyword_scan` launches the kernel for a CUDA tensor and runs
:func:`keyword_scan_reference` only for a CPU tensor.  Besides the score
it can return each row's keyword bit mask, which the chunked long-lyric
path ORs across windows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from music_analyst_tpu_torch import kernels

# Reference keyword sets (scripts/sentiment_classifier.py:70-71).
POSITIVE_KEYWORDS: Tuple[str, ...] = ("love", "happy", "joy", "sunshine", "smile")
NEGATIVE_KEYWORDS: Tuple[str, ...] = ("cry", "sad", "pain", "lonely", "tears")

KEYWORDS = POSITIVE_KEYWORDS + NEGATIVE_KEYWORDS
SIGNS = (1,) * len(POSITIVE_KEYWORDS) + (-1,) * len(NEGATIVE_KEYWORDS)
MAX_KEYWORD_LEN = max(map(len, KEYWORDS))

# The kernel compares one 8-byte little-endian window per position and
# keeps one hit bit per keyword in an int32.
if MAX_KEYWORD_LEN > 8 or len(KEYWORDS) > 16:
    raise ValueError("keyword_scan kernel takes at most 16 keywords of <= 8 bytes")


def _tables():
    """``(patterns, masks, signs)`` host arrays for the kernel: keyword
    bytes packed little-endian into a uint64, and a mask of its length."""
    patterns = np.zeros(len(KEYWORDS), np.uint64)
    masks = np.zeros(len(KEYWORDS), np.uint64)
    for i, kw in enumerate(KEYWORDS):
        data = kw.encode()
        patterns[i] = int.from_bytes(data, "little")
        masks[i] = (1 << (8 * len(data))) - 1
    return patterns, masks, np.asarray(SIGNS, np.int32)


_PATTERNS, _MASKS, _SIGNS = _tables()


def _lower_ascii(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x >= 65) & (x <= 90), x + 32, x)


def _contains(x: torch.Tensor, keyword: bytes) -> torch.Tensor:
    """Per-row substring containment of ``keyword`` in byte matrix ``x``:
    AND the m shifted equality masks, OR over positions (padding bytes are
    0 and keywords hold none, so padding never matches)."""
    length = x.shape[-1]
    m = len(keyword)
    if length < m:
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    window = length - m + 1
    acc = x[..., 0:window] == keyword[0]
    for j in range(1, m):
        acc = acc & (x[..., j : window + j] == keyword[j])
    return acc.any(dim=-1)


def keyword_scan_reference(batch: torch.Tensor):
    """Plain PyTorch version: ``(scores int32 [B], hits int32 [B])``."""
    x = _lower_ascii(batch)
    scores = torch.zeros(batch.shape[:-1], dtype=torch.int32, device=batch.device)
    hits = torch.zeros_like(scores)
    for i, (kw, sign) in enumerate(zip(KEYWORDS, SIGNS)):
        hit = _contains(x, kw.encode()).to(torch.int32)
        scores += sign * hit
        hits |= hit << i
    return scores, hits


def keyword_scan(batch: torch.Tensor, return_hits: bool = False):
    """Scores (and, with ``return_hits``, keyword bit masks) for a padded
    uint8 batch ``[B, L]``.  CUDA tensors launch ``csrc/keyword_scan.cu``
    (contiguous uint8 required) or raise; CPU tensors run the plain
    version."""
    if batch.dim() != 2:
        raise ValueError(f"expected a [B, L] byte matrix, got {tuple(batch.shape)}")
    if batch.device.type == "cpu":
        scores, hits = keyword_scan_reference(batch)
        return (scores, hits) if return_hits else scores
    if batch.device.type != "cuda":
        raise ValueError(f"keyword_scan: unsupported device {batch.device}")
    if batch.dtype != torch.uint8:
        raise TypeError(f"keyword_scan kernel takes uint8, got {batch.dtype}")
    if not batch.is_contiguous():
        raise ValueError("keyword_scan kernel needs a contiguous batch")
    B, L = batch.shape
    scores = torch.empty((B,), dtype=torch.int32, device=batch.device)
    hits = torch.empty_like(scores) if return_hits else None
    if B == 0 or L == 0:
        scores.zero_()
        if hits is not None:
            hits.zero_()
        return (scores, hits) if return_hits else scores
    fn = kernels.kernel("keyword_scan")
    with torch.cuda.device(batch.device):  # launch on the batch's card
        status = fn(
            batch.data_ptr(), B, L,
            _PATTERNS.ctypes.data, _MASKS.ctypes.data, _SIGNS.ctypes.data,
            len(KEYWORDS), scores.data_ptr(),
            hits.data_ptr() if hits is not None else None,
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("keyword_scan", status)
    kernels.count_launch("keyword_scan")
    return (scores, hits) if return_hits else scores
