"""Batched keyword sentiment — the ``--mock`` backend on the card.

Counterpart of ``music_analyst_tpu/ops/keyword_sentiment.py``.  Lyrics are
encoded as a padded uint8 byte matrix and scored by the keyword-scan
kernel (``ops/keyword_kernel.py``); see that module for the matching
semantics (substring containment, each keyword counted once, ASCII
lowercasing).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.ops.keyword_kernel import (
    MAX_KEYWORD_LEN,
    NEGATIVE_KEYWORDS,
    POSITIVE_KEYWORDS,
    SIGNS,
    keyword_scan,
)
from music_analyst_tpu_torch.runtime.wire import to_device
from music_analyst_tpu_torch.utils.shapes import round_pow2

__all__ = [
    "MAX_KEYWORD_LEN", "NEGATIVE_KEYWORDS", "POSITIVE_KEYWORDS",
    "encode_batch", "keyword_labels", "keyword_scores", "score_texts",
]

# Label ids follow utils.labels.LABEL_TO_ID: 0=Positive, 1=Neutral, 2=Negative.
_POSITIVE, _NEUTRAL, _NEGATIVE = 0, 1, 2


def keyword_scores(byte_matrix: torch.Tensor) -> torch.Tensor:
    """Scores for a padded uint8 batch ``[B, L]`` → int32 ``[B]``."""
    return keyword_scan(byte_matrix)


def keyword_labels(byte_matrix: torch.Tensor) -> torch.Tensor:
    """Label ids (0=Positive, 1=Neutral, 2=Negative) for a padded batch."""
    score = keyword_scores(byte_matrix)
    return torch.where(
        score > 0, _POSITIVE, torch.where(score < 0, _NEGATIVE, _NEUTRAL)
    )


def encode_batch(
    texts: Sequence[str],
    length: int,
) -> Tuple[np.ndarray, List[int]]:
    """Encode stripped lyrics to a padded ``[B, length]`` uint8 matrix.

    Returns the matrix plus the indices of songs whose UTF-8 encoding
    exceeds ``length`` (their windows need the chunked path to preserve
    exact containment semantics).
    """
    batch = np.zeros((len(texts), length), dtype=np.uint8)
    overflow: List[int] = []
    for i, text in enumerate(texts):
        data = text.strip().encode("utf-8", errors="replace")
        if len(data) > length:
            overflow.append(i)
            data = data[:length]
        row = np.frombuffer(data, dtype=np.uint8)
        batch[i, : row.shape[0]] = row
    return batch, overflow


def score_texts(
    texts: Sequence[str],
    length: int = 4096,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Exact batched scores for arbitrary-length lyrics.

    The batch is padded only to the power-of-two bucket covering its
    longest row (floor 512, cap ``length``), so typical lyrics do not move
    ~4x the bytes a fixed ``length`` would.  Songs above the cap are
    re-scored over overlapping windows (overlap ``MAX_KEYWORD_LEN - 1`` so
    no match can straddle a boundary) — exact for any length.
    """
    device = resolve_device(device)
    max_bytes = max(
        (len(t.strip().encode("utf-8", errors="replace")) for t in texts),
        default=1,
    )
    bucket = min(round_pow2(min(max_bytes, length), 512), length)
    batch, overflow = encode_batch(texts, bucket)
    (x,) = to_device([batch], device)
    scores = keyword_scores(x).cpu().numpy()
    for i in overflow:
        scores[i] = _score_long_text(texts[i].strip(), bucket, device)
    return scores


def _score_long_text(text: str, length: int, device: torch.device) -> int:
    """Windowed exact scoring for a single oversized lyric: the kernel's
    per-window keyword bits, OR-ed over the windows."""
    data = text.encode("utf-8", errors="replace")
    step = length - (MAX_KEYWORD_LEN - 1)
    windows = [data[start : start + length] for start in range(0, len(data), step)]
    batch = np.zeros((len(windows), length), dtype=np.uint8)
    for i, w in enumerate(windows):
        batch[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    (x,) = to_device([batch], device)
    _, hits = keyword_scan(x, return_hits=True)
    bits = int(np.bitwise_or.reduce(hits.cpu().numpy()))
    return sum(sign for i, sign in enumerate(SIGNS) if bits >> i & 1)
