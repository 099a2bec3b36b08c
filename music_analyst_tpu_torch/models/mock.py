"""The ``--mock`` classifier backend: the keyword-scan kernel on the card.

Counterpart of ``music_analyst_tpu/models/mock.py``.  Reference behavior
(``scripts/sentiment_classifier.py:57-83``): strip the lyric; empty →
Neutral; otherwise substring-score the ten keywords and label by sign.
Scoring runs batched on the device (``ops/keyword_sentiment.py``).
"""

from __future__ import annotations

from typing import List, Sequence

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines.sentiment import ClassifierBackend
from music_analyst_tpu_torch.ops.keyword_sentiment import score_texts
from music_analyst_tpu_torch.utils.labels import score_to_label


class MockKeywordClassifier(ClassifierBackend):
    name = "mock"
    # Reference mock records latency 0.0 for every song
    # (scripts/sentiment_classifier.py:83).
    reports_latency = False

    def __init__(self, window_bytes: int = 4096,
                 device: DeviceLike = "cuda") -> None:
        self.window_bytes = window_bytes
        self.device = resolve_device(device)

    def classify_batch(self, texts: Sequence[str]) -> List[str]:
        scores = score_texts(texts, length=self.window_bytes, device=self.device)
        # Empty (post-strip) lyrics score 0 → Neutral, identical to the
        # reference's explicit short-circuit.
        return [score_to_label(int(s)) for s in scores]
