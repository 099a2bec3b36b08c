"""Port keyword scan (plain version, CPU) ≡ the JAX keyword kernel, exactly.

Inputs are seeded with numpy: random lyrics with injected mixed-case
keywords, multi-byte UTF-8, and texts longer than the 4096-byte window.
Tolerance: none — scores and labels must be identical.
"""

import numpy as np
import pytest
import torch

from music_analyst_tpu.models.mock import MockKeywordClassifier as JaxMock
from music_analyst_tpu.ops import keyword_sentiment as jks
from music_analyst_tpu.ops.pallas_keyword import keyword_scores_pallas
from music_analyst_tpu_torch.models.mock import MockKeywordClassifier
from music_analyst_tpu_torch.ops import keyword_kernel, keyword_sentiment as tks

# Small shapes: one intra-op thread is enough, and keeps these tests from
# crowding the timing-sensitive tests that parallel workers run beside them.
torch.set_num_threads(1)

_FILLER = ("the", "night", "música", "coração", "naïve", "x", "日本", "🎵",
           "lov", "sa d", "te ars", "HAP", "py", "\n", "  ")


def _lyrics(seed: int, n: int, long_every: int = 0):
    rng = np.random.default_rng(seed)
    keywords = jks.POSITIVE_KEYWORDS + jks.NEGATIVE_KEYWORDS
    texts = []
    for i in range(n):
        words = list(rng.choice(_FILLER, size=int(rng.integers(0, 60))))
        for _ in range(int(rng.integers(0, 4))):
            kw = str(rng.choice(keywords))
            mixed = "".join(
                c.upper() if rng.random() < 0.5 else c for c in kw
            )
            words.insert(int(rng.integers(0, len(words) + 1)), mixed)
        text = " ".join(words)
        if long_every and i % long_every == 0:
            # Past the window: the keyword sits after the first 4096 bytes,
            # so only the chunked path can find it.
            text = "ñ" * 2100 + text + " " + str(rng.choice(keywords)).upper()
        texts.append(text)
    return texts


def _matrix(texts, length):
    batch, _ = jks.encode_batch(texts, length)
    return batch


def test_constants_match():
    assert keyword_kernel.POSITIVE_KEYWORDS == jks.POSITIVE_KEYWORDS
    assert keyword_kernel.NEGATIVE_KEYWORDS == jks.NEGATIVE_KEYWORDS
    assert tks.MAX_KEYWORD_LEN == jks.MAX_KEYWORD_LEN


@pytest.mark.parametrize("length", [512, 1024])
def test_keyword_scores_match_jax(length):
    batch = _matrix(_lyrics(1, 96), length)
    want = np.asarray(jks.keyword_scores(batch))
    got = tks.keyword_scores(torch.from_numpy(batch)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_keyword_scores_match_pallas_kernel():
    batch = _matrix(_lyrics(2, 40), 512)
    want = keyword_scores_pallas(batch)
    np.testing.assert_array_equal(
        tks.keyword_scores(torch.from_numpy(batch)).numpy(), want
    )


def test_keyword_labels_match_jax():
    batch = _matrix(_lyrics(3, 64), 512)
    np.testing.assert_array_equal(
        tks.keyword_labels(torch.from_numpy(batch)).numpy(),
        np.asarray(jks.keyword_labels(batch)),
    )


def test_hits_bits_agree_with_scores():
    batch = torch.from_numpy(_matrix(_lyrics(4, 64), 512))
    scores, hits = keyword_kernel.keyword_scan(batch, return_hits=True)
    signs = np.asarray(keyword_kernel.SIGNS)
    bits = (hits.numpy()[:, None] >> np.arange(len(signs))) & 1
    np.testing.assert_array_equal(scores.numpy(), bits @ signs)


def test_encode_batch_matches_jax():
    texts = _lyrics(5, 20, long_every=3)
    got, got_over = tks.encode_batch(texts, 1024)
    want, want_over = jks.encode_batch(texts, 1024)
    np.testing.assert_array_equal(got, want)
    assert got_over == want_over


@pytest.mark.parametrize("window", [512, 4096])
def test_score_texts_match_jax_including_long_lyrics(window):
    texts = _lyrics(6, 24, long_every=8) + ["", "   ", "LoNeLy " * 700]
    want = jks.score_texts(texts, length=window)
    got = tks.score_texts(texts, length=window, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_mock_classifier_labels_match_jax():
    texts = _lyrics(7, 80, long_every=9)
    assert (MockKeywordClassifier(device="cpu").classify_batch(texts)
            == JaxMock().classify_batch(texts))


def test_keyword_scan_rejects_bad_shape():
    with pytest.raises(ValueError):
        keyword_kernel.keyword_scan(torch.zeros(8, dtype=torch.uint8))
