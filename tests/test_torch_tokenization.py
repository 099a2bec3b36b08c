"""Port tokenizers ≡ the JAX package's: identical ids, exactly.

Covers the hash tokenizer (Python path and the port's native binding,
small-vocab special-id clamping included), BERT basic tokenization and
WordPiece over a small vocab.  Inputs are seeded with numpy.
"""

import numpy as np
import pytest

from music_analyst_tpu.models import tokenization as jt
from music_analyst_tpu_torch.data import native
from music_analyst_tpu_torch.models import tokenization as tt

_PIECES = ("Love", "don't", "CAFÉ", "naïve", "日本語", "🎵", "rock'n'roll",
           "\t", "\n", "$5", "a-b", "x" * 40, "é", "", "  ", "Über", "¿qué?")


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_PIECES, size=int(rng.integers(0, 50))))
            for _ in range(n)]


@pytest.mark.parametrize("vocab", [30522, 1024, 20])
def test_hash_tokenizer_ids_match(vocab):
    texts = _texts(0, 60)
    want = jt.HashWordTokenizer(vocab_size=vocab).encode_batch(texts, 48)
    got = tt.HashWordTokenizer(vocab_size=vocab).encode_batch(texts, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_hash_tokenizer_matches_python():
    if not native.available():
        pytest.skip(f"no C++ toolchain for native/: {native.load_error()}")
    texts = _texts(1, 200)
    want = jt.HashWordTokenizer().encode_batch(texts, 128)
    got = tt.NativeHashTokenizer().encode_batch(texts, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bert_basic_tokenize_matches():
    for text in _texts(2, 40) + ["Hello, World!  [MASK]\x00ok​"]:
        assert tt.bert_basic_tokenize(text) == jt.bert_basic_tokenize(text)


def test_wordpiece_matches(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "love", "##ly",
             "don", "'", "t", "cafe", "naive", "rock", "##n", "n", "roll",
             "$", "5", "a", "-", "b", "ub", "##er", "que", "?", "¿", "!"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    texts = _texts(3, 30) + ["lovely [MASK] Über", ""]
    want = jt.WordPieceTokenizer(str(path)).encode_batch(texts, 24)
    clf_tok = tt.resolve_bert_tokenizer(str(path))
    assert isinstance(clf_tok, tt.WordPieceTokenizer)
    got = clf_tok.encode_batch(texts, 24)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
