"""Port native WordPiece ≡ the port's Python WordPiece ≡ JAX's native one.

The port's ``NativeWordPieceTokenizer`` encodes Latin rows in the host
C++ library (``native/ingest.cpp:man_wp_encode_batch``) from the char
table ``_wp_char_table`` builds, and re-encodes the rows the library
flags (codepoints >= U+0370, invalid UTF-8) in Python.  Checks: the char
table equals JAX's byte for byte; ids and lengths equal the port's
Python tokenizer and JAX's native tokenizer on an adversarial corpus and
a seeded random one at several ``max_len`` (truncation included); a
vocab with ``\\r\\n`` or bare ``\\r`` line ends gives the ids of its
``\\n`` twin; a vocab without ``[CLS]``/``[SEP]`` is refused as in JAX;
the telemetry counters name how many rows each path took; and
``resolve_bert_tokenizer`` returns the native class for a vocab.
Vocabularies are built here.  Skips only when the host library cannot
be built.  Tolerance: none (ids exact).
"""

import numpy as np
import pytest

from music_analyst_tpu.data import native as jax_native
from music_analyst_tpu.models import tokenization as jt
from music_analyst_tpu_torch.data import native
from music_analyst_tpu_torch.models import tokenization as tt
from music_analyst_tpu_torch.telemetry import get_telemetry

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "love", "##ing", "##s", "rain", "un", "##known", "a", "b",
    "##c", ".", ",", "!", "'", "cafe", "don", "##t", "##'", "t", "$",
    "##ely", "lone", "night", "##time", "2", "##4", "7", "-", "naive",
    "resume", "søster", "sø", "##ster", "ßuber", "##uber", "über",
]

# Rows the native table handles (ASCII and accented Latin) and rows it
# hands to Python (Greek, CJK, emoji, a lone surrogate).
LATIN = [
    "love loving rains",
    "UNKNOWNWORD love",
    "love, rain!  night-time 24/7",
    "café Café CAFÉ",
    "don't Don'T",
    "a\tb\nc\r\x00d",
    "the  the the",
    "$$$ lone.ly...",
    "",
    "   ",
    "love" * 50,
    "naïve résumé",
    "søster ßüber Über",
    "the [MASK] love",
    "the[MASK]love [SEP] [mask] [UNK]x",
    "[CLS] [PAD][PAD]",
    "pure ascii love rain the don't $ 24/7 [MASK] x " * 6,
]
PYTHON = [
    "the ελληνικά row",
    "爱 the 愛love",
    "love 🎵 rain",
    "a\ud800b love",
]


def _require_native():
    if not native.available():
        pytest.skip(f"no C++ toolchain for native/: {native.load_error()}")


def _write_vocab(path, entries, newline="\n"):
    path.write_bytes(newline.join(entries).encode("utf-8") + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return _write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt", VOCAB)


def _assert_equal_ids(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_char_table_equals_jax():
    got, want = tt._wp_char_table(), jt._wp_char_table()
    assert tt._WP_TABLE_MAX == jt._WP_TABLE_MAX
    assert got[0].dtype == want[0].dtype and got[2].dtype == want[2].dtype
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1] == want[1]
    assert got[2].tobytes() == want[2].tobytes()


@pytest.mark.parametrize("max_len", [2, 8, 32, 256])
def test_adversarial_corpus_ids_equal(vocab_path, max_len):
    _require_native()
    nat = tt.NativeWordPieceTokenizer(vocab_path)
    assert nat._handle is not None
    corpus = LATIN + PYTHON
    want = tt.WordPieceTokenizer(vocab_path).encode_batch(corpus, max_len)
    _assert_equal_ids(nat.encode_batch(corpus, max_len), want)
    if jax_native.available():
        jax_ids = jt.NativeWordPieceTokenizer(vocab_path).encode_batch(
            corpus, max_len)
        _assert_equal_ids(jax_ids, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_corpus_ids_equal(vocab_path, seed):
    _require_native()
    rng = np.random.default_rng(seed)
    pieces = ["love", "the", "rain", "unknown", "zzz", "don't", "café", ",",
              "!", ".", "$", "a", "b", "C", "naïve", "''", "  ", "\t",
              "x" * 120, "24", "7-7", "[MASK]", "[SEP]", "[mask]", "Über",
              "søster", "ÆØÅ", "́", "ǅ", "ʼ", "\x7f", "愛", "ω"]
    corpus = [
        "".join(rng.choice(pieces) + (" " if rng.random() < 0.7 else "")
                for _ in range(int(rng.integers(0, 40))))
        for _ in range(400)
    ]
    want = tt.WordPieceTokenizer(vocab_path).encode_batch(corpus, 48)
    _assert_equal_ids(tt.NativeWordPieceTokenizer(vocab_path).encode_batch(
        corpus, 48), want)
    if jax_native.available():
        _assert_equal_ids(jt.NativeWordPieceTokenizer(
            vocab_path).encode_batch(corpus, 48), want)


@pytest.mark.parametrize("newline", ["\r\n", "\r"])
def test_universal_newline_vocab(tmp_path, newline):
    _require_native()
    unix = _write_vocab(tmp_path / "unix.txt", VOCAB)
    other = _write_vocab(tmp_path / "other.txt", VOCAB, newline)
    corpus = LATIN + PYTHON
    want = tt.WordPieceTokenizer(unix).encode_batch(corpus, 32)
    nat = tt.NativeWordPieceTokenizer(other)
    assert nat._handle is not None
    assert nat.vocab == tt.WordPieceTokenizer(unix).vocab
    _assert_equal_ids(nat.encode_batch(corpus, 32), want)


@pytest.mark.parametrize("missing", ["[CLS]", "[SEP]"])
def test_vocab_without_cls_or_sep_is_refused(tmp_path, missing):
    path = _write_vocab(tmp_path / "vocab.txt",
                        [t for t in VOCAB if t != missing])
    with pytest.raises(KeyError):
        jt.NativeWordPieceTokenizer(path)
    with pytest.raises(KeyError):
        tt.NativeWordPieceTokenizer(path)
    # The library refuses it on its own too: no handle that half works.
    if native.available():
        assert native.wp_create(path, tt._wp_char_table()) is None


def test_row_counters_name_the_path(vocab_path):
    _require_native()
    nat = tt.NativeWordPieceTokenizer(vocab_path)
    tel = get_telemetry()
    with tel.run_scope("unit", None):
        nat.encode_batch(LATIN + PYTHON + LATIN, 32)
        counters = dict(tel.counters)
    assert counters["tokenizer.wordpiece.native_rows"] == 2 * len(LATIN)
    assert counters["tokenizer.wordpiece.python_rows"] == len(PYTHON)


def test_row_counters_without_the_library(vocab_path, monkeypatch):
    """Without a handle every row is encoded in Python, and counted so."""
    nat = tt.NativeWordPieceTokenizer(vocab_path)
    monkeypatch.setattr(nat, "_handle", None)
    tel = get_telemetry()
    with tel.run_scope("unit", None):
        got = nat.encode_batch(LATIN, 16)
        counters = dict(tel.counters)
    _assert_equal_ids(got, tt.WordPieceTokenizer(vocab_path).encode_batch(
        LATIN, 16))
    assert counters["tokenizer.wordpiece.python_rows"] == len(LATIN)
    assert "tokenizer.wordpiece.native_rows" not in counters


def test_resolve_bert_tokenizer_returns_native(vocab_path, monkeypatch):
    assert isinstance(tt.resolve_bert_tokenizer(vocab_path),
                      tt.NativeWordPieceTokenizer)
    monkeypatch.setenv("MUSICAAL_BERT_VOCAB", vocab_path)
    assert isinstance(tt.resolve_bert_tokenizer(),
                      tt.NativeWordPieceTokenizer)
    monkeypatch.delenv("MUSICAAL_BERT_VOCAB")
    assert isinstance(tt.resolve_bert_tokenizer(), tt.NativeHashTokenizer)
