"""Port host ingest ≡ the JAX package's: tokenizer, vocab, exact CSV parser,
``ingest_dataset`` (python and native backends) and the corpus cache.

Inputs: the fixture CSV and a generated 2,000-song CSV (seeded), plus
seeded random byte strings.  Tolerance: none — ids, offsets, records and
every written byte must be equal.
"""

import numpy as np
import pytest

from music_analyst_tpu.data import corpus_cache as jcache
from music_analyst_tpu.data import csv_io as jcsv
from music_analyst_tpu.data import native as jnative
from music_analyst_tpu.data.ingest import ingest_dataset as jax_ingest
from music_analyst_tpu.data.tokenizer import tokenize_ascii as jax_tokenize
from music_analyst_tpu.data.tokenizer import tokenize_latin1 as jax_latin1
from music_analyst_tpu.data.vocab import Vocab as JaxVocab
from music_analyst_tpu.data.vocab import encode_corpus as jax_encode
from music_analyst_tpu_torch.data import corpus_cache as tcache
from music_analyst_tpu_torch.data import csv_io as tcsv
from music_analyst_tpu_torch.data import native as tnative
from music_analyst_tpu_torch.data.ingest import ingest_dataset
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.data.tokenizer import tokenize_ascii, tokenize_latin1
from music_analyst_tpu_torch.data.vocab import Vocab, encode_corpus


@pytest.fixture(scope="module")
def songs_2000(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "songs_2000.csv"
    generate_dataset(str(path), num_songs=2000, seed=3)
    return path


def _random_texts(n=200, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019' \n\t,.\"-") + ["é", "ção", "Ü", "’", "💜"]
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 60)))
            for _ in range(n)]


def test_tokenizers_match_jax(fixture_csv):
    texts = _random_texts() + [t for _, _, t in tcsv.iter_songs(str(fixture_csv))]
    for text in texts:
        assert tokenize_ascii(text) == jax_tokenize(text)
        assert tokenize_ascii(text.encode("utf-8")) == jax_tokenize(
            text.encode("utf-8"))
        assert list(tokenize_latin1(text)) == list(jax_latin1(text))


def test_vocab_and_encode_corpus_match_jax():
    lists = [jax_tokenize(t) for t in _random_texts(seed=1)]
    tv, tids, toff = encode_corpus(lists)
    jv, jids, joff = jax_encode(lists)
    assert tv.tokens == jv.tokens
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(toff, joff)
    counts = np.random.default_rng(2).integers(0, 3, size=len(tv))
    assert tv.counts_to_entries(counts) == jv.counts_to_entries(counts)
    assert Vocab(["a", "b", "a"]).tokens == JaxVocab(["a", "b", "a"]).tokens
    assert Vocab(["x"]).get("y") == JaxVocab(["x"]).get("y") == -1


def test_exact_csv_parser_matches_jax(fixture_csv, songs_2000):
    cases = [b"", b'a,b,c,"x\r\ny"\r\nq,w,e,r\rlast', b'"open,,,quote',
             b'h1,h2,h3,h4\n  " a ",b,c,  "t""q"  \n\n,s,l,\n']
    for path in (fixture_csv, songs_2000):
        cases.append(path.read_bytes())
    for data in cases:
        records = list(tcsv.iter_csv_records_exact(data))
        assert records == list(jcsv.iter_csv_records_exact(data))
        for rec in records:
            assert tcsv.parse_record_exact(rec) == jcsv.parse_record_exact(rec)
            assert tcsv.parse_record_exact(rec, True, True) == (
                jcsv.parse_record_exact(rec, True, True))
            assert tcsv.parse_record_fields(rec) == jcsv.parse_record_fields(rec)
            assert tcsv.clean_field(rec) == jcsv.clean_field(rec)
        assert list(tcsv.iter_dataset_exact(data)) == list(
            jcsv.iter_dataset_exact(data))
        assert list(tcsv.iter_dataset_fields(data)) == list(
            jcsv.iter_dataset_fields(data))
    for sample in ("a;b;c\n1;2;3\n", "a,b\n1,2\n", "x"):
        assert tcsv.sniff_delimiter(sample) == jcsv.sniff_delimiter(sample)


@pytest.mark.parametrize("limit", [0, 3])
def test_count_csv_writer_matches_jax(tmp_path, limit):
    entries = [("b", 2), ("a", 2), ('q"uote', 5), ("é", 2), ("Z", 2), ("x", 1)]
    assert tcsv.sort_count_entries(entries) == jcsv.sort_count_entries(entries)
    assert tcsv.format_count_row('a"b', 3) == jcsv.format_count_row('a"b', 3)
    tcsv.write_count_csv(str(tmp_path / "t.csv"), "word", entries, limit)
    jcsv.write_count_csv(str(tmp_path / "j.csv"), "word", entries, limit)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _assert_same_corpus(got, want, records: bool):
    assert got.song_count == want.song_count
    assert got.token_count == want.token_count
    np.testing.assert_array_equal(got.word_offsets, want.word_offsets)
    np.testing.assert_array_equal(got.artist_ids, want.artist_ids)
    np.testing.assert_array_equal(got.word_ids, want.word_ids)
    # Ids name the same strings through each vocab.
    assert ([got.word_vocab.tokens[i] for i in got.word_ids]
            == [want.word_vocab.tokens[i] for i in want.word_ids])
    assert got.artist_vocab.tokens == want.artist_vocab.tokens
    assert got.has_records == want.has_records == records
    if records:
        assert list(got.iter_records()) == list(want.iter_records())


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("limit", [None, 5])
@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("corpus", ["fixture", "songs_2000"])
def test_ingest_dataset_matches_jax(request, fixture_csv, backend, limit,
                                    capture, corpus):
    path = str(fixture_csv if corpus == "fixture"
               else request.getfixturevalue("songs_2000"))
    if backend == "native":
        assert tnative.available(), tnative.load_error()
        assert jnative.available(), jnative.unavailable_reason()
    got = ingest_dataset(path, limit=limit, backend=backend,
                         capture_records=capture)
    want = jax_ingest(path, limit=limit, backend=backend,
                      capture_records=capture)
    _assert_same_corpus(got, want, capture)


def test_native_and_python_backends_agree(songs_2000):
    native = ingest_dataset(str(songs_2000), backend="native",
                            capture_records=True)
    python = ingest_dataset(str(songs_2000), backend="python",
                            capture_records=True)
    _assert_same_corpus(native, python, True)


def test_native_backend_raises_when_unavailable(monkeypatch, fixture_csv):
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native ingest requested"):
        ingest_dataset(str(fixture_csv), backend="native")
    # auto parses in Python: a host path with the same ids.
    auto = ingest_dataset(str(fixture_csv), backend="auto")
    _assert_same_corpus(auto, jax_ingest(str(fixture_csv), backend="python"),
                        False)
    with pytest.raises(ValueError, match="unknown ingest backend"):
        ingest_dataset(str(fixture_csv), backend="gpu")


def test_native_record_range_and_split_match_jax(songs_2000, tmp_path):
    for n_procs in (1, 3):
        for p in range(n_procs):
            assert tnative.record_range(str(songs_2000), n_procs, p) == (
                jnative.record_range(str(songs_2000), n_procs, p))
    for mod, name in ((tnative, "t"), (jnative, "j")):
        assert mod.split_columns_native(
            str(songs_2000), str(tmp_path / f"{name}_a.csv"),
            str(tmp_path / f"{name}_t.csv"), "artist", "text")
    for col in ("a", "t"):
        assert ((tmp_path / f"t_{col}.csv").read_bytes()
                == (tmp_path / f"j_{col}.csv").read_bytes())


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corpus_cache_entries_load_across_packages(songs_2000, tmp_path,
                                                   backend, writer):
    cache = str(tmp_path / "cache")
    ingest = jax_ingest if writer == "jax" else ingest_dataset
    fresh = ingest(str(songs_2000), limit=50, backend=backend,
                   capture_records=True, cache_dir=cache)
    reader = tcache if writer == "jax" else jcache
    assert tcache.corpus_key(str(songs_2000), 50, True, backend) == (
        jcache.corpus_key(str(songs_2000), 50, True, backend))
    hit = reader.load(cache, str(songs_2000), 50, True, backend)
    assert hit is not None
    assert not hit.word_ids.flags.writeable   # mapped read-only
    _assert_same_corpus(hit, fresh, True)
    # The hit also serves the other package's ingest_dataset.
    other = ingest_dataset if writer == "jax" else jax_ingest
    before = reader.cache_stats()["hits"]
    again = other(str(songs_2000), limit=50, backend=backend,
                  capture_records=True, cache_dir=cache)
    assert reader.cache_stats()["hits"] == before + 1
    _assert_same_corpus(again, fresh, True)


def test_resolve_cache_dir_matches_jax(monkeypatch, tmp_path):
    for env in ("", "off", "0", str(tmp_path / "env")):
        monkeypatch.setenv("MUSICAAL_CORPUS_CACHE", env)
        for args in ((None, None), (str(tmp_path / "x"), None),
                     (str(tmp_path / "x"), False), (None, True)):
            assert tcache.resolve_cache_dir(*args) == (
                jcache.resolve_cache_dir(*args))
