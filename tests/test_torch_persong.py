"""Port ``wordcount-per-song`` ≡ the JAX package's, byte for byte.

Both engines run on the same CSVs: the mini fixture (quoted commas,
embedded newlines, accents, a short row) and a generated CSV with
accented and apostrophe tokens, written comma- and semicolon-separated
(delimiter sniffing) and read with several worker counts and small chunk
sizes.  ``word_counts_by_song.csv`` and ``word_counts_global.csv`` must
be byte-identical to JAX's.  Tolerance: none (exact).
"""

import csv

import numpy as np
import pytest

from music_analyst_tpu.engines.persong import (
    run_per_song_wordcount as jax_persong,
)
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.engines.persong import (
    _DenseHistogram,
    run_per_song_wordcount,
)
from music_analyst_tpu_torch.runtime import PrefetchPipeline, Stage

FILES = ("word_counts_by_song.csv", "word_counts_global.csv")
WORDS = ["love", "Love", "rain", "café", "naïve", "don't", "''", "ÀÉÎ",
         "sunshine", "la", "it's", "broken", "héart", "x1y2", "12345", "ok"]


def _generated(path, n=300, delimiter=","):
    rng = np.random.default_rng(31)
    with open(path, "w", encoding="utf-8", newline="") as fh:
        # Every field quoted, as in the reference dataset.
        w = csv.writer(fh, delimiter=delimiter, quoting=csv.QUOTE_ALL)
        w.writerow(["artist", "song", "link", "text"])
        for i in range(n):
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(0, 30))))
            if i % 17 == 0:
                text += "\nsecond, line; here"
            w.writerow([f"Artist {i % 23}", f"Song {i}", f"/l/{i}", text])


def _bytes(out):
    return {name: (out / name).read_bytes() for name in FILES}


def _both(tmp_path, src, **kw):
    jax_persong(str(src), output_dir=str(tmp_path / "jax"), quiet=True, **kw)
    g, p, rows = run_per_song_wordcount(str(src), output_dir=str(
        tmp_path / "port"), quiet=True, **kw)
    assert (g.name, p.name) == (FILES[1], FILES[0])
    return _bytes(tmp_path / "jax"), _bytes(tmp_path / "port"), rows


@pytest.mark.parametrize("workers,chunk_rows", [(1, 512), (3, 2), (4, 1)])
def test_fixture_matches_jax(fixture_csv, tmp_path, workers, chunk_rows):
    want, got, rows = _both(tmp_path, fixture_csv, workers=workers,
                            chunk_rows=chunk_rows)
    assert got == want
    assert rows == 8


@pytest.mark.parametrize("delimiter", [",", ";"])
@pytest.mark.parametrize("workers,chunk_rows", [(0, 512), (2, 7)])
def test_generated_csv_matches_jax(tmp_path, delimiter, workers, chunk_rows):
    src = tmp_path / "songs.csv"
    _generated(src, delimiter=delimiter)
    want, got, rows = _both(tmp_path, src, workers=workers,
                            chunk_rows=chunk_rows)
    assert got == want
    assert rows == 300
    # Explicit delimiter gives the same files as sniffing.
    run_per_song_wordcount(str(src), output_dir=str(tmp_path / "explicit"),
                           quiet=True, delimiter=delimiter)
    assert _bytes(tmp_path / "explicit") == got


def test_global_ranking_is_count_desc_first_seen_ties(tmp_path):
    src = tmp_path / "songs.csv"
    _generated(src)
    run_per_song_wordcount(str(src), output_dir=str(tmp_path), quiet=True)
    with open(tmp_path / FILES[1], newline="", encoding="utf-8") as fh:
        ranked = [(w, int(c)) for w, c in list(csv.reader(fh))[1:]]
    counts = [c for _, c in ranked]
    assert counts == sorted(counts, reverse=True)
    with open(tmp_path / FILES[0], newline="", encoding="utf-8") as fh:
        per_song = list(csv.reader(fh))[1:]
    assert sum(int(r[3]) for r in per_song) == sum(counts)
    first_seen = list(dict.fromkeys(r[2] for r in per_song))
    order = {w: i for i, w in enumerate(first_seen)}
    for (w1, c1), (w2, c2) in zip(ranked, ranked[1:]):
        if c1 == c2:
            assert order[w1] < order[w2]


def test_dense_histogram():
    h = _DenseHistogram()
    for word, n in (("b", 2), ("a", 3), ("b", 1), ("c", 3)):
        h.add(word, n)
    assert list(h.ranked()) == [("b", 3), ("a", 3), ("c", 3)]
    assert h.total == 9


def test_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("artist,song\nA,B\n", encoding="utf-8")
    with pytest.raises(ValueError, match="missing expected columns"):
        run_per_song_wordcount(str(bad), output_dir=str(tmp_path), quiet=True)
    with pytest.raises(FileNotFoundError):
        run_per_song_wordcount(str(tmp_path / "nope.csv"), quiet=True)
    with pytest.raises(ValueError, match="chunk_rows"):
        run_per_song_wordcount(str(bad), output_dir=str(tmp_path),
                               quiet=True, chunk_rows=0)


def test_cli_matches_jax_cli(fixture_csv, tmp_path, monkeypatch):
    from music_analyst_tpu.cli.main import main as jax_main

    assert jax_main(["wordcount-per-song", str(fixture_csv), "--output-dir",
                     str(tmp_path / "jax"), "--workers", "2",
                     "--chunk-rows", "3", "--no-telemetry"]) == 0
    assert port_main(["wordcount-per-song", str(fixture_csv), "--output-dir",
                      str(tmp_path / "port"), "--workers", "2",
                      "--chunk-rows", "3", "--no-telemetry",
                      "--device", "cpu"]) == 0
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "jax")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_main(["wordcount-per-song", str(fixture_csv), "--output-dir",
                   str(tmp_path / "x")])


def test_multi_worker_stage_keeps_order_and_raises():
    pipe = PrefetchPipeline([Stage("sq", lambda x: x * x, workers=4)],
                            depth=2)
    assert list(pipe.run(range(50))) == [x * x for x in range(50)]

    def boom(x):
        if x == 7:
            raise KeyError("seven")
        return x

    with pytest.raises(KeyError):
        list(PrefetchPipeline([Stage("b", boom, workers=3)]).run(range(20)))
    with pytest.raises(ValueError, match="workers"):
        PrefetchPipeline([Stage("z", boom, workers=0)])
