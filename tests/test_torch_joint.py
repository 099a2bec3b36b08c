"""Port ``run_joint`` (``analyze --with-sentiment``) ≡ the JAX pipeline.

Both run ``--mock`` sentiment over one parse of the same CSV (the fixture,
and a generated 600-song CSV), the port on ``device="cpu"``.  The word and
artist CSVs and ``sentiment_totals.json`` must be byte-identical, the
details equal on ``artist,song,label`` (``latency_seconds`` is measured),
``performance_metrics.json`` equal in its key set, and one song count must
hold across every artifact.  Tolerance: none.
"""

import csv
import json

import pytest
import torch

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu.engines.joint import run_joint as jax_joint
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.engines import joint as tj
from music_analyst_tpu_torch.engines.joint import run_joint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def songs_600(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "songs_600.csv"
    generate_dataset(str(path), num_songs=600, seed=9)
    return path


def _details(out):
    with open(out / "sentiment_details.csv", newline="", encoding="utf-8") as fh:
        return [(r["artist"], r["song"], r["label"]) for r in csv.DictReader(fh)]


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_key_tree(v) for v in value[:1]]
    return None


def _assert_same(port_out, jax_out):
    for name in ("word_counts.csv", "top_artists.csv", "sentiment_totals.json",
                 "split_columns/artist.csv", "split_columns/text.csv"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes()
    assert _details(port_out) == _details(jax_out)
    pm = json.loads((port_out / "performance_metrics.json").read_text())
    jm = json.loads((jax_out / "performance_metrics.json").read_text())
    assert _key_tree(pm) == _key_tree(jm)
    assert set(pm["stages"]) == set(jm["stages"]) == {
        "split", "ingest", "device_compute", "aggregate_export", "sentiment"}
    songs = pm["total_songs"]
    assert songs == jm["total_songs"] == len(_details(port_out))
    assert sum(json.loads(
        (port_out / "sentiment_totals.json").read_text()).values()) == songs
    return pm


@pytest.mark.parametrize("kwargs", [
    {}, dict(chunk_songs=5, batch_size=7), dict(limit=4, word_limit=3),
], ids=["default", "chunk5-batch7", "limits"])
@pytest.mark.parametrize("corpus", ["fixture", "songs_600"])
def test_run_joint_matches_jax(request, fixture_csv, tmp_path, kwargs, corpus):
    path = str(fixture_csv if corpus == "fixture"
               else request.getfixturevalue("songs_600"))
    kwargs = dict(kwargs, mock=True, quiet=True, use_corpus_cache=False)
    want = jax_joint(path, output_dir=str(tmp_path / "jax"), **kwargs)
    got = run_joint(path, output_dir=str(tmp_path / "port"), device="cpu",
                    **kwargs)
    pm = _assert_same(tmp_path / "port", tmp_path / "jax")
    assert got.sentiment.counts == want.sentiment.counts
    assert [r.label for r in got.sentiment.rows] == [
        r.label for r in want.sentiment.rows]
    assert pm["device_platform"] == "cpu" and pm["processes"] == 1
    assert got.songs_per_second > 0


def test_joint_cli_matches_jax_cli(fixture_csv, tmp_path, capsys):
    args = ["analyze", str(fixture_csv), "--with-sentiment", "--mock",
            "--no-corpus-cache"]
    jax_main(args + ["--output-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    assert port_main(args + ["--device", "cpu", "--output-dir",
                             str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "Total songs processed: 7" in out
    assert "Joint pipeline: 7 songs" in out
    _assert_same(tmp_path / "port", tmp_path / "jax")


def test_joint_reads_the_dataset_once(fixture_csv, tmp_path, monkeypatch):
    calls = []
    real = tj.ingest_dataset

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tj, "ingest_dataset", counting)
    run_joint(str(fixture_csv), output_dir=str(tmp_path), mock=True,
              quiet=True, device="cpu", use_corpus_cache=False)
    assert len(calls) == 1 and calls[0]["capture_records"] is True


def test_joint_refuses_inconsistent_song_counts(fixture_csv, tmp_path,
                                                monkeypatch):
    real = tj.run_sentiment

    def drops_one(*args, songs, **kwargs):
        rows = list(songs)[:-1]
        return real(*args, songs=iter(rows), **kwargs)

    monkeypatch.setattr(tj, "run_sentiment", drops_one)
    with pytest.raises(RuntimeError, match="inconsistent song counts"):
        run_joint(str(fixture_csv), output_dir=str(tmp_path), mock=True,
                  quiet=True, device="cpu", use_corpus_cache=False)
