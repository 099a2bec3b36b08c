"""Port ``run_analysis`` / ``analyze`` ≡ the JAX engine.

Both engines run over the same CSV (the fixture, and a generated 2,000-song
CSV), the port on ``device="cpu"`` and JAX on its 8-device CPU mesh, in
every count mode and chunk size and with the row limits, ``--limit`` and
``--no-split``.  ``word_counts.csv``, ``top_artists.csv`` and
``split_columns/*`` must be byte-identical; ``performance_metrics.json``
must have the same key set at every level.  Tolerance: none.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu.engines.wordcount import run_analysis as jax_run
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.engines.wordcount import run_analysis

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("word_counts.csv", "top_artists.csv")


@pytest.fixture(scope="module")
def songs_2000(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "songs_2000.csv"
    generate_dataset(str(path), num_songs=2000, seed=3)
    return path


def _files(out):
    names = [n for n in CSVS if (out / n).exists()]
    split = out / "split_columns"
    if split.exists():
        names += [f"split_columns/{n}" for n in sorted(os.listdir(split))]
    return {n: (out / n).read_bytes() for n in names}


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_key_tree(v) for v in value[:1]]
    return None


def _assert_same_outputs(port_out, jax_out, split=True):
    got, want = _files(port_out), _files(jax_out)
    assert set(got) == set(want)
    assert set(CSVS) <= set(got)
    assert any(n.startswith("split_columns/") for n in got) == split
    for name in want:
        assert got[name] == want[name], name
    pm = json.loads((port_out / "performance_metrics.json").read_text())
    jm = json.loads((jax_out / "performance_metrics.json").read_text())
    assert _key_tree(pm) == _key_tree(jm)
    return pm


CASES = {
    "default": {},
    "host-shard-chunk0": dict(count_mode="host-shard", chunk_songs=0),
    "device-ids": dict(count_mode="device-ids"),
    "device-ids-chunk0": dict(count_mode="device-ids", chunk_songs=0),
    "chunk3": dict(chunk_songs=3),
    "chunk-auto": dict(chunk_songs="auto"),
    "limits": dict(word_limit=5, artist_limit=2),
    "limit4": dict(limit=4),
    "no-split": dict(write_split=False),
    "python-ingest": dict(ingest_backend="python"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("corpus", ["fixture", "songs_2000"])
def test_artifacts_match_jax(request, fixture_csv, tmp_path, case, corpus):
    path = str(fixture_csv if corpus == "fixture"
               else request.getfixturevalue("songs_2000"))
    kwargs = dict(CASES[case], quiet=True, use_corpus_cache=False)
    want = jax_run(path, output_dir=str(tmp_path / "jax"), **kwargs)
    got = run_analysis(path, output_dir=str(tmp_path / "port"),
                       device="cpu", **kwargs)
    pm = _assert_same_outputs(tmp_path / "port", tmp_path / "jax",
                              split=kwargs.get("write_split", True))
    assert (got.total_songs, got.total_words) == (
        want.total_songs, want.total_words)
    assert got.word_entries == want.word_entries
    assert got.artist_entries == want.artist_entries
    assert pm["processes"] == 1 and pm["device_platform"] == "cpu"
    assert pm["per_chip"] == [{
        "device": "cpu", "platform": "cpu",
        "compute_seconds": round(got.per_chip_compute[0], 9)}]
    assert set(pm["stages"]) == {"split", "ingest", "device_compute",
                                 "aggregate_export"}


def test_warm_corpus_cache_is_byte_identical(fixture_csv, tmp_path):
    cache = str(tmp_path / "cache")
    for run in ("cold", "warm"):
        run_analysis(str(fixture_csv), output_dir=str(tmp_path / run),
                     corpus_cache_dir=cache, quiet=True, device="cpu")
    jax_run(str(fixture_csv), output_dir=str(tmp_path / "jax"),
            corpus_cache_dir=cache, quiet=True)
    assert _files(tmp_path / "warm") == _files(tmp_path / "cold") == (
        _files(tmp_path / "jax"))


def test_cli_matches_jax_cli(songs_2000, tmp_path):
    args = ["analyze", str(songs_2000), "--chunk-songs", "64",
            "--word-limit", "40", "--no-corpus-cache"]
    jax_main(args + ["--output-dir", str(tmp_path / "jax")])
    assert port_main(args + ["--device", "cpu", "--output-dir",
                             str(tmp_path / "port"), "--no-telemetry",
                             "--devices", "1"]) == 0
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")


def test_module_cli_prints_the_fixture_report(fixture_csv, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", "analyze",
         str(fixture_csv), "--device", "cpu", "--output-dir", str(tmp_path),
         "--no-corpus-cache"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "Total songs processed: 7" in lines
    assert "Total words counted: 52" in lines
    assert lines[lines.index("Top 10 words:") + 1] == "  love: 5"


def test_analyze_without_device_raises_without_a_card(monkeypatch,
                                                      fixture_csv, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--with-sentiment", "--mock"]):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            port_main(["analyze", str(fixture_csv), "--output-dir",
                       str(tmp_path), *extra])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_analysis(str(fixture_csv), output_dir=str(tmp_path))
    assert not (tmp_path / "word_counts.csv").exists()


@pytest.mark.parametrize("flags,message", [
    (["--devices", "2"], "not yet ported"),
    (["--trace-dir", "t"], "not yet ported"),
    (["--watchdog-timeout", "3"], "not yet ported"),
])
def test_analyze_refuses_unported_flag_values(fixture_csv, tmp_path, capsys,
                                              flags, message):
    with pytest.raises(SystemExit) as exc:
        port_main(["analyze", str(fixture_csv), "--device", "cpu",
                   "--output-dir", str(tmp_path), *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
