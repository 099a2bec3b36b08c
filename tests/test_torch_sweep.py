"""The port's ``sweep`` ≡ JAX's at one device, on the fixture CSV.

Both packages sweep ``tests/fixtures/mini_songs.csv`` over device counts
[1, 2, ...] with only one device to give: the word counts must be byte
for byte equal, the per-point metrics file and the summary must have the
same keys and structure (times differ), and counts past the devices
present are skipped with the same line.
"""

import json

import pytest

from music_analyst_tpu.engines.sweep import run_sweep as jax_run_sweep
from music_analyst_tpu_torch.cli.main import main
from music_analyst_tpu_torch.engines.sweep import run_sweep
from music_analyst_tpu_torch.telemetry import configure, get_telemetry


def _structure(value):
    if isinstance(value, dict):
        return {k: _structure(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_structure(v) for v in value]
    return type(value).__name__


@pytest.fixture
def runs(fixture_csv, tmp_path):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    want = jax_run_sweep(str(fixture_csv), device_counts=[1],
                         output_dir=str(jax_out), use_corpus_cache=False)
    configure(enabled=True)
    got = run_sweep(str(fixture_csv), device_counts=[1],
                    output_dir=str(port_out), use_corpus_cache=False,
                    device="cpu")
    return want, got, jax_out, port_out


def test_outputs_match_jax(runs):
    want, got, jax_out, port_out = runs
    assert ((port_out / "word_counts.csv").read_bytes()
            == (jax_out / "word_counts.csv").read_bytes())
    assert ((port_out / "top_artists.csv").read_bytes()
            == (jax_out / "top_artists.csv").read_bytes())
    metrics = json.loads((port_out / "performance_metrics_np1.json")
                         .read_text())
    jax_metrics = json.loads((jax_out / "performance_metrics_np1.json")
                             .read_text())
    assert set(metrics) == set(jax_metrics)
    assert metrics["processes"] == jax_metrics["processes"] == 1
    for key in ("total_songs", "total_words"):
        assert metrics[key] == jax_metrics[key], key
    summary = json.loads((port_out / "sweep_summary.json").read_text())
    assert summary == got
    assert _structure(summary) == _structure(
        json.loads((jax_out / "sweep_summary.json").read_text()))
    assert [r["devices"] for r in got["runs"]] == [1]
    assert got["runs"][0]["metrics_file"] == "performance_metrics_np1.json"
    assert got["runs"][0]["speedup_vs_first"] == 1.0


def test_telemetry_of_the_sweep(runs):
    tel = get_telemetry()
    assert tel.counters["sweep_points"] == 1
    assert tel.span_aggregates["sweep_point"][0] == 1


def test_skips_counts_past_the_devices(fixture_csv, tmp_path, capsys):
    summary = run_sweep(str(fixture_csv), device_counts=[1, 2, 8],
                        output_dir=str(tmp_path), use_corpus_cache=False,
                        device="cpu")
    out = capsys.readouterr().out
    assert "skipping np=2: only 1 devices" in out
    assert "skipping np=8: only 1 devices" in out
    assert [r["devices"] for r in summary["runs"]] == [1]
    # Default counts on the CPU: one point.
    summary = run_sweep(str(fixture_csv), output_dir=str(tmp_path / "d"),
                        use_corpus_cache=False, device="cpu")
    assert [r["devices"] for r in summary["runs"]] == [1]


def test_cli(fixture_csv, tmp_path, capsys):
    rc = main(["sweep", str(fixture_csv), "--devices", "1,2", "--device",
               "cpu", "--output-dir", str(tmp_path), "--no-corpus-cache"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "skipping np=2: only 1 devices" in out
    assert "np=1: " in out and "(speedup 1.0x)" in out
    assert (tmp_path / "performance_metrics_np1.json").exists()
    assert (tmp_path / "run_manifest.json").exists()
