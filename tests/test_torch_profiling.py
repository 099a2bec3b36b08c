"""The port's profiling layer: ``--profile-dir`` / ``--trace-dir`` through
``torch.profiler``, the span Chrome trace, and the ``profile-diff`` gate.

Counterpart of ``tests/test_profiling.py`` (its ``profiled_jit`` and
collective cases test JAX-only modules the port does not take).  On the
CPU the profiler records the CPU activity only; the CUDA activity and the
kernels' names in a device trace are checked on the card by
``chip_smoke.py``.  ``profile-diff`` must give the same exit code in both
packages on the same pair of inputs.
"""

import json

import numpy as np
import pytest
import torch

from music_analyst_tpu.profiling.diff import (
    run_profile_diff as jax_profile_diff,
)
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.profiling import trace as port_trace
from music_analyst_tpu_torch.profiling.diff import run_profile_diff
from music_analyst_tpu_torch.telemetry import configure, get_telemetry


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    yield configure(enabled=True, directory=None)
    configure(enabled=True, directory=None)


# ------------------------------------------------------------ traces


def test_profile_run_writes_chrome_trace(tmp_path):
    tel = get_telemetry()
    with port_trace.profile_run(str(tmp_path / "prof"), device="cpu"):
        with tel.span("unit_test_stage", rows=7):
            pass
    trace = json.loads((tmp_path / "prof" / "trace_spans.json").read_text())
    events = trace["traceEvents"]
    (span_event,) = [e for e in events if e["name"] == "unit_test_stage"]
    assert span_event["ph"] == "X" and span_event["dur"] >= 0
    assert span_event["args"]["rows"] == "7"
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in events)
    assert (tmp_path / "prof" / port_trace.DEVICE_TRACE_FILE).exists()


def test_maybe_trace_and_annotate_record_a_named_region(tmp_path):
    with port_trace.maybe_trace(str(tmp_path), device="cpu"):
        with port_trace.annotate("wordcount.word_histogram"):
            torch.ones(4).add_(1)
    trace = json.loads(
        (tmp_path / port_trace.DEVICE_TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "wordcount.word_histogram" in names


def test_maybe_trace_off_is_inert(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with port_trace.maybe_trace(None):
        pass
    assert list(tmp_path.iterdir()) == []


def test_force_readback_materializes_on_the_host():
    got = port_trace.force_readback(torch.arange(5))
    assert isinstance(got, np.ndarray) and got.tolist() == [0, 1, 2, 3, 4]
    assert port_trace.force_readback([1, 2]).tolist() == [1, 2]


def test_profiler_that_fails_to_start_is_recorded(tmp_path, monkeypatch):
    """A refusing profiler is recorded in the manifest's ``profiling``
    section; the run still completes, and the span trace still lands."""
    def refuse(device):
        raise RuntimeError("profiler refused to start")

    monkeypatch.setattr(port_trace, "_start_profiler", refuse)
    tel = get_telemetry()
    with port_trace.profile_run(str(tmp_path / "prof"), device="cpu"):
        with tel.run_scope("probe", str(tmp_path / "run")):
            tel.count("rows", 1)
    manifest = json.loads((tmp_path / "run" / "run_manifest.json").read_text())
    assert manifest["profiling"]["profiler"] == {
        "status": "unavailable", "error": "profiler refused to start"}
    assert manifest["counters"] == {"rows": 1}
    assert (tmp_path / "prof" / "trace_spans.json").exists()
    assert port_trace.profiler_status() is None


def test_manifest_profiling_section(tmp_path):
    tel = get_telemetry()
    with port_trace.profile_run(str(tmp_path / "prof"), device="cpu"):
        with tel.run_scope("x", str(tmp_path / "run")):
            pass
    manifest = json.loads((tmp_path / "run" / "run_manifest.json").read_text())
    section = manifest["profiling"]
    assert section["scope"] == "process" and section["compiles"] == []
    assert set(section["kernel_builds"]) >= {"count", "seconds"}
    assert section["profiler"]["status"] == "recording"
    assert section["profiler"]["activities"] == ["CPU"]


def test_cli_profile_dir_flag(fixture_csv, tmp_path, capsys):
    prof = tmp_path / "prof"
    assert port_main(["analyze", str(fixture_csv), "--device", "cpu",
                      "--output-dir", str(tmp_path / "out"), "--ingest",
                      "python", "--profile-dir", str(prof)]) == 0
    capsys.readouterr()
    assert (prof / "trace_spans.json").exists()
    assert (prof / port_trace.DEVICE_TRACE_FILE).exists()


def test_cli_trace_dir_and_profile_dir_are_exclusive(fixture_csv, tmp_path,
                                                     capsys):
    with pytest.raises(SystemExit) as exc:
        port_main(["sentiment", str(fixture_csv), "--mock", "--device", "cpu",
                   "--output-dir", str(tmp_path), "--trace-dir",
                   str(tmp_path / "t"), "--profile-dir", str(tmp_path / "p")])
    assert exc.value.code == 2
    assert "give one of them" in capsys.readouterr().err


def test_word_counts_byte_identical_with_profiling(fixture_csv, tmp_path,
                                                   capsys):
    base = ["analyze", str(fixture_csv), "--device", "cpu", "--ingest",
            "python"]
    assert port_main(base + ["--output-dir", str(tmp_path / "plain"),
                             "--no-telemetry"]) == 0
    configure(enabled=True, directory=None)
    assert port_main(base + ["--output-dir", str(tmp_path / "profiled"),
                             "--profile-dir", str(tmp_path / "prof")]) == 0
    capsys.readouterr()
    assert ((tmp_path / "plain" / "word_counts.csv").read_bytes()
            == (tmp_path / "profiled" / "word_counts.csv").read_bytes())


# --------------------------------------------------- profile-diff gate


def _bench_line(value, metric="sentiment_songs_per_sec_distilbert"):
    return {"metric": metric, "value": value, "unit": "songs/sec"}


def _write(tmp_path, name, payload):
    path = tmp_path / name
    path.write_text(json.dumps(payload))
    return str(path)


def test_profile_diff_detects_20pct_regression(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _bench_line(1000.0))
    b = _write(tmp_path, "b.json", _bench_line(800.0))
    assert run_profile_diff(a, b) == 1
    assert "REGRESSION" in capsys.readouterr().out


def test_profile_diff_passes_within_threshold(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _bench_line(1000.0))
    b = _write(tmp_path, "b.json", _bench_line(950.0))
    assert run_profile_diff(a, b) == 0
    assert "verdict: ok" in capsys.readouterr().out


def test_profile_diff_threshold_flag(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _bench_line(1000.0))
    b = _write(tmp_path, "b.json", _bench_line(950.0))
    assert run_profile_diff(a, b, threshold=0.02) == 1
    capsys.readouterr()


def test_profile_diff_manifest_wall_regression(tmp_path, capsys):
    a = _write(tmp_path, "a.json", {"schema": 1, "wall_seconds": 10.0})
    b = _write(tmp_path, "b.json", {"schema": 1, "wall_seconds": 14.0})
    assert run_profile_diff(a, b) == 1
    capsys.readouterr()


def test_profile_diff_bad_input_exits_2(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _bench_line(1000.0))
    assert run_profile_diff(a, "not json at all") == 2
    capsys.readouterr()


def test_profile_diff_cli_subcommand(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _bench_line(1000.0))
    b = _write(tmp_path, "b.json", _bench_line(790.0))
    assert port_main(["profile-diff", a, b]) == 1
    assert port_main(["profile-diff", a, a]) == 0
    assert port_main(["profile-diff", a, b, "--threshold", "0.5"]) == 0
    capsys.readouterr()


@pytest.fixture(scope="module")
def manifests(tmp_path_factory, fixture_csv):
    """One port run manifest and one JAX run manifest of ``analyze`` on
    the fixture."""
    from music_analyst_tpu.cli.main import main as jax_main

    base = tmp_path_factory.mktemp("manifests")
    args = ["analyze", str(fixture_csv), "--ingest", "python",
            "--no-corpus-cache", "--no-split"]
    assert port_main(args + ["--device", "cpu", "--output-dir",
                             str(base / "port")]) == 0
    assert jax_main(args + ["--output-dir", str(base / "jax")]) == 0
    configure(enabled=True, directory=None)
    return {name: json.loads((base / name / "run_manifest.json").read_text())
            for name in ("port", "jax")}


_DIFF_CASES = {
    "bench_regression": (_bench_line(1000.0), _bench_line(800.0)),
    "bench_ok": (_bench_line(1000.0), _bench_line(990.0)),
    "metric_mismatch": (_bench_line(1.0), _bench_line(1.0, metric="other")),
    "kind_mismatch": (_bench_line(1.0), "port"),
    "port_vs_itself": ("port", "port"),
    "port_wall_doubled": ("port", ("port", 2.0)),
    "jax_vs_port_wall_doubled": (("jax", 1.0), ("port", 2.0)),
    "unusable": ({"neither": 1}, "port"),
}


@pytest.mark.parametrize("case", sorted(_DIFF_CASES))
def test_profile_diff_exit_codes_match_jax(manifests, tmp_path, capsys, case):
    """Each package's profile-diff gives the same exit code on the same
    pair; the manifests are the packages' own (walls set so the verdict
    does not hang on run-to-run noise)."""
    def materialize(spec, name):
        if spec in ("port", "jax"):
            spec = (spec, None)
        if isinstance(spec, tuple):
            which, wall = spec
            payload = dict(manifests[which])
            if wall is not None:
                payload["wall_seconds"] = wall
            spec = payload
        return _write(tmp_path, name, spec)

    a_spec, b_spec = _DIFF_CASES[case]
    a, b = materialize(a_spec, "a.json"), materialize(b_spec, "b.json")
    rc = run_profile_diff(a, b)
    assert rc == jax_profile_diff(a, b)
    capsys.readouterr()
    expected = {"bench_regression": 1, "bench_ok": 0, "metric_mismatch": 2,
                "kind_mismatch": 2, "port_vs_itself": 0,
                "port_wall_doubled": 1, "jax_vs_port_wall_doubled": 1,
                "unusable": 2}
    assert rc == expected[case]
