"""The port's ``sweep`` ≡ JAX's over 1, 2 and 4 devices.

Both packages sweep ``tests/fixtures/mini_songs.csv`` and a seeded
corpus of 300 songs over device counts [1, 2, 4]: JAX on its 8-device
CPU mesh, the port as meshes of 1, 2 and 4 ranks over gloo (this process
is rank 0 and launches the others for each point, each point in a
process group of its own).  The word counts and split columns must be
byte for byte equal, each point's metrics file and the summary must have
JAX's keys and structure (times differ), with one ``per_chip`` row per
rank.  Counts given explicitly run as ranks; the default on the CPU is
one point.  A point whose rank fails, killed or exiting 1 after its
command has returned, publishes nothing of its own and ends the sweep
non-zero before the summary, and the earlier point's files stay.
"""

import json
import os
import subprocess
import sys

import pytest

from music_analyst_tpu.engines.sweep import run_sweep as jax_run_sweep
from music_analyst_tpu_torch.cli.main import main
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.engines.sweep import run_sweep
from music_analyst_tpu_torch.telemetry import configure, get_telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = [1, 2, 4]
CSVS = ("word_counts.csv", "top_artists.csv")


def _structure(value):
    if isinstance(value, dict):
        return {k: _structure(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_structure(v) for v in value]
    return type(value).__name__


def _files(out):
    names = list(CSVS) + [f"split_columns/{n}"
                          for n in sorted(os.listdir(out / "split_columns"))]
    return {n: (out / n).read_bytes() for n in names}


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    # The ranks run beside other test workers.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module", params=["fixture", "songs_300"])
def runs(request, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return _runs(request.param, tmp_path_factory)


def _runs(param, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(param)
    if param == "fixture":
        csv = os.path.join(ROOT, "tests", "fixtures", "mini_songs.csv")
    else:
        csv = str(tmp / "songs_300.csv")
        generate_dataset(csv, num_songs=300, seed=3)
    jax_out, port_out = tmp / "jax", tmp / "port"
    want = jax_run_sweep(csv, device_counts=COUNTS, output_dir=str(jax_out),
                         use_corpus_cache=False)
    configure(enabled=True)
    got = run_sweep(csv, device_counts=COUNTS, output_dir=str(port_out),
                    use_corpus_cache=False, device="cpu")
    tel = get_telemetry()
    telemetry = dict(points=tel.counters["sweep_points"],
                     spans=tel.span_aggregates["sweep_point"][0])
    return dict(want=want, got=got, jax_out=jax_out, port_out=port_out,
                telemetry=telemetry)


def test_outputs_match_jax(runs):
    jax_out, port_out, got = runs["jax_out"], runs["port_out"], runs["got"]
    assert _files(port_out) == _files(jax_out)
    for n in COUNTS:
        name = f"performance_metrics_np{n}.json"
        metrics = json.loads((port_out / name).read_text())
        jax_metrics = json.loads((jax_out / name).read_text())
        assert set(metrics) == set(jax_metrics)
        assert metrics["processes"] == jax_metrics["processes"] == n
        assert len(metrics["per_chip"]) == n
        for key in ("total_songs", "total_words"):
            assert metrics[key] == jax_metrics[key], key
    summary = json.loads((port_out / "sweep_summary.json").read_text())
    assert summary == got
    jax_summary = json.loads((jax_out / "sweep_summary.json").read_text())
    assert _structure(summary) == _structure(jax_summary)
    assert [r["devices"] for r in got["runs"]] == COUNTS
    assert [r["metrics_file"] for r in got["runs"]] == [
        f"performance_metrics_np{n}.json" for n in COUNTS]
    assert got["runs"][0]["speedup_vs_first"] == 1.0
    # Nothing of a staging directory is left beside the output.
    assert [p for p in os.listdir(port_out.parent) if "staging" in p] == []


def test_telemetry_of_the_sweep(runs):
    assert runs["telemetry"] == dict(points=3, spans=3)


def test_skips_counts_past_the_devices(fixture_csv, tmp_path, capsys):
    """Counts past the devices present are left out of the default list
    only: on the CPU it is one point, and explicit counts run as ranks."""
    summary = run_sweep(str(fixture_csv), output_dir=str(tmp_path / "d"),
                        use_corpus_cache=False, device="cpu")
    assert [r["devices"] for r in summary["runs"]] == [1]
    summary = run_sweep(str(fixture_csv), device_counts=[2],
                        output_dir=str(tmp_path / "e"),
                        use_corpus_cache=False, device="cpu")
    assert "skipping" not in capsys.readouterr().out
    assert [r["devices"] for r in summary["runs"]] == [2]
    metrics = json.loads((tmp_path / "e" / "performance_metrics_np2.json")
                         .read_text())
    assert metrics["processes"] == 2 and len(metrics["per_chip"]) == 2
    with pytest.raises(ValueError, match="must be >= 1"):
        run_sweep(str(fixture_csv), device_counts=[0],
                  output_dir=str(tmp_path / "f"), device="cpu")


def test_cli(fixture_csv, tmp_path, capsys):
    rc = main(["sweep", str(fixture_csv), "--devices", "1,2", "--device",
               "cpu", "--output-dir", str(tmp_path), "--no-corpus-cache"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "skipping" not in out
    assert "np=1: " in out and "(speedup 1.0x)" in out
    assert "np=2: " in out and "(speedup " in out.split("np=2: ")[-1]
    for n in (1, 2):
        assert (tmp_path / f"performance_metrics_np{n}.json").exists()
    assert (tmp_path / "run_manifest.json").exists()
    summary = json.loads((tmp_path / "sweep_summary.json").read_text())
    assert [r["devices"] for r in summary["runs"]] == [1, 2]


def test_cold_cache_at_a_first_point_of_four_ranks(fixture_csv, tmp_path):
    """Every rank of a cold first point ingests and stores the corpus
    cache at once: one entry is published, the later point hits it, and
    the bytes equal an uncached run's."""
    cache = tmp_path / "cache"
    run_sweep(str(fixture_csv), device_counts=[4, 2],
              output_dir=str(tmp_path / "cached"),
              corpus_cache_dir=str(cache), device="cpu")
    run_sweep(str(fixture_csv), device_counts=[1],
              output_dir=str(tmp_path / "plain"), use_corpus_cache=False,
              device="cpu")
    assert _files(tmp_path / "cached") == _files(tmp_path / "plain")
    entries = os.listdir(cache)
    assert len(entries) == 1 and ".tmp-" not in entries[0]


# The sweep with rank 1 of every point above 1 failing: killed as it
# starts, or exiting 1 once its ``analyze`` has returned.
FAILING = """
import os, signal, sys
from music_analyst_tpu_torch.engines.sweep import run_sweep
from music_analyst_tpu_torch.parallel import launch
csv, out, mode = sys.argv[1:]
RANK = {
    "killed": "import os, signal; os.kill(os.getpid(), signal.SIGKILL)",
    "late": ("import os, sys\\n"
             "from music_analyst_tpu_torch.cli.main import main\\n"
             "main(sys.argv[1:])\\n"
             "os._exit(1)\\n"),
}[mode]
launch.module_command = lambda argv: [sys.executable, "-c", RANK, *argv]
run_sweep(csv, device_counts=[1, 2], output_dir=out, use_corpus_cache=False,
          device="cpu")
"""


@pytest.mark.parametrize("mode", ["killed", "late"])
def test_failed_rank_publishes_nothing_of_its_point(mode, fixture_csv,
                                                    tmp_path):
    out = tmp_path / "out"
    run = subprocess.run(
        [sys.executable, "-c", FAILING, str(fixture_csv), str(out), mode],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert run.returncode != 0
    assert "rank 1 exited with" in run.stderr, run.stderr[-2000:]
    names = set(os.listdir(out))
    assert "performance_metrics_np2.json" not in names
    assert "sweep_summary.json" not in names
    # The first point's files were published before the second began.
    assert {"performance_metrics_np1.json", *CSVS, "split_columns"} <= names
    assert [p for p in os.listdir(tmp_path) if "staging" in p] == []


# A point's rank: the CLI, then its fault counters into a file of its rank.
COUNTING_RANK = """
import json, os, sys
from music_analyst_tpu_torch.cli.main import main
from music_analyst_tpu_torch.resilience.faults import fault_stats
stats_dir, argv = sys.argv[1], sys.argv[2:]
code = main(argv)
with open(os.path.join(stats_dir, os.environ["MUSICAAL_RANK"] + ".json"),
          "w") as fh:
    json.dump(fault_stats(), fh)
sys.exit(code)
"""


def test_faults_of_the_sweep_trip_on_its_ranks(fixture_csv, tmp_path,
                                               monkeypatch):
    """``sweep --inject-faults`` reaches every point's ranks through
    their command line, not through this process's environment."""
    from music_analyst_tpu_torch.parallel import launch
    from music_analyst_tpu_torch.resilience.faults import configure_faults

    stats = tmp_path / "stats"
    stats.mkdir()
    monkeypatch.delenv("MUSICAAL_FAULTS", raising=False)
    monkeypatch.setattr(launch, "module_command", lambda argv: [
        sys.executable, "-c", COUNTING_RANK, str(stats), *argv])
    spec = "ingest.read:delay=0s"
    try:
        rc = main(["sweep", str(fixture_csv), "--devices", "1,4", "--device",
                   "cpu", "--output-dir", str(tmp_path / "out"),
                   "--no-corpus-cache", "--inject-faults", spec])
    finally:
        configure_faults(None)
    assert rc == 0
    assert "MUSICAAL_FAULTS" not in os.environ
    assert sorted(os.listdir(stats)) == ["1.json", "2.json", "3.json"]
    for name in os.listdir(stats):
        read = json.loads((stats / name).read_text())["ingest.read"]
        assert read["trips"] == read["calls"] >= 1, (name, read)
