"""The rank launcher's staged publish (``parallel/launch.py``).

Rank 0 writes into a staging directory beside the output directory, and
``run_ranks`` moves its files into place only once rank 0's command has
returned 0 and every other rank has exited 0.  Through the launcher core
(a child command that joins, runs the last collective, leaves the group
and then exits with a given code) and through the CLI (``analyze`` and
``sentiment --model distilbert-tiny`` with ``--devices 2`` whose rank 1
exits 1 once its command has returned): a failed rank makes the command
exit non-zero, publishes nothing, leaves no staging directory, and leaves
a file that was in the output directory beforehand as it was.  Each
command runs as a process, since a failed mesh ends its rank 0 with
``os._exit``.
"""

import os
import subprocess
import sys

import pytest

from music_analyst_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEFORE = b"written before the command\n"

# Rank 1 of the core test: the last collective, then leave and exit.
CHILD = """
import os, sys, time
from music_analyst_tpu_torch.parallel import multihost
multihost.join_from_env()
multihost.barrier()
multihost.shutdown()
time.sleep(0.5)  # rank 0 has returned from its command by now
os._exit(int(sys.argv[1]))
"""

# Rank 0 of the core test: the output file, the same collective, and
# then ``raise`` makes rank 0's own command fail after it.
CORE = """
import os, sys
from music_analyst_tpu_torch.parallel import launch, multihost
out, child_code, mode = sys.argv[1], sys.argv[2], sys.argv[3]
staging = launch.Staging(out)

def body():
    with open(os.path.join(staging.path, "result.txt"), "w") as fh:
        fh.write("rank 0\\n")
    os.makedirs(os.path.join(staging.path, "sub"))
    with open(os.path.join(staging.path, "sub", "part.txt"), "w") as fh:
        fh.write("part\\n")
    multihost.barrier()
    if mode == "raise":
        raise RuntimeError("rank 0 failed after its last collective")
    return 0

sys.exit(launch.run_ranks([sys.executable, "-c", CHILD, child_code], 2,
                          "cpu", body, timeout_s=120, staging=staging))
"""

# The CLI with rank 1 exiting 1 once its command has returned.
LATE_RANK = ("import os, sys\n"
             "from music_analyst_tpu_torch.cli.main import main\n"
             "main(sys.argv[1:])\n"
             "os._exit(1)\n")
CLI = """
import sys
from music_analyst_tpu_torch.cli.main import main
from music_analyst_tpu_torch.parallel import launch
launch.module_command = (
    lambda argv: [sys.executable, "-c", LATE_RANK, *argv])
sys.exit(main(sys.argv[1:]))
"""


def _python(script, args, timeout=240):
    return subprocess.run(
        [sys.executable, "-c", script, *map(str, args)], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=timeout)


def _prepared(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    (out / "before.txt").write_bytes(BEFORE)
    return out


def _staging_left(out):
    return [p.name for p in out.parent.iterdir()
            if launch.STAGING_INFIX in p.name]


@pytest.mark.parametrize("child_code,mode", [
    (0, "return"), (1, "return"), (0, "raise")],
    ids=["all_ranks_ok", "rank_1_exits_1_late", "rank_0_raises_late"])
def test_core_publishes_only_when_every_rank_succeeds(child_code, mode,
                                                      tmp_path):
    out = _prepared(tmp_path)
    script = f"CHILD = {CHILD!r}\n{CORE}"
    run = _python(script, [out, child_code, mode])
    assert (out / "before.txt").read_bytes() == BEFORE
    assert _staging_left(out) == []
    if child_code == 0 and mode == "return":
        assert run.returncode == 0, run.stderr[-2000:]
        assert (out / "result.txt").read_text() == "rank 0\n"
        assert (out / "sub" / "part.txt").read_text() == "part\n"
        return
    assert run.returncode != 0
    assert sorted(os.listdir(out)) == ["before.txt"], run.stderr[-2000:]
    if child_code:
        assert "rank 1 exited with 1" in run.stderr
        assert "nothing published" in run.stderr


@pytest.mark.parametrize("command,flags", [
    ("analyze", []),
    ("sentiment", ["--model", "distilbert-tiny"]),
])
def test_cli_rank_failing_after_its_command_publishes_nothing(
        command, flags, fixture_csv, tmp_path):
    out = _prepared(tmp_path)
    script = f"LATE_RANK = {LATE_RANK!r}\n{CLI}"
    run = _python(script, [command, fixture_csv, "--device", "cpu",
                           "--devices", "2", "--output-dir", out, *flags])
    assert run.returncode != 0
    assert "mesh: 2 ranks over gloo" in run.stderr
    assert "rank 1 exited with 1" in run.stderr, run.stderr[-2000:]
    assert sorted(os.listdir(out)) == ["before.txt"]
    assert (out / "before.txt").read_bytes() == BEFORE
    assert _staging_left(out) == []


def test_cli_publishes_beside_earlier_files_and_continues_the_log(
        fixture_csv, tmp_path):
    """A mesh run that succeeds publishes its files among the earlier
    ones, appends to the earlier telemetry log, and its manifest names
    the published log, not the staging directory's."""
    import json

    out = _prepared(tmp_path)
    (out / "telemetry.jsonl").write_text('{"event": "earlier run"}\n')
    run = _python("import sys\n"
                  "from music_analyst_tpu_torch.cli.main import main\n"
                  "sys.exit(main(sys.argv[1:]))\n",
                  ["analyze", fixture_csv, "--device", "cpu", "--devices",
                   "2", "--output-dir", out])
    assert run.returncode == 0, run.stderr[-2000:]
    assert (out / "before.txt").read_bytes() == BEFORE
    log = (out / "telemetry.jsonl").read_text().splitlines()
    assert log[0] == '{"event": "earlier run"}' and len(log) > 1
    manifest = json.loads((out / "run_manifest.json").read_text())
    assert manifest["telemetry_log"] == str(out / "telemetry.jsonl")
    assert {"word_counts.csv", "top_artists.csv", "split_columns",
            "performance_metrics.json"} <= set(os.listdir(out))
    assert _staging_left(out) == []


def _labels(path):
    import csv

    with open(path, newline="", encoding="utf-8") as fh:
        return [(r["artist"], r["song"], r["label"])
                for r in csv.DictReader(fh)]


def test_failed_mesh_sentiment_leaves_the_published_prefix_to_resume(
        fixture_csv, tmp_path):
    """Under ``--devices N`` the details stream into the staging
    directory: a run whose rank fails leaves the output directory's
    details file as it was, so ``--resume`` continues from the last
    published prefix, and what the failed run classified is lost."""
    flags = ["sentiment", fixture_csv, "--model", "distilbert-tiny",
             "--device", "cpu", "--devices", "2"]
    cli = ("import sys\n"
           "from music_analyst_tpu_torch.cli.main import main\n"
           "sys.exit(main(sys.argv[1:]))\n")
    whole = tmp_path / "whole"
    run = _python(cli, [*flags, "--output-dir", whole])
    assert run.returncode == 0, run.stderr[-2000:]
    lines = (whole / "sentiment_details.csv").read_bytes().splitlines(True)
    out = tmp_path / "out"
    out.mkdir()
    prefix = b"".join(lines[:3])              # the header and two rows
    (out / "sentiment_details.csv").write_bytes(prefix)
    run = _python(f"LATE_RANK = {LATE_RANK!r}\n{CLI}",
                  [*flags, "--resume", "--output-dir", out])
    assert run.returncode != 0
    assert "rank 1 exited with 1" in run.stderr, run.stderr[-2000:]
    assert (out / "sentiment_details.csv").read_bytes() == prefix
    assert sorted(os.listdir(out)) == ["sentiment_details.csv"]
    assert _staging_left(out) == []
    run = _python(cli, [*flags, "--resume", "--output-dir", out])
    assert run.returncode == 0, run.stderr[-2000:]
    details = (out / "sentiment_details.csv").read_bytes()
    assert details.startswith(prefix)
    assert _labels(out / "sentiment_details.csv") == _labels(
        whole / "sentiment_details.csv")


def test_staging_maps_paths_and_carries_appended_files(tmp_path):
    out = tmp_path / "out"
    (out / "tel").mkdir(parents=True)
    (out / "tel" / "telemetry.jsonl").write_text('{"event": 1}\n')
    staging = launch.Staging(str(out), carry=[
        str(out / "tel" / "telemetry.jsonl"),
        str(out / "missing.csv"), str(tmp_path / "elsewhere.jsonl")])
    assert os.path.dirname(staging.path) == str(tmp_path)
    staged_log = staging.staged(str(out / "tel" / "telemetry.jsonl"))
    assert staged_log == os.path.join(staging.path, "tel", "telemetry.jsonl")
    assert staging.staged(str(tmp_path / "prof")) == str(tmp_path / "prof")
    assert staging.published(staged_log) == str(out / "tel" /
                                                "telemetry.jsonl")
    with open(staged_log, "a") as fh:
        fh.write('{"event": 2}\n')
    # The original is untouched until the publish, then replaced whole.
    assert (out / "tel" / "telemetry.jsonl").read_text() == '{"event": 1}\n'
    assert sorted(os.listdir(staging.path)) == ["tel"]
    staging.publish()
    assert (out / "tel" / "telemetry.jsonl").read_text() == (
        '{"event": 1}\n{"event": 2}\n')
    assert not os.path.exists(staging.path)


def test_module_command_is_the_cli():
    assert launch.module_command(["analyze", "x.csv"]) == [
        sys.executable, "-m", "music_analyst_tpu_torch", "analyze", "x.csv"]
