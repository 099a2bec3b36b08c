"""``--devices N`` on the port's CLI ≡ one device ≡ JAX's ``--devices N``.

The port's ``analyze`` and ``sentiment`` with ``--devices 2 --device
cpu`` run as subprocesses: rank 0 launches rank 1 itself (gloo, the
stderr names the backend), and only rank 0 writes.  Each run's outputs
must be byte-identical to the port's one-device run and to JAX's CLI with
``--devices 2`` on its 8-device CPU mesh — ``word_counts.csv``,
``top_artists.csv`` and ``split_columns/*`` (with and without streamed
chunks) — and so must the ``artist,song,label`` columns of
``sentiment_details.csv`` and ``sentiment_totals.json`` (the latency
column is a measured time), with the exception below.  The sentiment runs use a tiny DistilBERT
checkpoint in HF layout through ``$MUSICAAL_DISTILBERT_CKPT``, seeded,
with a classifier head scaled so the labels spread over all three
classes (float32 checkpoint, bf16 model on both sides).  The bf16 models
of the two packages round differently, and on this fixture their
one-device runs already disagree on one row; so labels are held equal to
the port's one-device run byte for byte, JAX's ``--devices 2`` run must
equal JAX's one-device run, and the port's mesh run must equal JAX's on
every row where the two one-device runs agree (all but at most one).
Float32 labels and logits are held to JAX's on the mesh in
``tests/test_torch_sharded_inference.py``.  ``--mock``
builds no mesh and runs one process.  A killed rank makes the command
exit non-zero with no output written, and what stays unported under a
mesh is a usage error.
"""

import json
import os
import re
import signal
import subprocess
import sys

import pytest
import torch

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu.models.distilbert import DistilBertConfig
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from tests.test_distilbert_checkpoint import _hf_state_dict

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("word_counts.csv", "top_artists.csv")


@pytest.fixture(scope="module")
def songs_600(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "songs_600.csv"
    generate_dataset(str(path), num_songs=600, seed=5)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = _hf_state_dict(DistilBertConfig.tiny(), seed=6)
    sd["classifier.weight"] = sd["classifier.weight"] * 3000
    path = tmp_path_factory.mktemp("ckpt") / "distilbert.pt"
    torch.save(sd, path)
    return str(path)


def _port_cli(args, env=None, timeout=240):
    run_env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", *args],
        cwd=ROOT, env=run_env, capture_output=True, text=True,
        timeout=timeout)


def _files(out):
    names = [n for n in CSVS if (out / n).exists()]
    split = out / "split_columns"
    if split.exists():
        names += [f"split_columns/{n}" for n in sorted(os.listdir(split))]
    return {n: (out / n).read_bytes() for n in names}


def _labels(out):
    lines = (out / "sentiment_details.csv").read_text().splitlines()
    return [line.rsplit(",", 1)[0] for line in lines]


@pytest.mark.parametrize("chunk", [None, "150"], ids=["whole", "chunks"])
@pytest.mark.parametrize("corpus", ["fixture", "songs_600"])
def test_analyze_devices_2_writes_one_device_and_jax_bytes(
        corpus, chunk, fixture_csv, songs_600, tmp_path):
    csv = str(fixture_csv if corpus == "fixture" else songs_600)
    extra = [] if chunk is None else ["--chunk-songs", chunk]
    run = _port_cli(["analyze", csv, "--device", "cpu", "--devices", "2",
                     "--output-dir", str(tmp_path / "d2"), *extra])
    assert run.returncode == 0, run.stderr[-2000:]
    assert "mesh: 2 ranks over gloo" in run.stderr
    port_main(["analyze", csv, "--device", "cpu", "--output-dir",
               str(tmp_path / "d1"), *extra])
    jax_main(["analyze", csv, "--devices", "2", "--output-dir",
              str(tmp_path / "jax"), *extra])
    got = _files(tmp_path / "d2")
    assert set(CSVS) <= set(got)
    assert got == _files(tmp_path / "d1") == _files(tmp_path / "jax")
    metrics = json.loads((tmp_path / "d2" / "performance_metrics.json")
                         .read_text())
    assert len(metrics["per_chip"]) == 2 and metrics["processes"] == 2
    manifest = json.loads((tmp_path / "d2" / "run_manifest.json").read_text())
    assert manifest["context"]["mesh_shape"] == {"dp": 2}
    assert manifest["context"]["mesh_backend"] == "gloo"


@pytest.mark.parametrize("command", ["sentiment", "analyze"])
def test_distilbert_devices_2_labels_equal_one_device_and_jax(
        command, fixture_csv, ckpt, tmp_path, monkeypatch):
    extra = (["--with-sentiment", "--model", "distilbert-tiny"]
             if command == "analyze" else ["--model", "distilbert-tiny"])
    run = _port_cli([command, str(fixture_csv), "--device", "cpu",
                     "--devices", "2", "--output-dir", str(tmp_path / "d2"),
                     *extra], env={"MUSICAAL_DISTILBERT_CKPT": ckpt})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "mesh: 2 ranks over gloo" in run.stderr
    monkeypatch.setenv("MUSICAAL_DISTILBERT_CKPT", ckpt)
    port_main([command, str(fixture_csv), "--device", "cpu", "--output-dir",
               str(tmp_path / "d1"), *extra])
    jax_main([command, str(fixture_csv), "--devices", "2", "--output-dir",
              str(tmp_path / "jax"), *extra])
    jax_main([command, str(fixture_csv), "--output-dir",
              str(tmp_path / "jax1"), *extra])
    labels = _labels(tmp_path / "d2")
    # The joint run classifies the 7 records the exact parser accepts.
    assert len({line.rsplit(",", 1)[1] for line in labels[1:]}) == (
        3 if command == "sentiment" else 2)
    # The mesh changes no label in either package.
    assert labels == _labels(tmp_path / "d1")
    assert _labels(tmp_path / "jax") == _labels(tmp_path / "jax1")
    for name in ("sentiment_totals.json",):
        assert ((tmp_path / "d2" / name).read_bytes()
                == (tmp_path / "d1" / name).read_bytes())
    # Across packages the bf16 models agree row for row wherever their
    # one-device runs do (all rows but at most one near-boundary row).
    same = [i for i, (a, b) in enumerate(zip(_labels(tmp_path / "d1"),
                                             _labels(tmp_path / "jax1")))
            if a == b]
    assert len(same) >= len(labels) - 1
    assert ([labels[i] for i in same]
            == [_labels(tmp_path / "jax")[i] for i in same])
    assert _files(tmp_path / "d2") == _files(tmp_path / "jax")


@pytest.mark.parametrize("model,mock", [
    ("distilbert", False), ("distilbert-tiny-int8", False),
    ("llama3-tiny", False), ("llama3-8b", False), ("mock", False),
    ("distilbert", True), ("llama3-tiny", True), ("ollama:llama3", False),
])
def test_mesh_capable_matches_jax(model, mock):
    from music_analyst_tpu.engines.sentiment import _mesh_capable
    from music_analyst_tpu_torch.engines.families import mesh_capable

    assert mesh_capable(model, mock) == _mesh_capable(model, mock)


def test_rank_launch_line_is_one_write(monkeypatch):
    """Ranks share one stderr, so each rank's launch line goes out in a
    single write, newline included (with an unbuffered stderr, ``print``'s
    separate newline let another rank's line in between)."""
    from music_analyst_tpu_torch.cli import main as cli

    writes = []

    class _Stderr:
        def write(self, text):
            writes.append(text)

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stderr", _Stderr())
    assert cli._report_launches(3) == 3
    assert len(writes) == 1
    found = re.fullmatch(r"mesh: rank 0 kernel launches (\{.*\})\n",
                         writes[0])
    assert found and isinstance(json.loads(found.group(1)), dict)


def test_mock_devices_2_runs_one_process(fixture_csv, tmp_path):
    run = _port_cli(["sentiment", str(fixture_csv), "--device", "cpu",
                     "--mock", "--devices", "2", "--output-dir",
                     str(tmp_path / "m")])
    assert run.returncode == 0, run.stderr[-2000:]
    assert "mesh:" not in run.stderr
    port_main(["sentiment", str(fixture_csv), "--device", "cpu", "--mock",
               "--output-dir", str(tmp_path / "one")])
    for name in ("sentiment_details.csv", "sentiment_totals.json"):
        assert ((tmp_path / "m" / name).read_bytes()
                == (tmp_path / "one" / name).read_bytes())


def test_killed_rank_exits_nonzero_and_writes_nothing(songs_600, tmp_path):
    out = tmp_path / "killed"
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_analyst_tpu_torch", "analyze",
         str(songs_600), "--device", "cpu", "--devices", "2",
         "--output-dir", str(out)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        found = None
        while found is None:
            line = proc.stderr.readline()
            assert line, "the command ended before launching rank 1"
            found = re.search(r"rank 1 pid (\d+)", line)
        pid = int(found.group(1))
        os.kill(pid, signal.SIGKILL)
        assert proc.wait(timeout=120) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "rank 1 exited with -9" in proc.stderr.read()
    assert not any((out / n).exists() for n in
                   (*CSVS, "performance_metrics.json", "split_columns"))


@pytest.mark.parametrize("command,flags,message", [
    ("sentiment", ["--model", "distilbert-tiny", "--devices", "2",
                   "--weight-quant", "int8"], "weight_quant under a mesh"),
    ("analyze", ["--devices", "0"], "must be >= 1"),
])
def test_mesh_refusals(command, flags, message, fixture_csv, tmp_path,
                       capsys):
    with pytest.raises(SystemExit) as exc:
        port_main([command, str(fixture_csv), "--device", "cpu",
                   "--output-dir", str(tmp_path), *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_devices_on_cuda_without_a_card_raises(fixture_csv, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_main(["analyze", str(fixture_csv), "--devices", "2",
                   "--output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
