"""Package rules of the port: no JAX imports, and no quiet CPU fallback.

Every ``.py`` under ``music_analyst_tpu_torch/`` and ``tools/``, and
``chip_smoke.py``, is scanned (AST) for imports of ``jax``, ``flax`` or ``music_analyst_tpu``.
The entry points default to CUDA and must raise on a machine without a
card unless the caller passes ``device="cpu"``.
"""

import ast
import pathlib

import pytest
import torch

import music_analyst_tpu_torch
from music_analyst_tpu_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(music_analyst_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "music_analyst_tpu")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
            + [ROOT / "chip_smoke.py"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 20
    offenders = []
    for path in files:
        for module in _imported_modules(path):
            if module.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(ROOT)}: {module}")
    assert not offenders, offenders


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(monkeypatch):
    _no_cuda(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_points_raise_without_cuda(monkeypatch, fixture_csv, tmp_path):
    from music_analyst_tpu_torch.cli.main import main
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.distilbert import DistilBertClassifier
    from music_analyst_tpu_torch.models.mock import MockKeywordClassifier
    from music_analyst_tpu_torch.ops.keyword_sentiment import score_texts

    _no_cuda(monkeypatch)
    calls = [
        lambda: run_sentiment(str(fixture_csv), mock=True,
                              output_dir=str(tmp_path)),
        lambda: run_sentiment(str(fixture_csv), model="distilbert-tiny",
                              output_dir=str(tmp_path)),
        lambda: main(["sentiment", str(fixture_csv), "--mock",
                      "--output-dir", str(tmp_path)]),
        lambda: MockKeywordClassifier(),
        lambda: DistilBertClassifier.from_pretrained_or_random("distilbert-tiny"),
        lambda: score_texts(["love"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    # The same entry points run when the CPU is asked for.
    assert MockKeywordClassifier(device="cpu").classify_batch(["joy"]) == [
        "Positive"
    ]
    assert main(["sentiment", str(fixture_csv), "--mock", "--device", "cpu",
                 "--output-dir", str(tmp_path)]) == 0


def test_scan_covers_the_decoder_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("models/llama.py", "ops/paged_attention.py", "ops/kv_pages.py",
                "ops/quant.py", "serving/batcher.py", "serving/decode_loop.py"):
        assert f"music_analyst_tpu_torch/{rel}" in scanned
    assert (PORT / "csrc" / "paged_attention.cu").exists()


def test_llama_entry_points_raise_without_cuda(monkeypatch, fixture_csv,
                                               tmp_path):
    from music_analyst_tpu_torch.cli.main import main
    from music_analyst_tpu_torch.engines.sentiment import get_backend
    from music_analyst_tpu_torch.models.llama import LlamaZeroShotClassifier

    _no_cuda(monkeypatch)
    calls = [
        lambda: LlamaZeroShotClassifier(),
        lambda: LlamaZeroShotClassifier.from_pretrained_or_random("llama3-tiny"),
        lambda: get_backend("llama3-tiny"),
        lambda: main(["sentiment", str(fixture_csv), "--model", "llama3-tiny",
                      "--output-dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    clf = get_backend("llama3-tiny", device="cpu")
    assert clf.device == torch.device("cpu")


def test_scan_covers_the_wordcount_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("data/tokenizer.py", "data/vocab.py", "data/ingest.py",
                "data/corpus_cache.py", "data/splitter.py", "metrics/timer.py",
                "metrics/perf.py", "parallel/mesh.py", "ops/histogram.py",
                "engines/wordcount.py", "engines/joint.py"):
        assert f"music_analyst_tpu_torch/{rel}" in scanned


def test_scan_covers_the_quantized_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("ops/quant.py", "models/layers.py", "models/tree.py",
                "models/ollama.py", "engines/wq_cache.py",
                "engines/checkpoint.py", "engines/persong.py",
                "resilience/policy.py", "runtime/prefetch.py"):
        assert f"music_analyst_tpu_torch/{rel}" in scanned


def test_quantized_entry_points_raise_without_cuda(monkeypatch, fixture_csv,
                                                   tmp_path):
    from music_analyst_tpu_torch.cli.main import main
    from music_analyst_tpu_torch.engines.sentiment import get_backend

    _no_cuda(monkeypatch)
    calls = [
        lambda: get_backend("distilbert-tiny", weight_quant="int8"),
        lambda: get_backend("distilbert-tiny-int8"),
        lambda: get_backend("llama3-tiny", weight_quant="int4"),
        lambda: main(["sentiment", str(fixture_csv), "--model",
                      "distilbert-tiny", "--weight-quant", "int4",
                      "--output-dir", str(tmp_path)]),
        lambda: main(["wordcount-per-song", str(fixture_csv),
                      "--output-dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    assert main(["sentiment", str(fixture_csv), "--model", "distilbert-tiny",
                 "--weight-quant", "int8", "--device", "cpu",
                 "--output-dir", str(tmp_path)]) == 0


def test_scan_covers_the_serve_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("resilience/faults.py", "resilience/failover.py",
                "telemetry/__init__.py", "telemetry/core.py",
                "telemetry/reqtrace.py", "observability/metrics_plane.py",
                "observability/engine_ledger.py", "observability/watchdog.py",
                "observability/flight.py", "serving/slo.py",
                "serving/batcher.py", "serving/response_cache.py",
                "serving/journal.py", "ops/kv_slots.py",
                "serving/decode_loop.py", "serving/residency.py",
                "serving/server.py"):
        assert f"music_analyst_tpu_torch/{rel}" in scanned


def test_serve_entry_points_raise_without_cuda(monkeypatch):
    from music_analyst_tpu_torch.cli.main import main
    from music_analyst_tpu_torch.serving.residency import ModelResidency
    from music_analyst_tpu_torch.serving.server import run_server

    _no_cuda(monkeypatch)
    calls = [
        lambda: main(["serve", "--stdio", "--mock"]),
        lambda: run_server(mock=True, stdio=True, quiet=True),
        lambda: ModelResidency(model="mock", mock=True).acquire(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    assert ModelResidency(model="mock", mock=True,
                          device="cpu").acquire().device.type == "cpu"


def test_scan_covers_the_manifest_and_router_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("telemetry/introspect.py", "profiling/__init__.py",
                "profiling/trace.py", "profiling/diff.py",
                "observability/report.py", "observability/monitor.py",
                "serving/router.py"):
        assert f"music_analyst_tpu_torch/{rel}" in scanned


def test_router_and_tools_entry_points_raise_without_cuda(monkeypatch,
                                                          tmp_path):
    """``serve --replicas N`` and ``run_router`` refuse a missing card
    before any worker spawns; the host-only tools need none."""
    from music_analyst_tpu_torch.cli.main import main
    from music_analyst_tpu_torch.serving.router import run_router

    _no_cuda(monkeypatch)
    for call in (lambda: main(["serve", "--stdio", "--mock",
                               "--replicas", "2"]),
                 lambda: run_router(mock=True, stdio=True, replicas=2)):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    manifest = tmp_path / "m.json"
    manifest.write_text('{"schema": 1, "wall_seconds": 1.0}')
    assert main(["profile-diff", str(manifest), str(manifest)]) == 0
