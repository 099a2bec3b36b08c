"""Port sentiment engine ≡ the JAX engine on the fixture CSV.

Both engines run with an injected backend (the port's on ``device="cpu"``;
DistilBERT weights carried over from the JAX classifier with
``params_from_jax``, tiny config in float32).  Tolerance: none — totals and
the ``artist,song,label`` columns must be identical.
"""

import csv
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.engines.sentiment import run_sentiment as jax_run
from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models.mock import MockKeywordClassifier as JaxMock
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data.synthetic import generate_dataset
from music_analyst_tpu_torch.engines.sentiment import get_backend, run_sentiment
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models.mock import MockKeywordClassifier

# Small shapes: one intra-op thread is enough, and keeps these tests from
# crowding the timing-sensitive tests that parallel workers run beside them.
torch.set_num_threads(1)


def _details(path):
    with open(path / "sentiment_details.csv", newline="", encoding="utf-8") as fh:
        return [(r["artist"], r["song"], r["label"]) for r in csv.DictReader(fh)]


def _totals(path):
    return (path / "sentiment_totals.json").read_text()


def _distilbert_pair():
    cfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32",
                              attn_impl="flash")
    jclf = jd.DistilBertClassifier(config=cfg, max_len=64, seed=5)
    state = td.params_from_jax(jax.tree_util.tree_map(np.asarray, jclf.params))
    tclf = td.DistilBertClassifier(
        config=td.DistilBertConfig.tiny(dtype="float32"), max_len=64,
        state_dict=state, device="cpu",
    )
    return jclf, tclf


@pytest.mark.parametrize("backend", ["mock", "distilbert-tiny"])
def test_artifacts_match_jax_engine(fixture_csv, tmp_path, backend):
    if backend == "mock":
        jclf, tclf = JaxMock(), MockKeywordClassifier(device="cpu")
    else:
        jclf, tclf = _distilbert_pair()
    jax_run(str(fixture_csv), backend=jclf, output_dir=str(tmp_path / "jax"),
            quiet=True, batch_size=3)
    result = run_sentiment(str(fixture_csv), backend=tclf,
                           output_dir=str(tmp_path / "port"), quiet=True,
                           batch_size=3)
    assert _totals(tmp_path / "port") == _totals(tmp_path / "jax")
    assert _details(tmp_path / "port") == _details(tmp_path / "jax")
    assert [r.label for r in result.rows] == [
        row[2] for row in _details(tmp_path / "jax")
    ]


def test_mock_fixture_counts(fixture_csv, tmp_path):
    run_sentiment(str(fixture_csv), mock=True, device="cpu",
                  output_dir=str(tmp_path), quiet=True)
    assert json.loads(_totals(tmp_path)) == {
        "Positive": 3, "Neutral": 4, "Negative": 1,
    }


@pytest.mark.parametrize("depth", [0, 2])
def test_resume_continues_a_partial_run(tmp_path, depth):
    data = tmp_path / "songs.csv"
    generate_dataset(str(data), num_songs=40, seed=2)
    full = tmp_path / "full"
    run_sentiment(str(data), mock=True, device="cpu", output_dir=str(full),
                  quiet=True, batch_size=7, prefetch_depth=depth)
    part = tmp_path / "part"
    run_sentiment(str(data), mock=True, device="cpu", output_dir=str(part),
                  quiet=True, limit=17, batch_size=7, prefetch_depth=depth)
    # A torn trailing row (kill mid-write) is dropped and re-classified.
    with open(part / "sentiment_details.csv", "a", encoding="utf-8") as fh:
        fh.write('Torn,"half a row')
    result = run_sentiment(str(data), mock=True, device="cpu",
                           output_dir=str(part), quiet=True, resume=True,
                           batch_size=7, prefetch_depth=depth)
    assert len(result.rows) == 40 - 17
    assert _details(part) == _details(full)
    assert _totals(part) == _totals(full)


def test_cli_matches_jax_cli(fixture_csv, tmp_path):
    from music_analyst_tpu.cli.main import main as jax_main

    jax_main(["sentiment", str(fixture_csv), "--mock",
              "--output-dir", str(tmp_path / "jax")])
    assert port_main(["sentiment", str(fixture_csv), "--mock", "--device",
                      "cpu", "--output-dir", str(tmp_path / "port")]) == 0
    assert _totals(tmp_path / "port") == _totals(tmp_path / "jax")
    assert ((tmp_path / "port" / "sentiment_details.csv").read_bytes()
            == (tmp_path / "jax" / "sentiment_details.csv").read_bytes())


def test_cli_runs_distilbert_tiny_packed(fixture_csv, tmp_path):
    assert port_main(["sentiment", str(fixture_csv), "--model",
                      "distilbert-tiny-packed", "--device", "cpu",
                      "--output-dir", str(tmp_path)]) == 0
    assert sum(json.loads(_totals(tmp_path)).values()) == 8


def test_backend_guards(monkeypatch):
    monkeypatch.delenv("MUSICAAL_LLAMA_CKPT", raising=False)
    with pytest.raises(ValueError, match="encoder-classifier option"):
        get_backend("mock", mock=True, length_buckets=(32,), device="cpu")
    # llama3 is ported; as in the JAX package the 8B preset refuses to
    # run on random weights (no checkpoint configured).
    with pytest.raises(RuntimeError, match="needs a checkpoint"):
        get_backend("llama3", device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_backend("ollama:llama3", device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_backend("distilbert-tiny", weight_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        get_backend("gpt", device="cpu")
    with pytest.raises(ValueError, match="explicit backend"):
        run_sentiment("x.csv", backend=MockKeywordClassifier(device="cpu"),
                      length_buckets=(32,))


@pytest.mark.parametrize("depth", [0, 2])
def test_stage_failure_reaches_the_caller(fixture_csv, tmp_path, depth):
    class Broken(MockKeywordClassifier):
        def prepare(self, texts):
            raise RuntimeError("tokenizer exploded")

    with pytest.raises(RuntimeError, match="tokenizer exploded"):
        run_sentiment(str(fixture_csv), backend=Broken(device="cpu"),
                      output_dir=str(tmp_path), quiet=True,
                      prefetch_depth=depth)


class _SubmitCollectOnly:
    """A backend with only submit/collect, like a user plugin."""

    name = "duck"
    reports_latency = False

    def submit(self, texts):
        return ["Positive" if "love" in t.lower() else "Neutral" for t in texts]

    def collect(self, handle):
        return handle


@pytest.mark.parametrize("depth", [0, 2])
def test_duck_typed_backend_matches_jax(fixture_csv, tmp_path, depth):
    jax_run(str(fixture_csv), backend=_SubmitCollectOnly(),
            output_dir=str(tmp_path / "jax"), quiet=True, batch_size=3,
            prefetch_depth=depth)
    run_sentiment(str(fixture_csv), backend=_SubmitCollectOnly(),
                  output_dir=str(tmp_path / "port"), quiet=True, batch_size=3,
                  prefetch_depth=depth)
    assert _totals(tmp_path / "port") == _totals(tmp_path / "jax")
    assert _details(tmp_path / "port") == _details(tmp_path / "jax")


def test_weight_quant_order_of_checks_matches_jax():
    from music_analyst_tpu.engines.sentiment import get_backend as jax_backend

    for model, mock in (("mock", True), ("distilbert-tiny", True),
                        ("ollama:llama3", False)):
        with pytest.raises(ValueError, match="on-device model option"):
            jax_backend(model, mock=mock, weight_quant="int8")
        with pytest.raises(ValueError, match="on-device model option"):
            get_backend(model, mock=mock, weight_quant="int8", device="cpu")


# JAX flags at their no-op values run; any other value is a usage error.
_NO_OP_FLAGS = [
    ["--weight-quant", "none"], ["--no-telemetry"], ["--devices", "1"],
    ["--watchdog-timeout", "0"], ["--watchdog-timeout", "0.0"],
]
_UNPORTED_FLAGS = [
    (["--weight-quant", "int8", "--model", "distilbert-tiny"], "not yet ported"),
    (["--weight-quant", "int8"], "on-device model family"),
    (["--devices", "2"], "not yet ported"),
    (["--trace-dir", "t"], "not yet ported"),
    (["--telemetry-dir", "t"], "not yet ported"),
    (["--profile-dir", "t"], "not yet ported"),
    (["--watchdog-timeout", "5"], "not yet ported"),
    (["--watchdog-timeout", "soon"], "number of seconds"),
    (["--inject-faults", "ingest.read:error@1"], "not yet ported"),
]


@pytest.mark.parametrize("flags", _NO_OP_FLAGS, ids=" ".join)
def test_sentiment_cli_accepts_no_op_flags(fixture_csv, tmp_path, flags):
    assert port_main(["sentiment", str(fixture_csv), "--mock", "--device",
                      "cpu", "--output-dir", str(tmp_path), *flags]) == 0
    assert json.loads(_totals(tmp_path)) == {
        "Positive": 3, "Neutral": 4, "Negative": 1,
    }


@pytest.mark.parametrize("flags,message", _UNPORTED_FLAGS,
                         ids=[" ".join(f) for f, _ in _UNPORTED_FLAGS])
def test_sentiment_cli_refuses_unported_values(fixture_csv, tmp_path, capsys,
                                               flags, message):
    backend = [] if "--model" in flags else ["--mock"]
    with pytest.raises(SystemExit) as exc:
        port_main(["sentiment", str(fixture_csv), *backend, "--device", "cpu",
                   "--output-dir", str(tmp_path), *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "sentiment_totals.json").exists()
