"""Port fault seams, retries, failover and watchdog scopes ≡ the JAX ones.

The same ``--inject-faults`` spec runs through both packages on the same
fixture; the port's outputs must be byte-identical to its clean run and
to JAX's faulted run, and the run manifest's ``resilience`` section (per
site calls and trips, retry attempts and recoveries) and its
``retry.*`` / ``failover.*`` / ``faults.*`` counters must equal JAX's.
The one intended difference: a persistent device fault makes the port
raise after one failover retry, where JAX degrades to a host
``np.bincount`` (the port never carries on on the CPU when the card is
lost).  The watchdog cases wait on the trip itself and on the flight
record with a deadline of their own, so a loaded machine only makes them
slower.  Tolerance: none (files and counters exact; DistilBERT labels
equal).
"""

import csv
import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu import resilience as jres
from music_analyst_tpu.engines.sentiment import run_sentiment as jax_sentiment
from music_analyst_tpu.engines.wordcount import run_analysis as jax_analysis
from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu_torch.engines.sentiment import run_sentiment
from music_analyst_tpu_torch.engines.wordcount import run_analysis
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models.mock import MockKeywordClassifier
from music_analyst_tpu_torch.observability import watchdog
from music_analyst_tpu_torch.observability.report import classify_error
from music_analyst_tpu_torch.resilience.failover import (
    run_with_failover,
    should_failover,
)
from music_analyst_tpu_torch.resilience.faults import (
    InjectedFatal,
    InjectedFault,
    configure_faults,
    fault_stats,
)
from music_analyst_tpu_torch.resilience.policy import (
    reset_retry_stats,
    retry_stats,
)
from music_analyst_tpu_torch.telemetry import get_telemetry

torch.set_num_threads(1)

# A watchdog case waits this long at most for its trip and its record;
# the watchdog's own timeout is long beside any unstalled scope here, so
# a loaded machine cannot trip another scope first.
_TRIP_DEADLINE_S = 60.0
_WATCHDOG_S = 1.0
_COUNTER_PREFIXES = ("retry.", "failover.", "faults.")


@pytest.fixture(autouse=True)
def _pristine():
    """No injector, retry stats or watchdog in either package, before and
    after every test."""

    def reset():
        configure_faults(None)
        reset_retry_stats()
        watchdog.stop_watchdog()
        jres.configure_faults(None)
        jres.reset_retry_stats()

    reset()
    yield
    reset()


def _arm(spec):
    """The same spec in both packages, retry stats zeroed."""
    jres.configure_faults(spec)
    jres.reset_retry_stats()
    configure_faults(spec)
    reset_retry_stats()


def _manifest(out):
    return json.loads((out / "run_manifest.json").read_text())


def _resilience(manifest):
    counters = {k: v for k, v in manifest["counters"].items()
                if k.startswith(_COUNTER_PREFIXES)}
    return manifest.get("resilience"), counters


def _wait_for(predicate, what):
    deadline = time.monotonic() + _TRIP_DEADLINE_S
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ------------------------------------------------------------ word count


def _analyze_both(fixture_csv, tmp_path, spec, name):
    kwargs = dict(write_split=False, quiet=True, use_corpus_cache=False)
    _arm(spec)
    run_analysis(str(fixture_csv), output_dir=str(tmp_path / name),
                 device="cpu", **kwargs)
    _arm(spec)
    jax_analysis(str(fixture_csv), output_dir=str(tmp_path / f"jax_{name}"),
                 **kwargs)
    return tmp_path / name, tmp_path / f"jax_{name}"


@pytest.mark.parametrize("spec,site", [
    ("ingest.read:error@1", "ingest.read"),
    ("collective.psum:error@1", "collective.psum"),
    ("ingest.read:error@1;collective.psum:error@1", "collective.psum"),
])
def test_wordcount_transient_fault_byte_identical(fixture_csv, tmp_path,
                                                  spec, site):
    clean, _ = _analyze_both(fixture_csv, tmp_path, None, "clean")
    port, jax_out = _analyze_both(fixture_csv, tmp_path, spec, "faulted")
    for name in ("word_counts.csv", "top_artists.csv"):
        assert (port / name).read_bytes() == (clean / name).read_bytes()
        assert (port / name).read_bytes() == (jax_out / name).read_bytes()
    got, want = _resilience(_manifest(port)), _resilience(_manifest(jax_out))
    assert got == want
    section, counters = got
    assert section["faults"][site]["trips"] == 1
    if site == "ingest.read":
        assert counters["retry.ingest.read.recovered"] == 1
    else:
        assert counters["failover.wordcount.device_compute.retries"] == 1
        assert counters["failover.wordcount.device_compute.recoveries"] == 1


def test_wordcount_persistent_device_fault_raises_after_one_retry(
        fixture_csv, tmp_path):
    """A persistent ``collective.psum:error``: the port re-inits once,
    retries once and raises; nothing of the run's outputs is written and
    no ``degraded`` stamp appears.  JAX, on the same spec, finishes on
    its host ``np.bincount`` degrade path (``degraded: true``) with the
    clean bytes — the one intended difference between the packages."""
    spec = "collective.psum:error"
    out = tmp_path / "port"
    _arm(spec)
    with pytest.raises(InjectedFault) as exc_info:
        run_analysis(str(fixture_csv), output_dir=str(out), device="cpu",
                     write_split=False, quiet=True, use_corpus_cache=False)
    assert classify_error(str(exc_info.value)) == "fault_injected"
    assert fault_stats()["collective.psum"]["trips"] == 2
    manifest = _manifest(out)
    counters = manifest["counters"]
    assert counters["failover.wordcount.device_compute.retries"] == 1
    assert counters["failover.wordcount.device_compute.failed"] == 1
    assert "failover.wordcount.device_compute.recoveries" not in counters
    assert "degraded" not in manifest
    leftovers = [n for n in os.listdir(out)
                 if n.endswith(".csv") or ".tmp-" in n]
    assert leftovers == []
    assert not (out / "performance_metrics.json").exists()

    jax_out = tmp_path / "jax"
    _arm(spec)
    jax_analysis(str(fixture_csv), output_dir=str(jax_out),
                 write_split=False, quiet=True, use_corpus_cache=False)
    jax_manifest = _manifest(jax_out)
    assert jax_manifest["degraded"] is True
    assert jax_manifest["counters"][
        "failover.wordcount.device_compute.retries"] == 1


def test_fatal_ingest_dies_structurally_no_torn_files(fixture_csv, tmp_path):
    out = tmp_path / "fatal"
    _arm("ingest.read:fatal")
    with pytest.raises(InjectedFatal) as exc_info:
        run_analysis(str(fixture_csv), output_dir=str(out), device="cpu",
                     write_split=False, quiet=True, use_corpus_cache=False)
    assert classify_error(str(exc_info.value)) == "fault_injected"
    # A fatal fault is not retried: one attempt, no recovery.
    assert retry_stats()["ingest.read"] == {
        "attempts": 1, "retries": 0, "recoveries": 0, "gave_up": 0}
    leftovers = [n for n in os.listdir(out)
                 if n.endswith(".csv") or ".tmp-" in n]
    assert leftovers == []


# ------------------------------------------------------------- sentiment


def _sentiment_files(out):
    return {name: (out / name).read_bytes()
            for name in ("sentiment_details.csv", "sentiment_totals.json")}


def test_sentiment_mock_h2d_fault_byte_identical(fixture_csv, tmp_path):
    kwargs = dict(mock=True, quiet=True, batch_size=3)
    run_sentiment(str(fixture_csv), output_dir=str(tmp_path / "clean"),
                  device="cpu", **kwargs)
    spec = "h2d.transfer:error@1"
    _arm(spec)
    run_sentiment(str(fixture_csv), output_dir=str(tmp_path / "port"),
                  device="cpu", **kwargs)
    _arm(spec)
    jax_sentiment(str(fixture_csv), output_dir=str(tmp_path / "jax"),
                  **kwargs)
    clean = _sentiment_files(tmp_path / "clean")
    assert _sentiment_files(tmp_path / "port") == clean
    assert _sentiment_files(tmp_path / "jax") == clean
    got = _resilience(_manifest(tmp_path / "port"))
    assert got == _resilience(_manifest(tmp_path / "jax"))
    assert got[0]["faults"]["h2d.transfer"]["trips"] == 1
    assert got[1]["retry.prefetch.stage.recovered"] == 1


def _labels(out):
    with open(out / "sentiment_details.csv", newline="",
              encoding="utf-8") as fh:
        rows = [(r["artist"], r["song"], r["label"])
                for r in csv.DictReader(fh)]
    return rows, (out / "sentiment_totals.json").read_bytes()


class _CollectFailsOnce:
    """A backend whose first ``collect`` raises a transient device fault."""

    def __init__(self, inner):
        self._inner = inner
        self.failures = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def collect(self, handle):
        if self.failures == 0:
            self.failures += 1
            raise InjectedFault("sentiment.collect", 1)
        return self._inner.collect(handle)


def test_distilbert_h2d_and_collect_faults_keep_labels(fixture_csv,
                                                       tmp_path):
    """Tiny DistilBERT (JAX's weights through ``params_from_jax``): a
    transient ``h2d.transfer`` on the second batch and a failed first
    ``collect`` (re-submitted by the failover) leave every label equal to
    the clean run's and to JAX's under the same faults."""
    cfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32",
                              attn_impl="flash")
    jclf = jd.DistilBertClassifier(config=cfg, max_len=64, seed=5)
    state = td.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jclf.params))
    tclf = td.DistilBertClassifier(
        config=td.DistilBertConfig.tiny(dtype="float32"), max_len=64,
        state_dict=state, device="cpu",
    )
    kwargs = dict(quiet=True, batch_size=3)
    run_sentiment(str(fixture_csv), backend=tclf,
                  output_dir=str(tmp_path / "clean"), **kwargs)
    spec = "h2d.transfer:error@2"
    _arm(spec)
    port_clf = _CollectFailsOnce(tclf)
    run_sentiment(str(fixture_csv), backend=port_clf,
                  output_dir=str(tmp_path / "port"), **kwargs)
    _arm(spec)
    jax_sentiment(str(fixture_csv), backend=_CollectFailsOnce(jclf),
                  output_dir=str(tmp_path / "jax"), **kwargs)
    # The latency column is measured wall time; labels and totals are
    # what the faults must not move.
    clean = _labels(tmp_path / "clean")
    assert _labels(tmp_path / "port") == clean
    assert _labels(tmp_path / "jax") == clean
    assert port_clf.failures == 1
    got = _resilience(_manifest(tmp_path / "port"))
    assert got == _resilience(_manifest(tmp_path / "jax"))
    counters = got[1]
    assert counters["failover.sentiment.collect.retries"] == 1
    assert counters["failover.sentiment.collect.recoveries"] == 1
    assert counters["retry.prefetch.stage.recovered"] == 1


# ----------------------------------------------------- prefetch and failover


def test_prefetch_stage_retry_and_watch_scope():
    from music_analyst_tpu.runtime.prefetch import (
        PrefetchPipeline as JaxPipeline,
        Stage as JaxStage,
    )
    from music_analyst_tpu_torch.runtime.prefetch import (
        PrefetchPipeline,
        Stage,
    )

    wd = watchdog.start_watchdog(300)
    seen = []

    def double(x):
        seen.append([(t["task"], t["kind"]) for t in wd.snapshot()["active"]])
        return x * 2

    for depth in (0, 2):
        _arm("prefetch.stage:error@2")
        pipe = PrefetchPipeline([Stage("double", double)], depth=depth,
                                name="unit_pipe")
        assert list(pipe.run(range(5))) == [0, 2, 4, 6, 8]
        assert fault_stats()["prefetch.stage"]["trips"] == 1
        assert retry_stats()["prefetch.stage"] == {
            "attempts": 6, "retries": 1, "recoveries": 1, "gave_up": 0}
        jax_pipe = JaxPipeline([JaxStage("double", lambda x: x * 2)],
                               depth=depth, name="unit_pipe")
        assert list(jax_pipe.run(range(5))) == [0, 2, 4, 6, 8]
        assert jres.retry_stats()["prefetch.stage"] == \
            retry_stats()["prefetch.stage"]
    # Every call ran inside its stage's watch scope, threaded and inline.
    assert seen and all(("unit_pipe.double", "stage") in s for s in seen)


def test_run_with_failover_reinit_then_recover():
    state = {"healthy": False, "reinits": 0}

    def compute():
        if not state["healthy"]:
            raise InjectedFault("collective.psum", 1)
        return 42

    def reinit():
        state["reinits"] += 1
        state["healthy"] = True

    with get_telemetry().run_scope("unit", None):
        assert run_with_failover(compute, site="unit.failover",
                                 reinit=reinit) == 42
        counters = dict(get_telemetry().counters)
    assert state["reinits"] == 1
    assert counters["failover.unit.failover.retries"] == 1
    assert counters["failover.unit.failover.recoveries"] == 1


def test_run_with_failover_does_not_retry_logic_errors():
    calls = []

    def compute():
        calls.append(1)
        raise KeyError("missing column")

    with pytest.raises(KeyError):
        run_with_failover(compute, site="unit.logic")
    assert calls == [1]
    assert not should_failover(KeyError("x"))
    assert not should_failover(InjectedFatal("collective.psum", 1))
    assert should_failover(InjectedFault("collective.psum", 1))


def test_run_with_failover_second_failure_raises():
    calls = []

    def compute():
        calls.append(1)
        raise RuntimeError(f"tunnel dead: lease lost ({len(calls)})")

    with get_telemetry().run_scope("unit", None):
        with pytest.raises(RuntimeError, match=r"lease lost \(2\)"):
            run_with_failover(compute, site="unit.lost",
                              reinit=lambda: None)
        counters = dict(get_telemetry().counters)
    assert calls == [1, 1]
    assert counters["failover.unit.lost.retries"] == 1
    assert counters["failover.unit.lost.failed"] == 1


# ------------------------------------------- checkpoint load and the caches


def test_checkpoint_load_and_h2d_faults_give_the_same_tree(tmp_path):
    from test_distilbert_checkpoint import _hf_state_dict
    from test_torch_wq_store import _assert_same, _jax_load, _load

    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(_hf_state_dict(jd.DistilBertConfig.tiny()), ckpt)
    clean = _load(str(ckpt), "int8")
    spec = "checkpoint.load:error@2;h2d.transfer:error@3"
    _arm(spec)
    faulted = _load(str(ckpt), "int8")
    stats = fault_stats()
    assert stats["checkpoint.load"]["trips"] == 1
    assert stats["h2d.transfer"]["trips"] == 1
    assert retry_stats()["prefetch.stage"]["recoveries"] == 2
    _assert_same(faulted, clean)
    _arm(spec)
    _assert_same(faulted, _jax_load(str(ckpt), "int8"))
    assert jres.fault_stats()["checkpoint.load"]["trips"] == 1


def test_corpus_cache_publish_retries_transient_rename(fixture_csv,
                                                       tmp_path):
    from music_analyst_tpu_torch.data import corpus_cache
    from music_analyst_tpu_torch.data.ingest import ingest_dataset

    cache = tmp_path / "corpus"
    _arm("corpus_cache.publish:error@1")
    fresh = ingest_dataset(str(fixture_csv), backend="python",
                           cache_dir=str(cache))
    assert fault_stats()["corpus_cache.publish"]["trips"] == 1
    assert retry_stats()["corpus_cache.publish"]["recoveries"] == 1
    assert not [n for n in os.listdir(cache) if ".tmp-" in n]
    cached = corpus_cache.load(str(cache), str(fixture_csv), None, False,
                               "python")
    assert cached is not None
    assert np.array_equal(cached.word_ids, fresh.word_ids)


def test_wq_cache_publish_retries_transient_rename(tmp_path):
    from music_analyst_tpu_torch.engines.wq_cache import WqCacheWriter

    _arm("corpus_cache.publish:error@1")
    writer = WqCacheWriter(str(tmp_path), "entry")
    writer.add("layer/kernel", np.ones((2, 2), dtype=np.float32))
    assert writer.publish() is True
    assert (tmp_path / "entry").is_dir()
    assert retry_stats()["corpus_cache.publish"]["recoveries"] == 1


def test_ollama_request_fault_is_retried(monkeypatch):
    requests = pytest.importorskip("requests")
    from music_analyst_tpu.models import ollama as jo
    from music_analyst_tpu_torch.models import ollama as to

    class _Response:
        def __init__(self, prompt):
            self._text = ("positive because of the sun" if "sun" in prompt
                          else "  Negative\n")

        def raise_for_status(self):
            return None

        def json(self):
            return {"response": self._text}

    posts = []

    def fake_post(url, json=None, timeout=None):
        posts.append(url)
        return _Response(json["prompt"])

    monkeypatch.setattr(requests, "post", fake_post)
    texts = ["sun all day", "", "rain again"]
    _arm("ollama.request:error@2")
    labels = to.OllamaClassifier(endpoint="http://stub.invalid",
                                 backoff_seconds=0.0).classify_batch(texts)
    assert labels == ["Positive", "Neutral", "Negative"]
    assert fault_stats()["ollama.request"] == {
        "rules": [{"site": "ollama.request", "mode": "error", "nth": 2}],
        "calls": 3, "trips": 1}
    port_retries = retry_stats()["ollama.request"]
    assert port_retries["recoveries"] == 1
    assert len(posts) == 2  # the faulted attempt never reached the wire
    _arm("ollama.request:error@2")
    jax_labels = jo.OllamaClassifier(
        endpoint="http://stub.invalid", backoff_seconds=0.0,
    ).classify_batch(texts)
    assert jax_labels == labels
    assert jres.retry_stats()["ollama.request"] == port_retries


# ---------------------------------------------------------------- watchdog


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    from music_analyst_tpu_torch.observability.flight import (
        get_flight_recorder,
    )

    directory = tmp_path / "flight"
    monkeypatch.setenv("MUSICAAL_FLIGHT_RECORD_DIR", str(directory))
    recorder = get_flight_recorder()
    recorder.install(signals=False, excepthook=False)
    try:
        yield directory
    finally:
        recorder.uninstall()


def _trip(wd, task):
    trips = [t for t in wd.trips if t["task"] == task]
    return trips[0] if trips else None


def _block_until_trip(wd, task):
    _wait_for(lambda: _trip(wd, task), f"the watchdog trip of {task}")


def _record(flight_dir, taxonomy):
    path = flight_dir / "flight_record.json"
    _wait_for(path.exists, "flight_record.json")
    record = json.loads(path.read_text())
    assert record["reason"] == "watchdog"
    assert record["taxonomy"] == taxonomy
    return record


def test_watchdog_hung_prefetch_stage_is_stage_stall(flight_dir):
    from music_analyst_tpu_torch.runtime.prefetch import (
        PrefetchPipeline,
        Stage,
    )

    wd = watchdog.start_watchdog(_WATCHDOG_S)

    def hanging_stage(item):
        _block_until_trip(wd, "bench.tokenize")
        return item

    pipe = PrefetchPipeline([Stage("tokenize", hanging_stage)], depth=1,
                            name="bench")
    assert list(pipe.run([1, 2])) == [1, 2]
    assert _trip(wd, "bench.tokenize")["taxonomy"] == "stage_stall"
    record = _record(flight_dir, "stage_stall")
    assert "hanging_stage" in record["thread_stacks"]
    assert record["watchdog"]["trips"][0]["task"] == "bench.tokenize"


def test_watchdog_stalled_collect_is_device_stall(fixture_csv, tmp_path,
                                                  flight_dir):
    kwargs = dict(quiet=True, batch_size=3)
    run_sentiment(str(fixture_csv), backend=MockKeywordClassifier(
        device="cpu"), output_dir=str(tmp_path / "clean"), **kwargs)
    wd = watchdog.start_watchdog(_WATCHDOG_S)

    class _StallsOnce(MockKeywordClassifier):
        def collect(self, handle):
            _block_until_trip(wd, "sentiment.collect")
            return super().collect(handle)

    run_sentiment(str(fixture_csv), backend=_StallsOnce(device="cpu"),
                  output_dir=str(tmp_path / "stalled"), **kwargs)
    assert _trip(wd, "sentiment.collect")["taxonomy"] == "device_stall"
    _record(flight_dir, "device_stall")
    assert _sentiment_files(tmp_path / "stalled") == \
        _sentiment_files(tmp_path / "clean")


def test_watchdog_stalled_persong_fold_is_host_stall(fixture_csv, tmp_path,
                                                     flight_dir, monkeypatch):
    from music_analyst_tpu_torch.engines import persong

    persong.run_per_song_wordcount(str(fixture_csv), quiet=True, workers=1,
                                   output_dir=str(tmp_path / "clean"))
    wd = watchdog.start_watchdog(_WATCHDOG_S)
    add = persong._DenseHistogram.add

    def stalled_add(self, word, n):
        _block_until_trip(wd, "persong.fold")
        add(self, word, n)

    monkeypatch.setattr(persong._DenseHistogram, "add", stalled_add)
    persong.run_per_song_wordcount(str(fixture_csv), quiet=True, workers=1,
                                   output_dir=str(tmp_path / "stalled"))
    assert _trip(wd, "persong.fold")["taxonomy"] == "host_stall"
    _record(flight_dir, "host_stall")
    for name in ("word_counts_global.csv", "word_counts_by_song.csv"):
        assert (tmp_path / "stalled" / name).read_bytes() == \
            (tmp_path / "clean" / name).read_bytes()


# --------------------------------------------------------------------- CLI


def _cli_pair(command, fixture_csv, out, extra):
    """argv for both packages (the port runs on the CPU)."""
    device = [] if command == "split" else ["--device", "cpu"]
    port = [command, str(fixture_csv), "--output-dir", str(out / "port"),
            *device, *extra]
    jax_argv = [command, str(fixture_csv), "--output-dir", str(out / "jax"),
                *extra]
    return port, jax_argv


_CLI_CASES = {
    "analyze": (["--no-split", "--no-corpus-cache"],
                "ingest.read:error@1;collective.psum:error@1",
                ("word_counts.csv", "top_artists.csv")),
    # Inline stages (depth 0) keep the order of the two sites' calls, and
    # so the retry counts, deterministic.
    "sentiment": (["--mock", "--batch-size", "3", "--prefetch-depth", "0"],
                  "h2d.transfer:error@1;prefetch.stage:error@3",
                  ("sentiment_details.csv", "sentiment_totals.json")),
    "wordcount-per-song": (["--workers", "1"], "prefetch.stage:error@1",
                           ("word_counts_global.csv",
                            "word_counts_by_song.csv")),
}


@pytest.mark.parametrize("command", sorted(_CLI_CASES))
def test_cli_runs_faults_and_watchdog_like_jax(command, fixture_csv,
                                               tmp_path):
    from music_analyst_tpu.cli.main import main as jax_main
    from music_analyst_tpu.observability.watchdog import (
        stop_watchdog as jax_stop_watchdog,
    )
    from music_analyst_tpu_torch.cli.main import main as port_main

    extra, spec, files = _CLI_CASES[command]
    clean, _ = _cli_pair(command, fixture_csv, tmp_path / "clean", extra)
    flags = [*extra, "--inject-faults", spec, "--watchdog-timeout", "5"]
    port, jax_argv = _cli_pair(command, fixture_csv, tmp_path, flags)
    try:
        assert port_main(clean) == 0
        reset_retry_stats()
        assert port_main(port) == 0
        assert watchdog.get_watchdog().timeout_s == 5.0
        jres.reset_retry_stats()
        assert jax_main(jax_argv) == 0
    finally:
        jax_stop_watchdog()
    for name in files:
        want = (tmp_path / "clean" / "port" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
        assert (tmp_path / "jax" / name).read_bytes() == want, name
    got = _resilience(_manifest(tmp_path / "port"))
    assert got == _resilience(_manifest(tmp_path / "jax"))
    assert sum(site["trips"] for site in got[0]["faults"].values()) == \
        spec.count(";") + 1


@pytest.mark.parametrize("flags,message", [
    (["--inject-faults", "ingest.read:explode"], "mode must be"),
    (["--inject-faults", "no.such.site:error"], "unknown site"),
    (["--watchdog-timeout", "-1"], "finite and >= 0"),
    (["--watchdog-timeout", "inf"], "finite and >= 0"),
])
@pytest.mark.parametrize("command", ["analyze", "sentiment", "split"])
def test_cli_bad_fault_spec_or_timeout_is_usage_error(command, flags,
                                                      message, fixture_csv,
                                                      tmp_path, capsys):
    from music_analyst_tpu_torch.cli.main import main as port_main

    argv, _ = _cli_pair(command, fixture_csv, tmp_path, flags)
    with pytest.raises(SystemExit) as exc:
        port_main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "port").exists()
