"""The port's run telemetry: the registry, the run manifest, engine wiring,
and manifest parity with the JAX package.

Counterpart of ``tests/test_telemetry.py`` and
``tests/test_telemetry_contract.py`` for ``music_analyst_tpu_torch``
(the JAX-only cases — ``jax.monitoring`` harvest, the train step, the
bench line — have no counterpart).  The parity cases run the same CLI
subcommand with each package on the fixture and hold the two output dirs,
the manifests' key sets and the span and counter names against each
other.
"""

import json
import threading

import pytest

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.telemetry import (
    DEFAULT_BUCKETS,
    Histogram,
    Telemetry,
    configure,
    get_telemetry,
)

# The manifest keys that name the framework: the port writes the torch
# and CUDA versions where JAX writes its own.
JAX_VERSION_KEYS = {"jax_version", "jaxlib_version"}
PORT_VERSION_KEYS = {"torch_version", "cuda_version"}
# Counters only JAX emits, from modules the port has not taken yet:
# ``collectives.*`` (profiling/collectives.py, multi-card work) and
# ``profiling.compiles`` (profiling/compile.py wraps jax.jit).
JAX_ONLY_COUNTER_PREFIXES = ("collectives.", "profiling.")
# Sections both packages write only once a subsystem has been used in the
# process (a cache consulted, a fault tripped, a server or tracer or
# watchdog started), so their presence depends on what ran earlier in a
# test worker, in either package.
PROCESS_KEYS = {"corpus_cache", "wq_cache", "resilience", "serving",
                "reqtrace", "trace_exemplars", "metrics", "observability"}


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Each test gets a clean, enabled registry in both packages; the CLI's
    configure() mutates process-wide state, so restore the default."""
    from music_analyst_tpu.telemetry import configure as jax_configure

    jax_configure(enabled=True, directory=None)
    yield configure(enabled=True, directory=None)
    configure(enabled=True, directory=None)
    jax_configure(enabled=True, directory=None)


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _manifest(directory):
    return json.loads((directory / "run_manifest.json").read_text())


# ---------------------------------------------------------------- spans


def test_span_nesting_links_parents():
    tel = Telemetry()
    with tel.span("outer") as outer:
        with tel.span("middle") as middle:
            with tel.span("inner", rows=3) as inner:
                pass
    assert outer.parent_id is None
    assert middle.parent_id == outer.span_id
    assert inner.parent_id == middle.span_id
    assert inner.attrs == {"rows": 3}
    assert [sp.name for sp in tel.spans] == ["inner", "middle", "outer"]


def test_span_attrs_via_set():
    tel = Telemetry()
    with tel.span("work") as sp:
        sp.set(rows=7, backend="mock")
    assert tel.spans[0].attrs == {"rows": 7, "backend": "mock"}


def test_record_span_preserves_duration():
    tel = Telemetry()
    tel.record_span("tokenize", 1.25, rows=10)
    sp = tel.spans[0]
    assert sp.name == "tokenize" and sp.duration_s == 1.25
    assert tel.span_aggregates["tokenize"] == [1, 1.25, 1.25]


def test_spans_are_thread_safe():
    tel = Telemetry()
    n_threads, per_thread = 8, 50

    def work(i):
        for _ in range(per_thread):
            with tel.span(f"t{i}"):
                tel.count("iterations")
            tel.record_span("measured", 0.001)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tel.counters["iterations"] == n_threads * per_thread
    assert tel.span_aggregates["measured"][0] == n_threads * per_thread
    for sp in tel.spans:
        if sp.parent_id is not None:
            parent = next(p for p in tel.spans if p.span_id == sp.parent_id)
            assert parent.thread == sp.thread


def test_disabled_registry_is_inert(tmp_path):
    tel = Telemetry(enabled=False)
    with tel.span("x") as sp:
        sp.set(rows=1)
    tel.count("c")
    tel.observe("h", 0.5)
    tel.record_span("y", 1.0)
    tel.record_pipeline("p", {"depth": 2})
    with tel.run_scope("engine", str(tmp_path)):
        pass
    assert tel.spans == [] and tel.counters == {} and tel.events == 0
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------- counters / histograms


def test_counter_aggregation():
    tel = Telemetry()
    tel.count("songs", 10)
    tel.count("songs", 5)
    tel.count("retries")
    assert tel.counters == {"songs": 15, "retries": 1}


def test_histogram_buckets():
    h = Histogram(buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.05):
        h.observe(v)
    d = h.as_dict()
    assert d["buckets_le"] == [0.01, 0.1, 1.0, "inf"]
    assert d["counts"] == [1, 2, 1, 1]
    assert d["count"] == 5
    assert d["sum_s"] == pytest.approx(5.605)


def test_observe_uses_default_buckets():
    tel = Telemetry()
    tel.observe("lat", 0.02)
    assert tel.histograms["lat"].buckets == tuple(sorted(DEFAULT_BUCKETS))


def test_compile_stats_counts_kernel_builds(monkeypatch):
    """The port's compile count is the CUDA kernel libraries built or
    loaded (``kernels.build_stats``); the manifest's JAX-shaped
    ``compile`` section stays empty, since eager PyTorch compiles no
    programs, and ``profiling.kernel_builds`` carries the builds."""
    from music_analyst_tpu_torch import kernels

    monkeypatch.setattr(kernels, "build_stats",
                        lambda: {"count": 2, "seconds": 3.25})
    assert Telemetry().compile_stats() == {"count": 2, "seconds": 3.25}


def test_top_spans_ranked_by_total():
    tel = Telemetry()
    tel.record_span("slow", 3.0)
    tel.record_span("fast", 0.1)
    tel.record_span("fast", 0.2)
    top = tel.top_spans(2)
    assert [t["name"] for t in top] == ["slow", "fast"]
    assert top[1]["count"] == 2 and top[1]["max_s"] == 0.2


# ----------------------------------------------------- run scope + sinks


def test_run_scope_writes_jsonl_and_manifest(tmp_path):
    tel = Telemetry()
    with tel.run_scope("wordcount", str(tmp_path)):
        with tel.span("ingest", rows=4):
            pass
        tel.count("songs_ingested", 4)
        tel.annotate(mesh_shape={"dp": 1})

    events = _events(tmp_path / "telemetry.jsonl")
    for ev in events:
        assert ev["type"] in ("span", "event")
        assert "t_wall" in ev and "t_mono" in ev
    names = [ev["name"] for ev in events]
    assert names[0] == "run_start" and names[-1] == "run_end"
    assert "ingest" in names and "engine:wordcount" in names
    run_end = next(ev for ev in events if ev["name"] == "run_end")
    assert run_end["attrs"]["counters"] == {"songs_ingested": 4}

    manifest = _manifest(tmp_path)
    for key in ("schema", "engine", "argv", "wall_seconds", "torch_version",
                "cuda_version", "git_describe", "device", "peak_rss_bytes",
                "compile", "jax_events", "counters", "context", "spans",
                "event_count", "profiling"):
        assert key in manifest, key
    assert not JAX_VERSION_KEYS & set(manifest)
    assert manifest["engine"] == "wordcount"
    assert manifest["device"] == {"platform": "cpu", "count": 1,
                                  "kinds": ["cpu"], "memory_stats": [None]}
    assert manifest["counters"] == {"songs_ingested": 4}
    assert manifest["context"]["mesh_shape"] == {"dp": 1}
    assert manifest["compile"] == {"count": 0, "seconds": 0.0}
    assert manifest["jax_events"] == {}
    assert manifest["profiling"]["compiles"] == []


def test_nested_run_scopes_degrade_to_spans(tmp_path):
    tel = Telemetry()
    outer_dir, inner_dir = tmp_path / "outer", tmp_path / "inner"
    with tel.run_scope("joint", str(outer_dir)):
        tel.count("songs", 2)
        with tel.run_scope("wordcount", str(inner_dir)):
            tel.count("songs", 3)
    assert not inner_dir.exists()
    manifest = _manifest(outer_dir)
    assert manifest["engine"] == "joint"
    assert manifest["counters"] == {"songs": 5}
    names = [ev["name"] for ev in _events(outer_dir / "telemetry.jsonl")]
    assert "engine:wordcount" in names
    assert names.count("run_start") == 1 and names.count("run_end") == 1


def test_back_to_back_runs_reset_state(tmp_path):
    tel = Telemetry()
    with tel.run_scope("a", str(tmp_path / "a")):
        tel.count("rows", 1)
    with tel.run_scope("b", str(tmp_path / "b")):
        pass
    assert _manifest(tmp_path / "b")["counters"] == {}


def test_explicit_directory_wins_over_output_dir(tmp_path):
    tel = Telemetry()
    tel.directory = str(tmp_path / "telemetry")
    with tel.run_scope("x", str(tmp_path / "output")):
        pass
    assert (tmp_path / "telemetry" / "telemetry.jsonl").exists()
    assert (tmp_path / "telemetry" / "run_manifest.json").exists()
    assert not (tmp_path / "output").exists()


def test_memory_only_when_no_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tel = Telemetry()
    with tel.run_scope("x", None):
        tel.count("rows", 1)
    assert list(tmp_path.iterdir()) == []
    assert tel.events > 0


def test_jsonl_appends_across_runs(tmp_path):
    tel = Telemetry()
    for _ in range(2):
        with tel.run_scope("x", str(tmp_path)):
            pass
    names = [ev["name"] for ev in _events(tmp_path / "telemetry.jsonl")]
    assert names.count("run_start") == 2


# ------------------------------------------------------- engine wiring


def test_stage_timer_spans_and_seconds_agree():
    from music_analyst_tpu_torch.metrics.timer import StageTimer

    tel = get_telemetry()
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("device_compute"):
            pass
    assert set(timer.seconds) == {"device_compute"}
    assert tel.span_aggregates["device_compute"][0] == 2


def test_wordcount_engine_emits_required_stage_spans(fixture_csv, tmp_path):
    from music_analyst_tpu_torch.engines.wordcount import run_analysis

    run_analysis(str(fixture_csv), output_dir=str(tmp_path),
                 ingest_backend="python", quiet=True, device="cpu")
    names = {ev["name"] for ev in _events(tmp_path / "telemetry.jsonl")}
    assert {"split", "ingest", "device_compute", "aggregate_export"} <= names
    manifest = _manifest(tmp_path)
    assert manifest["engine"] == "wordcount"
    assert manifest["counters"]["songs_ingested"] == 7
    assert manifest["counters"]["words_counted"] == 52
    assert manifest["context"]["mesh_shape"] == {"dp": 1}


def test_sentiment_engine_emits_stage_spans(fixture_csv, tmp_path):
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment

    run_sentiment(str(fixture_csv), mock=True, output_dir=str(tmp_path),
                  quiet=True, device="cpu")
    names = {ev["name"] for ev in _events(tmp_path / "telemetry.jsonl")}
    assert {"ingest", "compute", "write", "backend_init", "serve.load",
            "tokenize", "h2d"} <= names
    manifest = _manifest(tmp_path)
    assert manifest["engine"] == "sentiment"
    assert manifest["counters"]["rows_classified"] == 8
    assert "sentiment.batch_seconds" in manifest["histograms"]
    stages = [s["stage"] for s in manifest["pipeline"]["pipeline"]["stages"]]
    assert stages == ["source", "tokenize", "h2d", "compute"]


def test_persong_engine_emits_stage_spans(fixture_csv, tmp_path):
    from music_analyst_tpu_torch.engines.persong import run_per_song_wordcount

    run_per_song_wordcount(str(fixture_csv), output_dir=str(tmp_path),
                           quiet=True)
    names = {ev["name"] for ev in _events(tmp_path / "telemetry.jsonl")}
    assert {"ingest", "tokenize", "write"} <= names
    manifest = _manifest(tmp_path)
    assert manifest["counters"]["rows_processed"] == 8
    assert manifest["counters"]["words_counted"] == 52


def test_joint_run_writes_one_manifest(fixture_csv, tmp_path):
    from music_analyst_tpu_torch.engines.joint import run_joint

    run_joint(str(fixture_csv), output_dir=str(tmp_path), mock=True,
              quiet=True, device="cpu", use_corpus_cache=False)
    manifest = _manifest(tmp_path)
    assert manifest["engine"] == "joint"
    names = [ev["name"] for ev in _events(tmp_path / "telemetry.jsonl")]
    assert "engine:wordcount" in names and "engine:sentiment" in names
    assert names.count("run_start") == 1


def test_artifacts_identical_with_and_without_telemetry(fixture_csv,
                                                        tmp_path):
    from music_analyst_tpu_torch.engines.wordcount import run_analysis

    on_dir, off_dir = tmp_path / "on", tmp_path / "off"
    for enabled, out in ((True, on_dir), (False, off_dir)):
        configure(enabled=enabled)
        run_analysis(str(fixture_csv), output_dir=str(out),
                     ingest_backend="python", quiet=True, device="cpu")
    for name in ("word_counts.csv", "top_artists.csv"):
        assert (on_dir / name).read_bytes() == (off_dir / name).read_bytes()

    def structure(obj):
        if isinstance(obj, dict):
            return {k: structure(v) for k, v in sorted(obj.items())}
        if isinstance(obj, list):
            return [structure(v) for v in obj]
        return type(obj).__name__

    on_metrics = json.loads((on_dir / "performance_metrics.json").read_text())
    off_metrics = json.loads(
        (off_dir / "performance_metrics.json").read_text())
    assert structure(on_metrics) == structure(off_metrics)
    assert not (off_dir / "telemetry.jsonl").exists()
    assert not (off_dir / "run_manifest.json").exists()
    assert (on_dir / "telemetry.jsonl").exists()


# ------------------------------------------------------ the CLI contract


def test_cli_no_telemetry_writes_zero_extra_files(fixture_csv, tmp_path):
    out = tmp_path / "out"
    assert port_main(["wordcount-per-song", str(fixture_csv), "--device",
                      "cpu", "--output-dir", str(out), "--no-telemetry"]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "word_counts_by_song.csv", "word_counts_global.csv",
    ]
    assert not get_telemetry().enabled


def test_cli_telemetry_dir_emits_parseable_artifacts(fixture_csv, tmp_path):
    out, tdir = tmp_path / "out", tmp_path / "telemetry"
    assert port_main(["sentiment", str(fixture_csv), "--mock", "--limit", "3",
                      "--device", "cpu", "--output-dir", str(out),
                      "--telemetry-dir", str(tdir)]) == 0
    events = _events(tdir / "telemetry.jsonl")
    assert events and all("t_mono" in ev for ev in events)
    manifest = _manifest(tdir)
    assert manifest["engine"] == "sentiment"
    assert manifest["device"]["platform"] == "cpu"
    assert not (out / "telemetry.jsonl").exists()
    assert not (out / "run_manifest.json").exists()


def test_cli_default_telemetry_lands_in_output_dir(fixture_csv, tmp_path):
    out = tmp_path / "out"
    assert port_main(["wordcount-per-song", str(fixture_csv), "--device",
                      "cpu", "--output-dir", str(out)]) == 0
    assert (out / "telemetry.jsonl").exists()
    manifest = _manifest(out)
    assert manifest["engine"] == "persong"
    assert manifest["counters"]["rows_processed"] > 0


def test_split_stays_memory_only_without_flag(fixture_csv, tmp_path):
    cols = tmp_path / "cols"
    assert port_main(["split", str(fixture_csv), "--output-dir",
                      str(cols)]) == 0
    assert not any(p.name.startswith(("telemetry", "run_manifest"))
                   for p in cols.iterdir())


@pytest.mark.parametrize("command", ["analyze", "sentiment", "split",
                                     "wordcount-per-song"])
def test_cli_no_telemetry_under_every_subcommand(fixture_csv, tmp_path,
                                                 command):
    out = tmp_path / "out"
    args = [command, str(fixture_csv), "--output-dir", str(out),
            "--no-telemetry"]
    if command != "split":
        args += ["--device", "cpu"]
    if command == "sentiment":
        args.append("--mock")
    assert port_main(args) == 0
    written = {p.name for p in out.rglob("*")}
    assert not written & {"telemetry.jsonl", "run_manifest.json"}


# ------------------------------------------------- parity with JAX's manifest



_PARITY_RUNS = {
    "analyze": ["--no-corpus-cache"],
    "sentiment": ["--mock"],
    "wordcount-per-song": [],
    "split": [],
}


def _run_both(command, fixture_csv, tmp_path):
    """One run of ``command`` with each package; returns each package's
    (output dir, telemetry dir)."""
    dirs = {}
    for name, main, device in (("jax", jax_main, []),
                               ("port", port_main, ["--device", "cpu"])):
        out, tel = tmp_path / name / "out", tmp_path / name / "tel"
        args = [command, str(fixture_csv), "--output-dir", str(out),
                *_PARITY_RUNS[command]]
        if command == "split":
            # The splitter's run sinks only where --telemetry-dir points.
            args += ["--telemetry-dir", str(tel)]
        else:
            args += device
            tel = out
        assert main(args) == 0
        dirs[name] = (out, tel)
    return dirs


def _names(directory):
    events = _events(directory / "telemetry.jsonl")
    manifest = _manifest(directory)
    return ({ev["name"] for ev in events if ev["type"] == "span"},
            set(manifest["counters"]))


@pytest.mark.parametrize("command", sorted(_PARITY_RUNS))
def test_manifest_parity_with_jax(fixture_csv, tmp_path, command):
    """Both packages write the same files, manifests with the same keys
    (apart from the version keys), and the same span and counter names."""
    dirs = _run_both(command, fixture_csv, tmp_path)
    (jax_out, jax_tel), (port_out, port_tel) = dirs["jax"], dirs["port"]
    listing = [sorted(str(p.relative_to(d)) for p in d.rglob("*"))
               for d in (jax_out, port_out)]
    assert listing[0] == listing[1]
    jax_manifest, port_manifest = _manifest(jax_tel), _manifest(port_tel)
    assert (set(jax_manifest) - JAX_VERSION_KEYS - PROCESS_KEYS
            == set(port_manifest) - PORT_VERSION_KEYS - PROCESS_KEYS)
    assert JAX_VERSION_KEYS <= set(jax_manifest)
    assert PORT_VERSION_KEYS <= set(port_manifest)
    assert jax_manifest["schema"] == port_manifest["schema"] == 1
    assert jax_manifest["engine"] == port_manifest["engine"]
    jax_spans, jax_counters = _names(jax_tel)
    port_spans, port_counters = _names(port_tel)
    assert jax_spans == port_spans
    assert {c for c in jax_counters
            if not c.startswith(JAX_ONLY_COUNTER_PREFIXES)} == port_counters
    assert jax_manifest["counters"].get("rows_classified") == \
        port_manifest["counters"].get("rows_classified")
