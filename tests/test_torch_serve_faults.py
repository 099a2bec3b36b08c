"""Drills for the port's serving fault seams, after JAX's own drills.

Each seam of ``serve`` (ported with the server) gets an inject → observe
the degradation → recover exercise, as ``tests/test_fault_coverage.py``
and the subsystems' own tests drill JAX's: a faulted journal append or
compaction, response-cache read or write, engine-ledger flush, metrics
scrape or request-trace flush is counted and leaves no torn file; a
faulted radix lookup, int8 page dequantization or preemption leaves the
greedy text byte-identical to a clean run; a SIGKILL at the post-admit
seam loses no request across a restart.  Where the seam's code is
host-only, the same drill runs through JAX and the counters must agree.
Tolerance: none.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from music_analyst_tpu import resilience as jres
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.resilience.faults import (
    configure_faults,
    fault_stats,
)
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = "the quick brown fox jumps over the lazy dog and then "
PROMPTS = [SHARED + tail for tail in ("runs away", "naps", "eats a pie")] + [
    "golden sunshine on the river", "rain",
]


@pytest.fixture(autouse=True)
def _no_faults():
    configure_faults(None)
    jres.configure_faults(None)
    yield
    configure_faults(None)
    jres.configure_faults(None)


def _both(spec):
    configure_faults(spec)
    jres.configure_faults(spec)


# ------------------------------------------------------------ journal seams


def _journal_modules():
    from music_analyst_tpu.serving import journal as jj
    from music_analyst_tpu_torch.serving import journal as tj

    return tj, jj


def test_drill_journal_append_fault_counts_and_keeps_serving(tmp_path):
    stats = []
    for mod in _journal_modules():
        d = str(tmp_path / mod.__name__)
        j = mod.RequestJournal(d, sync_every=1)
        assert j.recover() == []
        _both("journal.append:error@1")
        j.record_admitted("a", "sentiment", "first verse")   # faulted
        j.record_admitted("b", "sentiment", "second verse")  # lands
        _both(None)
        stats.append((j.stats()["append_errors"], j.stats()["admitted"]))
        # The faulted admit never entered the replay index.
        j2 = mod.RequestJournal(d, sync_every=1)
        assert [r["id"] for r in j2.recover()] == ["b"]
        j2.close()
    assert stats[0] == stats[1] == (1, 1)


def test_drill_journal_compact_fault_leaves_replayable_state(tmp_path):
    for mod in _journal_modules():
        d = str(tmp_path / mod.__name__)
        j = mod.RequestJournal(d, sync_every=1)
        assert j.recover() == []
        for rid in ("a", "b", "c"):
            j.record_admitted(rid, "sentiment", f"verse {rid}")
        j.record_replied("b", {"ok": True, "label": "Positive"})
        _both("journal.compact:error@1")
        j.compact()
        _both(None)
        assert j.stats()["append_errors"] == 1
        j.record_admitted("d", "sentiment", "verse d")
        assert j.stats()["admitted"] == 4
        j2 = mod.RequestJournal(d, sync_every=1)
        assert sorted(r["id"] for r in j2.recover()) == ["a", "c", "d"]
        assert j2.stats()["unclean_start"] is True
        j2.close()


# ------------------------------------------------------ response-cache seams


def _cache_modules():
    from music_analyst_tpu.serving import response_cache as jrc
    from music_analyst_tpu_torch.serving import response_cache as trc

    return trc, jrc


def test_drill_response_cache_read_fault_recomputes_without_evicting(
        tmp_path):
    for mod in _cache_modules():
        d = str(tmp_path / mod.__name__)
        cache = mod.ResponseCache(d, fingerprint="fp")
        key = cache.key_for("sentiment", "faulted read song")
        cache.put(key, {"ok": True, "label": "Positive"})
        fresh = mod.ResponseCache(d, fingerprint="fp")
        _both("response_cache.read:error@1")
        assert fresh.lookup(key) is None   # transient: compute instead
        _both(None)
        assert fresh.stats()["read_fallbacks"] == 1
        assert fresh.stats()["corrupt"] == 0
        assert os.path.exists(os.path.join(d, f"{key}.json"))
        assert fresh.lookup(key) == {"ok": True, "label": "Positive"}


def test_drill_response_cache_write_fault_leaves_settle_uncached(tmp_path):
    for mod in _cache_modules():
        d = str(tmp_path / mod.__name__)
        cache = mod.ResponseCache(d, fingerprint="fp")
        key = cache.key_for("sentiment", "faulted write song")
        _both("response_cache.write:error@1")
        cache.put(key, {"ok": True, "label": "Positive"})
        _both(None)
        assert cache.stats()["write_errors"] == 1
        assert not os.path.exists(os.path.join(d, f"{key}.json"))
        assert cache.lookup(key) is not None   # the memory tier answered
        assert mod.ResponseCache(d, fingerprint="fp").lookup(key) is None


# ---------------------------------------------- ledger, metrics, trace seams


class _Req:
    tenant = "gold"


class _Slot:
    req = _Req()


def test_drill_ledger_flush_fault_counts_drops(tmp_path):
    from music_analyst_tpu.observability import engine_ledger as jl
    from music_analyst_tpu_torch.observability import engine_ledger as el

    for mod in (el, jl):
        d = tmp_path / mod.__name__
        led = mod.EngineLedger(2, interval_ms=10, directory=str(d))
        led.record_tick(0.0, 0.1, decode_s=0.05, slots=[_Slot(), None])
        _both("ledger.flush:error@1+")
        assert led.maybe_flush(force=True) is False
        assert led.maybe_flush(force=True) is False
        _both(None)
        assert (led.ledger_drops, led.flushes) == (2, 0)
        assert not (d / mod.LEDGER_FILE).exists()   # no torn line
        assert led.maybe_flush(force=True) is True
        record = json.loads((d / mod.LEDGER_FILE).read_text())
        assert record["ledger"]["ledger_drops"] == 2


def test_drill_metrics_scrape_fault_counts_errors(tmp_path):
    from music_analyst_tpu.observability import metrics_plane as jm
    from music_analyst_tpu_torch.observability import metrics_plane as tm

    for mod in (tm, jm):
        d = tmp_path / mod.__name__
        plane = mod.MetricsPlane(50.0, directory=str(d))
        plane.attach(lambda: {"requests": {"admitted": 1}})
        _both("metrics.scrape:error@1+")
        assert plane.sample_now() is None
        assert plane.sample_now() is None
        _both(None)
        assert plane.snapshot()["scrape_errors"] == 2
        assert not (d / mod.METRICS_FILE).exists()


def test_drill_reqtrace_flush_fault_degrades_to_drops(tmp_path):
    from music_analyst_tpu_torch.serving.batcher import DynamicBatcher
    from music_analyst_tpu_torch.telemetry.reqtrace import configure_reqtrace

    recorder = configure_reqtrace(1.0, directory=str(tmp_path))
    batcher = DynamicBatcher({"echo": lambda texts: [{"text": t}
                                                     for t in texts]},
                             max_batch=4, max_wait_ms=1.0,
                             max_queue=8).start()
    try:
        configure_faults("reqtrace.flush:error@1+")
        reqs = [batcher.submit(i, "echo", f"t{i}") for i in range(4)]
        for req in reqs:
            assert req.wait(30.0)
            assert req.response["ok"]
            recorder.finish_request(req)   # the flush and its fault
        trips = fault_stats()["reqtrace.flush"]["trips"]
    finally:
        configure_faults(None)
        batcher.drain()
        os.environ.pop("MUSICAAL_TRACE_DIR", None)
        os.environ.pop("MUSICAAL_TRACE_SAMPLE", None)
        configure_reqtrace(None, None)
    assert trips == 4
    stats = recorder.stats()
    assert stats["trace_drops"] == 4 and stats["flushed"] == 0
    assert not (tmp_path / "request_traces.jsonl").exists()


# -------------------------------------------------- decode scheduler seams


@pytest.fixture(scope="module")
def clf():
    return tl.LlamaZeroShotClassifier(
        config=dataclasses.replace(tl.LlamaConfig.tiny(dtype="float32"),
                                   n_layers=1),
        max_prompt_len=64, device="cpu")


def _scheduler(clf, **kwargs):
    kwargs.setdefault("n_slots", 2)
    return ContinuousScheduler(clf, prefill_chunk=16, prompt_region=64,
                               max_new_tokens=6, **kwargs)


def _run(sched, prompts):
    reqs = [sched.submit(i, p) for i, p in enumerate(prompts)]
    sched.run_until_idle()
    for req in reqs:
        assert req.response["ok"], req.response
    return [req.response["text"] for req in reqs]


def test_drill_kv_pages_lookup_fault_falls_back_to_full_prefill(clf):
    clean = _run(_scheduler(clf), PROMPTS)
    sched = _scheduler(clf)
    configure_faults("kv_pages.lookup:error@1+")
    try:
        faulted = _run(sched, PROMPTS)
        trips = fault_stats()["kv_pages.lookup"]["trips"]
    finally:
        configure_faults(None)
    assert faulted == clean
    assert trips >= len(PROMPTS)
    prefix = sched.stats()["prefix_cache"]
    assert prefix["fallbacks"] == trips
    assert prefix["hits"] == 0 and prefix["tokens_shared"] == 0


def test_drill_kv_quant_dequant_fault_degrades_to_unquantized(clf):
    clean = _run(_scheduler(clf, kv_quant="none"), PROMPTS)
    configure_faults("kv_quant.dequant:error@1+")
    try:
        sched = _scheduler(clf, kv_quant="int8")
    finally:
        configure_faults(None)
    assert _run(sched, PROMPTS) == clean
    kq = sched.stats()["kv_quant"]
    assert kq["degraded"] is True and kq["scheme"] == "none"


def test_drill_scheduler_preempt_fault_degrades_to_no_steal(clf):
    low_prompt, high_prompt = PROMPTS[3], PROMPTS[4]
    clean = _run(_scheduler(clf), [low_prompt, high_prompt])
    sched = _scheduler(clf, n_slots=1, ttft_slo_ms=1.0)
    configure_faults("scheduler.preempt:error@1+")
    try:
        low = sched.submit("low", low_prompt, priority=1,
                           deadline_ms=60_000.0)
        for _ in range(32):
            sched._tick()
            slot = sched._slots[0]
            if slot is not None and slot.active and slot.steps > 0:
                break
        high = sched.submit("gold", high_prompt, priority=5,
                            deadline_ms=60_000.0)
        sched.run_until_idle()
    finally:
        configure_faults(None)
    assert low.response["ok"] and low.response["text"] == clean[0]
    assert high.response["ok"] and high.response["text"] == clean[1]
    stats = sched.stats()
    assert stats["preemptions"] == 0
    assert stats["preempt_faults"] >= 1


# ---------------------------------------------------------- post-admit seam


def _serve(journal, spec, lines):
    argv = [sys.executable, "-m", "music_analyst_tpu_torch", "serve",
            "--stdio", "--device", "cpu", "--mock", "--no-response-cache",
            "--no-warmup", "--quiet", "--no-telemetry",
            "--journal-dir", str(journal)]
    if spec:
        argv += ["--inject-faults", spec]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(argv, input="".join(lines), capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def test_drill_serve_admit_crash_loses_no_request(tmp_path):
    """SIGKILL at the post-admit seam (the 3rd request admitted, not yet
    answered) leaves an unclean journal; a restart on the same journal,
    re-sent every request, answers each one with the clean label and
    shuts down clean."""
    from music_analyst_tpu_torch.serving import journal as tj

    texts = ["I love the sunshine", "rain and tears", "a quiet song",
             "happy happy joy"]
    lines = [json.dumps({"id": i, "text": t}) + "\n"
             for i, t in enumerate(texts)]
    clean = _serve(tmp_path / "clean", None, lines)
    assert clean.returncode == 0, clean.stderr
    want = {r["id"]: r["label"]
            for r in map(json.loads, clean.stdout.splitlines())}
    assert sorted(want) == [0, 1, 2, 3]

    journal = tmp_path / "wal"
    marker = journal / tj._CLEAN_MARKER
    crashed = _serve(journal, "serve.admit:crash@3", lines)
    assert crashed.returncode == -9, crashed.stderr
    assert not marker.exists()   # killed: no clean shutdown recorded
    restarted = _serve(journal, None, lines)
    assert restarted.returncode == 0, restarted.stderr
    got = {}
    for reply in map(json.loads, restarted.stdout.splitlines()):
        if reply.get("id") in want:
            got[reply["id"]] = reply["label"]
    assert got == want
    assert marker.exists()
