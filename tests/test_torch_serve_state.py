"""Port serving state ≡ the JAX package's: journal, response cache, SLO.

* The request journal is byte-compatible: a journal the port wrote (and
  left unclean) recovers in the JAX package — the same unanswered
  records, the same deduplicated replies — and the other way round.
* The response-cache fingerprints of the two packages differ, and only
  by ``framework`` and ``device``, so a shared cache directory never
  answers one framework with the other's bytes; the entry key schema is
  otherwise the same.
* The SLO primitives (fair queue, token bucket), the fault-spec parser,
  the failover verdicts and the histogram quantiles give the JAX
  package's answers on the same inputs (exact: these are host integer /
  float functions of the same arithmetic).
* A wedged decode dispatch trips the port's watchdog as ``decode_stall``.
"""

import json

import pytest

from music_analyst_tpu.resilience import faults as jfaults
from music_analyst_tpu.resilience.failover import should_failover as j_fo
from music_analyst_tpu.serving import journal as jj
from music_analyst_tpu.serving import response_cache as jrc
from music_analyst_tpu.serving import slo as jslo
from music_analyst_tpu.telemetry.core import Histogram as JHist
from music_analyst_tpu_torch.resilience import faults as tfaults
from music_analyst_tpu_torch.resilience.failover import should_failover
from music_analyst_tpu_torch.serving import journal as tj
from music_analyst_tpu_torch.serving import response_cache as trc
from music_analyst_tpu_torch.serving import slo as tslo
from music_analyst_tpu_torch.telemetry.core import Histogram


def _write_unclean(mod, path):
    """Three admits, one reply, no close (a crash): two unanswered."""
    journal = mod.RequestJournal(str(path))
    assert journal.recover() == []
    for i in range(3):
        journal.record_admitted(f"r{i}", "sentiment", f"text {i}",
                                tenant="t", priority=2,
                                meta={"max_new_tokens": 4})
    journal.record_replied("r1", {"id": "r1", "ok": True, "op": "sentiment",
                                  "label": "Positive"})
    journal.sync()
    return journal


def _recover(mod, path):
    journal = mod.RequestJournal(str(path))
    unanswered = journal.recover()
    out = ([(r["id"], r["op"], r["text"], r.get("tenant"), r.get("priority"),
             r.get("meta")) for r in unanswered],
           journal.lookup_reply("r1"), journal.stats()["unclean_start"])
    journal.close()
    return out


@pytest.mark.parametrize("writer,reader", [(tj, jj), (jj, tj)],
                         ids=["port-to-jax", "jax-to-port"])
def test_journal_recovers_across_packages(tmp_path, writer, reader):
    _write_unclean(writer, tmp_path / "a")
    _write_unclean(reader, tmp_path / "b")
    got = _recover(reader, tmp_path / "a")
    assert got == _recover(reader, tmp_path / "b")
    unanswered, reply, unclean = got
    assert [u[0] for u in unanswered] == ["r0", "r2"]
    assert reply["label"] == "Positive" and unclean
    # After a clean close the other package starts clean.
    assert _recover(writer, tmp_path / "a")[2] is False


def test_journal_segments_are_byte_identical(tmp_path):
    for mod, name in ((jj, "jax"), (tj, "port")):
        journal = _write_unclean(mod, tmp_path / name)
        journal.close()
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in files:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


def _parts(fp):
    return dict(item.split("=", 1) for item in fp.split(";"))


def test_response_cache_fingerprints_differ_by_framework_and_device(
        tmp_path):
    parts = dict(model="mock", backend="mock", mock=True, weight_quant="none",
                 kv_quant="none", max_new_tokens=16, tp=1, checkpoint=None)
    jfp = jrc.backend_fingerprint(**parts)
    tfp = trc.backend_fingerprint(device="cpu", **parts)
    assert jfp != tfp
    jp, tp = _parts(jfp), _parts(tfp)
    assert {k: v for k, v in tp.items()
            if k not in ("framework", "device")} == jp
    assert tp["framework"] == "torch" and tp["device"] == "cpu"
    # A shared directory: the port's entry never answers the JAX cache.
    tcache = trc.ResponseCache(str(tmp_path), fingerprint=tfp)
    jcache = jrc.ResponseCache(str(tmp_path), fingerprint=jfp)
    reply = {"id": 1, "ok": True, "op": "sentiment", "label": "Positive"}
    assert tcache.put(tcache.key_for("sentiment", "love"), dict(reply))
    assert jcache.lookup(jcache.key_for("sentiment", "love")) is None
    # Same fingerprint, same key: the entry schema is shared.
    assert (trc.response_key("love", "sentiment", None, jfp)
            == jrc.response_key("love", "sentiment", None, jfp))
    assert trc.normalize_text(" a \n b ") == jrc.normalize_text(" a \n b ")


class _Req:
    def __init__(self, rid, tenant, priority):
        self.id, self.tenant, self.priority = rid, tenant, priority
        self.done = False
        self.t_enqueue = 0.0


def _queue_trace(mod):
    q = mod.FairQueue()
    reqs = [_Req(i, t, p) for i, (t, p) in enumerate(
        [("a", 1), ("a", 1), ("b", 1), ("a", 2), ("c", 1), ("b", 1),
         ("a", 1), ("c", 2)])]
    for r in reqs:
        q.append(r)
    trace = [("ahead", q.depth_ahead(1), q.depth_ahead(2)),
             ("cand", getattr(q.shed_candidate("c", 2), "id", None))]
    q.requeue(reqs[2])
    while q:
        trace.append(q.popleft().id)
    return trace


def test_slo_primitives_match_jax(monkeypatch):
    assert _queue_trace(tslo) == _queue_trace(jslo)
    clock = iter([0.0, 0.0, 0.1, 0.2, 0.2, 0.9, 0.9, 1.5] * 4)
    for mod in (jslo, tslo):
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
    answers = []
    for mod in (jslo, tslo):
        bucket = mod.TokenBucket(2.0)
        answers.append([bucket.take(), bucket.take(), bucket.take(),
                        bucket.retry_after_ms()])
    assert answers[0] == answers[1]


def test_faults_failover_and_histogram_match_jax():
    spec = ("decode.step:error@2;spec.draft:delay=0.5s@1%seed=7;"
            "serve.reply:fatal@3+")
    assert ([r.describe() for r in tfaults.parse_fault_spec(spec)]
            == [r.describe() for r in jfaults.parse_fault_spec(spec)])
    for bad in ("nosite", "x:explode", "x:error@0"):
        with pytest.raises(ValueError):
            tfaults.parse_fault_spec(bad)
        with pytest.raises(ValueError):
            jfaults.parse_fault_spec(bad)
    cases = [(tfaults.InjectedFault("x", 1), jfaults.InjectedFault("x", 1)),
             (tfaults.InjectedFatal("x", 1), jfaults.InjectedFatal("x", 1))]
    cases += [(e, e) for e in (RuntimeError("tunnel dead"), ValueError("bad"),
                               TimeoutError("slow"), OSError("reset"))]
    verdicts = [should_failover(t) for t, _ in cases]
    assert verdicts == [j_fo(j) for _, j in cases]
    assert verdicts[:3] == [True, False, True]
    values = [0.001 * (i % 37) + 0.0003 * i for i in range(5000)]
    th, jh = Histogram(), JHist()
    for v in values:
        th.observe(v)
        jh.observe(v)
    assert th.as_dict() == jh.as_dict()


def test_wedged_decode_dispatch_trips_decode_stall(tmp_path, monkeypatch):
    """A decode dispatch stalled past the timeout (an injected delay at
    ``decode.step``) trips the watchdog with taxonomy ``decode_stall`` and
    leaves a flight record; the request still completes."""
    import dataclasses

    from music_analyst_tpu_torch.models import llama as tl
    from music_analyst_tpu_torch.observability import watchdog
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )

    monkeypatch.setenv("MUSICAAL_FLIGHT_RECORD_DIR", str(tmp_path))
    clf = tl.LlamaZeroShotClassifier(
        config=dataclasses.replace(tl.LlamaConfig.tiny(dtype="float32"),
                                   n_layers=1),
        max_prompt_len=32, device="cpu")
    sched = ContinuousScheduler(clf, n_slots=1, prefill_chunk=16,
                                prompt_region=32, max_new_tokens=2)
    wd = watchdog.start_watchdog(0.2)
    tfaults.configure_faults("decode.step:delay=0.8s@1")
    try:
        req = sched.submit(0, "rain")
        sched.run_until_idle()
    finally:
        tfaults.configure_faults(None)
        watchdog.stop_watchdog()
    assert req.response["ok"], req.response
    trips = [t for t in wd.trips if t["task"] == "decode.dispatch"]
    assert trips and trips[0]["taxonomy"] == "decode_stall"
    record = json.loads((tmp_path / "flight_record.json").read_text())
    assert record["taxonomy"] == "decode_stall"
