"""Port ``serve`` ≡ the JAX server, reply for reply.

The same NDJSON lines go through the JAX package's ``SentimentServer``
and the port's (in process, ``handle_stream`` over string streams), each
over its own backend: the keyword mock, the tiny DistilBERT in float32
and the tiny Llama in float32 (score mode, and ``generate`` through the
threaded continuous scheduler), the port's weights carried from JAX with
``params_from_jax``.  Replies must be equal once the timing fields are
removed (tolerance: none — labels, counts, greedy text and structured
errors are exact).  Queue-full sheds with their ``retry_after_ms`` and
poison isolation are held at the batcher.  ``serve --stdio --device cpu
--mock`` answers the fixture's songs with the port's ``sentiment --mock``
labels, and the unported serve flags (quantized projections under
``--tp``) refuse.
"""

import collections
import csv
import dataclasses
import io
import json
import sys
import time

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.models.mock import MockKeywordClassifier as JaxMock
from music_analyst_tpu.serving import batcher as jb
from music_analyst_tpu.serving import server as js
from music_analyst_tpu.serving.decode_loop import (
    ContinuousScheduler as JaxScheduler,
)
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.data.csv_io import iter_songs
from music_analyst_tpu_torch.data.tokenizer import tokenize_latin1
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.models.mock import MockKeywordClassifier
from music_analyst_tpu_torch.serving import batcher as tb
from music_analyst_tpu_torch.serving import server as ts
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

torch.set_num_threads(1)

# Reply fields that carry wall-clock readings.
_TIMING = ("uptime_s", "seconds", "load_seconds", "latency", "rates",
           "decode_seconds", "tokens_per_s", "ttft", "tpot", "ewma",
           "retry_after_ms", "estimate_ms", "ledger", "window_s")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if not any(t in k for t in _TIMING)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _stream(pkg, lines, backend, decode=None, **batcher_kwargs):
    """One in-process stdio session of ``pkg``'s server; reply dicts."""
    batcher = pkg.DynamicBatcher(pkg.build_ops(backend),
                                 **batcher_kwargs).start()
    if decode is not None:
        decode.start()
    server = pkg.SentimentServer(batcher, mode="stdio", decode=decode)
    out = io.StringIO()
    server.handle_stream(io.StringIO("".join(line + "\n" for line in lines)),
                         out, drain_on_eof=True)
    return [json.loads(line) for line in out.getvalue().splitlines()]


class _Pkg:
    def __init__(self, batcher_mod, server_mod):
        self.DynamicBatcher = batcher_mod.DynamicBatcher
        self.build_ops = server_mod.build_ops
        self.SentimentServer = server_mod.SentimentServer


JAX, PORT = _Pkg(jb, js), _Pkg(tb, ts)


def _both(lines, jax_backend, port_backend, **kw):
    want = _stream(JAX, lines, jax_backend, **kw)
    got = _stream(PORT, lines, port_backend, **kw)
    assert len(got) == len(want) == len(lines)
    return want, got


@pytest.fixture(scope="module")
def songs(fixture_csv):
    return [text for _, _, text in iter_songs(str(fixture_csv))]


def _lines(texts, op="sentiment", prefix="r"):
    return [json.dumps({"id": f"{prefix}{i}", "op": op, "text": t})
            for i, t in enumerate(texts)]


@pytest.mark.parametrize("max_batch", [1, 3, 8])
def test_mock_stream_matches_jax(songs, max_batch):
    lines = _lines(songs) + [
        json.dumps({"id": "p", "op": "ping"}),
        "this is not json",
        json.dumps({"id": "m", "op": "sentiment"}),
        json.dumps({"id": "t", "op": "sentiment", "text": "x",
                    "tenant": 3}),
        json.dumps({"id": "g", "op": "generate", "text": "hello"}),
        json.dumps({"id": "w", "op": "wordcount",
                    "text": "Hello hello world the THE the banana"}),
    ]
    want, got = _both(lines, JaxMock(), MockKeywordClassifier(device="cpu"),
                      max_batch=max_batch, max_wait_ms=2.0,
                      max_queue=len(lines) + 1)
    assert got == want
    assert [r["id"] for r in got[:len(songs)]] == [
        f"r{i}" for i in range(len(songs))]
    counts = collections.Counter(
        tokenize_latin1("Hello hello world the THE the banana"))
    assert got[-1]["counts"] == dict(
        sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))


def test_stats_and_shutdown_match_jax(songs):
    lines = _lines(songs[:4]) + [
        json.dumps({"id": "s", "op": "stats"}),
        json.dumps({"id": "z", "op": "shutdown"}),
    ]
    want, got = _both(lines, JaxMock(), MockKeywordClassifier(device="cpu"),
                      max_batch=4, max_wait_ms=10_000.0)
    assert got[:4] == want[:4] and got[-1] == want[-1]
    ws, gs = want[4]["stats"], got[4]["stats"]
    assert set(gs) == set(ws)
    assert set(gs["requests"]) == set(ws["requests"])
    for key in ("admitted", "completed", "shed", "failed"):
        assert gs["requests"][key] == ws["requests"][key]


def test_shutdown_reply_survives_a_slow_drain_record(songs, monkeypatch):
    """The ``shutdown`` reply is queued before its drain begins: a slow
    flight-record dump inside the drain must not let the writer see the
    drain with an empty queue and end the stream without that reply."""
    from music_analyst_tpu_torch.observability import flight

    class _SlowRecorder:
        def dump(self, **_):
            time.sleep(0.3)

    monkeypatch.setattr(flight, "get_flight_recorder", _SlowRecorder)
    lines = _lines(songs[:2]) + [json.dumps({"id": "z", "op": "shutdown"})]
    got = _stream(PORT, lines, MockKeywordClassifier(device="cpu"),
                  max_batch=4, max_wait_ms=5.0)
    assert [r["id"] for r in got] == ["r0", "r1", "z"]
    assert got[-1]["draining"] is True


@pytest.fixture(scope="module")
def distilbert_pair():
    cfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32")
    jclf = jd.DistilBertClassifier(config=cfg, max_len=64, seed=5)
    state = td.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jclf.params))
    tclf = td.DistilBertClassifier(
        config=td.DistilBertConfig.tiny(dtype="float32"), max_len=64,
        state_dict=state, device="cpu")
    return jclf, tclf


def test_distilbert_stream_matches_jax(songs, distilbert_pair):
    jclf, tclf = distilbert_pair
    lines = _lines(songs * 3)
    want, got = _both(lines, jclf, tclf, max_batch=8, max_wait_ms=2.0,
                      max_queue=64)
    assert got == want


@pytest.fixture(scope="module")
def llama_pair():
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32")
    jc = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64)
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jc.params))
    tc = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(dtype="float32"), max_prompt_len=64,
        device="cpu", state_dict=sd)
    return jc, tc


def test_llama_score_and_generate_stream_match_jax(songs, llama_pair):
    """Score-mode classify through the batcher and ``generate`` through
    the threaded continuous scheduler (paged, speculating), overlapping
    on one stream."""
    jc, tc = llama_pair
    prompts = ["golden sunshine on the river", "rain",
               "shadows fall across the empty street tonight", "ok",
               "la la la la"]
    lines = _lines(songs[:4])
    for i, p in enumerate(prompts):
        lines.append(json.dumps({"id": f"g{i}", "op": "generate", "text": p,
                                 "max_new_tokens": 4 + 3 * i}))
    kw = dict(n_slots=2, prefill_chunk=16, prompt_region=64,
              max_new_tokens=16, speculate_k=2)
    want = _stream(JAX, lines, jc, decode=JaxScheduler(jc, **kw),
                   max_batch=4, max_wait_ms=2.0)
    got = _stream(PORT, lines, tc, decode=ContinuousScheduler(tc, **kw),
                  max_batch=4, max_wait_ms=2.0)
    assert got == want
    assert all(r["ok"] for r in got)
    assert [r["text"] for r in got[4:]] == [
        r["text"] for r in want[4:]]


def _sheds(pkg, backend):
    """Six submits into a stopped batcher with room for three: the last
    three shed at once; then the worker starts and answers the rest."""
    b = pkg.DynamicBatcher(pkg.build_ops(backend), max_batch=2,
                           max_wait_ms=5.0, max_queue=3)
    reqs = [b.submit(i, "sentiment", f"love song {i}") for i in range(6)]
    b.start()
    try:
        for r in reqs:
            assert r.wait(10.0)
    finally:
        b.drain()
    return [r.response for r in reqs], b.stats()


def test_queue_full_sheds_match_jax():
    want, wstats = _sheds(JAX, JaxMock())
    got, gstats = _sheds(PORT, MockKeywordClassifier(device="cpu"))
    assert got == want
    shed = [r for r in got if not r["ok"]]
    assert len(shed) == 3
    assert all(r["error"]["kind"] == "queue_full"
               and r["error"]["retry_after_ms"] > 0 for r in shed)
    assert gstats["retry_after_ms_last"] == wstats["retry_after_ms_last"]


def _poison(pkg):
    def echo(texts):
        if any("POISON" in t for t in texts):
            raise RuntimeError("bad row in batch")
        return [{"text": t} for t in texts]

    b = pkg.DynamicBatcher({"echo": echo}, max_batch=4,
                           max_wait_ms=10_000.0, max_queue=16).start()
    try:
        reqs = [b.submit(i, "echo", t) for i, t in
                enumerate(["ok-a", "POISON pill", "ok-b", "ok-c"])]
        for r in reqs:
            assert r.wait(10.0)
    finally:
        b.drain()
    stats = b.stats()
    return ([r.response for r in reqs],
            {k: stats[k] for k in ("failed", "completed",
                                   "isolation_retries")})


def test_poison_isolation_matches_jax():
    want, got = _poison(JAX), _poison(PORT)
    assert got == want
    replies, stats = got
    assert replies[1]["error"]["kind"] == "request_failed"
    assert stats["failed"] == 1 and stats["completed"] == 3


def test_cli_stdio_mock_matches_sentiment_cli(fixture_csv, tmp_path,
                                              monkeypatch, capsys):
    assert port_main(["sentiment", str(fixture_csv), "--mock", "--device",
                      "cpu", "--output-dir", str(tmp_path)]) == 0
    with open(tmp_path / "sentiment_details.csv", newline="",
              encoding="utf-8") as fh:
        labels = [row["label"] for row in csv.DictReader(fh)]
    texts = [text for _, _, text in iter_songs(str(fixture_csv))]
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(line + "\n" for line in _lines(texts))))
    assert port_main(["serve", "--stdio", "--device", "cpu", "--mock",
                      "--no-response-cache", "--quiet"]) == 0
    replies = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert [r["label"] for r in replies] == labels


@pytest.mark.parametrize("signame", ["SIGTERM", "SIGINT"])
def test_signal_mid_batch_drains_gracefully(tmp_path, signame):
    """A signal with requests parked in a partial batch (deadline 60 s
    out): the port's server answers them, leaves a flight record naming
    the signal, and exits 0."""
    import os
    import pathlib
    import signal
    import subprocess
    import time

    flight_dir = tmp_path / "flight"
    flight_dir.mkdir()
    env = dict(os.environ, MUSICAAL_FLIGHT_RECORD_DIR=str(flight_dir))
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--device", "cpu", "--mock", "--quiet", "--no-response-cache",
         "--max-batch", "64", "--max-wait-ms", "60000", "--no-warmup"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env,
        cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        proc.stdin.write(json.dumps({"id": "up", "op": "ping"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["ok"]
        for i in range(3):
            proc.stdin.write(json.dumps({"id": f"g{i}",
                                         "text": "love " * (i + 1)}) + "\n")
        proc.stdin.flush()
        time.sleep(1.0)
        proc.send_signal(getattr(signal, signame))
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    by_id = {r["id"]: r for r in map(json.loads, out.splitlines())}
    assert all(by_id[f"g{i}"]["label"] == "Positive" for i in range(3))
    record = json.loads((flight_dir / "flight_record.json").read_text())
    assert record["reason"] == f"serve_drain:signal:{signame}"


def test_cli_serve_runs_fault_injection_and_watchdog(monkeypatch, capsys,
                                                     tmp_path):
    """``serve`` accepts ``--inject-faults`` (a transient fault at the
    dispatch seam is retried: the reply is the clean one) and a non-zero
    ``--watchdog-timeout``; a malformed fault spec is a usage error;
    ``serve_mesh(2)`` builds a ``tp`` mesh of 2 inside a group of two
    ranks, and outside one says how to launch them."""
    from music_analyst_tpu_torch.observability.watchdog import stop_watchdog
    from music_analyst_tpu_torch.resilience.faults import configure_faults

    monkeypatch.setattr(sys, "stdin", io.StringIO(
        json.dumps({"id": 1, "text": "I love the sunshine"}) + "\n"))
    try:
        assert port_main(["serve", "--stdio", "--device", "cpu", "--mock",
                          "--no-response-cache", "--quiet", "--no-warmup",
                          "--inject-faults", "serving.dispatch:error@1",
                          "--watchdog-timeout", "30"]) == 0
    finally:
        configure_faults(None)
        stop_watchdog()
    reply = json.loads(capsys.readouterr().out.splitlines()[0])
    assert reply == {"id": 1, "ok": True, "op": "sentiment",
                     "label": "Positive"}
    with pytest.raises(SystemExit):
        port_main(["serve", "--stdio", "--device", "cpu", "--mock",
                   "--inject-faults", "serving.dispatch:explode"])
    configure_faults(None)
    with pytest.raises(RuntimeError, match="serve --tp N"):
        ts.serve_mesh(2, device="cpu")
    assert ts.serve_mesh(1) is None
    from tests.torch_ranks import launch_ranks

    outs = launch_ranks(_SERVE_MESH_CHILD, 2, [], tmp_path / "ranks")
    assert [json.loads(o) for o in outs] == [
        {"axes": [["tp", 2]], "size": 2, "rank": r} for r in range(2)]


_SERVE_MESH_CHILD = r"""
import json, sys
from music_analyst_tpu_torch.parallel import multihost as mh
from music_analyst_tpu_torch.serving import server as ts
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mh.initialize(f"localhost:{port}", n, rank, timeout_s=60)
mesh = ts.serve_mesh(2, device="cpu")
print(json.dumps(dict(axes=mesh.axes, size=mesh.size, rank=mesh.rank)))
mh.shutdown()
"""
