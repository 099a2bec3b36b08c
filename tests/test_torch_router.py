"""The port's replica router: JSQ dispatch, health-aware failover, zero
loss, and byte-identical replies.

Counterpart of ``tests/test_router.py`` for ``music_analyst_tpu_torch``.
The fleets spawn real worker processes (``python -m
music_analyst_tpu_torch serve --socket … --device cpu``), so these tests
cover the wire protocol and the process lifecycle end to end.  Parity:
a port fleet answers with reply lines byte-identical to the JAX fleet's
and to one port server's (``--mock``), and a fleet of two tiny-Llama
workers generates the single server's text byte for byte.

Every test that spawns processes runs under its own time limit
(``_time_limit``), so a hung worker fails that test instead of eating
the suite's time.
"""

import contextlib
import io
import json
import os
import signal
import sys
import threading
import time

import pytest

from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.serving.batcher import (
    resolve_replicas,
    resolve_tp,
)
from music_analyst_tpu_torch.serving.router import (
    ReplicaHandle,
    ReplicaRouter,
    _RouterDecode,
    _replica_cmd,
    router_stats,
    spawn_replicas,
)
from music_analyst_tpu_torch.telemetry import configure

TEXTS = [
    "I love the sunshine and happy days",
    "tears and sorrow in the lonely night",
    "",
    "la la la the radio plays",
    "broken hearts mend slowly",
    "dancing together in the summer rain",
    "cry me a river",
    "golden mornings forever",
]


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Fail the enclosing test (not the suite) after ``seconds``."""
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds:.0f} s limit")

    previous = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_workers():
    """CPU workers with one intra-op thread each: the suite runs beside
    other test processes, and spinning worker threads would slow them."""
    previous = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if previous is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = previous


@pytest.fixture(autouse=True)
def _limit_and_fresh_telemetry():
    with _time_limit(180):
        yield configure(enabled=True, directory=None)
    configure(enabled=True, directory=None)


def _settle(reqs, timeout=30.0):
    for req in reqs:
        assert req.wait(timeout), f"request {req.id} never settled"
    return [req.response for req in reqs]


def _serve_cli(args, lines, monkeypatch, capsys):
    """One in-process ``serve --stdio`` session; returns stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(line + "\n" for line in lines)))
    assert port_main(["serve", "--stdio", "--device", "cpu", "--quiet",
                      "--no-response-cache", *args]) == 0
    return capsys.readouterr().out


def _lines(texts, op="sentiment"):
    return [json.dumps({"id": i, "op": op, "text": t})
            for i, t in enumerate(texts)]


def test_resolve_replicas_and_tp(monkeypatch):
    assert resolve_replicas(None) == 1
    assert resolve_replicas(3) == 3
    monkeypatch.setenv("MUSICAAL_SERVE_REPLICAS", "4")
    assert resolve_replicas(None) == 4
    monkeypatch.setenv("MUSICAAL_SERVE_REPLICAS", "junk")
    assert resolve_replicas(None) == 1
    with pytest.raises(ValueError):
        resolve_replicas("junk")
    with pytest.raises(ValueError):
        resolve_replicas(0)
    assert resolve_tp(None) == 1
    monkeypatch.setenv("MUSICAAL_SERVE_TP", "2")
    assert resolve_tp(None) == 2


def test_replica_cmd_runs_the_port_on_the_routers_device():
    cmd = _replica_cmd("/tmp/r.sock", "mock", True, None, 1, None, None,
                       None, None, None, 16, None, None, True, device="cuda")
    assert cmd[1:4] == ["-m", "music_analyst_tpu_torch", "serve"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert "--no-telemetry" in cmd and "--mock" in cmd


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two mock worker processes behind one router (shared by the
    read-only tests; the kill test spawns its own)."""
    with _time_limit(120):
        base = tmp_path_factory.mktemp("fleet")
        handles = spawn_replicas(2, str(base), model="mock", mock=True,
                                 warmup=False, device="cpu")
        router = ReplicaRouter(handles, poll_interval_s=0.1).start()
    yield router, handles
    with _time_limit(60):
        router.drain()


def test_dispatch_balance_and_zero_loss(fleet):
    router, _ = fleet
    reqs = [router.submit(i, "sentiment", TEXTS[i % len(TEXTS)])
            for i in range(16)]
    responses = _settle(reqs)
    assert all(r.get("ok") for r in responses), responses
    stats = router.stats()
    per_replica = {n: s["dispatched"] for n, s in stats["replicas"].items()}
    assert all(n > 0 for n in per_replica.values()), per_replica
    assert stats["admitted"] >= 16
    assert router_stats()["replica_count"] == 2
    assert all(s["pid"] for s in stats["replicas"].values())


def test_cross_replica_determinism(fleet):
    from music_analyst_tpu_torch.engines.sentiment import get_backend

    router, _ = fleet
    expected = get_backend("mock", mock=True,
                           device="cpu").classify_batch(TEXTS)
    for rnd in range(2):
        reqs = [router.submit(f"det{rnd}-{i}", "sentiment", text)
                for i, text in enumerate(TEXTS)]
        assert [r["label"] for r in _settle(reqs)] == expected


def test_wordcount_op_routes_and_matches_contract(fleet):
    router, _ = fleet
    (resp,) = _settle([router.submit("wc", "wordcount", "hello hello world")])
    assert resp["ok"] and resp["counts"] == {"hello": 2, "world": 1}


def test_bad_op_fails_at_the_router_edge(fleet):
    router, _ = fleet
    req = router.submit("bad", "no-such-op", "text")
    assert req.done
    assert req.response["error"]["kind"] == "bad_request"


def test_injected_dispatch_fault_absorbed_in_place(fleet):
    """``router.dispatch:error@1`` trips once and the shared RetryPolicy
    absorbs it against the same replica — no health transition."""
    from music_analyst_tpu_torch.resilience.faults import (
        configure_faults,
        fault_stats,
    )

    router, _ = fleet
    before = len(router.stats()["health_transitions"])
    configure_faults("router.dispatch:error@1")
    try:
        responses = _settle([router.submit(f"fault-{i}", "sentiment",
                                           "happy text") for i in range(4)])
        trips = fault_stats()["router.dispatch"]["trips"]
    finally:
        configure_faults(None)
    assert all(r.get("ok") for r in responses), responses
    assert trips == 1
    assert len(router.stats()["health_transitions"]) == before


def test_server_fronts_router_with_manifest_section(fleet):
    """A stock SentimentServer with the router in the batcher seat:
    in-order NDJSON replies, and stats_snapshot carries the fleet view
    (the manifest's ``serving.router`` section)."""
    from music_analyst_tpu_torch.serving.server import (
        SentimentServer,
        serving_stats,
    )

    router, _ = fleet
    server = SentimentServer(router, mode="stdio",
                             decode=_RouterDecode(router), router=router)
    lines = "\n".join([
        json.dumps({"id": "a", "op": "sentiment", "text": TEXTS[0]}),
        json.dumps({"id": "b", "op": "wordcount", "text": "la la la"}),
        json.dumps({"id": "c", "op": "ping"}),
    ]) + "\n"
    out = io.StringIO()
    assert server.handle_stream(io.StringIO(lines), out) == 3
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in replies] == ["a", "b", "c"]
    assert all(r["ok"] for r in replies)
    snapshot = server.stats_snapshot()
    assert snapshot["router"]["replica_count"] == 2
    assert "replica-0" in snapshot["router"]["replicas"]
    assert snapshot["router"]["dispatched"] >= 2
    assert serving_stats()["router"]["replica_count"] == 2


def test_kill_replica_under_load_loses_nothing(tmp_path):
    """SIGKILL one of two replicas with requests in flight: its pending
    requests requeue to the survivor, every admitted request is answered,
    and the health transition is recorded."""
    handles = spawn_replicas(2, str(tmp_path), model="mock", mock=True,
                             warmup=False, device="cpu")
    router = ReplicaRouter(handles, poll_interval_s=0.05,
                           respawn=False).start()
    try:
        first = [router.submit(i, "sentiment", TEXTS[i % len(TEXTS)])
                 for i in range(4)]
        os.kill(handles[0].proc.pid, signal.SIGKILL)
        second = [router.submit(100 + i, "sentiment", TEXTS[i % len(TEXTS)])
                  for i in range(8)]
        responses = _settle(first + second, timeout=60.0)
        assert all(r.get("ok") for r in responses), responses
        transitions = router.stats()["health_transitions"]
        assert transitions and transitions[0]["replica"] == "replica-0"
        assert transitions[0]["to"] in ("unhealthy", "dead")
        assert transitions[0]["kind"] == "tunnel_dead"
        deadline = time.monotonic() + 5.0
        while handles[0].health != "dead" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert handles[0].health == "dead"
        assert handles[1].health == "healthy"
    finally:
        router.drain()


def test_all_replicas_dead_fails_structurally(tmp_path):
    handle = ReplicaHandle("replica-0", str(tmp_path / "never.sock"))
    handle.health = "dead"
    router = ReplicaRouter([handle], max_queue=4).start()
    try:
        req = router.submit("r1", "sentiment", "text")
        assert req.wait(10.0)
        assert req.response["error"]["kind"] == "replica_lost"
    finally:
        router.drain()


def test_queue_full_shed_carries_retry_after(tmp_path):
    handle = ReplicaHandle("replica-0", str(tmp_path / "never.sock"))
    router = ReplicaRouter([handle], max_queue=1)  # dispatch NOT started
    router.submit("q1", "sentiment", "fills the queue")
    shed = router.submit("q2", "sentiment", "bounced")
    assert shed.done
    error = shed.response["error"]
    assert error["kind"] == "queue_full" and error["retry_after_ms"] >= 1.0
    assert router.stats()["shed"] == 1
    assert router.stats()["retry_after_ms_last"] == error["retry_after_ms"]


def test_router_stall_taxonomy_and_classification():
    from music_analyst_tpu_torch.observability.report import classify_error
    from music_analyst_tpu_torch.observability.watchdog import TAXONOMY
    from music_analyst_tpu_torch.resilience.faults import SITES

    assert TAXONOMY["router"] == "router_stall"
    assert "router.dispatch" in SITES
    assert classify_error("replica lost (tunnel_dead)") == "router_stall"
    assert classify_error("router.dispatch gave up") == "router_stall"


def test_cuda_worker_without_a_card_fails_the_spawn(tmp_path, monkeypatch):
    """A worker told to use CUDA on a machine without it exits non-zero
    and the spawn fails; it never serves from the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the worker would start")
    with pytest.raises(RuntimeError, match="exited rc="):
        spawn_replicas(1, str(tmp_path), model="mock", mock=True,
                       warmup=False, device="cuda")


def test_cli_replicas_needs_the_requested_device(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_main(["serve", "--stdio", "--mock", "--replicas", "2"])


# ------------------------------------------------------------- parity


def test_fleet_replies_byte_identical_to_one_server_and_jax(
        tmp_path, monkeypatch, capsys):
    """``serve --replicas 2 --mock``: the port fleet's reply bytes equal
    one port server's and the JAX fleet's on the same lines."""
    import subprocess

    lines = (_lines(TEXTS) + _lines(["hello hello world", ""], "wordcount")
             + ["{not json", json.dumps({"id": "p", "op": "ping"})])
    fleet = _serve_cli(["--mock", "--replicas", "2"], lines, monkeypatch,
                       capsys)
    single = _serve_cli(["--mock"], lines, monkeypatch, capsys)
    jax_fleet = subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu", "serve", "--stdio",
         "--mock", "--replicas", "2", "--quiet", "--no-response-cache"],
        input="".join(line + "\n" for line in lines), capture_output=True,
        text=True, timeout=150, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jax_fleet.returncode == 0, jax_fleet.stderr[-2000:]
    assert fleet == single
    assert fleet == jax_fleet.stdout
    assert len(fleet.splitlines()) == len(lines)


def test_llama_fleet_generates_the_single_servers_text(monkeypatch, capsys):
    """``serve --replicas 2 --model llama3-tiny`` (the CLI's bf16 model on
    the CPU) generates the single server's text byte for byte."""
    prompts = ["golden sunshine on the river", "rain",
               "shadows fall across the empty street tonight", "ok",
               "la la la la", "cry me a river"]
    lines = [json.dumps({"id": f"g{i}", "op": "generate", "text": p,
                         "max_new_tokens": 3 + 2 * i})
             for i, p in enumerate(prompts)]
    fleet = _serve_cli(["--model", "llama3-tiny", "--replicas", "2"], lines,
                       monkeypatch, capsys)
    single = _serve_cli(["--model", "llama3-tiny"], lines, monkeypatch,
                        capsys)
    replies = [json.loads(line) for line in fleet.splitlines()]
    assert [r["id"] for r in replies] == [f"g{i}" for i in range(6)]
    assert all(r["ok"] for r in replies)
    assert fleet == single


def test_f32_llama_fleet_generates_the_single_servers_text(tmp_path):
    """Two tiny-Llama (f32) servers on unix sockets behind the router —
    externally managed workers, each with its own continuous scheduler —
    generate the text one such server generates alone."""
    from music_analyst_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaZeroShotClassifier,
    )
    from music_analyst_tpu_torch.serving.batcher import DynamicBatcher
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )
    from music_analyst_tpu_torch.serving.server import (
        SentimentServer,
        build_ops,
    )

    def make_server():
        clf = LlamaZeroShotClassifier(
            config=LlamaConfig.tiny(dtype="float32"), max_prompt_len=64,
            seed=0, device="cpu")
        decode = ContinuousScheduler(clf, n_slots=2, prefill_chunk=16,
                                     max_new_tokens=16).start()
        batcher = DynamicBatcher(build_ops(clf), max_batch=4).start()
        return SentimentServer(batcher, mode="unix", decode=decode)

    prompts = ["golden sunshine on the river", "rain", "ok",
               "shadows fall across the empty street tonight"]
    lines = [json.dumps({"id": f"g{i}", "op": "generate", "text": p,
                         "max_new_tokens": 4 + 3 * i})
             for i, p in enumerate(prompts)]
    single = make_server()
    out = io.StringIO()
    single.handle_stream(io.StringIO("".join(l + "\n" for l in lines)), out,
                         drain_on_eof=True)

    servers, threads, handles = [], [], []
    for i in range(2):
        server = make_server()
        path = str(tmp_path / f"w{i}.sock")
        thread = threading.Thread(target=server.serve_unix, args=(path,),
                                  daemon=True)
        thread.start()
        servers.append(server)
        threads.append(thread)
        handles.append(ReplicaHandle(f"replica-{i}", path))
    for handle in handles:
        handle.connect(timeout_s=30.0)
    router = ReplicaRouter(handles, poll_interval_s=0.1).start()
    try:
        front = SentimentServer(router, mode="stdio",
                                decode=_RouterDecode(router), router=router)
        fleet_out = io.StringIO()
        front.handle_stream(io.StringIO("".join(l + "\n" for l in lines)),
                            fleet_out)
    finally:
        router.drain()
        for server in servers:
            server.request_drain("test done", record=False)
        for thread in threads:
            thread.join(timeout=30.0)
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    got = [json.loads(line) for line in fleet_out.getvalue().splitlines()]
    assert all(r["ok"] for r in want)
    assert fleet_out.getvalue() == out.getvalue(), (got, want)
    assert sum(h.dispatched for h in handles) == len(prompts)


def test_router_manifest_records_a_killed_worker(tmp_path):
    """``serve --replicas 2 --telemetry-dir`` as a process: a worker
    killed mid-session shows up in the manifest's ``serving.router`` as a
    health transition while every request is still answered, and the
    surviving worker's closing counters (its own kernel launches) are
    there too."""
    import subprocess

    tel_dir = tmp_path / "tel"
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--device", "cpu", "--mock", "--replicas", "2",
         "--no-response-cache", "--telemetry-dir", str(tel_dir)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        def send(lines):
            proc.stdin.write("".join(line + "\n" for line in lines))
            proc.stdin.flush()
            return [json.loads(proc.stdout.readline()) for _ in lines]

        first = send(_lines(TEXTS))
        (stats,) = send([json.dumps({"id": "s", "op": "stats"})])
        pid = stats["stats"]["router"]["replicas"]["replica-0"]["pid"]
        os.kill(pid, signal.SIGKILL)
        later = send([json.dumps({"id": f"k{i}", "op": "sentiment",
                                  "text": t})
                      for i, t in enumerate(TEXTS * 4)])
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    replies = first + later
    assert all(r["ok"] for r in replies), [r for r in replies
                                           if not r["ok"]][:3]
    manifest = json.loads((tel_dir / "run_manifest.json").read_text())
    assert manifest["engine"] == "serve"
    router = manifest["serving"]["router"]
    assert router["replica_count"] == 2
    assert any(t["replica"] == "replica-0" and t["to"] in ("unhealthy",
                                                           "dead")
               for t in router["health_transitions"])
    survivor = router["replicas"]["replica-1"]
    assert survivor["health"] == "healthy"
    assert survivor["last_stats"]["kernel_launches"] == {
        "flash_attention": 0, "keyword_scan": 0, "paged_attention": 0}
