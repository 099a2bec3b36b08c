"""``serve --tp N`` on ranks ≡ JAX's server on its ``serve_mesh(N)``.

JAX serves a tensor-parallel model from one process over its 8-device
CPU mesh (``tests/conftest.py``); the port runs the same server as N gloo
ranks (``tests/torch_ranks.py``), rank 0 serving and the others replaying
its dispatch stream (``serving/tp_dispatch.py``).  Weights are carried
from JAX with ``params_from_jax`` in float32, where the tp all-reduces
are exact at these widths, so greedy text must be byte-identical:

* 2 ranks — the tiny GQA Llama (8 / 4 heads) served through
  ``run_server`` with more ``generate`` requests than slots, their
  prompts sharing prefixes (the followers replay ``copy_page``; warm-up
  replays ``free_pages``), plus score-mode ``sentiment`` requests: replies
  equal JAX's ``run_server`` at ``tp=2`` and the port's at ``tp=1``; a
  priority-5 admit preempting a decode through the stream (paged: pinned
  rows; slots: ``snapshot_slot`` / ``restore_slot`` on every rank), text
  equal to JAX's tp 2 greedy; the tiny DistilBERT's ``sentiment``
  replies equal JAX's over a tp 2 mesh;
* 4 ranks — the same Llama, one KV head a rank, served.

Then the CLI as processes: ``serve --stdio --tp 2`` against ``--tp 1``, a
server idle past its group timeout, a follower killed mid-stream, rank 0
killed outright, ``--tp 2`` behind the replica router, and ``--tp 2
--mock`` in one process.
"""

import dataclasses
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.serving import server as js
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.serving import server as ts
from tests.torch_ranks import launch_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
LLAMA_CFG = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8,
                 n_kv_heads=4, hidden_dim=256, rope_theta=1e4,
                 max_seq_len=128, dtype="float32")
# Four prefixes: the first four prompts fill the slots; the later ones
# share 2+ pages of a finished prompt's prefix (page 16), the last page
# partly, so their admission copies it (copy_page).
_STEMS = ["the long road home winds past the ", "golden sunshine on the ",
          "shadows fall across the empty street ", "la la la la la la la "]
_ENDS = ["silver lake", "river", "tonight", "la", "golden field",
         "morning sea", "quiet town", "hills"]
GEN_PROMPTS = [_STEMS[i % 4] + _ENDS[i % 8] for i in range(10)]
SENTIMENT_TEXTS = ["love and sunshine all day",
                   "tears and pain in the lonely night", "",
                   "cry me a river of joy"]
SERVE = dict(slots=4, prefill_chunk=16, max_new_tokens=8, max_batch=4,
             max_wait_ms=2.0)
TP4_SERVE = dict(slots=2, prefill_chunk=16, max_new_tokens=6, max_batch=4,
                 max_wait_ms=2.0)
PREEMPT_LOW, PREEMPT_HIGH = GEN_PROMPTS[:2], GEN_PROMPTS[5]


def _generate_lines(prompts, budget):
    return [json.dumps({"id": f"g{i}", "op": "generate", "text": p,
                        "max_new_tokens": budget})
            for i, p in enumerate(prompts)]


def _sentiment_lines(texts):
    return [json.dumps({"id": f"s{i}", "text": t})
            for i, t in enumerate(texts)]


LLAMA_LINES = (_generate_lines(GEN_PROMPTS, 8)
               + _sentiment_lines(SENTIMENT_TEXTS))
TP4_LINES = _generate_lines(GEN_PROMPTS[:6], 6)
BERT_LINES = _sentiment_lines(SENTIMENT_TEXTS + ["la la la " * 40, "ok"])


def _save(tree, port_mod, path):
    state = port_mod.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    np.savez(path, **state)
    return path


def _in_process(run, lines, monkeypatch, capsys, **kw):
    """Replies of one package's ``run_server`` over ``lines`` on stdio."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(line + "\n" for line in lines)))
    assert run(stdio=True, quiet=True, use_response_cache=False, **kw) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _jax_mesh(n):
    from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec((("tp", n),)), devices=jax.devices()[:n])


# Each rank: the server (rank 0, run_server over stdin lines) or its
# follower (run_follower), on a classifier built on the rank's tp mesh.
_CHILD = r"""
import contextlib, io, json, sys
import numpy as np, torch
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
llama_w, bert_w, spec = sys.argv[4], sys.argv[5], json.loads(sys.argv[6])
torch.set_num_threads(1)
from music_analyst_tpu_torch.models import distilbert as td, llama as tl
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.serving import server as ts, tp_dispatch as TD
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
mesh = M.build_mesh(M.MeshSpec((("tp", n),)), device="cpu")
out = {}

def serve(clf, lines, kw):
    if rank:
        return {"follower": ts.run_follower(backend=clf, tp=n, device="cpu")}
    sys.stdin = io.StringIO("".join(line + "\n" for line in lines))
    replies, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(replies), contextlib.redirect_stderr(err):
        code = ts.run_server(backend=clf, stdio=True, tp=n, device="cpu",
                             use_response_cache=False, **kw)
    stream = [json.loads(line.split("serve: tp stream ", 1)[1])
              for line in err.getvalue().splitlines()
              if line.startswith("serve: tp stream ")]
    return {"code": code, "stream": stream[0],
            "replies": [json.loads(l) for l in replies.getvalue().splitlines()]}

llama = tl.LlamaZeroShotClassifier(
    config=tl.LlamaConfig(**spec["cfg"]), max_prompt_len=64,
    state_dict=dict(np.load(llama_w)), mesh=mesh)
out["served"] = serve(llama, spec["lines"], spec["serve"])
if "preempt" in spec:
    # A priority-5 admit preempts a priority-1 decode, every device call
    # through the stream (the scheduler ticked by hand, as JAX's test does).
    if rank:
        out["preempt"] = TD.follow({"backend": llama}, device="cpu")
    else:
        stream = TD.DispatchStream({"backend": llama})
        backend = stream.remote(llama, TD.BACKEND_METHODS)
        low, high = spec["preempt"]
        for page in (16, 0):
            sched = ContinuousScheduler(
                backend, n_slots=2, prefill_chunk=16, prompt_region=64,
                max_new_tokens=8, ttft_slo_ms=1.0, page_size=page,
                kv_pages=24 if page else None)
            sched.warmup()
            reqs = [sched.submit(i, p, priority=1, deadline_ms=60_000.0)
                    for i, p in enumerate(low)]
            for _ in range(64):
                sched._tick()
                if any(s is not None and s.active and s.steps > 0
                       for s in sched._slots):
                    break
            reqs.append(sched.submit("hi", high, priority=5,
                                     deadline_ms=60_000.0))
            for _ in range(64):
                if sched.stats()["preemptions"] >= 1:
                    break
                sched._tick()
            sched.run_until_idle()
            st = sched.stats()
            out[f"preempt-{page}"] = dict(
                texts=[r.response.get("text") for r in reqs],
                preemptions=st["preemptions"], resumed=st["resumed_o1"])
        stream.close()
        out["preempt"] = stream.stats()
if "bert" in spec:
    bert = td.DistilBertClassifier(
        config=td.DistilBertConfig.tiny(dtype="float32"), max_len=64,
        state_dict=dict(np.load(bert_w)), mesh=mesh)
    out["bert"] = serve(bert, spec["bert"], dict(max_batch=4,
                                                max_wait_ms=2.0))
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("weights")
    jc = jl.LlamaZeroShotClassifier(config=jl.LlamaConfig(**LLAMA_CFG),
                                    max_prompt_len=64, seed=11)
    bert_cfg = dataclasses.replace(jd.DistilBertConfig.tiny(),
                                   dtype="float32")
    jb = jd.DistilBertClassifier(config=bert_cfg, max_len=64, seed=6)
    return dict(llama=_save(jc.params, tl, tmp / "llama.npz"),
                bert=_save(jb.params, td, tmp / "bert.npz"),
                jax_llama=jc, bert_cfg=bert_cfg)


def _ranks(n, weights, spec, workdir):
    outs = launch_ranks(_CHILD, n, [weights["llama"], weights["bert"],
                                    json.dumps(spec)], workdir, timeout=300)
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for follower in results[1:]:
        assert follower["served"] == {"follower": 0}
    return results[0]


@pytest.fixture(scope="module")
def tp2(weights, tmp_path_factory):
    spec = dict(cfg=LLAMA_CFG, lines=LLAMA_LINES, serve=SERVE,
                preempt=[PREEMPT_LOW, PREEMPT_HIGH], bert=BERT_LINES)
    return _ranks(2, weights, spec, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def tp4(weights, tmp_path_factory):
    spec = dict(cfg=LLAMA_CFG, lines=TP4_LINES, serve=TP4_SERVE)
    return _ranks(4, weights, spec, tmp_path_factory.mktemp("tp4"))


@pytest.fixture(scope="module")
def jax_tp2_llama():
    return jl.LlamaZeroShotClassifier(config=jl.LlamaConfig(**LLAMA_CFG),
                                      max_prompt_len=64, seed=11,
                                      mesh=_jax_mesh(2))


def _jax_served(clf, lines, tp, monkeypatch, capsys, **kw):
    return _in_process(js.run_server, lines, monkeypatch, capsys,
                       backend=clf, tp=tp, **kw)


@pytest.mark.parametrize("width", [2, 4])
def test_served_llama_equals_jax_serve_mesh(width, weights, tp2, tp4,
                                            monkeypatch, capsys):
    """Every reply of the port's server on ``width`` ranks equals JAX's
    ``run_server`` at ``tp=width`` (its ``serve_mesh``), byte for byte."""
    port, lines, kw = ((tp2, LLAMA_LINES, SERVE) if width == 2
                       else (tp4, TP4_LINES, TP4_SERVE))
    jax_clf = jl.LlamaZeroShotClassifier(
        config=jl.LlamaConfig(**LLAMA_CFG), max_prompt_len=64, seed=11,
        mesh=_jax_mesh(width))
    want = _jax_served(jax_clf, lines, width, monkeypatch, capsys, **kw)
    served = port["served"]
    assert served["code"] == 0
    assert served["replies"] == want
    assert all(r["ok"] for r in want) and len(want) == len(lines)


@pytest.mark.parametrize("width", [2, 4])
def test_served_llama_equals_port_tp1(width, weights, tp2, tp4,
                                      monkeypatch, capsys):
    """The replies at ``--tp width`` equal the port's one-rank server's."""
    port, lines, kw = ((tp2, LLAMA_LINES, SERVE) if width == 2
                       else (tp4, TP4_LINES, TP4_SERVE))
    clf = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig(**LLAMA_CFG), max_prompt_len=64,
        state_dict=dict(np.load(weights["llama"])), device="cpu")
    want = _in_process(ts.run_server, lines, monkeypatch, capsys,
                       backend=clf, device="cpu", **kw)
    assert port["served"]["replies"] == want


@pytest.mark.parametrize("method", ["copy_page", "free_pages", "upload",
                                    "decode_step", "prefill_chunk",
                                    "classify_batch", "warmup", "acquire"])
def test_followers_replay_every_device_call(tp2, method):
    """The followers replayed the calls that look host-only too: the
    prefix copies of the shared prompts and warm-up's pool-wide free; no
    device tensor crossed the stream by value."""
    stream = tp2["served"]["stream"]
    assert stream["by_method"].get(method, 0) >= 1
    assert stream["shipped_device_bytes"] == 0


@pytest.mark.parametrize("page", [16, 0], ids=["paged", "slots"])
def test_preempted_text_equals_jax(tp2, jax_tp2_llama, page):
    """A preemption through the stream (paged: the victim's pinned row;
    slots: ``snapshot_slot`` / ``restore_slot`` on every rank) keeps every
    text equal to JAX's tp 2 greedy text."""
    got = tp2[f"preempt-{page}"]
    assert got["preemptions"] >= 1 and got["resumed"] >= 1
    want = jax_tp2_llama.generate_batch(PREEMPT_LOW + [PREEMPT_HIGH],
                                        max_new_tokens=8)
    assert got["texts"] == want
    if page == 0:
        methods = tp2["preempt"]["by_method"]
        assert methods["snapshot_slot"] >= 1 and methods["restore_slot"] >= 1


def test_served_distilbert_equals_jax_serve_mesh(weights, tp2, monkeypatch,
                                                 capsys):
    """Tiny DistilBERT ``sentiment`` replies at tp 2 equal JAX's server
    over a tp 2 mesh.  JAX's own ``serve_mesh(2)`` (a ``tp`` axis alone)
    cannot host its DistilBERT, which shards the batch over ``dp``
    (``ValueError: Resource axis: dp ... not found``), so the reference
    runs on ``dp 1 x tp 2``: the same two weight shards."""
    from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec((("dp", 1), ("tp", 2))),
                      devices=jax.devices()[:2])
    jax_clf = jd.DistilBertClassifier(config=weights["bert_cfg"], max_len=64,
                                      seed=6, mesh=mesh)
    want = _jax_served(jax_clf, BERT_LINES, 2, monkeypatch, capsys,
                       max_batch=4, max_wait_ms=2.0)
    assert tp2["bert"]["code"] == 0
    assert tp2["bert"]["replies"] == want
    assert tp2["bert"]["stream"]["by_method"]["classify_batch"] >= 2


# ------------------------------------------------------------ the CLI


def _cli(*flags):
    return [sys.executable, "-m", "music_analyst_tpu_torch", "serve",
            "--stdio", "--device", "cpu", "--no-response-cache",
            "--no-telemetry", *flags]


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _serve_cli(flags, lines, timeout=240, **env):
    proc = subprocess.run(
        _cli(*flags), input="".join(line + "\n" for line in lines),
        capture_output=True, text=True, timeout=timeout, env=_env(**env),
        cwd=REPO)
    return proc, [json.loads(line) for line in proc.stdout.splitlines()]


CLI_LINES = (_generate_lines(GEN_PROMPTS[:6], 6)
             + _sentiment_lines(SENTIMENT_TEXTS[:2]))


@pytest.fixture(scope="module")
def cli_tp1():
    proc, replies = _serve_cli(["--model", "llama3-tiny"], CLI_LINES)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return replies


@pytest.mark.parametrize("width", [2])
def test_cli_serve_tp_equals_tp1(cli_tp1, width):
    """``serve --stdio --tp 2`` answers as ``--tp 1`` does, exits 0 on
    EOF, and names its mesh and each rank's launches on stderr."""
    proc, replies = _serve_cli(["--model", "llama3-tiny", "--tp",
                                str(width)], CLI_LINES)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert replies == cli_tp1
    assert f"mesh: {width} ranks over gloo" in proc.stderr
    for rank in range(width):
        assert f"mesh: rank {rank} kernel launches" in proc.stderr


def _popen(flags, **env):
    return subprocess.Popen(
        _cli(*flags), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(**env), cwd=REPO)


def _ask(proc, line):
    proc.stdin.write(line + "\n")
    proc.stdin.flush()
    return json.loads(proc.stdout.readline())


def _follower_pid(stderr_lines):
    for line in stderr_lines:
        if line.startswith("mesh: rank 1 pid "):
            return int(line.split()[-1])
    raise AssertionError("no follower pid on stderr")


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split(")")[-1].split()[0] == "Z"
    except OSError:
        return True


def _read_err_until(proc, mark, deadline_s=120):
    lines, t_end = [], time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line.rstrip("\n"))
        if mark in line:
            return lines
    raise AssertionError(f"{mark!r} never came: {lines[-20:]}")


@pytest.mark.parametrize("idle_s", [11.0])
def test_idle_server_outlives_group_timeout(idle_s):
    """A server idle for twice its group timeout (5 s, set through the
    launcher's environment) still answers: rank 0's no-ops keep the
    follower's wait inside its timeout."""
    proc = _popen(["--model", "llama3-tiny", "--tp", "2", "--no-warmup"],
                  MUSICAAL_DIST_TIMEOUT_S="5")
    try:
        _read_err_until(proc, "serve: ready")
        assert _ask(proc, json.dumps({"id": 0, "text": "hello"}))["ok"]
        time.sleep(idle_s)
        reply = _ask(proc, _generate_lines(["rain"], 4)[0])
        assert reply["ok"] and reply["tokens"] == 4
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert '"noops": ' in err and '"noops": 0' not in err


@pytest.mark.parametrize("victim", ["follower", "rank0"])
def test_a_killed_rank_ends_the_server(victim):
    """A follower SIGKILLed mid-stream: rank 0 exits 1 within seconds and
    writes no reply after it.  Rank 0 SIGKILLed outright (no watcher
    runs): the follower exits within 5 s (it polls its parent every
    0.2 s)."""
    proc = _popen(["--model", "llama3-tiny", "--tp", "2"])
    try:
        err = _read_err_until(proc, "serve: ready")
        follower = _follower_pid(err)
        first = _ask(proc, _generate_lines(["golden sunshine"], 4)[0])
        assert first["ok"]
        t0 = time.monotonic()
        if victim == "follower":
            os.kill(follower, signal.SIGKILL)
            for line in _generate_lines(GEN_PROMPTS, 8):
                proc.stdin.write(line + "\n")
            proc.stdin.flush()
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 1
            assert time.monotonic() - t0 < 30
            # No reply at all after the kill: a follower's shard is part
            # of every answer.
            assert out.strip() == ""
            assert "every rank stopped" in err
        else:
            proc.kill()
            proc.wait(timeout=30)
            while not _gone(follower) and time.monotonic() - t0 < 5.0:
                time.sleep(0.05)
            assert _gone(follower)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)
        if not _gone(follower):
            os.kill(follower, signal.SIGKILL)


# The CLI as it runs ``serve --tp 2``, but rank 0 starts its follower as
# this script, which makes one method of the follower's paged decode
# runtime raise from its ``nth`` call on: a call that changes the caches
# in place and holds no collective, failing on that rank alone.
_DIVERGING = r"""
import sys
from music_analyst_tpu_torch.cli import main as cli
from music_analyst_tpu_torch.parallel import launch
method, nth, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
if launch.launched_rank() is None:
    launch.module_command = lambda args: [sys.executable, __file__, method,
                                          nth, *args]
else:
    from music_analyst_tpu_torch.ops import kv_pages
    real, calls = getattr(kv_pages.PagedDecodeRuntime, method), []
    def fail(self, caches, *args):
        calls.append(args)
        if len(calls) >= int(nth):
            raise RuntimeError(f"{method} failed on this rank alone")
        return real(self, caches, *args)
    setattr(kv_pages.PagedDecodeRuntime, method, fail)
sys.exit(cli.main(argv))
"""
DIVERGE_FLAGS = ["--model", "llama3-tiny", "--slots", "4",
                 "--prefill-chunk", "16", "--max-new-tokens", "8"]
DIVERGE_LINES = _generate_lines(GEN_PROMPTS, 8)


@pytest.fixture(scope="module")
def diverge_tp1():
    proc, replies = _serve_cli(DIVERGE_FLAGS, DIVERGE_LINES)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return {r["id"]: r for r in replies}


@pytest.mark.parametrize("method,nth", [("copy_page", 2), ("free_pages", 1)])
def test_a_follower_whose_replay_fails_alone_ends_the_server(
        diverge_tp1, method, nth, tmp_path):
    """A follower whose replay of ``method`` raises while rank 0's call
    returned (warm-up runs one ``copy_page`` and one ``free_pages``, the
    served prompts that share a finished one's prefix three more copies):
    the follower stops at the next descriptor, which says that rank 0's
    call returned; rank 0 exits 1, and every reply it wrote equals
    ``--tp 1``'s."""
    script = tmp_path / "diverging.py"
    script.write_text(_DIVERGING)
    proc = subprocess.run(
        [sys.executable, str(script), method, str(nth), *_cli(
            "--tp", "2", *DIVERGE_FLAGS)[3:]],
        input="".join(line + "\n" for line in DIVERGE_LINES),
        capture_output=True, text=True, timeout=240,
        env=_env(PYTHONPATH=str(REPO)), cwd=REPO)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert f"replayed {method} raised RuntimeError" in proc.stderr
    assert (f"StreamDiverged: replayed {method} raised RuntimeError: "
            f"{method} failed on this rank alone here; on rank 0 it "
            "returned") in proc.stderr
    assert "every rank stopped" in proc.stderr
    replies = [json.loads(line) for line in proc.stdout.splitlines()]
    assert len(replies) < len(DIVERGE_LINES)
    for reply in replies:
        assert reply == diverge_tp1[reply["id"]]


@pytest.mark.parametrize("signame", ["SIGINT"])
def test_a_terminals_signal_drains_every_rank(signame):
    """A terminal's SIGINT reaches every process of the foreground group:
    the follower ignores it, rank 0 drains (the queued request answered)
    and sends ``stop``, and both exit 0."""
    proc = subprocess.Popen(
        _cli("--model", "llama3-tiny", "--tp", "2", "--no-warmup",
             "--max-wait-ms", "60000", "--max-batch", "64"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(), cwd=REPO, start_new_session=True)
    try:
        err = _read_err_until(proc, "serve: ready")
        follower = _follower_pid(err)
        proc.stdin.write(_sentiment_lines(["love love love"])[0] + "\n")
        proc.stdin.flush()
        time.sleep(1.0)
        os.killpg(proc.pid, getattr(signal, signame))
        out, rest = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, rest[-2000:]
    assert json.loads(out)["ok"]
    assert "drained (signal:SIGINT)" in rest
    assert "mesh: rank 1 kernel launches" in rest
    t_end = time.monotonic() + 10
    while not _gone(follower) and time.monotonic() < t_end:
        time.sleep(0.05)
    assert _gone(follower)


@pytest.mark.parametrize("model", ["--mock", "llama3-tiny"])
def test_router_of_tp2_workers_equals_one_replica(model):
    """``serve --replicas 2 --tp 2``: every reply equals one replica's
    (for the Llama each worker is itself two ranks)."""
    flags = ["--mock"] if model == "--mock" else ["--model", model]
    lines = (_sentiment_lines(SENTIMENT_TEXTS) if model == "--mock"
             else CLI_LINES)
    one, want = _serve_cli(flags + ["--tp", "2"], lines)
    assert one.returncode == 0, one.stderr[-2000:]
    fleet, got = _serve_cli(flags + ["--tp", "2", "--replicas", "2"], lines,
                            timeout=300)
    assert fleet.returncode == 0, fleet.stderr[-2000:]
    assert got == want


def test_tp2_mock_serves_in_one_process(tmp_path):
    """``--tp 2 --mock`` builds no mesh and starts no rank, as in JAX; the
    manifest still records ``serve_tp: 2``."""
    proc = subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--device", "cpu", "--mock", "--tp", "2", "--no-response-cache",
         "--telemetry-dir", str(tmp_path)],
        input=_sentiment_lines(["I love the sunshine"])[0] + "\n",
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["label"] == "Positive"
    assert "mesh:" not in proc.stderr
    manifest = json.loads((tmp_path / "run_manifest.json").read_text())
    assert manifest["context"]["serve_tp"] == 2


# ------------------------------------------------- the stream in one rank


class _Shard:
    """A stand-in for an object every rank holds."""

    def __init__(self):
        self.calls = []

    def make(self, n):
        self.calls.append(("make", n))
        return [torch.arange(n), {"n": n}]

    def use(self, tensor, host):
        self.calls.append(("use", tensor.shape, host.shape))
        return int(tensor.sum())


_SHARD = frozenset({"make", "use"})


@pytest.fixture
def one_rank_group(request):
    """A process group of this process alone, its timeout ``request.param``
    seconds (60 unless a test says otherwise: a no-op sent by the idle
    stream would carry the released handles a test waits for)."""
    from music_analyst_tpu_torch.parallel import multihost
    from tests.torch_ranks import free_port

    multihost.initialize(f"localhost:{free_port()}", 1, 0,
                         timeout_s=getattr(request, "param", 60.0))
    yield
    multihost.shutdown()


@pytest.mark.parametrize("case", ["handles", "by_value", "refused",
                                  "raised"])
def test_descriptor_names_results_by_handle(one_rank_group, case):
    """A tensor a dispatch returned travels as its handle and resolves to
    the follower's own object; a host array and a tensor no dispatch made
    travel by value; an object that is neither is refused before anything
    is sent; a dead result's handle rides the next descriptor; each
    descriptor says whether rank 0's previous call raised."""
    import gc

    from music_analyst_tpu_torch.serving import tp_dispatch as TD

    mine, theirs = _Shard(), _Shard()
    stream = TD.DispatchStream({"shard": mine})
    remote = stream.remote(mine, _SHARD)
    try:
        made, meta = remote.make(4)
        handle = stream._handle(made)
        assert meta == {"n": 4} and handle == (1, 0)
        table = {(1, 0): torch.full((4,), 7)}
        if case == "handles":
            payload = stream._encode(2, mine, "use", (made, np.zeros(3)), {})
            seq, released, raised, target, method, args, _ = TD._Unpickler(
                payload, {"shard": theirs}, table, None).load()
            assert (seq, raised, target, method) == (2, False, theirs, "use")
            assert args[0] is table[(1, 0)] and args[1].shape == (3,)
            del made
            gc.collect()
            payload = stream._encode(3, mine, "use", (), {})
            assert TD._Unpickler(payload, {"shard": theirs}, table,
                                 None).load()[1] == ((1, 0),)
        elif case == "by_value":
            fresh = torch.tensor([[1.5, 2.5]], dtype=torch.bfloat16)
            payload = stream._encode(2, mine, "use", (fresh,), {})
            (got,) = TD._Unpickler(payload, {"shard": theirs}, table,
                                   None).load()[5]
            assert got is not fresh and torch.equal(got, fresh)
            assert remote.use(made, np.zeros(2)) == 6
        elif case == "refused":
            with pytest.raises(TypeError, match="neither a handle"):
                remote.use(_Shard(), np.zeros(1))
            assert stream.stats()["dispatches"] == 1
        else:
            def raised():
                payload = stream._encode(9, mine, "use", (), {})
                return TD._Unpickler(payload, {"shard": theirs}, table,
                                     None).load()[2]

            assert raised() is False
            with pytest.raises(AttributeError):
                remote.use(made, None)
            assert raised() is True
            assert remote.use(made, np.zeros(2)) == 6
            assert raised() is False
    finally:
        stream.close()
    assert stream.stats()["shipped_device_bytes"] == 0


@pytest.mark.parametrize("one_rank_group", [0.8], indirect=True)
def test_idle_stream_sends_noops_and_stop(one_rank_group):
    """Idle for longer than its group timeout (0.8 s), the stream sends a
    no-op every quarter of it; ``close`` sends ``stop`` once."""
    from music_analyst_tpu_torch.serving import tp_dispatch as TD

    stream = TD.DispatchStream({"shard": _Shard()})
    time.sleep(1.2)
    stream.close()
    stream.close()
    assert stream.heartbeat_s == pytest.approx(0.2)
    assert stream.stats()["noops"] >= 2
    with pytest.raises(RuntimeError, match="closed"):
        stream.call(stream._roots["shard"], "make", 1)
