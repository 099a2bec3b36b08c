"""Port Ollama backend ≡ the JAX package's, against a stub server.

A ``http.server`` stub on 127.0.0.1 answers ``POST /api/generate`` the
way Ollama does (``{"response": ...}``), labelling by the lyric it finds
in the prompt, and can fail a request with a chosen status first.
Checks: labels and the measured ``latency_seconds`` column, 5xx retried,
4xx not, an empty lyric ``Neutral`` at 0.0 without a request, and
``run_sentiment``'s two files byte-identical to JAX's with both clocks
replaced by the same fake one.  Tolerance: none (exact).
"""

import http.server
import json
import threading

import pytest

pytest.importorskip("requests")

from music_analyst_tpu.engines.sentiment import run_sentiment as jax_run  # noqa: E402
from music_analyst_tpu.models import ollama as jo  # noqa: E402
from music_analyst_tpu_torch.engines.sentiment import (  # noqa: E402
    get_backend,
    run_sentiment,
)
from music_analyst_tpu_torch.models import ollama as to  # noqa: E402
from music_analyst_tpu_torch.models.llama import (  # noqa: E402
    LYRICS_TRUNCATION,
    PROMPT_TEMPLATE,
)


class _Stub(http.server.BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 - http.server's name
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        state = self.server.state
        state["requests"].append(body)
        if state["fail"]:
            status = state["fail"].pop(0)
            self.send_response(status)
            self.end_headers()
            self.wfile.write(b"{}")
            return
        prompt = body["prompt"]
        if "sun" in prompt:
            text = "positive because of the sun"
        elif "rain" in prompt:
            text = "  Negative\n"
        elif "silence" in prompt:
            text = ""
        else:
            text = "Neutral."
        payload = json.dumps({"model": body["model"], "response": text})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(payload.encode())

    def log_message(self, *args):
        pass


@pytest.fixture
def stub(monkeypatch):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    server.state = {"requests": [], "fail": []}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    endpoint = f"http://127.0.0.1:{server.server_address[1]}"
    monkeypatch.setenv("OLLAMA_ENDPOINT", endpoint)
    try:
        yield server.state
    finally:
        server.shutdown()
        server.server_close()


class _FakeClock:
    """``perf_counter`` advancing 0.25 s a call: each request measures
    exactly 0.25 s."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


SONGS = [("A", "s1", "sun on my face"), ("B", "s2", "rain again"),
         ("C", "s3", "   "), ("D", "s4", "silence " * 3000),
         ("E", "s5", "la la")]


def test_labels_prompt_and_measured_latency(stub, monkeypatch):
    monkeypatch.setattr(to, "time", _FakeClock())
    clf = get_backend("ollama:phi3", device="cpu")
    assert clf.model == "phi3" and clf.timeout == 120.0
    labels = clf.classify_batch([t for _, _, t in SONGS])
    assert labels == ["Positive", "Negative", "Neutral", "Neutral", "Neutral"]
    assert clf.last_latencies == [0.25, 0.25, 0.0, 0.25, 0.25]
    reqs = stub["requests"]
    assert len(reqs) == 4  # the empty lyric sends nothing
    assert reqs[0] == {"model": "phi3", "stream": False,
                       "prompt": PROMPT_TEMPLATE.format(lyrics="sun on my face")}
    long_lyric = SONGS[3][2].strip()[:LYRICS_TRUNCATION]
    assert reqs[2]["prompt"] == PROMPT_TEMPLATE.format(lyrics=long_lyric)
    assert get_backend("ollama", device="cpu").model == "llama3"


def test_5xx_is_retried_and_4xx_is_not(stub):
    import requests

    clf = to.OllamaClassifier(retries=2, backoff_seconds=0.0)
    stub["fail"] = [503, 500]
    assert clf.classify_batch(["sun"]) == ["Positive"]
    assert len(stub["requests"]) == 3
    stub["requests"].clear()
    stub["fail"] = [429]
    assert clf.classify_batch(["rain"]) == ["Negative"]
    assert len(stub["requests"]) == 2
    stub["requests"].clear()
    stub["fail"] = [400]
    with pytest.raises(requests.HTTPError):
        clf.classify_batch(["sun"])
    assert len(stub["requests"]) == 1
    stub["requests"].clear()
    stub["fail"] = [502, 502, 502]
    with pytest.raises(requests.HTTPError):
        clf.classify_batch(["sun"])
    assert len(stub["requests"]) == 3


def test_retry_count_resolution(monkeypatch):
    from music_analyst_tpu_torch.resilience.policy import (
        RetryPolicy,
        classify_retryable,
        resolve_http_retries,
    )

    monkeypatch.setenv("MUSICAAL_HTTP_RETRIES", "5")
    assert resolve_http_retries() == 5
    assert resolve_http_retries(1) == 1
    monkeypatch.setenv("MUSICAAL_HTTP_RETRIES", "x")
    with pytest.raises(ValueError, match="MUSICAAL_HTTP_RETRIES"):
        resolve_http_retries()
    with pytest.raises(ValueError, match=">= 0"):
        resolve_http_retries(-1)
    # Full jitter under the cap.
    policy = RetryPolicy(retries=3, base_s=1.0, cap_s=1.5)
    assert all(0 <= policy.backoff_s(k) <= min(1.5, 2 ** (k - 1))
               for k in range(1, 6) for _ in range(20))
    for exc, verdict in ((TimeoutError(), True), (ConnectionError(), True),
                         (OSError("reset"), True),
                         (FileNotFoundError("x"), False),
                         (ValueError("bad"), False),
                         (RuntimeError("request timed out"), True)):
        assert classify_retryable(exc)[0] is verdict, exc


def test_run_sentiment_files_equal_jax(stub, tmp_path, monkeypatch):
    monkeypatch.setattr(jo, "time", _FakeClock())
    monkeypatch.setattr(to, "time", _FakeClock())
    jax_run("unused.csv", backend=jo.OllamaClassifier(), songs=SONGS,
            output_dir=str(tmp_path / "jax"), quiet=True, batch_size=2)
    run_sentiment("unused.csv", backend=to.OllamaClassifier(), songs=SONGS,
                  output_dir=str(tmp_path / "port"), quiet=True, batch_size=2)
    for name in ("sentiment_totals.json", "sentiment_details.csv"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    details = (tmp_path / "port" / "sentiment_details.csv").read_text()
    assert "A,s1,Positive,0.2500" in details
    assert "C,s3,Neutral,0.0000" in details


def test_cli_runs_ollama(stub, fixture_csv, tmp_path):
    from music_analyst_tpu_torch.cli.main import main

    assert main(["sentiment", str(fixture_csv), "--model", "ollama:llama3",
                 "--device", "cpu", "--output-dir", str(tmp_path)]) == 0
    totals = json.loads((tmp_path / "sentiment_totals.json").read_text())
    assert sum(totals.values()) == 8
    assert stub["requests"]
