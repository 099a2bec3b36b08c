"""Port continuous paged generation ≡ the JAX package's, end to end.

Weights are carried from the JAX tiny classifier (float32) with
``params_from_jax``.  Greedy text through the port's continuous scheduler
(paged KV, 2 and 4 slots, prefix cache on and off, slots reused by more
prompts than slots, per-request budgets, int8 pages) must equal the JAX
static ``generate_batch`` byte for byte, as the JAX package's own
continuous path does: on the CPU both sides keep dense attention's
reduction order over the gathered view and the static path's softmax
width.  ``run_sentiment`` with the port backend gives the JAX backend's
totals and labels in score and generate modes, and the CLI runs the tiny
Llama on the CPU.
"""

import csv
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.engines.sentiment import run_sentiment as jax_run
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.cli.main import main as cli_main
from music_analyst_tpu_torch.engines.sentiment import run_sentiment
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

torch.set_num_threads(1)

SHARED = "the quick brown fox jumps over the lazy dog and then "
PROMPTS = [SHARED + tail for tail in ("runs away", "naps", "eats a pie")] + [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "ok",
]


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32")
    jc = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64)
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jc.params))
    tc = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(dtype="float32"), max_prompt_len=64,
        device="cpu", state_dict=sd)
    return jc, tc


@pytest.fixture(scope="module")
def static_text(pair):
    jc, _ = pair
    return jc.generate_batch(PROMPTS, max_new_tokens=8)


def _run(sched, prompts, budgets=None):
    budgets = budgets or [sched.plan.max_new] * len(prompts)
    reqs = [sched.submit(i, p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    sched.run_until_idle()
    out = []
    for req in reqs:
        assert req.response["ok"], req.response
        out.append(req.response["text"])
    return out


def _scheduler(tc, **kwargs):
    kwargs.setdefault("prefill_chunk", 16)
    kwargs.setdefault("prompt_region", 64)
    kwargs.setdefault("max_new_tokens", 8)
    return ContinuousScheduler(tc, **kwargs)


@pytest.mark.parametrize("n_slots,prefix_cache,page_size", [
    (2, True, 16), (4, True, 8), (2, False, 16), (4, False, 8)])
def test_continuous_matches_jax_static(pair, static_text, n_slots,
                                       prefix_cache, page_size):
    _, tc = pair
    sched = _scheduler(tc, n_slots=n_slots, prefix_cache=prefix_cache,
                       page_size=page_size)
    assert _run(sched, PROMPTS) == static_text
    stats = sched.stats()
    assert stats["completed"] == len(PROMPTS)
    assert stats["free_slots"] == n_slots        # every slot released
    pc = stats["prefix_cache"]
    if prefix_cache:
        assert pc["hits"] >= 1 and pc["tokens_shared"] > 0
    else:
        assert pc["lookups"] == len(PROMPTS) and pc["hits"] == 0
    sched._pool.check()


def test_wrapper_matches_jax_continuous(pair, static_text):
    jc, tc = pair
    want = jc.generate_batch_continuous(PROMPTS, max_new_tokens=8, n_slots=2,
                                        prefill_chunk=16)
    assert want == static_text
    assert tc.generate_batch_continuous(PROMPTS, max_new_tokens=8, n_slots=2,
                                        prefill_chunk=16) == want


def test_prefix_hits_skip_chunks(pair, static_text):
    """Sequential arrival through one slot (a pool of three sequences):
    later prompts share the template head's pages and skip its chunks."""
    _, tc = pair
    sched = _scheduler(tc, n_slots=1, page_size=8, kv_pages=27)
    assert _run(sched, PROMPTS[:3]) == static_text[:3]
    pc = sched.stats()["prefix_cache"]
    assert pc["hits"] == 2 and pc["chunks_skipped"] >= 4
    assert pc["pages_shared"] > 0 and pc["cow_copies"] >= 1


def test_budgets_truncate_per_request(pair):
    from music_analyst_tpu.serving.decode_loop import (
        ContinuousScheduler as JaxScheduler,
    )

    jc, tc = pair
    budgets = [1, 8, 3, 5, 2, 8, 4]
    want = _run(JaxScheduler(jc, n_slots=2, prefill_chunk=16,
                             prompt_region=64, max_new_tokens=8),
                PROMPTS, budgets)
    got = _run(_scheduler(tc, n_slots=2), PROMPTS, budgets)
    assert got == want
    assert len(got[0].encode("utf-8", errors="surrogatepass")) <= 3


def test_int8_pages_match_jax_int8(pair):
    """int8 pages carry a bounded-error contract, not byte identity with
    bf16; both packages quantize the same rows the same way, so their
    int8 generations agree here."""
    jc, tc = pair
    kw = dict(max_new_tokens=8, n_slots=2, prefill_chunk=16, kv_quant="int8")
    want = jc.generate_batch_continuous(PROMPTS, **kw)
    assert tc.generate_batch_continuous(PROMPTS, **kw) == want


def test_scheduler_sheds_and_refuses_monolithic(pair):
    _, tc = pair
    sched = _scheduler(tc, n_slots=2, max_queue=2)
    reqs = [sched.submit(i, p) for i, p in enumerate(PROMPTS[:3])]
    assert reqs[2].response["error"]["kind"] == "queue_full"
    sched.run_until_idle()
    assert all(r.response["ok"] for r in reqs[:2])
    assert sched.stats()["shed"] == 1
    # The monolithic slot cache and speculation are ported: both build and
    # generate (their text against JAX is held in test_torch_kv_slots.py
    # and test_torch_speculative.py).
    mono = _scheduler(tc, n_slots=2, page_size=0)
    assert mono.stats()["kv_backend"] == "slots"
    assert _run(mono, PROMPTS[:2]) == _run(_scheduler(tc, n_slots=2),
                                           PROMPTS[:2])
    assert tc.generate_batch_continuous(
        PROMPTS, max_new_tokens=8, n_slots=2, prefill_chunk=16,
        speculate_k=2) == tc.generate_batch_continuous(
        PROMPTS, max_new_tokens=8, n_slots=2, prefill_chunk=16)


@pytest.mark.parametrize("mode", ["score", "generate"])
def test_run_sentiment_matches_jax(pair, fixture_csv, tmp_path, mode):
    jc, tc = pair
    for clf in (jc, tc):
        clf.decode_mode = mode
        clf.continuous_slots = 2 if mode == "generate" else 0
    try:
        want = jax_run(str(fixture_csv), backend=jc, quiet=True,
                       output_dir=str(tmp_path / "jax"))
        got = run_sentiment(str(fixture_csv), backend=tc, quiet=True,
                            output_dir=str(tmp_path / "port"), device="cpu")
    finally:
        for clf in (jc, tc):
            clf.decode_mode, clf.continuous_slots = "score", 0
    assert got.counts == want.counts
    assert [r.label for r in got.rows] == [r.label for r in want.rows]
    assert sum(got.counts.values()) == len(got.rows) == 8


@pytest.mark.parametrize("slots", ["", "2"])
def test_cli_runs_tiny_llama_on_cpu(monkeypatch, fixture_csv, tmp_path, slots):
    monkeypatch.setenv("MUSICAAL_CONTINUOUS_SLOTS", slots)
    out = tmp_path / "out"
    assert cli_main(["sentiment", str(fixture_csv), "--model", "llama3-tiny",
                     "--device", "cpu", "--output-dir", str(out)]) == 0
    totals = json.loads((out / "sentiment_totals.json").read_text())
    with open(out / "sentiment_details.csv", newline="", encoding="utf-8") as fh:
        rows = list(csv.DictReader(fh))
    assert sum(totals.values()) == len(rows) == 8
