"""Port speculative decoding ≡ JAX greedy text, byte for byte.

The tiny Llama runs in float32 on the CPU, its weights carried from the
JAX classifier with ``params_from_jax``.  Draft-and-verify through the
port's continuous scheduler must give the JAX package's static greedy
text exactly (tolerance: none — the function is greedy token ids) at
every draft depth ``k ∈ {2, 4, 8}`` on the paged cache (``page_size``
16) and on the monolithic slot cache (``page_size`` 0), under shuffled
arrival, mixed budgets and the EOS latch; after a preemption in the
middle of speculation; and when an injected ``spec.draft`` fault makes
every tick fall back to plain decode.  The paged ``verify_block`` is held
against the JAX runtime's on the same prefilled pool.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.resilience.faults import configure_faults
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

torch.set_num_threads(1)

PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "my heart beats a broken drum",
    "la la la la",
    "winter wind and summer fire",
    "ok",
    "the long road home winds past the silver lake and over the hills",
]
# Streams that stop early at EOS under a 16-token budget.
EOS_PROMPTS = ["la la la", "hey hey", "sun", "dance dance"]


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
    return jc.generate_batch(PROMPTS, max_new_tokens=16)


def _scheduler(tc, **kwargs):
    kwargs.setdefault("prefill_chunk", 16)
    kwargs.setdefault("prompt_region", 64)
    kwargs.setdefault("max_new_tokens", 16)
    kwargs.setdefault("max_queue", 64)
    return ContinuousScheduler(tc, **kwargs)


def _run(sched, prompts, budgets=None, order=None):
    budgets = budgets or [sched.plan.max_new] * len(prompts)
    order = order if order is not None else range(len(prompts))
    reqs = {i: sched.submit(i, prompts[i], max_new_tokens=budgets[i])
            for i in order}
    sched.run_until_idle()
    out = []
    for i in range(len(prompts)):
        resp = reqs[i].response or {}
        assert resp.get("ok"), resp
        out.append(resp)
    return out


@pytest.mark.parametrize("page_size", [16, 0], ids=["paged", "slots"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_speculative_matches_jax_static_greedy(pair, static_text,
                                               page_size, k):
    _, tc = pair
    sched = _scheduler(tc, n_slots=4, speculate_k=k, page_size=page_size)
    order = list(range(len(PROMPTS)))
    random.Random(k).shuffle(order)
    got = [r["text"] for r in _run(sched, PROMPTS, order=order)]
    assert got == static_text
    spec = sched.stats()["speculation"]
    assert spec["enabled"] and spec["k"] == k and spec["fallbacks"] == 0
    if k < 8:
        # At k = 8 the 9-row block fits a 16-token budget only early on,
        # before the streams repeat, so no verify dispatch need happen.
        assert spec["dispatches"] > 0 and spec["drafted"] > 0
        # Tokens committed per verify dispatch, summed over the 4 slots.
        assert 1.0 <= spec["accepted_tokens_per_dispatch"] <= 4 * (k + 1)


@pytest.mark.parametrize("page_size", [16, 0], ids=["paged", "slots"])
def test_mixed_budgets_freeze_identically(pair, page_size):
    """Per-request budgets truncate exactly as the plain scheduler does
    (whose budgets test_torch_continuous.py holds against JAX's)."""
    _, tc = pair
    budgets = [1, 2, 3, 16, 1, 2, 3, 16]
    want = [r["text"] for r in _run(
        _scheduler(tc, n_slots=4, page_size=page_size), PROMPTS,
        budgets=budgets)]
    got = _run(_scheduler(tc, n_slots=4, speculate_k=8, page_size=page_size),
               PROMPTS, budgets=budgets)
    assert [r["text"] for r in got] == want
    assert all(r["tokens"] <= b for r, b in zip(got, budgets))


def test_eos_latch_survives_accepted_blocks(pair):
    jc, tc = pair
    want = jc.generate_batch(EOS_PROMPTS, max_new_tokens=16)
    for page_size in (16, 0):
        sched = _scheduler(tc, n_slots=4, speculate_k=4, page_size=page_size)
        assert [r["text"] for r in _run(sched, EOS_PROMPTS)] == want


def test_draft_fault_degrades_to_plain_decode(pair, static_text):
    """Every eligible tick's ``spec.draft`` fault falls back to plain
    decode: the same bytes, the fallbacks counted, no verify dispatch."""
    _, tc = pair
    sched = _scheduler(tc, n_slots=4, speculate_k=4)
    configure_faults("spec.draft:error@1+")
    try:
        got = [r["text"] for r in _run(sched, PROMPTS[:4])]
    finally:
        configure_faults(None)
    assert got == static_text[:4]
    spec = sched.stats()["speculation"]
    assert spec["fallbacks"] > 0 and spec["dispatches"] == 0


@pytest.mark.parametrize("page_size", [16, 0], ids=["paged", "slots"])
def test_preempt_resume_mid_speculation_byte_identical(pair, static_text,
                                                       page_size):
    """A priority-5 admit preempts a speculating priority-1 slot: the
    victim checkpoints (paged: its pinned table row; slots: a device copy
    of its rows), resumes with no prefill chunk, and every text equals
    JAX static greedy."""
    _, tc = pair
    low_prompts, high_prompt = PROMPTS[:2], PROMPTS[7]
    sched = _scheduler(tc, n_slots=2, speculate_k=4, ttft_slo_ms=1.0,
                       page_size=page_size,
                       kv_pages=24 if page_size else None)
    sched.warmup()
    low = [sched.submit(i, p, priority=1, deadline_ms=60_000.0)
           for i, p in enumerate(low_prompts)]
    for _ in range(64):
        sched._tick()
        if any(s is not None and s.active and s.steps > 0
               for s in sched._slots):
            break
    high = sched.submit("gold", high_prompt, priority=5,
                        deadline_ms=60_000.0)
    for _ in range(64):
        if sched.stats()["preemptions"] >= 1:
            break
        sched._tick()
    sched.run_until_idle()
    for req, want in zip(low, static_text[:2]):
        assert req.response["ok"], req.response
        assert req.response["text"] == want
    assert high.response["ok"] and high.response["text"] == static_text[7]
    stats = sched.stats()
    assert stats["preemptions"] >= 1 and stats["resumed_o1"] >= 1
    assert stats["resume_chunks_skipped"] >= 1
    assert stats["speculation"]["dispatches"] > 0


def test_paged_verify_block_matches_jax(pair):
    """One prefilled slot, then a drafted block through both runtimes'
    paged ``verify_block``: predictions equal (greedy ids, exact), the
    written decode rows within one bf16 ulp of the pool's scale
    (atol 2e-2, the rows are stored in bfloat16)."""
    jc, tc = pair
    kw = dict(n_slots=2, prefill_chunk=16, max_new_tokens=8,
              prompt_region=32, decode_span=2, page_size=8)
    jrt, trt = jc.paged_runtime(**kw), tc.paged_runtime(**kw)
    plan = trt.plan
    ids, plen = tc.tokenizer.encode(PROMPTS[2], plan.prompt_region)
    ids = np.asarray(ids, np.int32)
    row = np.arange(plan.pages_per_slot, dtype=np.int32)
    table = np.full((plan.n_slots, plan.pages_per_slot), plan.trash_page,
                    np.int32)
    table[0] = row
    jcache, tcache = jrt.init_caches(), trt.init_caches()
    for start in trt.prompt_chunks(plen):
        C = plan.prefill_chunk
        last = max(0, min(plen - 1 - start, C - 1))
        after = min(start + C, plan.prompt_region)
        jcache, jfirst = jrt.prefill_chunk(
            jc.params, jcache, jnp.asarray(row), jnp.asarray(0, jnp.int32),
            jnp.asarray(ids[start:start + C]), jnp.asarray(start, jnp.int32),
            jnp.asarray(after, jnp.int32), jnp.asarray(last, jnp.int32))
        tcache, tfirst = trt.prefill_chunk(
            tcache, row, 0, torch.from_numpy(ids[start:start + C]), start,
            after, last)
    assert int(jfirst) == int(tfirst)
    blk = np.zeros((plan.n_slots, 5), np.int32)
    blk[0] = [int(tfirst), 7, 42, 42, 100]
    plens = np.array([plen, 0], np.int32)
    steps = np.zeros(plan.n_slots, np.int32)
    jcache, jpreds = jrt.verify_block(
        jc.params, jcache, jnp.asarray(table), jnp.asarray(blk),
        jnp.asarray(plens), jnp.asarray(steps))
    tcache, tpreds = trt.verify_block(
        tcache, torch.from_numpy(table), torch.from_numpy(blk),
        torch.from_numpy(plens), torch.from_numpy(steps))
    np.testing.assert_array_equal(tpreds[0].numpy(), np.asarray(jpreds)[0])
    pages = row[plan.prompt_pages:]
    for jl_c, tl_c in zip(jcache, tcache):
        np.testing.assert_allclose(
            tl_c.keys[pages].float().numpy(),
            np.asarray(jl_c.keys[pages], np.float32), atol=2e-2, rtol=0)
