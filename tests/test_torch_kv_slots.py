"""Port monolithic slot cache (``ops/kv_slots.py``) ≡ the JAX runtime.

The tiny Llama runs in float32 on the CPU with the JAX classifier's
weights (``params_from_jax``); both caches store bfloat16 rows.  The same
prompt chunks, decode steps, drafted block and snapshot/restore go
through JAX's ``SlotDecodeRuntime`` and the port's.  Tolerances: greedy
token ids, steps, done flags and write offsets exact; cache rows within
2e-2 absolute (one bfloat16 ulp at the rows' scale — the f32 K/V
projections of the two frameworks may differ in the last bits before
the cast).  End to end, greedy text through the port's scheduler at
``page_size=0`` equals JAX static greedy byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

torch.set_num_threads(1)

PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "my heart beats a broken drum",
    "ok",
]
ATOL = 2e-2


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
def runtimes(pair):
    jc, tc = pair
    kw = dict(n_slots=2, prefill_chunk=16, max_new_tokens=8,
              prompt_region=32, decode_span=3)
    return jc.slot_runtime(**kw), tc.slot_runtime(**kw)


def _close_rows(jcaches, tcaches):
    for jc_, tc_ in zip(jcaches, tcaches):
        for jt, tt in ((jc_.keys, tc_.keys), (jc_.values, tc_.values)):
            np.testing.assert_allclose(tt.float().numpy(),
                                       np.asarray(jt, np.float32),
                                       atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tc_.length.numpy(),
                                      np.asarray(jc_.length))


def _prefill(jc, jrt, trt, jcache, tcache, slot, text):
    plan = trt.plan
    ids, plen = jc.tokenizer.encode(text, plan.prompt_region)
    ids = np.asarray(ids, np.int32)
    C = plan.prefill_chunk
    for start in trt.prompt_chunks(plen):
        last = max(0, min(plen - 1 - start, C - 1))
        after = min(start + C, plan.prompt_region)
        jcache, jfirst = jrt.prefill_chunk(
            jc.params, jcache, jnp.asarray(slot, jnp.int32),
            jnp.asarray(ids[start:start + C]), jnp.asarray(start, jnp.int32),
            jnp.asarray(after, jnp.int32), jnp.asarray(last, jnp.int32))
        tcache, tfirst = trt.prefill_chunk(
            tcache, slot, torch.from_numpy(ids[start:start + C]), start,
            after, last)
    assert int(jfirst) == int(tfirst)
    return jcache, tcache, int(tfirst), plen


def test_prefill_decode_verify_snapshot_match_jax(pair, runtimes):
    jc, _ = pair
    jrt, trt = runtimes
    jcache, tcache = jrt.init_caches(), trt.init_caches()
    firsts, plens = [], []
    for slot, text in enumerate(PROMPTS[2:4]):
        jcache, tcache, first, plen = _prefill(jc, jrt, trt, jcache, tcache,
                                               slot, text)
        firsts.append(first)
        plens.append(plen)
    _close_rows(jcache, tcache)

    n = trt.plan.n_slots
    tokens = np.array(firsts, np.int32)
    plens = np.array(plens, np.int32)
    steps = np.zeros(n, np.int32)
    budgets = np.array([8, 2], np.int32)
    done = np.zeros(n, bool)
    active = np.ones(n, bool)
    jout = jrt.decode_step(jc.params, jcache, *map(jnp.asarray, (
        tokens, plens, steps, budgets, done, active)))
    tout = trt.decode_step(tcache, *map(torch.from_numpy, (
        tokens, plens, steps, budgets, done, active)))
    jcache, tcache = jout[0], tout[0]
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _close_rows(jcache, tcache)

    # Verify a block from the committed state: column 0 the carry.
    tok, stp = tout[1].numpy(), tout[2].numpy()
    blk = np.stack([tok, np.full(n, 5), np.full(n, 9)], axis=1).astype(np.int32)
    jcache, jpreds = jrt.verify_block(jc.params, jcache, jnp.asarray(blk),
                                      jnp.asarray(plens), jnp.asarray(stp))
    tcache, tpreds = trt.verify_block(tcache, torch.from_numpy(blk),
                                      torch.from_numpy(plens),
                                      torch.from_numpy(stp))
    np.testing.assert_array_equal(tpreds.numpy(), np.asarray(jpreds))
    _close_rows(jcache, tcache)

    # Snapshot slot 0, restore it into slot 1: both hold slot 0's rows.
    jk, jv, jlen = jrt.snapshot_slot(jcache, jnp.asarray(0, jnp.int32))
    tk, tv, tlen = trt.snapshot_slot(tcache, 0)
    assert int(jlen) == int(tlen)
    jcache = jrt.restore_slot(jcache, jk, jv, jnp.asarray(1, jnp.int32), jlen)
    tcache = trt.restore_slot(tcache, tk, tv, 1, tlen)
    _close_rows(jcache, tcache)
    for c in tcache:
        assert torch.equal(c.keys[0], c.keys[1])

    # The failure path zeroes exactly the masked slots.
    mask = np.array([True, False])
    jcache = jrt.free_slots(jcache, jnp.asarray(mask))
    tcache = trt.free_slots(tcache, torch.from_numpy(mask))
    _close_rows(jcache, tcache)
    assert all(not c.keys[0].any() and c.keys[1].any() for c in tcache)


def test_snapshot_resume_continues_identically(pair, runtimes):
    """Decoding on from a restored snapshot (in another slot) emits the
    tokens an undisturbed slot emits: the O(1) resume contract."""
    jc, _ = pair
    jrt, trt = runtimes
    jcache, tcache = jrt.init_caches(), trt.init_caches()
    _, tcache, first, plen = _prefill(jc, jrt, trt, jcache, tcache, 0,
                                      PROMPTS[0])

    def run(cache, slot):
        n = trt.plan.n_slots
        tokens = np.zeros(n, np.int32)
        tokens[slot] = first
        plens = np.zeros(n, np.int32)
        plens[slot] = plen
        active = np.zeros(n, bool)
        active[slot] = True
        args = (tokens, plens, np.zeros(n, np.int32), np.full(n, 8, np.int32),
                np.zeros(n, bool), active)
        out = trt.decode_step(cache, *map(torch.from_numpy, args))
        return out[4][:, slot].tolist()

    snap = trt.snapshot_slot(tcache, 0)
    want = run(tcache, 0)
    tcache = trt.restore_slot(tcache, *snap[:2], 1, snap[2])
    assert run(tcache, 1) == want


@pytest.mark.parametrize("n_slots", [2, 4])
def test_scheduler_slots_match_jax_static(pair, n_slots):
    jc, tc = pair
    want = jc.generate_batch(PROMPTS, max_new_tokens=8)
    sched = ContinuousScheduler(tc, n_slots=n_slots, prefill_chunk=16,
                                prompt_region=64, max_new_tokens=8,
                                page_size=0)
    reqs = [sched.submit(i, p) for i, p in enumerate(PROMPTS)]
    sched.run_until_idle()
    assert [r.response["text"] for r in reqs] == want
    stats = sched.stats()
    assert stats["kv_backend"] == "slots" and stats["completed"] == len(PROMPTS)
    assert sched.warmup()["kv_backend"] == "slots"
