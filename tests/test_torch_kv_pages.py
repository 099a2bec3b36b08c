"""Port paged KV cache ≡ the JAX paged KV cache.

* geometry and knobs: ``PagePlan`` and the serving resolvers accept and
  refuse the same values as the JAX package's, environment included;
* host structures: ``PagePool`` and ``RadixIndex`` give the same matches,
  adoptions, evictions and refcounts as the JAX package's on one seeded
  sequence of operations;
* device half: one paged prefill chunk writes the same K/V pages as the
  JAX runtime (f32 model, bf16 pools: within one bf16 rounding, 2^-7
  relative, plus 1e-6), and the byte accounting agrees.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.ops import kv_pages as jkv
from music_analyst_tpu.serving import batcher as jb
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.ops import kv_pages as tkv
from music_analyst_tpu_torch.serving import batcher as tb

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32")
    jc = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64)
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jc.params))
    tc = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(dtype="float32"), max_prompt_len=64,
        device="cpu", state_dict=sd)
    return jc, tc


_PLANS = [
    dict(n_slots=4, prefill_chunk=16, prompt_region=64, max_new=8,
         decode_span=4, page_size=16, n_pages=20),
    dict(n_slots=4, prefill_chunk=16, prompt_region=64, max_new=8,
         decode_span=4, page_size=12, n_pages=20),
    dict(n_slots=4, prefill_chunk=16, prompt_region=48, max_new=8,
         decode_span=4, page_size=32, n_pages=20),
    dict(n_slots=8, prefill_chunk=16, prompt_region=64, max_new=8,
         decode_span=4, page_size=16, n_pages=6),
    dict(n_slots=2, prefill_chunk=16, prompt_region=64, max_new=8,
         decode_span=4, page_size=16, n_pages=4),
    dict(n_slots=3, prefill_chunk=16, prompt_region=64, max_new=8,
         decode_span=4, page_size=16, n_pages=20),
    dict(n_slots=4, prefill_chunk=24, prompt_region=64, max_new=8,
         decode_span=4, page_size=16, n_pages=20),
    dict(n_slots=4, prefill_chunk=16, prompt_region=64, max_new=0,
         decode_span=4, page_size=16, n_pages=20),
]


@pytest.mark.parametrize("kwargs", _PLANS)
def test_page_plan_matches_jax(kwargs):
    try:
        want = jkv.PagePlan(**kwargs)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tkv.PagePlan(**kwargs)
        assert str(got.value) == str(exc)
        return
    got = tkv.PagePlan(**kwargs)
    for prop in ("max_total", "prompt_pages", "decode_pages",
                 "pages_per_slot", "slot_span", "trash_page"):
        assert getattr(got, prop) == getattr(want, prop)


_RESOLVERS = [
    ("resolve_page_size", "MUSICAAL_SERVE_PAGE_SIZE",
     [None, 8, 0, 12, "x"], ["32", "12", "junk", ""]),
    ("resolve_kv_quant", "MUSICAAL_SERVE_KV_QUANT",
     [None, "int8", "INT8", "fp4"], ["int8", "bogus", ""]),
    ("resolve_slots", "MUSICAAL_SERVE_SLOTS", [None, 5, 0], ["4", "3", "-1"]),
    ("resolve_prefill_chunk", "MUSICAAL_SERVE_PREFILL_CHUNK",
     [None, 32, 0], ["16", "zero"]),
    ("resolve_max_queue", "MUSICAAL_SERVE_MAX_QUEUE", [None, 7], ["9", "0"]),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError:
        return ("raises", None)


@pytest.mark.parametrize("name,env,values,env_values", _RESOLVERS)
def test_resolvers_match_jax(monkeypatch, name, env, values, env_values):
    for raw in env_values + [None]:
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
        for value in values:
            assert (_outcome(getattr(tb, name), value)
                    == _outcome(getattr(jb, name), value)), (name, raw, value)


def test_resolve_kv_pages_matches_jax(monkeypatch):
    for raw in ("48", "4", None):
        if raw is None:
            monkeypatch.delenv("MUSICAAL_SERVE_KV_PAGES", raising=False)
        else:
            monkeypatch.setenv("MUSICAAL_SERVE_KV_PAGES", raw)
        for value, n_slots in ((None, 8), (64, 8), (4, 8), (0, None)):
            assert (_outcome(tb.resolve_kv_pages, value, n_slots)
                    == _outcome(jb.resolve_kv_pages, value, n_slots))


def _pool_state(pool):
    return (list(pool.slot_refs), list(pool.in_tree), pool.free_count,
            sorted(pool._free))


def test_pool_and_radix_match_jax_on_a_random_workload():
    """Admit/prefill/complete cycles over prompts sharing prefixes, with a
    pool small enough to force eviction, on both host structures."""
    rng = random.Random(7)
    P, n_pages, pps = 4, 24, 5
    stems = [[rng.randrange(50) for _ in range(n)] for n in (9, 14, 6)]
    sides = []
    for mod_pool, mod_radix in ((jkv.PagePool, jkv.RadixIndex),
                                (tkv.PagePool, tkv.RadixIndex)):
        pool, radix = mod_pool(n_pages), mod_radix(P)
        rng = random.Random(11)
        trace = []
        live = []
        for _ in range(60):
            if live and (len(live) >= 3 or rng.random() < 0.4):
                row = live.pop(rng.randrange(len(live)))
                for phys in row:
                    pool.unpin(phys)
                trace.append(("free", _pool_state(pool)))
                continue
            ids = rng.choice(stems) + [rng.randrange(50)
                                       for _ in range(rng.randrange(0, 7))]
            ids = ids[:pps * P]
            match = radix.match(ids)
            for phys in match.pages:
                pool.pin(phys)
            need = pps - len(match.pages)
            if pool.free_count < need:
                radix.evict(pool, need - pool.free_count)
            fresh = pool.alloc(need)
            if fresh is None:
                for phys in match.pages:
                    pool.unpin(phys)
                trace.append(("deferred", match.tokens))
                continue
            for phys in fresh:
                pool.pin(phys)
            row = list(match.pages) + fresh
            adopted = radix.insert(ids, row, pool)
            live.append(row)
            trace.append((dataclasses.astuple(match), adopted,
                          radix.page_count(), _pool_state(pool)))
            pool.check()
        sides.append(trace)
    assert sides[0] == sides[1]
    assert any(t[0] == "deferred" or (len(t) == 4 and t[0][1] > 0)
               for t in sides[0])


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_byte_accounting_matches_jax(pair, kv_quant):
    jc, tc = pair
    kw = dict(n_slots=2, prefill_chunk=16, prompt_region=64,
              max_new_tokens=8, kv_quant=kv_quant)
    jrt, trt = jc.paged_runtime(**kw), tc.paged_runtime(**kw)
    assert dataclasses.asdict(trt.plan) == dataclasses.asdict(jrt.plan)
    assert trt.kv_token_bytes() == jrt.kv_token_bytes()
    assert trt.pool_bytes() == jrt.pool_bytes()
    assert list(trt.prompt_chunks(37)) == list(jrt.prompt_chunks(37))
    with pytest.raises(ValueError, match="max_seq_len"):
        tc.paged_runtime(n_slots=2, prefill_chunk=64, prompt_region=64,
                         max_new_tokens=2048)


def test_prefill_chunk_writes_the_same_pages_as_jax(pair):
    jc, tc = pair
    kw = dict(n_slots=2, prefill_chunk=16, prompt_region=64, max_new_tokens=8,
              page_size=8)
    jrt, trt = jc.paged_runtime(**kw), tc.paged_runtime(**kw)
    pps = trt.plan.pages_per_slot
    row = np.arange(pps, dtype=np.int32)[::-1] + 3
    ids, plen = tc.tokenizer.encode("a prompt that spans two chunks!", 64)
    jcaches, tcaches = jrt.init_caches(), trt.init_caches()
    for start in (0, 16):
        chunk = ids[start:start + 16]
        last = max(0, min(plen - 1 - start, 15))
        jcaches, jfirst = jrt.prefill_chunk(
            jc.params, jcaches, jnp.asarray(row), jnp.asarray(1, jnp.int32),
            jnp.asarray(chunk), jnp.asarray(start, jnp.int32),
            jnp.asarray(start + 16, jnp.int32), jnp.asarray(last, jnp.int32))
        tcaches, tfirst = trt.prefill_chunk(
            tcaches, row, 1, torch.tensor(chunk).long(), start, start + 16,
            last)
    assert int(jfirst) == int(tfirst)
    for jc_l, tc_l in zip(jcaches, tcaches):
        for jt, tt in ((jc_l.keys, tc_l.keys), (jc_l.values, tc_l.values)):
            want = np.asarray(jnp.asarray(jt, jnp.float32))
            got = tt.float().numpy()
            assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)
        assert np.array_equal(tc_l.length.numpy(), np.asarray(jc_l.length))
