"""Port Llama ≡ the JAX Llama, with weights carried over.

The JAX zero-shot classifier is built from a seed on ``LlamaConfig.tiny()``
(2 layers, dim 128, GQA 8/4) in float32 with ``max_prompt_len=64``, and
``params_from_jax`` hands its parameters to the port.  Tolerances: logits
and label scores within 1e-4 (f32 on both sides, sums in another order;
KV caches are bf16 on both sides), greedy tokens identical, labels
identical.  Building blocks (RoPE tables, RMSNorm) are held to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import layers as jlayers
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.models import layers as tlayers
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.models.tokenization import ByteTokenizer

torch.set_num_threads(1)

ATOL = 1e-4
PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "my heart beats a broken drum",
    "la la la la",
    "   ",
    "the long road home winds past the silver lake and over the hills",
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


def _dense_inputs(tok, prompts, S=64):
    ids, lens = tok.encode_batch(prompts, S)
    mask = (np.asarray(jlayers.causal_mask(S, S, 0))
            & (np.arange(S)[None, None, None, :] < lens[:, None, None, None]))
    pos = np.broadcast_to(np.arange(S), ids.shape).copy()
    return ids, lens, pos, mask


def test_model_logits_match_jax(pair):
    jc, tc = pair
    ids, lens, pos, mask = _dense_inputs(tc.tokenizer, PROMPTS)
    want, _ = jc.model.apply({"params": jc.params}, jnp.asarray(ids),
                             jnp.asarray(pos), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = tc.model(torch.tensor(ids), torch.tensor(pos),
                          torch.tensor(mask))
        last, _ = tc.model(torch.tensor(ids), torch.tensor(pos),
                           torch.tensor(mask),
                           last_position=torch.tensor(lens - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    rows = np.arange(len(PROMPTS))
    np.testing.assert_allclose(last[:, 0].numpy(),
                               np.asarray(want)[rows, lens - 1], atol=ATOL,
                               rtol=0)


def test_cached_prefill_and_decode_match_jax(pair):
    """Prefill into bf16 caches, then one decode step at per-row
    positions, on both sides."""
    jc, tc = pair
    ids, lens, pos, _ = _dense_inputs(tc.tokenizer, PROMPTS)
    S, T = 64, 68
    mask = (np.asarray(jlayers.causal_mask(S, T, 0))
            & (np.arange(T)[None, None, None, :] < lens[:, None, None, None]))
    jcaches = jl.init_caches(jc.config, len(PROMPTS), T)
    jlog, jcaches = jc.model.apply({"params": jc.params}, jnp.asarray(ids),
                                   jnp.asarray(pos), jnp.asarray(mask),
                                   jcaches)
    tcaches = tl.init_caches(tc.config, len(PROMPTS), T)
    with torch.no_grad():
        tlog, tcaches = tc.model(torch.tensor(ids), torch.tensor(pos),
                                 torch.tensor(mask), tcaches)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    tok = np.full((len(PROMPTS), 1), 65, np.int32)
    step_mask = np.arange(T)[None, None, None, :] <= lens[:, None, None, None]
    jcaches = [jlayers.KVCache(c.keys, c.values, jnp.asarray(S, jnp.int32))
               for c in jcaches]
    tcaches = [tlayers.KVCache(c.keys, c.values, S) for c in tcaches]
    jlog, _ = jc.model.apply({"params": jc.params}, jnp.asarray(tok),
                             jnp.asarray(lens[:, None]),
                             jnp.asarray(step_mask), jcaches)
    with torch.no_grad():
        tlog, tcaches = tc.model(torch.tensor(tok), torch.tensor(lens[:, None]),
                                 torch.tensor(step_mask), tcaches)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    assert tcaches[0].length == S + 1


def test_score_mode_matches_jax(pair):
    jc, tc = pair
    ids, lens = tc._encode_prompts(PROMPTS)
    want = np.asarray(jc._score_labels(
        jc.params, jnp.asarray(ids), jnp.asarray(lens),
        jnp.asarray(jc._label_ids), jnp.asarray(jc._label_lens)))
    got = tc.score_labels(torch.tensor(ids).long(), torch.tensor(lens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tc.classify_batch(PROMPTS) == jc.classify_batch(PROMPTS)
    assert tc.classify_batch(PROMPTS)[5] == "Neutral"    # empty lyric rule


def test_greedy_generation_matches_jax(pair):
    jc, tc = pair
    want = jc.generate_batch(PROMPTS, max_new_tokens=8)
    assert tc.generate_batch(PROMPTS, max_new_tokens=8) == want
    assert tc.generate_batch(PROMPTS, max_new_tokens=8, early_exit=False) == want
    assert tc.generate(PROMPTS[0], max_new_tokens=6) == jc.generate(
        PROMPTS[0], max_new_tokens=6)
    assert (tc.classify_batch_by_generation(PROMPTS[:3])
            == jc.classify_batch_by_generation(PROMPTS[:3]))


def test_rope_and_rmsnorm_match_jax():
    jcos, jsin = jlayers.rope_frequencies(16, 300, 500_000.0)
    tcos, tsin = tlayers.rope_frequencies(16, 300, 500_000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5))
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    got = tlayers.apply_rope(torch.tensor(x), tcos, tsin, torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    norm = jlayers.RMSNorm()
    jp = norm.init(jax.random.key(0), jnp.asarray(h))
    np.testing.assert_allclose(
        tlayers.RMSNorm(32)(torch.tensor(h)).detach().numpy(),
        np.asarray(norm.apply(jp, jnp.asarray(h))), atol=1e-6)


def test_kv_cache_per_row_offsets():
    cache = tlayers.KVCache.zeros(2, 6, 1, 2, torch.float32)
    new = cache.update(torch.ones(2, 2, 1, 2), torch.ones(2, 2, 1, 2))
    assert new.length == 2 and float(new.keys[:, :2].sum()) == 8.0
    rows = tlayers.KVCache(cache.keys.zero_(), cache.values.zero_(),
                           torch.tensor([0, 3]))
    out = rows.update(torch.full((2, 1, 1, 2), 5.0), torch.zeros(2, 1, 1, 2))
    assert out.keys[0, 0, 0, 0] == 5 and out.keys[1, 3, 0, 0] == 5
    assert torch.equal(out.length, torch.tensor([1, 4]))


def test_hf_checkpoint_loads_like_jax(pair, tmp_path):
    """One HF-named torch state dict, loaded by both packages' loaders,
    gives the same logits (tied lm_head: no ``lm_head.weight`` in the
    file)."""
    jc, tc = pair
    names = {
        "tok_embeddings.": "model.embed_tokens.",
        ".attention.": ".self_attn.",
        ".attention_norm.": ".input_layernorm.",
        ".ffn_norm.": ".post_attention_layernorm.",
        ".feed_forward.": ".mlp.",
    }
    sd = {}
    for key, value in tc.model.state_dict().items():
        if key == "lm_head.weight":
            continue
        new = key if key.startswith("tok_") else "model." + key
        for old, rep in names.items():
            new = new.replace(old, rep)
        sd[new] = value.clone()
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, path)
    with pytest.warns(UserWarning, match="no matching tokenizer"):
        port = tl.LlamaZeroShotClassifier(
            config=tl.LlamaConfig.tiny(dtype="float32"),
            checkpoint_path=str(path), max_prompt_len=64, device="cpu")
    params = jl.load_hf_torch_checkpoint(jc.params, str(path))
    ids, _, pos, mask = _dense_inputs(tc.tokenizer, PROMPTS[:3])
    want, _ = jc.model.apply({"params": params}, jnp.asarray(ids),
                             jnp.asarray(pos), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = port.model(torch.tensor(ids), torch.tensor(pos),
                            torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_random_init_follows_flax_distributions():
    torch.manual_seed(0)
    clf = tl.LlamaZeroShotClassifier(config=tl.LlamaConfig.tiny(n_layers=1),
                                     max_prompt_len=64, device="cpu", seed=3)
    m = clf.model
    assert m.layers[0].attention.q_proj.weight.dtype == torch.bfloat16
    assert m.lm_head.weight.dtype == torch.float32
    w = m.lm_head.weight
    assert abs(float(w.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert float(w.abs().max()) <= 2 * 128 ** -0.5 / 0.87962566103423978 + 1e-6
    emb = m.tok_embeddings.weight.float()
    assert abs(float(emb.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert torch.equal(m.norm.weight, torch.ones(128))
    again = tl.LlamaZeroShotClassifier(config=tl.LlamaConfig.tiny(n_layers=1),
                                       max_prompt_len=64, device="cpu", seed=3)
    assert torch.equal(again.model.lm_head.weight, w)
    assert isinstance(clf.tokenizer, ByteTokenizer)


def test_unported_and_refused_configurations(monkeypatch):
    monkeypatch.delenv("MUSICAAL_LLAMA_CKPT", raising=False)
    with pytest.raises(RuntimeError, match="needs a checkpoint"):
        tl.LlamaZeroShotClassifier.from_pretrained_or_random(
            "llama3", device="cpu")
    with pytest.raises(RuntimeError, match="needs a checkpoint"):
        tl.LlamaZeroShotClassifier.from_pretrained_or_random(
            "llama3-8b", device="cpu")
    # -int8 and weight_quant are ported (tests/test_torch_quant_models.py).
    assert tl.LlamaZeroShotClassifier.from_pretrained_or_random(
        "llama3-tiny-int8", device="cpu").config.quant == "int8"
    assert tl.LlamaZeroShotClassifier.from_pretrained_or_random(
        "llama3-tiny", weight_quant="int8", device="cpu"
    ).config.weight_quant == "int8"
    # MoE and the flash no-cache path are ported
    # (tests/test_torch_moe.py, tests/test_torch_llama_flash.py); MoE with
    # stored quantized weights is refused, as in JAX.
    assert tl.LlamaModel(tl.LlamaConfig.tiny(n_experts=4)).layers[0].moe
    assert tl.LlamaModel(tl.LlamaConfig.tiny(attn_impl="flash")).layers[0].flash
    with pytest.raises(ValueError, match="MoE expert stacks"):
        tl.LlamaConfig.tiny(n_experts=4, weight_quant="int8")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tl.LlamaZeroShotClassifier(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown llama preset"):
        tl.LlamaZeroShotClassifier.from_pretrained_or_random(
            "llama9", device="cpu")
