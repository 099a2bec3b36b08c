"""Quantized DistilBERT and Llama: the port ≡ the JAX package.

Both tiny models run in float32 on the CPU with weights carried from JAX
by ``params_from_jax``, stored ``QuantizedParam`` kernels included (the
JAX classifiers draw float weights and quantize them).  Tolerances:
logits within 1e-4 of the JAX logits' spread (the integer accumulations
are exact on both sides; the f32 epilogues and attention sum in another
order), labels equal, Llama greedy text byte-identical, static and
through the continuous paged scheduler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import layers as jlayers
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import layers as tlayers
from music_analyst_tpu_torch.models import llama as tl

torch.set_num_threads(1)

SPREAD_TOL = 1e-4
MODES = [("quant", "int8"), ("weight_quant", "int8"), ("weight_quant", "int4")]
PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "my heart beats a broken drum",
    "la la la la",
]


def _texts(n):
    words = ["love", "rain", "happy", "broken", "sun", "night", "dance"]
    rng = np.random.default_rng(5)
    return [" ".join(rng.choice(words, size=int(rng.integers(2, 20))))
            for _ in range(n)] + [""]


def _within_spread(got, want):
    got, want = np.asarray(got), np.asarray(want)
    spread = float(want.max() - want.min())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SPREAD_TOL * spread, (
        np.abs(got - want).max(), spread)


@pytest.fixture(scope="module", params=MODES, ids=["-".join(m) for m in MODES])
def bert_pair(request):
    field, scheme = request.param
    jcfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32",
                               **{field: scheme})
    jclf = jd.DistilBertClassifier(config=jcfg, max_len=32, seed=4)
    state = td.params_from_jax(jax.tree_util.tree_map(np.asarray, jclf.params))
    tcfg = td.DistilBertConfig.tiny(dtype="float32", attn_impl="dense",
                                    **{field: scheme})
    tclf = td.DistilBertClassifier(config=tcfg, max_len=32, state_dict=state,
                                   device="cpu")
    return jclf, tclf


def test_distilbert_quantized_logits_and_labels_match_jax(bert_pair):
    jclf, tclf = bert_pair
    texts = _texts(24)
    ids, lengths = jclf.tokenizer.encode_batch(texts, 32)
    want = jclf.model.apply({"params": jclf.params}, jnp.asarray(ids),
                            jnp.asarray(lengths))
    got = tclf.forward_logits(torch.from_numpy(ids), torch.from_numpy(lengths))
    _within_spread(got.numpy(), want)
    assert tclf.classify_batch(texts) == jclf.classify_batch(texts)


def test_distilbert_quantized_slots_hold_codes(bert_pair):
    _, tclf = bert_pair
    layer = tclf.model.encoder.layers[0]
    cfg = tclf.config
    if cfg.weight_quant != "none":
        assert isinstance(layer.attention.o_proj, tlayers.WqLinear)
        assert layer.attention.o_proj.q.dtype == torch.int8
        assert layer.attention.o_proj.scheme == cfg.weight_quant
        # Heads stay float, as in JAX.
        assert type(tclf.model.pre_classifier) is torch.nn.Linear
    else:
        assert isinstance(layer.ffn.lin1, tlayers.QuantLinear)


@pytest.mark.parametrize("name", [
    "distilbert-tiny-int8-packed", "distilbert-int8-tiny-packed",
    "distilbert-packed-int8-tiny", "distilbert-packed-tiny-int8",
    "distilbert-tiny-packed-int8", "distilbert-int8-packed-tiny",
    "distilbert-int8", "distilbert-tiny-int8",
])
def test_distilbert_int8_suffix_in_any_order(name):
    clf = td.DistilBertClassifier.from_pretrained_or_random(name, device="cpu")
    tiny = "tiny" in name
    assert clf.config.quant == "int8"
    assert clf.packed == ("packed" in name)
    assert clf.config.dim == (64 if tiny else 768)
    assert isinstance(clf.model.encoder.layers[0].attention.q_proj,
                      tlayers.QuantLinear)


def test_random_weight_quant_model_quantizes_the_float_draw():
    """Seeded random weights of a weight-quantized model are the float
    model's draw, quantized: the codes equal quantize_array of it."""
    from music_analyst_tpu_torch.ops.quant import quantize_array

    cfg = td.DistilBertConfig.tiny(dtype="float32")
    flt = td.DistilBertClassifier(config=cfg, seed=9, device="cpu")
    for scheme in ("int8", "int4"):
        wq = td.DistilBertClassifier(
            config=dataclasses.replace(cfg, weight_quant=scheme), seed=9,
            device="cpu")
        w = flt.model.encoder.layers[1].attention.o_proj.weight
        want = quantize_array(w.t().reshape(4, 16, 64), scheme, 2)
        got = wq.model.encoder.layers[1].attention.o_proj.qparam
        assert torch.equal(got.q, want.q) and torch.equal(got.scale,
                                                          want.scale)
        assert torch.equal(wq.model.encoder.word_embeddings.weight,
                           flt.model.encoder.word_embeddings.weight)


def test_mutual_exclusion_and_validation_match_jax():
    with pytest.raises(ValueError, match="mutually exclusive"):
        td.DistilBertConfig(quant="int8", weight_quant="int8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        jd.DistilBertConfig(quant="int8", weight_quant="int8")
    with pytest.raises(ValueError, match="weight_quant"):
        td.DistilBertConfig(weight_quant="fp8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tl.LlamaConfig(quant="int8", weight_quant="int4")
    with pytest.raises(ValueError, match="MoE"):
        tl.LlamaConfig(n_experts=4, weight_quant="int8")
    with pytest.raises(ValueError, match="MoE"):
        jl.LlamaConfig(n_experts=4, weight_quant="int8")
    with pytest.raises(ValueError, match="weight_quant"):
        tl.LlamaConfig(weight_quant="int2")


def test_wq_linear_float_fallback_matches_jax():
    """A WqLinear slot holding a float kernel computes the float product,
    as JAX's WqDenseGeneral does."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    kernel = rng.normal(size=(32, 4, 8)).astype(np.float32)
    bias = rng.normal(size=(4, 8)).astype(np.float32)
    mod = jlayers.WqDenseGeneral(features=(4, 8), dtype=jnp.float32)
    want = mod.apply({"params": {"kernel": jnp.asarray(kernel),
                                 "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    layer = tlayers.WqLinear(32, 32, "int8", dtype=torch.float32,
                             kernel_shape=(32, 4, 8))
    layer.use_float_(torch.from_numpy(kernel.reshape(32, 32).T.copy()))
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(bias.reshape(-1)))
        got = layer(torch.from_numpy(x))
    assert layer.qparam is None
    np.testing.assert_allclose(got.numpy().reshape(3, 5, 4, 8),
                               np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module", params=MODES, ids=["-".join(m) for m in MODES])
def llama_pair(request):
    field, scheme = request.param
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32",
                              **{field: scheme})
    jc = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64)
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jc.params))
    tc = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(dtype="float32", **{field: scheme}),
        max_prompt_len=64, device="cpu", state_dict=sd)
    return jc, tc


def _codes(x):
    """Per-row int8 codes of the quantized products' activations, and
    their distance to the nearest rounding tie (in code units)."""
    x = np.asarray(x, np.float32)
    s = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8))
    r = x / (s / np.float32(127.0))
    return np.round(r), np.abs(np.abs(r) % 1.0 - 0.5)


def _capture_jax(fn):
    """Run ``fn`` eagerly and record the input of every quantized dense
    call, as ``[B, S, K]``."""
    from flax import linen as nn

    caps = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and isinstance(
                mod, (jlayers.QuantDenseGeneral, jlayers.WqDenseGeneral)):
            x = np.asarray(args[0])
            caps.append(x.reshape(x.shape[:2] + (-1,)) if mod.axis != -1
                        else x)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor), jax.disable_jit():
        out = fn()
    return out, caps


def _capture_port(model, fn):
    caps = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: caps.append(args[0].detach().float().numpy()))
        for m in model.modules()
        if isinstance(m, (tlayers.QuantLinear, tlayers.WqLinear))]
    try:
        with torch.no_grad():
            out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, caps


def _flipped_rows(jcaps, tcaps, rows):
    """Rows (prompts) whose activation codes differ between the packages
    at some quantized product, in call order.  A row's first differing
    codes must sit at a rounding tie: a 1-ulp difference upstream (another
    f32 summation order) moves x/s across k + 0.5, which no port can rule
    out; any other difference is a fault.  After its first flip a row's
    activations differ by more than ulps, so later calls are not held."""
    assert len(jcaps) == len(tcaps) > 0
    flipped = np.zeros(rows, bool)
    for j, t in zip(jcaps, tcaps):
        assert j.shape == t.shape and j.shape[0] == rows
        cj, tie = _codes(j)
        ct, _ = _codes(t)
        diff = cj != ct
        diff[flipped] = False
        assert (tie[diff] < 1e-3).all(), tie[diff].max()
        flipped |= diff.reshape(rows, -1).any(-1)
    return flipped


def test_llama_quantized_logits_match_jax(llama_pair):
    """Logits at each prompt's last position within 1e-4 of the spread of
    JAX's; a prompt whose activation codes flipped at a rounding tie is
    held to the JAX package's own int8 bound instead (0.1 of the spread)
    and to the same argmax."""
    jc, tc = llama_pair
    S = 64
    ids, lens = tc.tokenizer.encode_batch(PROMPTS, S)
    mask = (np.asarray(jlayers.causal_mask(S, S, 0))
            & (np.arange(S)[None, None, None, :] < lens[:, None, None, None]))
    pos = np.broadcast_to(np.arange(S), ids.shape).copy()
    (want, _), jcaps = _capture_jax(lambda: jc.model.apply(
        {"params": jc.params}, jnp.asarray(ids), jnp.asarray(pos),
        jnp.asarray(mask), last_position=jnp.asarray(lens - 1)))
    (got, _), tcaps = _capture_port(tc.model, lambda: tc.model(
        torch.tensor(ids), torch.tensor(pos), torch.tensor(mask),
        last_position=torch.tensor(lens - 1)))
    flipped = _flipped_rows(jcaps, tcaps, len(PROMPTS))
    assert not flipped.all()
    want, got = np.asarray(want)[:, 0], got.numpy()[:, 0]
    spread = float(want.max() - want.min())
    for b in range(len(PROMPTS)):
        err = np.abs(got[b] - want[b]).max()
        limit = (0.1 if flipped[b] else SPREAD_TOL) * spread
        assert err <= limit, (b, err, spread, flipped[b])
        assert got[b].argmax() == want[b].argmax()
    if tc.config.weight_quant != "none":
        assert isinstance(tc.model.lm_head, tlayers.WqLinear)


def test_llama_quantized_score_labels_match_jax(llama_pair):
    jc, tc = llama_pair
    assert tc.classify_batch(PROMPTS + [""]) == jc.classify_batch(PROMPTS + [""])


def test_llama_quantized_greedy_text_matches_jax(llama_pair):
    """Greedy text byte-identical to JAX's for every prompt whose
    activation codes matched JAX's through the prefill and every decode
    step (a tie flip may change later tokens); and, for every prompt, the
    continuous paged scheduler's text equals the static path's (the paged
    runtime reaches the same quantized modules)."""
    jc, tc = llama_pair
    want, jcaps = _capture_jax(
        lambda: jc.generate_batch(PROMPTS, max_new_tokens=8))
    got, tcaps = _capture_port(
        tc.model, lambda: tc.generate_batch(PROMPTS, max_new_tokens=8))
    flipped = _flipped_rows(jcaps, tcaps, len(PROMPTS))
    assert not flipped.all()
    for b in np.flatnonzero(~flipped):
        assert got[b] == want[b], (b, got[b], want[b])
    continuous, ccaps = _capture_port(
        tc.model, lambda: tc.generate_batch_continuous(
            PROMPTS, max_new_tokens=8, n_slots=2))
    assert ccaps
    assert continuous == got


@pytest.mark.parametrize("name", ["llama3-tiny-int8", "llama-tiny-int8"])
def test_llama_int8_suffix(name):
    clf = tl.LlamaZeroShotClassifier.from_pretrained_or_random(
        name, max_prompt_len=64, device="cpu")
    assert clf.config.quant == "int8"
    labels = clf.classify_batch(["la la love", ""])
    assert labels[1] == "Neutral"


def test_llama_weight_quant_random_init_never_holds_float_kernels():
    """Random init under weight_quant fills the codes kernel by kernel:
    the model holds no float projection or lm_head weights, its codes are
    kernel-major, and its stored bytes match the accounting."""
    from music_analyst_tpu_torch.ops.quant import (
        is_kernel_major,
        param_tree_bytes,
    )

    for scheme in ("int8", "int4"):
        clf = tl.LlamaZeroShotClassifier(
            config=tl.LlamaConfig.tiny(weight_quant=scheme),
            max_prompt_len=64, device="cpu")
        names = {n for n, _ in clf.model.named_parameters()}
        assert not any(n.endswith(("_proj.weight", "lm_head.weight"))
                       for n in names)
        for m in clf.model.modules():
            if isinstance(m, tlayers.WqLinear):
                assert is_kernel_major(m.q, m.n_contract)
        acc = param_tree_bytes(clf.model)
        assert acc["n_quantized_leaves"] == 7 * 2 + 1
        assert acc["stored_bytes"] == sum(
            t.numel() * t.element_size()
            for t in list(clf.model.parameters()) + list(clf.model.buffers()))
