"""Port DistilBERT ≡ the JAX DistilBERT, with weights carried over.

The JAX classifier is built from a seed on the tiny config in float32 and
``params_from_jax`` hands its parameters to the port.  Flat, bucketed and
packed batches go through both.  Tolerance: atol 1e-4 on logits and
confidences (f32 on both sides; the flash paths fold the softmax in a
different order than the dense ones), and identical labels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu_torch.models import distilbert as td

# Small shapes: one intra-op thread is enough, and keeps these tests from
# crowding the timing-sensitive tests that parallel workers run beside them.
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 64
_WORDS = ("love", "night", "pain", "joy", "the", "música", "tears", "sun",
          "don't", "cry", "happy", "road", "!", "fire")


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.choice([0, 2, 5, 11, 20, 40, 80]))
        out.append(" ".join(rng.choice(_WORDS, size=k)))
    out[1] = "   "
    return out


@pytest.fixture(scope="module", params=["dense", "flash"])
def pair(request):
    """(jax classifier, port classifier) sharing weights, per attn_impl."""
    impl = request.param
    jcfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32",
                               attn_impl=impl)
    jclf = jd.DistilBertClassifier(config=jcfg, max_len=MAX_LEN, seed=3)
    state = td.params_from_jax(jax.tree_util.tree_map(np.asarray, jclf.params))
    tcfg = td.DistilBertConfig.tiny(dtype="float32", attn_impl=impl)
    tclf = td.DistilBertClassifier(config=tcfg, max_len=MAX_LEN,
                                   state_dict=state, device="cpu")
    return jclf, tclf, state


def test_params_from_jax_fills_every_parameter(pair):
    _, tclf, state = pair
    assert set(state) == set(tclf.model.state_dict())
    for name, value in tclf.model.state_dict().items():
        assert tuple(value.shape) == state[name].shape, name


def test_flat_logits_match(pair):
    jclf, tclf, _ = pair
    ids, lengths = jclf.tokenizer.encode_batch(_texts(1, 12), MAX_LEN)
    want = jclf.model.apply({"params": jclf.params}, jnp.asarray(ids),
                            jnp.asarray(lengths))
    got = tclf.forward_logits(torch.from_numpy(ids), torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_packed_forward_matches(pair):
    jclf, tclf, _ = pair
    ids, lengths = jclf.tokenizer.encode_batch(_texts(2, 24), MAX_LEN)
    tclf.packed = True
    try:
        [(_, _, (pids, st, rl))] = tclf._plan_packed(ids, lengths)
    finally:
        tclf.packed = False
    want_cls, want_conf = jclf._forward_packed(
        jclf.params, jnp.asarray(pids), jnp.asarray(st), jnp.asarray(rl)
    )
    with torch.inference_mode():
        got_cls, got_conf = tclf._forward_packed(
            *(torch.from_numpy(a) for a in (pids, st, rl))
        )
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf),
                               atol=ATOL)


def test_packed_logits_equal_flat_logits(pair):
    """Each song's logits through the packed path (shared rows, segment
    masks, restarted positions, CLS gather) equal its flat-row logits."""
    _, tclf, _ = pair
    texts = [t for t in _texts(5, 30) if t.strip()]
    ids, lengths = tclf.tokenizer.encode_batch(texts, MAX_LEN)
    flat = tclf.forward_logits(torch.from_numpy(ids), torch.from_numpy(lengths))
    packed = tclf.forward_logits_packed(texts)
    assert packed.shape == flat.shape
    np.testing.assert_allclose(packed.numpy(), flat.numpy(), atol=ATOL)


@pytest.mark.parametrize("mode", ["flat", "bucketed", "packed"])
def test_labels_match(pair, mode):
    jclf, tclf, _ = pair
    buckets = (16, 32, MAX_LEN) if mode == "bucketed" else None
    texts = _texts(4, 40)
    for clf in (jclf, tclf):
        clf.length_buckets, clf.packed = buckets, mode == "packed"
    try:
        assert tclf.classify_batch(texts) == jclf.classify_batch(texts)
    finally:
        for clf in (jclf, tclf):
            clf.length_buckets, clf.packed = None, False


def test_expand_packed_positions_and_segments():
    starts = torch.tensor([[0, 3, 8, 16], [0, 16, 16, 16]], dtype=torch.int16)
    row_len = torch.tensor([12, 5], dtype=torch.int16)
    seg, pos = td.expand_packed(starts, row_len, 16)
    assert seg[0].tolist() == [1] * 3 + [2] * 5 + [3] * 4 + [0] * 4
    assert seg[1].tolist() == [1] * 5 + [0] * 11
    assert pos[0, :12].tolist() == [0, 1, 2, 0, 1, 2, 3, 4, 0, 1, 2, 3]


def test_pack_segments_and_buckets_match_jax():
    rng = np.random.default_rng(9)
    lengths = rng.integers(1, 65, size=200)
    for got, want in zip(td.pack_segments(lengths, 64),
                         jd.pack_segments(lengths, 64)):
        np.testing.assert_array_equal(got, want)
    assert (td.derive_length_buckets(lengths, 128)
            == jd.derive_length_buckets(lengths, 128))


def test_model_name_suffixes():
    clf = td.DistilBertClassifier.from_pretrained_or_random(
        "distilbert-tiny-packed", device="cpu"
    )
    assert clf.packed and clf.config.dim == 64
    assert clf.config.attn_impl == "flash"
    with pytest.raises(ValueError):
        td.DistilBertClassifier.from_pretrained_or_random("distilbertx",
                                                          device="cpu")
    # -int8 and weight_quant are ported (tests/test_torch_quant_models.py).
    assert td.DistilBertClassifier.from_pretrained_or_random(
        "distilbert-tiny-int8", device="cpu").config.quant == "int8"
    assert td.DistilBertClassifier.from_pretrained_or_random(
        "distilbert-tiny", device="cpu", weight_quant="int8"
    ).config.weight_quant == "int8"


def test_hf_checkpoint_round_trip(pair, tmp_path):
    """A state dict under HF DistilBERT names loads to the same model."""
    _, tclf, state = pair
    hf = {}
    for name, value in state.items():
        key = (name.replace("encoder.layers.", "distilbert.transformer.layer.")
               .replace("encoder.word_embeddings.",
                        "distilbert.embeddings.word_embeddings.")
               .replace("encoder.position_embeddings.",
                        "distilbert.embeddings.position_embeddings.")
               .replace("encoder.embed_layer_norm.",
                        "distilbert.embeddings.LayerNorm.")
               .replace(".q_proj.", ".q_lin.").replace(".k_proj.", ".k_lin.")
               .replace(".v_proj.", ".v_lin.").replace(".o_proj.", ".out_lin."))
        hf[key] = torch.tensor(value)
    path = tmp_path / "ckpt.pt"
    torch.save(hf, path)
    model = td.DistilBertForSentiment(tclf.config)
    td.load_hf_torch_checkpoint(model, str(path))
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[name])
    hf["extra.weight"] = torch.zeros(1)
    torch.save(hf, path)
    with pytest.raises(ValueError, match="does not match"):
        td.load_hf_torch_checkpoint(model, str(path))
