"""The port's Llama flash no-cache path ≡ JAX's, and the kernel refuses
autograd.

A two-layer f32 Llama (dim 32, GQA 4/2, head dim 8) with ``attn_impl=
"flash"``: JAX runs its Pallas kernel in interpret mode, the port the
kernel's plain version (the CPU tensors' path).  Tolerances: port against
JAX within 1e-4 and flash against the port's dense forward within 1e-4
(f32 on both sides; the flash forms normalise once at the end, dense per
row, so sums differ in order), over every position of every row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.models import layers as tlayers
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

torch.set_num_threads(1)

ATOL = 1e-4
S = 32
CFG = dict(vocab_size=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=64, rope_theta=1e4, max_seq_len=64, dtype="float32",
           attn_impl="flash")


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig(**CFG)
    jmodel = jl.LlamaModel(jcfg)
    ids = jnp.zeros((1, S), jnp.int32)
    params = jmodel.init(jax.random.key(0), ids, ids,
                         jnp.ones((1, 1, S, S), bool))["params"]
    sd = {k: torch.tensor(np.asarray(v)) for k, v in tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    flash = tl.LlamaModel(tl.LlamaConfig(**CFG))
    flash.load_state_dict(sd)
    dense = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, attn_impl="dense")))
    dense.load_state_dict(sd)
    return jmodel, params, flash.eval(), dense.eval()


def _ids(seed, B=3):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32)


def test_unpacked_forward_matches_jax_and_dense(models):
    jmodel, params, flash, dense = models
    ids = _ids(0)
    lengths = np.array([S, 20, 7], np.int32)
    pos = np.broadcast_to(np.arange(S), ids.shape).copy()
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                           jnp.asarray(pos), None,
                           lengths=jnp.asarray(lengths))
    t = torch.tensor
    with torch.no_grad():
        got, _ = flash(t(ids), t(pos), None, lengths=t(lengths))
        mask = (tlayers.causal_mask(S, S, 0)
                & tlayers.padding_mask(t(lengths).long(), S))
        ref, _ = dense(t(ids), t(pos), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_packed_forward_matches_jax_and_dense(models):
    """Two or three documents per row, positions restarted at each, pad
    tokens in segment 0."""
    jmodel, params, flash, dense = models
    ids = _ids(1)
    seg = np.zeros((3, S), np.int32)
    seg[0, :12], seg[0, 12:30] = 1, 2
    seg[1, :5], seg[1, 5:20], seg[1, 20:] = 1, 2, 3
    seg[2, :S] = 1
    pos = np.zeros_like(seg)
    for b in range(3):
        for s in range(1, S):
            pos[b, s] = pos[b, s - 1] + 1 if seg[b, s] == seg[b, s - 1] else 0
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                           jnp.asarray(pos), None,
                           segment_ids=jnp.asarray(seg))
    t = torch.tensor
    with torch.no_grad():
        got, _ = flash(t(ids), t(pos), None, segment_ids=t(seg))
        mask = tlayers.causal_mask(S, S, 0) & tlayers.segment_mask(t(seg))
        ref, _ = dense(t(ids), t(pos), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_segment_ids_refused_off_the_flash_no_cache_path(models):
    _, _, flash, dense = models
    ids = torch.tensor(_ids(2, B=1))
    pos = torch.arange(S)[None]
    seg = torch.ones(1, S, dtype=torch.int32)
    with torch.no_grad(), pytest.raises(ValueError, match="flash prefill"):
        dense(ids, pos, tlayers.causal_mask(S, S, 0), segment_ids=seg)
    caches = tl.init_caches(flash.config, 1, S)
    with torch.no_grad(), pytest.raises(ValueError, match="flash prefill"):
        flash(ids, pos, tlayers.causal_mask(S, S, 0), caches,
              segment_ids=seg)


def test_mask_array_on_the_flash_branch_raises():
    attn = tlayers.MultiHeadAttention(32, 4, attn_impl="flash",
                                      dtype=torch.float32, n_kv_heads=2,
                                      use_rope=True, flash_causal=True)
    x = torch.randn(1, 8, 32)
    with torch.no_grad(), pytest.raises(ValueError, match="mask array"):
        attn(x, mask=tlayers.causal_mask(8, 8, 0))
    with torch.no_grad():
        assert attn(x).shape == (1, 8, 32)


def test_flash_attention_refuses_autograd():
    """A backward through the kernel would give q, k and v no gradient on
    the card, so on both devices the forward runs and a backward through
    it raises, as differentiating the Pallas kernel does."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, generator=gen)
    v = torch.randn(1, 16, 2, 8, generator=gen)
    out = flash_attention(q, k, v, causal=True)
    assert out.requires_grad
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()
    assert q.grad is None
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert not out.requires_grad
    np.testing.assert_allclose(
        out.numpy(),
        flash_attention_reference(q, k, v, causal=True).detach().numpy(),
        atol=1e-6)
    # Inputs that need no gradient give a result that needs none.
    assert not flash_attention(q.detach(), k, v).requires_grad


def test_flash_model_with_trainable_weights_refuses_backward(models):
    _, _, flash, _ = models
    model = tl.LlamaModel(tl.LlamaConfig(**CFG))
    model.load_state_dict(flash.state_dict())
    ids = torch.tensor(_ids(3, B=1))
    pos = torch.arange(S)[None]
    logits, _ = model(ids, pos, None)
    with pytest.raises(NotImplementedError, match="no backward"):
        logits.sum().backward()
    with torch.no_grad():
        want, _ = model(ids, pos, None)
    np.testing.assert_array_equal(logits.detach().numpy(), want.numpy())
    assert logits.shape == (1, S, CFG["vocab_size"])
