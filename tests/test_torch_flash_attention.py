"""Port flash attention (plain version, CPU) ≡ the JAX flash kernel.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as its own
tests do.  Inputs are float32, drawn with numpy from a seed.  Tolerance:
atol 1e-5 — both sides accumulate in f32, in different orders (the JAX
kernel folds kv blocks online, the plain version softmaxes in one pass).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models.layers import (
    causal_mask,
    dot_product_attention as jax_dpa,
    padding_mask,
    segment_mask,
)
from music_analyst_tpu.ops.flash_attention import flash_attention as jax_flash
from music_analyst_tpu_torch.models import layers as tl
from music_analyst_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_reference,
)

# Small shapes: one intra-op thread is enough, and keeps these tests from
# crowding the timing-sensitive tests that parallel workers run beside them.
torch.set_num_threads(1)

ATOL = 1e-5


def _qkv(seed, B, S, H, D, n_kv=None, kv_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, kv_len or S, n_kv or H, D)).astype(np.float32)
    v = rng.standard_normal((B, kv_len or S, n_kv or H, D)).astype(np.float32)
    return q, k, v


def _segments(seed, B, S, pad_tail):
    """Packed-row segment ids: a few runs per row, then a 0-id padding tail."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S - pad_tail), 3, replace=False))
        bounds = [0, *cuts, S - pad_tail]
        for i in range(len(bounds) - 1):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


CASES = {
    "lengths": dict(shape=(3, 64, 2, 64), lengths=[64, 37, 1]),
    "causal_gqa": dict(shape=(2, 64, 4, 64), n_kv=2, causal=True),
    "causal_lengths_d128": dict(shape=(2, 64, 2, 128), causal=True,
                                lengths=[50, 64]),
    "segments": dict(shape=(2, 64, 2, 64), segments=True, lengths=[56, 56]),
    "offsets": dict(shape=(2, 32, 2, 64), kv_len=64, causal=True,
                    q_offset=40, kv_offset=8, lengths=[72, 60]),
    "fully_masked_row": dict(shape=(2, 32, 2, 64), lengths=[0, 32]),
}


def _run_case(case, residuals=False):
    B, S, H, D = case["shape"]
    q, k, v = _qkv(zlib.crc32(repr(sorted(case.items())).encode()), B, S, H, D,
                   case.get("n_kv"), case.get("kv_len"))
    lengths = (np.asarray(case["lengths"], np.int32)
               if "lengths" in case else None)
    seg = _segments(7, B, S, pad_tail=8) if case.get("segments") else None
    kwargs = dict(causal=case.get("causal", False),
                  q_offset=case.get("q_offset", 0),
                  kv_offset=case.get("kv_offset", 0),
                  return_residuals=residuals)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=None if lengths is None else jnp.asarray(lengths),
        q_segment_ids=None if seg is None else jnp.asarray(seg), **kwargs,
    )
    tq, tk, tv, tlen, tseg = _t(q, k, v, lengths, seg)
    got = flash_attention(tq, tk, tv, lengths=tlen, q_segment_ids=tseg,
                          **kwargs)
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_kernel(name):
    got, want = _run_case(CASES[name])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["causal_gqa", "offsets", "fully_masked_row"])
def test_residual_mode_matches_jax_kernel(name):
    (o, m, l), (wo, wm, wl) = _run_case(CASES[name], residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(wo), atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(wl), atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(m.numpy() == NEG_INF, np.asarray(wm) == NEG_INF)
    live = m.numpy() != NEG_INF
    np.testing.assert_allclose(m.numpy()[live], np.asarray(wm)[live], atol=ATOL)


def test_fully_masked_rows_are_exact_zeros():
    got, _ = _run_case(CASES["fully_masked_row"])
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()


@pytest.mark.parametrize("mode", ["lengths", "causal_gqa", "segments"])
def test_matches_dense_attention(mode):
    """Where the masks agree (every query keeps a key), flash ≡ the dense
    formulation, for JAX's dense function and for the port's."""
    B, S, H, D = 2, 64, 4, 64
    n_kv = 2 if mode == "causal_gqa" else None
    q, k, v = _qkv(11, B, S, H, D, n_kv)
    lengths = np.asarray([64, 40], np.int32)
    seg = _segments(3, B, S, pad_tail=0)
    if mode == "lengths":
        mask = padding_mask(jnp.asarray(lengths), S)
        kw = dict(lengths=torch.from_numpy(lengths))
    elif mode == "causal_gqa":
        mask = causal_mask(S, S, 0)
        kw = dict(causal=True)
    else:
        mask = segment_mask(jnp.asarray(seg))
        kw = dict(q_segment_ids=torch.from_numpy(seg))
    want = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=mask))
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk, tv, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    port_dense = tl.dot_product_attention(
        tq, tk, tv, mask=torch.from_numpy(np.array(mask))
    ).numpy()
    np.testing.assert_allclose(port_dense, want, atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _t(*_qkv(5, 1, 16, 2, 64))
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True),
        flash_attention_reference(q, k, v, causal=True), rtol=0, atol=0,
    )


def test_bf16_output_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(6, 1, 16, 2, 64)))
    assert flash_attention(q, k, v).dtype == torch.bfloat16


def test_argument_checks():
    q, k, v = _t(*_qkv(8, 2, 16, 3, 64, n_kv=2))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k, v)
    q, k, v = _t(*_qkv(8, 2, 16, 2, 64, kv_len=32))
    seg = torch.ones(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_segment_ids is required"):
        flash_attention(q, k, v, q_segment_ids=seg)
    with pytest.raises(ValueError, match="without q_segment_ids"):
        flash_attention(q, k, v, kv_segment_ids=torch.ones(2, 32))
