"""Port paged attention ≡ the JAX paged attention, on the same pools.

Pools, tables and masks are made from a seed with numpy (odd per-slot
lengths, a decode row past a masked gap, a free slot whose row sits on the
trash page, garbage in the trash page) and handed to both packages; int8
pools share one set of codes and scales.  Tolerances:

* the port's plain version (the exact body's reduction order) against JAX
  ``paged_attention(interpret=True)`` with ``stream=False`` and
  ``stream=True``, elementwise within ``REL * scale + 1e-6``, where
  ``scale`` is attention over ``|V|`` (the f32 oracle with the values'
  magnitudes): each output is a sum of weighted values, and a relative
  rounding of each term is bounded by that sum of magnitudes, also where
  the signed sum cancels.  Against the exact body the active slots are
  bitwise equal; ``REL`` (two bf16 roundings, 2^-7) covers the free slot's
  fully masked row, whose average over int8 trash rows XLA computes
  without the bf16 rounding of the dequantized rows.  ``STREAM_REL`` covers
  the streaming body;
* the port's f32 oracle against JAX's: 1e-5 (f32 sums in another order);
* the plain version against the port's dense attention over the gathered
  view: bitwise, which is what keeps paged decode byte-identical to dense
  decode on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.ops import paged_attention as jpa
from music_analyst_tpu.ops.quant import quantize_kv_page as jax_quantize
from music_analyst_tpu_torch.models.layers import dot_product_attention
from music_analyst_tpu_torch.ops import paged_attention as tpa
from music_analyst_tpu_torch.ops.quant import (
    dequantize_kv_page,
    quantize_kv_page,
)

torch.set_num_threads(1)

REL = 2.0 ** -7
# The TPU streaming body rounds its QK logits to bf16 before the softmax
# (its einsum returns the input dtype), which moves the weights by about a
# bf16 rounding of the logits: measured up to 1.9 x 2^-8 of the scale on
# these cases, bounded at 2^-6.
STREAM_REL = 2.0 ** -6


def _case(seed, P, quantized, n=4, H=4, n_kv=2, D=8, pps=4, garbage=7.0):
    rng = np.random.default_rng(seed)
    n_pages = n * pps
    table = rng.permutation(n_pages).reshape(n, pps).astype(np.int32)
    table[-1] = n_pages                    # free slot: all trash
    total = pps * P - 1
    mask = np.zeros((n, total), bool)
    for i in range(n - 1):
        mask[i, :int(rng.integers(0, total // 3)) * 2 + 1] = True
    mask[0, total - 2] = True              # decode row past a masked gap
    shape = (n_pages + 1, P, n_kv, D)
    keys = rng.standard_normal(shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    keys[n_pages] = garbage
    values[n_pages] = -garbage
    q = torch.tensor(rng.standard_normal((n, 1, H, D)), dtype=torch.bfloat16)
    case = dict(q=q, table=torch.tensor(table), mask=torch.tensor(mask),
                key_scale=None, value_scale=None)
    if quantized:
        case["key_pages"], case["key_scale"] = quantize_kv_page(torch.tensor(keys))
        case["value_pages"], case["value_scale"] = quantize_kv_page(
            torch.tensor(values))
    else:
        case["key_pages"] = torch.tensor(keys).to(torch.bfloat16)
        case["value_pages"] = torch.tensor(values).to(torch.bfloat16)
    return case


def _args(case):
    return (case["q"], case["key_pages"], case["value_pages"], case["table"],
            case["mask"])


def _scales(case):
    return dict(key_scale=case["key_scale"], value_scale=case["value_scale"])


def _jax(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _abs_scale(case):
    """Attention over |V|: the magnitude of the terms each output sums."""
    q, kp, vp, table, mask = _args(case)
    return tpa.paged_attention_reference(q, kp, vp.abs(), table, mask,
                                         **_scales(case)).numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("stream", [False, True])
def test_plain_matches_jax_kernel(P, quantized, stream):
    case = _case(P + quantized, P, quantized)
    got = tpa.paged_attention(*_args(case), **_scales(case)).float().numpy()
    want = _np(jpa.paged_attention(
        *(_jax(t) for t in _args(case)),
        **{k: _jax(v) for k, v in _scales(case).items()},
        interpret=True, stream=stream))
    # The free slot (last row) is fully masked: the exact order averages
    # its trash values, as dense attention does; the streaming body (and
    # the CUDA kernel) give zeros.  Neither is ever read.
    scale = _abs_scale(case)
    if not stream:
        assert np.array_equal(got[:-1], want[:-1])
    else:
        assert np.all(want[-1] == 0)
        got, want, scale = got[:-1], want[:-1], scale[:-1]
    rel = STREAM_REL if stream else REL
    assert np.all(np.abs(got - want) <= rel * scale + 1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_oracle_matches_jax_oracle(quantized):
    case = _case(3, 8, quantized)
    got = tpa.paged_attention_reference(*_args(case), **_scales(case)).numpy()
    want = _np(jpa.paged_attention_reference(
        *(_jax(t) for t in _args(case)),
        **{k: _jax(v) for k, v in _scales(case).items()}))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_plain_equals_dense_over_gathered_view(quantized):
    case = _case(5, 16, quantized)
    q, kp, vp, table, mask = _args(case)
    idx = table.long()
    k, v = kp[idx], vp[idx]
    if quantized:
        k = dequantize_kv_page(k, case["key_scale"][idx], q.dtype)
        v = dequantize_kv_page(v, case["value_scale"][idx], q.dtype)
    n, pps, P = k.shape[:3]
    total = mask.shape[-1]
    k = k.reshape(n, pps * P, *k.shape[3:])[:, :total]
    v = v.reshape(n, pps * P, *v.shape[3:])[:, :total]
    dense = dot_product_attention(q, k, v, mask[:, None, None, :])
    assert torch.equal(tpa.paged_attention_plain(*_args(case), **_scales(case)),
                       dense)


def test_trash_garbage_changes_nothing():
    """Active slots never read the trash page (the free slot's fully
    masked row averages it, as dense attention does, and is never read)."""
    clean = tpa.paged_attention(*_args(_case(9, 8, False, garbage=0.0)))
    dirty = tpa.paged_attention(*_args(_case(9, 8, False, garbage=1e4)))
    assert torch.equal(clean[:-1], dirty[:-1])


def test_quantize_matches_jax():
    x = np.random.default_rng(4).standard_normal((5, 8, 2, 16)).astype(np.float32)
    codes, scale = quantize_kv_page(torch.tensor(x))
    jcodes, jscale = jax_quantize(jnp.asarray(x))
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = dequantize_kv_page(codes, scale, torch.float32)
    assert torch.equal(quantize_kv_page(back)[0], codes)


@pytest.mark.parametrize("quantized", [False, True])
def test_view_update_lands_in_physical_page(quantized):
    case = _case(3, 8, quantized)
    n = case["table"].shape[0]
    lengths = torch.tensor([5, 17, 30, 2], dtype=torch.int32)
    view = tpa.PagedAttnView(
        keys=case["key_pages"].clone(), values=case["value_pages"].clone(),
        key_scale=None if case["key_scale"] is None else case["key_scale"].clone(),
        value_scale=None if case["value_scale"] is None else case["value_scale"].clone(),
        table=case["table"], length=lengths, page_size=8,
        total=case["mask"].shape[-1])
    k_new = torch.tensor(np.random.default_rng(9).standard_normal((n, 1, 2, 8)),
                         dtype=torch.bfloat16)
    new = view.update(k_new, k_new * 2)
    assert torch.equal(new.length, lengths + 1)
    table = case["table"].numpy()
    for s in range(n):
        off = int(lengths[s])
        phys, r = table[s, off // 8], off % 8
        if quantized:
            codes, scale = quantize_kv_page(k_new[s, 0])
            assert torch.equal(new.keys[phys, r], codes)
            assert torch.equal(new.key_scale[phys, r], scale)
        elif s < n - 1:    # the free slot's write lands in the trash page
            assert torch.equal(new.keys[phys, r], k_new[s, 0])
            assert torch.equal(new.values[phys, r], k_new[s, 0] * 2)
    mask = torch.arange(view.total)[None, :] < (lengths + 1)[:, None]
    out = new.attend(case["q"], mask[:, None, None, :])
    direct = tpa.paged_attention(case["q"], new.keys, new.values, new.table,
                                 mask, key_scale=new.key_scale,
                                 value_scale=new.value_scale)
    assert torch.equal(out, direct)


def test_geometry_and_argument_validation():
    case = _case(0, 8, False)
    q, kp, vp, table, mask = _args(case)
    with pytest.raises(ValueError, match="decode kernel"):
        tpa.paged_attention(q.expand(-1, 2, -1, -1), kp, vp, table, mask)
    with pytest.raises(ValueError, match="passed together"):
        tpa.paged_attention(q, kp, vp, table, mask,
                            key_scale=torch.ones(kp.shape[:2]))
    with pytest.raises(ValueError, match="exceeds slot span"):
        tpa.paged_attention(q, kp, vp, table[:, :1], mask)
    with pytest.raises(ValueError, match="one decode token"):
        tpa.PagedAttnView(kp, vp, None, None, table,
                          torch.zeros(4, dtype=torch.int32), 8, 31).update(
            torch.zeros(4, 2, 2, 8), torch.zeros(4, 2, 2, 8))
