"""Card-only checks of the port's CUDA kernels against their plain versions.

These need an NVIDIA card and ``nvcc`` (the kernels have no interpret
mode); without a card they skip.  On the card:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Tolerances: the flash kernel's f32 outputs within 1e-4 of the plain
version (f32 sums in another order), its bf16 outputs within 2e-2 (half a
bf16 ulp at |o| < 8); the keyword scan exact.  The paged-attention kernel
rounds an f32 result to bf16 once, so each element lies within
``2^-8 |ref| + 1e-5`` of the f32 oracle (and within 2e-2 absolute); a
free slot reads exact zeros, and garbage (NaN) in the trash page changes
nothing bit for bit.
"""

import numpy as np
import pytest
import torch

from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from music_analyst_tpu_torch.ops.keyword_kernel import (
    keyword_scan,
    keyword_scan_reference,
)
from music_analyst_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)
from music_analyst_tpu_torch.ops.quant import (
    dequantize_kv_page,
    quantize_kv_page,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


def _qkv(dev, dtype, B, S, KV, H, Hkv, D, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=gen)
    k = torch.randn(B, KV, Hkv, D, generator=gen)
    v = torch.randn(B, KV, Hkv, D, generator=gen)
    return (t.to(dev, dtype) for t in (q, k, v))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mode", ["lengths", "causal_gqa_offset", "segments"])
def test_flash_kernel_matches_plain(dev, dtype, tol, mode):
    if mode == "causal_gqa_offset":
        q, k, v = _qkv(dev, dtype, 2, 70, 150, 8, 2, 128)
        kw = dict(causal=True, q_offset=80,
                  lengths=torch.tensor([150, 97], device=dev))
    else:
        q, k, v = _qkv(dev, dtype, 3, 130, 130, 4, 4, 64)
        kw = dict(lengths=torch.tensor([130, 64, 0], device=dev))
        if mode == "segments":
            seg = torch.arange(130, device=dev).repeat(3, 1) // 40 + 1
            seg[:, 120:] = 0
            kw["q_segment_ids"] = seg
    before = kernels.launches()["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert kernels.launches()["flash_attention"] == before + 1
    assert got.dtype == dtype
    assert torch.isfinite(got).all()
    assert float((got.float() - want).abs().max()) <= tol


def test_flash_kernel_residuals(dev):
    q, k, v = _qkv(dev, torch.float32, 2, 64, 96, 4, 2, 64)
    kw = dict(causal=True, q_offset=32, return_residuals=True)
    for got, want in zip(flash_attention(q, k, v, **kw),
                         flash_attention_reference(q, k, v, **kw)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 16, 16, 2, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv(dev, torch.float32, 1, 16, 16, 2, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v)


def test_keyword_kernel_exact(dev):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, size=(300, 5000), dtype=np.uint8)
    for i, word in enumerate([b"LoVe", b"TEARS", b"sunshine", b"Joy", b"sad"]):
        x[i::5, 4090 + i:4090 + i + len(word)] = np.frombuffer(word, np.uint8)
    x = torch.from_numpy(x).to(dev)
    scores, hits = keyword_scan(x, return_hits=True)
    want_scores, want_hits = keyword_scan_reference(x)
    assert torch.equal(scores, want_scores) and torch.equal(hits, want_hits)


def _paged_case(dev, P, D, quantized, n=4, H=8, n_kv=2, pps=6, seed=0):
    """Pools with odd per-slot lengths; the last slot is free (its whole
    row on the trash page); returns (args, kwargs, trash page index)."""
    rng = np.random.default_rng(seed)
    n_pages = n * pps
    table = rng.permutation(n_pages).reshape(n, pps).astype(np.int32)
    table[-1] = n_pages
    total = pps * P - 3
    lengths = [int(rng.integers(1, total // 2)) * 2 + 1 for _ in range(n - 1)]
    mask = np.zeros((n, total), bool)
    for i, length in enumerate(lengths):
        mask[i, :length] = True
    mask[0, total - 2] = True      # a decode row past a masked gap
    keys = rng.standard_normal((n_pages + 1, P, n_kv, D)).astype(np.float32)
    values = rng.standard_normal((n_pages + 1, P, n_kv, D)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((n, 1, H, D)),
                        dtype=torch.bfloat16, device=dev)
    k, v = torch.as_tensor(keys, device=dev), torch.as_tensor(values, device=dev)
    kw = {}
    if quantized:
        k, ks = quantize_kv_page(k)
        v, vs = quantize_kv_page(v)
        kw = dict(key_scale=ks, value_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    args = (q, k, v, torch.as_tensor(table, device=dev),
            torch.as_tensor(mask, device=dev))
    return args, kw, n_pages


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("P,D", [(8, 64), (16, 128), (64, 128)])
def test_paged_kernel_matches_oracle(dev, P, D, quantized):
    args, kw, trash = _paged_case(dev, P, D, quantized)
    before = kernels.launches()["paged_attention"]
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches()["paged_attention"] == before + 1
    if quantized:
        # The oracle on the rows the kernel's load produces (codes x scale
        # rounded to bf16, as the TPU kernel does after its DMA).
        q, k, v, table, mask = args
        ref = paged_attention_reference(
            q, dequantize_kv_page(k, kw["key_scale"]),
            dequantize_kv_page(v, kw["value_scale"]), table, mask)
    else:
        ref = paged_attention_reference(*args, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    # The oracle averages the free slot's fully masked row; compare the
    # active slots (the free slot is checked for zeros below).
    err = (got[:-1].float() - ref[:-1]).abs()
    assert float(err.max()) <= 2e-2
    assert bool((err <= 2.0 ** -8 * ref[:-1].abs() + 1e-5).all())
    assert bool((got[-1] == 0).all())            # free slot: exact zeros
    q, k, v, table, mask = args
    k, v = k.clone(), v.clone()
    if quantized:
        k[trash], v[trash] = 127, -127
        kw = {name: s.clone() for name, s in kw.items()}
        kw["key_scale"][trash] = float("nan")
        kw["value_scale"][trash] = float("nan")
    else:
        k[trash], v[trash] = float("nan"), float("inf")
    dirty = paged_attention(q, k, v, table, mask, **kw)
    assert torch.equal(dirty, got)


def test_paged_kernel_rejects_what_it_cannot_take(dev):
    args, kw, _ = _paged_case(dev, 8, 64, False)
    q, k, v, table, mask = args
    with pytest.raises(TypeError, match="bf16 q"):
        paged_attention(q.float(), k, v, table, mask)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), table, mask)
    with pytest.raises(ValueError, match="decode kernel"):
        paged_attention(q.expand(-1, 2, -1, -1).contiguous(), k, v, table, mask)
