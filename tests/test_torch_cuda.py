"""Card-only checks of the port's CUDA kernels against their plain versions.

These need an NVIDIA card and ``nvcc`` (the kernels have no interpret
mode); without a card they skip.  On the card:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Tolerances: the flash kernel's f32 outputs within 1e-4 of the plain
version (f32 sums in another order), its bf16 outputs within 2e-2 (half a
bf16 ulp at |o| < 8); the keyword scan exact.
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
