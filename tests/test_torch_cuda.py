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
nothing bit for bit.  The bf16 flash kernel (wgmma) is held to the same
elementwise half-ulp bound as the paged kernel; both agree bit for bit
between two launches on the same inputs.
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


def _within_bf16_bound(got, want):
    """The bf16 kernel rounds its f32 result once: half a bf16 ulp of the
    f32 plain version, 2^-8 |ref| + 1e-5 elementwise, and 2e-2 absolute."""
    err = (got.float() - want).abs()
    return (float(err.max()) <= 2e-2
            and bool((err <= 2.0 ** -8 * want.abs() + 1e-5).all()))


@pytest.mark.parametrize("S", [1, 64, 127, 128, 129, 200])
def test_flash_bf16_ragged_rows(dev, S):
    """Query tiles of 128 rows and kv tiles of 64 with S and KV on neither
    boundary; one row of length 0 reads exact zeros."""
    q, k, v = _qkv(dev, torch.bfloat16, 3, S, 150, 4, 2, 64, seed=S)
    kw = dict(lengths=torch.tensor([150, 97, 0], device=dev))
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    assert _within_bf16_bound(got, want)
    assert bool((got[2] == 0).all())
    assert torch.equal(flash_attention(q, k, v, **kw), got)   # run to run


def test_flash_bf16_segments_cross_tiles(dev):
    """Block-diagonal segments whose edges fall inside 64-row tiles, with
    kv segment ids of their own (KV != S)."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 150, 190, 4, 4, 64, seed=3)
    q_seg = (torch.arange(150, device=dev) // 50 + 1).repeat(2, 1)
    kv_seg = (torch.arange(190, device=dev) // 70 + 1).repeat(2, 1)
    kw = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              lengths=torch.tensor([190, 120], device=dev))
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    assert _within_bf16_bound(got, want)


def test_flash_bf16_residuals_d128(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 2, 130, 150, 8, 2, 128, seed=5)
    kw = dict(causal=True, q_offset=32, return_residuals=True,
              lengths=torch.tensor([150, 0], device=dev))
    o, m, l = flash_attention(q, k, v, **kw)
    ro, rm, rl = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    live = rl > 0
    norm = lambda o, l: o / l.clamp(min=1e-30).permute(0, 2, 1)[..., None]  # noqa: E731
    assert float((norm(o, l) - norm(ro, rl)).abs().max()) <= 1e-3
    assert float((m - rm).abs()[live].max()) <= 1e-3
    assert float(((l - rl).abs() / rl.clamp(min=1e-30))[live].max()) <= 1e-3
    assert bool((o[1] == 0).all()) and bool((l[1] == 0).all())


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


def _assert_scan_exact(x):
    before = kernels.launches()["keyword_scan"]
    scores, hits = keyword_scan(x, return_hits=True)
    want_scores, want_hits = keyword_scan_reference(x)
    assert kernels.launches()["keyword_scan"] == before + 1
    assert torch.equal(scores, want_scores) and torch.equal(hits, want_hits)
    return want_scores, want_hits


@pytest.mark.parametrize("L", [512, 528, 1000])
def test_keyword_kernel_row_boundary(dev, L):
    """A keyword split across two rows (``...lo`` | ``ve...``) is in
    neither; whole keywords at both ends of a row are found."""
    x = np.zeros((6, L), np.uint8)
    x[0, L - 2:] = np.frombuffer(b"LO", np.uint8)
    x[1, :2] = np.frombuffer(b"ve", np.uint8)
    x[2, L - 4:] = np.frombuffer(b"sUNS", np.uint8)
    x[3, :4] = np.frombuffer(b"hine", np.uint8)
    x[4, :5] = np.frombuffer(b"Tears", np.uint8)
    x[5, L - 6:] = np.frombuffer(b"lonely", np.uint8)
    scores, hits = _assert_scan_exact(torch.from_numpy(x).to(dev))
    assert scores.tolist() == [0, 0, 0, 0, -1, -1]


@pytest.mark.parametrize("L", [4096, 5000])
def test_keyword_kernel_offset_view(dev, L):
    """A view one byte off 16-byte alignment takes the byte-load instance
    of the kernel and gives the same answer."""
    rng = np.random.default_rng(L)
    x = rng.integers(0, 256, size=(40, L), dtype=np.uint8)
    for i, word in enumerate([b"SMILE", b"cry", b"Pain", b"HAPPY"]):
        x[i::4, L - 9 + i:L - 9 + i + len(word)] = np.frombuffer(word, np.uint8)
    flat = torch.empty(x.size + 1, dtype=torch.uint8, device=dev)
    view = flat[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _assert_scan_exact(view)


def test_keyword_kernel_refuses_a_drifted_table(dev):
    """The kernel's keywords are compile-time constants: the C entry
    returns cudaErrorInvalidValue (1) for a host table that differs."""
    from music_analyst_tpu_torch.ops import keyword_kernel as kk

    x = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    scores = torch.empty(2, dtype=torch.int32, device=dev)
    fn = kernels.kernel("keyword_scan")
    stream = torch.cuda.current_stream().cuda_stream
    patterns, signs = kk._PATTERNS.copy(), kk._SIGNS.copy()
    patterns[0] += 1                                   # "lovf"
    signs[-1] = 1
    n = len(kk.KEYWORDS)
    for p, s, count in ((patterns, kk._SIGNS, n), (kk._PATTERNS, signs, n),
                        (kk._PATTERNS, kk._SIGNS, n - 1)):
        status = fn(x.data_ptr(), 2, 64, p.ctypes.data, kk._MASKS.ctypes.data,
                    s.ctypes.data, count, scores.data_ptr(), None, stream)
        assert status == 1
    assert fn(x.data_ptr(), 2, 64, kk._PATTERNS.ctypes.data,
              kk._MASKS.ctypes.data, kk._SIGNS.ctypes.data, n,
              scores.data_ptr(), None, stream) == 0
    torch.cuda.synchronize()
    assert scores.tolist() == [0, 0]


@pytest.mark.parametrize("L", [1, 3, 4, 7, 8, 17])
def test_keyword_kernel_small_rows(dev, L):
    rng = np.random.default_rng(L)
    x = rng.integers(60, 123, size=(33, L), dtype=np.uint8)
    x[::3, :min(L, 3)] = np.frombuffer(b"SaD", np.uint8)[:min(L, 3)]
    _assert_scan_exact(torch.from_numpy(x).to(dev))
    _assert_scan_exact(torch.from_numpy(x[:1].copy()).to(dev))   # B = 1


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


def test_paged_kernel_empty_splits_and_one_key(dev):
    """Splits with no valid key, a slot with exactly one valid key (it reads
    that key's value row: p = 1), total not a multiple of P; two launches
    agree bit for bit."""
    args, kw, _ = _paged_case(dev, 16, 128, False, n=4, H=8, n_kv=2, pps=20)
    q, k, v, table, mask = args
    mask = torch.zeros_like(mask)
    total = mask.shape[1]
    mask[0, :5] = True
    mask[1, total - 7] = True
    mask[2, 60:70] = True
    got = paged_attention(q, k, v, table, mask)
    again = paged_attention(q, k, v, table, mask)
    ref = paged_attention_reference(q, k, v, table, mask)
    err = (got[:-1].float() - ref[:-1]).abs()
    assert float(err.max()) <= 2e-2
    assert bool((err <= 2.0 ** -8 * ref[:-1].abs() + 1e-5).all())
    j = total - 7
    row = v[int(table[1, j // 16]), j % 16]                       # [n_kv, D]
    assert torch.equal(got[1, 0], row.repeat_interleave(4, dim=0))
    assert bool((got[-1] == 0).all())
    assert torch.equal(got, again)


def test_paged_kernel_on_two_streams(dev):
    """Each call owns its scratch (partials and tickets) on its stream, so
    calls in flight on two streams at once each give the default stream's
    result bit for bit."""
    args, kw, _ = _paged_case(dev, 16, 128, False)
    want = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(paged_attention(*args, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


# ------------------------------------------------ word-count histograms
# Exact against np.bincount (integer counts, order-free atomics).


def _zipf_ids(n, ranks, seed, pad_share=0.01):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, ranks + 1)
    ids = rng.permutation(ranks)[rng.choice(ranks, size=n, p=p / p.sum())]
    ids[rng.random(n) < pad_share] = -1
    return ids.astype(np.int32)


def _bincount(ids, vocab):
    return np.bincount(ids[(ids >= 0) & (ids < vocab)], minlength=vocab)


def _one_card_mesh(dev):
    from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh

    return data_parallel_mesh(device=dev)


def test_histogram_pad_ids_and_empty_stream(dev):
    from music_analyst_tpu_torch.ops.histogram import token_histogram

    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 1000, size=1_000_003).astype(np.int32)
    ids[:5] = [-1, -7, 999, 1000, 5000]          # PAD_ID, negative, past vocab
    got = token_histogram(torch.from_numpy(ids).to(dev), 1000)
    assert got.device == dev and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), _bincount(ids, 1000))
    empty = token_histogram(torch.zeros(0, dtype=torch.int32, device=dev), 9)
    np.testing.assert_array_equal(empty.cpu().numpy(), np.zeros(9))
    one = token_histogram(torch.tensor([0, -1, 0, 3], dtype=torch.int32,
                                       device=dev), 1)
    assert one.cpu().tolist() == [2]


def test_histogram_zipf_hot_stream_both_device_paths(dev):
    from music_analyst_tpu_torch.ops.histogram import (
        sharded_histogram,
        sharded_histogram_streaming,
    )

    vocab = 1 << 18
    ids = _zipf_ids(20_000_000, vocab, seed=1)
    want = _bincount(ids, vocab)
    mesh = _one_card_mesh(dev)
    got = sharded_histogram(ids, vocab, mesh)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    offsets = np.arange(0, ids.shape[0] + 1, 150, dtype=np.int64)
    offsets[-1] = ids.shape[0]
    stream = sharded_histogram_streaming(ids, offsets, vocab, mesh,
                                         chunk_songs=10_000)
    np.testing.assert_array_equal(stream, want)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_histogram_streaming_reuses_its_buffer_ring(dev, depth):
    """Many more chunks than ring slots, of uneven sizes, so every pinned
    and device buffer is rewritten many times: the counts must equal the
    whole put's.  Reusing a pinned buffer before its copy has completed,
    or a device buffer before its accumulate, would change them."""
    from music_analyst_tpu_torch.ops.histogram import (
        chunk_token_bounds,
        sharded_histogram,
        sharded_histogram_streaming,
    )

    rng = np.random.default_rng(2 + depth)
    vocab = 50_000
    ids = _zipf_ids(6_000_000, vocab, seed=3)
    cuts = np.sort(rng.integers(0, ids.shape[0], size=3_999))
    offsets = np.concatenate([[0], cuts, [ids.shape[0]]]).astype(np.int64)
    mesh = _one_card_mesh(dev)
    whole = sharded_histogram(ids, vocab, mesh).cpu().numpy()
    assert len(chunk_token_bounds(offsets, 37)) - 1 > 10 * (depth + 1)
    for _ in range(3):
        got = sharded_histogram_streaming(ids, offsets, vocab, mesh,
                                          chunk_songs=37, prefetch_depth=depth)
        np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(whole, _bincount(ids, vocab))


def test_histogram_device_ids_holds_no_int64_copy(dev):
    """The device-ids path keeps 4 bytes per id on the card plus one
    slice of temporaries; an int64 copy of the stream would add 8 per id."""
    from music_analyst_tpu_torch.ops import histogram

    n, vocab = 64 << 20, 1 << 16
    ids = np.random.default_rng(4).integers(-1, vocab, size=n).astype(np.int32)
    mesh = _one_card_mesh(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = histogram.sharded_histogram(ids, vocab, mesh).cpu().numpy()
    peak = torch.cuda.max_memory_allocated(dev) - base
    np.testing.assert_array_equal(got, _bincount(ids, vocab))
    limit = 4 * n + 8 * histogram._SLICE + 8 * (vocab + 1) + (8 << 20)
    assert peak <= limit < 12 * n, (peak, limit)
