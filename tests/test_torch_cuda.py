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

import dataclasses

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


# ----------------------------------------------------- quantized products
#
# The int8 products are library calls (torch._int_mm); the plain versions
# compute the same integer sums exactly in float64 on the CPU, so the card
# must agree within 1e-6 of the output's scale (f32 epilogues, group sums
# in another order).


def _quant_case(M, K, N, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K, N, generator=gen) * K ** -0.5
    return x, w


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("scheme", ["dynamic", "int8", "int4"])
def test_quantized_products_match_plain(dev, M, scheme):
    from music_analyst_tpu_torch.ops import quant

    x, w = _quant_case(M, 1024, 768, seed=M)
    if scheme == "dynamic":
        run = lambda xx, ww: quant.quant_matmul(xx, ww)  # noqa: E731
        args = (w,)
    else:
        qp = quant.quantize_array(w, scheme)
        run = lambda xx, qq: quant.wq_matmul(xx, qq)  # noqa: E731
        args = (qp,)
    want = run(x, *args)
    card_args = (args[0].to(dev),) if scheme == "dynamic" else (
        quant.kernel_major(args[0].to(dev)),)
    before = quant.quant_calls()["int_mm"]
    got = run(x.to(dev), *card_args)
    again = run(x.to(dev), *card_args)
    torch.cuda.synchronize()
    assert quant.quant_calls()["int_mm"] > before
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-6 * scale
    assert torch.equal(got, again)            # repeat launches bitwise equal


def test_quantized_product_pads_short_rows(dev):
    from music_analyst_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(3)
    qx = torch.randint(-127, 128, (8, 256), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (96, 256), generator=gen, dtype=torch.int8)
    got = quant.int8_matmul(qx.to(dev), w.to(dev).t())
    assert torch.equal(got.cpu(), quant.int8_matmul_plain(qx, w.t()))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(qx[:, :60].to(dev), w[:, :60].to(dev).t()[:, :90])


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_wq_linear_on_the_card_equals_the_cpu(dev, scheme):
    from music_analyst_tpu_torch.models.layers import WqLinear

    gen = torch.Generator().manual_seed(4)
    cpu = WqLinear(256, 256, scheme, dtype=torch.float32,
                   kernel_shape=(4, 64, 256), n_contract=2)
    cpu.quantize_from_(torch.randn(256, 256, generator=gen) / 16)
    with torch.no_grad():
        cpu.bias.copy_(torch.randn(256, generator=gen))
    card = WqLinear(256, 256, scheme, dtype=torch.float32,
                    kernel_shape=(4, 64, 256), n_contract=2, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 5, 256, generator=gen)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-6 * float(
        want.abs().max())


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantized_paged_decode_step_matches_dense(dev, scheme):
    """One decode step of a weight-quantized Llama (head_dim 128) through
    the paged kernel against dense attention over the gathered view:
    within 5e-2 of the logit scale, as the bf16 model's check."""
    from music_analyst_tpu_torch.models.layers import KVCache, WqLinear
    from music_analyst_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaZeroShotClassifier,
    )
    from music_analyst_tpu_torch.ops.paged_attention import (
        PagedAttnView,
        _gather,
    )
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )

    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, hidden_dim=512,
                           weight_quant=scheme)
    clf = LlamaZeroShotClassifier(config=cfg, max_prompt_len=128, device=dev)
    assert isinstance(clf.model.lm_head, WqLinear)
    sched = ContinuousScheduler(clf, n_slots=4, prefill_chunk=64,
                                prompt_region=128, max_new_tokens=8)
    for i in range(4):
        sched.submit(i, f"prompt {i}: " + "la " * (5 + 9 * i))
    sched._admit()
    while any(s is not None and s.next_chunk >= 0 for s in sched._slots):
        sched._prefill_tick()
    plan = sched.plan
    R, total = plan.prompt_region, plan.max_total
    slots = sched._slots
    arr = lambda xs, dt: torch.as_tensor(xs, dtype=dt, device=dev)  # noqa: E731
    table = arr(sched._table, torch.int32)
    tokens = arr([s.carry for s in slots], torch.long)
    plens = arr([s.plen for s in slots], torch.long)
    steps = arr([s.steps for s in slots], torch.long)
    kv_pos = torch.arange(total, device=dev)[None, None, None, :]
    mask = (kv_pos < plens[:, None, None, None]) | (
        (kv_pos >= R) & (kv_pos - R <= steps[:, None, None, None]))
    pos = (plens + steps)[:, None]

    def step(dense):
        views = []
        for c in sched.caches:
            if dense:
                views.append(KVCache(
                    _gather(c.keys, None, table, total, torch.bfloat16),
                    _gather(c.values, None, table, total, torch.bfloat16),
                    R + steps))
            else:
                views.append(PagedAttnView(c.keys, c.values, None, None, table,
                                           R + steps, plan.page_size, total))
        with torch.no_grad():
            logits, _ = clf.model(tokens[:, None], pos, mask, views)
        return logits[:, 0]

    before = kernels.launches()["paged_attention"]
    paged = step(dense=False)
    torch.cuda.synchronize()
    assert kernels.launches()["paged_attention"] == before + cfg.n_layers
    dense = step(dense=True)
    scale = float(dense.abs().max())
    assert torch.isfinite(paged).all()
    assert float((paged - dense).abs().max()) <= 5e-2 * scale


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantize_array_on_the_card_equals_the_cpu(dev, scheme):
    """Codes and scales drawn on the card are the CPU's (and so JAX's):
    the scale divisions are true divisions on both."""
    from music_analyst_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(1024, 4, 96, generator=gen) / 32).to(torch.bfloat16)
    want = quant.quantize_array(w, scheme)
    got = quant.quantize_array(w.to(dev), scheme)
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)
    x = torch.randn(64, 1024, generator=gen).to(torch.bfloat16)
    q_cpu, s_cpu = quant._quantize_rows(x.float())
    q_card, s_card = quant._quantize_rows(x.to(dev).float())
    assert torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu)


# ------------------------------------------------------------ serve path

_SERVE_PROMPTS = ["golden sunshine on the river", "rain", "la la la la",
                  "shadows fall across the empty street tonight",
                  "my heart beats a broken drum", "ok"]


def _serve_llama(dev):
    from music_analyst_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaZeroShotClassifier,
    )

    return LlamaZeroShotClassifier(
        config=LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1,
                                hidden_dim=512),
        max_prompt_len=64, device=dev)


def _serve_run(sched, prompts=_SERVE_PROMPTS, threaded=False):
    reqs = [sched.submit(i, p) for i, p in enumerate(prompts)]
    if threaded:
        sched.start()
        sched.drain(timeout=120)
    else:
        sched.run_until_idle()
    assert all(r.response["ok"] for r in reqs), [r.response for r in reqs]
    return [r.response["text"] for r in reqs]


def test_speculative_text_equals_plain_on_card(dev):
    """bf16 on the card: speculative (k = 4) and preempt-free plain decode
    go through the same paged kernel at the same shapes, so their greedy
    text is byte-identical; the verify blocks launch the kernel."""
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )

    clf = _serve_llama(dev)
    kw = dict(n_slots=4, prefill_chunk=16, prompt_region=64,
              max_new_tokens=16)
    plain = _serve_run(ContinuousScheduler(clf, **kw))
    sched = ContinuousScheduler(clf, speculate_k=4, **kw)
    before = kernels.launches()["paged_attention"]
    assert _serve_run(sched) == plain
    assert kernels.launches()["paged_attention"] > before
    assert sched.stats()["speculation"]["dispatches"] > 0


def test_paged_verify_block_reproduces_decode_on_card(dev):
    """A verify block fed the tokens plain decode emitted predicts exactly
    the tokens plain decode emitted next (the same 1-wide kernel step)."""
    import numpy as np

    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )

    clf = _serve_llama(dev)
    sched = ContinuousScheduler(clf, n_slots=4, prefill_chunk=16,
                                prompt_region=64, max_new_tokens=8,
                                decode_span=4)
    for i, p in enumerate(_SERVE_PROMPTS[:4]):
        sched.submit(i, p)
    sched._admit()
    while any(s is not None and s.next_chunk >= 0 for s in sched._slots):
        sched._prefill_tick()
    slots = sched._slots
    n = sched.plan.n_slots
    carry = np.array([s.carry for s in slots], np.int32)
    plens = np.array([s.plen for s in slots], np.int32)
    zeros = np.zeros(n, np.int32)
    args = sched._upload(sched._table, carry, plens, zeros,
                         np.full(n, 8, np.int32), np.zeros(n, bool),
                         np.ones(n, bool))
    _, _, _, _, emitted = sched.runtime.decode_step(sched.caches, *args)
    emitted = emitted.cpu().numpy().T                      # [n, span]
    blk = emitted[:, :4].astype(np.int32)
    table, blk_d, plens_d, steps_d = sched._upload(sched._table, blk, plens,
                                                   zeros)
    _, preds = sched.runtime.verify_block(sched.caches, table, blk_d,
                                          plens_d, steps_d)
    preds = preds.cpu().numpy()
    eos = sched.runtime.eos_id
    for i in range(n):
        for j in range(3):
            if emitted[i, j] == eos:    # decode latches EOS; verify does not
                break
            assert preds[i, j] == emitted[i, j + 1], (i, j)


def test_threaded_scheduler_and_slot_cache_on_card(dev):
    """The threaded loop (its own inference_mode and current device) gives
    the synchronous loop's text; the monolithic slot cache runs on the
    card through dense attention, without the paged kernel."""
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )

    clf = _serve_llama(dev)
    kw = dict(n_slots=4, prefill_chunk=16, prompt_region=64,
              max_new_tokens=8)
    sync = _serve_run(ContinuousScheduler(clf, **kw))
    assert _serve_run(ContinuousScheduler(clf, **kw), threaded=True) == sync
    before = kernels.launches()["paged_attention"]
    slots = _serve_run(ContinuousScheduler(clf, page_size=0, **kw),
                       threaded=True)
    assert len(slots) == len(_SERVE_PROMPTS)
    assert kernels.launches()["paged_attention"] == before


# --------------------------------------------------------------------------
# Training, the Llama flash no-cache path and MoE on the card.  Tolerances:
# flash at D = 128 as the bf16 bound above; the train step in f32 on the
# card against the CPU within 1e-4 relative on each loss (f32 sums in
# another order); per-expert int8 products exact against the CPU (the same
# codes, int32 sums, the same f32 epilogue).
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lengths", "segments"])
def test_flash_d128_causal_gqa(dev, mode):
    """Llama's no-cache shapes in miniature: causal, 32/8 heads' ratio,
    with lengths or with packed documents."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 300, 300, 8, 2, 128, seed=7)
    kw = dict(causal=True)
    if mode == "lengths":
        kw["lengths"] = torch.tensor([300, 151], device=dev)
    else:
        seg = torch.ones(2, 300, dtype=torch.int32, device=dev)
        seg[0, 70:], seg[1, 129:] = 2, 2
        seg[1, 250:] = 0
        kw["q_segment_ids"] = seg
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    assert _within_bf16_bound(got, want)


def test_flash_refuses_autograd_on_the_card(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 1, 64, 64, 4, 2, 128)
    before = kernels.launches()["flash_attention"]
    out = flash_attention(q.requires_grad_(), k, v, causal=True)
    assert kernels.launches()["flash_attention"] == before + 1
    with pytest.raises(NotImplementedError, match="no backward"):
        out.float().sum().backward()
    assert q.grad is None
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v, causal=True), out)


def _tiny_llama(dev, **over):
    from music_analyst_tpu_torch.models.llama import LlamaConfig, LlamaModel

    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, hidden_dim=384,
                           **over)
    return LlamaModel(cfg).to(dev)


def test_train_steps_on_the_card_match_the_cpu(dev):
    from music_analyst_tpu_torch.engines import train

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, (4, 65)).astype(np.int32)
    lengths = np.array([65, 40, 65, 9], np.int32)
    # Weights drawn once on the CPU (a card's generator draws others).
    weights = _tiny_llama("cpu", dtype="float32")
    train.init_train_state(weights, train.make_optimizer(), seed=0)
    losses = {}
    for where in ("cpu", dev):
        model = _tiny_llama(where, dtype="float32")
        model.load_state_dict(weights.state_dict())
        opt = train.make_optimizer(1e-3)
        state = train.init_train_state(model, opt, seed=None)
        step = train.make_train_step(model, opt)
        got = []
        for batch in train.prefetch_batches([(ids, lengths)] * 2,
                                            device=where):
            state, loss = step(state, *batch)
            got.append(float(loss))
        losses[str(where)] = got
        assert int(state.step) == 2
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)


def test_bf16_train_step_and_flash_eval_on_the_card(dev):
    from music_analyst_tpu_torch.engines import train
    from music_analyst_tpu_torch.models.llama import LlamaModel

    model = _tiny_llama(dev)
    opt = train.make_optimizer(1e-3)
    state = train.init_train_state(model, opt, seed=1)
    step = train.make_train_step(model, opt)
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(1, 512, (4, 129)), device=dev)
    lengths = torch.tensor([129, 100, 129, 30], device=dev)
    first = None
    for _ in range(4):
        state, loss = step(state, ids, lengths)
        first = float(loss) if first is None else first
    assert float(loss) < first
    assert all(p.dtype == torch.float32 for p in state.params.values())
    train.load_params_(model, state.params)
    flash = LlamaModel(dataclasses.replace(model.config,
                                           attn_impl="flash")).to(dev)
    flash.load_state_dict(model.state_dict())
    before = kernels.launches()["flash_attention"]
    with torch.no_grad():
        a = float(train.causal_lm_loss(flash, ids, lengths))
        b = float(train.causal_lm_loss(model, ids, lengths))
    assert kernels.launches()["flash_attention"] == before + 2  # 2 layers
    assert abs(a - b) <= 1e-2 * abs(b)


def test_quant_batched_matmul_on_the_card_equals_the_cpu(dev):
    from music_analyst_tpu_torch.ops.quant import (
        quant_batched_matmul,
        quant_batched_matmul_plain,
    )

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 40, 256, generator=gen)
    w = torch.randn(4, 256, 96, generator=gen)
    got = quant_batched_matmul(x.to(dev, torch.bfloat16),
                               w.to(dev, torch.bfloat16))
    want = quant_batched_matmul_plain(x.bfloat16(), w.bfloat16())
    assert torch.equal(got.cpu(), want)


def test_moe_sparse_equals_dense_on_the_card(dev):
    from music_analyst_tpu_torch.models.moe import MoESwiGLU

    moe = MoESwiGLU(256, 4, 384, dtype=torch.float32, dispatch="sparse",
                    capacity_factor=4.0)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(4)
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    moe = moe.to(dev)
    x = torch.randn(2, 33, 256, generator=gen).to(dev)
    with torch.no_grad():
        sparse = moe(x)
        moe.dispatch = "dense"
        dense = moe(x)
    torch.testing.assert_close(sparse, dense, rtol=1e-4, atol=1e-4)


# The train step on a mesh of two gloo ranks sharing the card (dp 2 with
# ZeRO-1, then tp 2) against the one-device step on the CPU: bf16 weights
# and activations on both sides, so each loss within 2^-7 relative (bf16
# products summed in another order, on another device).
_MESH_TRAIN_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from music_analyst_tpu_torch.engines import train as T
from music_analyst_tpu_torch.models.llama import LlamaConfig, LlamaModel
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
mh.initialize(f"localhost:{port}", n, rank, backend="gloo", timeout_s=120)
data = np.load(f"{work}/batch.npz")
weights = torch.load(f"{work}/weights.pt")
cfg = LlamaConfig(**json.loads(open(f"{work}/cfg.json").read()))
out = {}
for tag, axes, zero1 in (("dp2_zero1", (("dp", 2),), True),
                         ("tp2", (("tp", 2),), False)):
    mesh = M.build_mesh(M.MeshSpec(axes))
    torch.cuda.set_device(mesh.device)
    model = LlamaModel(cfg)
    model.load_state_dict(weights)
    model = model.to(mesh.device)
    opt = T.make_optimizer(1e-3)
    state = T.init_train_state(model, opt, seed=None, mesh=mesh, zero1=zero1)
    step = T.make_train_step(model, opt, mesh=mesh)
    losses = []
    for batch in T.prefetch_batches([(data["ids"], data["lengths"])] * 2,
                                    mesh=mesh):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    out[tag] = losses
print(json.dumps(out))
mh.shutdown()
"""


def test_mesh_train_steps_on_the_card_match_the_cpu(dev, tmp_path):
    import json

    from music_analyst_tpu_torch.engines import train
    from music_analyst_tpu_torch.models.llama import LlamaConfig, LlamaModel
    # By its own name: pytest puts tests/ on the path, and a machine may
    # have another top-level package called "tests".
    from torch_ranks import launch_ranks

    cfg = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
               hidden_dim=384, rope_theta=1e4, max_seq_len=128)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 512, (4, 65)).astype(np.int32)
    lengths = np.array([65, 64, 20, 9], np.int32)   # dp halves: 127 vs 27
    model = LlamaModel(LlamaConfig(**cfg))
    opt = train.make_optimizer(1e-3)
    state = train.init_train_state(model, opt, seed=3)
    np.savez(tmp_path / "batch.npz", ids=ids, lengths=lengths)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    step = train.make_train_step(model, opt)
    want = []
    for _ in range(2):
        state, loss = step(state, torch.tensor(ids), torch.tensor(lengths))
        want.append(float(loss))
    outs = launch_ranks(_MESH_TRAIN_CHILD, 2, [tmp_path], tmp_path / "ranks")
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert got[0] == got[1]
    for tag in ("dp2_zero1", "tp2"):
        np.testing.assert_allclose(got[0][tag], want, rtol=2.0 ** -7)
