"""Port histograms ≡ the JAX package's on seeded id streams.

Each layout of ``ops/histogram.py`` — ``token_histogram``, the device-ids
put (``sharded_histogram``), host-shard counting with the merge on the
device, and the chunked stream — runs on ``device="cpu"`` against the JAX
function on its 8-device CPU mesh and against ``np.bincount``.  Streams
hold ``PAD_ID``s, ids past the vocabulary, an empty stream, vocab 1 and a
Zipf-skewed stream.  Tolerance: none (integer counts).
"""

import numpy as np
import pytest
import torch

from music_analyst_tpu.ops import histogram as jh
from music_analyst_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
from music_analyst_tpu_torch.ops import histogram as th
from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh

torch.set_num_threads(1)


def _zipf(n, ranks, seed, pad_share=0.01):
    """``n`` ids from a finite Zipf law (s = 1) over ``ranks`` shuffled
    word ranks, with ``pad_share`` of them ``PAD_ID``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, ranks + 1)
    ids = rng.permutation(ranks)[rng.choice(ranks, size=n, p=p / p.sum())]
    ids[rng.random(n) < pad_share] = th.PAD_ID
    return ids.astype(np.int32)


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "pad":
        ids = rng.integers(-1, 300, size=5_003).astype(np.int32)
        return ids, 300
    if name == "empty":
        return np.zeros((0,), np.int32), 7
    if name == "vocab1":
        return rng.integers(-1, 1, size=101).astype(np.int32), 1
    if name == "zipf":
        return _zipf(40_000, 4096, seed=1), 4096
    if name == "past_vocab":
        return rng.integers(-3, 80, size=999).astype(np.int32), 64
    raise KeyError(name)


CASES = ["pad", "empty", "vocab1", "zipf", "past_vocab"]


def _oracle(ids, vocab):
    valid = ids[(ids >= 0) & (ids < vocab)]
    return np.bincount(valid, minlength=vocab).astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    return data_parallel_mesh(device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_token_histogram_matches_jax(case):
    ids, vocab = _case(case)
    got = th.token_histogram(torch.from_numpy(ids), vocab)
    assert got.dtype == torch.int32 and got.shape == (vocab,)
    want = np.asarray(jh.token_histogram(ids, vocab))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _oracle(ids, vocab))


@pytest.mark.parametrize("case", CASES)
def test_device_ids_layout_matches_jax(mesh, case):
    ids, vocab = _case(case)
    got = th.sharded_histogram(ids, vocab, mesh).numpy()
    want = np.asarray(jh.sharded_histogram(ids, vocab, jax_mesh()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(ids, vocab))


@pytest.mark.parametrize("case", CASES)
def test_host_shard_layout_matches_jax(mesh, case):
    ids, vocab = _case(case)
    got, timings = th.sharded_histogram_hostlocal_timed(ids, vocab, mesh)
    want, _ = jh.sharded_histogram_hostlocal_timed(ids, vocab, jax_mesh())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert len(timings.count_seconds) == mesh.size == 1
    assert timings.merge_seconds > 0
    assert timings.per_chip_seconds() == [
        timings.count_seconds[0] + timings.merge_seconds]


def _offsets(n_tokens, n_songs, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, n_tokens + 1, size=n_songs - 1))
    return np.concatenate([[0], cuts, [n_tokens]]).astype(np.int64)


@pytest.mark.parametrize("chunk", [1, 7, "auto"])
@pytest.mark.parametrize("depth", [0, 2])
def test_streaming_layout_matches_jax(mesh, chunk, depth):
    if chunk == "auto":
        # Large enough for auto to stream: ~4.2 M ids in 3 chunks.
        ids = _zipf((1 << 22) + 12_345, 1 << 14, seed=2)
        offsets = _offsets(ids.shape[0], 5_000, seed=3)
    else:
        ids = _zipf(3_000, 500, seed=4)
        offsets = _offsets(ids.shape[0], 40, seed=5)
    songs = offsets.shape[0] - 1
    vocab = int(ids.max()) + 1
    resolved = th.resolve_chunk_songs(chunk, songs, ids.shape[0])
    assert resolved == jh.resolve_chunk_songs(chunk, songs, ids.shape[0]) > 0
    got = th.sharded_histogram_streaming(ids, offsets, vocab, mesh,
                                         chunk_songs=resolved,
                                         prefetch_depth=depth)
    want = jh.sharded_histogram_streaming(ids, offsets, vocab, jax_mesh(),
                                          chunk_songs=resolved,
                                          prefetch_depth=depth)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(ids, vocab))
    if chunk == "auto":
        assert len(th.chunk_token_bounds(offsets, resolved)) - 1 == 3


def test_streaming_edges(mesh):
    empty = th.sharded_histogram_streaming(
        np.zeros((0,), np.int32), np.zeros((4,), np.int64), 5, mesh,
        chunk_songs=2)
    np.testing.assert_array_equal(empty, np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="chunk_songs > 0"):
        th.sharded_histogram_streaming(np.ones(3, np.int32),
                                       np.array([0, 3]), 2, mesh)


def test_resolve_chunk_songs_matches_jax():
    grid = [0, 1, 7, 64, "auto", None, 10 ** 9]
    for chunk in grid:
        for songs in (0, 1, 2, 1_000, 57_650, 1_000_000):
            for tokens in (0, 1_000, (1 << 22) - 1, 1 << 22, 10_000_000,
                           180_000_000):
                assert th.resolve_chunk_songs(chunk, songs, tokens) == (
                    jh.resolve_chunk_songs(chunk, songs, tokens)), (
                        chunk, songs, tokens)
    with pytest.raises(ValueError):
        th.resolve_chunk_songs(-1, 10, 10)


def test_sharded_total_and_mesh(mesh):
    values = np.arange(17, dtype=np.int64)
    assert th.sharded_total(values, mesh) == jh.sharded_total(
        values, jax_mesh()) == 136
    assert mesh.shape == {"dp": 1} and mesh.devices == (torch.device("cpu"),)
    assert data_parallel_mesh(1, device="cpu") == mesh
    # Two devices are two ranks: without a process group it refuses.
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        data_parallel_mesh(2, device="cpu")


def test_token_histogram_rejects_int64_ids():
    with pytest.raises(ValueError, match="int32"):
        th.token_histogram(torch.zeros(3, dtype=torch.int64), 4)


def test_device_ids_slices_match_one_pass(mesh, monkeypatch):
    ids, vocab = _case("zipf")
    whole = th.sharded_histogram(ids, vocab, mesh).numpy()
    monkeypatch.setattr(th, "_SLICE", 977)
    np.testing.assert_array_equal(
        th.sharded_histogram(ids, vocab, mesh).numpy(), whole)
