"""Dense token-id histograms on the card.

The counterpart of ``music_analyst_tpu/ops/histogram.py``.  With ids dense
on the host (``data/vocab.py``), one device's histogram is one scatter-add
of ones into an int32 vector, and the cross-device merge is a sum of dense
vectors — the replacement for the reference's per-rank string hash tables
and their Send/Recv merge (``src/parallel_spotify.c:38-175,396-432,
1011-1025``).

The JAX package has no Pallas kernel here (its docstring: the scatter-add
is XLA's), so the port computes it with torch operations on the card:

* No hidden host synchronisation on the device paths.  ``torch.bincount``
  on CUDA reads the input's maximum back to the host, and boolean-mask
  selection (``ids[ids >= 0]``) synchronises through ``nonzero``.  Instead
  every id that is not a vocabulary index (``PAD_ID`` = -1, any negative,
  or >= ``vocab_size``, which the JAX scatter drops) is sent by
  ``torch.where`` to one spare trash bin at index ``vocab_size``; ones are
  ``index_add_``-ed into ``vocab_size + 1`` int32 bins, and the trash bin
  is sliced off.  The one synchronisation is the copy of the counts back
  to the host.
* No int64 copy of the id stream: ``index_add_`` takes the int32 ids as
  its index, the ones are a stride-0 view, and the trash-bin index is
  computed in slices of ``_SLICE`` ids, so a device-resident stream of N
  ids costs 4N bytes plus one slice.
* No shape buckets: JAX rounds id lengths and vocab sizes up to powers of
  two or multiples of 2^22 only so that XLA reuses one compiled program.
  PyTorch runs eagerly, and padding is bytes over the host→device link,
  so the port moves each stream and each chunk at its own length.
* On a mesh of ranks (``parallel/mesh.py``) each rank counts its own
  ``dp`` shard on its own device and the dense histograms merge with one
  ``all_reduce(SUM)`` over ``dp`` (JAX's ``psum``; staged through host
  memory under gloo).  Shards follow JAX: the id stream padded with
  ``PAD_ID`` to a multiple of dp and cut into equal blocks (``shard_pad``)
  for the device-ids and streaming paths — the streaming path cuts every
  chunk so — and ``np.array_split`` for the host-shard path.  With one
  device the sum is the identity; the host-shard path still merges its
  row on the card, so its measured ``merge_seconds`` keeps its meaning.
  Each merge point keeps JAX's ``collective.psum`` fault seam and records
  the merge's bytes (``profiling/collectives.py``) at JAX's four call
  sites.  Payloads are the port's unpadded ``vocab_size`` int32 bins, not
  JAX's buckets.

Counts are exact int32 (integer atomics do not depend on their order).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.parallel.mesh import (
    DeviceMesh,
    all_gather,
    all_reduce,
    shard_bounds,
)
from music_analyst_tpu_torch.profiling.collectives import record_collective
from music_analyst_tpu_torch.resilience.faults import fault_point

PAD_ID = -1

# Ids whose trash-bin index is computed at once: bounds the temporaries of
# a device-resident stream (an int32 index and a bool mask, or the three
# masks while it is computed) at 5 B x 2^24.
_SLICE = 1 << 24


def _accumulate(hist: torch.Tensor, ids: torch.Tensor) -> None:
    """Add the counts of ``ids`` (int32, same device) into ``hist``, whose
    last bin is the trash bin; enqueues work and never synchronises."""
    trash = hist.shape[0] - 1
    n = ids.shape[0]
    if n == 0:
        return
    ones = torch.ones((1,), dtype=torch.int32, device=hist.device)
    for start in range(0, n, _SLICE):
        part = ids[start:start + _SLICE]
        # One expression, so no slice's index outlives its index_add_.
        hist.index_add_(
            0, torch.where((part >= 0) & (part < trash), part, trash),
            ones.expand(part.shape[0]),
        )


def _bins(vocab_size: int, device) -> torch.Tensor:
    return torch.zeros((vocab_size + 1,), dtype=torch.int32, device=device)


def token_histogram(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Count id occurrences; ``PAD_ID`` (any negative id) and ids past the
    vocabulary are ignored.  int32 ``[vocab_size]`` on ``ids``'s device."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(
            f"ids must be a 1-D int32 tensor, got {ids.dtype} {tuple(ids.shape)}"
        )
    hist = _bins(vocab_size, ids.device)
    _accumulate(hist, ids)
    return hist[:vocab_size]


def _host_tensor(values: np.ndarray) -> torch.Tensor:
    """A tensor over ``values`` without a copy, for reading only.

    Corpus-cache hits map their arrays read-only (``data/corpus_cache.py``);
    ``torch.from_numpy`` warns on those because torch cannot mark a tensor
    read-only.  Every caller here only reads the tensor (a copy to the
    card, or ``_accumulate`` on the CPU), so the warning is silenced.
    """
    arr = np.ascontiguousarray(values, dtype=np.int32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr)


def sharded_histogram(
    ids: np.ndarray,
    vocab_size: int,
    mesh: DeviceMesh,
    axis: str = "dp",
) -> torch.Tensor:
    """Global histogram of host ``ids`` sharded over the mesh's ranks.

    This rank's shard goes to its device whole (one host→device copy) and
    is scatter-added there; the per-rank histograms are summed over
    ``axis``.  Returns int32 ``[vocab_size]`` on this rank's device (the
    caller's host copy is the synchronisation point).
    """
    ids = np.asarray(ids)
    start, stop, _ = shard_bounds(ids.shape[0], mesh, axis)
    # Each device's vocab_size-wide int32 histogram joins the merge.
    record_collective(
        "histogram.device_ids", "psum",
        payload_bytes=vocab_size * 4, n_devices=mesh.shape[axis], axis=axis,
    )
    fault_point("collective.psum", op="histogram.device_ids")
    hist = token_histogram(_host_tensor(ids[start:stop]).to(mesh.device),
                           vocab_size)
    return all_reduce(hist, mesh, axis)


@dataclasses.dataclass(frozen=True)
class HistogramTimings:
    """Per-shard measured compute for the host-local histogram.

    ``count_seconds[i]`` is shard *i*'s own counting wall-clock — the
    analogue of each MPI rank timing its local count loop
    (``src/parallel_spotify.c:850-851,1000``).  ``merge_seconds`` is the
    merge every device takes part in together.
    """

    count_seconds: Tuple[float, ...]
    merge_seconds: float

    def per_chip_seconds(self) -> List[float]:
        return [s + self.merge_seconds for s in self.count_seconds]


def sharded_histogram_hostlocal_timed(
    ids: np.ndarray,
    vocab_size: int,
    mesh: DeviceMesh,
    axis: str = "dp",
) -> Tuple[np.ndarray, HistogramTimings]:
    """Histogram with host-local counting and a merge on the card.

    Each shard's ids are counted on the host where they were ingested
    (``np.bincount``, timed per shard); only the dense per-shard rows,
    O(vocab) bytes, cross to the card, where they are summed and copied
    back.  Returns the counts plus the measured :class:`HistogramTimings`.
    """
    ids = np.asarray(ids)
    shards = mesh.shape[axis]
    chunk = np.array_split(ids, shards)[mesh.coords.get(axis, 0)]
    local = np.zeros((vocab_size,), dtype=np.int32)
    t0 = time.perf_counter()
    valid = chunk[(chunk >= 0) & (chunk < vocab_size)]
    if valid.size:
        local[:] = np.bincount(valid, minlength=vocab_size)
    # Every shard's own count time, gathered over the axis.
    count_seconds = all_gather(
        torch.tensor([time.perf_counter() - t0], dtype=torch.float64),
        mesh, axis).tolist()
    record_collective(
        "histogram.hostlocal_merge", "psum",
        payload_bytes=vocab_size * 4, n_devices=shards, axis=axis,
    )
    t0 = time.perf_counter()
    fault_point("collective.psum", op="histogram.hostlocal_merge")
    row = torch.from_numpy(local).to(mesh.device)
    merged = all_reduce(row, mesh, axis).cpu().numpy()   # the sync point
    merge_seconds = time.perf_counter() - t0
    return merged, HistogramTimings(tuple(count_seconds), merge_seconds)


# --- chunked streaming device path ----------------------------------------
#
# ``sharded_histogram`` puts the whole id stream on the card at once: peak
# memory is O(corpus).  The streaming path walks song-aligned chunks
# instead: the host stages chunk k in a pinned buffer, a side stream copies
# it to the card (non-blocking), and the accumulate of chunk k waits for
# that copy by an event — so the copy of chunk k+1 overlaps the
# scatter-add of chunk k.  A ring of (pinned, device) buffer pairs bounds
# memory at O(chunk x ring); a pinned buffer is rewritten only after its
# last copy's event completed, and its device buffer only after the
# accumulate that read it.

_AUTO_STREAM_MIN_TOKENS = 1 << 22   # below this, chunking is pure overhead
_AUTO_CHUNK_TARGET_TOKENS = 1 << 21  # ~8 MiB of int32 ids per chunk


def resolve_chunk_songs(
    chunk_songs, song_count: int, token_count: int
) -> int:
    """Resolve a ``--chunk-songs`` value to songs per chunk (0 = off).

    Explicit ``0`` disables streaming; an explicit positive value is
    clamped to the corpus.  ``None``/``"auto"`` streams only when the
    corpus is big enough for chunking to pay, sizing chunks so each
    carries ~``_AUTO_CHUNK_TARGET_TOKENS`` ids.  Same thresholds as JAX.
    """
    if chunk_songs is not None and chunk_songs != "auto":
        n = int(chunk_songs)
        if n < 0:
            raise ValueError(f"chunk-songs must be >= 0, got {n}")
        return 0 if n == 0 else min(n, max(1, song_count))
    if token_count < _AUTO_STREAM_MIN_TOKENS or song_count <= 1:
        return 0
    avg_tokens = max(1.0, token_count / song_count)
    return max(1, min(song_count, int(_AUTO_CHUNK_TARGET_TOKENS / avg_tokens)))


def chunk_token_bounds(offsets: np.ndarray, chunk_songs: int) -> List[int]:
    """Token offsets of the song-aligned chunk boundaries."""
    song_count = offsets.shape[0] - 1
    bounds = list(range(0, song_count, chunk_songs)) + [song_count]
    return [int(offsets[b]) for b in bounds]


def _record_stream_merge(vocab_size: int, mesh: DeviceMesh, axis: str) -> None:
    record_collective(
        "histogram.stream_merge", "psum",
        payload_bytes=vocab_size * 4, n_devices=mesh.shape[axis], axis=axis,
    )


def sharded_histogram_streaming(
    ids: np.ndarray,
    offsets: np.ndarray,
    vocab_size: int,
    mesh: DeviceMesh,
    axis: str = "dp",
    chunk_songs: int = 0,
    prefetch_depth=None,
) -> np.ndarray:
    """Global histogram via bounded chunks overlapped with the H2D copy.

    ``offsets`` (int64 ``[songs+1]``, from ``IngestResult``) keeps chunks
    song-aligned.  ``prefetch_depth`` (default 2, or
    ``$MUSICAAL_PREFETCH_DEPTH``) chunks may be in flight ahead of the
    accumulate: the ring holds ``depth + 1`` buffer pairs (0 = one chunk
    at a time).  Identical counts to :func:`sharded_histogram` at every
    chunk size.  On a mesh each rank streams its ``shard_pad`` block of
    every chunk and the histograms merge over ``axis`` once at the end.
    """
    from music_analyst_tpu_torch.runtime.prefetch import resolve_prefetch_depth
    from music_analyst_tpu_torch.telemetry import get_telemetry

    ids = np.asarray(ids)
    offsets = np.asarray(offsets, dtype=np.int64)
    song_count = offsets.shape[0] - 1
    if chunk_songs <= 0:
        raise ValueError("sharded_histogram_streaming needs chunk_songs > 0")
    if song_count <= 0 or ids.shape[0] == 0:
        return np.zeros((vocab_size,), dtype=np.int32)
    device = mesh.device
    bounds = chunk_token_bounds(offsets, chunk_songs)
    spans = []
    for start, end in zip(bounds, bounds[1:]):
        lo, hi, _ = shard_bounds(end - start, mesh, axis)
        spans.append((start + lo, start + hi))
    hist = _bins(vocab_size, device)
    tel = get_telemetry()
    tel.count("histogram.stream_chunks", len(spans))
    if device.type != "cuda":
        tel.count("histogram.stream_h2d_bytes", 0)
        for start, end in spans:
            _accumulate(hist, _host_tensor(ids[start:end]))
        _record_stream_merge(vocab_size, mesh, axis)
        fault_point("collective.psum", op="histogram.stream_merge")
        return all_reduce(hist[:vocab_size], mesh, axis).numpy().copy()
    # The bytes that cross: this rank's int32 ids of each chunk, unpadded.
    tel.count("histogram.stream_h2d_bytes",
              4 * sum(end - start for start, end in spans))

    ring = resolve_prefetch_depth(prefetch_depth) + 1
    width = max(1, max(end - start for start, end in spans))
    compute = torch.cuda.current_stream(device)
    copier = torch.cuda.Stream(device)
    pinned = [torch.empty((width,), dtype=torch.int32, pin_memory=True)
              for _ in range(min(ring, len(spans)))]
    staged = [torch.empty((width,), dtype=torch.int32, device=device)
              for _ in pinned]
    copied = [None] * len(pinned)    # event: the slot's last H2D copy done
    consumed = [None] * len(pinned)  # event: the slot's last accumulate done
    for k, (start, end) in enumerate(spans):
        slot, n = k % len(pinned), end - start
        if copied[slot] is not None:
            copied[slot].synchronize()   # the pinned buffer is free again
        pinned[slot].numpy()[:n] = ids[start:end]
        with torch.cuda.stream(copier):
            if consumed[slot] is not None:
                copier.wait_event(consumed[slot])
            staged[slot][:n].copy_(pinned[slot][:n], non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(copier)
        compute.wait_event(copied[slot])
        _accumulate(hist, staged[slot][:n])
        consumed[slot] = torch.cuda.Event()
        consumed[slot].record(compute)
    for buf in staged:
        buf.record_stream(copier)
    _record_stream_merge(vocab_size, mesh, axis)
    fault_point("collective.psum", op="histogram.stream_merge")
    # The host copy is the synchronisation point.
    return all_reduce(hist[:vocab_size], mesh, axis).cpu().numpy()


def sharded_total(values: np.ndarray, mesh: DeviceMesh, axis: str = "dp") -> int:
    """Sum of per-shard scalar contributions, taken on the card (the
    analogue of the reference's ``MPI_Reduce(SUM)``,
    ``src/parallel_spotify.c:1004-1005``)."""
    values = np.asarray(values, dtype=np.int64)
    record_collective(
        "histogram.scalar_total", "psum",
        payload_bytes=8, n_devices=mesh.shape[axis], axis=axis,
    )
    fault_point("collective.psum", op="histogram.scalar_total")
    start, stop, _ = shard_bounds(values.shape[0], mesh, axis)
    total = torch.from_numpy(values[start:stop]).to(mesh.device).sum()
    return int(all_reduce(total, mesh, axis))
