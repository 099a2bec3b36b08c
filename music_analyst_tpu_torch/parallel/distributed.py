"""Multi-process distributed word count: the reference's ``mpirun -np N``.

The port's counterpart of ``music_analyst_tpu/parallel/distributed.py``
and of the reference's N-rank MPI run (``src/parallel_spotify.c:725-730``):
each *process* ingests a disjoint record range of the dataset, local
vocabularies merge through the coordinator (the reference's
``MPI_Send``/``Recv`` string shuffle → one
:func:`multihost.allgather_bytes` + :func:`multihost.broadcast_bytes`
round, ``:396-432,1011-1025``), each process counts its remapped ids on
its own device (``ops/histogram.py:token_histogram``), and the dense
int64 count vectors merge with one ``all_reduce(SUM)`` over the process
group — host tensors under gloo, device tensors under NCCL.

Each rank computes on ``cuda:(rank % device_count)`` unless the caller
passes ``device="cpu"``; several ranks may share one card (gloo).
Single-process calls degrade to one ingest and one count, so this module
is safe to call unconditionally.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from music_analyst_tpu_torch.data.csv_io import (
    iter_csv_records_exact,
    sort_count_entries,
    write_count_csv,
)
from music_analyst_tpu_torch.data.ingest import IngestResult, ingest_dataset
from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.ops.histogram import PAD_ID, token_histogram
from music_analyst_tpu_torch.parallel import multihost
from music_analyst_tpu_torch.profiling.collectives import record_collective
from music_analyst_tpu_torch.telemetry import get_telemetry


def _my_record_range(dataset_path: str) -> Tuple[bytes, int]:
    """This process's contiguous slice of the dataset's data records.

    Returns a reconstructed mini-dataset (header + owned records — records
    keep their terminator bytes, so concatenation is byte-faithful) plus
    the number of owned records.  Contiguous ranges, like the reference's
    per-rank byte slices, but record-exact.

    Partitioning runs the native parallel boundary scan
    (``data/native.py:record_range``); the fallback parses the whole file
    in Python.  The two may split blank/``\\r\\n`` filler records
    differently, so every process must use the same one: ``all_agree`` is
    a collective that every process calls, whatever its local
    availability, and a mixed run falls back to Python everywhere.
    """
    from music_analyst_tpu_torch.data import native

    n_procs = multihost.process_count()
    p = multihost.process_index()
    use_native = native.available()
    if n_procs > 1:
        agreed = multihost.all_agree(use_native)
        use_native = use_native and agreed
    if use_native:
        header_end, begin, end, n = native.record_range(
            dataset_path, n_procs, p
        )
        with open(dataset_path, "rb") as fh:
            header = fh.read(header_end)
            fh.seek(begin)
            body = fh.read(end - begin)
        return (header + body if header else b""), n
    with open(dataset_path, "rb") as fh:
        data = fh.read()
    records = list(iter_csv_records_exact(data))
    if not records:
        return b"", 0
    header, body = records[0], records[1:]
    share = -(-len(body) // n_procs) if body else 0
    mine = body[p * share : (p + 1) * share]
    return header + b"".join(mine), len(mine)


def _merge_vocabs(local_tokens: List[str]) -> List[str]:
    """Global vocabulary, identical on every process.

    All-gather each process's token list, merge on the coordinator in
    process order (first occurrence wins, preserving the deterministic
    insertion-order ids the exports rely on), broadcast the merged list.
    """
    gathered = multihost.allgather_bytes(
        json.dumps(local_tokens).encode("utf-8")
    )
    merged_payload = None
    if multihost.is_coordinator():
        seen = {}
        for payload in gathered:
            for tok in json.loads(payload.decode("utf-8")):
                if tok not in seen:
                    seen[tok] = len(seen)
        merged_payload = json.dumps(list(seen)).encode("utf-8")
    return json.loads(multihost.broadcast_bytes(merged_payload).decode("utf-8"))


def _sum_across_processes(counts: torch.Tensor) -> np.ndarray:
    """One ``all_reduce(SUM)`` of int64 ``counts`` over every process →
    the global sum on the host (identical on every process).

    The replacement for the reference's serialised rank→0 Send/Recv
    accumulation (``src/parallel_spotify.c:1002-1025``).  The counts cross
    to the host for gloo (whose collectives read host memory) and stay on
    the card for NCCL.
    """
    n = multihost.process_count()
    record_collective(
        "distributed.count_merge", "psum",
        payload_bytes=counts.numel() * counts.element_size(), n_devices=n,
    )
    if n == 1:
        return counts.cpu().numpy()
    with get_telemetry().span("distributed.all_reduce", elements=counts.numel()):
        staged = counts.to(multihost.transport_device())
        dist.all_reduce(staged, op=dist.ReduceOp.SUM)
        return staged.cpu().numpy()


def _rank_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device(
            "cuda", multihost.process_index() % torch.cuda.device_count())
    return dev


def _global_counts(local_ids: np.ndarray, local_tokens: List[str],
                   merged_tokens: List[str], dev: torch.device) -> torch.Tensor:
    """This process's counts over the merged vocabulary (int64 on ``dev``):
    local ids remapped to global ids and counted on the device."""
    index = {tok: i for i, tok in enumerate(merged_tokens)}
    # remap[0] serves the local PAD_ID (-1): local id i reads remap[i + 1].
    remap = np.asarray([PAD_ID] + [index[tok] for tok in local_tokens],
                       dtype=np.int32)
    ids = torch.from_numpy(np.ascontiguousarray(local_ids, dtype=np.int32))
    global_ids = torch.from_numpy(remap).to(dev).index_select(
        0, ids.to(dev) + 1)
    hist = token_histogram(global_ids, max(1, len(merged_tokens)))
    return hist.to(torch.int64)


def distributed_wordcount(
    dataset_path: str,
    output_dir: str = "output",
    *,
    device: DeviceLike = "cuda",
) -> dict:
    """Word/artist counts with per-process ingest and a collective merge.

    Every process returns the totals; only the coordinator writes
    ``word_counts.csv``/``top_artists.csv`` (byte-identical to a
    single-process run over the same dataset) plus
    ``performance_metrics.json``, whose min/avg/max spread comes from each
    process's own measured compute time — the collective analogue of the
    reference's six ``MPI_Reduce`` timing calls
    (``src/parallel_spotify.c:1077-1082``).
    """
    t_start = time.perf_counter()
    dev = _rank_device(device)
    tel = get_telemetry()
    with tel.span("distributed.ingest"):
        my_slice, _ = _my_record_range(dataset_path)
        # The native scanner is file-based: the slice goes through a
        # scratch file, then the usual ingest (native, or Python).
        with tempfile.NamedTemporaryFile(suffix=".csv") as tmp:
            tmp.write(my_slice)
            tmp.flush()
            corpus: IngestResult = ingest_dataset(tmp.name)

    with tel.span("distributed.vocab_merge"):
        word_tokens = _merge_vocabs(corpus.word_vocab.tokens)
        artist_tokens = _merge_vocabs(corpus.artist_vocab.tokens)

    with tel.span("distributed.count"):
        word_local = _global_counts(corpus.word_ids, corpus.word_vocab.tokens,
                                    word_tokens, dev)
        artist_local = _global_counts(corpus.artist_ids,
                                      corpus.artist_vocab.tokens,
                                      artist_tokens, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    word_counts = _sum_across_processes(word_local)
    artist_counts = _sum_across_processes(artist_local)
    totals = _sum_across_processes(torch.tensor(
        [corpus.song_count, corpus.token_count], dtype=torch.int64))

    # Per-process compute time: partition + ingest + vocab merge + counts
    # + merges, by each process's own clock, then all-gathered so the
    # coordinator sees the real spread.
    my_compute = time.perf_counter() - t_start
    per_process = [
        float(json.loads(payload.decode("utf-8")))
        for payload in multihost.allgather_bytes(
            json.dumps(my_compute).encode("utf-8")
        )
    ]
    # Timestamp AFTER the all-gather: the coordinator's wait for slower
    # processes is skew, not export work, and must not inflate total_time.
    t_gathered = time.perf_counter()

    result = {
        "processes": multihost.process_count(),
        "total_songs": int(totals[0]),
        "total_words": int(totals[1]),
    }
    if multihost.is_coordinator():
        from music_analyst_tpu_torch.metrics.perf import (
            TimeStats,
            write_performance_metrics,
        )

        os.makedirs(output_dir, exist_ok=True)
        word_entries = sort_count_entries(
            (tok, int(n)) for tok, n in zip(word_tokens, word_counts) if n
        )
        artist_entries = sort_count_entries(
            (tok, int(n)) for tok, n in zip(artist_tokens, artist_counts) if n
        )
        write_count_csv(
            os.path.join(output_dir, "word_counts.csv"), "word", word_entries
        )
        write_count_csv(
            os.path.join(output_dir, "top_artists.csv"), "artist",
            artist_entries,
        )
        export_seconds = time.perf_counter() - t_gathered
        write_performance_metrics(
            os.path.join(output_dir, "performance_metrics.json"),
            processes=multihost.process_count(),
            total_songs=result["total_songs"],
            total_words=result["total_words"],
            compute_time=TimeStats.from_samples(per_process),
            # total = own compute + the coordinator's aggregation/export
            # tail every process waits out at the final barrier.
            total_time=TimeStats.from_samples(
                [c + export_seconds for c in per_process]
            ),
            per_chip=[
                {"process": i, "compute_seconds": round(seconds, 9)}
                for i, seconds in enumerate(per_process)
            ],
            device_platform="multi-controller",
        )
    multihost.barrier("distributed_wordcount_export")
    return result
