#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds every kernel from ``csrc/`` (one ``nvcc`` per source, started
   together) and the host C++ library; ptxas must report no spills in any
   kernel.
2. Holds each kernel against its plain PyTorch version on the card: flash
   attention at DistilBERT shapes (bf16, B=256, S=128, H=12, D=64, random
   lengths; packed segments), in causal + GQA + offset and residual modes
   at D=128, and with one query row over 1,040 keys at D=128; the keyword
   scan exactly (scores and hit masks) on a seeded 8192x4096 byte matrix,
   on that matrix one byte off alignment and cut to one row, and on edge
   cases: keyword halves across a row boundary, keywords at both ends of a
   row, every byte value around upper-case keywords, L = 5000 and L < 8.
3. Times each kernel, its plain version and (where one exists) the PyTorch
   library call for the same function, at the main path's shapes, beside
   the bound the card's bandwidth and peak rate put on the same work.  The
   paged-attention kernel is held at the Llama-3-8B decode shape (8 slots,
   page 16, region 1024, bf16 and int8 pools) against its f32 oracle and
   its exact-order plain version; a free slot must read zeros, NaN in the
   trash page must change nothing, two launches must agree bit for bit,
   and a shifted page or a dropped key must break the limits; a case with
   empty splits and a one-key slot is held too.  Paged and keyword-scan
   times are kernel device times from ``torch.profiler``, warm and with L2
   flushed by a 128 MB write before each launch, beside CUDA events around
   back-to-back calls (and, for paged, the wrapper's host time per call).
   A profile that saw no device event is taken again, twice at most; if
   none did, the calls are timed by CUDA events instead, and the case is
   logged and listed under ``timed_by_events`` in ``chip_smoke.json``.
   The served DistilBERT stream of step 8 and the ``--profile-dir`` trace
   of step 9 are taken again the same way (the stream through a fresh
   server, the command as a new process) while their profile holds no
   device event, and must then name ``flash_wgmma_kernel``.
   The scan is timed on a ``--mock`` batch of the corpus (its first 4,096
   songs, padded to the 4,096-byte bucket) and on the random matrix.  The
   flash kernel's output at the main shape (B=8192, corpus lengths) is
   held against its plain version too, and a variant that drops one key
   per row must break the limits.
4. Drives the main path: ``run_sentiment`` with full-size DistilBERT
   (``DistilBertConfig()``, flash attention, seeded random weights) over a
   generated 16,384-song CSV at batch 8192, flat and packed (three runs
   each, median reported), then the
   ``sentiment --mock`` CLI.  Launch counts are zeroed just before each run
   and read just after; every kernel of the path must have launched (the
   keyword scan once per 4,096-song ``--mock`` batch).  Outputs are
   checked: complete totals, flash-vs-dense logits on 1,024 songs (a model
   that ignores lengths must break that limit), packed-path
   logits against flat rows on the same songs, and the mock labels against
   the reference heuristic on every song.
   One flat batch is then profiled: host prepare time, device busy time by
   kernel group, and the card's idle share over the batch.
5. Drives the Llama slice at full width: ``LlamaConfig.llama3_8b()``
   (4 of its 32 layers, ``LLAMA_LAYERS``, since step 10's sweep over
   ranks; seeded random bf16 weights drawn on the card) through
   ``run_sentiment`` in generate mode on the continuous paged scheduler
   (16 songs, 8 slots, one run after a warm-up on 8 prompts; ``paged_attention``
   must launch exactly once per layer per decode step), in score mode (16
   songs) and with int8 pages (10 prompts).  Checks: every song labelled,
   totals complete, one decode step's logits through the kernel against
   dense attention over the gathered view (and a step that ignores the
   slot lengths must break that limit); reports how many prompts give the
   same greedy text as static ``generate_batch``, and a profile of one
   decode dispatch.
6. Drives the word-count slice (run between steps 4 and 5):
   ``python -m music_analyst_tpu_torch analyze --ingest native`` as a
   process on a generated 57,650-song CSV (the real dataset's row count,
   ~10 M tokens) in three layouts — auto (the word histogram streamed in
   chunks), ``--chunk-songs 0`` (host-shard) and ``--chunk-songs 0
   --count-mode device-ids`` — one process each (``ANALYZE_REPEATS``),
   songs/s, tokens/s and stage seconds reported.  Every run's ``word_counts.csv`` and
   ``top_artists.csv`` must equal a host ``np.bincount`` oracle over the
   same ingest and an ``--ingest python`` run byte for byte, and
   ``performance_metrics.json`` must say ``gpu`` and one process; one run
   is profiled in-process.  Then ``analyze --with-sentiment`` on the same
   CSV: ``--mock`` (the keyword scan once per 4,096-song batch, labels equal
   to the reference heuristic) and ``--model distilbert --batch-size 8192``
   (flash six times a batch, every song labelled); their CSVs must equal
   the plain run's.  Last, the histogram op at the 1 M-song north star's
   size: ~180 M int32 ids drawn on the card (finite Zipf, s = 1, over 2^18
   shuffled ranks, 1% ``PAD_ID``), device-ids and streaming (auto chunks)
   held exactly against ``np.bincount``, with wall time, profiler device
   time, the H2D share, peak device memory and the byte bound; a stream
   that drops its last chunk must break exactness.

7. Drives the quantized paths and ``wordcount-per-song``.  Products first
   (after step 3): ``quant_matmul`` (dynamic) and ``wq_matmul`` int8 / int4
   at the Llama-3-8B decode shapes (M = 8, the projections of q, gate, down
   and lm_head) and one prefill shape (gate, M = 512), device time warm and
   L2-flushed beside the bf16 cuBLAS product and the bound, each held
   against its plain version on the CPU from the same codes (an int4
   weight with its nibbles swapped, or one group's scale dropped, must
   break the limit).  After step 4, full DistilBERT ``-int8`` and
   ``weight_quant`` int8 / int4 through ``run_sentiment`` once each on
   4,096 songs (8,192 before step 10's sweep over ranks, 16,384 before
   step 13; flash must launch), logits on the first 8,192 against the
   bf16 model on the same weights, stored bytes and peak memory.  After step 6,
   ``wordcount-per-song`` as one process on a 4,096-song CSV (16,384
   songs until step 10's sweep over ranks, 57,650 until step 13) (global
   counts sum to the per-song counts, ranked by count, one row group per
   song with tokens).  After step 5 (whose bf16 generate phase runs once
   now), Llama-3-8B with weights drawn on the card and quantized kernel by
   kernel: each weight scheme is first built at all 32 layers for its
   stored bytes and init peak memory (the init must peak below the bf16
   weights' bytes), then run at ``LLAMA_LAYERS`` (4) layers:
   ``weight_quant`` int8 in generate mode (9 songs, two waves on 8
   continuous slots) and score mode (8), int4 in generate mode (9, two
   waves), dynamic int8 in score mode (8), paged attention once per layer
   per decode step; a decoder layer rebuilt in f32 on the card and on the
   CPU from the same codes must agree; run peak memory and a profiled
   decode dispatch per weight scheme.

8. Drives ``serve`` (the resident NDJSON server).  After step 4's
   ``--mock`` CLI, ``python -m music_analyst_tpu_torch serve --stdio
   --mock`` as a process: 2,048 classify requests from a generated
   corpus, word-count requests and a malformed line, then ``stats`` and
   ``shutdown``; labels equal the reference heuristic, word counts the
   tokenizer contract, the process exits 0 after its drain, and the
   scan's launches are the ones the process counted in that session.
   Inside step 4, the flat DistilBERT model serves 4,096 classify
   requests at max_batch 256 through ``SentimentServer.handle_stream``
   under ``torch.profiler`` (``flash_wgmma_kernel`` must launch), with the
   neutral threshold at the median confidence so the labels split: the
   logits served for each request id must hold the plain reference's
   (``forward_logits`` on its text), each reply's label must follow its
   own logits, and a label may differ from the batch engine's only at a
   near-tie.  At the end of step 5, on the same Llama-3-8B, 12
   ``generate`` requests (16 before step 10's sweep over ranks; a first
   wave filling the 8 slots, then 4; 16 new tokens) through the threaded
   continuous scheduler behind the server: paged (the baseline),
   speculative (k = 4; text byte-identical to the baseline), a
   priority-2 burst preempting priority-1 decodes under a 1 ms TTFT
   target (at least one preemption resumed from its checkpoint; text
   byte-identical), the monolithic slot cache and int8 pages (agreement
   reported); TTFT and TPOT quantiles, host ms per decode dispatch, and
   the device time of the served run's dispatch with the most active
   slots among those profiled in the run (the first, then each with more
   active slots, up to four), for each but the preempt run.  No serve
   thread may outlive its drain.

9. Drives the replica router and the run-manifest tools, after the
   quantized Llama phases.  (a) ``serve --replicas 2 --stdio --mock`` as a
   process over step 8's 2,048-request stream: every reply equal to the
   single replica's of this run, labels and word counts exact, the scan
   launched by the workers (each counts its own, read from the router's
   run manifest).  (b) ``serve --replicas 2 --socket --model distilbert``
   as a process (full width; each worker loads, through
   ``$MUSICAAL_DISTILBERT_CKPT``, a seeded checkpoint written here whose
   head splits the labels about 25/50/25) over 4,096 requests at
   max_batch 256: labels held against the same checkpoint loaded here
   (replies rotated by one request must fail that check), the workers'
   flash launches summed, ``monitor --once``
   attached to the router, then a second stream with one worker SIGKILLed
   halfway (every request answered; the manifest's ``serving.router``
   records the transition; the supervised respawn comes back before the
   drain).  (c) ``sentiment --model distilbert --profile-dir D
   --telemetry-dir T`` on one 8,192-song batch as a process: D's
   ``torch_trace.json`` names ``flash_wgmma_kernel`` and D holds
   ``trace_spans.json``; T's manifest names the card; then
   ``telemetry-report`` over the run dirs of an ``analyze`` run, (a), (b)
   and (c) (exit 0, with the router fleet section), ``trace-report`` over
   (b)'s request traces, and ``profile-diff`` (0 on a manifest against
   itself, 1 with its wall doubled).  Every worker a router spawned is
   gone when its phase ends.

10. Drives training, the flash loss, MoE and ``sweep``, after step 9.
   Kernel 2 against its plain version at Llama-3-8B's no-cache shapes (q
   [8, 512, 32, 128], kv [8, 512, 8, 128], bf16), causal with lengths and
   causal with two packed documents per row (attention across the
   documents must break the limit), timed beside SDPA (GQA, causal) and
   its bound.  The loss (``engines/train.py:causal_lm_loss``) on the full
   32-layer ``llama3_8b`` (random bf16 weights) through flash against
   dense on the same weights, B = 8, S = 513, unpacked and packed; flash
   launches once per layer per forward.  The trainer at ``llama3_8b``'s
   full width with 2 layers (4 before step 10's sweep over ranks; f32
   masters and AdamW moments): 5 steps (lr
   1e-4) on one seeded batch and 3 packed batches, each through
   ``prefetch_batches``; every loss finite, the fifth below the first,
   ``train_steps`` counting 8; the trained model's loss through flash
   against dense (2 launches); ``save_train_state`` then
   ``restore_train_state`` in a temporary directory must give back the
   masters, moments and step bit for bit; step wall time by CUDA events,
   tokens/s, peak memory, and one more step split into loading the
   masters, forward, backward and optimizer, each under
   ``torch.profiler``.  MoE at ``llama3_8b`` width (2 layers, 8 experts,
   top-2): sparse dispatch at lossless capacity against dense (last
   prompt logits and label scores over 8 prompts), the drops at capacity
   1.25, int8 experts against the float model.  ``sweep --devices 1,2,4``
   as a process on step 6's CSV with a corpus cache (point 1 cold, the
   later points warm), each point above 1 a mesh of ranks on the one card
   over gloo: no skip line, the summary listing [1, 2, 4], each mesh named
   on stderr, each point's metrics with ``processes == N``, N ``per_chip``
   rows on the card and the corpus's songs, the np 4 point's CSVs equal
   to the oracle; each point's wall and speedup beside the process's
   wall.  A 2-rank point whose rank 1 exits 1 after its last collective
   must exit non-zero and publish neither its metrics nor a summary.

11. Drives the fault seams, the watchdog and the native WordPiece path,
   after step 10; each drill is held against the same run without faults
   in this call.  (a) ``run_analysis`` on step 6's CSV with
   ``ingest.read:error@1;collective.psum:error@1`` (CSVs equal the
   oracle's, one trip and one recovery each); ``analyze`` as a process
   with a persistent ``collective.psum:error`` (non-zero exit, taxonomy
   ``fault_injected`` in its flight record, one failover retry, no
   ``degraded`` stamp, no CSV, metrics or temporary file written);
   full-width DistilBERT ``run_sentiment`` over the 16,384 songs with
   ``h2d.transfer:error@2;prefetch.stage:error@3`` (labels and totals
   equal, flash six times a batch); the ``sentiment --mock`` CLI with
   ``--watchdog-timeout 1 --inject-faults prefetch.stage:delay=3s@2``
   (files byte-identical, one ``stage_stall`` trip naming the stage and
   its ``flight_record.json``, the scan once a batch); a ``weight_quant``
   int8 load of step 9's checkpoint with
   ``checkpoint.load:error@2;h2d.transfer:error@3`` (every code and scale
   equal bit for bit).  (b) A WordPiece vocabulary (at most 30,522
   entries) built from the corpus, then full-width DistilBERT
   ``run_sentiment`` under ``$MUSICAAL_BERT_VOCAB`` over 4,096 of the songs
   (8,192 before step 10's sweep over ranks, 16,384 before step 13) with
   the native tokenizer and with the Python one: the ids of every batch
   equal (and of the edge rows, encoded apart), the native run's
   manifest counting every song on the native path, labels identical;
   each run's first 4,096-song batch times its tokenizer, and each run's
   songs/s is reported.

12. Drives the multi-process paths, after step 11, with every rank a
   process on the one card over gloo (NCCL refuses two ranks on one
   device), the kernels built before the first rank starts; a rank that
   fails or overstays kills its peers and fails the run.  (a)
   ``distributed_wordcount`` (``parallel/distributed.py``) on step 6's
   57,650-song CSV at np 2 and 4 (1 too before step 10's sweep over
   ranks): the coordinator's CSVs byte-identical
   to the single-process ``analyze`` output and the ``np.bincount``
   oracle, every rank's totals equal, one ``per_chip`` row per process;
   at np 2 a variant whose last rank starts one record late must break
   the bytes; wall, songs/s, compute min/avg/max, the all-reduce seconds
   and ``collectives.total_bytes`` per np.  (b) ``ring_attention``
   (``ops/ring_attention.py``) over 4 ranks at Llama-3-8B's attention
   width (H = 32, Hkv = 8, D = 128, bf16, B = 1, S = 32,768, 8,192 a
   rank, ``use_flash``), causal and causal + five packed documents (two
   crossing a rank boundary): kernel 2 four times a rank a call, each
   rank's output within the bf16 limits of the whole-sequence flash
   kernel run here and within check_flash's limits of the f32 plain
   version on 256 sampled query rows, the ranks' gathered outputs equal;
   a ring that takes owner = idx + step must fail.  Ms per call (the
   slowest rank), kernel device ms per hop, transfer ms per hop and the
   output gather timed alone, bytes per hop; kernel 2 at one full hop
   (residual mode) beside its bound, its plain version and SDPA.

13. Drives the meshes over ranks, after step 12, every rank a process on
   the one card over gloo.  Kernels 2 and 3 first, at the per-rank shapes
   of this step (flash at DistilBERT's dp 2, tp 2 and dp 2 x tp 2 rows
   and heads; paged with tp 2's 16 query and 4 KV heads), each against
   its plain version, beside its bound and the library call.  (a)
   ``analyze --devices 2`` and ``--devices 4`` (the CLI launching its
   ranks), plus ``--devices 2 --chunk-songs 4096``, on step 6's
   CSV: CSVs byte-identical to the oracle, one ``per_chip`` row per rank, the manifest naming the mesh
   and gloo; process wall, songs/s and ``collectives.total_bytes``.  (b)
   ``sentiment --model distilbert --devices 2`` at full width on the
   16,384 songs (batch 8192, step 9's split checkpoint through
   ``$MUSICAAL_DISTILBERT_CKPT``): labels equal to the one-device run's
   except within 1e-2 of the neutral threshold, flash launched on every
   rank (each rank names its own launches); then ``analyze
   --with-sentiment --devices 2`` on the same checkpoint (CSVs equal the
   oracle, labels equal (b)'s).  (c) Full-width DistilBERT through the
   API on four ranks, as dp 2 x tp 2 and then as a dp 1 x tp 2 mesh per
   tp line, on 2,048 songs (the checkpoint with N(0, 1) biases): logits
   within 5e-2 of the scale of the one-rank logits; the row-parallel bias
   added before the reduce, and two ranks' head shards swapped, must
   each fail.  (d) Llama-3-8B at tp 2 as two ranks, full
   width and step 5's ``LLAMA_LAYERS`` (4 of 32) layers, random bf16
   weights drawn whole from seed 0 on
   each rank and sliced: score-mode labels on 16 songs equal step 5's;
   generate mode on 8 prompts through the paged kernel (once per layer
   per decode step on each rank), the share of texts byte-identical to
   tp 1's reported; one decode step's logits within 5e-2 of the scale of
   step 5's at the same pool state, and ranks whose pools hold each
   other's KV heads must fail; per rank: weight bytes, peak memory, init
   seconds, prefill and decode rates, ms per decode step and the share of
   a decode dispatch spent in the tp collectives.

Prints the card's name and power limit, a ``{"quant_gemm": [...]}`` line,
a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no
result, when no card is present or when run outside a checkout.  A fuller
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

# Tolerances, with their reasons.
#  - flash, bf16 output vs the f32 plain version on the same bf16 inputs:
#    outputs are averages of N(0,1) values (|o| < 8), whose bf16 rounding
#    is at most half an ulp = 2^-9 * 8 = 1.6e-2; f32 sums in another order
#    add ~1e-6.  Stated tolerance 2e-2.
FLASH_BF16_TOL = 2e-2
#    Beside it, elementwise: the kernel rounds its f32 result to bf16 once,
#    so each element lies within half a bf16 ulp of the f32 plain version,
#    |got - ref| <= 2^-8 |ref|, plus 1e-5 for f32 sums in another order.
FLASH_BF16_REL = 2.0 ** -8
FLASH_F32_SLACK = 1e-5
#  - flash residual mode (f32 outputs): normalised o, m and relative l,
#    f32 sums in another order over <= 328 keys.  1e-3.
FLASH_F32_TOL = 1e-3
#  - keyword scan: integer function, exact.
#  - whole-model logits, flash vs dense path in bf16: the two paths round
#    attention differently (flash keeps p in f32, dense casts probs to
#    bf16), then six post-LN layers in bf16; 5e-2 of the logit scale.  The
#    same limit holds packed rows against flat rows (both flash).
LOGIT_REL_TOL = 5e-2
# Each limit is also shown to catch a broken variant in every run: the
# kernel with one key dropped per row, and the model with its lengths
# ignored (attention over padding).  The run fails if a variant passes.

N_SONGS = 16_384
BATCH = 8192
REPEATS = 3      # main-path runs per mode; the median is reported
MOCK_BATCH = 4096  # the --mock CLI's batch (run_sentiment's default)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def python_ms() -> float:
    """Wall of a fixed pure-Python loop: the host's speed, torch aside
    (the host's speed differs between calls and within one)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i * i
    return (time.perf_counter() - t0) * 1e3


def host_us(torch, fn, iters: int) -> float:
    """Host time of one call of ``fn`` in microseconds: the mean over
    ``iters`` back-to-back calls, read before the card is waited for (the
    calls only enqueue work, and ``iters`` launches fit the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


L2_FLUSH_BYTES = 128 << 20   # a write of this many bytes evicts the 50 MB L2
# torch.profiler on the H100 now and then returns a profile with no device
# event at all (seen in the paged and quantized probes, at random): such a
# profile is taken again, up to this many times in all.
PROFILE_TRIES = 3
# Every device_ms that the profiler could not time, timed by CUDA events
# instead: (what, ms).  Written into chip_smoke.json as "timed_by_events".
TIMED_BY_EVENTS = []


def device_ms(torch, fn, iters: int, flush: bool = False,
              what: str = "") -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, summed over ``iters`` calls by ``torch.profiler`` (CUPTI) and
    divided by ``iters``.  Host gaps between kernels are not counted, so a
    kernel faster than its Python wrapper is still timed, not the wrapper.
    With ``flush``, each call follows a write to a 128 MB buffer, which
    pushes the inputs out of the 50 MB L2 (as each layer's pools are cold
    in the decode loop); the write's own kernel is left out.  Where
    :data:`PROFILE_TRIES` profiles saw no kernel, each call is timed
    between its own pair of CUDA events (the flush write outside them),
    which counts host gaps inside the call, and the case is logged and
    listed in :data:`TIMED_BY_EVENTS`."""
    total = profiled_ms(torch, fn, iters, flush)
    if total:
        return total
    total = events_each_ms(torch, fn, iters, flush)
    TIMED_BY_EVENTS.append((what or getattr(fn, "__name__", "?"), total))
    log(f"torch.profiler saw no kernel in {PROFILE_TRIES} profiles of "
        f"{TIMED_BY_EVENTS[-1][0]}: timed by CUDA events, {total:.4f} ms")
    return total


def profiled_ms(torch, fn, iters: int, flush: bool = False) -> float:
    """:func:`device_ms` by the profiler alone: 0.0 when none of
    :data:`PROFILE_TRIES` profiles saw a kernel."""
    buf = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
           if flush else None)
    fn()
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            if buf is not None:
                buf.fill_(float(i))
            fn()

    kernels = profile_kernels(torch, run)
    return sum(ms for name, ms in kernels.items()
               if "FillFunctor" not in name) / iters


def profile_kernels(torch, run) -> dict:
    """``run()`` under ``torch.profiler`` (device activity only), then a
    synchronize; device time by kernel name (:func:`device_kernel_ms`).
    A profile that saw no device event is taken again, so ``run`` is
    called up to :data:`PROFILE_TRIES` times; ``{}`` if none saw one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = device_kernel_ms(prof)
        if kernels:
            return kernels
    return {}


def events_each_ms(torch, fn, iters: int, flush: bool = False) -> float:
    """Mean time of one call of ``fn`` between a CUDA event pair of its own;
    with ``flush``, a 128 MB write before each pair, outside it."""
    buf = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
           if flush else None)
    pairs = []
    for i in range(iters):
        if buf is not None:
            buf.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def flash_errors(got, ref, rel=FLASH_BF16_REL):
    """Max abs error, and max error in units of the elementwise bound."""
    diff = (got.float() - ref).abs()
    scaled = diff / (rel * ref.abs() + FLASH_F32_SLACK)
    return float(diff.max()), float(scaled.max())


def flash_within(got, ref) -> bool:
    err, scaled = flash_errors(got, ref)
    return err <= FLASH_BF16_TOL and scaled <= 1.0


def check_flash_output(torch, name, got, ref) -> float:
    if not torch.isfinite(got.float()).all():
        fail(f"flash {name}: non-finite output")
    err, scaled = flash_errors(got, ref)
    if err > FLASH_BF16_TOL or scaled > 1.0:
        fail(f"flash {name}: max abs err {err} (limit {FLASH_BF16_TOL}), "
             f"{scaled} x the elementwise bf16 bound")
    return err


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_all() -> dict:
    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data import native

    t0 = time.perf_counter()
    host = threading.Thread(target=native.load)
    host.start()
    try:
        kernels.build()
    finally:
        host.join()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [line.strip() for line in kernels.build_log(name).splitlines()
               if "registers" in line or "spill" in line]
        for name in ("flash_attention", "keyword_scan", "paged_attention")
    }
    log(f"built kernels in {seconds:.1f} s; native tokenizer "
        f"{'on' if native.available() else 'off: ' + str(native.load_error())}")
    for name, lines in ptxas.items():
        for line in lines:
            log(f"{name}: {line}")
    for name in ("flash_attention", "keyword_scan", "paged_attention"):
        spills = [line for line in ptxas[name]
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        if spills or not ptxas[name]:
            fail(f"{name}: ptxas reports spills (or printed nothing): {spills}")
    return {"build_s": seconds, "ptxas": ptxas,
            "native_tokenizer": native.available()}


def check_flash(torch, dev) -> dict:
    """Kernel vs plain version on the card, at DistilBERT shapes and in the
    causal + GQA + offset and residual modes at D=128."""
    import numpy as np

    from music_analyst_tpu_torch.models.distilbert import (
        expand_packed,
        pack_segments,
    )
    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    errs = {}
    B, S, H, D = 256, 128, 12, 64
    q, k, v = randn(B, S, H, D), randn(B, S, H, D), randn(B, S, H, D)
    lengths = torch.randint(1, S + 1, (B,), generator=gen).to(dev, torch.int32)
    # Packed rows: real best-fit packing of random lyric lengths.
    rng = np.random.default_rng(2)
    _, _, starts, row_len = pack_segments(rng.integers(2, 129, 700), S)
    starts, row_len = starts[:B], row_len[:B]
    seg, _ = expand_packed(torch.from_numpy(starts).to(dev),
                           torch.from_numpy(row_len).to(dev), S)
    rows = starts.shape[0]
    cases = {
        "distilbert_flat": (q, k, v, dict(lengths=lengths)),
        "distilbert_packed": (q[:rows], k[:rows], v[:rows], dict(
            lengths=torch.from_numpy(row_len).to(dev, torch.int32),
            q_segment_ids=seg)),
    }
    qg = randn(4, 200, 8, 128)
    kg, vg = randn(4, 328, 2, 128), randn(4, 328, 2, 128)
    lg = torch.tensor([328, 300, 170, 129], dtype=torch.int32, device=dev)
    cases["causal_gqa_offset_d128"] = (qg, kg, vg, dict(
        lengths=lg, causal=True, q_offset=128))
    # One query row over 17 kv tiles at D=128.
    q1, k1, v1 = randn(4, 1, 8, 128), randn(4, 1040, 8, 128), randn(4, 1040, 8, 128)
    cases["s1_kv1040_d128"] = (q1, k1, v1, dict(
        lengths=torch.tensor([1040, 1000, 65, 1], dtype=torch.int32, device=dev)))
    for name, (qq, kk, vv, kw) in cases.items():
        got = flash_attention(qq, kk, vv, **kw)
        ref = flash_attention_reference(qq.float(), kk.float(), vv.float(), **kw)
        errs[name] = check_flash_output(torch, name, got, ref)
    kw = dict(lengths=lg, causal=True, q_offset=128, return_residuals=True)
    o, m, l = flash_attention(qg, kg, vg, **kw)
    ro, rm, rl = flash_attention_reference(qg.float(), kg.float(), vg.float(), **kw)

    def normed(o, l):
        return o / l.clamp(min=1e-30).permute(0, 2, 1)[..., None]

    live = rl > 0
    res_errs = [
        float((normed(o, l) - normed(ro, rl)).abs().max()),
        float((m - rm).abs()[live].max()),
        float(((l - rl).abs() / rl.clamp(min=1e-30))[live].max()),
    ]
    errs["residual_d128"] = max(res_errs)
    if errs["residual_d128"] > FLASH_F32_TOL:
        fail(f"flash residual: errors (o, m, l) {res_errs} > {FLASH_F32_TOL}")
    torch.cuda.synchronize()
    log(f"flash kernel vs plain: {errs}")
    return errs


def keyword_matrix(torch, dev, rows=8192, width=4096):
    """Seeded random bytes with mixed-case keywords planted in 2 of 3 rows."""
    import numpy as np

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
    words = [b"LOVE", b"Sunshine", b"tears", b"cRy", b"joy", b"Lonely",
             b"SMILE", b"pain", b"happy", b"sAd"]
    for i in range(rows):
        for w in rng.choice(len(words), size=int(rng.integers(0, 3))):
            word = words[w]
            p = int(rng.integers(0, width - len(word) + 1))
            x[i, p:p + len(word)] = np.frombuffer(word, np.uint8)
    return torch.from_numpy(x).to(dev)


def keyword_corpus_batch(torch, dev, dataset, rows=4096):
    """The first ``rows`` corpus songs padded as the ``--mock`` path pads a
    batch (``score_texts``: the power-of-two bucket, floor 512, cap 4096,
    over its longest lyric), and the share of its bytes that are lyric."""
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.ops.keyword_sentiment import encode_batch
    from music_analyst_tpu_torch.utils.shapes import round_pow2

    texts = [t for _, _, t in iter_songs(dataset, limit=rows)]
    sizes = [len(t.strip().encode("utf-8", errors="replace")) for t in texts]
    bucket = min(round_pow2(min(max(sizes), 4096), 512), 4096)
    batch, _ = encode_batch(texts, bucket)
    return torch.from_numpy(batch).to(dev), sum(sizes) / batch.size


def keyword_edge_cases(width=4096):
    """Named uint8 matrices for the scan's edges (numpy, seeded): keyword
    halves across a row boundary (the reference scores those rows 0), each
    keyword at position 0 and at L - m, every byte value around planted
    upper-case words, and ragged widths (L = 5000, L < 8)."""
    import numpy as np

    from music_analyst_tpu_torch.ops.keyword_kernel import KEYWORDS

    rng = np.random.default_rng(6)
    cases = {}
    halves = np.zeros((2 * len(KEYWORDS), width), np.uint8)
    for i, kw in enumerate(KEYWORDS):
        cut = len(kw) // 2
        halves[2 * i, width - cut:] = np.frombuffer(kw[:cut].upper().encode(), np.uint8)
        halves[2 * i + 1, :len(kw) - cut] = np.frombuffer(kw[cut:].encode(), np.uint8)
    cases["row_boundary_halves"] = halves
    for L in (width, 5000):
        ends = rng.integers(97, 123, size=(2 * len(KEYWORDS), L), dtype=np.uint8)
        for i, kw in enumerate(KEYWORDS):
            data = np.frombuffer(kw.encode(), np.uint8)
            ends[2 * i, :len(data)] = data
            ends[2 * i + 1, L - len(data):] = data
        cases[f"ends_L{L}"] = ends
    rows = []
    for word in (b"LOVE", b"SUNSHINE", b"TEARS", b"CRY", b"LoNeLy", b"Happy"):
        for value in range(256):
            row = np.full(256, value, np.uint8)
            row[100:100 + len(word)] = np.frombuffer(word, np.uint8)
            rows.append(row)
    cases["byte_values"] = np.stack(rows)
    cases["L5000"] = rng.integers(0, 256, size=(300, 5000), dtype=np.uint8)
    for i, word in enumerate((b"LoVe", b"TEARS", b"sunshine", b"Joy", b"sad")):
        cases["L5000"][i::5, 4093 + i:4093 + i + len(word)] = np.frombuffer(word, np.uint8)
    for L in (1, 3, 5, 7):
        small = rng.integers(60, 123, size=(64, L), dtype=np.uint8)
        small[::4, :3] = np.frombuffer(b"JoY", np.uint8)[:min(3, L)]
        cases[f"L{L}"] = small
    return cases


def check_keyword(torch, dev, x) -> dict:
    """The scan on the random matrix ``x``, on each edge case and on a view
    offset by one byte (the kernel's byte-load instance), all exactly
    against the plain version; returns the rows with hits per case."""
    from music_analyst_tpu_torch.ops.keyword_kernel import (
        keyword_scan,
        keyword_scan_reference,
    )

    cases = {"random": x}
    for name, matrix in keyword_edge_cases().items():
        cases[name] = torch.from_numpy(matrix).to(dev)
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
    cases["offset_1_byte"] = flat[1:].view(x.shape)
    cases["offset_1_byte"].copy_(x)
    cases["B1"] = x[:1]
    rows_hit = {}
    for name, matrix in cases.items():
        scores, hits = keyword_scan(matrix, return_hits=True)
        ref_scores, ref_hits = keyword_scan_reference(matrix)
        if not (torch.equal(scores, ref_scores) and torch.equal(hits, ref_hits)):
            bad = int(((scores != ref_scores) | (hits != ref_hits)).sum())
            fail(f"keyword scan differs from its plain version on {bad} rows "
                 f"of case {name} {tuple(matrix.shape)}")
        rows_hit[name] = int((ref_hits != 0).sum())
    if rows_hit["row_boundary_halves"] != 0:
        fail("keyword halves across a row boundary scored a hit")
    if cases["offset_1_byte"].data_ptr() % 16 == 0:
        fail("the offset view is aligned: the byte-load instance went untested")
    log(f"keyword kernel == plain on {len(cases)} cases; rows with hits "
        f"{rows_hit}")
    return rows_hit


def measure(torch, dev, corpus_lengths, x, corpus_batch, lyric_share) -> dict:
    """Kernel, plain version, library call and bound at main-path shapes.
    The flash kernel's output there is also held against its plain version,
    and a broken variant (one key dropped per row) must break the limits.
    The scan is timed on a ``--mock`` corpus batch and on ``x``."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    out = {}
    gen = torch.Generator().manual_seed(4)
    B, S, H, D = BATCH, 128, 12, 64
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    lengths = torch.as_tensor(corpus_lengths[:B], dtype=torch.int32, device=dev)
    ref = flash_attention_reference(q.float(), k.float(), v.float(),
                                    lengths=lengths)
    err = check_flash_output(torch, "main shape", flash_attention(
        q, k, v, lengths=lengths), ref)
    dropped = flash_attention(q, k, v, lengths=(lengths - 1).clamp(min=1))
    bad_err, bad_scaled = flash_errors(dropped, ref)
    if flash_within(dropped, ref):
        fail(f"flash limits pass a kernel that drops one key: max abs err "
             f"{bad_err}, {bad_scaled} x the elementwise bound")
    log(f"flash at main shape: max abs err {err}; one key dropped reads "
        f"{bad_err} ({bad_scaled} x the elementwise bound)")
    del ref, dropped
    torch.cuda.empty_cache()
    kernel_ms = time_ms(torch, lambda: flash_attention(q, k, v, lengths=lengths), 10)
    plain_ms = time_ms(
        torch, lambda: flash_attention_reference(q, k, v, lengths=lengths), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 10)
    # q and o at full S; k and v only below each row's length.
    sum_len = float(lengths.sum())
    bytes_moved = 2 * B * S * H * D * 2 + 2 * sum_len * H * D * 2 + B * 4
    flops = 4.0 * H * D * S * sum_len
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    out["flash_attention"] = dict(
        shape=f"q/k/v bf16 [{B},{S},{H},{D}], corpus lengths",
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, flops=flops,
        max_abs_err=err, one_key_dropped=dict(max_abs_err=bad_err,
                                              bound_units=bad_scaled))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["keyword_scan"] = keyword_timing(torch, corpus_batch)
    out["keyword_scan"]["lyric_share"] = lyric_share
    out["keyword_scan"]["random_8192x4096"] = keyword_timing(torch, x)
    out["keyword_scan"]["timing_s"] = time.perf_counter() - t0
    log(f"timings: {json.dumps(out)}")
    return out


def keyword_timing(torch, x) -> dict:
    """The scan on ``x``: kernel device time by ``torch.profiler``, warm and
    with L2 flushed (both matrices fit the 50 MB L2, and back-to-back CUDA
    events time the Python wrapper once the kernel is faster than it),
    beside those events, the plain version and the bound."""
    from music_analyst_tpu_torch.ops.keyword_kernel import (
        KEYWORDS,
        keyword_scan,
        keyword_scan_reference,
    )

    rows, width = x.shape
    call = lambda: keyword_scan(x)  # noqa: E731
    bytes_moved = rows * width + rows * 4
    ops = float(rows * width * len(KEYWORDS))
    b_ms, b_by = bound(bytes_moved, ops, PEAK_INT8_OPS)
    return dict(
        shape=f"uint8 [{rows},{width}]",
        ms=device_ms(torch, call, 50, what="keyword_scan"),
        ms_l2_flushed=device_ms(torch, call, 50, flush=True,
                                what="keyword_scan flushed"),
        event_ms=time_ms(torch, call, 50, 3),
        plain_ms=time_ms(torch, lambda: keyword_scan_reference(x), 2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved,
        ops=ops)


def reference_mock_label(text: str) -> str:
    """The reference heuristic (scripts/sentiment_classifier.py:57-83)."""
    from music_analyst_tpu_torch.ops.keyword_kernel import (
        NEGATIVE_KEYWORDS,
        POSITIVE_KEYWORDS,
    )

    lowered = text.strip().lower()
    score = (sum(w in lowered for w in POSITIVE_KEYWORDS)
             - sum(w in lowered for w in NEGATIVE_KEYWORDS))
    return "Positive" if score > 0 else "Negative" if score < 0 else "Neutral"


def device_kernel_ms(prof) -> dict:
    """Device time by kernel name (ms) from a finished profile; device-side
    events only, since CPU ops carry their kernels' time too."""
    from torch.autograd import DeviceType

    kernels = {}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels[event.key] = kernels.get(event.key, 0.0) + us / 1e3
    return kernels


def breakdown(torch, clf, texts) -> dict:
    """Where one flat 8192-song batch spends its time: host prepare
    (tokenize + plan) on the host clock, then transfer + forward + collect
    under ``torch.profiler`` with device time summed by kernel."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    prepared = clf.prepare(texts)
    prepare_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.collect(clf.launch(clf.transfer(prepared)))
    device_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.collect(clf.launch(clf.transfer(prepared)))
        traced_wall_s = time.perf_counter() - t0
    kernels = device_kernel_ms(prof)
    busy_ms = sum(kernels.values())
    groups = {"flash_attention": 0.0, "gemm": 0.0, "memcpy": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        key = ("flash_attention" if "flash_fwd" in low or "flash_wgmma" in low else
               "memcpy" if "memcpy" in low else
               "gemm" if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet")) else
               "other")
        groups[key] += ms
    top = [(name[:96], ms) for name, ms in
           sorted(kernels.items(), key=lambda kv: -kv[1])[:8]]
    out = dict(prepare_s=prepare_s, device_wall_s=device_wall_s,
               traced_wall_s=traced_wall_s, device_busy_ms=busy_ms,
               device_idle_share=(max(0.0, 1 - busy_ms / 1e3 / traced_wall_s)
                                  if busy_ms else None),
               groups_ms=groups, top_kernels_ms=top)
    log(f"breakdown of one 8192-song flat batch: {json.dumps(out)}")
    return out


def main_path(torch, dev, dataset, card) -> dict:
    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.cli.main import main as cli_main
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
        DistilBertForSentiment,
    )
    from music_analyst_tpu_torch.runtime.wire import to_device

    report = {}
    texts = [t for _, _, t in iter_songs(dataset)]
    cfg = DistilBertConfig(attn_impl="flash")
    for mode in ("flat", "packed"):
        clf = DistilBertClassifier.from_pretrained_or_random(
            "distilbert-packed" if mode == "packed" else "distilbert",
            config=cfg, seed=0, device=dev)
        clf.classify_batch(texts[:BATCH])          # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        out_dir = os.path.join(WORK, f"distilbert_{mode}")
        rates = []
        for _ in range(REPEATS):
            kernels.reset_launches()
            result = run_sentiment(dataset, backend=clf, output_dir=out_dir,
                                   batch_size=BATCH, quiet=True)
            torch.cuda.synchronize()
            launches = kernels.launches()
            if launches["flash_attention"] == 0:
                fail(f"distilbert {mode}: the flash kernel never launched")
            rates.append(result.songs_per_second)
        with open(os.path.join(out_dir, "sentiment_totals.json")) as fh:
            totals = json.load(fh)
        if sum(totals.values()) != N_SONGS:
            fail(f"distilbert {mode}: totals {totals} do not cover {N_SONGS}")
        report[f"distilbert_{mode}"] = dict(
            songs_per_s=float(np.median(rates)), songs_per_s_runs=rates,
            launches=launches, totals=totals)
        log(f"distilbert {mode}: median {np.median(rates):.1f} songs/s "
            f"(runs {[round(r, 1) for r in rates]}) on {card}; "
            f"launches {launches}; totals {totals}")
        ids, lens = clf.tokenizer.encode_batch(texts[:1024], clf.max_len)
        tid, tlen = to_device([ids, lens], dev)
        flat_logits = clf.forward_logits(tid, tlen)
        if mode == "flat":
            # Flash vs dense forward on one batch, same weights; then the
            # flash model with its lengths ignored must break the limit.
            dense = DistilBertForSentiment(
                DistilBertConfig(attn_impl="dense")).to(dev).eval()
            dense.load_state_dict(clf.model.state_dict())
            with torch.inference_mode():
                dense_logits = dense(tid.long(), tlen)
            unmasked = clf.forward_logits(tid, torch.full_like(tlen, clf.max_len))
            diff = float((flat_logits - dense_logits).abs().max())
            bad = float((unmasked - dense_logits).abs().max())
            scale = max(1.0, float(dense_logits.abs().max()))
            report["logits_flash_vs_dense"] = dict(
                max_abs_diff=diff, scale=scale, lengths_ignored=bad)
            log(f"logits flash vs dense: max |diff| {diff:.4g}, scale "
                f"{scale:.4g}; with lengths ignored {bad:.4g}")
            if (not torch.isfinite(flat_logits).all()
                    or diff > LOGIT_REL_TOL * scale):
                fail(f"flash vs dense logits differ by {diff} "
                     f"(> {LOGIT_REL_TOL} x {scale})")
            if bad <= LOGIT_REL_TOL * scale:
                fail(f"the logit limit passes a model that ignores lengths "
                     f"({bad} <= {LOGIT_REL_TOL} x {scale})")
            del dense, dense_logits, unmasked
            report["breakdown_flat_batch"] = breakdown(torch, clf, texts[:BATCH])
            report["serve"] = serve_distilbert_path(torch, dev, clf, dataset,
                                                    texts, card)
        else:
            # The whole packed path (plan, wire, device-side segment and
            # position expansion, CLS gather) against flat rows, per song.
            packed_logits = clf.forward_logits_packed(texts[:1024])
            diff = float((packed_logits - flat_logits).abs().max())
            scale = max(1.0, float(flat_logits.abs().max()))
            report["logits_packed_vs_flat"] = dict(max_abs_diff=diff,
                                                   scale=scale)
            log(f"logits packed vs flat: max |diff| {diff:.4g}, "
                f"scale {scale:.4g}")
            if (not torch.isfinite(packed_logits).all()
                    or diff > LOGIT_REL_TOL * scale):
                fail(f"packed vs flat logits differ by {diff} "
                     f"(> {LOGIT_REL_TOL} x {scale})")
        del flat_logits, clf
        torch.cuda.empty_cache()

    out_dir = os.path.join(WORK, "mock")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(["sentiment", dataset, "--mock", "--output-dir", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    # One launch per 4,096-song batch: no corpus lyric exceeds the 4,096-byte
    # cap, so none takes the chunked long-lyric path.
    if rc != 0 or launches["keyword_scan"] != -(-N_SONGS // MOCK_BATCH):
        fail(f"mock CLI rc {rc}, keyword kernel launches {launches}")
    with open(os.path.join(out_dir, "sentiment_details.csv"), newline="",
              encoding="utf-8") as fh:
        import csv

        got = [row["label"] for row in csv.DictReader(fh)]
    want = [reference_mock_label(t) for t in texts]
    if got != want:
        bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        fail(f"mock CLI labels differ from the reference heuristic on {bad} songs")
    report["mock_cli"] = dict(songs_per_s=N_SONGS / wall, launches=launches)
    log(f"mock CLI: {N_SONGS / wall:.1f} songs/s (wall, process-local); "
        f"launches {launches}; labels == reference on all {N_SONGS}")
    return report


# ------------------------------------------- word count and joint (slice 6)

# The real dataset's row count (spotify_millsongdata.csv): ~10 M tokens of
# the synthetic corpus, which `--chunk-songs auto` streams in ~5 chunks.
ANALYZE_SONGS = 57_650
ANALYZE_REPEATS = 1   # analyze processes per layout
ANALYZE_LAYOUTS = {
    "auto_streaming": [],
    "host_shard": ["--chunk-songs", "0"],
    "device_ids": ["--chunk-songs", "0", "--count-mode", "device-ids"],
}
JOINT_DISTILBERT_BATCH = 8192
# The north star's corpus (BASELINE.json: 1 M songs): ~180 M int32 ids
# from a finite Zipf law (s = 1) over 2^18 shuffled word ranks, 1% PAD_ID.
HIST_IDS = 180_000_000
HIST_SONGS = 1_000_000
HIST_VOCAB = 1 << 18


def analyze_cli(dataset, out_dir, flags):
    """One ``python -m music_analyst_tpu_torch analyze`` process on the
    card; returns its metrics, console report and process wall."""
    cmd = [sys.executable, "-m", "music_analyst_tpu_torch", "analyze",
           dataset, "--ingest", "native", "--no-corpus-cache",
           "--output-dir", out_dir, *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"analyze {flags}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "performance_metrics.json")) as fh:
        metrics = json.load(fh)
    return metrics, proc.stdout, wall


def read_outputs(out_dir, names=("word_counts.csv", "top_artists.csv")):
    out = {}
    for name in names:
        with open(os.path.join(out_dir, name), "rb") as fh:
            out[name] = fh.read()
    return out


def oracle_outputs(corpus, out_dir):
    """The two count CSVs from a host ``np.bincount`` over the ingest."""
    import numpy as np

    from music_analyst_tpu_torch.data.csv_io import (
        sort_count_entries,
        write_count_csv,
    )

    os.makedirs(out_dir, exist_ok=True)
    for name, header, ids, vocab in (
            ("word_counts.csv", "word", corpus.word_ids, corpus.word_vocab),
            ("top_artists.csv", "artist", corpus.artist_ids,
             corpus.artist_vocab)):
        ids = np.asarray(ids)
        counts = np.bincount(ids[ids >= 0], minlength=max(1, len(vocab)))
        write_count_csv(os.path.join(out_dir, name), header,
                        sort_count_entries(vocab.counts_to_entries(counts)))
    return read_outputs(out_dir)


def check_metrics(name, metrics, songs, tokens):
    if (metrics.get("device_platform") != "gpu" or metrics.get("processes") != 1
            or [c["platform"] for c in metrics["per_chip"]] != ["gpu"]
            or metrics["total_songs"] != songs
            or metrics["total_words"] != tokens):
        fail(f"{name}: performance_metrics.json says {json.dumps(metrics)}")


def analyze_breakdown(torch, dev, corpus, dataset):
    """One default-layout ``run_analysis`` on the ingested corpus under
    ``torch.profiler``: stage seconds, device busy time, the H2D share of
    it and the card's idle share over the histogram stage."""
    from torch.profiler import ProfilerActivity, profile

    from music_analyst_tpu_torch.engines.wordcount import run_analysis

    out_dir = os.path.join(WORK, "analyze_profiled")
    run_analysis(dataset, output_dir=out_dir, corpus=corpus, quiet=True,
                 write_split=False, device=dev)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run_analysis(dataset, output_dir=out_dir, corpus=corpus,
                              quiet=True, write_split=False, device=dev)
        torch.cuda.synchronize()
    kernels = device_kernel_ms(prof)
    busy = sum(kernels.values())
    h2d = sum(ms for name, ms in kernels.items() if "HtoD" in name)
    compute_s = result.timings["device_compute"]
    return dict(stages_s=result.timings, device_busy_ms=busy, h2d_ms=h2d,
                h2d_share=h2d / busy if busy else None,
                device_idle_share_of_device_compute=(
                    max(0.0, 1 - busy / 1e3 / compute_s) if busy else None),
                top_device_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:6])


def analyze_path(torch, dev, card) -> dict:
    """``analyze`` on the card at the real dataset's size in three layouts,
    ``ANALYZE_REPEATS`` processes each; every layout, a ``--ingest
    python`` run and a host ``np.bincount`` oracle must write the same
    bytes.  Returns the report and the oracle's CSV bytes."""
    import numpy as np

    from music_analyst_tpu_torch.cli.main import main as cli_main
    from music_analyst_tpu_torch.data.ingest import ingest_dataset
    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.ops.histogram import (
        chunk_token_bounds,
        resolve_chunk_songs,
    )

    t0 = time.perf_counter()
    dataset = os.path.join(WORK, f"songs_{ANALYZE_SONGS}.csv")
    generate_dataset(dataset, num_songs=ANALYZE_SONGS, seed=17)
    corpus = ingest_dataset(dataset, backend="native")
    chunk = resolve_chunk_songs("auto", corpus.song_count, corpus.token_count)
    n_chunks = len(chunk_token_bounds(corpus.word_offsets, chunk)) - 1
    songs, tokens = corpus.song_count, corpus.token_count
    log(f"analyze corpus: {songs} songs, {tokens} tokens, "
        f"{len(corpus.word_vocab)} words, {len(corpus.artist_vocab)} artists; "
        f"auto streams {n_chunks} chunks of {chunk} songs "
        f"(set-up {time.perf_counter() - t0:.1f} s)")
    if songs != ANALYZE_SONGS or n_chunks < 2:
        fail(f"analyze corpus: {songs} songs, {n_chunks} chunks")
    want = oracle_outputs(corpus, os.path.join(WORK, "analyze_oracle"))

    report = dict(songs=songs, tokens=tokens, chunk_songs=chunk,
                  chunks=n_chunks, layouts={})
    for name, flags in ANALYZE_LAYOUTS.items():
        runs = []
        for i in range(ANALYZE_REPEATS):
            out_dir = os.path.join(WORK, f"analyze_{name}")
            metrics, stdout, wall = analyze_cli(dataset, out_dir, flags)
            check_metrics(f"analyze {name}", metrics, songs, tokens)
            if f"Total songs processed: {songs}" not in stdout.splitlines():
                fail(f"analyze {name}: console report lacks the song total")
            if read_outputs(out_dir) != want:
                fail(f"analyze {name}: CSVs differ from the np.bincount oracle")
            engine_s = sum(metrics["stages"].values())
            runs.append(dict(songs_per_s=songs / engine_s,
                             tokens_per_s=tokens / engine_s,
                             engine_s=engine_s, process_wall_s=wall,
                             stages_s=metrics["stages"]))
        med = lambda key: float(np.median([r[key] for r in runs]))  # noqa: E731
        stage_med = {k: float(np.median([r["stages_s"][k] for r in runs]))
                     for k in runs[0]["stages_s"]}
        report["layouts"][name] = dict(
            flags=flags, songs_per_s=med("songs_per_s"),
            tokens_per_s=med("tokens_per_s"), engine_s=med("engine_s"),
            process_wall_s=med("process_wall_s"), stages_s=stage_med,
            runs=runs)
        log(f"analyze {name} on {card}: median {med('songs_per_s'):.1f} songs/s, "
            f"{med('tokens_per_s'):.1f} tokens/s over {med('engine_s'):.3f} s "
            f"of stages (process {med('process_wall_s'):.2f} s); stages "
            f"{json.dumps({k: round(v, 4) for k, v in stage_med.items()})}")

    out_dir = os.path.join(WORK, "analyze_python_ingest")
    rc = cli_main(["analyze", dataset, "--ingest", "python",
                   "--no-corpus-cache", "--output-dir", out_dir])
    if rc != 0 or read_outputs(out_dir) != want:
        fail("analyze --ingest python: CSVs differ from the native layouts")
    report["breakdown"] = analyze_breakdown(torch, dev, corpus, dataset)
    log(f"analyze breakdown (auto layout, in-process): "
        f"{json.dumps(report['breakdown'])}")
    report["dataset"] = dataset
    return report, want


def joint_path(torch, card, analyze, oracle) -> dict:
    """``analyze --with-sentiment`` on the analyze corpus: ``--mock``
    (keyword scan, once per 4,096-song batch; labels equal the reference
    heuristic) and full-size DistilBERT (flash, six launches a batch)."""
    import csv

    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.cli.main import main as cli_main
    from music_analyst_tpu_torch.data.ingest import ingest_dataset

    dataset, songs = analyze["dataset"], analyze["songs"]
    texts = [t for _, _, t in ingest_dataset(
        dataset, backend="native", capture_records=True).iter_records()]
    want_labels = [reference_mock_label(t) for t in texts]
    report = {}
    for name, flags, batch, kernel, per_batch in (
            ("mock", ["--mock"], MOCK_BATCH, "keyword_scan", 1),
            ("distilbert", ["--model", "distilbert"], JOINT_DISTILBERT_BATCH,
             "flash_attention", 6)):
        out_dir = os.path.join(WORK, f"joint_{name}")
        rates, launch_runs = [], []
        for _ in range(REPEATS if name == "mock" else 1):
            kernels.reset_launches()
            rc = cli_main(["analyze", dataset, "--with-sentiment", *flags,
                           "--batch-size", str(batch), "--ingest", "native",
                           "--no-corpus-cache", "--output-dir", out_dir])
            torch.cuda.synchronize()
            launches = kernels.launches()
            want_launches = per_batch * -(-songs // batch)
            if rc != 0 or launches[kernel] != want_launches:
                fail(f"joint {name}: rc {rc}, launches {launches} "
                     f"(want {kernel} x {want_launches})")
            with open(os.path.join(out_dir, "performance_metrics.json")) as fh:
                metrics = json.load(fh)
            check_metrics(f"joint {name}", metrics, songs, analyze["tokens"])
            rates.append(songs / metrics["total_time"]["max_seconds"])
            launch_runs.append(launches)
        if read_outputs(out_dir) != oracle:
            fail(f"joint {name}: word/artist CSVs differ from the plain run's")
        with open(os.path.join(out_dir, "sentiment_details.csv"), newline="",
                  encoding="utf-8") as fh:
            labels = [row["label"] for row in csv.DictReader(fh)]
        with open(os.path.join(out_dir, "sentiment_totals.json")) as fh:
            totals = json.load(fh)
        if len(labels) != songs or sum(totals.values()) != songs:
            fail(f"joint {name}: {len(labels)} labels, totals {totals}")
        if name == "mock" and labels != want_labels:
            bad = sum(a != b for a, b in zip(labels, want_labels))
            fail(f"joint mock: labels differ from the reference on {bad} songs")
        report[name] = dict(songs_per_s=float(np.median(rates)),
                            songs_per_s_runs=rates, launches=launch_runs[-1],
                            totals=totals, stages_s=metrics["stages"])
        log(f"joint {name} on {card}: {float(np.median(rates)):.1f} songs/s "
            f"(runs {[round(r, 1) for r in rates]}); launches "
            f"{launch_runs[-1]}; totals {totals}; stages "
            f"{json.dumps({k: round(v, 4) for k, v in metrics['stages'].items()})}")
        torch.cuda.empty_cache()
    return report


def zipf_ids(torch, dev, n, ranks, seed):
    """``n`` int32 ids drawn on the card from a finite Zipf law (s = 1)
    over ``ranks`` shuffled ranks, 1% of them ``PAD_ID``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = 1.0 / torch.arange(1, ranks + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(weights, 0) / weights.sum()
    perm = torch.randperm(ranks, device=dev, generator=gen).to(torch.int32)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    step = 1 << 25
    for s in range(0, n, step):
        m = min(step, n - s)
        u = torch.rand(m, device=dev, dtype=torch.float64, generator=gen)
        rank = torch.searchsorted(cdf, u).clamp_(max=ranks - 1)
        part = perm[rank]
        pad = torch.rand(m, device=dev, generator=gen) < 0.01
        ids[s:s + m] = part.masked_fill_(pad, -1)
    return ids


def histogram_path(torch, dev, card) -> dict:
    """The port's histogram op on ~180 M ids (the 1 M-song north star),
    device-ids and streaming (auto chunks), held exactly against
    ``np.bincount``; wall, device time, H2D share, peak memory and the
    byte bound for each.  Dropping the last chunk must break exactness."""
    import numpy as np

    from music_analyst_tpu_torch.ops.histogram import (
        chunk_token_bounds,
        resolve_chunk_songs,
        sharded_histogram,
        sharded_histogram_streaming,
        token_histogram,
    )
    from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh

    t0 = time.perf_counter()
    ids_dev = zipf_ids(torch, dev, HIST_IDS, HIST_VOCAB, seed=23)
    gen = torch.Generator(device=dev).manual_seed(29)
    cuts = torch.sort(torch.randint(0, HIST_IDS + 1, (HIST_SONGS - 1,),
                                    device=dev, generator=gen)).values
    offsets = torch.cat([cuts.new_zeros(1), cuts,
                         cuts.new_full((1,), HIST_IDS)]).cpu().numpy()
    ids = ids_dev.cpu().numpy()
    want = np.bincount(ids[ids >= 0], minlength=HIST_VOCAB).astype(np.int32)
    setup_s = time.perf_counter() - t0
    mesh = data_parallel_mesh(device=dev)
    chunk = resolve_chunk_songs("auto", HIST_SONGS, HIST_IDS)
    bounds = chunk_token_bounds(offsets, chunk)
    bytes_read = HIST_IDS * 4
    # Bytes: each id read once, the int32 counts written once; operations:
    # one integer add per id, against the int8 peak (never the bound).
    bound_ms, bound_by = bound(bytes_read + HIST_VOCAB * 4, HIST_IDS,
                               PEAK_INT8_OPS)
    log(f"histogram input: {HIST_IDS} ids ({bytes_read / 1e6:.1f} MB), "
        f"{(ids < 0).mean():.4f} PAD_ID, hottest bin {int(want.max())}, "
        f"{HIST_SONGS} songs; auto chunks {len(bounds) - 1} of {chunk} "
        f"songs; set-up {setup_s:.1f} s; bound {bound_ms:.4f} ms ({bound_by})")

    calls = {
        "device_ids": lambda: sharded_histogram(
            ids, HIST_VOCAB, mesh).cpu().numpy(),
        "streaming": lambda: sharded_histogram_streaming(
            ids, offsets, HIST_VOCAB, mesh, chunk_songs=chunk),
    }
    report = dict(ids=HIST_IDS, songs=HIST_SONGS, vocab=HIST_VOCAB,
                  chunk_songs=chunk, chunks=len(bounds) - 1,
                  hottest_bin=int(want.max()), bound_ms=bound_ms,
                  bound_by=bound_by, setup_s=setup_s)
    for name, call in calls.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = call()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if not np.array_equal(got, want):
            fail(f"histogram {name}: counts differ from np.bincount on "
                 f"{int((got != want).sum())} bins")
        walls = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            got = call()
            walls.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(got, want):
                fail(f"histogram {name}: a repeat run is not exact")
        kernels = profile_kernels(torch, call)
        busy = sum(kernels.values())
        if kernels:
            h2d = sum(ms for key, ms in kernels.items() if "HtoD" in key)
        else:
            # No profile saw the device: the call between CUDA events,
            # and its H2D share not measured.
            busy, h2d = device_ms(torch, call, 1, what=f"histogram {name}"), None
        if name == "device_ids":
            # The whole put is one synchronous copy from pageable memory,
            # which torch.profiler may not record: time it on the host too.
            copies = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                torch.from_numpy(ids).to(dev)
                torch.cuda.synchronize()
                copies.append((time.perf_counter() - t0) * 1e3)
            h2d_wall = float(np.median(copies))
        else:
            h2d_wall = None
        report[name] = dict(
            wall_ms=float(np.median(walls)), wall_ms_runs=walls,
            h2d_wall_ms=h2d_wall, h2d_wall_share=(
                h2d_wall / float(np.median(walls)) if h2d_wall else None),
            device_ms=busy, h2d_ms=h2d,
            h2d_share=None if h2d is None else h2d / busy,
            non_h2d_device_ms=None if h2d is None else busy - h2d,
            max_memory_allocated=peak,
            top_device_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
        log(f"histogram {name} on {card}: wall {np.median(walls):.2f} ms "
            f"(runs {[round(w, 2) for w in walls]}), device {busy:.3f} ms of "
            f"which H2D " + ("not measured" if h2d is None else
                             f"{h2d:.3f} ({h2d / busy:.1%})")
            + f"; host-clock H2D "
            f"{h2d_wall} ms; peak {peak / 2**20:.1f} MiB; exact")
    # The scatter alone on ids already on the card, against the byte bound.
    scatter_ms = device_ms(torch, lambda: token_histogram(ids_dev, HIST_VOCAB),
                           iters=3, what="histogram scatter")
    report["scatter_only_device_ms"] = scatter_ms
    log(f"histogram scatter on ids on the card: {scatter_ms:.3f} ms device "
        f"(bound {bound_ms:.4f} ms, {scatter_ms / bound_ms:.0f}x)")
    # A variant that drops the last chunk must break exactness.
    short = sharded_histogram_streaming(
        ids[:bounds[-2]], offsets[:np.searchsorted(offsets, bounds[-2]) + 1],
        HIST_VOCAB, mesh, chunk_songs=chunk)
    if np.array_equal(short, want):
        fail("histogram: dropping the last chunk still passes the check")
    report["dropped_chunk_bins_differ"] = int((short != want).sum())
    del ids_dev
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------- paged attention (slice 2)

# Llama-3-8B decode geometry on the continuous scheduler's defaults:
# 8 slots, page 16, prompt region 1024, 16 new tokens -> 65 pages per slot,
# 520 pages + the trash page; 32 query heads over 8 kv heads of dim 128.
PAGED_SLOTS, PAGED_P, PAGED_REGION, PAGED_NEW = 8, 16, 1024, 16
PAGED_H, PAGED_KV, PAGED_D = 32, 8, 128
#  - paged kernel vs the f32 oracle on the same pools (bf16, or the same
#    int8 codes and scales, dequantized as the kernel's load does: codes x
#    scale rounded to bf16): the kernel rounds its f32 result to bf16 once,
#    so elementwise |got - ref| <= 2^-8 |ref| + 1e-5 (f32 sums in another
#    order), beside an absolute limit of 2e-2 (half a bf16 ulp at |o| < 8).
PAGED_ABS_TOL = 2e-2
#  - paged kernel vs the exact-order plain version, which rounds its
#    logits and its softmax weights to bf16 before the V sum: within
#    2^-5 of attention over |V| (the magnitude of the terms each output
#    sums), i.e. a few bf16 roundings of every term.
PAGED_PLAIN_REL = 2.0 ** -5
#  - Llama logits of one decode step, paged kernel vs dense attention over
#    the gathered view, same pool state: the two round attention
#    differently (the kernel keeps logits and weights in f32, dense rounds
#    both to bf16), and the bf16 layers carry the difference to the logits;
#    5e-2 of the logit scale (max |logit|).  A step that ignores the slot
#    lengths (attends to every row of its pages) must break it.
LLAMA_LOGIT_REL_TOL = 5e-2
# The Llama-3-8B phases (steps 5, 7, 8 and 13) run at full width and 4 of
# its 32 layers, cut in step 10's sweep over ranks to keep the script well
# inside its time; the quantized inits are also built at all 32 layers,
# for the memory they must stay under (step 7).
LLAMA_LAYERS = 4
LLAMA_SONGS = 16          # generate mode (64, then 32; cut to fit steps 8 and 13)
LLAMA_REPEATS = 1         # bf16 generate runs
LLAMA_SCORE_SONGS = 16    # score mode, one batch
LLAMA_INT8_PROMPTS = 10   # int8 pages, two waves on 8 slots (16 before)
LLAMA_COMPARE = 8         # warm-up and static-vs-continuous prompts (16 before)


def paged_case(torch, dev, quantized: bool, seed: int = 5,
               heads: int = PAGED_H, kv_heads: int = PAGED_KV) -> dict:
    """Pools, table and mask at the main decode shape (``heads`` /
    ``kv_heads`` per rank under tensor parallelism).  Slots 0..6 hold
    odd prompt lengths near 1,024 plus 1..7 decode rows; slot 7 is free,
    its whole row on the trash page, which holds garbage (1e4)."""
    import numpy as np

    from music_analyst_tpu_torch.ops.quant import quantize_kv_page

    rng = np.random.default_rng(seed)
    n, P = PAGED_SLOTS, PAGED_P
    pps = PAGED_REGION // P + -(-PAGED_NEW // P)
    n_pages = n * pps
    total = PAGED_REGION + PAGED_NEW
    table = rng.permutation(n_pages).reshape(n, pps).astype(np.int32)
    table[-1] = n_pages
    mask = np.zeros((n, total), bool)
    for i in range(n - 1):
        mask[i, :1023 - 2 * int(rng.integers(0, 60))] = True
        mask[i, PAGED_REGION:PAGED_REGION + 1 + i] = True
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_pages + 1, P, kv_heads, PAGED_D)
    keys = torch.randn(shape, generator=gen, device=dev)
    values = torch.randn(shape, generator=gen, device=dev)
    keys[n_pages], values[n_pages] = 1e4, -1e4
    q = torch.randn((n, 1, heads, PAGED_D), generator=gen,
                    device=dev).to(torch.bfloat16)
    case = dict(q=q, table=torch.as_tensor(table, device=dev),
                mask=torch.as_tensor(mask, device=dev), trash=n_pages)
    if quantized:
        case["key_pages"], case["key_scale"] = quantize_kv_page(keys)
        case["value_pages"], case["value_scale"] = quantize_kv_page(values)
    else:
        case["key_pages"] = keys.to(torch.bfloat16)
        case["value_pages"] = values.to(torch.bfloat16)
        case["key_scale"] = case["value_scale"] = None
    return case


def _pargs(case, **over):
    c = dict(case, **over)
    return ((c["q"], c["key_pages"], c["value_pages"], c["table"], c["mask"]),
            dict(key_scale=c["key_scale"], value_scale=c["value_scale"]))


def paged_errors(got, ref):
    """Over the active slots (the last is free): max abs error, and max
    error in units of the elementwise bf16 bound."""
    diff = (got[:-1].float() - ref[:-1]).abs()
    scaled = diff / (FLASH_BF16_REL * ref[:-1].abs() + FLASH_F32_SLACK)
    return float(diff.max()), float(scaled.max())


def paged_within(got, ref) -> bool:
    err, scaled = paged_errors(got, ref)
    return err <= PAGED_ABS_TOL and scaled <= 1.0


def check_paged_sparse(torch, dev) -> dict:
    """The split-K kernel where splits hold no key: slot 0 attends only to
    its first 10 keys, slot 1 to exactly one key, slot 2 to 40 keys that
    straddle a split boundary (the other splits of these slots are empty);
    slots 3..6 as in ``paged_case``, slot 7 free.  Same limits as the main
    case; the one-key slot must read that key's value row exactly (p = 1);
    two launches must agree bit for bit."""
    from music_analyst_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
        split_plan,
    )

    case = paged_case(torch, dev, False, seed=6)
    mask = case["mask"].clone()
    mask[:3] = False
    mask[0, :10] = True
    one = 700
    mask[1, one] = True
    chunk = split_plan(mask.shape[1], PAGED_P).chunk
    mask[2, 5 * chunk - 20:5 * chunk + 20] = True
    args, kw = _pargs(case, mask=mask)
    got = paged_attention(*args, **kw)
    again = paged_attention(*args, **kw)
    ref = paged_attention_reference(*args, **kw)
    err, scaled = paged_errors(got, ref)
    if err > PAGED_ABS_TOL or scaled > 1.0:
        fail(f"paged sparse splits: max abs err {err}, {scaled} x the bound")
    page = int(case["table"][1, one // PAGED_P])
    v_row = case["value_pages"][page, one % PAGED_P]          # [n_kv, D]
    want = v_row.repeat_interleave(PAGED_H // PAGED_KV, dim=0)
    if not torch.equal(got[1, 0], want):
        fail("paged sparse splits: the one-key slot does not read its value row")
    if not bool((got[-1] == 0).all()) or not torch.equal(got, again):
        fail("paged sparse splits: free slot not zero, or launches differ")
    out = dict(max_abs_err=err, bound_units=scaled, chunk=chunk)
    log(f"paged kernel with empty splits and a one-key slot: {json.dumps(out)}")
    return out


def check_paged(torch, dev) -> dict:
    """Kernel vs its plain versions at the main decode shape, bf16 and
    int8; exact zeros for the free slot; NaN in the trash page changes
    nothing; a shifted page and a dropped key must break the limits.
    Times the kernel, the exact-order plain version and the gather +
    ``scaled_dot_product_attention`` pair (context: two calls)."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.paged_attention import (
        _gather,
        paged_attention,
        paged_attention_plain,
        paged_attention_reference,
        split_plan,
    )
    from music_analyst_tpu_torch.ops.quant import dequantize_kv_page

    out = {}
    for quantized in (False, True):
        name = "int8" if quantized else "bf16"
        case = paged_case(torch, dev, quantized)
        args, kw = _pargs(case)
        got = paged_attention(*args, **kw)
        f32_dequant = None
        if quantized:
            # The oracle on the rows the kernel's load produces.
            ref = paged_attention_reference(*_pargs(
                case,
                key_pages=dequantize_kv_page(case["key_pages"], case["key_scale"]),
                value_pages=dequantize_kv_page(case["value_pages"],
                                               case["value_scale"]),
                key_scale=None, value_scale=None)[0])
            f32_dequant = float((got[:-1].float() - paged_attention_reference(
                *args, **kw)[:-1]).abs().max())
        else:
            ref = paged_attention_reference(*args, **kw)
        if not torch.isfinite(got.float()).all():
            fail(f"paged {name}: non-finite output")
        err, scaled = paged_errors(got, ref)
        if err > PAGED_ABS_TOL or scaled > 1.0:
            fail(f"paged {name}: max abs err {err} (limit {PAGED_ABS_TOL}), "
                 f"{scaled} x the elementwise bf16 bound")
        if not bool((got[-1] == 0).all()):
            fail(f"paged {name}: the free slot does not read exact zeros")
        plain = paged_attention_plain(*args, **kw)
        vabs_args, _ = _pargs(case, value_pages=case["value_pages"].abs())
        scale = paged_attention_reference(*vabs_args, **kw)
        plain_units = float(((got[:-1].float() - plain[:-1].float()).abs()
                             / (PAGED_PLAIN_REL * scale[:-1] + FLASH_F32_SLACK)).max())
        if plain_units > 1.0:
            fail(f"paged {name}: kernel vs exact-order plain version at "
                 f"{plain_units} x its bound")
        trash = case["trash"]
        dirty = {k: case[k].clone() for k in ("key_pages", "value_pages")}
        if quantized:
            dirty["key_pages"][trash] = 127
            dirty["value_pages"][trash] = -127
            dirty["key_scale"] = case["key_scale"].clone()
            dirty["value_scale"] = case["value_scale"].clone()
            dirty["key_scale"][trash] = float("nan")
            dirty["value_scale"][trash] = float("nan")
        else:
            dirty["key_pages"][trash] = float("nan")
            dirty["value_pages"][trash] = float("nan")
        dargs, dkw = _pargs(case, **dirty)
        if not torch.equal(paged_attention(*dargs, **dkw), got):
            fail(f"paged {name}: garbage in the trash page changed the output")
        if not torch.equal(paged_attention(*args, **kw), got):
            fail(f"paged {name}: two launches on the same inputs differ")
        shifted = case["table"].clone()
        shifted[0, 10] = case["table"][0, 11]
        sargs, skw = _pargs(case, table=shifted)
        dropped = case["mask"].clone()
        dropped[:, 0] = False
        margs, mkw = _pargs(case, mask=dropped)
        broken = {}
        for bname, (bargs, bkw) in (("page_shifted", (sargs, skw)),
                                    ("key_dropped", (margs, mkw))):
            bad = paged_attention(*bargs, **bkw)
            broken[bname] = paged_errors(bad, ref)
            if paged_within(bad, ref):
                fail(f"paged {name}: the limits pass a kernel with one "
                     f"{bname.replace('_', ' ')}: {broken[bname]}")
        entry = dict(max_abs_err=err, bound_units=scaled,
                     plain_bound_units=plain_units, broken=broken)
        if quantized:
            # Against the oracle that dequantizes in f32 (no bf16 rounding
            # of the rows): reported, not held to the half-ulp bound.
            entry["max_abs_err_vs_f32_dequant"] = f32_dequant
        if not quantized:
            valid = float(case["mask"].sum())
            n, H, D = PAGED_SLOTS, PAGED_H, PAGED_D
            # Valid K and V rows once, q and o once, table and mask once.
            bytes_moved = (2 * valid * PAGED_KV * D * 2 + 2 * n * H * D * 2
                           + case["table"].numel() * 4 + case["mask"].numel())
            flops = 4.0 * H * D * valid
            b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
            total = case["mask"].shape[1]
            qt = case["q"].transpose(1, 2)
            amask = case["mask"][:, None, None, :]

            def gather_sdpa():
                k = _gather(case["key_pages"], None, case["table"], total,
                            torch.bfloat16).transpose(1, 2)
                v = _gather(case["value_pages"], None, case["table"], total,
                            torch.bfloat16).transpose(1, 2)
                return F.scaled_dot_product_attention(qt, k, v, attn_mask=amask,
                                                      enable_gqa=True)

            plan = split_plan(total, PAGED_P)
            call = lambda: paged_attention(*args, **kw)  # noqa: E731
            entry.update(
                shape=(f"q bf16 [{n},1,{H},{D}]; pools bf16 "
                       f"{list(case['key_pages'].shape)}; table int32 "
                       f"{list(case['table'].shape)}; mask [{n},{total}]"),
                split_plan=dict(chunk=plan.chunk, splits=plan.splits,
                                blocks=n * PAGED_KV * plan.splits),
                timing=("ms, library_ms: kernel device time by torch.profiler "
                        "(CUPTI), mean over 100 / 50 calls, warm; *_l2_flushed: "
                        "the same after a 128 MB write before each call, the "
                        "write not counted; event_ms: CUDA events around "
                        "back-to-back eager calls; host_us: host time of one "
                        "wrapper call, mean over 200"),
                # Kernel device time (profiler), warm and with L2 flushed;
                # beside it the earlier method, CUDA events around
                # back-to-back wrapper calls, which now also counts the
                # wrapper's host time whenever that exceeds the kernel's.
                ms=device_ms(torch, call, 100, what=f"paged {name}"),
                ms_l2_flushed=device_ms(torch, call, 100, flush=True,
                                        what=f"paged {name} flushed"),
                event_ms=time_ms(torch, call, 100, 3),
                host_us=host_us(torch, call, 200),
                plain_ms=time_ms(torch, lambda: paged_attention_plain(*args, **kw), 5),
                library_ms=device_ms(torch, gather_sdpa, 50,
                                     what="gather + SDPA"),
                library_ms_l2_flushed=device_ms(
                    torch, gather_sdpa, 50, flush=True,
                    what="gather + SDPA flushed"),
                library_event_ms=time_ms(torch, gather_sdpa, 20),
                bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, flops=flops,
                valid_rows=valid)
        else:
            call = lambda: paged_attention(*args, **kw)  # noqa: E731
            entry.update(ms=device_ms(torch, call, 100, what=f"paged {name}"),
                         ms_l2_flushed=device_ms(
                             torch, call, 100, flush=True,
                             what=f"paged {name} flushed"))
        out[name] = entry
        del case, dirty
    out["sparse_splits"] = check_paged_sparse(torch, dev)
    torch.cuda.synchronize()
    log(f"paged kernel at the 8B decode shape: {json.dumps(out)}")
    return out


# ------------------------------------------------------ Llama path (slice 2)

def _active_scheduler(torch, clf, prompts, reqs=None):
    """A fresh scheduler with every slot prefilled and in decode; the
    submitted requests are appended to ``reqs`` when it is given."""
    from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

    sched = ContinuousScheduler(clf, n_slots=PAGED_SLOTS, prefill_chunk=64,
                                prompt_region=PAGED_REGION,
                                max_new_tokens=PAGED_NEW)
    for i, p in enumerate(prompts[:PAGED_SLOTS]):
        req = sched.submit(i, p)
        if reqs is not None:
            reqs.append(req)
    sched._admit()
    while any(s is not None and s.next_chunk >= 0 for s in sched._slots):
        sched._prefill_tick()
    if not all(s is not None and s.active for s in sched._slots):
        fail("llama: a slot ended at its first token; pick other prompts")
    return sched


def _step_inputs(torch, sched):
    import numpy as np

    dev = sched.device
    slots = sched._slots
    arr = lambda xs, dt: torch.as_tensor(np.asarray(xs, dt), device=dev)  # noqa: E731
    return dict(
        table=arr(sched._table, np.int32),
        tokens=arr([s.carry for s in slots], np.int32),
        plens=arr([s.plen for s in slots], np.int32),
        steps=arr([s.steps for s in slots], np.int32),
        budgets=arr([s.budget for s in slots], np.int32),
        done=arr([s.done for s in slots], bool),
        active=arr([True] * len(slots), bool))


def decode_step_logits(torch, clf, sched, kind="paged", ignore_lengths=False):
    """Logits ``[slots, V]`` of one decode step from the scheduler's pool
    state, attention through the paged kernel (``kind="paged"``) or dense
    over the gathered view; ``ignore_lengths`` attends to every row."""
    from music_analyst_tpu_torch.models.layers import KVCache
    from music_analyst_tpu_torch.ops.paged_attention import (
        PagedAttnView,
        _gather,
    )

    plan = sched.plan
    R, total = plan.prompt_region, plan.max_total
    x = _step_inputs(torch, sched)
    offsets = R + x["steps"]
    dev = sched.device
    kv_pos = torch.arange(total, device=dev)[None, None, None, :]
    mask = (kv_pos < x["plens"][:, None, None, None]) | (
        (kv_pos >= R) & (kv_pos - R <= x["steps"][:, None, None, None]))
    if ignore_lengths:
        mask = torch.ones_like(mask)
    pos = (x["plens"] + x["steps"])[:, None]
    views = []
    for c in sched.caches:
        if kind == "dense":
            views.append(KVCache(
                _gather(c.keys, None, x["table"], total, torch.bfloat16).contiguous(),
                _gather(c.values, None, x["table"], total, torch.bfloat16).contiguous(),
                offsets))
        else:
            views.append(PagedAttnView(c.keys, c.values, None, None,
                                       x["table"], offsets, plan.page_size,
                                       total))
    with torch.no_grad():
        logits, _ = clf.model(x["tokens"][:, None], pos, mask, views)
    return logits[:, 0]


def decode_logits_check(torch, clf, sched, limit: bool = True,
                        save: str = None) -> dict:
    """One decode step from the same pool state through the paged kernel
    and through dense attention over the gathered view; a step with the
    slot lengths ignored must break the limit.  ``limit=False`` reports
    the difference only (a model with dynamically quantized activations,
    where a rounding tie can amplify attention's rounding differences).
    ``save`` keeps the paged step's logits (f32, host) in that file."""
    dense = decode_step_logits(torch, clf, sched, "dense")
    paged = decode_step_logits(torch, clf, sched, "paged")
    unmasked = decode_step_logits(torch, clf, sched, "paged",
                                  ignore_lengths=True)
    torch.cuda.synchronize()
    if save:
        torch.save(dict(logits=paged.float().cpu(),
                        tokens=[int(s.carry) for s in sched._slots]), save)
    scale = float(dense.abs().max())
    diff = float((paged - dense).abs().max())
    bad = float((unmasked - dense).abs().max())
    out = dict(max_abs_diff=diff, scale=scale, lengths_ignored=bad,
               argmax_agree=int((paged.argmax(-1) == dense.argmax(-1)).sum()),
               rows=int(dense.shape[0]))
    log(f"llama decode-step logits, paged kernel vs dense: {json.dumps(out)}")
    if not torch.isfinite(paged).all():
        fail("llama paged decode-step logits are not finite")
    if not limit:
        return out
    if diff > LLAMA_LOGIT_REL_TOL * scale:
        fail(f"llama paged vs dense logits differ by {diff} "
             f"(> {LLAMA_LOGIT_REL_TOL} x {scale})")
    if bad <= LLAMA_LOGIT_REL_TOL * scale:
        fail(f"the logit limit passes a step that ignores lengths ({bad})")
    return out


def decode_breakdown(torch, sched) -> dict:
    """One decode dispatch (decode_span steps over 8 active slots) under
    torch.profiler: paged kernel, GEMMs, the rest; and its wall time."""
    from torch.profiler import ProfilerActivity, profile

    x = _step_inputs(torch, sched)
    args = (x["table"], x["tokens"], x["plens"], x["steps"], x["budgets"],
            x["done"], x["active"])
    sched.runtime.decode_step(sched.caches, *args)      # warm
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):       # a profile may see no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched.runtime.decode_step(sched.caches, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_kernel_ms(prof)
        if kernels:
            break
    else:
        log(f"decode breakdown: torch.profiler saw no device event in "
            f"{PROFILE_TRIES} profiles: device time not measured")
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        groups["paged_attention" if "paged_split" in low else
               "gemm" if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass",
                                                "nvjet", "splitk")) else
               "other"] += ms
    busy = sum(kernels.values()) if kernels else None
    out = dict(groups_ms=groups if kernels else None, top_kernels_ms=[
        (name[:96], ms) for name, ms in
        sorted(kernels.items(), key=lambda kv: -kv[1])[:8]])
    out.update(traced_wall_ms=wall * 1e3, device_busy_ms=busy,
               device_idle_share=(None if busy is None else
                                  max(0.0, 1 - busy / (wall * 1e3))),
               steps=sched.plan.decode_span)
    log(f"breakdown of one decode dispatch: {json.dumps(out)}")
    return out


def llama_path(torch, dev, card, serve=None) -> dict:
    """Full-width Llama-3-8B at LLAMA_LAYERS layers (random bf16 weights
    drawn on the card) through
    run_sentiment: generate mode on the continuous paged scheduler (8
    slots, page 16, chunk 64, 16 new tokens, span 4, prefix cache on) and
    score mode; int8 pages; model-level checks."""
    import dataclasses

    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.llama import (
        PROMPT_TEMPLATE,
        LYRICS_TRUNCATION,
        LlamaConfig,
        LlamaZeroShotClassifier,
    )
    from music_analyst_tpu_torch.utils.labels import (
        SUPPORTED_LABELS,
        normalise_label,
    )

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 lm_head stays f32
    report = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=LLAMA_LAYERS)
    clf = LlamaZeroShotClassifier(config=cfg, max_prompt_len=PAGED_REGION,
                                  device=dev, seed=0, decode_mode="generate",
                                  continuous_slots=PAGED_SLOTS)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["weights_bytes"] = sum(p.numel() * p.element_size()
                                  for p in clf.model.parameters())
    log(f"llama3_8b ({cfg.n_layers} layers) random init on the card in "
        f"{report['init_s']:.1f} s, {report['weights_bytes'] / 1e9:.2f} GB of "
        f"weights")
    dataset = os.path.join(WORK, f"songs_{LLAMA_SONGS}.csv")
    generate_dataset(dataset, num_songs=LLAMA_SONGS, seed=13)
    songs = list(iter_songs(dataset))
    prompts = [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
               for _, _, t in songs]

    # Warm-up that doubles as the continuous side of the token comparison
    # (the first LLAMA_COMPARE prompts, to keep the script's time).
    t0 = time.perf_counter()
    continuous = clf.generate_batch_continuous(
        prompts[:LLAMA_COMPARE], max_new_tokens=16, n_slots=PAGED_SLOTS)
    report["warmup_s"] = time.perf_counter() - t0

    out_dir = os.path.join(WORK, "llama_generate")
    runs = []
    for _ in range(LLAMA_REPEATS):
        clf._slot_schedulers.clear()            # each run: empty prefix cache
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = run_sentiment(dataset, backend=clf, output_dir=out_dir,
                               batch_size=LLAMA_SONGS, quiet=True)
        torch.cuda.synchronize()
        launches = kernels.launches()
        (sched,) = clf._slot_schedulers.values()
        stats = sched.stats()
        want = cfg.n_layers * stats["decode_steps"]
        if launches["paged_attention"] != want or want == 0:
            fail(f"llama generate: paged_attention launched "
                 f"{launches['paged_attention']} times, expected {want} "
                 f"({cfg.n_layers} layers x {stats['decode_steps']} steps)")
        labels = [r.label for r in result.rows]
        if (len(labels) != LLAMA_SONGS or sum(result.counts.values()) != LLAMA_SONGS
                or any(label not in SUPPORTED_LABELS for label in labels)):
            fail(f"llama generate: totals {result.counts} over {len(labels)} rows")
        pc = stats["prefix_cache"]
        runs.append(dict(
            songs_per_s=result.songs_per_second, launches=launches,
            totals=result.counts,
            prefill_tokens_per_s=stats["prefill_tokens"] / stats["prefill_seconds"],
            decode_tokens_per_s=stats["tokens_generated"] / stats["decode_seconds"],
            ms_per_decode_step=stats["decode_seconds"] / stats["decode_steps"] * 1e3,
            prefill_dispatches=stats["prefill_dispatches"],
            decode_dispatches=stats["decode_dispatches"],
            decode_steps=stats["decode_steps"],
            tokens_generated=stats["tokens_generated"],
            prefix_hits=pc["hits"], chunks_skipped=pc["chunks_skipped"],
            pages_shared=pc["pages_shared"], cow_copies=pc["cow_copies"],
            evictions=pc["evictions"]))
    rates = [r["songs_per_s"] for r in runs]
    median = runs[int(np.argsort(rates)[len(rates) // 2])]
    report["generate"] = dict(median, songs_per_s_runs=rates,
                              labels=labels)
    log(f"llama generate mode on {card}: median {median['songs_per_s']:.2f} "
        f"songs/s (runs {[round(r, 2) for r in rates]}); {json.dumps(median)}")

    # Continuous-paged vs static greedy text on LLAMA_COMPARE prompts (a
    # static batch's padded width can differ from the continuous region,
    # so this is a report, not a check).
    static = clf.generate_batch(prompts[:LLAMA_COMPARE], max_new_tokens=16)
    same = sum(a == b for a, b in zip(static, continuous))
    report["static_vs_continuous_same_text"] = same
    log(f"llama greedy text, continuous paged == static on {same} of "
        f"{LLAMA_COMPARE} prompts")

    # Score mode, one batch of 16.
    clf.decode_mode = "score"
    t0 = time.perf_counter()
    result = run_sentiment(dataset, backend=clf, limit=LLAMA_SCORE_SONGS,
                           batch_size=LLAMA_SCORE_SONGS, quiet=True,
                           output_dir=os.path.join(WORK, "llama_score"))
    torch.cuda.synchronize()
    if sum(result.counts.values()) != LLAMA_SCORE_SONGS:
        fail(f"llama score: totals {result.counts}")
    report["score"] = dict(songs_per_s=result.songs_per_second,
                           wall_s=time.perf_counter() - t0,
                           totals=result.counts,
                           labels=[r.label for r in result.rows])
    log(f"llama score mode: {json.dumps(report['score'])}")
    # Step 13's tp-1 reference: the label scores of the same 16 songs.
    ids, lens = clf._encode_prompts(
        [t for _, _, t in songs[:LLAMA_SCORE_SONGS]])
    report["score"]["scores"] = clf.score_labels(
        clf._tensor(ids), clf._tensor(lens)).float().cpu().tolist()

    # int8 pages.
    clf._slot_schedulers.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    texts8 = clf.generate_batch_continuous(
        prompts[:LLAMA_INT8_PROMPTS], max_new_tokens=16,
        n_slots=PAGED_SLOTS, kv_quant="int8")
    torch.cuda.synchronize()
    n8 = kernels.launches()["paged_attention"]
    if len(texts8) != LLAMA_INT8_PROMPTS or n8 == 0:
        fail(f"llama int8: {len(texts8)} texts, {n8} paged launches")
    agree = sum(normalise_label(a) == normalise_label(b)
                for a, b in zip(texts8, continuous))
    report["int8"] = dict(wall_s=time.perf_counter() - t0, launches=n8,
                          same_text_as_bf16=sum(
                              a == b for a, b in zip(texts8, continuous)),
                          same_label_as_bf16=agree)
    log(f"llama int8 pages: {json.dumps(report['int8'])}")
    clf._slot_schedulers.clear()

    reqs = []
    sched = _active_scheduler(torch, clf, prompts, reqs)
    report["decode_logits_paged_vs_dense"] = decode_logits_check(
        torch, clf, sched, save=os.path.join(WORK, "llama_tp1_decode_logits.pt"))
    report["decode_breakdown"] = decode_breakdown(torch, sched)
    # The dispatches above rewrite decode rows the scheduler writes again
    # with the same tokens: it runs on to its texts, step 13's tp-1 text.
    sched.run_until_idle()
    report["tp_reference_texts"] = [r.response["text"] for r in reqs]
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"llama peak device memory {report['peak_memory_bytes'] / 1e9:.2f} GB")
    del sched
    torch.cuda.empty_cache()
    if serve is not None:
        # The serve phase reuses this model (no second build).
        clf.decode_mode = "generate"
        report["serve"] = serve(clf, prompts)
    del clf
    # The schedulers' ledgers hold bound methods of their schedulers, a
    # cycle that keeps the model alive until the collector runs.
    gc.collect()
    torch.cuda.empty_cache()
    return report


# ------------------------------------------ quantized inference (slice 7)

# The Llama-3-8B projections at the 8-slot decode shape (M = 8, padded to
# 32 rows inside the int8 product) and one prefill chunk of 64 tokens for
# each of the 8 slots (M = 512).
QUANT_SHAPES = [("q_proj", 8, 4096, 4096), ("gate_proj", 8, 4096, 14336),
                ("down_proj", 8, 14336, 4096), ("lm_head", 8, 4096, 128256),
                ("gate_proj", 512, 4096, 14336)]
# Tolerances, with their reasons.
#  - quantized products against their plain versions (CPU, float64 integer
#    sums, same codes): the int32 accumulations are exact on both sides,
#    so only the f32 epilogue (and, for int4, the sum over groups in
#    another order) differs: 1e-6 of the output's largest magnitude.
QUANT_REL_TOL = 1e-6
#  - quantized DistilBERT against the bf16 flash model on the same weights,
#    with the JAX package's own bounds: logit correlation > 0.99 for every
#    scheme (tests/test_wq_store.py:83-93 holds int4 to that), and for the
#    int8 schemes max |diff| < 0.1 of the bf16 logits' spread
#    (tests/test_quant.py:54-77, a dynamic int8 bound).  The JAX package
#    holds int4 to no such bound: its step (max|w| / 7 per group of 128)
#    is ~18x int8's, and its max |diff| is reported.
DQ_SONGS = 4096              # songs of each quantized DistilBERT run (8,192
                             # before step 10's sweep over ranks, 16,384
                             # before step 13)
QUANT_LOGIT_CORR = 0.99
QUANT_LOGIT_SPREAD = 0.1
#  - one quantized layer (DistilBERT encoder layer 0 on 8 x 128 tokens;
#    Llama decoder layer 0 on 64 tokens): every quantized projection, in
#    f32 on the card and on the CPU from the same codes and the same input
#    (the layer's own activations), within QUANT_REL_TOL.  The whole layer
#    in f32 on both is reported, not limited: the float operations before
#    each product (LayerNorm, softmax, GELU) differ by ulps between the
#    card and the CPU, which moves activation codes at rounding ties.
# Each limit is shown to catch a broken variant in every run: int4 codes
# with their nibbles swapped and one group's scale dropped (products), the
# model with every o_proj zeroed (DistilBERT; the correlation alone does
# not catch it, since a random model's logits vary little from song to
# song), each layer projection with one scale or weight row dropped.
# The int8 generate run was 64 songs; cut to 24 (three waves of 8 slots)
# to fit the serve phases in the script's time, then to 16 to fit step 13,
# then to 10 (int4: 16 to 10) to keep the script well inside its limit,
# then to 9 with the cut to LLAMA_LAYERS layers.
# Each generate run keeps two waves, so slots are refilled under every
# weight scheme (``run`` fails on a run of one wave).
LLAMA_WQ_SONGS = 9         # weight_quant int8, generate mode (two waves)
LLAMA_WQ_INT4_SONGS = 9    # weight_quant int4, generate mode (two waves)
LLAMA_Q_SCORE_SONGS = 8    # weight_quant int8 and dynamic int8, score (16 before)


def _swap_nibbles(torch, q):
    lo = torch.bitwise_and(q, 0x0F)
    hi = torch.bitwise_and(torch.bitwise_right_shift(q, 4), 0x0F)
    return torch.bitwise_or(torch.bitwise_left_shift(lo, 4), hi)


def _rel_err(got, want) -> float:
    return float((got.float().cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def quant_gemm_probe(torch, dev) -> list:
    """The quantized products at the Llama-3-8B decode and prefill shapes:
    device time (torch.profiler, warm and L2-flushed) of ``quant_matmul``
    (dynamic, the weight quantized inside the call) and ``wq_matmul`` int8
    / int4 beside the bf16 cuBLAS product; each card result against its
    plain version on the CPU from the same codes."""
    import dataclasses

    from music_analyst_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for i, (proj, M, K, N) in enumerate(QUANT_SHAPES):
        x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(N, K, device=dev, generator=gen)
             * K ** -0.5).to(torch.bfloat16)                  # [out, in]
        qps = {s: quant.kernel_major(quant.quantize_array(w.t(), s))
               for s in ("int8", "int4")}
        fns = {
            "bf16": lambda: x @ w.t(),
            "dynamic": lambda: quant.quant_matmul(x, w.t()),
            "int8": lambda: quant.wq_matmul(x, qps["int8"]),
            "int4": lambda: quant.wq_matmul(x, qps["int4"]),
        }
        xc = x.cpu()
        plains = {
            "dynamic": lambda: quant.quant_matmul(xc, w.cpu().t()),
            "int8": lambda: quant.wq_matmul(xc, qps["int8"].to("cpu")),
            "int4": lambda: quant.wq_matmul(xc, qps["int4"].to("cpu")),
        }
        G = K // qps["int4"].group_size
        weight_bytes = {"bf16": 2 * K * N, "dynamic": 2 * K * N,
                        "int8": K * N + 4 * N, "int4": K * N // 2 + 4 * G * N}
        iters = 3 if proj == "lm_head" or M > 8 else 10
        entry = dict(proj=proj, M=M, K=K, N=N, groups=G)
        for name, fn in fns.items():
            out = fn()
            torch.cuda.synchronize()
            res = dict(ms=profiled_ms(torch, fn, iters, flush=True),
                       ms_warm=profiled_ms(torch, fn, iters), timed_by="profiler")
            if not (res["ms"] and res["ms_warm"]):
                # The profiler has been seen to record no kernel for the
                # lm_head product: CUDA events around back-to-back calls.
                res.update(ms=time_ms(torch, fn, iters),
                           ms_warm=time_ms(torch, fn, iters), timed_by="events")
            moved = weight_bytes[name] + 2 * M * K + out.element_size() * M * N
            res["bound_ms"], res["bound_by"] = bound(
                moved, 2 * M * K * N,
                PEAK_BF16_FLOPS if name == "bf16" else PEAK_INT8_OPS)
            if name != "bf16":
                want = plains[name]()
                err = _rel_err(out, want)
                res["rel_err"] = err
                if not torch.isfinite(out).all() or err > QUANT_REL_TOL:
                    fail(f"quantized {name} {proj} M={M}: card vs plain "
                         f"{err} of the scale (limit {QUANT_REL_TOL})")
                if name == "int4" and i == 0:
                    qp = qps["int4"]
                    swapped = dataclasses.replace(
                        qp, q=_swap_nibbles(torch, qp.q))
                    scale = qp.scale.clone()
                    scale[0] = 0
                    dropped = dataclasses.replace(qp, scale=scale)
                    res["broken"] = {
                        "swapped_nibbles": _rel_err(
                            quant.wq_matmul(x, swapped), want),
                        "group_scale_dropped": _rel_err(
                            quant.wq_matmul(x, dropped), want)}
                    if min(res["broken"].values()) <= QUANT_REL_TOL:
                        fail(f"the product limit passes a broken int4 "
                             f"variant: {res['broken']}")
            entry[name] = res
        rows.append(entry)
        log(f"quantized products {proj} M={M}: " + json.dumps(
            {k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
                 for kk, vv in v.items()} if isinstance(v, dict) else v
             for k, v in entry.items()}))
        del x, w, qps, fns, out
        torch.cuda.empty_cache()
    return rows


def _zero_o_proj(torch, model):
    """Zero every layer's attention output projection in place; returns
    the function that restores it."""
    saved = []
    for layer in model.encoder.layers:
        proj = layer.attention.o_proj
        t = proj.scale if getattr(proj, "q", None) is not None else proj.weight
        saved.append((t, t.detach().clone()))
        with torch.no_grad():
            t.zero_()

    def restore():
        with torch.no_grad():
            for t, value in saved:
                t.copy_(value)

    return restore


def _f32_projection(torch, mod, where):
    """An f32-output copy of a quantized projection on ``where``, holding
    the same codes (or, for the dynamic path, the same weights)."""
    from music_analyst_tpu_torch.models.layers import QuantLinear, WqLinear
    from music_analyst_tpu_torch.ops.quant import WQ_DEFAULT_GROUP

    bias = mod.bias is not None
    if isinstance(mod, WqLinear):
        copy = WqLinear(mod.in_features, mod.out_features, mod.scheme,
                        bias=bias, dtype=torch.float32,
                        kernel_shape=mod.kernel_shape,
                        n_contract=mod.n_contract,
                        group_size=mod.group_size or WQ_DEFAULT_GROUP,
                        device=where)
    else:
        copy = QuantLinear(mod.in_features, mod.out_features, bias=bias,
                           dtype=torch.float32, device=where)
    copy.load_state_dict(mod.state_dict())
    return copy.eval()


def _break_projection(torch, mod) -> None:
    """Drop one group's scale (int4), one output channel's scale (int8),
    or one output channel's weights (dynamic)."""
    with torch.no_grad():
        if getattr(mod, "q", None) is None:
            mod.weight[0].zero_()
        elif mod.scheme == "int4":
            mod.scale[0].zero_()
        else:
            mod.scale.view(-1)[0] = 0


def quantized_layer_check(torch, dev, layer, run) -> dict:
    """One quantized layer on the card: ``run(layer)`` drives it on the
    card, and every quantized projection's input is recorded; each
    projection, in f32 on the card and on the CPU from the same codes,
    must give the same output on that input (the int32 sums are exact:
    QUANT_REL_TOL), and the card copy with one scale (or weight row)
    dropped must not.  The whole layer is then run in f32 on the card and
    on the CPU and their difference reported: activation codes flip at
    rounding ties when the float operations before a product differ by an
    ulp, so that difference is a measurement, not a limit."""
    import dataclasses

    from music_analyst_tpu_torch.models.layers import QuantLinear, WqLinear

    mods = {n: m for n, m in layer.named_modules()
            if isinstance(m, (QuantLinear, WqLinear))}
    caps = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: caps.append((n, args[0].detach())))
        for n, m in mods.items()]
    try:
        with torch.inference_mode():
            run(layer)
    finally:
        for h in hooks:
            h.remove()
    worst, least_broken = 0.0, float("inf")
    for name, x in caps:
        card = _f32_projection(torch, mods[name], dev)
        cpu = _f32_projection(torch, mods[name], "cpu")
        with torch.inference_mode():
            want = cpu(x.cpu())
            err = _rel_err(card(x), want)
            _break_projection(torch, card)
            bad = _rel_err(card(x), want)
        worst, least_broken = max(worst, err), min(least_broken, bad)
        if err > QUANT_REL_TOL:
            fail(f"quantized projection {name}: card vs CPU {err} of the "
                 f"scale (limit {QUANT_REL_TOL})")
    if least_broken <= QUANT_REL_TOL:
        fail(f"the projection limit passes a dropped scale ({least_broken})")
    return dict(projections=len(caps), max_rel_err=worst,
                min_broken_rel_err=least_broken)


def _whole_layer_f32(torch, dev, layer, make, run) -> dict:
    """``layer`` rebuilt in f32 (``make(cfg)``) on the card and on the
    CPU from the same state; ``run(layer, where)`` returns its output."""
    state = {k: v.detach().cpu() for k, v in layer.state_dict().items()}
    outs = {}
    for where in ("cpu", dev):
        copy = make()
        copy.load_state_dict(state)
        with torch.inference_mode():
            outs[str(where)] = run(copy.to(where).eval(), where).cpu()
    want = outs["cpu"]
    return dict(max_abs_diff=float((outs[str(dev)] - want).abs().max()),
                scale=float(want.abs().max()))


def distilbert_layer_check(torch, dev, clf, tlen) -> dict:
    """Encoder layer 0 of the quantized DistilBERT on 8 x 128 tokens of
    random activations with the first songs' lengths."""
    import dataclasses

    from music_analyst_tpu_torch.models.distilbert import TransformerBlock

    gen = torch.Generator().manual_seed(22)
    x = torch.randn(8, clf.max_len, clf.config.dim, generator=gen)
    lens = tlen[:8].to(torch.int32)
    layer = clf.model.encoder.layers[0]
    out = quantized_layer_check(
        torch, dev, layer,
        lambda l: l(x.to(dev, clf.config.torch_dtype), None, lens))
    cfg32 = dataclasses.replace(clf.config, dtype="float32")
    out["whole_layer_f32"] = _whole_layer_f32(
        torch, dev, layer, lambda: TransformerBlock(cfg32),
        lambda l, where: l(x.to(where), None, lens.to(where)))
    return out


def distilbert_quant_path(torch, dev, dataset, card) -> dict:
    """Full DistilBERT, flash attention: ``-int8`` (dynamic) and
    ``weight_quant`` int8 / int4, each through ``run_sentiment`` once on
    the first DQ_SONGS songs of the corpus, against the bf16 model on the
    same weights (seed 0) on the first batch of 8,192; encoder layer 0
    against its plain version on the CPU."""
    import dataclasses

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
    )
    from music_analyst_tpu_torch.ops import quant
    from music_analyst_tpu_torch.runtime.wire import to_device

    texts = [t for _, _, t in iter_songs(dataset, limit=BATCH)]
    cfg = DistilBertConfig(attn_impl="flash")
    ref = DistilBertClassifier(config=cfg, seed=0, device=dev)
    ids, lens = ref.tokenizer.encode_batch(texts, ref.max_len)
    tid, tlen = to_device([ids, lens], dev)
    want = ref.forward_logits(tid, tlen).float()
    spread = float(want.max() - want.min())
    report = dict(bf16_stored_bytes=quant.param_tree_bytes(ref.model)[
        "stored_bytes"], bf16_logit_spread=spread)
    del ref
    torch.cuda.empty_cache()

    def compare(logits):
        a, b = logits.float().flatten(), want.flatten()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        return corr, float((a - b).abs().max())

    for name, field in (("int8_dynamic", dict(quant="int8")),
                        ("wq_int8", dict(weight_quant="int8")),
                        ("wq_int4", dict(weight_quant="int4"))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clf = DistilBertClassifier(config=dataclasses.replace(cfg, **field),
                                   seed=0, device=dev)
        torch.cuda.synchronize()
        entry = dict(init_s=time.perf_counter() - t0,
                     bytes=quant.param_tree_bytes(clf.model))
        logits = clf.forward_logits(tid, tlen)
        corr, diff = compare(logits)
        restore = _zero_o_proj(torch, clf.model)
        bad_corr, bad_diff = compare(clf.forward_logits(tid, tlen))
        restore()
        diff_limit = QUANT_LOGIT_SPREAD * spread if name != "wq_int4" else None
        entry.update(logit_corr=corr, max_abs_diff=diff, spread=spread,
                     max_abs_diff_limit=diff_limit, broken_corr=bad_corr,
                     broken_max_abs_diff=bad_diff)
        if (not torch.isfinite(logits).all() or corr <= QUANT_LOGIT_CORR
                or (diff_limit is not None and diff >= diff_limit)):
            fail(f"distilbert {name}: logits vs bf16 corr {corr}, max |diff| "
                 f"{diff} (spread {spread})")
        if diff_limit is not None and bad_diff < diff_limit:
            fail(f"distilbert {name}: the logit limits pass a model without "
                 f"attention outputs (corr {bad_corr}, diff {bad_diff})")
        entry["layer_check"] = distilbert_layer_check(torch, dev, clf, tlen)
        torch.cuda.synchronize()
        kernels.reset_launches()
        quant.reset_quant_calls()
        result = run_sentiment(dataset, backend=clf, batch_size=BATCH,
                               quiet=True, limit=DQ_SONGS,
                               output_dir=os.path.join(WORK, f"distilbert_{name}"))
        torch.cuda.synchronize()
        launches, calls = kernels.launches(), quant.quant_calls()
        if launches["flash_attention"] == 0 or calls["int_mm"] == 0:
            fail(f"distilbert {name}: launches {launches}, products {calls}")
        if sum(result.counts.values()) != DQ_SONGS:
            fail(f"distilbert {name}: totals {result.counts}")
        entry.update(songs_per_s=result.songs_per_second, launches=launches,
                     int_mm_calls=calls["int_mm"], totals=result.counts,
                     peak_memory_bytes=torch.cuda.max_memory_allocated())
        report[name] = entry
        log(f"distilbert {name} on {card}: {result.songs_per_second:.1f} "
            f"songs/s; {json.dumps(entry)}")
        del clf, logits
        torch.cuda.empty_cache()
    return report


def llama_layer_check(torch, dev, clf) -> dict:
    """Decoder layer 0 of the quantized Llama on 64 tokens of random
    activations (causal mask)."""
    import dataclasses

    from music_analyst_tpu_torch.models.layers import causal_mask
    from music_analyst_tpu_torch.models.llama import LlamaBlock

    gen = torch.Generator().manual_seed(21)
    x = torch.randn(1, 64, clf.config.dim, generator=gen)
    pos = torch.arange(64)[None, :]
    mask = causal_mask(64, 64, 0)
    layer = clf.model.layers[0]
    out = quantized_layer_check(
        torch, dev, layer,
        lambda l: l(x.to(dev, clf.config.torch_dtype), mask.to(dev),
                    pos.to(dev)))
    cfg32 = dataclasses.replace(clf.config, dtype="float32")
    out["whole_layer_f32"] = _whole_layer_f32(
        torch, dev, layer, lambda: LlamaBlock(cfg32),
        lambda l, where: l(x.to(where), mask.to(where), pos.to(where))[0])
    return out


def llama_quant_path(torch, dev, card) -> dict:
    """Full-width Llama-3-8B with random weights drawn on the card and
    quantized kernel by kernel, each weight scheme built at all 32 layers
    for its init memory and then run at LLAMA_LAYERS: weight_quant int8
    (generate, 9 songs on 8 continuous slots; score, 8), weight_quant
    int4 (generate, 9) and dynamic int8 (score, 8), each through
    ``run_sentiment`` once."""
    import dataclasses

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.llama import (
        LYRICS_TRUNCATION,
        PROMPT_TEMPLATE,
        LlamaConfig,
        LlamaZeroShotClassifier,
    )
    from music_analyst_tpu_torch.ops import quant
    from music_analyst_tpu_torch.utils.labels import SUPPORTED_LABELS

    torch.backends.cuda.matmul.allow_tf32 = False
    dataset = os.path.join(WORK, f"songs_{LLAMA_SONGS}.csv")
    if not os.path.exists(dataset):
        generate_dataset(dataset, num_songs=LLAMA_SONGS, seed=13)
    prompts = [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
               for _, _, t in iter_songs(dataset)]
    full = LlamaConfig.llama3_8b()
    bf16_bytes = 2 * (2 * full.vocab_size * full.dim + full.n_layers * (
        2 * full.dim * full.dim + 2 * full.dim * full.head_dim
        * full.n_kv_heads + 3 * full.dim * full.hidden_dim))
    report = dict(bf16_weight_bytes=bf16_bytes, layers=LLAMA_LAYERS)

    def build(n_layers=LLAMA_LAYERS, **field):
        gc.collect()              # a scheduler and its model form a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clf = LlamaZeroShotClassifier(
            config=dataclasses.replace(full, n_layers=n_layers, **field),
            max_prompt_len=PAGED_REGION, device=dev, seed=0,
            decode_mode="generate", continuous_slots=PAGED_SLOTS)
        torch.cuda.synchronize()
        info = dict(init_s=time.perf_counter() - t0,
                    init_peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    bytes=quant.param_tree_bytes(clf.model))
        return clf, info

    def run(clf, mode, n, tag):
        clf.decode_mode = mode
        clf._slot_schedulers.clear()
        torch.cuda.synchronize()
        kernels.reset_launches()
        quant.reset_quant_calls()
        result = run_sentiment(dataset, backend=clf, limit=n, batch_size=n,
                               quiet=True,
                               output_dir=os.path.join(WORK, f"llama_{tag}"))
        torch.cuda.synchronize()
        launches, calls = kernels.launches(), quant.quant_calls()
        labels = [r.label for r in result.rows]
        if (len(labels) != n or sum(result.counts.values()) != n
                or any(label not in SUPPORTED_LABELS for label in labels)):
            fail(f"llama {tag}: totals {result.counts} over {len(labels)} rows")
        if calls["int_mm"] == 0:
            fail(f"llama {tag}: no quantized product ran")
        out = dict(songs_per_s=result.songs_per_second, launches=launches,
                   int_mm_calls=calls["int_mm"], totals=result.counts)
        if mode == "generate":
            (sched,) = clf._slot_schedulers.values()
            stats = sched.stats()
            if n <= stats["n_slots"]:
                fail(f"llama {tag}: {n} songs on {stats['n_slots']} slots "
                     "is one wave; no slot is refilled")
            want = clf.config.n_layers * stats["decode_steps"]
            if launches["paged_attention"] != want or want == 0:
                fail(f"llama {tag}: paged_attention launched "
                     f"{launches['paged_attention']} times, expected {want}")
            out.update(
                prefill_tokens_per_s=stats["prefill_tokens"]
                / stats["prefill_seconds"],
                decode_tokens_per_s=stats["tokens_generated"]
                / stats["decode_seconds"],
                ms_per_decode_step=stats["decode_seconds"]
                / stats["decode_steps"] * 1e3,
                decode_steps=stats["decode_steps"],
                tokens_generated=stats["tokens_generated"])
        log(f"llama {tag} on {card}: {json.dumps(out)}")
        return out

    def full_depth(**field):
        """The stored bytes and init memory of all 32 layers."""
        return build(full.n_layers, **field)[1]

    report["wq_int8"] = full_depth(weight_quant="int8")
    clf, info = build(weight_quant="int8")
    report["wq_int8"].update(run_init=info,
                             layer_check=llama_layer_check(torch, dev, clf))
    report["wq_int8"]["generate"] = run(clf, "generate", LLAMA_WQ_SONGS,
                                        "wq_int8_generate")
    report["wq_int8"]["score"] = run(clf, "score", LLAMA_Q_SCORE_SONGS,
                                     "wq_int8_score")
    clf._slot_schedulers.clear()
    sched = _active_scheduler(torch, clf, prompts)
    report["wq_int8"]["decode_logits_paged_vs_dense"] = decode_logits_check(
        torch, clf, sched, limit=False)
    report["wq_int8"]["decode_breakdown"] = decode_breakdown(torch, sched)
    report["wq_int8"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del sched, clf
    report["wq_int4"] = full_depth(weight_quant="int4")
    clf, info = build(weight_quant="int4")
    report["wq_int4"].update(run_init=info,
                             layer_check=llama_layer_check(torch, dev, clf))
    report["wq_int4"]["generate"] = run(clf, "generate", LLAMA_WQ_INT4_SONGS,
                                        "wq_int4_generate")
    clf._slot_schedulers.clear()
    sched = _active_scheduler(torch, clf, prompts)
    report["wq_int4"]["decode_breakdown"] = decode_breakdown(torch, sched)
    report["wq_int4"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del sched, clf
    clf, info = build(quant="int8")
    report["int8_dynamic"] = dict(info,
                                  layer_check=llama_layer_check(torch, dev, clf))
    report["int8_dynamic"]["score"] = run(clf, "score", LLAMA_Q_SCORE_SONGS,
                                          "int8_dynamic_score")
    report["int8_dynamic"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del clf
    torch.cuda.empty_cache()
    for name in ("wq_int8", "wq_int4"):
        peak = report[name]["init_peak_memory_bytes"]
        if peak >= bf16_bytes:
            fail(f"llama {name}: init peaked at {peak} bytes, no less than the "
                 f"bf16 weights ({bf16_bytes})")
    log(f"llama quantized: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk in (
            "init_s", "init_peak_memory_bytes", "peak_memory_bytes",
            "layer_check")} for k, v in report.items() if isinstance(v, dict)}))
    return report


PERSONG_SONGS = 4096   # 16,384 until step 10's sweep over ranks


def persong_path(card) -> dict:
    """``wordcount-per-song`` as one process on a CSV of PERSONG_SONGS
    songs; the two files must agree with each other and with the CSV."""
    import csv

    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.data.tokenizer import tokenize_latin1

    dataset = os.path.join(WORK, f"persong_{PERSONG_SONGS}.csv")
    generate_dataset(dataset, num_songs=PERSONG_SONGS, seed=11)
    out_dir = os.path.join(WORK, "persong")
    t0 = time.perf_counter()
    # csv.Sniffer takes this corpus's spaces for the delimiter (in both
    # packages), so the delimiter is given, as a user of the tool would.
    proc = subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", "wordcount-per-song",
         dataset, "--output-dir", out_dir, "--delimiter", ","],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"wordcount-per-song rc {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "word_counts_global.csv"), newline="",
              encoding="utf-8") as fh:
        ranked = [(w, int(c)) for w, c in list(csv.reader(fh))[1:]]
    per_song_total, keyed = 0, set()
    with open(os.path.join(out_dir, "word_counts_by_song.csv"), newline="",
              encoding="utf-8") as fh:
        for artist, song, _, count in list(csv.reader(fh))[1:]:
            per_song_total += int(count)
            keyed.add((artist, song))
    rows = with_tokens = 0
    with open(dataset, newline="", encoding="utf-8-sig") as fh:
        for row in csv.DictReader(fh):
            rows += 1
            if next(iter(tokenize_latin1(row.get("text") or "")), None):
                with_tokens += 1
    counts = [c for _, c in ranked]
    out = dict(songs=rows, process_wall_s=wall, songs_per_s=rows / wall,
               words=len(ranked), tokens=sum(counts),
               songs_with_tokens=with_tokens)
    if (sum(counts) != per_song_total or counts != sorted(counts, reverse=True)
            or len(keyed) != with_tokens
            or f"Processed {rows} row(s)" not in proc.stdout):
        fail(f"wordcount-per-song: inconsistent outputs {json.dumps(out)} "
             f"(per-song total {per_song_total}, keyed songs {len(keyed)})")
    log(f"wordcount-per-song on {card}: {json.dumps(out)}")
    return out


# ----------------------------------------------------- serve (slice 8)

SERVE_MOCK_REQUESTS = 2048
SERVE_DISTILBERT_REQUESTS = 4096
SERVE_MAX_BATCH = 256
SERVE_PROMPTS = 12        # generate requests per Llama serve variant (16
                          # before step 10's sweep over ranks): 8 fill the
                          # slots, then 4 more
SERVE_K = 4               # draft tokens per slot in the speculative variant
#  - DistilBERT through the server vs the batch engine, same weights: the
#    server pads its pow2 batches to another width and mixes other songs
#    into each batch, so bf16 logits move by rounding; a label may differ
#    only where the batch engine's top-two logit gap is within 1e-2 of the
#    logit scale (max |logit|) of a decision boundary: 0 (the argmax) or
#    the gap at which the confidence meets the neutral threshold.
SERVE_FLIP_REL = 1e-2


def _quantiles(hist: dict) -> dict:
    return {f"{q}_ms": (None if hist.get(f"{q}_s") is None
                        else hist[f"{q}_s"] * 1e3) for q in ("p50", "p99")}


def _lines(texts, op="sentiment", prefix=""):
    return [json.dumps({"id": f"{prefix}{i}", "op": op, "text": t})
            for i, t in enumerate(texts)]


def _stream(server, lines):
    """One in-process NDJSON session through ``handle_stream``; ``lines``
    may be any iterable (a generator can hold lines back)."""
    import io

    out = io.StringIO()
    server.handle_stream((line + "\n" for line in lines), out,
                         drain_on_eof=True)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _no_serve_threads(tag: str) -> None:
    """A drained server leaves no worker thread behind: one that polls on
    would take the interpreter from every later phase's host work."""
    names = ("-batcher", "decode-loop", "serve-reader", "serve-conn-")
    alive = [t.name for t in threading.enumerate()
             if any(n in t.name for n in names)]
    if alive:
        fail(f"{tag}: serve threads still running after the drain: {alive}")


def _wordcount_contract(text: str) -> dict:
    import collections

    from music_analyst_tpu_torch.data.tokenizer import tokenize_latin1

    counts = collections.Counter(tokenize_latin1(text))
    return {"counts": dict(sorted(counts.items(),
                                  key=lambda kv: (-kv[1], kv[0]))),
            "total_words": int(sum(counts.values()))}


def serve_mock_path(torch, dev, card) -> dict:
    """(a) ``serve --stdio --mock`` as a process: 2,048 classify requests,
    wordcount requests and a malformed line, then ``stats`` once every
    reply is in, then ``shutdown``; labels must equal the reference
    heuristic, word counts the tokenizer contract, and the process must
    exit 0 after its drain.  The process prints the kernel launches of the
    session on stderr as it exits; the keyword scan must have launched."""
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.synthetic import generate_dataset

    dataset = os.path.join(WORK, f"serve_{SERVE_MOCK_REQUESTS}.csv")
    generate_dataset(dataset, num_songs=SERVE_MOCK_REQUESTS, seed=19)
    texts = [t for _, _, t in iter_songs(dataset)]
    words = texts[:8]
    lines = (_lines(texts) + _lines(words, "wordcount", "w")
             + ["{not json"])
    n = len(lines)
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--mock", "--no-response-cache", "--max-queue", str(n + 16)],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    stderr = []
    reader = threading.Thread(target=lambda: stderr.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        # Wait for the ready line so the rate excludes start-up and warmup.
        t_wait = time.perf_counter() + 300
        while not any("ready" in s for s in stderr):
            if proc.poll() is not None or time.perf_counter() > t_wait:
                fail(f"serve --mock did not start: {''.join(stderr)[-2000:]}")
            time.sleep(0.05)
        t0 = time.perf_counter()
        writer = threading.Thread(
            target=lambda: (proc.stdin.write("".join(l + "\n" for l in lines)),
                            proc.stdin.flush()), daemon=True)
        writer.start()
        replies = [json.loads(proc.stdout.readline()) for _ in range(n)]
        wall = time.perf_counter() - t0
        writer.join()
        proc.stdin.write(json.dumps({"id": "s", "op": "stats"}) + "\n")
        proc.stdin.flush()
        stats = json.loads(proc.stdout.readline())
        proc.stdin.write(json.dumps({"id": "z", "op": "shutdown"}) + "\n")
        proc.stdin.flush()
        bye = json.loads(proc.stdout.readline())
        proc.stdin.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    if rc != 0 or not bye.get("draining"):
        fail(f"serve --mock exited {rc} after shutdown {bye}: "
             f"{''.join(stderr)[-2000:]}")
    want = [reference_mock_label(t) for t in texts]
    got = [r.get("label") for r in replies[:len(texts)]]
    if got != want or not all(r["ok"] for r in replies[:len(texts)]):
        bad = sum(a != b for a, b in zip(got, want))
        fail(f"serve --mock: {bad} labels differ from the reference heuristic")
    for r, text in zip(replies[len(texts):len(texts) + len(words)], words):
        if {k: r.get(k) for k in ("counts", "total_words")} != \
                _wordcount_contract(text):
            fail(f"serve --mock: wordcount reply {r['id']} breaks the contract")
    if replies[-1].get("error", {}).get("kind") != "bad_request":
        fail(f"serve --mock: malformed line answered {replies[-1]}")
    req = stats["stats"]["requests"]
    if req["completed"] != len(texts) + len(words):
        fail(f"serve --mock: stats count {req['completed']} completions")
    out = dict(requests=n, requests_per_s=len(texts) / wall, wall_s=wall,
               latency=_quantiles(req["latency"]), batches=req["batches"],
               occupancy=req["occupancy"], exit_code=rc)
    # For the router phase: every fleet reply must equal this run's.
    out["replies"] = replies

    # The process's own count of the session's launches (warmup excluded).
    prefix = "serve: kernel launches since ready "
    line = [s for s in stderr if s.startswith(prefix)]
    if not line:
        fail(f"serve --mock: no launch count on stderr: "
             f"{''.join(stderr)[-2000:]}")
    out["launches"] = json.loads(line[-1][len(prefix):])
    if out["launches"]["keyword_scan"] == 0:
        fail(f"serve --mock: the keyword scan never launched {out['launches']}")
    log(f"serve --mock (process) on {card}: "
        f"{json.dumps({k: v for k, v in out.items() if k != 'replies'})}")
    return out


def serve_distilbert_path(torch, dev, clf, dataset, texts, card) -> dict:
    """(b) Full DistilBERT through ``SentimentServer.handle_stream``: 4,096
    classify requests at max_batch 256 under ``torch.profiler``; the flash
    kernel must launch.

    Random weights give every song one label, so the neutral threshold is
    set to the median confidence of the plain reference (``forward_logits``
    on the same texts, one flat batch) and the labels split between two
    classes.  A forward hook on the model records the logits of every row
    it ran, in the batch engine (``run_sentiment`` at the same threshold)
    and in the server.  Each request id's row must be among each path's,
    and hold the reference's logits within LOGIT_REL_TOL of the scale (the
    server's rows shifted by one request must break that limit).  Each
    path's labels must follow the label rule from its own logits, and the
    server's labels may differ from the batch engine's only where the
    batch engine's top-two logit gap lies within SERVE_FLIP_REL of the
    scale of a decision boundary (0 for the argmax, the threshold's gap
    for Neutral)."""
    import math

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.runtime.wire import to_device
    from music_analyst_tpu_torch.serving.batcher import DynamicBatcher
    from music_analyst_tpu_torch.serving.residency import ModelResidency
    from music_analyst_tpu_torch.serving.server import (
        SentimentServer,
        build_resident_ops,
    )

    n = SERVE_DISTILBERT_REQUESTS
    texts = texts[:n]
    ids, lens = clf.tokenizer.encode_batch(texts, clf.max_len)
    ids, lens = np.asarray(ids, np.int64), np.asarray(lens)
    keys = [ids[i, :lens[i]].tobytes() for i in range(n)]
    ref = clf.forward_logits(*to_device([ids, lens], dev)).float().cpu()
    if ref.shape[1] != 2:
        fail(f"serve distilbert: the label rule below is for two classes, "
             f"the head has {ref.shape[1]}")
    scale = max(1.0, float(ref.abs().max()))
    threshold = float(torch.softmax(ref, dim=-1).amax(dim=-1).median())
    # Two classes: confidence < threshold  <=>  top-two gap < boundary.
    boundary = math.log(threshold / (1.0 - threshold))
    empty = [not t.strip() for t in texts]

    def gaps(logits):
        top2 = logits.topk(2, dim=-1).values
        return top2[:, 0] - top2[:, 1]

    def rule(logits) -> list:
        return ["Neutral" if e or float(g) < boundary
                else clf._CLASS_LABELS[int(k)]
                for e, g, k in zip(empty, gaps(logits),
                                   logits.argmax(dim=-1))]

    def recorded_by_id(store, what):
        rows = {}
        for row_ids, row_lens, logits in store:
            row_ids, row_lens = row_ids.cpu().numpy(), row_lens.cpu().numpy()
            logits = logits.cpu()
            for r in range(row_ids.shape[0]):
                rows[row_ids[r, :row_lens[r]].astype(np.int64).tobytes()] = \
                    logits[r]
        missing = [i for i in range(n) if keys[i] not in rows]
        if missing:
            fail(f"serve distilbert: {len(missing)} requests ran through no "
                 f"forward of the {what} (first id {missing[0]})")
        return torch.stack([rows[k] for k in keys])

    def record(store):
        return clf.model.register_forward_hook(
            lambda module, inputs, output: store.append(
                (inputs[0].clone(), inputs[1].clone(), output.float().clone())))

    default_threshold = clf.neutral_threshold
    clf.neutral_threshold = threshold
    batch_store, serve_store = [], []
    try:
        hook = record(batch_store)
        try:
            batch = run_sentiment(dataset, backend=clf, limit=n, batch_size=n,
                                  quiet=True,
                                  output_dir=os.path.join(WORK, "serve_batch"))
        finally:
            hook.remove()
        batch_labels = [r.label for r in batch.rows]
        residency = ModelResidency(model="distilbert", backend=clf, device=dev)
        warm = residency.warmup(SERVE_MAX_BATCH)
        # A profile with no device event at all is taken again, the whole
        # stream through a fresh batcher and server (the drain stops them).
        for attempt in range(1, PROFILE_TRIES + 1):
            serve_store.clear()
            batcher = DynamicBatcher(
                build_resident_ops(residency), max_batch=SERVE_MAX_BATCH,
                max_queue=n + 1, device=dev,
                failover=lambda exc: residency.reload() is not None).start()
            server = SentimentServer(batcher, residency, mode="stdio")
            hook = record(serve_store)
            try:
                kernels.reset_launches()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    replies = _stream(server, _lines(texts))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                launches = kernels.launches()
            finally:
                hook.remove()
            _no_serve_threads("serve distilbert")
            if device_kernel_ms(prof):
                break
            log(f"serve distilbert: profile {attempt} of the stream holds "
                f"no device event" + ("; streaming again"
                                      if attempt < PROFILE_TRIES else ""))
    finally:
        clf.neutral_threshold = default_threshold
    flash_events = sum(e.count for e in prof.key_averages()
                       if "flash_wgmma_kernel" in e.key)
    if launches["flash_attention"] == 0 or flash_events == 0:
        fail(f"serve distilbert: flash launches {launches}, "
             f"profiled flash_wgmma_kernel launches {flash_events}")
    if ([r.get("id") for r in replies] != [str(i) for i in range(n)]
            or not all(r["ok"] for r in replies)):
        fail("serve distilbert: a request failed or replies are out of order")
    if len(batch_labels) != n or len(set(batch_labels)) < 2:
        fail(f"serve distilbert: the batch engine gave {len(batch_labels)} "
             f"labels of {sorted(set(batch_labels))} at threshold "
             f"{threshold:.6g}: a swapped reply could not show")

    batch_logits = recorded_by_id(batch_store, "batch engine")
    served = recorded_by_id(serve_store, "server")
    diff = float((served - ref).abs().max())
    batch_diff = float((batch_logits - ref).abs().max())
    shifted = float((served.roll(1, dims=0) - ref).abs().max())
    if (not torch.isfinite(served).all()
            or max(diff, batch_diff) > LOGIT_REL_TOL * scale):
        fail(f"serve distilbert: logits differ from the reference by {diff} "
             f"(server) and {batch_diff} (batch engine); the limit is "
             f"{LOGIT_REL_TOL} x {scale}")
    if shifted <= LOGIT_REL_TOL * scale:
        fail(f"serve distilbert: logits of neighbouring requests pass the "
             f"limit ({shifted} <= {LOGIT_REL_TOL} x {scale})")
    labels = [r["label"] for r in replies]
    # Softmax on the card and the gap here round differently right at the
    # boundary: rows within 1e-4 of it may go either way.
    for what, got, logits in (("server", labels, served),
                              ("batch engine", batch_labels, batch_logits)):
        g = gaps(logits)
        off = [i for i, (a, b) in enumerate(zip(got, rule(logits)))
               if a != b and abs(float(g[i]) - boundary) > 1e-4]
        if off:
            fail(f"serve distilbert: {len(off)} {what} labels are not the "
                 f"label of their own logits (first id {off[0]})")
    g = gaps(batch_logits)
    near = torch.minimum(g, (g - boundary).abs()) < SERVE_FLIP_REL * scale
    differ = [i for i, (a, b) in enumerate(zip(labels, batch_labels))
              if a != b]
    far = [i for i in differ if not bool(near[i])]
    if far:
        fail(f"serve distilbert: {len(far)} labels differ from the batch "
             f"engine away from a near-tie (first id {far[0]})")
    stats = batcher.stats()
    counts = {label: labels.count(label) for label in sorted(set(labels))}
    out = dict(requests=n, requests_per_s=n / wall, wall_s=wall,
               latency=_quantiles(stats["latency"]),
               batches=stats["batches"], occupancy=stats["occupancy"],
               launches=launches, flash_wgmma_kernel_events=flash_events,
               threshold=threshold, label_counts=counts,
               logits_vs_reference=dict(
                   server_max_abs_diff=diff, batch_max_abs_diff=batch_diff,
                   scale=scale, server_shifted_by_one=shifted),
               labels_differing=dict(differ=len(differ),
                                     near_ties=int(near.sum())),
               warmup=warm, profile_attempts=attempt)
    log(f"serve distilbert on {card}: {json.dumps(out)}")
    return out


def _profile_dispatches(torch, sched, count: int = 4) -> list:
    """Wrap the scheduler's decode dispatch (its verify dispatch when it
    speculates) so that up to ``count`` of the served run's dispatches,
    each with its upload, readback and settling, run under
    ``torch.profiler``: the first, then each one with more active slots
    than any profiled before.  Returns the list the wrapper fills:
    ``(profile, wall_s, active slots)``, or the repr of a profiler
    failure.  The profiled dispatches stay in the run's own stats."""
    from torch.profiler import ProfilerActivity, profile

    taken = []
    name = "_verify_tick" if sched.speculate_k else "_plain_decode_tick"
    inner = getattr(sched, name)

    def profiled(occupied, *rest):
        most = max((t[2] for t in taken if isinstance(t, tuple)), default=0)
        if len(taken) >= count or len(occupied) <= most:
            return inner(occupied, *rest)
        # The profiler runs on the decode thread: a failure of its own is
        # recorded (and fails the phase once the run is over) rather than
        # ending the thread, which would leave the stream waiting.
        try:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001
            taken.append(f"profiler: {exc!r}"[:300])
            return inner(occupied, *rest)
        try:
            t0 = time.perf_counter()
            did = inner(occupied, *rest)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            try:
                prof.__exit__(None, None, None)
            except Exception as exc:  # noqa: BLE001
                taken.append(f"profiler: {exc!r}"[:300])
        taken.append((prof, wall, len(occupied)))
        return did

    setattr(sched, name, profiled)
    return taken


def _dispatch_profile(sched, taken, what: str) -> dict:
    """The profiled dispatch with the most active slots: device busy and
    traced wall ms.  Fails when no dispatch was profiled."""
    profiled = [t for t in taken if isinstance(t, tuple)]
    if not profiled or len(profiled) != len(taken):
        fail(f"{what}: the served run's dispatches were not profiled "
             f"({[t for t in taken if not isinstance(t, tuple)]})")
    prof, wall, active = max(profiled, key=lambda t: t[2])
    return dict(device_busy_ms=sum(device_kernel_ms(prof).values()),
                traced_wall_ms=wall * 1e3, active_slots=active,
                profiled_dispatches=len(profiled),
                kind="verify" if sched.speculate_k else "decode",
                steps=(sched.speculate_k + 1 if sched.speculate_k
                       else sched.plan.decode_span))


def serve_llama_path(torch, dev, clf, prompts, card) -> dict:
    """(c) ``generate`` through the threaded continuous scheduler behind
    ``SentimentServer`` on the full-width Llama the Llama phase built: 12
    prompts, 8 slots, 16 new tokens; paged plain (the baseline), paged
    with speculation (text byte-identical to the baseline), a priority-2
    burst preempting priority-1 decodes under a TTFT target (at least one
    preemption, text byte-identical), the monolithic slot cache and int8
    pages (text agreement reported)."""
    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.serving.batcher import DynamicBatcher
    from music_analyst_tpu_torch.serving.decode_loop import (
        ContinuousScheduler,
    )
    from music_analyst_tpu_torch.serving.server import (
        SentimentServer,
        build_ops,
    )

    prompts = prompts[:SERVE_PROMPTS]
    deadline = 600_000.0  # explicit: a TTFT target must not shed these

    def gen_lines(idx, priority=1):
        return [json.dumps({"id": f"g{i}", "op": "generate", "text": prompts[i],
                            "max_new_tokens": PAGED_NEW, "priority": priority,
                            "deadline_ms": deadline}) for i in idx]

    def run(name, staged=False, **kw):
        sched = ContinuousScheduler(
            clf, n_slots=PAGED_SLOTS, prefill_chunk=64,
            max_new_tokens=PAGED_NEW, max_queue=64, **kw)
        warm = sched.warmup()
        batcher = DynamicBatcher(build_ops(clf), max_batch=PAGED_SLOTS,
                                 device=dev).start()
        # The preempt variant's dispatches are the paged variant's.
        profiled = None if staged else _profile_dispatches(torch, sched)
        sched.start()
        server = SentimentServer(batcher, mode="stdio", decode=sched)
        half = PAGED_SLOTS            # the first wave fills every slot

        def lines():
            yield from gen_lines(range(half))
            if staged:
                # The burst arrives once the first wave is decoding.
                t_end = time.perf_counter() + 120
                while not any(s is not None and s.active and s.steps > 0
                              for s in sched._slots):
                    if time.perf_counter() > t_end:
                        break
                    time.sleep(0.002)
                yield from gen_lines(range(half, SERVE_PROMPTS), priority=2)
            else:
                yield from gen_lines(range(half, SERVE_PROMPTS))

        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        replies = _stream(server, lines())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        _no_serve_threads(f"serve llama {name}")
        if len(replies) != SERVE_PROMPTS or not all(r["ok"] for r in replies):
            fail(f"serve llama {name}: replies {replies[:2]}")
        stats = sched.stats()
        texts = [r["text"] for r in replies]
        out = dict(
            wall_s=wall, launches=launches, warmup_s=warm["seconds"],
            ttft=_quantiles(stats["ttft"]), tpot=_quantiles(stats["tpot"]),
            host_ms_per_decode_dispatch=(
                stats["decode_seconds"] / stats["decode_dispatches"] * 1e3),
            decode_dispatches=stats["decode_dispatches"],
            prefill_dispatches=stats["prefill_dispatches"],
            tokens_generated=stats["tokens_generated"],
            preemptions=stats["preemptions"], resumed_o1=stats["resumed_o1"])
        spec = stats["speculation"]
        if spec["enabled"]:
            out.update(acceptance_rate=spec["acceptance_rate"],
                       tokens_per_verify_dispatch=spec[
                           "accepted_tokens_per_dispatch"],
                       verify_dispatches=spec["dispatches"],
                       plain_ticks=spec["plain_ticks"])
        if profiled is not None:
            out["dispatch_profile"] = _dispatch_profile(
                sched, profiled, f"serve llama {name}")
        del sched, batcher, server
        gc.collect()
        torch.cuda.empty_cache()
        return out, texts

    report = {}
    report["paged"], base = run("paged")
    if report["paged"]["launches"]["paged_attention"] == 0:
        fail("serve llama: the paged kernel never launched")
    report["speculative"], texts = run("speculative", speculate_k=SERVE_K)
    if texts != base:
        fail(f"serve llama speculative: {sum(a != b for a, b in zip(texts, base))}"
             f" texts differ from plain paged decode")
    if report["speculative"]["launches"]["paged_attention"] == 0:
        fail("serve llama speculative: the paged kernel never launched")
    # Twice the default pool, so the victims' checkpoints (pinned page
    # rows) survive the burst's admissions and resume with no prefill.
    pool = 2 * PAGED_SLOTS * (PAGED_REGION // PAGED_P + -(-PAGED_NEW // PAGED_P))
    report["preempt"], texts = run("preempt", staged=True, ttft_slo_ms=1.0,
                                   kv_pages=pool)
    if report["preempt"]["preemptions"] < 1 or \
            report["preempt"]["resumed_o1"] < 1:
        fail(f"serve llama preempt: the priority-2 burst preempted "
             f"{report['preempt']['preemptions']} and resumed "
             f"{report['preempt']['resumed_o1']} from a checkpoint")
    if texts != base:
        fail(f"serve llama preempt: {sum(a != b for a, b in zip(texts, base))}"
             f" texts differ from the undisturbed run")
    report["slots"], texts = run("slots", page_size=0)
    report["slots"]["same_text_as_paged"] = sum(
        a == b for a, b in zip(texts, base))
    report["int8"], texts = run("int8", kv_quant="int8")
    report["int8"]["same_text_as_paged"] = sum(
        a == b for a, b in zip(texts, base))
    if report["int8"]["launches"]["paged_attention"] == 0:
        fail("serve llama int8: the paged kernel never launched")
    for name, r in report.items():
        log(f"serve llama {name} on {card}: {json.dumps(r)}")
    return report


# Slice 9: the replica router and the run-manifest tools on the card.
ROUTER_REPLICAS = 2
ROUTER_TRACE_SAMPLE = 0.05   # head-sampled request traces in (b)
PROFILED_SONGS = 8192        # (c): one flat batch under --profile-dir


def _fleet_env(tmp: str, **extra) -> dict:
    """The router's environment: its fleet's temp dir (worker sockets)
    under ``tmp``, so every worker it spawns can be found and stopped."""
    os.makedirs(tmp, exist_ok=True)
    return dict(os.environ, TMPDIR=tmp, **extra)


def _stop_fleet_leftovers(tmp: str) -> list:
    """Kill any process whose command line names ``tmp`` (a worker a
    router left behind, e.g. one respawned while it drained)."""
    import signal

    killed = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read().decode(errors="replace")
        except OSError:
            continue
        if tmp in cmdline:
            try:
                os.kill(int(pid), signal.SIGKILL)
                killed.append(int(pid))
            except OSError:
                pass
    return killed


def _spawn_router(args, tmp, env_extra=None, stdio=False):
    """``serve --replicas 2 …`` as a process; returns it with a list that
    a thread fills with its stderr lines."""
    cmd = [sys.executable, "-m", "music_analyst_tpu_torch", "serve",
           "--replicas", str(ROUTER_REPLICAS), *args]
    proc = subprocess.Popen(
        cmd, cwd=ROOT, env=_fleet_env(tmp, **(env_extra or {})),
        stdin=subprocess.PIPE if stdio else subprocess.DEVNULL,
        stdout=subprocess.PIPE if stdio else subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    stderr = []
    threading.Thread(target=lambda: stderr.extend(proc.stderr),
                     daemon=True).start()
    t_wait = time.perf_counter() + 300
    while not any("routing over" in s for s in stderr):
        if proc.poll() is not None or time.perf_counter() > t_wait:
            proc.kill()
            fail(f"serve --replicas {ROUTER_REPLICAS} did not come up: "
                 f"{''.join(stderr)[-3000:]}")
        time.sleep(0.05)
    return proc, stderr


def _burst(wfile, rfile, lines, on_reply=None):
    """Write ``lines`` from a thread and read as many replies; returns the
    replies, each reply's arrival (s after the first write) and the wall."""
    t0 = time.perf_counter()
    writer = threading.Thread(
        target=lambda: (wfile.write("".join(l + "\n" for l in lines)),
                        wfile.flush()), daemon=True)
    writer.start()
    replies, arrivals = [], []
    for k in range(len(lines)):
        line = rfile.readline()
        if not line:
            fail(f"router: the stream ended after {k} of {len(lines)} replies")
        replies.append(json.loads(line))
        arrivals.append(time.perf_counter() - t0)
        if on_reply is not None:
            on_reply(k)
    wall = time.perf_counter() - t0
    writer.join()
    return replies, arrivals, wall


def _arrival_quantiles(arrivals) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(arrivals, 50)) * 1e3,
            "p99_ms": float(np.percentile(arrivals, 99)) * 1e3}


def _worker_launches(router_stats: dict, kernel: str) -> dict:
    """Each worker's own count of ``kernel`` launches since it was ready,
    from its last polled ``stats`` reply."""
    out = {}
    for name, snap in router_stats["replicas"].items():
        launches = (snap.get("last_stats") or {}).get("kernel_launches")
        if launches is None:
            fail(f"router: {name} reported no kernel launches: {snap}")
        out[name] = launches[kernel]
    return out


def _manifest(directory: str) -> dict:
    path = os.path.join(directory, "run_manifest.json")
    if not os.path.exists(path):
        fail(f"no run manifest in {directory}")
    with open(path) as fh:
        return json.load(fh)


def _cli(args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)


def router_mock_path(torch, card, single, single_replies) -> dict:
    """(a) ``serve --replicas 2 --stdio --mock`` as a process over the
    single-replica phase's 2,048-request stream: labels and word counts
    exact, every reply equal to the single replica's, the scan launched by
    the workers (each counts its own), requests/s and arrival p50/p99
    beside the single replica's figures of this run."""
    from music_analyst_tpu_torch.data.csv_io import iter_songs

    dataset = os.path.join(WORK, f"serve_{SERVE_MOCK_REQUESTS}.csv")
    texts = [t for _, _, t in iter_songs(dataset)]
    lines = (_lines(texts) + _lines(texts[:8], "wordcount", "w")
             + ["{not json"])
    tel_dir = os.path.join(WORK, "router_mock_telemetry")
    tmp = os.path.join(WORK, "router_mock_tmp")
    shutil.rmtree(tel_dir, ignore_errors=True)
    proc, stderr = _spawn_router(
        ["--stdio", "--mock", "--no-response-cache",
         "--max-queue", str(len(lines) + 16), "--telemetry-dir", tel_dir],
        tmp, stdio=True)
    try:
        replies, arrivals, wall = _burst(proc.stdin, proc.stdout, lines)
        proc.stdin.write(json.dumps({"id": "z", "op": "shutdown"}) + "\n")
        proc.stdin.flush()
        bye = json.loads(proc.stdout.readline())
        proc.stdin.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        leftovers = _stop_fleet_leftovers(tmp)
    if rc != 0 or not bye.get("draining") or leftovers:
        fail(f"router --mock exited {rc} after {bye} (leftover workers "
             f"{leftovers}): {''.join(stderr)[-2000:]}")
    if replies != single_replies:
        bad = sum(a != b for a, b in zip(replies, single_replies))
        fail(f"router --mock: {bad} replies differ from the single replica's")
    want = [reference_mock_label(t) for t in texts]
    if [r.get("label") for r in replies[:len(texts)]] != want:
        fail("router --mock: labels differ from the reference heuristic")
    for r, text in zip(replies[len(texts):len(texts) + 8], texts[:8]):
        if {k: r.get(k) for k in ("counts", "total_words")} != \
                _wordcount_contract(text):
            fail(f"router --mock: wordcount reply {r['id']} breaks the "
                 "contract")
    router = _manifest(tel_dir).get("serving", {}).get("router")
    if not router or router["replica_count"] != ROUTER_REPLICAS:
        fail(f"router --mock: the manifest's serving.router is {router}")
    launches = _worker_launches(router, "keyword_scan")
    dispatched = {n: s["dispatched"] for n, s in router["replicas"].items()}
    if sum(launches.values()) == 0 or min(dispatched.values()) == 0:
        fail(f"router --mock: scan launches {launches}, dispatched "
             f"{dispatched}")
    out = dict(requests=len(lines), requests_per_s=len(texts) / wall,
               wall_s=wall, arrival=_arrival_quantiles(arrivals[:len(texts)]),
               launches_by_worker=launches,
               scan_launches=sum(launches.values()), dispatched=dispatched,
               single_replica=dict(requests_per_s=single["requests_per_s"],
                                   latency=single["latency"],
                                   launches=single["launches"]["keyword_scan"]),
               replies_equal_single=True)
    log(f"serve --replicas {ROUTER_REPLICAS} --mock (process) on {card}: "
        f"{json.dumps(out)}")
    return out


def router_distilbert_path(torch, dev, card, dataset, single) -> dict:
    """(b) ``serve --replicas 2 --socket --model distilbert`` as a process:
    full-width DistilBERT in each worker (bf16, flash), loaded through
    ``$MUSICAAL_DISTILBERT_CKPT`` from a seeded checkpoint written here
    whose head splits the labels (random weights alone label every song
    ``Positive``, so swapped replies would pass), 4,096 requests at
    max_batch 256.  Labels are held against the parent's reference model
    loaded from the same file (equal except within SERVE_FLIP_REL of the
    scale of a decision boundary), and the same check must fail on the
    replies rotated by one request; the workers' flash launches summed;
    ``monitor --once`` attaches to the router; then a second stream with
    one worker SIGKILLed halfway: every request must be answered, and the
    manifest's ``serving.router`` must record the worker's health
    transition."""
    import math
    import signal

    import numpy as np

    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
    )
    from music_analyst_tpu_torch.runtime.wire import to_device

    n = SERVE_DISTILBERT_REQUESTS
    texts = [t for _, _, t in iter_songs(dataset, limit=n)]
    checkpoint = distilbert_split_checkpoint(
        torch, dev, texts, os.path.join(WORK, "router_distilbert.bin"))
    # The reference: the workers' model, loaded here from the same file.
    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", config=DistilBertConfig(attn_impl="flash"),
        checkpoint_path=checkpoint["path"], device=dev)
    ids, lens = clf.tokenizer.encode_batch(texts, clf.max_len)
    ref = clf.forward_logits(*to_device(
        [np.asarray(ids, np.int64), np.asarray(lens)], dev)).float().cpu()
    threshold = clf.neutral_threshold
    del clf
    torch.cuda.empty_cache()
    scale = max(1.0, float(ref.abs().max()))
    boundary = math.log(threshold / (1.0 - threshold))
    top2 = ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    want = ["Neutral" if not t.strip() or float(g) < boundary
            else DistilBertClassifier._CLASS_LABELS[int(k)]
            for t, g, k in zip(texts, gap, ref.argmax(dim=-1))]
    near = (torch.minimum(gap, (gap - boundary).abs())
            < SERVE_FLIP_REL * scale).tolist()
    counts = {l: want.count(l) for l in DistilBertClassifier._CLASS_LABELS
              + ("Neutral",)}
    if min(counts.values()) < n // 10:
        fail(f"router distilbert: the reference labels do not split: "
             f"{counts}")

    def mismatches(replies):
        return [i for i, r in enumerate(replies)
                if r["label"] != want[i] and not near[i]]

    def check(replies, what):
        if not all(r.get("ok") for r in replies):
            bad = [r for r in replies if not r.get("ok")]
            fail(f"router distilbert ({what}): {len(bad)} requests failed, "
                 f"first {bad[0]}")
        off = mismatches(replies)
        if off:
            fail(f"router distilbert ({what}): {len(off)} labels differ from "
                 f"the seed-0 reference away from a boundary (first id "
                 f"{off[0]}: {replies[off[0]]['label']} vs {want[off[0]]})")

    tel_dir = os.path.join(WORK, "router_distilbert_telemetry")
    trace_dir = os.path.join(WORK, "router_distilbert_traces")
    tmp = os.path.join(WORK, "router_distilbert_tmp")
    sock_path = os.path.join(WORK, "router.sock")
    for d in (tel_dir, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    t_start = time.perf_counter()
    proc, stderr = _spawn_router(
        ["--socket", sock_path, "--model", "distilbert",
         "--max-batch", str(SERVE_MAX_BATCH), "--max-queue", str(4 * n),
         "--no-response-cache", "--telemetry-dir", tel_dir],
        tmp, env_extra={"MUSICAAL_TRACE_DIR": trace_dir,
                        "MUSICAAL_TRACE_SAMPLE": str(ROUTER_TRACE_SAMPLE),
                        "MUSICAAL_DISTILBERT_CKPT": checkpoint["path"]})
    startup_s = time.perf_counter() - t_start
    import socket as socketlib

    sock = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    try:
        t_wait = time.perf_counter() + 60
        while True:
            try:
                sock.connect(sock_path)
                break
            except OSError:
                if time.perf_counter() > t_wait or proc.poll() is not None:
                    fail(f"router distilbert: no socket: "
                         f"{''.join(stderr)[-2000:]}")
                time.sleep(0.05)
        wfile = sock.makefile("w", encoding="utf-8")
        rfile = sock.makefile("r", encoding="utf-8")

        def stats():
            wfile.write(json.dumps({"id": "stats", "op": "stats"}) + "\n")
            wfile.flush()
            return json.loads(rfile.readline())["stats"]

        replies, arrivals, wall = _burst(wfile, rfile, _lines(texts))
        check(replies, "measured stream")
        # The check must catch replies handed to the wrong request.
        rotated = len(mismatches(replies[1:] + replies[:1]))
        log(f"router distilbert: replies rotated by one request break the "
            f"label check on {rotated} of {n} requests")
        if rotated == 0:
            fail("router distilbert: the label check passes replies rotated "
                 "by one request")
        time.sleep(1.0)          # one more stats poll of each worker
        fleet = stats()["router"]
        launches = _worker_launches(fleet, "flash_attention")
        if min(launches.values()) == 0:
            fail(f"router distilbert: a worker launched no flash kernel "
                 f"{launches}")
        worker_latency = {
            name: _quantiles(snap["last_stats"]["requests"]["latency"])
            for name, snap in fleet["replicas"].items()}
        mon = _cli(["monitor", "--socket", sock_path, "--once"], timeout=60)
        if mon.returncode != 0:
            fail(f"monitor --once: rc {mon.returncode}: {mon.stdout[-1000:]} "
                 f"{mon.stderr[-1000:]}")

        # The kill stream: SIGKILL one worker once half the replies are in.
        victim = sorted(fleet["replicas"])[0]
        pid = fleet["replicas"][victim]["pid"]
        killed = []

        def kill_halfway(k):
            if k == n // 2 and not killed:
                os.kill(pid, signal.SIGKILL)
                killed.append(time.perf_counter())

        kill_replies, _, kill_wall = _burst(
            wfile, rfile, _lines(texts, prefix="k"), on_reply=kill_halfway)
        if [r.get("id") for r in kill_replies] != [f"k{i}" for i in range(n)]:
            fail("router distilbert (kill stream): replies out of order")
        check(kill_replies, "kill stream")
        # Wait for the supervised respawn, so no worker starts mid-drain.
        t_wait = time.perf_counter() + 180
        while True:
            fleet_after = stats()["router"]
            if fleet_after["replicas"][victim]["respawns"] >= 1 and \
                    fleet_after["replicas"][victim]["health"] == "healthy":
                break
            if time.perf_counter() > t_wait:
                fail(f"router distilbert: {victim} was not respawned: "
                     f"{fleet_after['health_transitions']}")
            time.sleep(0.5)
        wfile.write(json.dumps({"id": "z", "op": "shutdown"}) + "\n")
        wfile.flush()
        line = rfile.readline()
        if not line:
            rc = proc.wait(timeout=180)
            fail(f"router distilbert: no reply to shutdown (router rc {rc}): "
                 f"{''.join(stderr)[-3000:]}")
        bye = json.loads(line)
        rc = proc.wait(timeout=180)
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        leftovers = _stop_fleet_leftovers(tmp)
    if rc != 0 or not bye.get("draining") or leftovers:
        fail(f"router distilbert exited {rc} after {bye} (leftover workers "
             f"{leftovers}): {''.join(stderr)[-2000:]}")
    manifest = _manifest(tel_dir)
    router = manifest.get("serving", {}).get("router") or {}
    lost = [t for t in router.get("health_transitions", [])
            if t["replica"] == victim and t["to"] in ("unhealthy", "dead")]
    if not lost:
        fail(f"router distilbert: the manifest records no health transition "
             f"for {victim}: {router.get('health_transitions')}")
    if manifest["device"]["platform"] != "gpu":
        fail(f"router distilbert: manifest device {manifest['device']}")
    out = dict(requests=n, requests_per_s=n / wall, wall_s=wall,
               startup_s=startup_s,
               arrival=_arrival_quantiles(arrivals),
               worker_latency=worker_latency,
               launches_by_worker=launches,
               flash_launches=sum(launches.values()),
               dispatched={k: s["dispatched"]
                           for k, s in fleet["replicas"].items()},
               reference_labels=counts, near_boundary=int(sum(near)),
               rotated_mismatches=rotated, checkpoint=checkpoint,
               kill=dict(victim=victim, wall_s=kill_wall,
                         requests_per_s=n / kill_wall, all_answered=True,
                         requeued=router.get("requeued"),
                         respawns=router.get("respawns"),
                         transitions=router.get("health_transitions")),
               monitor=mon.stdout.strip().splitlines()[:8],
               single_replica=dict(
                   requests_per_s=single["requests_per_s"],
                   latency=single["latency"],
                   launches=single["launches"]["flash_attention"],
                   note="in process (handle_stream), the serve phase"),
               telemetry_dir=tel_dir, trace_dir=trace_dir)
    log(f"serve --replicas {ROUTER_REPLICAS} --model distilbert on {card}: "
        f"{json.dumps(out)}")
    return out


def manifest_tools_path(torch, card, dataset, run_dirs, trace_dir) -> dict:
    """(c) ``sentiment --model distilbert --profile-dir D --telemetry-dir
    T`` on one 8,192-song batch: D holds a device trace naming
    ``flash_wgmma_kernel`` and ``trace_spans.json``, T a manifest naming
    the card.  Then ``telemetry-report`` over the run dirs of (a), (b), (c)
    and one ``analyze`` (exit 0, with the router fleet section),
    ``trace-report`` over (b)'s request traces, and ``profile-diff`` (0 on
    a manifest against itself, 1 with the wall doubled)."""
    prof_dir = os.path.join(WORK, "profiled_sentiment_profile")
    tel_dir = os.path.join(WORK, "profiled_sentiment_telemetry")
    out_dir = os.path.join(WORK, "profiled_sentiment")
    # A trace with no device event at all is taken again: the command
    # runs again, up to PROFILE_TRIES times in all.
    for attempt in range(1, PROFILE_TRIES + 1):
        for d in (prof_dir, tel_dir):
            shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        run = _cli(["sentiment", dataset, "--model", "distilbert",
                    "--limit", str(PROFILED_SONGS),
                    "--batch-size", str(PROFILED_SONGS),
                    "--profile-dir", prof_dir, "--telemetry-dir", tel_dir,
                    "--output-dir", out_dir])
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"sentiment --profile-dir: rc {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        with open(os.path.join(prof_dir, "torch_trace.json")) as fh:
            trace = json.load(fh)
        device = [e for e in trace.get("traceEvents", [])
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if device:
            break
        log(f"sentiment --profile-dir: trace {attempt} holds no device "
            f"event" + ("; running the command again"
                        if attempt < PROFILE_TRIES else ""))
    flash_events = sum(1 for e in device if e.get("cat") == "kernel"
                       and "flash_wgmma_kernel" in e.get("name", ""))
    kernel_events = sum(1 for e in device if e.get("cat") == "kernel")
    if flash_events == 0:
        fail(f"sentiment --profile-dir: the device trace holds no "
             f"flash_wgmma_kernel ({kernel_events} kernel events)")
    with open(os.path.join(prof_dir, "trace_spans.json")) as fh:
        spans = json.load(fh)["traceEvents"]
    if not any(e.get("name") == "compute" for e in spans):
        fail("sentiment --profile-dir: trace_spans.json has no compute span")
    manifest = _manifest(tel_dir)
    kind = torch.cuda.get_device_name(0)
    if manifest["device"]["platform"] != "gpu" or \
            manifest["device"]["kinds"] != [kind]:
        fail(f"sentiment --profile-dir: manifest device {manifest['device']}")
    if manifest["profiling"].get("profiler", {}).get("status") != "recording":
        fail(f"sentiment --profile-dir: profiler {manifest['profiling']}")
    out = dict(wall_s=wall, flash_events=flash_events,
               kernel_events=kernel_events, profile_attempts=attempt,
               span_events=len(spans),
               manifest_wall_s=manifest["wall_seconds"],
               manifest_device=manifest["device"]["kinds"])

    report = _cli(["telemetry-report", *run_dirs, tel_dir], timeout=120)
    if report.returncode != 0 or "router fleet" not in report.stdout:
        fail(f"telemetry-report: rc {report.returncode}: "
             f"{report.stdout[-2000:]} {report.stderr[-1000:]}")
    out["telemetry_report"] = report.stdout.splitlines()
    traces = _cli(["trace-report", trace_dir], timeout=120)
    if traces.returncode != 0:
        fail(f"trace-report: rc {traces.returncode}: {traces.stdout[-1000:]} "
             f"{traces.stderr[-1000:]}")
    out["trace_report"] = traces.stdout.splitlines()[:12]
    base = os.path.join(tel_dir, "run_manifest.json")
    doubled = dict(manifest, wall_seconds=2 * manifest["wall_seconds"])
    slow = os.path.join(WORK, "manifest_wall_doubled.json")
    with open(slow, "w") as fh:
        json.dump(doubled, fh)
    same = _cli(["profile-diff", base, base], timeout=60)
    worse = _cli(["profile-diff", base, slow], timeout=60)
    if same.returncode != 0 or worse.returncode != 1:
        fail(f"profile-diff: rc {same.returncode} on a manifest against "
             f"itself, {worse.returncode} with the wall doubled")
    out["profile_diff_rc"] = [same.returncode, worse.returncode]
    log(f"manifests and tools on {card}: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Step 10: training at full width, the flash loss, MoE, sweep
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 8, 513        # token rows: 512 inputs and 512 targets
TRAIN_LAYERS = 2                 # llama3_8b width, depth cut to fit 80 GB
                                 # (4 before step 10's sweep over ranks)
TRAIN_LR = 1e-4
TRAIN_FIXED_STEPS, TRAIN_PACKED_STEPS = 5, 3
#  - flash at Llama's shapes: the bf16 elementwise bound above (one
#    rounding of an f32 result), at q [8, 512, 32, 128], kv [8, 512, 8, 128].
#  - the loss through flash against dense on the same bf16 weights: the two
#    paths round attention differently (flash keeps p in f32, dense casts
#    the probabilities to bf16), through 32 layers.  The mean next-token
#    cross-entropy agrees to FLASH_LOSS_REL_TOL relative (3.2e-5 and 2.9e-5
#    measured on an H100, unpacked and packed; below one nat, to
#    FLASH_LOSS_REL_TOL nats: 7.6e-5 measured after training), and the
#    logits of every scored position to LLAMA_LOGIT_REL_TOL of their scale
#    (2.0% and 1.9% measured).  A non-causal kernel (unpacked) and one that
#    attends across documents (packed) must break both: measured 5.8e-4
#    and 3.8e-4 relative on the loss, logits off by 1.4 times their scale.
FLASH_LOSS_REL_TOL = 2e-4
#  - MoE sparse at lossless capacity against dense, bf16: dense combines
#    the experts in bf16, sparse in f32; the last-position logits agree to
#    LOGIT_REL_TOL of their scale.  int8 experts and projections against
#    the float model: MOE_INT8_REL_TOL of the logit scale (2.0% measured
#    on an H100: a dynamic int8 product is ~1% off per layer on random
#    weights).  Each expert's int8 product taken with its neighbour's
#    weights must break it (7.6% measured).  Weight scales swapped between
#    experts cannot: at random 8B weights every expert's per-channel
#    maximum over 4096 draws is nearly the same, so the swap stays within
#    int8's own error; the expert product's bit-for-bit check
#    (check_expert_product) holds those.
MOE_INT8_REL_TOL = 5e-2
MOE_PROMPTS = 8


def llama_token_batch(np, seed, packed=False):
    """A seeded ``[TRAIN_B, TRAIN_S]`` int32 batch over the 8B vocab with
    lengths (and, ``packed``, two or three documents per row)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128_256, (TRAIN_B, TRAIN_S)).astype(np.int32)
    if not packed:
        lengths = np.full(TRAIN_B, TRAIN_S, np.int32)
        lengths[TRAIN_B // 2:] = rng.integers(TRAIN_S // 2, TRAIN_S,
                                              TRAIN_B - TRAIN_B // 2)
        return ids, lengths
    seg = np.zeros((TRAIN_B, TRAIN_S), np.int32)
    for b in range(TRAIN_B):
        cuts = np.sort(rng.choice(np.arange(32, TRAIN_S - 32),
                                  1 + b % 2, replace=False))
        bounds = [0, *cuts, TRAIN_S - 8 * (b % 3)]
        for doc, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]), 1):
            seg[b, lo:hi] = doc
    return ids, (seg > 0).sum(axis=1).astype(np.int32), seg


def check_flash_llama(torch, dev) -> dict:
    """Kernel 2 against its plain version at Llama-3-8B's no-cache shapes
    (q [8, 512, 32, 128], kv [8, 512, 8, 128], bf16): causal with lengths,
    and causal with two packed documents per row; then its time beside the
    plain version, SDPA (GQA, causal) and the bound."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    B, S, H, Hkv, D = 8, 512, 32, 8, 128
    gen = torch.Generator().manual_seed(21)
    q = torch.randn(B, S, H, D, generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([S, S, S, S, 400, 300, 129, 17], dtype=torch.int32,
                           device=dev)
    seg = torch.ones(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, 64 + 48 * b:] = 2
    cases = {"causal_lengths": dict(causal=True, lengths=lengths),
             "causal_two_documents": dict(causal=True, q_segment_ids=seg)}
    out = {}
    with torch.no_grad():
        for name, kw in cases.items():
            got = flash_attention(q, k, v, **kw)
            ref = flash_attention_reference(q.float(), k.float(), v.float(),
                                            **kw)
            out[name] = check_flash_output(torch, f"llama {name}", got, ref)
            if name == "causal_two_documents":
                # The limit must catch attention across the documents.
                crossed = flash_attention(q, k, v, causal=True)
                if flash_within(crossed, ref):
                    fail("flash llama: limits pass attention across "
                         "documents")
            del got, ref
        max_err = max(out.values())
        kernel_ms = time_ms(torch, lambda: flash_attention(q, k, v,
                                                           causal=True), 20)
        plain_ms = time_ms(torch, lambda: flash_attention_reference(
            q, k, v, causal=True), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    # q and o once each, k and v once each; causal: S(S+1)/2 pairs.
    bytes_moved = 2 * B * S * H * D * 2 + 2 * B * S * Hkv * D * 2
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    timing = dict(shape=f"q bf16 [{B},{S},{H},{D}], kv [{B},{S},{Hkv},{D}], "
                        "causal", ms=kernel_ms, plain_ms=plain_ms,
                  library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                  bytes=bytes_moved, flops=flops, max_abs_err=max_err,
                  errors=out)
    log(f"flash at Llama shapes: {json.dumps(timing)}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return timing


def _meta_llama(torch, cfg, dev):
    from music_analyst_tpu_torch.models.llama import LlamaModel

    with torch.device("meta"):
        model = LlamaModel(cfg)
    return model.to_empty(device=dev)


def _shared_llama(torch, model, **over):
    """A second Llama over ``model``'s own weight tensors (no copy), with
    config fields changed (attention impl, MoE dispatch)."""
    import dataclasses

    from music_analyst_tpu_torch.models.llama import LlamaModel

    with torch.device("meta"):
        twin = LlamaModel(dataclasses.replace(model.config, **over))
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


@contextlib.contextmanager
def _broken_flash(**force):
    """Llama's flash attention with keyword arguments forced: causal=False
    (a non-causal kernel) or q_segment_ids=None (attention across
    documents).  The model's layers call it through ``models.layers``."""
    from music_analyst_tpu_torch.models import layers

    real = layers.flash_attention
    layers.flash_attention = lambda q, k, v, **kw: real(q, k, v,
                                                        **{**kw, **force})
    try:
        yield
    finally:
        layers.flash_attention = real


def _loss_and_logits(torch, model, ids, lengths, seg):
    """``causal_lm_loss`` of the batch, and the logits it scored
    (recorded at ``lm_head``), the padding's set to 0."""
    from music_analyst_tpu_torch.engines.train import causal_lm_loss

    seen = []
    hook = model.lm_head.register_forward_hook(
        lambda module, args, out: seen.append(out))
    try:
        loss = float(causal_lm_loss(model, ids, lengths, segment_ids=seg))
    finally:
        hook.remove()
    (logits,) = seen
    S = logits.shape[1]
    valid = torch.arange(S, device=ids.device)[None, :] < lengths[:, None] - 1
    if seg is not None:
        valid &= seg[:, :-1] > 0
    return loss, logits * valid[..., None]


def _loss_agreement(torch, got, want) -> dict:
    """How far ``got`` = (loss, logits) is from ``want``, against
    FLASH_LOSS_REL_TOL (relative to the loss, or to one nat below it) and
    LLAMA_LOGIT_REL_TOL."""
    scale = float(want[1].abs().max())
    logit_diff = float((got[1] - want[1]).abs().max())
    rel = abs(got[0] - want[0]) / max(abs(want[0]), 1.0)
    return dict(loss=got[0], rel_diff=rel, logit_max_abs=logit_diff,
                logit_scale=scale,
                within=bool(rel <= FLASH_LOSS_REL_TOL
                            and logit_diff <= LLAMA_LOGIT_REL_TOL * scale))


def flash_loss_path(torch, dev, card) -> dict:
    """The loss forward through the flash kernel on the full 32-layer
    llama3_8b (random bf16 weights), against the dense path on the same
    weights, B = 8, S = 513, unpacked and packed: the loss and the logits
    of every scored position; the flash launches are counted (one per
    layer per forward).  A non-causal kernel (unpacked) and attention
    across documents (packed) must break the limits."""
    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.models.llama import LlamaConfig, init_random_

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    dense = _meta_llama(torch, cfg, dev)
    init_random_(dense, 0)
    flash = _shared_llama(torch, dense, attn_impl="flash")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"init_s": init_s, "layers": cfg.n_layers}
    batches = {"unpacked": llama_token_batch(np, 31) + (None,),
               "packed": llama_token_batch(np, 32, packed=True)}
    broken = {"unpacked": dict(causal=False),
              "packed": dict(q_segment_ids=None)}
    with torch.no_grad():
        for name, (ids, lengths, seg) in batches.items():
            args = [torch.as_tensor(a, device=dev) for a in (ids, lengths)]
            if seg is not None:
                seg = torch.as_tensor(seg, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = _loss_and_logits(torch, flash, *args, seg)
            flash_s = time.perf_counter() - t0
            launches = kernels.launches()
            want = _loss_and_logits(torch, dense, *args, seg)
            if not (np.isfinite(got[0]) and np.isfinite(want[0])):
                fail(f"flash loss {name}: non-finite ({got[0]}, {want[0]})")
            agree = _loss_agreement(torch, got, want)
            del got
            with _broken_flash(**broken[name]):
                wrong = _loss_agreement(torch, _loss_and_logits(
                    torch, flash, *args, seg), want)
            out[name] = dict(agree, dense_loss=want[0], launches=launches,
                             flash_forward_s=flash_s,
                             broken={"forced": list(broken[name]), **wrong})
            if not agree["within"]:
                fail(f"flash loss {name}: flash vs dense {agree}")
            if wrong["within"]:
                fail(f"flash loss {name}: the limits pass a kernel with "
                     f"{broken[name]}: {wrong}")
            if launches["flash_attention"] != cfg.n_layers:
                fail(f"flash loss {name}: flash_attention launched "
                     f"{launches['flash_attention']} times, expected "
                     f"{cfg.n_layers}")
            del want
    log(f"llama3_8b loss, flash vs dense on {card}: {json.dumps(out)}")
    del dense, flash
    gc.collect()
    torch.cuda.empty_cache()
    return out


def traced_device_ms(prof, path) -> float:
    """The device's busy time in ms in a finished profile's trace (written
    to ``path``): the union of its kernels, copies and memsets on any
    stream, whichever host thread launched them."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        spans = sorted((e["ts"], e["ts"] + e["dur"])
                       for e in json.load(fh)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") in (
                           "kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy_us / 1e3


def train_split(torch, model, opt, state, batch) -> dict:
    """One more step of ``state`` on ``batch`` through ``make_train_step``
    with a phase hook: CUDA events around each phase (loading the masters,
    the forward, the backward, the optimizer) on the stream, with no
    synchronize between them, and ``torch.profiler`` around the whole
    step.  The device's idle time in the step (the host's share) is the
    step's event time less the device activity in the profiler's trace.
    (The trace's per-range device times miss the backward, whose kernels
    the autograd engine's thread launches, so phases are timed by events.)"""
    from torch.profiler import ProfilerActivity, profile, record_function

    from music_analyst_tpu_torch.engines import train as engine

    phases = {}

    @contextlib.contextmanager
    def phase(name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with record_function(f"train.{name}"):
            start.record()
            yield
            end.record()
        phases[name] = (start, end, time.perf_counter() - t0)

    step = engine.make_train_step(model, opt, phase=phase)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):      # the tracer's first start-up
        torch.ones(1, device=batch[0].device).add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    finish = torch.cuda.Event(enable_timing=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        begin.record()
        state, loss = step(state, *batch)
        finish.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    step_ms = begin.elapsed_time(finish)
    busy_ms = traced_device_ms(prof, os.path.join(WORK, "train_step.json"))
    result = {name: dict(device_ms=start.elapsed_time(end),
                         host_enqueue_ms=host_s * 1e3)
              for name, (start, end, host_s) in phases.items()}
    result.update(step_ms=step_ms, step_wall_ms=wall_ms,
                  device_busy_ms=busy_ms, device_idle_ms=step_ms - busy_ms,
                  idle_share=(step_ms - busy_ms) / step_ms,
                  loss=float(loss))
    return result


def train_path(torch, dev, card) -> dict:
    """The trainer at llama3_8b's full width with TRAIN_LAYERS layers: 5
    AdamW steps on one fixed batch, then 3 packed batches, each batch
    through ``prefetch_batches``; then an evaluation of the loss through
    the flash kernel, a checkpoint round trip and a phase split."""
    import dataclasses
    import tempfile

    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.engines import train as engine
    from music_analyst_tpu_torch.engines.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from music_analyst_tpu_torch.models.llama import LlamaConfig
    from music_analyst_tpu_torch.telemetry import get_telemetry

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _meta_llama(torch, cfg, dev)
    opt = engine.make_optimizer(TRAIN_LR)
    state = engine.init_train_state(model, opt, seed=0)
    step = engine.make_train_step(model, opt)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in state.params.values())}
    fixed = llama_token_batch(np, 41)
    batches = ([fixed] * TRAIN_FIXED_STEPS
               + [llama_token_batch(np, 50 + i, packed=True)
                  for i in range(TRAIN_PACKED_STEPS)])
    tel = get_telemetry()
    steps_before = tel.counters.get("train_steps", 0)
    bytes_before = tel.counters.get("train_pipeline.h2d_bytes", 0)
    losses, step_ms = [], []
    kernels.reset_launches()
    t0 = time.perf_counter()
    for batch in engine.prefetch_batches(batches, device=dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        step_ms.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    steps = tel.counters.get("train_steps", 0) - steps_before
    if not all(np.isfinite(losses)):
        fail(f"trainer: non-finite loss {losses}")
    if not losses[TRAIN_FIXED_STEPS - 1] < losses[0]:
        fail(f"trainer: loss did not fall over {TRAIN_FIXED_STEPS} steps on "
             f"one batch: {losses[:TRAIN_FIXED_STEPS]}")
    if steps != len(batches) or int(state.step) != len(batches):
        fail(f"trainer: train_steps counted {steps}, state.step "
             f"{int(state.step)}, expected {len(batches)}")
    tokens = TRAIN_B * (TRAIN_S - 1)
    steady = step_ms[1:]
    out.update(
        losses=losses, step_ms=step_ms,
        step_ms_mean=sum(steady) / len(steady),
        tokens_per_s=tokens / (sum(steady) / len(steady) / 1e3),
        wall_s=wall, train_steps=steps,
        h2d_bytes=tel.counters.get("train_pipeline.h2d_bytes", 0)
        - bytes_before,
        training_launches=kernels.launches(),
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    # Evaluation through the flash kernel on the trained weights.
    engine.load_params_(model, state.params)
    flash = _shared_llama(torch, model, attn_impl="flash")
    ids, lengths = (torch.as_tensor(a, device=dev) for a in fixed)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad():
        got = _loss_and_logits(torch, flash, ids, lengths, None)
        out["eval_launches"] = kernels.launches()
        want = _loss_and_logits(torch, model, ids, lengths, None)
    if out["eval_launches"]["flash_attention"] != TRAIN_LAYERS:
        fail(f"trainer eval: flash launched {out['eval_launches']}")
    out["eval"] = dict(_loss_agreement(torch, got, want), dense_loss=want[0])
    if not out["eval"]["within"]:
        fail(f"trainer eval: flash vs dense {out['eval']}")
    del flash, got, want
    # Checkpoint round trip, in a temporary directory.
    tmp = tempfile.mkdtemp(prefix="train_state_")
    try:
        out["checkpoint_disk_free_bytes"] = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        save_train_state(state, tmp)
        out["checkpoint_save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(
            os.path.join(tmp, "train_state.pt"))
        t0 = time.perf_counter()
        restored = restore_train_state(tmp, device=dev)
        torch.cuda.synchronize()
        out["checkpoint_restore_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if int(restored.step) != int(state.step):
        fail(f"checkpoint: step {int(restored.step)} != {int(state.step)}")
    for name, master in state.params.items():
        back = restored.params[name]
        moments = state.opt_state.state[master]
        back_m = restored.opt_state.state[back]
        if not (torch.equal(back, master)
                and torch.equal(back_m["exp_avg"], moments["exp_avg"])
                and torch.equal(back_m["exp_avg_sq"], moments["exp_avg_sq"])):
            fail(f"checkpoint: {name} did not round-trip")
    del restored
    torch.cuda.empty_cache()
    out["split"] = train_split(torch, model, opt, state, (ids, lengths))
    log(f"trainer llama3_8b width x {TRAIN_LAYERS} layers on {card}: "
        f"{json.dumps(out)}")
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _int8_experts_rolled():
    """The MoE layers' int8 expert product with each expert's weights (codes
    and scales) taken from the expert before it."""
    from music_analyst_tpu_torch.models import moe

    real = moe.quant_batched_matmul
    moe.quant_batched_matmul = lambda x, w: real(x, w.roll(1, dims=0))
    try:
        yield
    finally:
        moe.quant_batched_matmul = real


def check_expert_product(torch, dev) -> dict:
    """``quant_batched_matmul`` at the 8B MoE's expert shape (8 experts,
    256 rows, 4096 → 14336) against its plain version, bit for bit, each
    expert's weights at their own magnitude (2^e), so that scales taken
    from another expert show; weight scales swapped between neighbouring
    experts must break it."""
    from music_analyst_tpu_torch.ops.quant import (
        quant_batched_matmul,
        quant_batched_matmul_plain,
    )

    E, C, K, N = 8, 256, 4096, 14336
    gen = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn(E, C, K, generator=gen, device=dev).bfloat16()
    w = torch.randn(E, K, N, generator=gen, device=dev)
    w = (w * 0.02 * 2.0 ** torch.arange(E, device=dev)[:, None, None]
         ).bfloat16()
    with torch.no_grad():
        got = quant_batched_matmul(x, w)
        want = quant_batched_matmul_plain(x, w)
        amax = w.float().abs().amax(dim=1, keepdim=True)           # [E,1,N]
        swapped = got * (amax.roll(1, dims=0) / amax)
    out = dict(shape=f"x bf16 [{E},{C},{K}], w [{E},{K},{N}]",
               max_abs_err=float((got - want).abs().max()),
               swapped_max_rel=float(((swapped - want).abs()
                                      / want.abs().max()).max()))
    if not torch.equal(got, want):
        fail(f"int8 expert product on the card vs plain: {out}")
    if torch.equal(swapped, want):
        fail("int8 expert product: the check passes swapped weight scales")
    del x, w, got, want, swapped
    torch.cuda.empty_cache()
    return out


def moe_path(torch, dev, card) -> dict:
    """MoE at llama3_8b width (2 layers, 8 experts, top-2, bf16): last
    prompt logits and label scores over MOE_PROMPTS prompts with sparse
    dispatch at lossless capacity against dense; the drops at capacity
    1.25; int8 experts against the float model."""
    import dataclasses

    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaZeroShotClassifier,
    )

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              n_experts=8, moe_top_k=2,
                              moe_capacity_factor=8.0)
    texts = [t for _, _, t in iter_songs(os.path.join(WORK, "songs_16384.csv"),
                                         limit=MOE_PROMPTS)]
    out = {}

    def run(clf):
        ids, lens = clf._encode_prompts(texts)
        ids = torch.as_tensor(ids, device=dev).long()
        lens = torch.as_tensor(lens, device=dev).long()
        S = ids.shape[1]
        pos = torch.arange(S, device=dev).expand(len(texts), S)
        mask = (torch.arange(S, device=dev)[None, None, None, :]
                < lens[:, None, None, None])
        mask = mask & (torch.arange(S, device=dev)[None, :]
                       <= torch.arange(S, device=dev)[:, None])
        with torch.no_grad():
            logits, _ = clf.model(ids, pos, mask, last_position=lens - 1)
            # Assignments the prompt forward dropped past capacity.
            drops = sum(int(layer.feed_forward_moe.last_dropped)
                        for layer in clf.model.layers)
            scores = clf.score_labels(ids, lens)
        torch.cuda.synchronize()
        return logits[:, 0].float(), scores.float(), S, drops

    t0 = time.perf_counter()
    clf = LlamaZeroShotClassifier(config=cfg, device=dev, seed=0,
                                  max_prompt_len=1024)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sparse, sparse_scores, S, out["sparse_lossless_drops"] = run(clf)
    out["sparse_s"] = time.perf_counter() - t0
    out["prompt_len"] = S
    for layer in clf.model.layers:
        layer.feed_forward_moe.dispatch = "dense"
    t0 = time.perf_counter()
    dense, dense_scores, _, _ = run(clf)
    out["dense_s"] = time.perf_counter() - t0
    scale = float(dense.abs().max())
    diff = float((sparse - dense).abs().max())
    out.update(logit_scale=scale, sparse_vs_dense_max_abs=diff,
               score_max_abs=float((sparse_scores - dense_scores).abs().max()),
               argmax_agree=int((sparse.argmax(-1) == dense.argmax(-1)).sum()))
    if not (torch.isfinite(sparse).all() and torch.isfinite(dense).all()):
        fail("moe: non-finite logits")
    if out["sparse_lossless_drops"] or diff > LOGIT_REL_TOL * scale:
        fail(f"moe: sparse at lossless capacity vs dense: {out}")
    for layer in clf.model.layers:
        layer.feed_forward_moe.dispatch = "sparse"
        layer.feed_forward_moe.capacity_factor = 1.25
    capped, _, _, out["capacity_1_25_drops"] = run(clf)
    out["capacity_1_25_max_abs"] = float((capped - dense).abs().max())
    out["assignments"] = 2 * MOE_PROMPTS * S * cfg.n_layers
    del clf
    gc.collect()
    torch.cuda.empty_cache()
    # The same seed draws the same weights into the int8 model.
    q_cfg = dataclasses.replace(cfg, quant="int8")
    clf = LlamaZeroShotClassifier(config=q_cfg, device=dev, seed=0,
                                  max_prompt_len=1024)
    quant, _, _, _ = run(clf)
    out["int8_vs_float_max_abs"] = float((quant - sparse).abs().max())
    out["int8_argmax_agree"] = int((quant.argmax(-1)
                                    == sparse.argmax(-1)).sum())
    with _int8_experts_rolled():
        rolled, _, _, _ = run(clf)
    out["int8_experts_rolled_max_abs"] = float((rolled - sparse).abs().max())
    if (not torch.isfinite(quant).all()
            or out["int8_vs_float_max_abs"] > MOE_INT8_REL_TOL * scale):
        fail(f"moe int8: {out}")
    if out["int8_experts_rolled_max_abs"] <= MOE_INT8_REL_TOL * scale:
        fail(f"moe int8: the limit passes each expert's product taken with "
             f"its neighbour's weights: {out}")
    del clf
    gc.collect()
    torch.cuda.empty_cache()
    out["expert_product"] = check_expert_product(torch, dev)
    log(f"moe llama3_8b width, 2 layers x 8 experts on {card}: "
        f"{json.dumps(out)}")
    return out


SWEEP_COUNTS = (1, 2, 4)          # sweep --devices 1,2,4 on step 6's CSV
# The broken sweep: rank 1 of its 2-rank point runs the point's analyze,
# then exits 1, after its last collective and after leaving the group.
_SWEEP_LATE_RANK = r'''
import os, sys
from music_analyst_tpu_torch.engines.sweep import run_sweep
from music_analyst_tpu_torch.parallel import launch
dataset, out, cache = sys.argv[1:]
RANK = ("import os, sys\n"
        "from music_analyst_tpu_torch.cli.main import main\n"
        "main(sys.argv[1:])\n"
        "os._exit(1)\n")
launch.module_command = lambda argv: [sys.executable, "-c", RANK, *argv]
run_sweep(dataset, device_counts=[2], output_dir=out, ingest_backend="native",
          corpus_cache_dir=cache, device="cuda")
'''


def sweep_path(analyze, oracle, card) -> dict:
    """``sweep --devices 1,2,4`` as a process on step 6's CSV with a corpus
    cache (point 1 cold, the later points warm), each point above 1 a mesh
    of ranks on the one card over gloo: no skip line, each mesh named on
    stderr, each point's metrics with one ``per_chip`` row a rank and the
    corpus's songs, the np 4 point's CSVs equal to the oracle.  Then a
    2-rank point whose rank 1 exits 1 after its last collective must exit
    non-zero and publish neither its metrics nor a summary."""
    dataset, songs = analyze["dataset"], analyze["songs"]
    out_dir = os.path.join(WORK, "sweep")
    cache = os.path.join(WORK, "sweep_corpus_cache")
    for d in (out_dir, cache):
        shutil.rmtree(d, ignore_errors=True)
    counts = ",".join(map(str, SWEEP_COUNTS))
    t0 = time.perf_counter()
    proc = _cli(["sweep", dataset, "--devices", counts, "--ingest", "native",
                 "--corpus-cache-dir", cache, "--output-dir", out_dir])
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"sweep exited {proc.returncode}: {proc.stderr[-3000:]}")
    skips = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("skipping np=")]
    if skips:
        fail(f"sweep: skipped points {skips}")
    for n in SWEEP_COUNTS[1:]:
        if f"mesh: {n} ranks over gloo" not in proc.stderr:
            fail(f"sweep: no gloo mesh of {n} ranks named: "
                 f"{proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "sweep_summary.json")) as fh:
        summary = json.load(fh)
    if [r["devices"] for r in summary["runs"]] != list(SWEEP_COUNTS):
        fail(f"sweep: summary {summary}")
    points = {}
    for run in summary["runs"]:
        n = run["devices"]
        with open(os.path.join(out_dir, run["metrics_file"])) as fh:
            metrics = json.load(fh)
        if (metrics.get("processes") != n or len(metrics["per_chip"]) != n
                or metrics.get("device_platform") != "gpu"
                or {c["platform"] for c in metrics["per_chip"]} != {"gpu"}
                or metrics.get("total_songs") != songs):
            fail(f"sweep np={n}: metrics {json.dumps(metrics)[:600]}")
        points[n] = dict(wall_s=run["wall_seconds"],
                         speedup=run["speedup_vs_first"],
                         stages_s=metrics["stages"])
    if read_outputs(out_dir) != oracle:
        fail("sweep: the np 4 point's CSVs differ from the oracle")
    in_points = sum(p["wall_s"] for p in points.values())
    out = dict(process_wall_s=wall, points=points,
               outside_clock_s=wall - in_points, total_songs=songs)
    log(f"sweep --devices {counts} on {card}: "
        + ", ".join(f"np={n} {p['wall_s']:.3f} s (speedup {p['speedup']}x)"
                    for n, p in points.items())
        + f"; process {wall:.2f} s, of it {wall - in_points:.2f} s outside "
          f"the points' clocks (start-ups of the process and the ranks)")

    broken = os.path.join(WORK, "sweep_late_rank")
    shutil.rmtree(broken, ignore_errors=True)
    t0 = time.perf_counter()
    late = subprocess.run(
        [sys.executable, "-c", _SWEEP_LATE_RANK, dataset, broken, cache],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    late_wall = time.perf_counter() - t0
    left = sorted(os.listdir(broken)) if os.path.isdir(broken) else []
    staged = [e for e in os.listdir(WORK) if ".staging-" in e]
    if (late.returncode == 0 or "rank 1 exited with 1" not in late.stderr
            or "performance_metrics_np2.json" in left
            or "sweep_summary.json" in left or staged):
        fail(f"sweep with rank 1 exiting 1 late: rc {late.returncode}, "
             f"left {left}, staging {staged}: {late.stderr[-2000:]}")
    out["late_rank"] = dict(rc=late.returncode, wall_s=late_wall, left=left)
    log(f"sweep with rank 1 exiting 1 after its last collective: rc "
        f"{late.returncode} after {late_wall:.2f} s, left {left} (failed, as "
        f"it must)")
    return out


# ------------------------------------------ fault drills and WordPiece (step 11)

# The inverse of ``models/distilbert.py:load_hf_torch_checkpoint``'s
# renames: the port's parameter names to an HF DistilBERT state dict's.
_HF_NAMES = (
    ("encoder.word_embeddings.", "distilbert.embeddings.word_embeddings."),
    ("encoder.position_embeddings.",
     "distilbert.embeddings.position_embeddings."),
    ("encoder.embed_layer_norm.", "distilbert.embeddings.LayerNorm."),
    ("encoder.layers.", "distilbert.transformer.layer."),
    (".attention.q_proj.", ".attention.q_lin."),
    (".attention.k_proj.", ".attention.k_lin."),
    (".attention.v_proj.", ".attention.v_lin."),
    (".attention.o_proj.", ".attention.out_lin."),
)
DRILL_DELAY_S = 3.0          # the injected prefetch-stage stall ...
DRILL_WATCHDOG_S = 1.0       # ... against this watchdog timeout
WP_VOCAB_MAX = 30_522        # bert-base-uncased's vocabulary size
WP_BATCH = 4096              # the timed tokenization batch (8,192 before
                             # step 10's sweep over ranks)
WP_SONGS = WP_BATCH          # songs of each WordPiece run (one batch)
WP_EDGE_ROWS = [
    "", "   ", "the ελληνικά row", "爱 love 愛", "love 🎵 rain",
    "a\ud800b love", "naïve résumé søster ßüber", "[MASK] love [SEP]",
    "love " * 400,
]


def distilbert_split_checkpoint(torch, dev, texts, path) -> dict:
    """Write a full-width DistilBERT (seed 0, bf16 on the card) as an HF
    torch state dict (f32 tensors) whose classifier is rescaled so that,
    over ``texts``, the median of the logit gap sits at 0 and the median
    confidence at the neutral threshold: the labels split about 25%
    Negative, 50% Neutral, 25% Positive, where random weights label every
    song ``Positive``."""
    import math

    import numpy as np

    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
    )
    from music_analyst_tpu_torch.runtime.wire import to_device

    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", config=DistilBertConfig(attn_impl="flash"), seed=0,
        device=dev)
    ids, lens = clf.tokenizer.encode_batch(texts, clf.max_len)
    logits = clf.forward_logits(*to_device(
        [np.asarray(ids, np.int64), np.asarray(lens)], dev)).float()
    gap = logits[:, 1] - logits[:, 0]
    mid = float(gap.median())
    boundary = math.log(clf.neutral_threshold / (1 - clf.neutral_threshold))
    scale = boundary / max(float((gap - mid).abs().median()), 1e-6)
    head = clf.model.classifier
    with torch.no_grad():
        head.weight.mul_(scale)
        head.bias.mul_(scale)
        head.bias[1] -= scale * mid / 2
        head.bias[0] += scale * mid / 2
    state = {}
    for name, value in clf.model.state_dict().items():
        for ours, theirs in _HF_NAMES:
            name = name.replace(ours, theirs)
        state[name] = value.detach().float().cpu()
    torch.save(state, path)
    del clf, logits
    torch.cuda.empty_cache()
    return dict(path=path, gap_median=mid, head_scale=scale,
                bytes=os.path.getsize(path))


def _label_rows(out_dir):
    import csv

    with open(os.path.join(out_dir, "sentiment_details.csv"), newline="",
              encoding="utf-8") as fh:
        rows = [(r["artist"], r["song"], r["label"])
                for r in csv.DictReader(fh)]
    with open(os.path.join(out_dir, "sentiment_totals.json"), "rb") as fh:
        return rows, fh.read()


def _armed(spec):
    """Arm ``spec`` in this process with the retry stats zeroed."""
    from music_analyst_tpu_torch.resilience.faults import configure_faults
    from music_analyst_tpu_torch.resilience.policy import reset_retry_stats

    configure_faults(spec)
    reset_retry_stats()


def _drill_counters(manifest) -> dict:
    return {k: v for k, v in manifest.get("counters", {}).items()
            if k.startswith(("retry.", "failover.", "faults."))}


def fault_drills(torch, dev, card, dataset, analyze, oracle,
                 checkpoint) -> dict:
    """(a) The fault drills on the card, each against the same run without
    faults in this call: ``analyze`` (in process) with a transient ingest
    and a transient merge fault; ``analyze`` as a process with a
    persistent merge fault (non-zero exit, ``fault_injected``, one
    failover retry, no degrade, no output written); full-width
    DistilBERT ``run_sentiment`` with transient H2D and stage faults; the
    ``sentiment --mock`` CLI with a stage stalled past the watchdog; a
    ``weight_quant`` int8 load with transient load and H2D faults."""
    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.cli.main import main as cli_main
    from music_analyst_tpu_torch.engines.checkpoint import (
        load_quantized_params,
    )
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.engines.wordcount import run_analysis
    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
        iter_hf_param_units,
        param_shapes,
    )
    from music_analyst_tpu_torch.observability import watchdog
    from music_analyst_tpu_torch.observability.report import classify_error
    from music_analyst_tpu_torch.ops.quant import iter_tree
    from music_analyst_tpu_torch.resilience.faults import fault_stats

    report = {}

    # 1. analyze, transient ingest and merge faults, in process.
    spec = "ingest.read:error@1;collective.psum:error@1"
    out_dir = os.path.join(WORK, "drill_analyze")
    _armed(spec)
    t0 = time.perf_counter()
    try:
        run_analysis(analyze["dataset"], output_dir=out_dir,
                     ingest_backend="native", use_corpus_cache=False,
                     write_split=False, quiet=True, device=dev)
    finally:
        _armed(None)
    wall = time.perf_counter() - t0
    manifest = _manifest(out_dir)
    trips = {site: s["trips"]
             for site, s in manifest["resilience"]["faults"].items()}
    counters = _drill_counters(manifest)
    if read_outputs(out_dir) != oracle:
        fail("drill analyze: CSVs differ from the clean run's")
    if (trips != {"ingest.read": 1, "collective.psum": 1}
            or counters.get("retry.ingest.read.recovered") != 1
            or counters.get("failover.wordcount.device_compute.recoveries")
            != 1):
        fail(f"drill analyze: trips {trips}, counters {counters}")
    report["analyze_transient"] = dict(spec=spec, wall_s=wall, trips=trips,
                                       counters=counters,
                                       csvs_equal_clean=True)
    log(f"drill analyze ({spec}) on {card}: {json.dumps(report['analyze_transient'])}")

    # 2. analyze, persistent merge fault, as a process.
    spec = "collective.psum:error"
    out_dir = os.path.join(WORK, "drill_analyze_persistent")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = _cli(["analyze", analyze["dataset"], "--ingest", "native",
                 "--no-corpus-cache", "--no-split", "--output-dir", out_dir,
                 "--inject-faults", spec])
    wall = time.perf_counter() - t0
    manifest = _manifest(out_dir)
    counters = _drill_counters(manifest)
    with open(os.path.join(out_dir, "flight_record.json")) as fh:
        flight = json.load(fh)
    taxonomy = classify_error(flight.get("detail"))
    torn = [n for n in os.listdir(out_dir)
            if n.endswith(".csv") or ".tmp-" in n
            or n == "performance_metrics.json"]
    if (proc.returncode == 0 or taxonomy != "fault_injected"
            or counters.get("failover.wordcount.device_compute.retries") != 1
            or counters.get("failover.wordcount.device_compute.failed") != 1
            or "degraded" in manifest or torn):
        fail(f"drill analyze ({spec}): rc {proc.returncode}, taxonomy "
             f"{taxonomy}, counters {counters}, degraded "
             f"{manifest.get('degraded')}, files {torn}: "
             f"{proc.stderr[-1500:]}")
    report["analyze_persistent"] = dict(
        spec=spec, rc=proc.returncode, taxonomy=taxonomy, wall_s=wall,
        counters=counters, degraded=False, files_written=torn)
    log(f"drill analyze ({spec}, process) on {card}: "
        f"{json.dumps(report['analyze_persistent'])}")

    # 3. Full-width DistilBERT, transient H2D and stage faults.
    spec = "h2d.transfer:error@2;prefetch.stage:error@3"
    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", config=DistilBertConfig(attn_impl="flash"), seed=0,
        device=dev)
    clf.classify_batch(["warm up"] * 16)
    runs = {}
    for name, armed in (("clean", None), ("faulted", spec)):
        out_dir = os.path.join(WORK, f"drill_distilbert_{name}")
        _armed(armed)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            run_sentiment(dataset, backend=clf, output_dir=out_dir,
                          batch_size=BATCH, quiet=True)
            torch.cuda.synchronize()
        finally:
            _armed(None)
        runs[name] = dict(wall_s=time.perf_counter() - t0,
                          launches=kernels.launches()["flash_attention"],
                          out=_label_rows(out_dir),
                          manifest=_manifest(out_dir))
    faulted = runs["faulted"]
    trips = {site: s["trips"] for site, s in
             faulted["manifest"]["resilience"]["faults"].items()}
    counters = _drill_counters(faulted["manifest"])
    per_run = -(-N_SONGS // BATCH) * DistilBertConfig().n_layers
    if faulted["out"] != runs["clean"]["out"]:
        fail("drill distilbert: labels or totals differ from the clean run")
    if (trips != {"h2d.transfer": 1, "prefetch.stage": 1}
            or counters.get("retry.prefetch.stage.recovered", 0) < 1
            or faulted["launches"] != per_run
            or runs["clean"]["launches"] != per_run):
        fail(f"drill distilbert: trips {trips}, counters {counters}, flash "
             f"launches {faulted['launches']} (clean "
             f"{runs['clean']['launches']}, want {per_run})")
    report["distilbert"] = dict(
        spec=spec, trips=trips, counters=counters,
        launches=faulted["launches"], clean_launches=runs["clean"]["launches"],
        wall_s=faulted["wall_s"], clean_wall_s=runs["clean"]["wall_s"],
        labels_equal_clean=True)
    log(f"drill distilbert ({spec}) on {card}: {json.dumps(report['distilbert'])}")
    del clf
    torch.cuda.empty_cache()

    # 4. The --mock CLI with a stage stalled past the watchdog, in process.
    spec = f"prefetch.stage:delay={DRILL_DELAY_S:g}s@2"
    out_dir = os.path.join(WORK, "drill_mock_watchdog")
    shutil.rmtree(out_dir, ignore_errors=True)
    _armed(None)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli_main(["sentiment", dataset, "--mock", "--output-dir",
                       out_dir, "--watchdog-timeout", f"{DRILL_WATCHDOG_S:g}",
                       "--inject-faults", spec])
        torch.cuda.synchronize()
        trips_seen = list(watchdog.get_watchdog().trips)
        stage_trips = fault_stats()["prefetch.stage"]["trips"]
    finally:
        watchdog.stop_watchdog()
        _armed(None)
    wall = time.perf_counter() - t0
    launches = kernels.launches()["keyword_scan"]
    record_path = os.path.join(out_dir, "flight_record.json")
    names = ("sentiment_details.csv", "sentiment_totals.json")
    if rc != 0 or read_outputs(out_dir, names) != read_outputs(
            os.path.join(WORK, "mock"), names):
        fail(f"drill mock watchdog: rc {rc}, or outputs differ from the "
             "clean --mock CLI run")
    stalls = [t for t in trips_seen if t["taxonomy"] == "stage_stall"]
    if (stage_trips != 1 or not stalls
            or not stalls[0]["task"].startswith("pipeline.")
            or not os.path.exists(record_path)
            or launches != -(-N_SONGS // MOCK_BATCH)):
        fail(f"drill mock watchdog: fault trips {stage_trips}, watchdog "
             f"trips {trips_seen}, flight record "
             f"{os.path.exists(record_path)}, scan launches {launches}")
    with open(record_path) as fh:
        record = json.load(fh)
    if record.get("taxonomy") != "stage_stall":
        fail(f"drill mock watchdog: flight record taxonomy "
             f"{record.get('taxonomy')}")
    report["mock_watchdog"] = dict(
        spec=spec, watchdog_s=DRILL_WATCHDOG_S, wall_s=wall,
        watchdog_trips=trips_seen, launches=launches,
        flight_record=record_path, outputs_equal_clean=True)
    log(f"drill --mock watchdog ({spec}) on {card}: "
        f"{json.dumps(report['mock_watchdog'])}")

    # 5. weight_quant int8 load, transient load and H2D faults.
    spec = "checkpoint.load:error@2;h2d.transfer:error@3"
    shapes = param_shapes(DistilBertConfig())
    trees = {}
    for name, armed in (("clean", None), ("faulted", spec)):
        _armed(armed)
        t0 = time.perf_counter()
        try:
            tree = load_quantized_params(
                shapes, lambda: iter_hf_param_units(shapes, checkpoint,
                                                    mmap=True),
                "int8", device=dev)
            torch.cuda.synchronize()
            if armed:
                trips = {site: s["trips"] for site, s in fault_stats().items()}
        finally:
            _armed(None)
        leaves = {}
        for path, leaf in iter_tree(tree):
            if hasattr(leaf, "scheme"):
                leaves[path + "/q"], leaves[path + "/scale"] = leaf.q, leaf.scale
            else:
                leaves[path] = leaf
        trees[name] = (leaves, time.perf_counter() - t0)
    clean, faulted = trees["clean"][0], trees["faulted"][0]
    same = sorted(clean) == sorted(faulted) and all(
        clean[k].dtype == faulted[k].dtype and clean[k].device.type == "cuda"
        and torch.equal(clean[k], faulted[k]) for k in clean)
    if not same or trips != {"checkpoint.load": 1, "h2d.transfer": 1}:
        fail(f"drill weight_quant load: trees equal {same}, trips {trips}")
    report["wq_load"] = dict(spec=spec, trips=trips, leaves=len(clean),
                             load_s=trees["faulted"][1],
                             clean_load_s=trees["clean"][1],
                             bit_identical=True)
    log(f"drill weight_quant int8 load ({spec}) on {card}: "
        f"{json.dumps(report['wq_load'])}")
    del trees, clean, faulted
    torch.cuda.empty_cache()
    return report


def wordpiece_vocab(texts, path) -> dict:
    """A WordPiece vocabulary of at most ``WP_VOCAB_MAX`` entries: the
    specials, punctuation and digits, every one-, two- and three-letter
    piece (each letter and pair also as a ``##`` continuation), and every
    other word of the corpus whole, so the rest split into pieces."""
    import itertools
    import string

    from music_analyst_tpu_torch.models.tokenization import bert_basic_tokenize

    letters = string.ascii_lowercase
    words = sorted({w for t in texts[:512] for w in bert_basic_tokenize(t)})
    entries = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    entries += list(string.punctuation) + list(string.digits)
    for n in (1, 2, 3):
        grams = ["".join(p) for p in itertools.product(letters, repeat=n)]
        entries += grams + (["##" + g for g in grams] if n < 3 else [])
    known = set(entries)
    entries += [w for w in words[::2] if w not in known]
    if len(entries) > WP_VOCAB_MAX:
        fail(f"wordpiece vocab: {len(entries)} entries")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(entries) + "\n")
    return dict(path=path, entries=len(entries), corpus_words=len(words),
                whole_words=len(words[::2]))


class _RecordingTokenizer:
    """A tokenizer whose ``encode_batch`` calls are timed and kept."""

    def __init__(self, tokenizer) -> None:
        self.tokenizer = tokenizer
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.tokenizer, name)

    def encode_batch(self, texts, max_len):
        t0 = time.perf_counter()
        out = self.tokenizer.encode_batch(texts, max_len)
        self.calls.append((len(texts), time.perf_counter() - t0, out))
        return out


def wordpiece_path(torch, dev, card, dataset, checkpoint) -> dict:
    """(b) The native WordPiece fast path: a vocabulary built from the
    corpus, then full-width DistilBERT (step 9's checkpoint, whose labels
    split) ``run_sentiment`` over 4,096 of the songs under
    ``$MUSICAAL_BERT_VOCAB`` with the native tokenizer and with the Python
    one.  Every batch each run tokenized is kept: the native ids must
    equal the Python ids on every song (and on the edge rows, encoded
    apart), the native run's manifest must show every song on the native
    path, the labels must be identical; each run's first 4,096-song batch
    is its tokenizer's timed batch (in the pipeline's tokenize stage), and
    each run's songs/s is reported."""
    import numpy as np

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data import native
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.distilbert import (
        DistilBertClassifier,
        DistilBertConfig,
    )
    from music_analyst_tpu_torch.models.tokenization import (
        NativeWordPieceTokenizer,
        WordPieceTokenizer,
    )
    from music_analyst_tpu_torch.telemetry import get_telemetry

    texts = [t for _, _, t in iter_songs(dataset)]
    t0 = time.perf_counter()
    vocab = wordpiece_vocab(texts, os.path.join(WORK, "wordpiece_vocab.txt"))
    vocab["build_s"] = time.perf_counter() - t0
    py = WordPieceTokenizer(vocab["path"])
    os.environ["MUSICAAL_BERT_VOCAB"] = vocab["path"]
    try:
        clf = DistilBertClassifier.from_pretrained_or_random(
            "distilbert", config=DistilBertConfig(attn_impl="flash"),
            checkpoint_path=checkpoint, device=dev)
    finally:
        del os.environ["MUSICAAL_BERT_VOCAB"]
    nat = clf.tokenizer
    if not isinstance(nat, NativeWordPieceTokenizer) or nat._handle is None:
        fail(f"wordpiece: $MUSICAAL_BERT_VOCAB gave {type(nat)} (library: "
             f"{'on' if native.available() else native.unavailable_reason()})")

    # The edge rows, encoded apart: the Greek, CJK, emoji and surrogate
    # rows go to Python, the rest stay native.
    tel = get_telemetry()
    with tel.run_scope("wordpiece_edges", None):
        got = nat.encode_batch(WP_EDGE_ROWS, 128)
        edge_counters = {k: v for k, v in tel.counters.items()
                         if k.startswith("tokenizer.wordpiece.")}
    want = py.encode_batch(WP_EDGE_ROWS, 128)
    python_edge = 4
    if (not all(np.array_equal(g, w) for g, w in zip(got, want))
            or edge_counters != {
                "tokenizer.wordpiece.native_rows":
                    len(WP_EDGE_ROWS) - python_edge,
                "tokenizer.wordpiece.python_rows": python_edge}):
        fail(f"wordpiece: edge rows differ or counters {edge_counters}")

    clf.classify_batch(texts[:16])
    runs = {}
    for name, tok in (("native", nat), ("python", py)):
        clf.tokenizer = recording = _RecordingTokenizer(tok)
        out_dir = os.path.join(WORK, f"wordpiece_{name}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run_sentiment(dataset, backend=clf, output_dir=out_dir,
                               batch_size=WP_BATCH, quiet=True, limit=WP_SONGS)
        torch.cuda.synchronize()
        runs[name] = dict(wall_s=time.perf_counter() - t0,
                          songs_per_s=result.songs_per_second,
                          launches=kernels.launches()["flash_attention"],
                          out=_label_rows(out_dir), calls=recording.calls,
                          counters=_manifest(out_dir)["counters"])
    ids = {name: [np.concatenate([c[2][i] for c in r["calls"]])
                  for i in (0, 1)] for name, r in runs.items()}
    if not (ids["native"][0].shape[0] == WP_SONGS and all(
            np.array_equal(a, b) for a, b in zip(ids["native"],
                                                 ids["python"]))):
        bad = int((ids["native"][0] != ids["python"][0]).any(axis=1).sum())
        fail(f"wordpiece: native ids differ from Python's on {bad} songs")
    counters = {k: v for k, v in runs["native"]["counters"].items()
                if k.startswith("tokenizer.wordpiece.")}
    if counters != {"tokenizer.wordpiece.native_rows": WP_SONGS,
                    "tokenizer.wordpiece.python_rows": 0}:
        fail(f"wordpiece: the native run's row counters are {counters}")
    if runs["native"]["out"] != runs["python"]["out"]:
        fail("wordpiece: labels differ between the native and Python runs")
    if min(r["launches"] for r in runs.values()) == 0:
        fail(f"wordpiece: flash launches {[r['launches'] for r in runs.values()]}")
    batch = {name: r["calls"][0] for name, r in runs.items()}
    if batch["native"][0] != WP_BATCH or batch["python"][0] != WP_BATCH:
        fail(f"wordpiece: first batches of {batch['native'][0]} and "
             f"{batch['python'][0]} songs")
    totals = json.loads(runs["native"]["out"][1])
    del clf
    torch.cuda.empty_cache()
    out = dict(
        vocab={k: v for k, v in vocab.items() if k != "path"},
        songs=len(texts), edge_rows=len(WP_EDGE_ROWS),
        edge_counters=edge_counters, counters=counters,
        unk_ids=int((ids["native"][0] == py.unk_id).sum()), ids_equal=True,
        native_threads=max(4, os.cpu_count() or 1),
        batch=dict(songs=WP_BATCH, native_s=batch["native"][1],
                   python_s=batch["python"][1],
                   native_songs_per_s=WP_BATCH / batch["native"][1],
                   python_songs_per_s=WP_BATCH / batch["python"][1],
                   speedup=batch["python"][1] / batch["native"][1]),
        run_sentiment={name: {k: r[k] for k in ("wall_s", "songs_per_s",
                                                 "launches")}
                       for name, r in runs.items()},
        totals=totals, labels_equal=True)
    log(f"wordpiece on {card}: {json.dumps(out)}")
    return out


# --- step 12: multi-process runs on the one card ---------------------------

DIST_NPS = (2, 4)              # the reference's run_performance.sh sweep
                               # (np 1 too before step 10's sweep over
                               # ranks, which runs it as one process)
RING_RANKS = 4
RING_SEQ = 32_768              # 8,192 positions a rank
RING_HEADS, RING_KV_HEADS, RING_HEAD_DIM = 32, 8, 128   # Llama-3-8B attention
# Five packed documents of uneven length; the second and the fourth cross
# a rank boundary (8,192 and 24,576), the third ends on one.
RING_DOC_BOUNDS = (0, 6_000, 13_000, 16_384, 29_000, RING_SEQ)
RING_REPEATS = 2               # timed ring calls per case (3 until step 13)
RING_WINDOW = 64               # rows per window held against the f32 plain version
RING_WINDOWS = 4               # windows per rank: 256 sampled query rows
RANKS_TIMEOUT_S = 300
#  - ring output (bf16) against the whole-sequence flash kernel (bf16): each
#    is one rounding to bf16 of an f32 result that differs from the other
#    only in the order of its f32 sums, so the two may differ by a whole
#    bf16 ulp: the elementwise limit is twice check_flash's, 2 x 2^-8 |ref|
#    + 1e-5, beside check_flash's absolute limit FLASH_BF16_TOL.  Against the
#    f32 plain version the ring output is held to check_flash's limits.
RING_VS_FLASH_REL = 2 * FLASH_BF16_REL

_WORDCOUNT_CHILD = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dataset, out, broken_out = sys.argv[4], sys.argv[5], sys.argv[6]
import torch
from music_analyst_tpu_torch.parallel import distributed, multihost
from music_analyst_tpu_torch.telemetry import get_telemetry
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo", timeout_s=300)
torch.zeros(1, device=f"cuda:{rank % torch.cuda.device_count()}")  # context first
multihost.barrier("start")
t0 = time.perf_counter()
result = distributed.distributed_wordcount(dataset, out, device="cuda")
wall = time.perf_counter() - t0
tel = get_telemetry()
report = dict(rank=rank, backend=multihost.backend(),
              device=f"cuda:{rank % torch.cuda.device_count()}", result=result,
              wall_s=wall, spans_s={k: v[1] for k, v in tel.span_aggregates.items()
                                    if k.startswith("distributed.")},
              collective_bytes=tel.counters.get("collectives.total_bytes", 0))
if broken_out != "-":
    # Broken variant: the last rank's slice starts one record late.
    from music_analyst_tpu_torch.data.csv_io import iter_csv_records_exact
    original = distributed._my_record_range
    def shifted(path):
        blob, count = original(path)
        if rank == n - 1:
            records = list(iter_csv_records_exact(blob))
            blob, count = records[0] + b"".join(records[2:]), count - 1
        return blob, count
    distributed._my_record_range = shifted
    distributed.distributed_wordcount(dataset, broken_out, device="cuda")
print("RESULT " + json.dumps(report), flush=True)
multihost.shutdown()
'''

_RING_CHILD = r'''
import hashlib, json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import torch
import chip_smoke as cs
from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.ops import ring_attention as ra
from music_analyst_tpu_torch.parallel import multihost
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo", timeout_s=300)
dev = torch.device("cuda", rank % torch.cuda.device_count())
torch.cuda.set_device(dev)
q, k, v, seg = cs.ring_inputs(torch, dev)
S_loc = q.shape[1] // n
mine = slice(rank * S_loc, (rank + 1) * S_loc)
segments = {"causal": None, "packed": seg}
report = dict(rank=rank, backend=multihost.backend(), device=str(dev), cases={})

def call(case):
    return ra.ring_attention(q, k, v, causal=True, use_flash=True,
                             segment_ids=segments[case])

def save(out, name):
    torch.save(out[:, mine].cpu(), os.path.join(work, f"{name}_rank{rank}.pt"))

with torch.no_grad():
    call("causal")                       # warm-up: the kernel's library loads
    for case in segments:
        times, launches = [], []
        for _ in range(cs.RING_REPEATS):
            multihost.barrier("call")
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = call(case)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(kernels.launches()["flash_attention"])
        if not torch.isfinite(out.float()).all():
            raise SystemExit(f"rank {rank}: non-finite ring output ({case})")
        save(out, case)
        digest = hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes())
        # The hop's transfer alone: the same bytes through one rotate and
        # the copy onto the card, every rank at once.
        blocks = [k[:, mine], v[:, mine]] + ([seg[:, mine]] if case == "packed" else [])
        nbytes = sum(t.numel() * t.element_size() for t in blocks)
        cur = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        nxt = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        transfer = []
        for _ in range(cs.RING_REPEATS):
            multihost.barrier("rotate")
            t0 = time.perf_counter()
            for req in ra.rotate(cur, nxt):
                req.wait()
            nxt.to(dev)
            torch.cuda.synchronize()
            transfer.append((time.perf_counter() - t0) * 1e3)
        # The output's all-gather alone, as ring_attention stages it: this
        # rank's shard to the host, the gather, the whole output onto the card.
        shard = out[:, mine].contiguous().view(torch.uint8)
        gather = []
        for _ in range(cs.RING_REPEATS):
            multihost.barrier("gather")
            t0 = time.perf_counter()
            rows = shard.cpu()
            parts = [torch.empty_like(rows) for _ in range(n)]
            torch.distributed.all_gather(parts, rows)
            torch.cat(parts, dim=1).to(dev)
            torch.cuda.synchronize()
            gather.append((time.perf_counter() - t0) * 1e3)
        report["cases"][case] = dict(
            call_ms=statistics.median(times), call_ms_all=times,
            launches=launches, sha256=digest.hexdigest(), hop_bytes=nbytes,
            transfer_ms_per_hop=statistics.median(transfer),
            gather_ms=statistics.median(gather))
    # Kernel device time per hop inside the ring (the card is shared).
    from torch.profiler import ProfilerActivity, profile
    multihost.barrier("profile")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call("causal")
        torch.cuda.synchronize()
    flash = sum(ms for name, ms in cs.device_kernel_ms(prof).items()
                if "flash" in name)
    report["kernel_ms_per_hop"] = flash / n if flash else None
    # Broken ring: after `step` rotations it takes owner = idx + step.
    original = ra.flash_attention
    def wrong_owner(*args, q_offset, kv_offset, **kw):
        idx, owner = q_offset // S_loc, kv_offset // S_loc
        return original(*args, q_offset=q_offset,
                        kv_offset=((2 * idx - owner) % n) * S_loc, **kw)
    ra.flash_attention = wrong_owner
    save(call("causal"), "broken")
    ra.flash_attention = original
print("RESULT " + json.dumps(report), flush=True)
multihost.shutdown()
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, n: int, args, tag: str) -> list:
    """``n`` processes of ``script`` (written to ``WORK/<tag>.py``) as ranks
    of one gloo group on a free port; returns each rank's ``RESULT`` JSON.
    The moment one rank fails, or the deadline passes, every rank still
    running is killed and the run fails."""
    path = os.path.join(WORK, f"{tag}.py")
    with open(path, "w") as fh:
        fh.write(script)
    port = str(_free_port())
    logs, procs = [], []
    try:
        for rank in range(n):
            logs.append(open(os.path.join(WORK, f"{tag}_rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, path, str(rank), str(n), port, *args],
                cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        deadline = time.perf_counter() + RANKS_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.05)
        for rank, p in enumerate(procs):
            if p.poll() != 0:
                logs[rank].seek(0)
                fail(f"{tag}: rank {rank} of {n} exited {p.poll()} "
                     f"(None: killed at the deadline):\n"
                     f"{logs[rank].read()[-3000:]}")
        results = []
        for log_fh in logs:
            log_fh.seek(0)
            lines = [ln for ln in log_fh.read().splitlines()
                     if ln.startswith("RESULT ")]
            if len(lines) != 1:
                fail(f"{tag}: a rank printed {len(lines)} RESULT lines")
            results.append(json.loads(lines[0][len("RESULT "):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log_fh in logs:
            log_fh.close()


def distributed_wordcount_path(card, analyze, oracle) -> dict:
    """The distributed word count at np 2 and 4 on the one card over
    gloo, on step 6's 57,650-song CSV: CSVs byte-identical to the
    single-process ``analyze`` output and the ``np.bincount`` oracle,
    every rank's totals equal, one ``per_chip`` row per process; at np 2,
    a variant whose last rank starts one record late must break the
    bytes."""
    dataset = analyze["dataset"]
    single = read_outputs(os.path.join(WORK, "analyze_auto_streaming"))
    if single != oracle:
        fail("distributed: the single-process analyze output differs from "
             "the oracle")
    report = {}
    for n in DIST_NPS:
        out = os.path.join(WORK, f"distributed_np{n}")
        broken = os.path.join(WORK, f"distributed_np{n}_broken")
        for d in (out, broken):
            shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        ranks = run_ranks(_WORDCOUNT_CHILD, n,
                          [dataset, out, broken if n == 2 else "-"],
                          f"wordcount_np{n}")
        launch_s = time.perf_counter() - t0
        if read_outputs(out) != oracle:
            fail(f"distributed np {n}: CSVs differ from the single-process "
                 "analyze output and the oracle")
        want = dict(processes=n, total_songs=analyze["songs"],
                    total_words=analyze["tokens"])
        if any(r["result"] != want for r in ranks):
            fail(f"distributed np {n}: rank totals {[r['result'] for r in ranks]}"
                 f" != {want}")
        with open(os.path.join(out, "performance_metrics.json")) as fh:
            metrics = json.load(fh)
        if (metrics["processes"] != n or metrics["device_platform"]
                != "multi-controller"
                or [c["process"] for c in metrics["per_chip"]] != list(range(n))):
            fail(f"distributed np {n}: metrics say {json.dumps(metrics)}")
        if n == 2 and read_outputs(broken) == oracle:
            fail("distributed: a rank starting one record late still writes "
                 "the oracle's bytes")
        wall = max(r["wall_s"] for r in ranks)
        report[f"np{n}"] = dict(
            backend=sorted({r["backend"] for r in ranks}),
            devices=sorted({r["device"] for r in ranks}),
            wall_s=wall, songs_per_s=analyze["songs"] / wall,
            compute_s=metrics["compute_time"], launch_s=launch_s,
            all_reduce_s=max(r["spans_s"].get("distributed.all_reduce", 0.0)
                             for r in ranks),
            spans_s=[r["spans_s"] for r in ranks],
            collective_bytes_per_rank=ranks[0]["collective_bytes"])
        log(f"distributed word count np {n} on {card} "
            f"({report[f'np{n}']['backend']}, {report[f'np{n}']['devices']}): "
            f"{json.dumps(report[f'np{n}'])}")
    report["broken_variant"] = ("np 2, last rank one record late: CSVs "
                                "differ from the oracle (check failed)")
    return report


def ring_inputs(torch, dev):
    """q [1, S, 32, 128], k/v [1, S, 8, 128] bf16 from a seeded generator on
    the card (every process draws the same numbers), and the packed case's
    segment ids [1, S] int32."""
    gen = torch.Generator(device=dev).manual_seed(29)
    shape = (1, RING_SEQ)
    q = torch.randn(*shape, RING_HEADS, RING_HEAD_DIM, generator=gen,
                    device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(*shape, RING_KV_HEADS, RING_HEAD_DIM, generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    seg = torch.empty(shape, dtype=torch.int32, device=dev)
    for doc, (lo, hi) in enumerate(zip(RING_DOC_BOUNDS, RING_DOC_BOUNDS[1:])):
        seg[:, lo:hi] = doc + 1
    return q, k, v, seg


def ring_hop_timing(torch, q, k, v) -> dict:
    """Kernel 2 at one full ring hop: q [1, 8192, 32, 128] against the
    8,192 keys before it (causal with offsets, so no pair is masked),
    residual mode; beside the plain version, SDPA without residuals and
    the bound, on the card alone."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    S_loc = RING_SEQ // RING_RANKS
    qh = q[:, S_loc:2 * S_loc].contiguous()
    kh, vh = k[:, :S_loc].contiguous(), v[:, :S_loc].contiguous()
    kw = dict(causal=True, q_offset=S_loc, kv_offset=0, return_residuals=True)
    with torch.no_grad():
        ms = time_ms(torch, lambda: flash_attention(qh, kh, vh, **kw), 20)
        plain_ms = time_ms(torch, lambda: flash_attention_reference(
            qh, kh, vh, **kw), 1)
        torch.cuda.empty_cache()
        qt, kt, vt = (t.transpose(1, 2) for t in (qh, kh, vh))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), 20)
    H, D = RING_HEADS, RING_HEAD_DIM
    # q, k, v read once; o (f32), m and l written once.
    bytes_moved = (S_loc * H * D * 2 + 2 * S_loc * RING_KV_HEADS * D * 2
                   + S_loc * H * D * 4 + 2 * S_loc * H * 4)
    flops = 4.0 * H * D * S_loc * S_loc
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    return dict(shape=f"q bf16 [1,{S_loc},{H},{D}] vs {S_loc} keys "
                      f"[1,{S_loc},{RING_KV_HEADS},{D}], residual mode",
                ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=bytes_moved, flops=flops)


def ring_path(torch, dev, card) -> dict:
    """Ring attention over 4 ranks on the one card (gloo, host-staged hops)
    at Llama-3-8B's attention width, S = 32,768, causal and causal +
    packed: each rank's output against the whole-sequence flash kernel
    (bf16) and the f32 plain version on 256 sampled query rows, 4 kernel-2
    launches a rank a call, a ring with the wrong owner must fail; then
    the hop's kernel time beside its bound and SDPA."""
    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from music_analyst_tpu_torch.profiling.collectives import ppermute_bytes

    q, k, v, seg = ring_inputs(torch, dev)
    S_loc = RING_SEQ // RING_RANKS
    with torch.no_grad():
        whole = {"causal": flash_attention(q, k, v, causal=True),
                 "packed": flash_attention(q, k, v, causal=True,
                                           q_segment_ids=seg)}
        whole_ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True),
                           5)
    torch.cuda.synchronize()
    ranks = run_ranks(_RING_CHILD, RING_RANKS, [WORK], "ring")
    kf, vf = k.float(), v.float()
    gen = torch.Generator().manual_seed(31)
    errors = {}
    with torch.no_grad():
        for case, segments in (("causal", None), ("packed", seg)):
            digests = {r["cases"][case]["sha256"] for r in ranks}
            if len(digests) != 1:
                fail(f"ring {case}: the ranks gathered different outputs")
            for r in ranks:
                launches = r["cases"][case]["launches"]
                if launches != [RING_RANKS] * RING_REPEATS:
                    fail(f"ring {case}: rank {r['rank']} launched kernel 2 "
                         f"{launches} times a call, not {RING_RANKS}")
            errs = []
            for rank in range(RING_RANKS):
                got = torch.load(os.path.join(WORK, f"{case}_rank{rank}.pt")).to(dev)
                lo = rank * S_loc
                abs_err, scaled = flash_errors(
                    got, whole[case][:, lo:lo + S_loc].float(), RING_VS_FLASH_REL)
                if abs_err > FLASH_BF16_TOL or scaled > 1.0:
                    fail(f"ring {case} rank {rank}: vs whole-sequence flash: "
                         f"max abs err {abs_err}, {scaled} x the bf16 bound")
                starts = [0, S_loc - RING_WINDOW] + torch.randint(
                    1, S_loc - RING_WINDOW, (RING_WINDOWS - 2,),
                    generator=gen).tolist()
                plain = []
                for s in starts:
                    rows = slice(lo + s, lo + s + RING_WINDOW)
                    seg_kw = ({} if segments is None else dict(
                        q_segment_ids=segments[:, rows], kv_segment_ids=segments))
                    ref = flash_attention_reference(
                        q[:, rows].float(), kf, vf, causal=True,
                        q_offset=lo + s, **seg_kw)
                    plain.append(check_flash_output(
                        torch, f"ring {case} rank {rank} rows {lo + s}",
                        got[:, s:s + RING_WINDOW], ref))
                errs.append(dict(vs_flash=abs_err, vs_flash_scaled=scaled,
                                 vs_plain=max(plain)))
            errors[case] = errs
        failed = []
        for rank in range(RING_RANKS):
            got = torch.load(os.path.join(WORK, f"broken_rank{rank}.pt")).to(dev)
            lo = rank * S_loc
            abs_err, scaled = flash_errors(
                got, whole["causal"][:, lo:lo + S_loc].float(), RING_VS_FLASH_REL)
            failed.append(abs_err > FLASH_BF16_TOL or scaled > 1.0)
        if not any(failed):
            fail("ring: a ring that takes owner = idx + step passes the limits")
    del whole, kf, vf
    torch.cuda.empty_cache()
    hop = ring_hop_timing(torch, q, k, v)
    hop["max_abs_err"] = max(e["vs_plain"] for errs in errors.values()
                             for e in errs)
    del q, k, v, seg
    torch.cuda.empty_cache()
    kv_bytes = 2 * S_loc * RING_KV_HEADS * RING_HEAD_DIM * 2
    report = dict(
        shape=f"B=1, S={RING_SEQ} over {RING_RANKS} ranks, H={RING_HEADS}, "
              f"Hkv={RING_KV_HEADS}, D={RING_HEAD_DIM}, bf16, use_flash",
        backend=sorted({r["backend"] for r in ranks}),
        devices=sorted({r["device"] for r in ranks}),
        errors=errors, broken_ranks_failing=failed,
        whole_sequence_flash_ms=whole_ms, hop=hop,
        kernel_ms_per_hop=[r["kernel_ms_per_hop"] for r in ranks],
        launches_per_rank=[r["cases"]["causal"]["launches"][0] for r in ranks],
        cases={case: dict(
            ms_per_call=max(r["cases"][case]["call_ms"] for r in ranks),
            ms_per_call_by_rank=[r["cases"][case]["call_ms"] for r in ranks],
            transfer_ms_per_hop=max(r["cases"][case]["transfer_ms_per_hop"]
                                    for r in ranks),
            output_gather_ms=max(r["cases"][case]["gather_ms"] for r in ranks),
            bytes_per_hop=ppermute_bytes(
                kv_bytes + (S_loc * 4 if case == "packed" else 0)),
            measured_hop_bytes=ranks[0]["cases"][case]["hop_bytes"])
            for case in ("causal", "packed")})
    for case, row in report["cases"].items():
        if row["bytes_per_hop"] != row["measured_hop_bytes"]:
            fail(f"ring {case}: {row['measured_hop_bytes']} bytes a hop, "
                 f"accounted {row['bytes_per_hop']}")
    log(f"ring attention on {card}: {json.dumps(report)}")
    return report


# --- step 13: meshes over ranks on the one card ------------------------------

MESH_ANALYZE_RUNS = {            # analyze --devices N on step 6's corpus
    "d2": ["--devices", "2"],
    "d4": ["--devices", "4"],
    "d2_chunk_4096": ["--devices", "2", "--chunk-songs", "4096"],
}
MESH_API_ROWS = 2048             # DistilBERT API check: songs per forward
MESH_BROKEN_ROWS = 512           # rows the broken variants run on
#  - DistilBERT labels, --devices 2 vs one device: equal except on songs
#    whose one-device confidence lies within 1e-2 of the neutral
#    threshold (the only label boundary a song can cross: both classes
#    below it are Neutral); the tp all-reduces add bf16 roundings.
MESH_BOUNDARY_TOL = 1e-2
#  - whole-model logits on a mesh vs one rank: the tp partial products
#    are rounded to bf16 and summed in another order (LOGIT_REL_TOL, 5e-2
#    of the logit scale, for DistilBERT; LLAMA_LOGIT_REL_TOL for Llama).

_MESH_BERT_CHILD = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
rank, n, port, work, ckpt, texts_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
    sys.argv[6])
import torch
import torch.nn.functional as F
import chip_smoke as cs
from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.models import layers
from music_analyst_tpu_torch.models.distilbert import DistilBertClassifier
from music_analyst_tpu_torch.parallel import mesh as M, multihost
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo", timeout_s=300)
grid = M.build_mesh(M.MeshSpec((("dp", 2), ("tp", 2))))
dev = grid.device
torch.cuda.set_device(dev)
# dp1 x tp2: this rank's tp line of the grid as a mesh of its own (both
# lines compute the same rows; rank 0's is kept).
line = [grid.coord("dp") * 2 + t for t in range(2)]
tp_only = M.DeviceMesh(tuple(grid.devices[r] for r in line),
                       (("dp", 1), ("tp", 2)), grid.coord("tp"),
                       {"tp": grid.group("tp")})
with open(texts_path) as fh:
    texts = json.load(fh)
few = texts[:cs.MESH_BROKEN_ROWS]
report = dict(rank=rank, backend=multihost.backend(), device=str(dev),
              coords=grid.coords, layouts={})

def early_bias(self, x):
    return layers.all_reduce(F.linear(x, self.weight, self.bias), self.mesh,
                             self.axis)

for tag, mesh in (("dp2xtp2", grid), ("dp1xtp2", tp_only)):
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", checkpoint_path=ckpt, mesh=mesh)
    init_s = time.perf_counter() - t0
    clf.classify_logits(texts[:64])                  # warm-up
    multihost.barrier("api")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    good = clf.classify_logits(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    # Broken: the row-parallel bias added on every rank before the reduce.
    original = layers.RowParallelLinear.forward
    layers.RowParallelLinear.forward = early_bias
    bias_early = clf.classify_logits(few)
    layers.RowParallelLinear.forward = original
    # Broken: each rank holds the next tp rank's q/k/v head block.
    tp, me = mesh.axis_size("tp"), mesh.coord("tp")
    with torch.no_grad():
        for layer in clf.model.encoder.layers:
            att = layer.attention
            for proj in (att.q_proj, att.k_proj, att.v_proj):
                for p in (proj.weight, proj.bias):
                    p.copy_(M.all_gather(p[None], mesh, "tp")[(me + 1) % tp])
    heads_swapped = clf.classify_logits(few)
    if rank == 0:
        torch.save(dict(good=good, bias_early=bias_early,
                        heads_swapped=heads_swapped),
                   os.path.join(work, f"mesh_bert_{tag}.pt"))
    att = clf.model.encoder.layers[0].attention
    report["layouts"][tag] = dict(
        init_s=init_s, forward_s=wall, launches=launches,
        q_shape=[len(texts) // mesh.axis_size("dp"), clf.max_len,
                 att.n_heads, att.head_dim],
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    del clf
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(report), flush=True)
multihost.shutdown()
'''

_MESH_LLAMA_CHILD = r'''
import dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
rank, n, port, work, songs_csv = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
import torch
import chip_smoke as cs
from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.data.csv_io import iter_songs
from music_analyst_tpu_torch.models import layers
from music_analyst_tpu_torch.models.llama import (
    LYRICS_TRUNCATION, PROMPT_TEMPLATE, LlamaConfig, LlamaZeroShotClassifier)
from music_analyst_tpu_torch.parallel import mesh as M, multihost
from music_analyst_tpu_torch.utils.labels import SUPPORTED_LABELS
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo", timeout_s=300)
mesh = M.build_mesh(M.MeshSpec((("tp", n),)))
dev = mesh.device
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False     # f32 lm_head stays f32
cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=cs.LLAMA_LAYERS)
report = dict(rank=rank, backend=multihost.backend(), device=str(dev),
              coords=mesh.coords)
multihost.barrier("init")
torch.cuda.reset_peak_memory_stats(dev)
t0 = time.perf_counter()
clf = LlamaZeroShotClassifier(config=cfg, max_prompt_len=cs.PAGED_REGION,
                              mesh=mesh, seed=0, decode_mode="score")
torch.cuda.synchronize()
report["init_s"] = time.perf_counter() - t0
report["weights_bytes"] = sum(p.numel() * p.element_size()
                              for p in clf.model.parameters())
report["init_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
texts = [t for _, _, t in iter_songs(songs_csv)]
prompts = [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
           for t in texts]

multihost.barrier("score")
t0 = time.perf_counter()
# classify_batch's score mode, keeping the scores: one pass.
scored = texts[:cs.LLAMA_SCORE_SONGS]
ids, lens = clf._encode_prompts(scored)
scores = clf.score_labels(clf._tensor(ids), clf._tensor(lens)).float().cpu()
labels = ["Neutral" if not t.strip() else SUPPORTED_LABELS[int(i)]
          for t, i in zip(scored, scores.argmax(dim=1))]
score_s = time.perf_counter() - t0
report["score"] = dict(labels=labels, scores=scores.tolist(), wall_s=score_s,
                       songs_per_s=cs.LLAMA_SCORE_SONGS / score_s)

# Step 5's scheduler state: the 8 prompts prefilled (8 slots, page 16,
# region 1,024).  A prefill's greedy token can flip on a near-tie (bf16
# sums in another order), so the logit check carries tp 1's tokens.
multihost.barrier("prefill")
torch.cuda.synchronize()
reqs = []
t0 = time.perf_counter()
sched = cs._active_scheduler(torch, clf, prompts, reqs)
torch.cuda.synchronize()
prefill_s = time.perf_counter() - t0
saved = torch.load(os.path.join(work, "llama_tp1_decode_logits.pt"))
ref = saved["logits"]
mine = [int(s.carry) for s in sched._slots]
report["prefill_tokens_equal"] = sum(a == b for a, b in zip(mine, saved["tokens"]))
for s, t in zip(sched._slots, saved["tokens"]):
    s.carry = t
logits = cs.decode_step_logits(torch, clf, sched).float().cpu()
report["decode_logits"] = dict(
    max_abs_diff=float((logits - ref).abs().max()),
    scale=float(ref.abs().max()),
    argmax_agree=int((logits.argmax(-1) == ref.argmax(-1)).sum()),
    rows=int(ref.shape[0]))
# Broken: every rank's pool holds the next rank's KV heads; the pools
# are put back afterwards.
pools = [p for c in sched.caches for p in (c.keys, c.values)]
kept = [p.clone() for p in pools]
with torch.no_grad():
    for pool in pools:
        pool.copy_(M.all_gather(pool[None], mesh, "tp")[(rank + 1) % n])
bad = cs.decode_step_logits(torch, clf, sched).float().cpu()
report["other_ranks_kv"] = dict(max_abs_diff=float((bad - ref).abs().max()))
with torch.no_grad():
    for pool, copy in zip(pools, kept):
        pool.copy_(copy)
del kept
for s, t in zip(sched._slots, mine):
    s.carry = t

# One decode dispatch (decode_span steps): its wall, then again with the
# tp collectives timed between synchronisations.  Both rewrite decode rows
# that the scheduler writes again, with the same tokens, below.
x = cs._step_inputs(torch, sched)
args = (x["table"], x["tokens"], x["plens"], x["steps"], x["budgets"],
        x["done"], x["active"])
multihost.barrier("dispatch")
torch.cuda.synchronize()
t0 = time.perf_counter()
sched.runtime.decode_step(sched.caches, *args)
torch.cuda.synchronize()
dispatch_ms = (time.perf_counter() - t0) * 1e3
spent, calls = [0.0], [0]
def timed(fn):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        calls[0] += 1
        return out
    return run
plain = layers.all_reduce, layers.all_gather
layers.all_reduce, layers.all_gather = timed(plain[0]), timed(plain[1])
multihost.barrier("dispatch_timed")
torch.cuda.synchronize()
t0 = time.perf_counter()
sched.runtime.decode_step(sched.caches, *args)
torch.cuda.synchronize()
timed_ms = (time.perf_counter() - t0) * 1e3
layers.all_reduce, layers.all_gather = plain
steps = sched.plan.decode_span
report["dispatch"] = dict(
    steps=steps, ms=dispatch_ms, ms_per_step=dispatch_ms / steps,
    timed_ms=timed_ms, collective_ms=spent[0] * 1e3,
    collective_calls=calls[0],
    collective_share=spent[0] * 1e3 / timed_ms)

# Generate mode: the scheduler decodes its 8 prompts to their texts
# through the paged kernel.
multihost.barrier("generate")
torch.cuda.synchronize()
kernels.reset_launches()
t0 = time.perf_counter()
sched.run_until_idle()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
st = sched.stats()
report["generate"] = dict(
    texts=[r.response["text"] for r in reqs], wall_s=prefill_s + wall,
    launches=kernels.launches(), songs_per_s=len(reqs) / (prefill_s + wall),
    decode_steps=st["decode_steps"], tokens_generated=st["tokens_generated"],
    prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_seconds"],
    decode_tokens_per_s=st["tokens_generated"] / st["decode_seconds"],
    ms_per_decode_step=st["decode_seconds"] / st["decode_steps"] * 1e3)
report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
report["kv_heads"] = clf.kv_heads
report["pool_shape"] = list(sched.caches[0].keys.shape)
print("RESULT " + json.dumps(report), flush=True)
multihost.shutdown()
'''


def mesh_cli(args, env_extra=None, timeout=900):
    """One ``python -m music_analyst_tpu_torch`` mesh run (rank 0, which
    launches the others); returns the process, its wall and each rank's
    kernel launches from its stderr."""
    cmd = [sys.executable, "-m", "music_analyst_tpu_torch", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ,
                                                    **(env_extra or {})))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{' '.join(args[:1] + args[2:])}: rc {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    launches = {}
    for line in proc.stderr.splitlines():
        # The ranks share one stderr: a line may carry another writer's
        # text (a library warning) before or after it.
        found = re.search(r"mesh: rank (\d+) kernel launches (\{[^{}]*\})",
                          line)
        if found:
            launches[int(found.group(1))] = json.loads(found.group(2))
    return proc, wall, launches


def mesh_analyze_path(card, analyze, oracle) -> dict:
    """``analyze --devices N`` (the CLI launching its ranks, all on the
    one card over gloo) on step 6's corpus: CSVs byte-identical to step
    6's analyze output and the oracle; one ``per_chip`` row per rank; the
    manifest names the mesh and its backend."""
    dataset = analyze["dataset"]
    songs = analyze["songs"]
    out = {}
    for name, flags in MESH_ANALYZE_RUNS.items():
        out_dir = os.path.join(WORK, f"mesh_analyze_{name}")
        proc, wall, _ = mesh_cli(["analyze", dataset, "--ingest", "native",
                                  "--no-corpus-cache", "--output-dir",
                                  out_dir, *flags])
        n = int(flags[1])
        if f"mesh: {n} ranks over gloo" not in proc.stderr:
            fail(f"mesh analyze {name}: no gloo mesh of {n} ranks named")
        if read_outputs(out_dir) != oracle:
            fail(f"mesh analyze {name}: CSVs differ from the oracle")
        with open(os.path.join(out_dir, "performance_metrics.json")) as fh:
            metrics = json.load(fh)
        manifest = _manifest(out_dir)
        context = manifest.get("context", {})
        if (metrics["processes"] != n or len(metrics["per_chip"]) != n
                or metrics["total_songs"] != songs
                or context.get("mesh_shape") != {"dp": n}
                or context.get("mesh_backend") != "gloo"):
            fail(f"mesh analyze {name}: metrics {json.dumps(metrics)[:600]}, "
                 f"context {context}")
        counters = manifest.get("counters", {})
        out[name] = dict(
            ranks=n, process_wall_s=wall, songs_per_s=songs / wall,
            engine_songs_per_s=songs / sum(metrics["stages"].values()),
            stages_s=metrics["stages"],
            per_chip_s=[c["compute_seconds"] for c in metrics["per_chip"]],
            collective_bytes=counters.get("collectives.total_bytes"))
        log(f"mesh analyze {name} on {card}: {n} ranks, process "
            f"{wall:.2f} s ({songs / wall:.1f} songs/s), collectives "
            f"{out[name]['collective_bytes']} B; {json.dumps(out[name])}")
    return out


def _detail_labels(out_dir):
    with open(os.path.join(out_dir, "sentiment_details.csv"),
              newline="", encoding="utf-8") as fh:
        return [row["label"] for row in csv.DictReader(fh)]


def mesh_sentiment_path(torch, dev, card, dataset, checkpoint) -> dict:
    """``sentiment --model distilbert --devices 2`` at full width on the
    16,384 songs (batch 8192, step 11's split checkpoint), labels against
    the one-device run; then ``analyze --with-sentiment --devices 2`` on
    the same checkpoint."""
    import numpy as np

    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.ingest import ingest_dataset
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment
    from music_analyst_tpu_torch.models.distilbert import DistilBertClassifier

    env = {"MUSICAAL_DISTILBERT_CKPT": checkpoint}
    texts = [t for _, _, t in iter_songs(dataset)]
    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", checkpoint_path=checkpoint, device=dev)
    one_dir = os.path.join(WORK, "mesh_sentiment_d1")
    t0 = time.perf_counter()
    run_sentiment(dataset, backend=clf, output_dir=one_dir, batch_size=BATCH,
                  quiet=True)
    one_s = time.perf_counter() - t0
    want = _detail_labels(one_dir)
    logits = torch.cat([clf.classify_logits(texts[i:i + BATCH])
                        for i in range(0, len(texts), BATCH)])
    conf = torch.softmax(logits, dim=-1).amax(dim=-1).numpy()
    near = np.abs(conf - clf.neutral_threshold) < MESH_BOUNDARY_TOL
    del clf, logits
    torch.cuda.empty_cache()

    out_dir = os.path.join(WORK, "mesh_sentiment_d2")
    proc, wall, launches = mesh_cli(
        ["sentiment", dataset, "--model", "distilbert", "--devices", "2",
         "--batch-size", str(BATCH), "--output-dir", out_dir], env)
    got = _detail_labels(out_dir)
    if len(got) != len(want):
        fail(f"mesh sentiment: {len(got)} rows, one device {len(want)}")
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    outside = [i for i in differ if not near[i]]
    if outside:
        fail(f"mesh sentiment: {len(outside)} labels differ from one "
             f"device away from the boundary (first rows {outside[:5]})")
    flash = [launches.get(r, {}).get("flash_attention", 0) for r in range(2)]
    if len(launches) != 2 or min(flash) == 0:
        fail(f"mesh sentiment: per-rank launches {launches}")
    manifest = _manifest(out_dir)
    report = dict(
        songs=len(want), process_wall_s=wall, songs_per_s=len(want) / wall,
        engine_wall_s=manifest.get("wall_seconds"),
        one_device_songs_per_s=len(want) / one_s,
        labels_differ=len(differ), near_boundary=int(near.sum()),
        flash_launches_per_rank=flash,
        mesh_shape=manifest.get("context", {}).get("mesh_shape"),
        mesh_backend=manifest.get("context", {}).get("mesh_backend"),
        collective_bytes=manifest.get("counters", {}).get(
            "collectives.total_bytes"))
    if report["mesh_backend"] != "gloo":
        fail(f"mesh sentiment: manifest context {manifest.get('context')}")
    log(f"mesh sentiment distilbert --devices 2 on {card}: "
        f"{report['songs_per_s']:.1f} songs/s (process), flash launches per "
        f"rank {flash}; {json.dumps(report)}")

    joint_dir = os.path.join(WORK, "mesh_joint_d2")
    proc, jwall, jlaunches = mesh_cli(
        ["analyze", dataset, "--with-sentiment", "--model", "distilbert",
         "--devices", "2", "--batch-size", str(BATCH), "--ingest", "native",
         "--no-corpus-cache", "--output-dir", joint_dir], env)
    oracle = oracle_outputs(ingest_dataset(dataset, backend="native"),
                            os.path.join(WORK, "mesh_joint_oracle"))
    if read_outputs(joint_dir) != oracle:
        fail("mesh joint: CSVs differ from the oracle")
    if _detail_labels(joint_dir) != got:
        fail("mesh joint: labels differ from sentiment --devices 2")
    jflash = [jlaunches.get(r, {}).get("flash_attention", 0) for r in range(2)]
    if min(jflash, default=0) == 0:
        fail(f"mesh joint: per-rank launches {jlaunches}")
    report["joint"] = dict(process_wall_s=jwall,
                           songs_per_s=len(want) / jwall,
                           flash_launches_per_rank=jflash)
    log(f"mesh analyze --with-sentiment --devices 2: {json.dumps(report['joint'])}")
    return report


def mesh_distilbert_api_path(torch, dev, card, dataset, checkpoint) -> dict:
    """Full-width DistilBERT through the API on four ranks of the one
    card, as dp2 x tp2 and then as two dp1 x tp2 meshes (each tp line of
    the grid, computing the same rows): logits of 2,048 songs within
    LOGIT_REL_TOL of the one-rank logits; the row-parallel bias added
    before the reduce and two ranks' head shards swapped must fail.  The
    split checkpoint's biases are zero, so the check runs on a copy whose
    every bias is drawn N(0, 1) from seed 13: a bias counted twice then
    shows."""
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.models.distilbert import DistilBertClassifier

    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    gen = torch.Generator().manual_seed(13)
    for name, value in state.items():
        if name.endswith(".bias") and ".transformer." in name:
            state[name] = torch.randn(value.shape, generator=gen)
    biased = os.path.join(WORK, "mesh_api_checkpoint.pt")
    torch.save(state, biased)
    checkpoint = biased
    songs = [t for _, _, t in iter_songs(dataset, limit=MESH_API_ROWS)]
    texts = os.path.join(WORK, "mesh_api_texts.json")
    with open(texts, "w") as fh:
        json.dump(songs, fh)
    clf = DistilBertClassifier.from_pretrained_or_random(
        "distilbert", checkpoint_path=checkpoint, device=dev)
    ref = clf.classify_logits(songs)
    del clf, state
    torch.cuda.empty_cache()
    scale = float(ref.abs().max())
    few = ref[:MESH_BROKEN_ROWS]
    out = {}
    t0 = time.perf_counter()
    ranks = run_ranks(_MESH_BERT_CHILD, 4, [WORK, checkpoint, texts],
                      "mesh_bert")
    wall = time.perf_counter() - t0
    for tag, n in (("dp2xtp2", 4), ("dp1xtp2", 2)):
        got = torch.load(os.path.join(WORK, f"mesh_bert_{tag}.pt"))
        diff = float((got["good"] - ref).abs().max())
        bias = float((got["bias_early"] - few).abs().max())
        heads = float((got["heads_swapped"] - few).abs().max())
        if diff > LOGIT_REL_TOL * scale:
            fail(f"mesh distilbert {tag}: logits differ by {diff} "
                 f"(> {LOGIT_REL_TOL} x {scale})")
        for bname, bad in (("bias before the reduce", bias),
                           ("head shards swapped", heads)):
            if bad <= LOGIT_REL_TOL * scale:
                fail(f"mesh distilbert {tag}: the limit passes a run with "
                     f"the {bname} ({bad})")
        runs = [r["layouts"][tag] for r in ranks]
        flash = [r["launches"]["flash_attention"] for r in runs]
        if min(flash) == 0:
            fail(f"mesh distilbert {tag}: flash launches per rank {flash}")
        out[tag] = dict(
            ranks=n, max_abs_diff=diff, scale=scale, bias_before_reduce=bias,
            head_shards_swapped=heads, flash_launches_per_rank=flash,
            q_shape_per_rank=runs[0]["q_shape"],
            forward_s_per_rank=[r["forward_s"] for r in runs],
            songs_per_s=MESH_API_ROWS / max(r["forward_s"] for r in runs),
            init_s_per_rank=[r["init_s"] for r in runs],
            peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in runs])
        log(f"mesh distilbert {tag} on {card}: {json.dumps(out[tag])}")
    out["wall_s"] = wall
    return out


def mesh_llama_path(torch, card, llama) -> dict:
    """Llama-3-8B at tp 2 (full width, LLAMA_LAYERS layers, random bf16
    weights from
    seed 0 drawn whole on each rank and sliced) as two ranks on the one
    card: score-mode labels equal to the tp-1 run's, generate mode
    through the paged kernel, decode-step logits within
    LLAMA_LOGIT_REL_TOL of tp 1's; a rank reading the other rank's KV
    heads must fail."""
    t0 = time.perf_counter()
    ranks = run_ranks(_MESH_LLAMA_CHILD, 2,
                      [WORK, os.path.join(WORK, f"songs_{LLAMA_SONGS}.csv")],
                      "mesh_llama_tp2")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        log(f"mesh llama rank {r['rank']}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("score", "generate")}))
    for r in ranks[1:]:
        for key in ("score", "generate"):
            same = ("labels", "scores") if key == "score" else ("texts",)
            if any(r[key][k] != r0[key][k] for k in same):
                fail(f"mesh llama: rank {r['rank']} {key} differs from rank 0")
    want_labels = llama["score"]["labels"]
    want_scores = llama["score"]["scores"]
    got_scores = r0["score"]["scores"]
    score_diff = max(abs(a - b) for ra, rb in zip(got_scores, want_scores)
                     for a, b in zip(ra, rb))
    score_scale = max(abs(a) for row in want_scores for a in row)
    if r0["score"]["labels"] != want_labels:
        fail(f"mesh llama: score labels {r0['score']['labels']} differ from "
             f"tp 1's {want_labels} (max score diff {score_diff})")
    if score_diff > LLAMA_LOGIT_REL_TOL * score_scale:
        fail(f"mesh llama: label scores differ from tp 1's by {score_diff} "
             f"(> {LLAMA_LOGIT_REL_TOL} x {score_scale})")
    n_layers = LLAMA_LAYERS
    for r in ranks:
        g = r["generate"]
        if g["launches"]["paged_attention"] != n_layers * g["decode_steps"]:
            fail(f"mesh llama: rank {r['rank']} paged launches "
                 f"{g['launches']} for {g['decode_steps']} decode steps")
    d = r0["decode_logits"]
    if d["max_abs_diff"] > LLAMA_LOGIT_REL_TOL * d["scale"]:
        fail(f"mesh llama: decode logits differ from tp 1 by "
             f"{d['max_abs_diff']} (> {LLAMA_LOGIT_REL_TOL} x {d['scale']})")
    bad = r0["other_ranks_kv"]["max_abs_diff"]
    if bad <= LLAMA_LOGIT_REL_TOL * d["scale"]:
        fail(f"mesh llama: the limit passes ranks reading each other's KV "
             f"heads ({bad})")
    ref_texts = llama["tp_reference_texts"]
    if len(r0["generate"]["texts"]) != len(ref_texts):
        fail(f"mesh llama: {len(r0['generate']['texts'])} texts")
    same_text = sum(a == b for a, b in zip(r0["generate"]["texts"], ref_texts))
    out = dict(
        wall_s=wall, score_labels_equal=True, score_max_abs_diff=score_diff,
        score_scale=score_scale,
        same_text_as_tp1=same_text, prompts=len(ref_texts),
        decode_logits=d, other_ranks_kv=r0["other_ranks_kv"],
        prefill_tokens_equal=r0["prefill_tokens_equal"],
        per_rank=[{key: r[key] for key in (
            "rank", "backend", "device", "init_s", "weights_bytes",
            "init_peak_memory_bytes", "peak_memory_bytes", "kv_heads",
            "pool_shape", "dispatch")} | dict(
                score_songs_per_s=r["score"]["songs_per_s"],
                **{k: r["generate"][k] for k in (
                    "songs_per_s", "prefill_tokens_per_s",
                    "decode_tokens_per_s", "ms_per_decode_step",
                    "decode_steps", "launches")})
            for r in ranks])
    log(f"mesh llama3_8b tp 2 on {card}: {json.dumps(out)}")
    return out


def mesh_kernel_shapes(torch, dev) -> dict:
    """Kernels 2 and 3 at the per-rank shapes of this step: flash at
    DistilBERT's dp2 / tp2 / dp2 x tp2 rows and heads, paged at the 8B
    decode shape with tp 2's 16 query and 4 KV heads; each against its
    plain version, with its bound and the library call."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from music_analyst_tpu_torch.ops.paged_attention import (
        _gather,
        paged_attention,
        paged_attention_plain,
        paged_attention_reference,
    )

    out = {}
    gen = torch.Generator(device=dev).manual_seed(13)
    S, D = 128, 64
    for name, B, H in (("flash_dp2", 4096, 12), ("flash_tp2", 8192, 6),
                       ("flash_dp2xtp2", 4096, 6)):
        t0 = time.perf_counter()
        q, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        lengths = torch.randint(8, S + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
        call = lambda: flash_attention(q, k, v, lengths=lengths)  # noqa: E731
        ref = flash_attention_reference(q.float(), k.float(), v.float(),
                                        lengths=lengths)
        err = check_flash_output(torch, name, call(), ref)
        del ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        sum_len = float(lengths.sum())
        bytes_moved = 2 * B * S * H * D * 2 + 2 * sum_len * H * D * 2 + B * 4
        flops = 4.0 * H * D * S * sum_len
        b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16_FLOPS)
        out[name] = dict(
            shape=f"q/k/v bf16 [{B},{S},{H},{D}]", max_abs_err=err,
            ms=time_ms(torch, call, 10),
            plain_ms=time_ms(torch, lambda: flash_attention_reference(
                q, k, v, lengths=lengths), 2),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 10),
            bound_ms=b_ms, bound_by=b_by, wall_s=time.perf_counter() - t0)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    case = paged_case(torch, dev, False, heads=PAGED_H // 2,
                      kv_heads=PAGED_KV // 2)
    args, kw = _pargs(case)
    ref = paged_attention_reference(*args, **kw)
    got = paged_attention(*args, **kw)
    err, scaled = paged_errors(got, ref)
    if err > PAGED_ABS_TOL or scaled > 1.0:
        fail(f"paged at tp 2's heads: max abs err {err}, {scaled} x bound")
    n, H, Hkv, D = PAGED_SLOTS, PAGED_H // 2, PAGED_KV // 2, PAGED_D
    valid = float(case["mask"].sum())
    bytes_moved = (2 * valid * Hkv * D * 2 + 2 * n * H * D * 2
                   + case["table"].numel() * 4 + case["mask"].numel())
    b_ms, b_by = bound(bytes_moved, 4.0 * H * D * valid, PEAK_BF16_FLOPS)
    total = case["mask"].shape[1]
    qt = case["q"].transpose(1, 2)
    amask = case["mask"][:, None, None, :]

    def gather_sdpa():
        kk = _gather(case["key_pages"], None, case["table"], total,
                     torch.bfloat16).transpose(1, 2)
        vv = _gather(case["value_pages"], None, case["table"], total,
                     torch.bfloat16).transpose(1, 2)
        return F.scaled_dot_product_attention(qt, kk, vv, attn_mask=amask,
                                              enable_gqa=True)

    call = lambda: paged_attention(*args, **kw)  # noqa: E731
    out["paged_tp2"] = dict(
        shape=(f"q bf16 [{n},1,{H},{D}]; pools bf16 "
               f"{list(case['key_pages'].shape)}"),
        max_abs_err=err, bound_units=scaled,
        ms=device_ms(torch, call, 50, what="paged tp2"),
        plain_ms=time_ms(torch, lambda: paged_attention_plain(*args, **kw), 5),
        library_ms=device_ms(torch, gather_sdpa, 20, what="gather + SDPA tp2"),
        bound_ms=b_ms, bound_by=b_by, wall_s=time.perf_counter() - t0)
    del case
    torch.cuda.empty_cache()
    log(f"kernels at the mesh's per-rank shapes: {json.dumps(out)}")
    return out


class PhaseClock:
    """The wall seconds of each phase of ``main``: a call names the phase
    that has just ended, timed from the previous call."""

    def __init__(self) -> None:
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def sum(self, *names: str) -> float:
        return sum(self.seconds[name] for name in names)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card", 2)
    if not os.path.isdir(os.path.join(ROOT, "music_analyst_tpu_torch")):
        fail("run from the root of a checkout: music_analyst_tpu_torch/ is "
             "missing beside chip_smoke.py", 3)
    sys.path.insert(0, ROOT)
    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.models.tokenization import HashWordTokenizer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    report = {"card": card, "torch": torch.__version__}

    report["host_python_ms"] = {"start": python_ms()}
    mark = PhaseClock()
    report["build"] = build_all()
    mark("build")
    report["flash_max_abs_err"] = check_flash(torch, dev)
    mark("flash_max_abs_err")
    x = keyword_matrix(torch, dev)
    report["keyword_rows_with_hits"] = check_keyword(torch, dev, x)
    mark("keyword")
    report["keyword_check_s"] = mark.seconds["keyword"]

    os.makedirs(WORK, exist_ok=True)
    dataset = os.path.join(WORK, "songs_16384.csv")
    generate_dataset(dataset, num_songs=N_SONGS, seed=11)
    from music_analyst_tpu_torch.data.csv_io import iter_songs

    _, corpus_lengths = HashWordTokenizer().encode_batch(
        [t for _, _, t in iter_songs(dataset, limit=BATCH)], 128)
    corpus_batch, lyric_share = keyword_corpus_batch(torch, dev, dataset)
    report["timing"] = measure(torch, dev, corpus_lengths, x, corpus_batch,
                               lyric_share)
    del x, corpus_batch
    torch.cuda.empty_cache()
    mark("timing")
    report["quant_gemm"] = quant_gemm_probe(torch, dev)
    mark("quant_gemm")
    report["main_path"] = main_path(torch, dev, dataset, card)
    mark("main_path")
    mp = report["main_path"]
    torch.cuda.empty_cache()
    report["serve_mock"] = serve_mock_path(torch, dev, card)
    mark("serve_mock")
    mock_replies = report["serve_mock"].pop("replies")
    report["distilbert_quant"] = distilbert_quant_path(torch, dev, dataset,
                                                       card)
    mark("distilbert_quant")
    report["analyze"], oracle = analyze_path(torch, dev, card)
    mark("analyze")
    report["joint"] = joint_path(torch, card, report["analyze"], oracle)
    mark("joint")
    report["histogram"] = histogram_path(torch, dev, card)
    mark("histogram")
    report["slice6_s"] = mark.sum("analyze", "joint", "histogram")
    log(f"word-count, joint and histogram phases: {report['slice6_s']:.1f} s")
    report["persong"] = persong_path(card)
    mark("persong")
    report["paged"] = check_paged(torch, dev)
    mark("paged")
    torch.cuda.empty_cache()
    serve_s = []

    def serve(clf, prompts):
        t1 = time.perf_counter()
        out = serve_llama_path(torch, dev, clf, prompts, card)
        serve_s.append(time.perf_counter() - t1)
        return out

    report["host_python_ms"]["before_llama"] = python_ms()
    report["llama"] = llama_path(torch, dev, card, serve=serve)
    mark("llama")
    report["slice8_s"] = (mp["serve"]["wall_s"] + mark.seconds["serve_mock"]
                          + serve_s[0])
    log(f"serve phases: {report['slice8_s']:.1f} s")
    torch.cuda.empty_cache()
    report["llama_quant"] = llama_quant_path(torch, dev, card)
    mark("llama_quant")
    report["slice7_s"] = mark.sum("quant_gemm", "distilbert_quant", "persong",
                                  "llama_quant")
    log(f"quantized and per-song phases: {report['slice7_s']:.1f} s")
    torch.cuda.empty_cache()
    report["router_mock"] = router_mock_path(
        torch, card, report["serve_mock"], mock_replies)
    mark("router_mock")
    report["router_distilbert"] = router_distilbert_path(
        torch, dev, card, dataset, mp["serve"])
    mark("router_distilbert")
    report["manifests"] = manifest_tools_path(
        torch, card, dataset,
        [os.path.join(WORK, "analyze_auto_streaming"),
         os.path.join(WORK, "router_mock_telemetry"),
         report["router_distilbert"]["telemetry_dir"]],
        report["router_distilbert"]["trace_dir"])
    mark("manifests")
    report["slice9_s"] = mark.sum("router_mock", "router_distilbert",
                                  "manifests")
    log(f"router and manifest phases: {report['slice9_s']:.1f} s")
    torch.cuda.empty_cache()
    report["flash_llama"] = check_flash_llama(torch, dev)
    mark("flash_llama")
    report["flash_loss"] = flash_loss_path(torch, dev, card)
    mark("flash_loss")
    report["train"] = train_path(torch, dev, card)
    mark("train")
    report["moe"] = moe_path(torch, dev, card)
    mark("moe")
    report["sweep"] = sweep_path(report["analyze"], oracle, card)
    mark("sweep")
    report["slice10_s"] = mark.sum("flash_llama", "flash_loss", "train", "moe",
                                   "sweep")
    log(f"training, flash loss, MoE and sweep phases: "
        f"{report['slice10_s']:.1f} s")
    torch.cuda.empty_cache()
    report["fault_drills"] = fault_drills(
        torch, dev, card, dataset, report["analyze"], oracle,
        report["router_distilbert"]["checkpoint"]["path"])
    mark("fault_drills")
    report["wordpiece"] = wordpiece_path(
        torch, dev, card, dataset,
        report["router_distilbert"]["checkpoint"]["path"])
    mark("wordpiece")
    report["slice11_s"] = mark.sum("fault_drills", "wordpiece")
    log(f"fault drills and WordPiece phases: {report['slice11_s']:.1f} s")
    torch.cuda.empty_cache()
    report["distributed"] = distributed_wordcount_path(
        card, report["analyze"], oracle)
    mark("distributed")
    report["ring"] = ring_path(torch, dev, card)
    mark("ring")
    report["slice12_s"] = mark.sum("distributed", "ring")
    log(f"distributed word count and ring attention phases: "
        f"{report['slice12_s']:.1f} s")
    torch.cuda.empty_cache()
    checkpoint = report["router_distilbert"]["checkpoint"]["path"]
    report["mesh_kernels"] = mesh_kernel_shapes(torch, dev)
    mark("mesh_kernels")
    report["mesh_analyze"] = mesh_analyze_path(card, report["analyze"], oracle)
    mark("mesh_analyze")
    report["mesh_sentiment"] = mesh_sentiment_path(torch, dev, card, dataset,
                                                   checkpoint)
    mark("mesh_sentiment")
    report["mesh_distilbert"] = mesh_distilbert_api_path(
        torch, dev, card, dataset, checkpoint)
    mark("mesh_distilbert")
    report["mesh_llama"] = mesh_llama_path(torch, card, report["llama"])
    mark("mesh_llama")
    report["slice13_s"] = mark.sum("mesh_kernels", "mesh_analyze",
                                   "mesh_sentiment", "mesh_distilbert",
                                   "mesh_llama")
    log(f"mesh phases (analyze/sentiment --devices, DistilBERT dp x tp, "
        f"Llama-3-8B tp 2): {report['slice13_s']:.1f} s")
    report["host_python_ms"]["end"] = python_ms()
    report["phase_s"] = mark.seconds
    log(f"phase walls (s): {json.dumps(mark.seconds)}")
    log(f"host probe (ms of a fixed Python loop): "
        f"{json.dumps(report['host_python_ms'])}")
    report["timed_by_events"] = TIMED_BY_EVENTS
    report["seconds"] = time.perf_counter() - t_start

    timing = report["timing"]
    errs = dict(report["flash_max_abs_err"],
                distilbert_main_shape=timing["flash_attention"]["max_abs_err"],
                llama_shapes=report["flash_llama"]["max_abs_err"],
                ring=report["ring"]["hop"]["max_abs_err"])
    kernels_line = {"kernels": [
        dict(name="flash_attention", route="cuda",
             source="music_analyst_tpu_torch/csrc/flash_attention.cu",
             replaces="music_analyst_tpu/ops/flash_attention.py:45",
             launches=mp["distilbert_flat"]["launches"]["flash_attention"],
             joint_launches=report["joint"]["distilbert"]["launches"][
                 "flash_attention"],
             serve_launches=mp["serve"]["launches"]["flash_attention"],
             router_launches=report["router_distilbert"]["flash_launches"],
             profile_dir_trace_events=report["manifests"]["flash_events"],
             loss_launches=sum(report["flash_loss"][name]["launches"][
                 "flash_attention"] for name in ("unpacked", "packed")),
             train_eval_launches=report["train"]["eval_launches"][
                 "flash_attention"],
             fault_drill_launches=report["fault_drills"]["distilbert"][
                 "launches"],
             wordpiece_launches=report["wordpiece"]["run_sentiment"][
                 "native"]["launches"],
             llama_shape={key: report["flash_llama"][key] for key in
                          ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "max_abs_err")},
             ring_launches_per_rank=report["ring"]["launches_per_rank"],
             ring_hop_shape={key: report["ring"]["hop"][key] for key in
                             ("shape", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "max_abs_err")},
             mesh_launches_per_rank=dict(
                 sentiment_devices_2=report["mesh_sentiment"][
                     "flash_launches_per_rank"],
                 joint_devices_2=report["mesh_sentiment"]["joint"][
                     "flash_launches_per_rank"],
                 **{f"api_{tag}": report["mesh_distilbert"][tag][
                     "flash_launches_per_rank"]
                    for tag in ("dp1xtp2", "dp2xtp2")}),
             mesh_shapes={name: report["mesh_kernels"][name] for name in
                          ("flash_dp2", "flash_tp2", "flash_dp2xtp2")},
             **{f"{name}_launches": report["distilbert_quant"][name][
                 "launches"]["flash_attention"]
                for name in ("int8_dynamic", "wq_int8", "wq_int4")},
             max_abs_err=max(list(errs.values()) + [
                 report["mesh_kernels"][name]["max_abs_err"] for name in
                 ("flash_dp2", "flash_tp2", "flash_dp2xtp2")]),
             **{key: timing["flash_attention"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="keyword_scan", route="cuda",
             source="music_analyst_tpu_torch/csrc/keyword_scan.cu",
             replaces="music_analyst_tpu/ops/pallas_keyword.py:63",
             launches=mp["mock_cli"]["launches"]["keyword_scan"],
             joint_launches=report["joint"]["mock"]["launches"]["keyword_scan"],
             serve_launches=report["serve_mock"]["launches"]["keyword_scan"],
             router_launches=report["router_mock"]["scan_launches"],
             fault_drill_launches=report["fault_drills"]["mock_watchdog"][
                 "launches"],
             max_abs_err=0.0,
             **{key: timing["keyword_scan"][key] for key in
                ("shape", "ms", "ms_l2_flushed", "event_ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")}),
        dict(name="paged_attention", route="cuda",
             source="music_analyst_tpu_torch/csrc/paged_attention.cu",
             replaces="music_analyst_tpu/ops/paged_attention.py:138",
             launches=report["llama"]["generate"]["launches"]["paged_attention"],
             wq_launches=report["llama_quant"]["wq_int8"]["generate"][
                 "launches"]["paged_attention"],
             wq_int4_launches=report["llama_quant"]["wq_int4"]["generate"][
                 "launches"]["paged_attention"],
             **{f"serve_{name}_launches": report["llama"]["serve"][name][
                 "launches"]["paged_attention"]
                for name in ("paged", "speculative", "preempt", "int8")},
             tp2_launches_per_rank=[
                 r["launches"]["paged_attention"]
                 for r in report["mesh_llama"]["per_rank"]],
             tp2_shape=report["mesh_kernels"]["paged_tp2"],
             max_abs_err=max([v["max_abs_err"] for v in report["paged"].values()]
                             + [report["mesh_kernels"]["paged_tp2"][
                                 "max_abs_err"]]),
             **{key: report["paged"]["bf16"][key] for key in
                ("ms", "ms_l2_flushed", "event_ms", "host_us", "plain_ms",
                 "bound_ms", "bound_by", "library_ms",
                 "library_ms_l2_flushed")}),
    ]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    log(f"songs/s on {card}: flat {mp['distilbert_flat']['songs_per_s']:.1f}, "
        f"packed {mp['distilbert_packed']['songs_per_s']:.1f}, llama3_8b "
        f"generate {report['llama']['generate']['songs_per_s']:.2f}; analyze "
        f"{report['analyze']['layouts']['auto_streaming']['songs_per_s']:.1f}, "
        f"joint mock {report['joint']['mock']['songs_per_s']:.1f}, joint "
        f"distilbert {report['joint']['distilbert']['songs_per_s']:.1f}; "
        f"serve --mock {report['serve_mock']['requests_per_s']:.1f} req/s, "
        f"serve distilbert {mp['serve']['requests_per_s']:.1f} req/s; "
        f"router --mock "
        f"{report['router_mock']['requests_per_s']:.1f} req/s, router "
        f"distilbert {report['router_distilbert']['requests_per_s']:.1f} "
        f"req/s; train step {report['train']['step_ms_mean']:.1f} ms "
        f"({report['train']['tokens_per_s']:.0f} tokens/s); WordPiece "
        f"native {report['wordpiece']['batch']['native_songs_per_s']:.0f} "
        f"vs Python {report['wordpiece']['batch']['python_songs_per_s']:.0f} "
        f"songs/s; distributed word count "
        + ", ".join(f"{key} {row['songs_per_s']:.1f}"
                    for key, row in report["distributed"].items()
                    if key.startswith("np"))
        + f" songs/s; ring S={RING_SEQ} causal "
        f"{report['ring']['cases']['causal']['ms_per_call']:.1f} ms a call; "
        f"mesh: analyze --devices 2 "
        f"{report['mesh_analyze']['d2']['songs_per_s']:.1f} songs/s, sentiment "
        f"distilbert --devices 2 "
        f"{report['mesh_sentiment']['songs_per_s']:.1f} songs/s, llama3_8b "
        f"tp 2 {report['mesh_llama']['per_rank'][0]['ms_per_decode_step']:.1f}"
        f" ms a decode step; total {report['seconds']:.1f} s")
    print(json.dumps({"quant_gemm": report["quant_gemm"]}))
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
