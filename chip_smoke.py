#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds every kernel of the batch-sentiment path from ``csrc/`` (one
   ``nvcc`` per source, started together) and the host C++ library.
2. Holds each kernel against its plain PyTorch version on the card: flash
   attention at DistilBERT shapes (bf16, B=256, S=128, H=12, D=64, random
   lengths; packed segments) and in causal + GQA + offset and residual modes
   at D=128; the keyword scan exactly on a seeded 8192x4096 byte matrix.
3. Times each kernel, its plain version and (where one exists) the PyTorch
   library call for the same function, at the main path's shapes, beside
   the bound the card's bandwidth and peak rate put on the same work.  The
   paged-attention kernel is held at the Llama-3-8B decode shape (8 slots,
   page 16, region 1024, bf16 and int8 pools) against its f32 oracle and
   its exact-order plain version; a free slot must read zeros, NaN in the
   trash page must change nothing, and a shifted page or a dropped key
   must break the limits.  The
   flash kernel's output at the main shape (B=8192, corpus lengths) is held
   against its plain version too, and a variant that drops one key per row
   must break the limits.
4. Drives the main path: ``run_sentiment`` with full-size DistilBERT
   (``DistilBertConfig()``, flash attention, seeded random weights) over a
   generated 16,384-song CSV at batch 8192, flat and packed (three runs
   each, median reported), then the
   ``sentiment --mock`` CLI.  Launch counts are zeroed just before each run
   and read just after; every kernel of the path must have launched.
   Outputs are checked: complete totals, flash-vs-dense logits on 1,024
   songs (a model that ignores lengths must break that limit), packed-path
   logits against flat rows on the same songs, and the mock labels against
   the reference heuristic on every song.
   One flat batch is then profiled: host prepare time, device busy time by
   kernel group, and the card's idle share over the batch.
5. Drives the Llama slice at full width: ``LlamaConfig.llama3_8b()``
   (32 layers, seeded random bf16 weights drawn on the card) through
   ``run_sentiment`` in generate mode on the continuous paged scheduler
   (64 songs, 8 slots, three runs, median reported; ``paged_attention``
   must launch exactly once per layer per decode step), in score mode (16
   songs) and with int8 pages (16 prompts).  Checks: every song labelled,
   totals complete, one decode step's logits through the kernel against
   dense attention over the gathered view (and a step that ignores the
   slot lengths must break that limit); reports how many prompts give the
   same greedy text as static ``generate_batch``, and a profile of one
   decode dispatch.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no card is present or when run outside a checkout.  A fuller
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
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


def flash_errors(got, ref):
    """Max abs error, and max error in units of the elementwise bound."""
    diff = (got.float() - ref).abs()
    scaled = diff / (FLASH_BF16_REL * ref.abs() + FLASH_F32_SLACK)
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


def check_keyword(torch, dev, x) -> None:
    from music_analyst_tpu_torch.ops.keyword_kernel import (
        keyword_scan,
        keyword_scan_reference,
    )

    scores, hits = keyword_scan(x, return_hits=True)
    ref_scores, ref_hits = keyword_scan_reference(x)
    if not (torch.equal(scores, ref_scores) and torch.equal(hits, ref_hits)):
        bad = int((scores != ref_scores).sum())
        fail(f"keyword scan differs from its plain version on {bad} rows")
    log(f"keyword kernel == plain on {x.shape[0]}x{x.shape[1]} "
        f"({int((ref_hits != 0).sum())} rows with hits)")


def measure(torch, dev, corpus_lengths, x) -> dict:
    """Kernel, plain version, library call and bound at main-path shapes.
    The flash kernel's output there is also held against its plain version,
    and a broken variant (one key dropped per row) must break the limits."""
    import torch.nn.functional as F

    from music_analyst_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from music_analyst_tpu_torch.ops.keyword_kernel import (
        KEYWORDS,
        keyword_scan,
        keyword_scan_reference,
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

    rows, width = x.shape
    kernel_ms = time_ms(torch, lambda: keyword_scan(x), 20)
    plain_ms = time_ms(torch, lambda: keyword_scan_reference(x), 2)
    bytes_moved = rows * width + rows * 4
    ops = float(rows * width * len(KEYWORDS))
    b_ms, b_by = bound(bytes_moved, ops, PEAK_INT8_OPS)
    out["keyword_scan"] = dict(
        shape=f"uint8 [{rows},{width}]", ms=kernel_ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved,
        ops=ops)
    log(f"timings: {json.dumps(out)}")
    return out


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
        key = ("flash_attention" if "flash_fwd" in low else
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
    if rc != 0 or launches["keyword_scan"] == 0:
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
#    both to bf16), and 32 bf16 layers carry the difference to the logits;
#    5e-2 of the logit scale (max |logit|).  A step that ignores the slot
#    lengths (attends to every row of its pages) must break it.
LLAMA_LOGIT_REL_TOL = 5e-2
LLAMA_SONGS = 64          # generate mode, median of REPEATS runs
LLAMA_SCORE_SONGS = 16    # score mode, one batch
LLAMA_INT8_PROMPTS = 16


def paged_case(torch, dev, quantized: bool, seed: int = 5) -> dict:
    """Pools, table and mask at the main decode shape.  Slots 0..6 hold
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
    shape = (n_pages + 1, P, PAGED_KV, PAGED_D)
    keys = torch.randn(shape, generator=gen, device=dev)
    values = torch.randn(shape, generator=gen, device=dev)
    keys[n_pages], values[n_pages] = 1e4, -1e4
    q = torch.randn((n, 1, PAGED_H, PAGED_D), generator=gen,
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

            entry.update(
                shape=(f"q bf16 [{n},1,{H},{D}]; pools bf16 "
                       f"{list(case['key_pages'].shape)}; table int32 "
                       f"{list(case['table'].shape)}; mask [{n},{total}]"),
                ms=time_ms(torch, lambda: paged_attention(*args, **kw), 50, 3),
                plain_ms=time_ms(torch, lambda: paged_attention_plain(*args, **kw), 5),
                library_ms=time_ms(torch, gather_sdpa, 20),
                bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, flops=flops,
                valid_rows=valid)
        else:
            entry["ms"] = time_ms(torch, lambda: paged_attention(*args, **kw), 50, 3)
        out[name] = entry
        del case, dirty
    torch.cuda.synchronize()
    log(f"paged kernel at the 8B decode shape: {json.dumps(out)}")
    return out


# ------------------------------------------------------ Llama path (slice 2)

def _active_scheduler(torch, clf, prompts):
    """A fresh scheduler with every slot prefilled and in decode."""
    from music_analyst_tpu_torch.serving.decode_loop import ContinuousScheduler

    sched = ContinuousScheduler(clf, n_slots=PAGED_SLOTS, prefill_chunk=64,
                                prompt_region=PAGED_REGION,
                                max_new_tokens=PAGED_NEW)
    for i, p in enumerate(prompts[:PAGED_SLOTS]):
        sched.submit(i, p)
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


def decode_logits_check(torch, clf, sched) -> dict:
    """One decode step from the same pool state through the paged kernel
    and through dense attention over the gathered view; a step with the
    slot lengths ignored must break the limit."""
    from music_analyst_tpu_torch.models.layers import KVCache
    from music_analyst_tpu_torch.ops.paged_attention import (
        PagedAttnView,
        _gather,
    )

    rt, plan = sched.runtime, sched.plan
    R, total = plan.prompt_region, plan.max_total
    x = _step_inputs(torch, sched)
    offsets = R + x["steps"]
    dev = sched.device
    kv_pos = torch.arange(total, device=dev)[None, None, None, :]
    mask = (kv_pos < x["plens"][:, None, None, None]) | (
        (kv_pos >= R) & (kv_pos - R <= x["steps"][:, None, None, None]))
    pos = (x["plens"] + x["steps"])[:, None]

    def step(kind, step_mask):
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
            logits, _ = clf.model(x["tokens"][:, None], pos, step_mask, views)
        return logits[:, 0]

    dense = step("dense", mask)
    paged = step("paged", mask)
    unmasked = step("paged", torch.ones_like(mask))
    torch.cuda.synchronize()
    scale = float(dense.abs().max())
    diff = float((paged - dense).abs().max())
    bad = float((unmasked - dense).abs().max())
    out = dict(max_abs_diff=diff, scale=scale, lengths_ignored=bad,
               argmax_agree=int((paged.argmax(-1) == dense.argmax(-1)).sum()),
               rows=int(dense.shape[0]))
    log(f"llama decode-step logits, paged kernel vs dense: {json.dumps(out)}")
    if not torch.isfinite(paged).all() or diff > LLAMA_LOGIT_REL_TOL * scale:
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.runtime.decode_step(sched.caches, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernel_ms(prof)
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        groups["paged_attention" if "paged_decode" in low else
               "gemm" if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass",
                                                "nvjet", "splitk")) else
               "other"] += ms
    busy = sum(kernels.values())
    out = dict(groups_ms=groups, top_kernels_ms=[
        (name[:96], ms) for name, ms in
        sorted(kernels.items(), key=lambda kv: -kv[1])[:8]])
    out.update(traced_wall_ms=wall * 1e3, device_busy_ms=busy,
               device_idle_share=max(0.0, 1 - busy / (wall * 1e3)),
               steps=sched.plan.decode_span)
    log(f"breakdown of one decode dispatch: {json.dumps(out)}")
    return out


def llama_path(torch, dev, card) -> dict:
    """Full-width Llama-3-8B (random bf16 weights drawn on the card) through
    run_sentiment: generate mode on the continuous paged scheduler (8
    slots, page 16, chunk 64, 16 new tokens, span 4, prefix cache on) and
    score mode; int8 pages; model-level checks."""
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
    cfg = LlamaConfig.llama3_8b()
    clf = LlamaZeroShotClassifier(config=cfg, max_prompt_len=PAGED_REGION,
                                  device=dev, seed=0, decode_mode="generate",
                                  continuous_slots=PAGED_SLOTS)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["weights_bytes"] = sum(p.numel() * p.element_size()
                                  for p in clf.model.parameters())
    log(f"llama3_8b random init on the card in {report['init_s']:.1f} s, "
        f"{report['weights_bytes'] / 1e9:.2f} GB of weights")
    dataset = os.path.join(WORK, f"songs_{LLAMA_SONGS}.csv")
    generate_dataset(dataset, num_songs=LLAMA_SONGS, seed=13)
    songs = list(iter_songs(dataset))
    prompts = [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
               for _, _, t in songs]

    # Warm-up that doubles as the continuous side of the token comparison.
    t0 = time.perf_counter()
    continuous = clf.generate_batch_continuous(prompts, max_new_tokens=16,
                                               n_slots=PAGED_SLOTS)
    report["warmup_s"] = time.perf_counter() - t0

    out_dir = os.path.join(WORK, "llama_generate")
    runs = []
    for _ in range(REPEATS):
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

    # Continuous-paged vs static greedy text, 64 prompts (static in four
    # batches of 16; a batch's padded width can differ from the
    # continuous region, so this is a report, not a check).
    static = []
    for i in range(0, LLAMA_SONGS, 16):
        static += clf.generate_batch(prompts[i:i + 16], max_new_tokens=16)
    same = sum(a == b for a, b in zip(static, continuous))
    report["static_vs_continuous_same_text"] = same
    log(f"llama greedy text, continuous paged == static on {same} of "
        f"{LLAMA_SONGS} prompts")

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
                           totals=result.counts)
    log(f"llama score mode: {json.dumps(report['score'])}")

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

    sched = _active_scheduler(torch, clf, prompts)
    report["decode_logits_paged_vs_dense"] = decode_logits_check(torch, clf, sched)
    report["decode_breakdown"] = decode_breakdown(torch, sched)
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"llama peak device memory {report['peak_memory_bytes'] / 1e9:.2f} GB")
    del sched, clf
    torch.cuda.empty_cache()
    return report


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

    report["build"] = build_all()
    report["flash_max_abs_err"] = check_flash(torch, dev)
    x = keyword_matrix(torch, dev)
    check_keyword(torch, dev, x)

    os.makedirs(WORK, exist_ok=True)
    dataset = os.path.join(WORK, "songs_16384.csv")
    generate_dataset(dataset, num_songs=N_SONGS, seed=11)
    from music_analyst_tpu_torch.data.csv_io import iter_songs

    _, corpus_lengths = HashWordTokenizer().encode_batch(
        [t for _, _, t in iter_songs(dataset, limit=BATCH)], 128)
    report["timing"] = measure(torch, dev, corpus_lengths, x)
    del x
    torch.cuda.empty_cache()
    report["main_path"] = main_path(torch, dev, dataset, card)
    torch.cuda.empty_cache()
    report["paged"] = check_paged(torch, dev)
    torch.cuda.empty_cache()
    report["llama"] = llama_path(torch, dev, card)
    report["seconds"] = time.perf_counter() - t_start

    timing = report["timing"]
    errs = dict(report["flash_max_abs_err"],
                distilbert_main_shape=timing["flash_attention"]["max_abs_err"])
    mp = report["main_path"]
    kernels_line = {"kernels": [
        dict(name="flash_attention", route="cuda",
             source="music_analyst_tpu_torch/csrc/flash_attention.cu",
             replaces="music_analyst_tpu/ops/flash_attention.py:45",
             launches=mp["distilbert_flat"]["launches"]["flash_attention"],
             max_abs_err=max(errs.values()),
             **{key: timing["flash_attention"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="keyword_scan", route="cuda",
             source="music_analyst_tpu_torch/csrc/keyword_scan.cu",
             replaces="music_analyst_tpu/ops/pallas_keyword.py:63",
             launches=mp["mock_cli"]["launches"]["keyword_scan"],
             max_abs_err=0.0,
             **{key: timing["keyword_scan"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="paged_attention", route="cuda",
             source="music_analyst_tpu_torch/csrc/paged_attention.cu",
             replaces="music_analyst_tpu/ops/paged_attention.py:138",
             launches=report["llama"]["generate"]["launches"]["paged_attention"],
             max_abs_err=max(v["max_abs_err"] for v in report["paged"].values()),
             **{key: report["paged"]["bf16"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    log(f"songs/s on {card}: flat {mp['distilbert_flat']['songs_per_s']:.1f}, "
        f"packed {mp['distilbert_packed']['songs_per_s']:.1f}, llama3_8b "
        f"generate {report['llama']['generate']['songs_per_s']:.2f}; "
        f"total {report['seconds']:.1f} s")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
