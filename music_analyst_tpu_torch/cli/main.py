"""Command-line surface of the port: ``python -m music_analyst_tpu_torch``.

Counterpart of ``music_analyst_tpu/cli/main.py`` for the subcommands
ported so far — ``analyze`` (with ``--with-sentiment``, the joint
pipeline), ``sentiment`` (``--weight-quant``, ``--model ollama[:tag]``),
``wordcount-per-song``, ``split``, ``serve`` (``--replicas N`` puts the
replica router in front of N worker processes; ``--tp 1``), ``sweep``
(the word count over device counts), ``validate`` (label agreement with
a ``transformers`` oracle on a checkpoint), and the host-only tools
``profile-diff``, ``telemetry-report``, ``trace-report`` and ``monitor``
— with the JAX flags, defaults and exit codes, plus ``--device
{cuda,cpu}`` on ``analyze``, ``sentiment``, ``wordcount-per-song``,
``serve``, ``sweep`` and ``validate`` (the counterpart of
``JAX_PLATFORMS``; default ``cuda``, which fails rather than falling back
when no card is present).

Every run-scoped subcommand writes ``telemetry.jsonl`` and
``run_manifest.json`` (to ``--telemetry-dir``, else the run's output dir;
``--no-telemetry`` turns both off), flies with the flight recorder, and
takes ``--profile-dir`` (a ``torch.profiler`` trace plus
``trace_spans.json``); ``analyze`` and ``sentiment`` also take
``--trace-dir``.  Every run-scoped subcommand also takes
``--watchdog-timeout`` (the heartbeat watchdog that classifies a stall)
and ``--inject-faults`` (seeded fault injection at the named seams); a
malformed value of either is a usage error, as in JAX.

``analyze`` and ``sentiment`` take ``--devices N``: the command runs as
rank 0 of a mesh of N ranks and launches ranks 1..N-1 as child processes
with the same arguments (``parallel/launch.py:run_ranks``); the
backend is NCCL when every rank has a card of its own and gloo when
ranks share one or run on the CPU, and is printed and written into the
run manifest.  Only rank 0 writes outputs and the manifest, into a
staging directory that is published once every rank has exited 0; a
failed rank stops every rank, nothing is published and the command exits
1.  ``sentiment --devices N`` with ``--mock`` or ``--model ollama``
builds no mesh and runs one process, as JAX does.  ``sweep --devices
1,2,4`` runs each point as such a mesh.  Not ported yet: ``--tp`` above
1 and ``--devices`` above 1 with ``--weight-quant`` (usage errors naming
the flag).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

_NOT_PORTED = "is not yet ported to music_analyst_tpu_torch"


def _int_list(text: str) -> List[int]:
    try:
        return [int(x) for x in text.split(",") if x.strip()]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated integers, got {text!r}"
        ) from None


def _buckets_arg(text: str):
    """``--length-buckets`` value: comma-separated lengths, or ``auto``."""
    if text.strip().lower() == "auto":
        return "auto"
    return _int_list(text)


def _chunk_songs_arg(text: str):
    """``--chunk-songs`` value: ``auto`` (size by corpus), ``0`` (off), or
    a positive songs-per-chunk count."""
    if text.strip().lower() == "auto":
        return "auto"
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer >= 0 or 'auto', got {text!r}"
        ) from None
    if value < 0:
        raise argparse.ArgumentTypeError(
            f"expected an integer >= 0 or 'auto', got {value}"
        )
    return value


def _add_corpus_cache_flags(p: argparse.ArgumentParser) -> None:
    """Persistent-ingest-cache and streaming flags, shared by analyze and
    sweep."""
    p.add_argument("--corpus-cache-dir", default=None,
                   help="Persistent corpus-cache directory (default "
                        "$MUSICAAL_CORPUS_CACHE or ~/.cache/musicaal_corpus)")
    p.add_argument("--no-corpus-cache", action="store_true",
                   help="Disable the persistent corpus cache (always "
                        "re-ingest)")
    p.add_argument("--chunk-songs", type=_chunk_songs_arg, default=None,
                   help="Songs per streamed device chunk for the word "
                        "histogram: 'auto' (default — stream only on "
                        "large corpora), 0 = whole-corpus put, or an "
                        "explicit count (bounds host+device memory)")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Run on the CUDA card (default) or the CPU")


def _add_run_flags(p: argparse.ArgumentParser, devices: bool = True) -> None:
    """The JAX run-scoped flags (``_add_telemetry_flags``, and
    ``--trace-dir``/``--devices`` where the subcommand has them).
    :func:`_check_run_flags` refuses the values not ported yet."""
    p.add_argument("--telemetry-dir", default=None,
                   help="Write telemetry.jsonl + run_manifest.json here "
                        "(default: the run's output dir)")
    p.add_argument("--no-telemetry", action="store_true",
                   help="Disable run telemetry entirely (no extra files)")
    p.add_argument("--profile-dir", default=None,
                   help="Capture a torch.profiler trace (the card's kernels "
                        "when the run is on CUDA) + span-level Chrome trace "
                        "(trace_spans.json) into this dir "
                        "(profiling/trace.py)")
    p.add_argument("--watchdog-timeout", default=None,
                   help="Heartbeat watchdog: classify a stage/device/host "
                        "scope silent this many seconds (stage_stall, "
                        "device_stall, ...) and dump flight_record.json "
                        "(default $MUSICAAL_WATCHDOG_S or 0 = off)")
    p.add_argument("--inject-faults", default=None, metavar="SPEC",
                   help="Deterministic fault injection at named seams, "
                        "e.g. 'ingest.read:error@1;h2d.transfer:delay=2s@3' "
                        "(default $MUSICAAL_FAULTS; grammar in "
                        "resilience/faults.py)")
    if devices:
        p.add_argument("--trace-dir", default=None,
                       help="Capture a torch.profiler trace into this dir "
                            "(Chrome-trace viewable)")
        p.add_argument("--devices", type=int, default=None,
                       help="Ranks of the data-parallel mesh: this process "
                            "is rank 0 and launches the others")


def _check_run_flags(parser: argparse.ArgumentParser,
                     args: argparse.Namespace) -> None:
    # One profiler session per process: torch.profiler cannot nest.
    if getattr(args, "trace_dir", None) and args.profile_dir:
        parser.error("--trace-dir and --profile-dir each capture a device "
                     "trace; give one of them")
    devices = getattr(args, "devices", None)
    if args.command == "sweep":
        if devices and min(devices) < 1:
            parser.error(f"--devices counts must be >= 1, got {devices}")
        return
    if devices is None:
        return
    if devices < 1:
        parser.error(f"--devices must be >= 1, got {devices}")
    if devices > 1 and getattr(args, "weight_quant", "none") != "none":
        parser.error(f"--devices {devices} with --weight-quant "
                     f"{args.weight_quant} {_NOT_PORTED} (weight_quant "
                     "under a mesh)")


def _mesh_ranks(args: argparse.Namespace) -> int:
    """Ranks this run's mesh spans (1: one process, no mesh).  Only
    ``analyze`` and the on-device ``sentiment`` models build a mesh."""
    devices = getattr(args, "devices", None) or 1
    if devices == 1 or args.command not in ("analyze", "sentiment"):
        return 1
    if args.command == "sentiment":
        from music_analyst_tpu_torch.engines.families import mesh_capable

        if not mesh_capable(args.model, args.mock):
            return 1
    return devices


def _run_mesh(args: argparse.Namespace):
    """The mesh of a run launched over ranks (``None`` for one process)."""
    from music_analyst_tpu_torch.parallel import multihost

    if multihost.process_count() == 1:
        return None
    from music_analyst_tpu_torch.parallel.mesh import data_parallel_mesh

    return data_parallel_mesh(multihost.process_count(), device=args.device)


def _add_analyze(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "analyze",
        help="parallel word-count + artist-count over the dataset",
    )
    p.add_argument("dataset", help="Path to the spotify_millsongdata.csv dataset")
    # Reference flags (src/parallel_spotify.c:756-767)
    p.add_argument("--word-limit", type=int, default=0,
                   help="Cap rows in word_counts.csv (0 = unlimited)")
    p.add_argument("--artist-limit", type=int, default=0,
                   help="Cap rows in top_artists.csv (0 = unlimited)")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--limit", type=int, default=None,
                   help="Only process the first N songs")
    p.add_argument("--ingest", choices=("auto", "native", "python"),
                   default="auto")
    p.add_argument("--count-mode", choices=("host-shard", "device-ids"),
                   default="host-shard",
                   help="Histogram layout: host-counted shards merged on "
                        "the card (default) or scatter-add of ids put on "
                        "the card")
    p.add_argument("--no-split", action="store_true",
                   help="Skip writing split_columns/ artifacts")
    p.add_argument("--with-sentiment", action="store_true",
                   help="Joint pipeline: also classify sentiment in this run")
    p.add_argument("--model", default="mock",
                   help="Sentiment model for --with-sentiment")
    p.add_argument("--mock", action="store_true",
                   help="Keyword-kernel sentiment for --with-sentiment")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="Sentiment batch size for --with-sentiment")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="Sentiment batches staged ahead of the device in "
                        "the tokenize→transfer pipeline (default 2, or "
                        "$MUSICAAL_PREFETCH_DEPTH; 0 = no overlap)")
    _add_corpus_cache_flags(p)
    _add_device_flag(p)
    _add_run_flags(p)


def _add_sentiment(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("sentiment", help="batched sentiment classification")
    p.add_argument("dataset")
    # Reference flags (scripts/sentiment_classifier.py:128-136)
    p.add_argument("--model", default="llama3",
                   help="Model family: mock, distilbert[-tiny][-packed]"
                        "[-int8], llama3[-8b|-tiny][-int8] (the 8B needs "
                        "$MUSICAAL_LLAMA_CKPT; $MUSICAAL_CONTINUOUS_SLOTS "
                        "selects continuous generation), ollama[:tag] "
                        "($OLLAMA_ENDPOINT)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--output-dir", default="output")
    p.add_argument("--mock", action="store_true",
                   help="Keyword-kernel backend (no model weights needed)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--resume", action="store_true",
                   help="Continue from an interrupted run's "
                        "sentiment_details.csv")
    p.add_argument("--length-buckets", type=_buckets_arg, default=None,
                   help="Sequence-length buckets for the encoder "
                        "classifier: comma-separated lengths (e.g. "
                        "32,64,128) or 'auto'")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="Batches staged ahead of the device (default 2, "
                        "or $MUSICAAL_PREFETCH_DEPTH; 0 = no overlap)")
    p.add_argument("--weight-quant", choices=("none", "int8", "int4"),
                   default="none",
                   help="Store model weights quantized on the device "
                        "(int8 per-channel / int4 grouped); checkpoints "
                        "stream layer by layer through the quantized "
                        "cache ($MUSICAAL_WQ_CACHE)")
    _add_device_flag(p)
    _add_run_flags(p)


def _add_wordcount_per_song(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "wordcount-per-song",
        help="serial per-song word counts (independent oracle)",
    )
    # Reference flags (scripts/word_count_per_song.py:52-81)
    p.add_argument("csv_path")
    p.add_argument("--output-dir", default="output/serial_word_counts")
    p.add_argument("--encoding", default="utf-8-sig")
    p.add_argument("--delimiter", default=None)
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--chunk-rows", type=int, default=512,
                   help="Rows per tokenize task (streaming granularity; "
                        "bounds in-flight memory)")
    _add_device_flag(p)
    _add_run_flags(p, devices=False)


def _add_split(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("split", help="split a CSV into one file per column")
    # Reference flags (scripts/split_csv_columns.py:73-114)
    p.add_argument("csv_path")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--delimiter", default=None)
    p.add_argument("--quotechar", default='"')
    p.add_argument("--encoding", default="utf-8-sig")
    p.add_argument("--no-header", action="store_true")
    p.add_argument("--force", action="store_true")
    _add_run_flags(p, devices=False)


def _add_validate(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "validate",
        help="certify real weights: label agreement vs a transformers "
             "torch oracle on a dataset slice (engines/validate.py)",
    )
    p.add_argument("dataset")
    p.add_argument("--model", default="distilbert",
                   help="distilbert[-*] or llama[3*]; the checkpoint comes "
                        "from MUSICAAL_DISTILBERT_CKPT / MUSICAAL_LLAMA_CKPT")
    p.add_argument("--limit", type=int, default=64,
                   help="Rows in the validation slice (0 = whole dataset)")
    p.add_argument("--output-dir", default=None,
                   help="Also write weight_validation.json here")
    p.add_argument("--min-agreement", type=float, default=None,
                   help="Exit non-zero when agreement falls below this "
                        "fraction (CI gate)")
    p.add_argument("--weight-quant", choices=("none", "int8", "int4"),
                   default="none",
                   help="Validate the weight-quantized model against the "
                        "float torch oracle (quantization quality gate)")
    _add_device_flag(p)
    _add_run_flags(p, devices=False)


def _add_sweep(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "sweep",
        help="scaling sweep over device counts (run_performance.sh analogue)",
    )
    p.add_argument("dataset")
    p.add_argument("--devices", type=_int_list, default=None,
                   help="Comma-separated device counts, each point a mesh "
                        "of that many ranks, which may share a card "
                        "(default: 1,2,4,8 capped at the cards present; 1 "
                        "with --device cpu)")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--ingest", choices=("auto", "native", "python"),
                   default="auto")
    _add_corpus_cache_flags(p)
    _add_device_flag(p)
    _add_run_flags(p, devices=False)


def _run_validate(args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.engines.validate import run_validation

    report = run_validation(
        args.dataset,
        model=args.model,
        limit=args.limit,
        output_dir=args.output_dir,
        weight_quant=args.weight_quant,
        device=args.device,
    )
    if (args.min_agreement is not None
            and report["agreement"] < args.min_agreement):
        print(f"FAIL: agreement {report['agreement']} < "
              f"{args.min_agreement}", file=sys.stderr)
        return 1
    return 0


def _run_sweep(args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.engines.sweep import run_sweep

    summary = run_sweep(
        args.dataset,
        device_counts=args.devices,
        output_dir=args.output_dir,
        ingest_backend=args.ingest,
        quiet=False,
        corpus_cache_dir=args.corpus_cache_dir,
        use_corpus_cache=not args.no_corpus_cache,
        chunk_songs=args.chunk_songs,
        device=args.device,
        inject_faults=args.inject_faults,
    )
    for run in summary["runs"]:
        print(f"np={run['devices']}: {run['wall_seconds']}s "
              f"(speedup {run['speedup_vs_first']}x)")
    return 0


def _add_serve(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "serve",
        help="resident inference server: newline-delimited JSON over a "
             "unix socket (or --stdio), dynamic batching + warm model "
             "residency (serving/); --replicas N routes over N worker "
             "processes",
    )
    p.add_argument("--model", default="mock",
                   help="Model family: mock, distilbert[-*], llama[3*]")
    p.add_argument("--mock", action="store_true",
                   help="Keyword-kernel backend (no model weights needed)")
    p.add_argument("--weight-quant", choices=("none", "int8", "int4"),
                   default="none",
                   help="Serve the weight-quantized model (loads through "
                        "the persistent $MUSICAAL_WQ_CACHE)")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="Unix socket path to listen on (loopback-only by "
                        "construction)")
    p.add_argument("--stdio", action="store_true",
                   help="Serve one NDJSON stream on stdin/stdout instead "
                        "of a socket (tests, pipelines)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="Flush a batch at this many requests (default "
                        f"$MUSICAAL_SERVE_MAX_BATCH or 32)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="Flush a partial batch once its oldest request "
                        "has waited this long (default "
                        "$MUSICAAL_SERVE_MAX_WAIT_MS or 5.0)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="Admission queue bound; beyond it requests shed "
                        "with a structured queue_full error (default "
                        "$MUSICAAL_SERVE_MAX_QUEUE or 1024)")
    p.add_argument("--slots", type=int, default=None,
                   help="KV slots for the continuous-batching generate op "
                        "(power of two; 0 disables; default "
                        "$MUSICAAL_SERVE_SLOTS or 8; requires a "
                        "generative backend)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="Prompt tokens written per chunked-prefill "
                        "dispatch for the generate op (default "
                        "$MUSICAAL_SERVE_PREFILL_CHUNK or 64)")
    p.add_argument("--max-new-tokens", type=int, default=16,
                   help="Largest per-request generation budget the decode "
                        "runtime is compiled for (generate op)")
    p.add_argument("--page-size", type=int, default=None,
                   help="Tokens per KV page for the paged prefix-shared "
                        "cache (power of two; 0 pins the monolithic "
                        "per-slot cache; default $MUSICAAL_SERVE_PAGE_SIZE "
                        "or 16)")
    p.add_argument("--kv-pages", type=int, default=None,
                   help="Physical KV pages in the device pool (>= slots; "
                        "0 sizes it to slots*pages_per_slot; default "
                        "$MUSICAAL_SERVE_KV_PAGES or 0)")
    p.add_argument("--kv-quant", choices=("none", "int8"), default=None,
                   help="KV-page quantization for the paged cache: int8 "
                        "stores pages as per-row symmetric int8 codes + "
                        "f32 scales (~1.9x less KV HBM per sequence), "
                        "dequantized inside the paged-attention kernel; "
                        "requires --page-size > 0 (default "
                        "$MUSICAAL_SERVE_KV_QUANT or none)")
    p.add_argument("--speculate-k", type=int, default=None,
                   help="Draft tokens per slot per speculative decode "
                        "dispatch (prompt-lookup self-drafting; the "
                        "verify program commits the longest accepted "
                        "prefix + 1 correction token, byte-identical to "
                        "plain decode; 0 disables; default "
                        "$MUSICAAL_SERVE_SPECULATE_K or 0)")
    p.add_argument("--replicas", type=int, default=None,
                   help="Worker server processes behind the replica "
                        "router (join-shortest-queue dispatch, "
                        "health-aware failover; 1 serves in-process; "
                        "default $MUSICAAL_SERVE_REPLICAS or 1); each "
                        "worker runs on this --device")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel width per worker: attention "
                        "heads + KV cache shard over a tp mesh axis "
                        "(must divide kv heads; default "
                        "$MUSICAAL_SERVE_TP or 1; only 1 is ported)")
    p.add_argument("--ttft-slo-ms", type=float, default=None,
                   help="Time-to-first-token target in ms: arms SLO-aware "
                        "preemption (a waiting higher-priority admit may "
                        "slot-steal) and deadline-aware shedding "
                        "(slo_unattainable); 0 disables (default "
                        "$MUSICAAL_SERVE_SLO_TTFT_MS or 0)")
    p.add_argument("--tpot-slo-ms", type=float, default=None,
                   help="Time-per-output-token target in ms: the decode "
                        "loop defers low-priority admits while the "
                        "per-token EWMA is over target; 0 disables "
                        "(default $MUSICAAL_SERVE_SLO_TPOT_MS or 0)")
    p.add_argument("--tenant-budget", type=float, default=None,
                   help="Per-tenant admission budget in requests/second "
                        "(token bucket, burst 2x); an over-budget tenant "
                        "sheds at its own bucket while others keep "
                        "admitting; 0 disables (default "
                        "$MUSICAAL_SERVE_TENANT_BUDGET or 0)")
    p.add_argument("--priority", type=int, default=None,
                   help="Default priority class for requests that don't "
                        "carry one on the wire (higher serves first; "
                        "default $MUSICAAL_SERVE_PRIORITY or 1)")
    p.add_argument("--journal-dir", default=None,
                   help="Durable request journal directory: admitted/"
                        "replied records are fsync'd there, unanswered "
                        "requests replay on restart, and re-sent ids "
                        "return the journaled reply instead of "
                        "recomputing (default $MUSICAAL_SERVE_JOURNAL; "
                        "unset = journaling off)")
    p.add_argument("--no-warmup", action="store_true",
                   help="Skip the startup warmup batches (first request "
                        "pays compile cost)")
    p.add_argument("--quiet", action="store_true",
                   help="Suppress stderr status lines")
    p.add_argument("--trace-sample", default=None, metavar="P",
                   help="Per-request distributed tracing head-sample "
                        "probability in [0, 1]; sampled (plus every shed/"
                        "preempted/requeued/SLO-missed) request flushes "
                        "its span waterfall to request_traces.jsonl under "
                        "--profile-dir (default $MUSICAAL_TRACE_SAMPLE "
                        "or 0; requires --profile-dir or "
                        "$MUSICAAL_TRACE_DIR)")
    p.add_argument("--metrics-interval-ms", default=None, metavar="MS",
                   help="Metrics plane sampling interval in ms: every "
                        "serving counter/gauge/histogram/rate snapshots "
                        "into a ring-buffer time series, flushes to "
                        "metrics.jsonl + a Prometheus exposition file "
                        "under --profile-dir, and feeds multi-window SLO "
                        "burn-rate alerts (default "
                        "$MUSICAAL_METRICS_INTERVAL_MS or 0 = off)")
    p.add_argument("--response-cache-dir", default=None,
                   help="Persistent response-cache directory: settled "
                        "replies are content-addressed (normalized text + "
                        "op + budget + backend fingerprint) and repeat "
                        "requests answer from cache before shedding or "
                        "tenant metering, byte-identical and without a "
                        "device dispatch (default $MUSICAAL_RESPONSE_CACHE "
                        "or ~/.cache/musicaal_responses)")
    p.add_argument("--no-response-cache", action="store_true",
                   help="Disable the response cache (every request "
                        "computes)")
    _add_device_flag(p)
    _add_run_flags(p, devices=False)


def _add_profile_diff(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "profile-diff",
        help="perf-regression gate: compare two run manifests / bench "
             "lines; exit 1 on regression (profiling/diff.py)",
    )
    p.add_argument("a", help="Baseline: run_manifest.json, a bench JSON "
                             "line file, or literal JSON")
    p.add_argument("b", help="Candidate, same formats")
    p.add_argument("--threshold", type=float, default=0.1,
                   help="Relative throughput drop that fails the gate "
                        "(default 0.10)")
    p.add_argument("--wall-threshold", type=float, default=0.25,
                   help="Relative wall-clock growth that fails the gate "
                        "for manifests (default 0.25)")


def _add_telemetry_report(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "telemetry-report",
        help="cross-run analytics: aggregate telemetry dirs / BENCH_r*.json "
             "captures / bench lines into a run-over-run report "
             "(observability/report.py); exit 1 when the newest run failed",
    )
    p.add_argument("sources", nargs="+",
                   help="Run sources, oldest first: telemetry run dirs, "
                        "BENCH_r*.json bench captures, bench-line JSON "
                        "files, or flight_record.json files")
    p.add_argument("--json", action="store_true",
                   help="Emit the aggregated report as one JSON object "
                        "instead of text")


def _add_trace_report(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "trace-report",
        help="per-request waterfalls: reconstruct cross-process traces "
             "from request_traces.jsonl and attribute each request's "
             "wire latency to its phases (observability/report.py); "
             "exit 1 when no complete waterfall was found",
    )
    p.add_argument("sources", nargs="+",
                   help="Trace sources: profile dirs holding "
                        "request_traces*.jsonl, or the .jsonl files "
                        "themselves")
    p.add_argument("--json", action="store_true",
                   help="Emit the reconstructed traces as one JSON object "
                        "instead of waterfall text")


def _add_monitor(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "monitor",
        help="live fleet monitor: attach to a serving socket and render "
             "a refreshing per-replica table (req/s, tokens/s, "
             "occupancy, queue depth, p50/p99, active burn-rate alerts); "
             "host-only (observability/monitor.py)",
    )
    p.add_argument("--socket", required=True, metavar="PATH",
                   help="Unix socket of a live serve front end (single "
                        "server or replica router)")
    p.add_argument("--once", action="store_true",
                   help="Render one snapshot and exit (0 = healthy "
                        "reply, 1 = draining, 2 = no usable reply)")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="Refresh period in seconds (default 2.0)")
    p.add_argument("--json", action="store_true",
                   help="Emit each snapshot as one JSON object instead "
                        "of the table")
    p.add_argument("--idle-bubble-gate", type=float, default=None,
                   metavar="FRAC",
                   help="With --once: also exit 1 when any engine's "
                        "ledger idle_bubble fraction exceeds FRAC "
                        "(0..1) — the goodput health gate")


def _run_analyze(args: argparse.Namespace) -> int:
    common = dict(
        output_dir=args.output_dir,
        word_limit=args.word_limit,
        artist_limit=args.artist_limit,
        limit=args.limit,
        write_split=not args.no_split,
        ingest_backend=args.ingest,
        corpus_cache_dir=args.corpus_cache_dir,
        use_corpus_cache=not args.no_corpus_cache,
        chunk_songs=args.chunk_songs,
        device=args.device,
    )
    from music_analyst_tpu_torch.profiling.trace import maybe_trace

    mesh = _run_mesh(args)
    if mesh is not None:
        common["mesh"] = mesh
    if args.with_sentiment:
        from music_analyst_tpu_torch.engines.joint import run_joint

        with maybe_trace(args.trace_dir, device=args.device):
            run_joint(
                args.dataset,
                model=args.model,
                mock=args.mock,
                batch_size=args.batch_size,
                prefetch_depth=args.prefetch_depth,
                **common,
            )
        return 0
    from music_analyst_tpu_torch.engines.wordcount import run_analysis

    with maybe_trace(args.trace_dir, device=args.device):
        run_analysis(args.dataset, count_mode=args.count_mode, **common)
    return 0


def _run_sentiment(parser: argparse.ArgumentParser,
                   args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.engines.sentiment import run_sentiment

    if args.length_buckets and (
        args.mock or not args.model.startswith("distilbert")
    ):
        parser.error(
            "--length-buckets requires --model distilbert[-*] "
            "(not --mock or decoder models)"
        )
    if args.weight_quant != "none":
        if args.mock or not (args.model.startswith("distilbert")
                             or args.model.startswith("llama")):
            parser.error(
                "--weight-quant requires an on-device model family "
                "(distilbert[-*] or llama[3*])"
            )
    from music_analyst_tpu_torch.profiling.trace import maybe_trace

    mesh = _run_mesh(args)
    with maybe_trace(args.trace_dir, device=args.device):
        run_sentiment(
            args.dataset,
            mesh=mesh,
            model=args.model,
            mock=args.mock,
            limit=args.limit,
            output_dir=args.output_dir,
            batch_size=args.batch_size,
            resume=args.resume,
            length_buckets=args.length_buckets,
            prefetch_depth=args.prefetch_depth,
            device=args.device,
            weight_quant=args.weight_quant,
        )
    return 0


def _run_wordcount_per_song(args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.device import resolve_device
    from music_analyst_tpu_torch.engines.persong import run_per_song_wordcount

    # Host-only work; the device rule of every entry point still holds
    # (the default cuda refuses a machine without a card).
    resolve_device(args.device)
    run_per_song_wordcount(
        args.csv_path,
        output_dir=args.output_dir,
        encoding=args.encoding,
        delimiter=args.delimiter,
        workers=args.workers,
        chunk_rows=args.chunk_rows,
    )
    return 0


def _run_serve(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.device import resolve_device
    from music_analyst_tpu_torch.serving.batcher import (
        resolve_replicas,
        resolve_tp,
    )
    from music_analyst_tpu_torch.serving.server import run_server

    if not args.stdio and not args.socket:
        parser.error("serve requires --socket PATH or --stdio")
    if args.weight_quant != "none" and (
        args.mock or not (args.model.startswith("distilbert")
                          or args.model.startswith("llama"))
    ):
        parser.error(
            "--weight-quant requires an on-device model family "
            "(distilbert[-*] or llama[3*])"
        )
    try:
        replicas, tp = resolve_replicas(args.replicas), resolve_tp(args.tp)
    except ValueError as exc:
        parser.error(str(exc))
    if tp > 1:
        parser.error(f"--tp {tp} {_NOT_PORTED}")
    resolve_device(args.device)
    try:
        common = dict(
            model=args.model,
            mock=args.mock,
            weight_quant=(None if args.weight_quant == "none"
                          else args.weight_quant),
            stdio=args.stdio,
            socket_path=args.socket,
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue,
            warmup=not args.no_warmup,
            quiet=args.quiet,
            slots=args.slots,
            prefill_chunk=args.prefill_chunk,
            max_new_tokens=args.max_new_tokens,
            page_size=args.page_size,
            kv_pages=args.kv_pages,
            kv_quant=args.kv_quant,
            speculate_k=args.speculate_k,
            tp=args.tp,
            ttft_slo_ms=args.ttft_slo_ms,
            tpot_slo_ms=args.tpot_slo_ms,
            tenant_budget=args.tenant_budget,
            priority=args.priority,
            journal_dir=args.journal_dir,
            trace_sample=args.trace_sample,
            trace_dir=args.profile_dir,
            metrics_interval_ms=args.metrics_interval_ms,
            response_cache_dir=args.response_cache_dir,
            use_response_cache=not args.no_response_cache,
            device=args.device,
        )
        if replicas > 1:
            from music_analyst_tpu_torch.serving.router import run_router

            return run_router(replicas=replicas, **common)
        return run_server(**common)
    except ValueError as exc:
        parser.error(str(exc))
    return 2


def _run_split(args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.data.splitter import split_csv_columns
    from music_analyst_tpu_torch.telemetry import get_telemetry

    # The splitter has no engine scope of its own; sink only where
    # --telemetry-dir points (None ⇒ memory-only), never into the split
    # output dir, whose listing is a compared artifact.
    with get_telemetry().run_scope("split", None):
        out_dir, names = split_csv_columns(
            args.csv_path,
            output_dir=args.output_dir,
            delimiter=args.delimiter,
            quotechar=args.quotechar,
            encoding=args.encoding,
            no_header=args.no_header,
            force=args.force,
        )
    print(f"Wrote {len(names)} column file(s) to {out_dir}:")
    for name in names:
        print(f"  {out_dir / name}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="music_analyst_tpu_torch",
        description="Spotify lyrics analytics on PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_analyze(sub)
    _add_sentiment(sub)
    _add_wordcount_per_song(sub)
    _add_split(sub)
    _add_serve(sub)
    _add_sweep(sub)
    _add_validate(sub)
    _add_profile_diff(sub)
    _add_telemetry_report(sub)
    _add_trace_report(sub)
    _add_monitor(sub)
    args = parser.parse_args(argv)

    # The host-only tools: no telemetry scope, no device, no torch import.
    if args.command == "profile-diff":
        from music_analyst_tpu_torch.profiling.diff import run_profile_diff

        return run_profile_diff(args.a, args.b, threshold=args.threshold,
                                wall_threshold=args.wall_threshold)
    if args.command == "telemetry-report":
        from music_analyst_tpu_torch.observability.report import (
            run_telemetry_report,
        )

        return run_telemetry_report(args.sources, json_output=args.json)
    if args.command == "trace-report":
        from music_analyst_tpu_torch.observability.report import (
            run_trace_report,
        )

        return run_trace_report(args.sources, json_output=args.json)
    if args.command == "monitor":
        from music_analyst_tpu_torch.observability.monitor import run_monitor

        return run_monitor(
            args.socket, once=args.once, interval_s=args.interval,
            json_output=args.json, idle_bubble_gate=args.idle_bubble_gate,
        )

    _check_run_flags(parser, args)
    from music_analyst_tpu_torch.parallel import launch

    if launch.launched_rank() is not None:
        return _run_launched_rank(parser, args)
    n_ranks = _mesh_ranks(args)
    if n_ranks > 1:
        # --devices N on CUDA needs a card: run_ranks checks before rank 0
        # joins, and stops the ranks it started.
        argv = list(sys.argv[1:] if argv is None else argv)
        staging = _stage_outputs(args)
        return launch.run_ranks(
            launch.module_command(argv), n_ranks, args.device,
            lambda: _report_launches(_run_scoped(parser, args, staging)),
            staging=staging)
    return _run_scoped(parser, args)


def _stage_outputs(args: argparse.Namespace):
    """Rank 0 of a mesh writes into a staging directory that
    ``run_ranks`` publishes once every rank has exited 0: ``--output-dir``
    and every path flag that lies under it are pointed there.  The
    telemetry log and a resumed details file are appended to, so they are
    carried in first.  A ``--telemetry-dir``, ``--profile-dir`` or
    ``--trace-dir`` elsewhere is written in place.

    So ``sentiment --devices N`` keeps its crash-resume contract only at
    the level of whole runs: the rows it classifies reach the output
    directory with its publish, and a run whose rank fails, or whose
    rank 0 is killed, adds nothing to the details prefix that
    ``--resume`` continues from (the last published one)."""
    from music_analyst_tpu_torch.parallel.launch import Staging

    carry = [os.path.join(args.telemetry_dir or args.output_dir,
                          "telemetry.jsonl")]
    if getattr(args, "resume", False):
        carry.append(os.path.join(args.output_dir, "sentiment_details.csv"))
    staging = Staging(args.output_dir, carry=carry)
    for flag in ("telemetry_dir", "profile_dir", "trace_dir"):
        path = getattr(args, flag, None)
        if path:
            setattr(args, flag, staging.staged(path))
    args.output_dir = staging.path
    return staging


def _run_launched_rank(parser: argparse.ArgumentParser,
                       args: argparse.Namespace) -> int:
    """A rank launched by ``run_ranks``: join its group, run the same
    command writing nothing (no telemetry, no profile, no flight
    record; the engines write on the coordinator only), leave."""
    from music_analyst_tpu_torch.parallel import multihost
    from music_analyst_tpu_torch.resilience.faults import (
        configure_faults,
        resolve_fault_spec,
    )
    from music_analyst_tpu_torch.telemetry import configure

    configure(enabled=False, directory=None)
    configure_faults(resolve_fault_spec(args.inject_faults))
    multihost.join_from_env()
    try:
        return _report_launches(_dispatch(parser, args))
    finally:
        multihost.shutdown()


def _report_launches(code: int) -> int:
    """Each rank of a mesh run counts its own kernel launches; it names
    them on stderr when its command has run, in one write with its
    newline, since every rank shares the stream (``print`` writes the
    newline apart, and an unbuffered stderr lets another rank's line
    in between)."""
    import json

    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.parallel import multihost

    counts = json.dumps(kernels.launches(), sort_keys=True)
    sys.stderr.write(f"mesh: rank {multihost.process_index()} kernel "
                     f"launches {counts}\n")
    sys.stderr.flush()
    return code


def _run_scoped(parser: argparse.ArgumentParser,
                args: argparse.Namespace, staging=None) -> int:
    from music_analyst_tpu_torch.observability.flight import (
        install_flight_recorder,
    )
    from music_analyst_tpu_torch.observability.watchdog import (
        resolve_watchdog_timeout,
        start_watchdog,
    )
    from music_analyst_tpu_torch.profiling.trace import profile_run
    from music_analyst_tpu_torch.resilience.faults import (
        configure_faults,
        resolve_fault_spec,
    )
    from music_analyst_tpu_torch.telemetry import configure

    configure(enabled=not args.no_telemetry, directory=args.telemetry_dir,
              published=staging.published if staging else None)
    # Every run-scoped subcommand flies with the recorder installed: an
    # unhandled exception or SIGTERM leaves flight_record.json behind.
    # The watchdog is opt-in (--watchdog-timeout / $MUSICAAL_WATCHDOG_S).
    install_flight_recorder()
    try:
        start_watchdog(resolve_watchdog_timeout(args.watchdog_timeout))
    except ValueError as exc:
        parser.error(str(exc))
    # Fault injection is explicit chaos tooling: a malformed spec (flag
    # OR env) is a hard usage error, never a silent no-op.
    try:
        configure_faults(resolve_fault_spec(args.inject_faults))
    except ValueError as exc:
        parser.error(str(exc))
    with profile_run(args.profile_dir,
                     device=getattr(args, "device", "cpu")):
        return _dispatch(parser, args)


def _dispatch(parser: argparse.ArgumentParser,
              args: argparse.Namespace) -> int:
    if args.command == "analyze":
        return _run_analyze(args)
    if args.command == "sentiment":
        return _run_sentiment(parser, args)
    if args.command == "wordcount-per-song":
        return _run_wordcount_per_song(args)
    if args.command == "split":
        return _run_split(args)
    if args.command == "serve":
        return _run_serve(parser, args)
    if args.command == "sweep":
        return _run_sweep(args)
    if args.command == "validate":
        return _run_validate(args)
    parser.error(f"unknown command {args.command!r}")
    return 2
