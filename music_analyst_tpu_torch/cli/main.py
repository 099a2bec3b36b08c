"""Command-line surface of the port: ``python -m music_analyst_tpu_torch``.

Counterpart of ``music_analyst_tpu/cli/main.py`` for the subcommands
ported so far — ``analyze`` (with ``--with-sentiment``, the joint
pipeline), ``sentiment`` and ``split`` — with the JAX flags and defaults,
plus ``--device {cuda,cpu}`` on ``analyze`` and ``sentiment`` (the
counterpart of ``JAX_PLATFORMS``; default ``cuda``, which fails rather
than falling back when no card is present).  ``split`` is host-only.

Every JAX flag parses.  A flag whose feature is not ported yet passes at
its default or no-op value (``--no-telemetry``, ``--devices 1``,
``--weight-quant none``, ``--watchdog-timeout 0``) and is a usage error
naming the flag at any other value.
"""

from __future__ import annotations

import argparse
import math
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


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Run on the CUDA card (default) or the CPU")


def _add_run_flags(p: argparse.ArgumentParser, devices: bool = True) -> None:
    """The JAX run-scoped flags (``_add_telemetry_flags``, and
    ``--trace-dir``/``--devices`` where the subcommand has them).  Parsed
    as in JAX; :func:`_check_run_flags` admits only their no-op values."""
    p.add_argument("--telemetry-dir", default=None,
                   help="Telemetry output dir (not yet ported)")
    p.add_argument("--no-telemetry", action="store_true",
                   help="Disable run telemetry (the port writes none yet)")
    p.add_argument("--profile-dir", default=None,
                   help="Profiler trace dir (not yet ported)")
    p.add_argument("--watchdog-timeout", default=None,
                   help="Heartbeat watchdog seconds; only 0 (disabled) "
                        "runs in the port")
    p.add_argument("--inject-faults", default=None, metavar="SPEC",
                   help="Fault injection (not yet ported)")
    if devices:
        p.add_argument("--trace-dir", default=None,
                       help="Profiler trace dir (not yet ported)")
        p.add_argument("--devices", type=int, default=None,
                       help="Devices of the mesh; the port runs on one")


def _check_run_flags(parser: argparse.ArgumentParser,
                     args: argparse.Namespace) -> None:
    for flag in ("telemetry_dir", "profile_dir", "inject_faults",
                 "trace_dir"):
        if getattr(args, flag, None) is not None:
            parser.error(f"--{flag.replace('_', '-')} {_NOT_PORTED}")
    if args.watchdog_timeout is not None:
        try:
            seconds = float(args.watchdog_timeout)
        except ValueError:
            parser.error("watchdog timeout must be a number of seconds >= 0, "
                         f"got {args.watchdog_timeout!r}")
        if not math.isfinite(seconds) or seconds < 0:
            parser.error(f"watchdog timeout must be finite and >= 0, "
                         f"got {seconds}")
        if seconds != 0:
            parser.error(f"--watchdog-timeout {_NOT_PORTED} (only 0 runs)")
    devices = getattr(args, "devices", None)
    if devices is not None and devices != 1:
        parser.error(f"--devices {devices} {_NOT_PORTED} (one device only)")


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
    _add_device_flag(p)
    _add_run_flags(p)


def _add_sentiment(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("sentiment", help="batched sentiment classification")
    p.add_argument("dataset")
    # Reference flags (scripts/sentiment_classifier.py:128-136)
    p.add_argument("--model", default="llama3",
                   help="Model family: mock, distilbert[-tiny][-packed], "
                        "llama3[-8b|-tiny] (the 8B needs "
                        "$MUSICAAL_LLAMA_CKPT; $MUSICAAL_CONTINUOUS_SLOTS "
                        "selects continuous generation)")
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
                   help="Quantized weight store (only 'none' is ported)")
    _add_device_flag(p)
    _add_run_flags(p)


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
    if args.with_sentiment:
        from music_analyst_tpu_torch.engines.joint import run_joint

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
        parser.error(f"--weight-quant {args.weight_quant} {_NOT_PORTED}")
    run_sentiment(
        args.dataset,
        model=args.model,
        mock=args.mock,
        limit=args.limit,
        output_dir=args.output_dir,
        batch_size=args.batch_size,
        resume=args.resume,
        length_buckets=args.length_buckets,
        prefetch_depth=args.prefetch_depth,
        device=args.device,
    )
    return 0


def _run_split(args: argparse.Namespace) -> int:
    from music_analyst_tpu_torch.data.splitter import split_csv_columns

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
    _add_split(sub)
    args = parser.parse_args(argv)
    _check_run_flags(parser, args)

    if args.command == "analyze":
        return _run_analyze(args)
    if args.command == "sentiment":
        return _run_sentiment(parser, args)
    if args.command == "split":
        return _run_split(args)
    parser.error(f"unknown command {args.command!r}")
    return 2
