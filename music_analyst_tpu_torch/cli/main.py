"""Command-line surface of the port: ``python -m music_analyst_tpu_torch``.

Counterpart of ``music_analyst_tpu/cli/main.py`` for the subcommand ported
so far, ``sentiment``, with the JAX flags that apply to it plus
``--device {cuda,cpu}`` (the counterpart of ``JAX_PLATFORMS``; default
``cuda``, which fails rather than falling back when no card is present).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


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
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Run on the CUDA card (default) or the CPU")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="music_analyst_tpu_torch",
        description="Spotify lyrics analytics on PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_sentiment(sub)
    args = parser.parse_args(argv)

    if args.command == "sentiment":
        from music_analyst_tpu_torch.engines.sentiment import run_sentiment

        if args.length_buckets and (
            args.mock or not args.model.startswith("distilbert")
        ):
            parser.error(
                "--length-buckets requires --model distilbert[-*] "
                "(not --mock or decoder models)"
            )
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
    parser.error(f"unknown command {args.command!r}")
    return 2
