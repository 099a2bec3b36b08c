import sys

from music_analyst_tpu_torch.cli.main import main

if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except Exception as exc:  # top-level error reporting, like the reference
        print(f"Error: {exc}", file=sys.stderr)
        raise
