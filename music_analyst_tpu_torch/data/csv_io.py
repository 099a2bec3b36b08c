"""CSV ingest for the sentiment pipeline (copy of the reference reader).

Counterpart of ``music_analyst_tpu/data/csv_io.py:iter_songs``; the port
keeps its own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
from typing import Iterator, Optional, Tuple


def iter_songs(
    path: str,
    limit: Optional[int] = None,
    encoding: str = "utf-8",
) -> Iterator[Tuple[str, str, str]]:
    """Yield ``(artist, song, text)`` rows like the reference sentiment reader.

    Mirrors ``scripts/sentiment_classifier.py:111-118``: ``csv.DictReader``
    over the named columns, optional row limit applied by row index.  One
    deliberate robustness fix: rows shorter than the header give ``None``
    values from ``DictReader`` and the reference would crash on
    ``None.strip()`` — here missing values coerce to ``""``.
    """
    with open(path, newline="", encoding=encoding) as fh:
        reader = csv.DictReader(fh)
        for index, row in enumerate(reader):
            if limit is not None and index >= limit:
                break
            yield (
                row.get("artist") or "",
                row.get("song") or "",
                row.get("text") or "",
            )
