"""CSV column splitting: the dataset preprocessor and the generic tool.

The port's copy of ``music_analyst_tpu/data/splitter.py`` (host-only).
Two distinct splitters exist in the reference and both are reproduced:

* the in-process dataset splitter the analysis binary runs on rank 0
  (``src/parallel_spotify.c:640-721``): writes
  ``split_columns/<artist>.csv`` + ``<text>.csv``, one record per line with
  the original quoting preserved, header label as first line;
* the standalone generic splitter (``scripts/split_csv_columns.py``): one
  file per column of any CSV, named after the sanitized header, with
  collision suffixes, ``--no-header`` / ``--force`` support.
"""

from __future__ import annotations

import csv
import os
import re
from contextlib import ExitStack
from dataclasses import dataclass
from itertools import chain, count
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

from music_analyst_tpu_torch.data.csv_io import (
    iter_csv_records_exact,
    parse_record_exact,
)


def sanitize_header_name(name: str) -> str:
    """Header → filename base, C-binary semantics.

    Reference ``src/parallel_spotify.c:510-543``: drop CR/LF, map other
    whitespace and non ``[A-Za-z0-9-._]`` ASCII chars to ``_``; empty result
    falls back to ``"col"``.  (Non-ASCII bytes are "not alnum" to the C
    locale, so every byte of a multi-byte char becomes ``_``.)
    """
    out = []
    for byte in name.encode("utf-8", errors="surrogateescape"):
        ch = chr(byte)
        if ch in "\r\n":
            continue
        if ch in " \t\v\f":
            out.append("_")
        elif ch.isascii() and (ch.isalnum() or ch in "-._"):
            out.append(ch)
        else:
            out.append("_")
    return "".join(out) or "col"


def sanitize_filename(name: str, max_len: int = 80) -> str:
    """Header → filename base, generic-tool semantics.

    Reference ``scripts/split_csv_columns.py:25-29``: newlines → spaces,
    non ``[\\w\\-. ]`` → ``_`` (Unicode word chars allowed), whitespace runs
    → ``_``, truncated to ``max_len``, fallback ``"col"``.
    """
    name = (name or "").replace("\n", " ").replace("\r", " ").strip()
    name = re.sub(r"[^\w\-. ]+", "_", name, flags=re.UNICODE)
    name = re.sub(r"\s+", "_", name)
    return (name or "col")[:max_len]


def split_dataset_columns(
    dataset_path: str,
    split_dir: str,
    artist_base_name: str,
    text_base_name: str,
    artist_header_label: str,
    text_header_label: str,
    backend: str = "auto",
) -> Tuple[str, str]:
    """Write ``<split_dir>/<artist>.csv`` and ``<text>.csv``.

    Matches the reference splitter (``src/parallel_spotify.c:640-721``):
    header label (or ``Artists``/``Texts`` fallback) on the first line, then
    one record per data row with outer quotes preserved verbatim; records
    with fewer than three unquoted commas are skipped.  Uses the C++ fast
    path when available (byte-identical; tested differentially).
    """
    os.makedirs(split_dir, exist_ok=True)
    artist_path = os.path.join(split_dir, artist_base_name + ".csv")
    text_path = os.path.join(split_dir, text_base_name + ".csv")
    if backend in ("auto", "native"):
        from music_analyst_tpu_torch.data import native

        if native.available():
            native.split_columns_native(
                dataset_path, artist_path, text_path,
                artist_header_label or "Artists",
                text_header_label or "Texts",
            )
            return artist_path, text_path
        if backend == "native":
            raise RuntimeError("native splitter requested but unavailable")
    with open(dataset_path, "rb") as fh:
        data = fh.read()
    records = iter_csv_records_exact(data)
    next(records, None)  # header row
    with open(artist_path, "wb") as artist_fp, open(text_path, "wb") as text_fp:
        artist_fp.write((artist_header_label or "Artists").encode("utf-8") + b"\n")
        text_fp.write((text_header_label or "Texts").encode("utf-8") + b"\n")
        for record in records:
            if not record.strip(b"\r\n"):
                continue
            parsed = parse_record_exact(
                record, preserve_artist_quotes=True, preserve_text_quotes=True
            )
            if parsed is None:
                continue
            artist_raw, text_raw = parsed
            artist_fp.write(artist_raw + b"\n")
            text_fp.write(text_raw + b"\n")
    return artist_path, text_path


def read_header_labels(dataset_path: str) -> Tuple[str, str]:
    """Artist/text header labels from the dataset's first record.

    Mirrors the rank-0 preamble (``src/parallel_spotify.c:788-819``): parse
    the header record with quotes stripped; raises ``ValueError`` when the
    header can't be parsed (the reference aborts).
    """
    with open(dataset_path, "rb") as fh:
        data = fh.read()
    header = next(iter_csv_records_exact(data), None)
    if header is None:
        raise ValueError("Dataset does not contain a header row")
    parsed = parse_record_exact(header)
    if parsed is None:
        raise ValueError("Unable to parse dataset header")
    artist_label, text_label = parsed
    return (
        artist_label.decode("utf-8", errors="replace"),
        text_label.decode("utf-8", errors="replace"),
    )


@dataclass(frozen=True)
class _ColumnCsvFormat:
    """Dialect parameters shared by the generic splitter's reader and its
    column writers (same-format round-trip is what keeps unquoted cells
    unquoted and ``\\n`` line endings stable)."""

    delimiter: str = ","
    quotechar: str = '"'
    skipinitialspace: bool = False

    def dialect_kwargs(self) -> dict:
        return dict(
            delimiter=self.delimiter,
            quotechar=self.quotechar,
            doublequote=True,
            skipinitialspace=self.skipinitialspace,
            lineterminator="\n",
            quoting=csv.QUOTE_MINIMAL,
        )


def _resolve_format(
    fh, delimiter: Optional[str], quotechar: str
) -> _ColumnCsvFormat:
    """Explicit delimiter wins; otherwise sniff a 64 KiB sample and fall
    back to commas (reference tool semantics, SURVEY.md §2.2 P9)."""
    quote = quotechar or '"'
    if delimiter:
        return _ColumnCsvFormat(delimiter, quote)
    mark = fh.tell()
    sample = fh.read(65536)
    fh.seek(mark)
    try:
        sniffed = csv.Sniffer().sniff(sample)
    except csv.Error:
        return _ColumnCsvFormat(",", quote)
    return _ColumnCsvFormat(
        sniffed.delimiter, quote, sniffed.skipinitialspace
    )


def _allocate_column_filenames(
    headers: Sequence[str], out_dir: Path, force: bool
) -> List[str]:
    """``<sanitized>.csv`` per column; duplicates (case-insensitive) and
    pre-existing files (unless ``force``) get ``_2, _3…`` suffixes."""
    taken: set = set()
    names: List[str] = []
    for position, header in enumerate(headers, start=1):
        base = sanitize_filename(str(header)) or f"col{position}"
        for suffix in count(1):
            name = f"{base}.csv" if suffix == 1 else f"{base}_{suffix}.csv"
            blocked = name.lower() in taken or (
                (out_dir / name).exists() and not force
            )
            if not blocked:
                break
        taken.add(name.lower())
        names.append(name)
    return names


def split_csv_columns(
    csv_path: str,
    output_dir: Optional[str] = None,
    delimiter: Optional[str] = None,
    quotechar: str = '"',
    encoding: str = "utf-8-sig",
    no_header: bool = False,
    force: bool = False,
) -> Tuple[Path, List[str]]:
    """Generic one-file-per-column splitter.

    Capability parity with ``scripts/split_csv_columns.py`` (artifact
    bytes pinned by ``tests/test_reference_scripts_differential.py``):
    sanitized header filenames with collision suffixes, header row
    re-emitted into each column file unless ``no_header``, short rows
    padded with empty cells, surplus cells dropped.
    """
    in_path = Path(csv_path)
    if not in_path.exists():
        raise FileNotFoundError(str(in_path))
    out_dir = (
        Path(output_dir)
        if output_dir
        else in_path.parent / f"{in_path.stem}_columns"
    )
    out_dir.mkdir(parents=True, exist_ok=True)

    with open(in_path, "r", encoding=encoding, newline="") as fh:
        fmt = _resolve_format(fh, delimiter, quotechar).dialect_kwargs()
        rows: Iterator[List[str]] = csv.reader(fh, **fmt)
        first = next(rows, None)
        if first is None:
            raise ValueError(f"{in_path} is empty")
        if no_header:
            headers = [f"col{i + 1}" for i in range(len(first))]
            rows = chain([first], rows)  # first row is data, not labels
        else:
            headers = [
                str(cell) if str(cell).strip() else f"col{i + 1}"
                for i, cell in enumerate(first)
            ]
        names = _allocate_column_filenames(headers, out_dir, force)

        with ExitStack() as stack:
            sinks = []
            for header, name in zip(headers, names):
                sink_fh = stack.enter_context(
                    open(out_dir / name, "w", encoding=encoding, newline="")
                )
                sink = csv.writer(sink_fh, **fmt)
                if not no_header:
                    sink.writerow([header])
                sinks.append(sink)
            for row in rows:
                for i, sink in enumerate(sinks):
                    sink.writerow([row[i] if i < len(row) else ""])
    return out_dir, names
