"""CSV ingest and export with the reference's exact field semantics.

The port's copy of ``music_analyst_tpu/data/csv_io.py`` (it imports nothing
of the JAX package).  Three access paths:

* :func:`iter_songs` — fast ``csv.DictReader`` path over the
  ``artist,song,link,text`` dataset, mirroring the sentiment pipeline's
  reader (reference ``scripts/sentiment_classifier.py:111-118``).
* the *exact* byte-level record reader / field extractor replicating the C
  binary's parser (reference ``src/parallel_spotify.c:549-633`` record
  reader, ``:258-304`` line parser, ``:215-255`` field duplication).  Used
  by parity tests and as the oracle for the native C++ ingest.
* :func:`write_count_csv` — the count-table CSV writer: rows sorted count
  descending, ties byte-wise ascending, keys always quoted with ``""``
  doubling (reference ``src/parallel_spotify.c:178-188,307-344``).
"""

from __future__ import annotations

import csv
from typing import BinaryIO, Iterable, Iterator, List, Optional, Sequence, Tuple

# C-locale isspace() byte set (reference trims fields with isspace,
# src/parallel_spotify.c:191-208).
C_WHITESPACE = b" \t\n\r\x0b\x0c"

_QUOTE = 0x22  # '"'
_COMMA = 0x2C
_NL = 0x0A
_CR = 0x0D


def whole_rows_length(raw: BinaryIO) -> int:
    """Bytes of the longest prefix of the CSV in ``raw`` (read from its
    position to its end) that holds whole rows only: a newline ends a row
    iff the quote count of the prefix ending there is even (a newline
    inside an open quoted field is row content), so a row torn by a
    killed writer is left out."""
    keep = quotes = size = 0
    while chunk := raw.read(1 << 22):
        start = 0
        while (nl := chunk.find(b"\n", start)) >= 0:
            quotes += chunk.count(b'"', start, nl)
            if quotes % 2 == 0:
                keep = size + nl + 1
            start = nl + 1
        quotes += chunk.count(b'"', start)
        size += len(chunk)
    return keep


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


def sniff_delimiter(sample: str, fallback: str = ",") -> str:
    """Delimiter of a CSV sample via ``csv.Sniffer``.

    Used by the per-song tool (reference
    ``scripts/word_count_per_song.py:42-49`` sniffs a 64 KiB sample, comma
    fallback).  The generic splitter needs the full dialect, not just the
    delimiter — see ``data/splitter.py:_resolve_format``.
    """
    try:
        return csv.Sniffer().sniff(sample).delimiter
    except csv.Error:
        return fallback


def iter_csv_records_exact(data: bytes) -> Iterator[bytes]:
    """Split a CSV byte stream into records, quotes-aware.

    Exact re-implementation of the reference's record reader
    (``src/parallel_spotify.c:549-633``): a record ends at an unquoted
    newline; ``""`` inside a quoted field is kept verbatim; a lone ``\\r``
    or ``\\r\\n`` both terminate a record (the terminator bytes are included
    in the yielded record, as in the reference).
    """
    i = 0
    n = len(data)
    while i < n:
        start = i
        in_quotes = False
        while i < n:
            ch = data[i]
            i += 1
            if ch == _QUOTE:
                if not in_quotes:
                    in_quotes = True
                elif i < n and data[i] == _QUOTE:
                    i += 1  # escaped quote stays inside the field
                else:
                    in_quotes = False
            elif (ch == _NL or ch == _CR) and not in_quotes:
                if ch == _CR and i < n and data[i] == _NL:
                    i += 1
                break
        yield data[start:i]


def clean_field(raw: bytes, preserve_outer_quotes: bool = False) -> bytes:
    """Normalize one CSV field exactly like the reference's field duplicator.

    Reference ``src/parallel_spotify.c:215-255``: trim C whitespace; if the
    trimmed field is wrapped in quotes, either keep it verbatim
    (``preserve_outer_quotes``) or strip the quotes and collapse ``""`` to
    ``"``; then trim again.
    """
    stripped = raw.strip(C_WHITESPACE)
    quoted = (
        len(stripped) >= 2
        and stripped[:1] == b'"'
        and stripped[-1:] == b'"'
    )
    if preserve_outer_quotes and quoted:
        out = stripped
    else:
        inner = stripped[1:-1] if quoted else stripped
        out = inner.replace(b'""', b'"')
    return out.strip(C_WHITESPACE)


def _split_record_fields(
    record: bytes,
) -> Optional[Tuple[bytes, bytes, bytes, bytes]]:
    """Split one record at its first three unquoted commas.

    Returns raw ``(field0, field1, field2, rest)`` or ``None`` for records
    with fewer than three unquoted commas (the reference rejects them,
    ``src/parallel_spotify.c:258-304``).
    """
    line = record.rstrip(b"\r\n")
    fields: List[bytes] = []
    in_quotes = False
    start = 0
    i = 0
    n = len(line)
    while i < n:
        ch = line[i]
        if ch == _QUOTE:
            if in_quotes and i + 1 < n and line[i + 1] == _QUOTE:
                i += 1
            else:
                in_quotes = not in_quotes
        elif ch == _COMMA and not in_quotes:
            fields.append(line[start:i])
            start = i + 1
            if len(fields) == 3:
                break
        i += 1
    if len(fields) < 3:
        return None
    return fields[0], fields[1], fields[2], line[start:]


def parse_record_exact(
    record: bytes,
    preserve_artist_quotes: bool = False,
    preserve_text_quotes: bool = False,
) -> Optional[Tuple[bytes, bytes]]:
    """Extract ``(artist, text)`` from one record, reference semantics.

    Reference ``src/parallel_spotify.c:258-304``: split on unquoted commas;
    field 0 is the artist; the *text* is everything after the third unquoted
    comma (untouched — it may itself contain unquoted commas).  Records with
    fewer than three unquoted commas are rejected (``None``).
    """
    split = _split_record_fields(record)
    if split is None:
        return None
    field0, _, _, rest = split
    return (
        clean_field(field0, preserve_artist_quotes),
        clean_field(rest, preserve_text_quotes),
    )


def parse_record_fields(
    record: bytes,
) -> Optional[Tuple[bytes, bytes, bytes]]:
    """Extract cleaned ``(artist, song, text)`` from one record.

    Same splitting/cleaning semantics as :func:`parse_record_exact`, plus
    the *song* column (field 1) — the fused joint pipeline classifies
    sentiment from the very records the histogram pass parsed, and its
    details CSV needs the song title.
    """
    split = _split_record_fields(record)
    if split is None:
        return None
    field0, field1, _, rest = split
    return clean_field(field0), clean_field(field1), clean_field(rest)


def _iter_data_records(data: bytes) -> Iterator[bytes]:
    """Every non-blank data record (header skipped) — the reference's
    record-skip semantics (``src/parallel_spotify.c:690-714``), shared by
    the two dataset iterators below so they can never drift apart."""
    records = iter_csv_records_exact(data)
    next(records, None)  # header
    for record in records:
        if record.strip(b"\r\n"):
            yield record


def iter_dataset_exact(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield ``(artist, text)`` for every parseable data record."""
    for record in _iter_data_records(data):
        parsed = parse_record_exact(record)
        if parsed is not None:
            yield parsed


def iter_dataset_fields(data: bytes) -> Iterator[Tuple[bytes, bytes, bytes]]:
    """Yield cleaned ``(artist, song, text)`` for every parseable record."""
    for record in _iter_data_records(data):
        parsed = parse_record_fields(record)
        if parsed is not None:
            yield parsed


def sort_count_entries(
    entries: Iterable[Tuple[str, int]],
) -> List[Tuple[str, int]]:
    """Sort count-descending, ties byte-wise ascending (strcmp order).

    Reference comparator ``src/parallel_spotify.c:178-188``: larger counts
    first, ties broken by ``strcmp`` — reproduced here by comparing the
    UTF-8 bytes of the key (unsigned lexicographic, same as strcmp on the
    reference's raw bytes).
    """
    return sorted(entries, key=lambda kv: (-kv[1], kv[0].encode("utf-8")))


def format_count_row(key: str, value: int) -> str:
    """One output row: key always quoted, inner quotes doubled.

    Reference ``src/parallel_spotify.c:307-319``.
    """
    return '"%s",%d\n' % (key.replace('"', '""'), value)


def write_count_csv(
    path: str,
    key_header: str,
    entries: Sequence[Tuple[str, int]],
    limit: int = 0,
) -> None:
    """Write a sorted count table (reference ``write_table_csv``, :325-344).

    ``limit`` <= 0 means unlimited, matching the reference's default flag
    values (``src/parallel_spotify.c:32-33``).
    """
    from music_analyst_tpu_torch.utils.atomic import atomic_write

    ordered = sort_count_entries(entries)
    if limit > 0:
        ordered = ordered[:limit]
    # Atomic publish: the byte-identity contracts (word_counts.csv vs the
    # reference binary, cold-vs-warm cache, chaos runs) compare whole
    # files — a torn half-write under the final name must be impossible.
    with atomic_write(path, newline="") as fh:
        fh.write("%s,count\n" % key_header)
        for key, value in ordered:
            fh.write(format_count_row(key, value))
