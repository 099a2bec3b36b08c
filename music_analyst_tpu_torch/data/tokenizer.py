"""Reference-exact lyric tokenizers (the port's copy).

Copy of ``music_analyst_tpu/data/tokenizer.py``; the port keeps its own so
it imports nothing of the JAX package.  The reference has two divergent
tokenizers (SURVEY.md §2.2 P7 vs §2.1 C6):

* the C path (reference ``src/parallel_spotify.c:350-394``): byte-wise,
  token chars are ASCII alphanumerics (lowercased) plus apostrophe, anything
  else is a separator (non-ASCII UTF-8 bytes break tokens), tokens counted
  only when >= 3 **bytes** long.  This is the parity target for
  ``word_counts.csv``.
* the serial Python tool (reference ``scripts/word_count_per_song.py:
  27-39``): regex ``[0-9A-Za-zÀ-ÖØ-öø-ÿ']+`` (Latin-1 accented letters are
  token chars), Unicode lowercase, >= 3 **characters**, tokens made only of
  apostrophes rejected.

The C semantics are also implemented in C++ (``native/ingest.cpp``) for
the production ingest path; this module is the oracle it is tested
against.
"""

from __future__ import annotations

import re
from typing import Iterator, List

# Token chars of the C tokenizer: C-locale isalnum() bytes plus apostrophe
# (reference src/parallel_spotify.c:359).  Operating on ``bytes`` makes every
# non-ASCII UTF-8 byte a separator, exactly like the reference's byte loop.
_ASCII_TOKEN_RE = re.compile(rb"[0-9A-Za-z']+")

# Reference scripts/word_count_per_song.py:27 — note the explicit Latin-1
# accent ranges; this is NOT the same token-character set as the C path.
LATIN1_TOKEN_RE = re.compile(r"[0-9A-Za-zÀ-ÖØ-öø-ÿ']+", re.UNICODE)

MIN_TOKEN_LEN = 3


def tokenize_ascii(text: str | bytes) -> List[str]:
    """Tokenize with the C binary's exact semantics.

    Accepts ``str`` (encoded to UTF-8 first, as the reference reads raw file
    bytes) or ``bytes``.  Returns lowercase ASCII tokens of length >= 3
    bytes.  Apostrophes count toward length and are preserved (a token may
    even be all-apostrophes, e.g. ``'''`` — the reference counts it,
    src/parallel_spotify.c:378-381).
    """
    if isinstance(text, str):
        data = text.encode("utf-8", errors="surrogateescape")
    else:
        data = text
    out: List[str] = []
    append = out.append
    for match in _ASCII_TOKEN_RE.finditer(data):
        tok = match.group()
        if len(tok) >= MIN_TOKEN_LEN:
            # bytes.lower() lowercases exactly the ASCII A-Z range, matching
            # per-byte tolower() in the C locale.
            append(tok.lower().decode("ascii"))
    return out


def tokenize_latin1(text: str) -> Iterator[str]:
    """Tokenize with the serial Python tool's exact semantics.

    Yields lowercase tokens of >= 3 characters; tokens containing no
    alphanumeric character (i.e. all apostrophes) are rejected
    (reference scripts/word_count_per_song.py:30-39).
    """
    for match in LATIN1_TOKEN_RE.finditer(text):
        token = match.group().lower()
        if len(token) < MIN_TOKEN_LEN:
            continue
        if not any(ch.isalnum() for ch in token):
            continue
        yield token
