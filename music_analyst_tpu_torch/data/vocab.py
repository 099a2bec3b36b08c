"""String→id vocabulary: the bridge between host strings and device ints.

Copy of ``music_analyst_tpu/data/vocab.py``.  The reference's MPI build
ships string-keyed hash tables between ranks
(``src/parallel_spotify.c:396-432``); here strings stay on the host, this
class assigns dense int32 ids, and the card counts dense id streams
(``ops/histogram.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Vocab:
    """Insertion-ordered string→int32 id map."""

    __slots__ = ("_index", "_tokens")

    def __init__(self, tokens: Iterable[str] = ()) -> None:
        self._index: Dict[str, int] = {}
        self._tokens: List[str] = []
        for tok in tokens:
            self.add(tok)

    def add(self, token: str) -> int:
        idx = self._index.get(token)
        if idx is None:
            idx = len(self._tokens)
            self._index[token] = idx
            self._tokens.append(token)
        return idx

    def get(self, token: str, default: int = -1) -> int:
        return self._index.get(token, default)

    def __len__(self) -> int:
        return len(self._tokens)

    def __contains__(self, token: str) -> bool:
        return token in self._index

    @property
    def tokens(self) -> List[str]:
        return self._tokens

    def token(self, idx: int) -> str:
        return self._tokens[idx]

    def counts_to_entries(self, counts: np.ndarray) -> List[Tuple[str, int]]:
        """Pair each vocab string with its dense count; drop zero counts."""
        out: List[Tuple[str, int]] = []
        for idx, value in enumerate(np.asarray(counts).tolist()):
            if value:
                out.append((self._tokens[idx], int(value)))
        return out


def encode_corpus(
    token_lists: Iterable[Sequence[str]],
    vocab: Vocab | None = None,
) -> Tuple[Vocab, np.ndarray, np.ndarray]:
    """Flatten per-song token lists into device-ready dense arrays.

    Returns ``(vocab, flat_ids int32[N], offsets int64[S+1])`` where song
    ``s`` owns ``flat_ids[offsets[s]:offsets[s+1]]``.  This is the host→HBM
    handoff format shared with the native C++ ingest.
    """
    if vocab is None:
        vocab = Vocab()
    ids: List[int] = []
    offsets: List[int] = [0]
    add = vocab.add
    for toks in token_lists:
        ids.extend(add(t) for t in toks)
        offsets.append(len(ids))
    return vocab, np.asarray(ids, dtype=np.int32), np.asarray(offsets, dtype=np.int64)
