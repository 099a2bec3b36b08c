"""Synthetic Spotify-like dataset generator.

The real ``spotify_millsongdata.csv`` is stripped from the reference repo
(``.MISSING_LARGE_BLOBS``), so benchmarks and stress tests synthesize a
dataset with the same shape: columns ``artist,song,link,text``, lyrics of
a few hundred words with newlines, quotes, punctuation, apostrophes and the
sentiment keywords at realistic rates.

Copy of ``music_analyst_tpu/data/synthetic.py:generate_dataset``: the same
seed gives the same file in both packages.
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np

_WORDS = (
    "love heart night time baby life world dream feel know way day eyes "
    "light fire rain soul mind home road song dance sweet blue sun moon "
    "star sky hand face kiss tear smile cry pain joy happy lonely sad "
    "tears sunshine wanna gonna ain't don't can't i'm you're it's never "
    "always together forever yesterday tomorrow remember forget believe "
    "break fall rise run walk stand hold touch whisper scream silence "
    "música coração noite amor céu"
).split()

_ARTIST_FIRST = (
    "The Midnight Electric Golden Silver Crimson Velvet Neon Lunar Solar "
    "Wild Broken Silent Lost Royal"
).split()
_ARTIST_SECOND = (
    "Echoes Rivers Wolves Hearts Shadows Lights Dreamers Strangers "
    "Horizons Sparrows Tides O'Brien Sons, Daughters"
).split()


def generate_dataset(
    path: str,
    num_songs: int = 10_000,
    seed: int = 0,
    mean_words: int = 180,
    num_artists: Optional[int] = None,
) -> None:
    """Write a synthetic dataset CSV with ``num_songs`` rows."""
    rng = np.random.default_rng(seed)
    if num_artists is None:
        num_artists = max(1, num_songs // 25)
    artists = [
        f"{rng.choice(_ARTIST_FIRST)} {rng.choice(_ARTIST_SECOND)} {i}"
        for i in range(num_artists)
    ]
    words = np.array(_WORDS)
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh)
        writer.writerow(["artist", "song", "link", "text"])
        for i in range(num_songs):
            artist = artists[int(rng.integers(0, num_artists))]
            n_words = max(5, int(rng.normal(mean_words, mean_words // 3)))
            lyric_words = rng.choice(words, size=n_words)
            # newline every ~8 words, like real lyric rows
            parts = []
            for j in range(0, n_words, 8):
                parts.append(" ".join(lyric_words[j : j + 8]))
            text = "  \n".join(parts)
            if i % 97 == 0:
                text = f'She said "{text[:40]}" and left'
            writer.writerow(
                [artist, f"Song {i}", f"/x/{i}.html", text]
            )
