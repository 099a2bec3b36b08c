"""The three-label sentiment contract shared by every classifier backend.

The reference's label set and normalization rules
(``scripts/sentiment_classifier.py:36,102-108``) are part of its public API:
every output artifact speaks ``Positive | Neutral | Negative``.  All three
backends here (keyword kernel, encoder classifier, decoder LM) funnel
through this module so the contract is enforced in exactly one place.
"""

from __future__ import annotations

SUPPORTED_LABELS = ("Positive", "Neutral", "Negative")

# Stable int encoding used on device: scores/argmax indices map through this.
LABEL_TO_ID = {label: i for i, label in enumerate(SUPPORTED_LABELS)}
ID_TO_LABEL = dict(enumerate(SUPPORTED_LABELS))


def normalise_label(output: str) -> str:
    """First whitespace token, title-cased, whitelisted — else ``Neutral``.

    Matches the reference normalizer (``scripts/sentiment_classifier.py:
    102-108``) except for one deliberate fix: the reference crashes with
    ``IndexError`` on an empty model response (``"".split()[0]``); here an
    empty response normalizes to ``Neutral`` (SURVEY.md §5 contract #5).
    """
    parts = output.split()
    if not parts:
        return "Neutral"
    cleaned = parts[0].strip().title()
    if cleaned not in SUPPORTED_LABELS:
        return "Neutral"
    return cleaned


def score_to_label(score: int | float) -> str:
    """Sign-of-score labeling used by the keyword heuristic.

    Reference ``scripts/sentiment_classifier.py:78-83``.
    """
    if score > 0:
        return "Positive"
    if score < 0:
        return "Negative"
    return "Neutral"
