"""Shared jit-shape bucketing policy.

Everything dispatched to the device rounds its dynamic sizes up to a
bounded set of compiled shapes (XLA compiles per shape; unbounded shape
churn defeats the compilation cache).  The rounding rule lives here once —
histogram rows, keyword-kernel byte buckets, encoder row counts, and
decoder prompt widths all share it.
"""

from __future__ import annotations


def round_pow2(n: int, floor: int) -> int:
    """Round ``n`` up to a power of two (≥ ``floor``): stable jit shapes,
    ≤ 2× padding, O(log) distinct compiled programs."""
    size = floor
    while size < n:
        size <<= 1
    return size
