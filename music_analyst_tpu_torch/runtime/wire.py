"""Host→device wire: narrow integer payloads, ship them from pinned memory.

Counterpart of ``music_analyst_tpu/runtime/wire.py`` for the pieces the
sentiment path uses.  Token ids travel as int16 when the vocab fits 2^15
(the classifier decides), and lengths / segment starts / row lengths as
int16 whenever every representable position fits (:func:`narrow_lengths`);
the forward widens them on the device.  :func:`to_device` stages each host
array in page-locked memory and copies it with ``non_blocking=True``, so
the copy runs on the card's copy engine while the host moves on.
:func:`count_h2d_bytes` counts each transfer's payload into the run's
telemetry, as in JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.telemetry import get_telemetry

_INT16_MAX = 1 << 15


def narrow_lengths(values: np.ndarray, max_value: int) -> np.ndarray:
    """Cast an integer payload to int16 when every representable value
    (``0..max_value``) fits, else int32.  Lossless by construction."""
    dtype = np.int16 if max_value < _INT16_MAX else np.int32
    return np.asarray(values, dtype=dtype)


def to_device(
    arrays: Sequence[np.ndarray], device: torch.device
) -> Tuple[torch.Tensor, ...]:
    """Place host arrays on ``device``: pinned staging + asynchronous copy
    for CUDA (the caching host allocator keeps each staging buffer alive
    until its copy has run), a zero-copy view for the CPU."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def count_h2d_bytes(
    arrays: Sequence[Any],
    baseline_bytes: Optional[int] = None,
    prefix: str = "pipeline",
) -> int:
    """Count one transfer's payload bytes into the run's telemetry.

    ``<prefix>.h2d_bytes`` accumulates what actually shipped;
    ``<prefix>.h2d_bytes_saved`` accumulates the reduction against
    ``baseline_bytes`` — by default the 4-bytes-per-element wire every
    payload used before narrowing.  Returns the shipped byte count.
    """
    shipped = sum(int(a.nbytes) for a in arrays)
    if baseline_bytes is None:
        baseline_bytes = sum(int(a.size) * 4 for a in arrays)
    tel = get_telemetry()
    tel.count(f"{prefix}.h2d_bytes", shipped)
    saved = int(baseline_bytes) - shipped
    if saved > 0:
        tel.count(f"{prefix}.h2d_bytes_saved", saved)
    return shipped
