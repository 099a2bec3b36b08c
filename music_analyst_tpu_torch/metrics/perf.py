"""``performance_metrics.json`` writer — reference schema, superset fields.

The port's copy of ``music_analyst_tpu/metrics/perf.py``; the schema is
the same.  Device fields name the card as JAX names a CUDA device:
``platform`` / ``device_platform`` read ``"gpu"`` on the card and
``"cpu"`` on the CPU (:func:`device_platform`), and ``device`` is
``str(torch.device)``, for example ``"cuda:0"``.

The reference writes ``{processes, total_songs, total_words,
compute_time{avg,min,max_seconds}, total_time{...}}`` by hand-formatted
fprintf (``src/parallel_spotify.c:1084-1109``).  This writer reproduces that
schema exactly (keys, nesting, 6-decimal seconds) and appends the TPU-era
extensions: a per-chip timing column, device platform info, and stage
breakdowns.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class TimeStats:
    avg_seconds: float
    min_seconds: float
    max_seconds: float

    @classmethod
    def uniform(cls, seconds: float) -> "TimeStats":
        """SPMD timing: one synchronous program — avg == min == max.

        The reference's per-rank min/avg/max spread comes from MPI ranks
        running asynchronously (``src/parallel_spotify.c:1077-1082``); a
        jitted SPMD program is lock-stepped across chips, so the three
        statistics legitimately coincide.  Paths with genuinely per-chip
        phases use :meth:`from_samples` instead.
        """
        return cls(seconds, seconds, seconds)

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "TimeStats":
        """min/avg/max over per-chip measurements — the honest analogue of
        the reference's six ``MPI_Reduce`` timing statistics
        (``src/parallel_spotify.c:1077-1082``)."""
        if not samples:
            return cls.uniform(0.0)
        return cls(sum(samples) / len(samples), min(samples), max(samples))

    def as_dict(self) -> Dict[str, float]:
        return {
            "avg_seconds": round(self.avg_seconds, 6),
            "min_seconds": round(self.min_seconds, 6),
            "max_seconds": round(self.max_seconds, 6),
        }


def device_platform(device) -> str:
    """``"gpu"`` for a CUDA device (JAX's name for one), else its type."""
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def per_chip_rows(devices, seconds) -> List[Dict[str, Any]]:
    """The ``per_chip`` column: one row per device of the mesh."""
    return [
        {
            "device": str(d),
            "platform": device_platform(d),
            # 9 decimals: the per-shard spread is microseconds on small
            # corpora; 6 would round distinct measurements together.
            "compute_seconds": round(s, 9),
        }
        for d, s in zip(devices, seconds)
    ]


def write_performance_metrics(
    path: str,
    processes: int,
    total_songs: int,
    total_words: int,
    compute_time: TimeStats,
    total_time: TimeStats,
    per_chip: Optional[List[Dict[str, Any]]] = None,
    stages: Optional[Dict[str, float]] = None,
    device_platform: Optional[str] = None,
) -> None:
    payload: Dict[str, Any] = {
        "processes": processes,
        "total_songs": total_songs,
        "total_words": total_words,
        "compute_time": compute_time.as_dict(),
        "total_time": total_time.as_dict(),
    }
    if device_platform is not None:
        payload["device_platform"] = device_platform
    if per_chip is not None:
        payload["per_chip"] = per_chip
    if stages is not None:
        payload["stages"] = {k: round(v, 6) for k, v in stages.items()}
    from music_analyst_tpu_torch.utils.atomic import atomic_write

    with atomic_write(path) as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
