"""Host↔device runtime plane: the H2D wire and the prefetch pipeline."""

from music_analyst_tpu_torch.runtime.prefetch import (
    DEFAULT_PREFETCH_DEPTH,
    PrefetchPipeline,
    Stage,
    resolve_prefetch_depth,
)

__all__ = [
    "DEFAULT_PREFETCH_DEPTH",
    "PrefetchPipeline",
    "Stage",
    "resolve_prefetch_depth",
]
