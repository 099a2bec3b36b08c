"""Streaming weight-quantized inference loader.

Counterpart of ``load_quantized_params`` / ``last_load_stats`` in
``music_analyst_tpu/engines/checkpoint.py`` (training-state save and
restore are not ported yet).  HF torch tensors are read one layer-sized
unit at a time (the model families' ``iter_hf_param_units``), quantized on
the host, and copied to the device through the bounded
``runtime/prefetch.py`` pipeline: the copy of unit *k* overlaps the
quantization of unit *k+1*, and the float tree never exists whole
(``last_load_stats()["peak_host_staging_bytes"]`` is the measured peak of
float bytes staged at once).  Quantized leaves are persisted through the
content-addressed ``engines/wq_cache.py``, so a warm load reads codes and
never touches ``torch.load``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.engines import wq_cache
from music_analyst_tpu_torch.ops.quant import (
    WQ_DEFAULT_GROUP,
    QuantizedParam,
    quantize_array,
    wq_rule_for_path,
)
from music_analyst_tpu_torch.runtime.prefetch import (
    PrefetchPipeline,
    Stage,
    resolve_prefetch_depth,
)

_LOAD_LOCK = threading.Lock()
_LAST_LOAD_STATS: Dict[str, Any] = {}


def last_load_stats() -> Dict[str, Any]:
    """Snapshot of the most recent quantized load (empty before any)."""
    with _LOAD_LOCK:
        return dict(_LAST_LOAD_STATS)


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, QuantizedParam):
        return _leaf_bytes(leaf.q) + _leaf_bytes(leaf.scale)
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(math.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize


def _to_device(leaf, device):
    if isinstance(leaf, (QuantizedParam, torch.Tensor)):
        return leaf.to(device)
    # Memory-mapped cache arrays are read-only: copy into a tensor.
    return torch.tensor(np.asarray(leaf), device=device)


def _set_tree_path(tree, path: str, leaf) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    if parts[-1] not in node:
        raise KeyError(path)
    node[parts[-1]] = leaf


def _none_like(node):
    if isinstance(node, dict):
        return {k: _none_like(v) for k, v in node.items()}
    return None


def _missing_paths(node, prefix=""):
    if isinstance(node, dict):
        out = []
        for k, v in node.items():
            out.extend(_missing_paths(v, f"{prefix}{k}/"))
        return out
    return [prefix[:-1]] if node is None else []


def load_quantized_params(
    params_shape,
    unit_source: Callable[[], Iterable[Tuple[str, List[Tuple[str, Any]]]]],
    scheme: str,
    group_size: Optional[int] = None,
    device="cpu",
    cache_dir: Optional[str] = None,
    cache_key: Optional[str] = None,
    prefetch_depth: Optional[int] = None,
):
    """Stream a checkpoint into a weight-quantized Flax-path tree.

    ``params_shape``: the float tree's structure (nested dict; leaves
    only need ``.shape``).  ``unit_source``: a zero-argument callable
    yielding ``(unit_name, [(tree_path, array), ...])`` per unit; it is
    called only on a cache miss.  Returns the nested dict with a
    ``QuantizedParam`` for every rule-matched kernel and every leaf a
    tensor on ``device``.
    """
    group_size = WQ_DEFAULT_GROUP if group_size is None else group_size
    depth = resolve_prefetch_depth(prefetch_depth)
    t0 = time.monotonic()

    cached = wq_cache.iter_entry_or_none(cache_dir, cache_key)
    cache_state = "off" if not (cache_dir and cache_key) else (
        "hit" if cached is not None else "miss"
    )
    writer = None
    if cached is not None:
        # Warm path: leaves come back quantized (memory-mapped); one
        # pipeline item per leaf keeps the in-flight window bounded.
        units: Iterable = [(path, [(path, leaf)]) for path, leaf in cached]
    else:
        units = unit_source()
        if cache_dir and cache_key:
            writer = wq_cache.WqCacheWriter(cache_dir, cache_key)

    staged = {"now": 0, "peak": 0, "units": 0, "leaves": 0}

    def stage_quantize(item):
        unit_name, leaves = item
        float_bytes = sum(_leaf_bytes(leaf) for _, leaf in leaves)
        with _LOAD_LOCK:
            staged["now"] += float_bytes
            staged["peak"] = max(staged["peak"], staged["now"])
            staged["units"] += 1
            staged["leaves"] += len(leaves)
        out = []
        for path, leaf in leaves:
            n_contract = wq_rule_for_path(path)
            if n_contract is not None and not isinstance(leaf,
                                                         QuantizedParam):
                leaf = quantize_array(np.asarray(leaf), scheme, n_contract,
                                      group_size)
            if writer is not None:
                writer.add(path, leaf)
            out.append((path, leaf))
        with _LOAD_LOCK:
            staged["now"] -= float_bytes
        return unit_name, out

    def stage_h2d(item):
        unit_name, leaves = item
        return unit_name, [(path, _to_device(leaf, device))
                           for path, leaf in leaves]

    out_tree = _none_like(params_shape)
    pipeline = PrefetchPipeline(
        [Stage("wq_quantize", stage_quantize), Stage("wq_h2d", stage_h2d)],
        depth=depth, name="wq_load",
    )
    for _, leaves in pipeline.run(units):
        for path, leaf in leaves:
            _set_tree_path(out_tree, path, leaf)
    published = writer.publish() if writer is not None else False

    missing = _missing_paths(out_tree)
    if missing:
        raise ValueError(
            "checkpoint stream did not cover the param tree; missing: "
            + ", ".join(missing[:8])
        )
    stats = {
        "scheme": scheme,
        "group_size": group_size,
        "cache": cache_state,
        "cache_stored": bool(published),
        "peak_host_staging_bytes": staged["peak"],
        "units": staged["units"],
        "leaves": staged["leaves"],
        "prefetch_depth": depth,
        "load_seconds": round(time.monotonic() - t0, 6),
    }
    with _LOAD_LOCK:
        _LAST_LOAD_STATS.clear()
        _LAST_LOAD_STATS.update(stats)
    from music_analyst_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    tel.gauge("wq_load.peak_host_staging_bytes", staged["peak"])
    tel.gauge("wq_load.seconds", stats["load_seconds"])
    tel.count(f"wq_load.cache_{cache_state}")
    return out_tree
