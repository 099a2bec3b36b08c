"""Train-state checkpoints and the streaming weight-quantized inference
loader.

Counterpart of ``music_analyst_tpu/engines/checkpoint.py``.
:func:`save_train_state` / :func:`restore_train_state` keep a train state
(``engines/train.py``: f32 master params, both AdamW moments, the step) in
torch format, one file ``train_state.pt`` in the checkpoint directory,
written atomically.  The JAX package writes orbax checkpoints, which only
JAX can read; the port neither reads nor writes that format, so a state
moves between the packages only as parameters (``params_from_jax``).

``load_quantized_params`` / ``last_load_stats``: HF torch tensors are read one layer-sized
unit at a time (the model families' ``iter_hf_param_units``), quantized on
the host, and copied to the device through the bounded
``runtime/prefetch.py`` pipeline: the copy of unit *k* overlaps the
quantization of unit *k+1*, and the float tree never exists whole
(``last_load_stats()["peak_host_staging_bytes"]`` is the measured peak of
float bytes staged at once).  Quantized leaves are persisted through the
content-addressed ``engines/wq_cache.py``, so a warm load reads codes and
never touches ``torch.load``.  The quantize stage opens with the
``checkpoint.load`` fault seam and the copy stage with ``h2d.transfer``;
the prefetch stage retry re-runs a failed unit, as in JAX.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines import wq_cache
from music_analyst_tpu_torch.engines.train import AdamW, TrainState
from music_analyst_tpu_torch.ops.quant import (
    WQ_DEFAULT_GROUP,
    QuantizedParam,
    quantize_array,
    wq_rule_for_path,
)
from music_analyst_tpu_torch.resilience.faults import fault_point
from music_analyst_tpu_torch.runtime.prefetch import (
    PrefetchPipeline,
    Stage,
    resolve_prefetch_depth,
)
from music_analyst_tpu_torch.utils.atomic import atomic_write

TRAIN_STATE_FILE = "train_state.pt"


def save_train_state(state: TrainState, path: str) -> str:
    """Save ``state`` into the directory ``path`` (absolute or
    cwd-relative; created if missing); returns its absolute path.  The
    file is staged and renamed into place, so a crash leaves the previous
    checkpoint whole."""
    path = os.path.abspath(path)
    with atomic_write(os.path.join(path, TRAIN_STATE_FILE), "wb",
                      encoding=None) as fh:
        torch.save({"params": state.params,
                    "opt_state": state.opt_state.state_dict(),
                    "step": int(state.step)}, fh)
    return path


def restore_train_state(path: str, like: Optional[TrainState] = None,
                        device: DeviceLike = "cuda") -> TrainState:
    """Restore the state saved in ``path``.  With ``like``, the saved
    values are copied into ``like``'s tensors and optimizer (its devices
    and structure; the names must match) and ``like`` is returned with the
    saved step; otherwise a new state is built on ``device``."""
    path = os.path.join(os.path.abspath(path), TRAIN_STATE_FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    opt_saved = saved["opt_state"]
    if like is not None:
        if list(saved["params"]) != list(like.params):
            raise ValueError(
                f"{path} holds other parameters than the state to restore "
                "into"
            )
        with torch.no_grad():
            for name, value in saved["params"].items():
                like.params[name].copy_(value)
        params, opt = like.params, like.opt_state
        dev = like.step.device
    else:
        dev = resolve_device(device)
        params = {name: value.detach().to(dev, copy=True)
                  for name, value in saved["params"].items()}
        group = opt_saved["param_groups"][0]
        opt = AdamW(group["lr"], group["weight_decay"], *group["betas"],
                    group["eps"]).init(params.values())
    # The fused update runs only on the card: keep this optimizer's own
    # choice, take every other saved setting and the moments.
    for saved_group, group in zip(opt_saved["param_groups"],
                                  opt.param_groups):
        saved_group["fused"] = group["fused"]
    opt.load_state_dict(opt_saved)
    step = torch.tensor(saved["step"], dtype=torch.int32, device=dev)
    return TrainState(params=params, opt_state=opt, step=step)

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
        # First statement on purpose: an injected checkpoint.load trip
        # raises before any staging or writer side effect, so the prefetch
        # stage retry re-runs the unit from scratch.
        fault_point("checkpoint.load", unit=unit_name)
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
        fault_point("h2d.transfer", unit=unit_name)
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
