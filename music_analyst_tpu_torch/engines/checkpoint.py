"""Train-state checkpoints and the streaming weight-quantized inference
loader.

Counterpart of ``music_analyst_tpu/engines/checkpoint.py``.
:func:`save_train_state` / :func:`restore_train_state` keep a train state
(``engines/train.py``: f32 master params, both AdamW moments, the step) in
torch format, one file ``train_state.pt`` in the checkpoint directory,
written atomically, keyed by parameter name and holding the global
tensors whatever mesh saved it, so it restores onto any mesh of the same
model (JAX's orbax checkpoint restores onto any mesh with the same global
shapes).  A file of the one-device layout written before format 2
(the masters, the optimizer's ``state_dict`` and the step) still
restores, onto one device or a mesh.  The JAX package writes orbax
checkpoints, which only JAX can read; the port neither reads nor writes
that format, so a state moves between the packages only as parameters
(``params_from_jax``).

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

import dataclasses
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
TRAIN_STATE_FORMAT = 2
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _global(block: torch.Tensor, name: str, state: TrainState,
            gather: bool) -> torch.Tensor:
    """The whole tensor of this rank's block of ``name``: all-gathered
    along each split dimension over the mesh axis that splits it (``ep``
    for an expert stack's first, ``tp`` for the others) when ``gather``."""
    piece = state.tp_layout.get(name)
    if piece is None or not gather:
        return block
    from music_analyst_tpu_torch.parallel.mesh import all_gather
    from music_analyst_tpu_torch.parallel.sharding import (
        prune_spec,
        spec_for_path,
    )

    spec = prune_spec(spec_for_path(name), state.mesh.axis_names)
    for dim, (lo, hi) in enumerate(piece.bounds):
        if (lo, hi) != (0, piece.full_shape[dim]):
            block = all_gather(block, state.mesh, spec[dim], dim=dim)
    return block


def save_train_state(state: TrainState, path: str) -> str:
    """Save ``state`` into the directory ``path`` (absolute or
    cwd-relative; created if missing); returns its absolute path.  The
    file is staged and renamed into place, so a crash leaves the previous
    checkpoint whole.

    One file in one format whatever the mesh: the global f32 masters,
    both AdamW moments and their step counts, each keyed by parameter
    name, with the optimizer's settings and the step.  On a mesh every
    rank calls this (a collective): ZeRO-1 slices are all-gathered over
    ``dp`` and blocks over ``ep`` and ``tp``, one parameter at a time,
    the coordinator (rank 0) writes the file, and every rank returns once
    it is in place."""
    from music_analyst_tpu_torch.parallel import multihost
    from music_analyst_tpu_torch.parallel.mesh import all_gather_rows_

    path = os.path.abspath(path)
    mesh = state.mesh
    writer = mesh is None or mesh.rank == 0
    # The ranks of dp row 0 hold every ep and tp block: they gather.
    gather = mesh is None or mesh.coord("dp") == 0
    saved = {"format": TRAIN_STATE_FORMAT, "params": {}, "adam_step": {},
             **{key: {} for key in _MOMENTS}}
    for name, stepped in state.opt_tensors().items():
        master = state.params[name]
        entry = state.opt_state.state.get(stepped, {})
        values = {"params": master}
        for key in _MOMENTS:
            moment = entry.get(key)
            if moment is None:              # before the first step
                moment = torch.zeros_like(stepped)
            zero1 = state.zero1.get(name)
            if zero1 is not None:
                whole = torch.empty_like(master)
                zero1.take(whole).copy_(moment)
                all_gather_rows_([whole], mesh, "dp")
                moment = whole
            values[key] = moment
        for key, value in values.items():
            value = _global(value, name, state, gather)
            if writer:
                saved[key][name] = value.detach().to("cpu", copy=True)
        if writer:
            saved["adam_step"][name] = float(entry.get("step", 0.0))
    if writer:
        group = {k: v for k, v in state.opt_state.param_groups[0].items()
                 if k != "params"}
        saved.update(param_group=group, step=int(state.step))
        with atomic_write(os.path.join(path, TRAIN_STATE_FILE), "wb",
                          encoding=None) as fh:
            torch.save(saved, fh)
    if mesh is not None:
        multihost.barrier("save_train_state")
    return path


def _from_format_1(saved: Dict[str, Any]) -> Dict[str, Any]:
    """A train state of the one-device layout written before format 2
    (``params``, the optimizer's ``state_dict`` as ``opt_state``,
    ``step``) in format 2's: the optimizer's per-index state under the
    parameters' names, zero moments and step 0 where a parameter was never
    stepped."""
    opt = saved["opt_state"]
    group = dict(opt["param_groups"][0])
    ids = group.pop("params")
    out = {"format": TRAIN_STATE_FORMAT, "params": saved["params"],
           "adam_step": {}, **{key: {} for key in _MOMENTS},
           "param_group": group, "step": saved["step"]}
    for name, i in zip(saved["params"], ids):
        entry = opt["state"].get(i, {})
        out["adam_step"][name] = float(entry.get("step", 0.0))
        for key in _MOMENTS:
            out[key][name] = entry.get(key,
                                       torch.zeros_like(saved["params"][name]))
    return out


def restore_train_state(path: str, like: Optional[TrainState] = None,
                        device: DeviceLike = "cuda") -> TrainState:
    """Restore the state saved in ``path``.  With ``like``, the saved
    values are copied into ``like``'s tensors and optimizer (its devices,
    mesh and layout; the names must match) and ``like`` is returned with
    the saved step — each rank takes its block (``ep``, ``tp``) and, under
    ZeRO-1, its slice of the moments, so a state saved on one mesh
    restores onto another or onto one device; otherwise a new one-device
    state is built on ``device``."""
    path = os.path.join(os.path.abspath(path), TRAIN_STATE_FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    if "format" not in saved and "opt_state" in saved:
        saved = _from_format_1(saved)
    if saved.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"{path} is not a train state of format "
                         f"{TRAIN_STATE_FORMAT}")
    if like is not None:
        if list(saved["params"]) != list(like.params):
            raise ValueError(
                f"{path} holds other parameters than the state to restore "
                "into"
            )
        dev = like.step.device

        def block(name, full):
            piece = like.tp_layout.get(name)
            return piece.take(full) if piece is not None else full

        with torch.no_grad():
            for name, master in like.params.items():
                master.copy_(block(name, saved["params"][name]))
        params, opt, zero1 = like.params, like.opt_state, like.zero1
    else:
        dev = resolve_device(device)
        params = {name: value.detach().to(dev, copy=True)
                  for name, value in saved["params"].items()}
        group = saved["param_group"]
        opt = AdamW(group["lr"], group["weight_decay"], *group["betas"],
                    group["eps"]).init(params.values())
        zero1 = {}

        def block(name, full):
            return full

    moments = {}
    for i, name in enumerate(params):
        entry = {"step": torch.tensor(saved["adam_step"][name],
                                      dtype=torch.float32)}
        for key in _MOMENTS:
            value = block(name, saved[key][name])
            if name in zero1:
                value = zero1[name].take(value.contiguous())
            entry[key] = value.to(dev, copy=True)
        moments[i] = entry
    # The fused update runs only on the card: keep this optimizer's own
    # choice, take every other saved setting and the moments.
    group = dict(saved["param_group"], fused=opt.param_groups[0]["fused"],
                 params=list(range(len(params))))
    opt.load_state_dict({"state": moments, "param_groups": [group]})
    step = torch.tensor(saved["step"], dtype=torch.int32, device=dev)
    if like is not None:
        return dataclasses.replace(like, step=step)
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
