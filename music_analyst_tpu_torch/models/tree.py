"""Helpers for the models' Flax-tree mappings (``params_from_jax``).

A Flax parameter tree is a nested dict addressed by "/"-joined paths
(``encoder/layer_0/attention/q_proj/kernel``); its kernels are
``[*contract, *features]``.  These helpers move its leaves into the port's
``state_dict`` names and layouts, for numpy arrays and tensors alike, and
carry stored quantized kernels (``QuantizedParam``: JAX's or the port's)
across unchanged.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def is_quantized(leaf) -> bool:
    """Whether ``leaf`` is a stored quantized kernel (duck-typed, so the
    JAX package's ``QuantizedParam`` counts without being imported)."""
    return all(hasattr(leaf, a) for a in ("q", "scale", "scheme", "shape"))


def f32(x):
    """``x`` as float32, keeping its kind (tensor or numpy array)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return np.asarray(x, dtype=np.float32)


def _transposed(x):
    if isinstance(x, torch.Tensor):
        return x.t().contiguous()
    return np.ascontiguousarray(x.T)


def put_kernel(out: Dict[str, object], name: str, kernel,
               n_contract: int = 1) -> None:
    """Store a Flax kernel at ``name``: a float one as ``{name}.weight``
    in ``nn.Linear`` layout ``[out, in]``; a quantized one as
    ``{name}.q`` / ``{name}.scale`` in its Flax layout (``WqLinear``)."""
    if is_quantized(kernel):
        out[f"{name}.q"] = kernel.q
        out[f"{name}.scale"] = kernel.scale
        return
    k = f32(kernel)
    K = int(math.prod(k.shape[:n_contract]))
    out[f"{name}.weight"] = _transposed(k.reshape(K, -1))


def as_tensor(value) -> torch.Tensor:
    """A state-dict value as a tensor (numpy arrays, memory-mapped ones
    included, are copied; tensors pass through)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(np.asarray(value))
