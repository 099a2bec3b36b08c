"""Device mesh of the port: an ordered list of devices on one ``dp`` axis.

The counterpart of ``music_analyst_tpu/parallel/mesh.py:data_parallel_mesh``
for the data-parallel word count.  The JAX mesh is a named
``jax.sharding.Mesh``; the port needs only what the histogram engine reads
from it: the devices in order, the axis name and its size.  This slice
runs on one card (``n_devices`` 1); a larger count raises until the NCCL
port (roadmap item 8).  No ``torch.distributed`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices along one named axis (``dp``)."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def data_parallel_mesh(
    n_devices: Optional[int] = None,
    axis: str = "dp",
    device: DeviceLike = "cuda",
) -> DeviceMesh:
    """1-D data-parallel mesh over ``device`` (default the CUDA card;
    ``device="cpu"`` for the tests).  Only one device is supported."""
    if n_devices is not None and int(n_devices) != 1:
        raise NotImplementedError(
            f"a mesh of {n_devices} devices is not yet ported to "
            "music_analyst_tpu_torch (one device only)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        # Create the card's context now, as building a JAX mesh initialises
        # its backend: the first histogram then does not pay for it inside
        # the engine's device_compute stage.
        torch.zeros((1,), device=dev)
    return DeviceMesh((dev,), axis)
