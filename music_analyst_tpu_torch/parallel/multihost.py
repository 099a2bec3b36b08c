"""Multi-process coordination: the Bcast/Barrier analogues.

The port's counterpart of ``music_analyst_tpu/parallel/multihost.py``.
The reference synchronises ranks with ``MPI_Bcast`` (split-file names,
``src/parallel_spotify.c:830-831``) and ``MPI_Barrier`` (``:850,1067``);
JAX maps them onto ``jax.experimental.multihost_utils``.  Here they are
``torch.distributed`` collectives over the default process group, one
process per rank.  Every call degrades to the trivial result when
``torch.distributed`` is not initialised or the world has one process, so
engine code calls them unconditionally.

:func:`initialize` / :func:`shutdown` take the place of
``jax.distributed.initialize``.  The backend is explicit: ``gloo`` (host
tensors; the one that runs several ranks on one card, where NCCL refuses
two ranks on one device) or ``nccl`` (one card per rank).  Collective
payloads live where the backend wants them: host tensors under gloo, the
rank's card under NCCL (:func:`transport_device`).  Byte payloads stay
``uint8`` end to end.
"""

from __future__ import annotations

import datetime
import pickle
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# A peer that died leaves its partners in a collective; after this long
# the collective raises instead of waiting for ever.
DEFAULT_TIMEOUT_S = 300.0


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    backend: str = "gloo",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the default process group as rank ``process_id`` of
    ``num_processes``; rank 0 listens on ``coordinator_address``
    (``host:port``, or a full ``tcp://host:port``).  Under NCCL the
    rank's card, ``cuda:(process_id % device_count)``, becomes current."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=address, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """Process 0 — the analogue of the reference's rank-0 master role."""
    return process_index() == 0


def backend(group=None) -> Optional[str]:
    """The process group's backend name, or ``None`` outside a group."""
    return str(dist.get_backend(group)) if _initialized() else None


def transport_device(group=None) -> torch.device:
    """Where a collective's tensors must lie: the host under gloo, this
    rank's current card under NCCL."""
    if backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_coordinator(value: Any) -> Any:
    """Broadcast a picklable host value from process 0 to all processes."""
    if process_count() == 1:
        return value
    box = [value if is_coordinator() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (``name`` labels the
    call site, as JAX's ``sync_global_devices`` does)."""
    if process_count() == 1:
        return
    dist.barrier()


def all_agree(value) -> bool:
    """Whether a host value is identical on every process.  A collective:
    every process must call it."""
    if process_count() == 1:
        return True
    mine = np.asarray(value)
    gathered = [pickle.loads(b) for b in allgather_bytes(pickle.dumps(mine))]
    return all(g.dtype == mine.dtype and np.array_equal(g, gathered[0])
               for g in gathered)


def _byte_row(payload: bytes, width: int) -> torch.Tensor:
    row = torch.zeros((width,), dtype=torch.uint8)
    if payload:
        row[: len(payload)] = torch.from_numpy(
            np.frombuffer(payload, dtype=np.uint8).copy())
    return row


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Gather one byte string from every process, in process order.

    The building block for metadata exchange (vocabulary merge) that the
    reference does with serialised ``MPI_Send``/``MPI_Recv`` strings
    (``src/parallel_spotify.c:396-432``).  Collectives need uniform
    shapes, so this is two rounds: an all-gather of the lengths, then an
    all-gather of max-length-padded ``uint8`` rows.
    """
    n = process_count()
    if n == 1:
        return [payload]
    dev = transport_device()
    length = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length)
    lengths = [int(t.item()) for t in lengths]
    width = max(1, max(lengths))
    rows = [torch.empty((width,), dtype=torch.uint8, device=dev)
            for _ in range(n)]
    dist.all_gather(rows, _byte_row(payload, width).to(dev))
    return [rows[i][: lengths[i]].cpu().numpy().tobytes() for i in range(n)]


def broadcast_bytes(payload: Optional[bytes]) -> bytes:
    """Broadcast a byte string from the coordinator to every process.

    The analogue of the reference's ``MPI_Bcast`` of the split-file names
    (``src/parallel_spotify.c:830-831``), for variable-size payloads:
    the length first, then the padded ``uint8`` row.  Only the
    coordinator's ``payload`` is read.
    """
    if is_coordinator() and payload is None:
        raise ValueError("broadcast_bytes: the coordinator's payload is None")
    if process_count() == 1:
        return payload
    dev = transport_device()
    data = payload if is_coordinator() else b""
    length = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(length, src=0)
    n = int(length.item())
    row = _byte_row(data, max(1, n)).to(dev)
    dist.broadcast(row, src=0)
    return row[:n].cpu().numpy().tobytes()
