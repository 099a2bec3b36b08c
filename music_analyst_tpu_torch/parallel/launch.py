"""The CLI's rank launcher: ``--devices N`` is one command.

The calling process is rank 0 of an N-rank mesh; :func:`run_ranks`
starts ranks 1..N-1 as ``python -m music_analyst_tpu_torch <same argv>``
with the rank, world size, coordinator address, device and group timeout
in their environment (``multihost.join_from_env`` is their side), before
this process imports torch, so the ranks' start-ups overlap.  Every rank
works out the same backend (``multihost.mesh_backend``: NCCL when each
rank has a card of its own, gloo when ranks share a card or run on the
CPU).  A watcher kills every rank and ends this process with exit code 1
the moment one fails, so no rank is left blocked in a collective.  Only
rank 0 writes, inside its command: a rank that fails before that command
has returned leaves no output.  One window stays open: a rank that fails
after its last collective (reporting its launches, leaving the group)
while rank 0 has already written still makes the command exit 1; rank
0's files are then complete, and the watcher's message says so.  This
module imports no torch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional, Sequence

ENV_RANK = "MUSICAAL_RANK"
ENV_WORLD = "MUSICAAL_WORLD_SIZE"
ENV_COORDINATOR = "MUSICAAL_COORDINATOR"
ENV_DEVICE = "MUSICAAL_RANK_DEVICE"
ENV_TIMEOUT = "MUSICAAL_DIST_TIMEOUT_S"


def launched_rank() -> Optional[int]:
    """This process's rank when :func:`run_ranks` started it, else
    ``None``."""
    value = os.environ.get(ENV_RANK)
    return None if value is None else int(value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], n_ranks: int, device: str,
              body: Callable[[], int], timeout_s: float = 300.0) -> int:
    """Run ``body`` as rank 0 of ``n_ranks`` on ``device``, ranks
    1..N-1 being child processes of this one; the process group lives
    for ``body``'s call and is destroyed in a ``finally``.  After
    ``body`` returns, the children are awaited under one deadline
    (``timeout_s``, also every collective's timeout)."""
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, **{ENV_WORLD: str(n_ranks),
                              ENV_COORDINATOR: address,
                              ENV_DEVICE: device,
                              ENV_TIMEOUT: str(timeout_s)})
    if "OMP_NUM_THREADS" not in os.environ:
        # Ranks on one host split its cores (as the replica router does).
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_ranks))
    children = []

    def _kill_children() -> None:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()

    try:
        for rank in range(1, n_ranks):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "music_analyst_tpu_torch", *argv],
                env=dict(env, **{ENV_RANK: str(rank)}),
                stdout=subprocess.DEVNULL,
            ))
            print(f"mesh: rank {rank} pid {children[-1].pid}",
                  file=sys.stderr, flush=True)
        # torch, and the device check, while the children start.
        from music_analyst_tpu_torch.device import resolve_device
        from music_analyst_tpu_torch.parallel import multihost

        resolve_device(device)
        backend = multihost.mesh_backend(n_ranks, device)
    except BaseException:
        _kill_children()
        raise
    print(f"mesh: {n_ranks} ranks over {backend}", file=sys.stderr,
          flush=True)
    done = threading.Event()
    returned = threading.Event()

    def _fail(reason: str) -> None:
        for child in children:
            if child.poll() is None:
                child.kill()
        if returned.is_set():
            reason += (" after rank 0's command returned (its output is "
                       "written and complete)")
        print(f"mesh: {reason}; every rank stopped", file=sys.stderr,
              flush=True)
        os._exit(1)

    def _watch() -> None:
        while not done.is_set():
            for rank, child in enumerate(children, start=1):
                code = child.poll()
                if code not in (None, 0):
                    _fail(f"rank {rank} exited with {code}")
            time.sleep(0.05)

    threading.Thread(target=_watch, name="mesh-watch", daemon=True).start()
    try:
        multihost.initialize(address, n_ranks, 0, backend=backend,
                             timeout_s=timeout_s)
        try:
            code = body()
            if code == 0:
                returned.set()
        finally:
            multihost.shutdown()
        deadline = time.monotonic() + timeout_s
        while any(c.poll() is None for c in children):
            if time.monotonic() > deadline:
                _fail("ranks still running at the deadline")
            time.sleep(0.05)
        return code
    except BaseException:
        done.set()
        _kill_children()
        raise
    finally:
        done.set()
