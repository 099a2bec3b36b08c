"""The rank launcher: one command runs as an N-rank mesh.

The calling process is rank 0; :func:`run_ranks` starts ranks 1..N-1 as
child processes of a command its caller gives (the CLI's is
:func:`module_command`, ``python -m music_analyst_tpu_torch <same
argv>``), with the rank, world size, coordinator address, device and
group timeout in their environment (``multihost.join_from_env`` is their
side), before this process imports torch, so the ranks' start-ups
overlap.  Every rank works out the same backend
(``multihost.mesh_backend``: NCCL when each rank has a card of its own,
gloo when ranks share a card or run on the CPU).

Only rank 0 writes, and it writes into a :class:`Staging` directory
beside the output directory.  :func:`run_ranks` moves the staged files
into the output directory only once rank 0's command has returned 0 and
every other rank has exited 0; a rank that fails at any moment, after its
last collective included, leaves the staging directory removed and
nothing published, and files already in the output directory untouched.
The moment a rank fails, a watcher kills the others, so no rank is left
blocked in a collective; this process then removes the staging
directory and exits 1 as soon as its command stops writing (it returns
or raises), or after ``END_GRACE_S`` if it stays blocked on the dead
peer.  This module imports no torch.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence

ENV_RANK = "MUSICAAL_RANK"
ENV_WORLD = "MUSICAAL_WORLD_SIZE"
ENV_COORDINATOR = "MUSICAAL_COORDINATOR"
ENV_DEVICE = "MUSICAAL_RANK_DEVICE"
ENV_TIMEOUT = "MUSICAAL_DIST_TIMEOUT_S"

STAGING_INFIX = ".staging-"
# How long a failed rank's watcher waits for rank 0 to come out of its
# command before it ends the run itself.
END_GRACE_S = 5.0


def launched_rank() -> Optional[int]:
    """This process's rank when :func:`run_ranks` started it, else
    ``None``."""
    value = os.environ.get(ENV_RANK)
    return None if value is None else int(value)


def module_command(argv: Sequence[str]) -> List[str]:
    """The CLI's child command: the port's CLI with ``argv``."""
    return [sys.executable, "-m", "music_analyst_tpu_torch", *argv]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inside(path: str, root: str) -> Optional[str]:
    """``path`` relative to ``root`` when it lies under it, else ``None``."""
    rel = os.path.relpath(os.path.abspath(path), root)
    return None if rel == os.pardir or rel.startswith(os.pardir + os.sep) \
        else rel


class Staging:
    """Rank 0's outputs while the mesh runs: a directory beside
    ``output_dir``, named ``.<name>.staging-<pid>-<random>``, whose files
    :meth:`publish` moves into ``output_dir`` one rename each.

    ``carry`` names files under ``output_dir`` that the run appends to
    (the telemetry log, a resumed details file): they are copied in first,
    so the originals stay untouched until the publish.  A rank 0 killed
    outright leaves its staging directory behind, under a hidden name
    that no run reads."""

    def __init__(self, output_dir: str, carry: Sequence[str] = ()) -> None:
        self.output_dir = os.path.abspath(output_dir)
        parent, name = os.path.split(self.output_dir)
        os.makedirs(parent, exist_ok=True)
        self.path = tempfile.mkdtemp(
            prefix=f".{name}{STAGING_INFIX}{os.getpid()}-", dir=parent)
        for src in carry:
            dst = self.staged(src)
            if dst != src and os.path.isfile(src):
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)

    def staged(self, path: str) -> str:
        """Where ``path`` is written while staging: its place under the
        staging directory if it lies under ``output_dir``, else itself."""
        rel = _inside(path, self.output_dir)
        return path if rel is None else os.path.normpath(
            os.path.join(self.path, rel))

    def published(self, path: str) -> str:
        """Where a staged ``path`` lands once published."""
        rel = _inside(path, self.path)
        return path if rel is None else os.path.normpath(
            os.path.join(self.output_dir, rel))

    def publish(self) -> None:
        """Move every staged file into ``output_dir`` (each by one
        rename, under the corpus cache's short retry), then remove the
        staging directory."""
        from music_analyst_tpu_torch.resilience.policy import RetryPolicy

        retry = RetryPolicy(base_s=0.02, cap_s=0.2)
        for root, _, files in os.walk(self.path):
            dest = self.published(root)
            os.makedirs(dest, exist_ok=True)
            for name in files:
                retry.call(os.replace, os.path.join(root, name),
                           os.path.join(dest, name), site="launch.publish")
        self.discard()

    def discard(self) -> None:
        """Remove the staging directory, renamed away first, so that a
        write into it that is still under way cannot leave it behind."""
        doomed = f"{self.path}.discarded"
        try:
            os.rename(self.path, doomed)
        except OSError:
            doomed = self.path
        shutil.rmtree(doomed, ignore_errors=True)


def run_ranks(command: Sequence[str], n_ranks: int, device: str,
              body: Callable[[], int], timeout_s: float = 300.0,
              staging: Optional[Staging] = None) -> int:
    """Run ``body`` as rank 0 of ``n_ranks`` on ``device``, ranks
    1..N-1 being ``command`` in child processes of this one; the process
    group lives for ``body``'s call and is destroyed in a ``finally``.
    After ``body`` returns, the children are awaited under one deadline
    (``timeout_s``, also every collective's timeout).  ``staging`` is
    published when ``body`` returned 0 and every child exited 0, and
    removed in every other case.  One rank runs ``body`` alone."""
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, **{ENV_WORLD: str(n_ranks),
                              ENV_COORDINATOR: address,
                              ENV_DEVICE: device,
                              ENV_TIMEOUT: str(timeout_s)})
    if "OMP_NUM_THREADS" not in os.environ:
        # Ranks on one host split its cores (as the replica router does).
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_ranks))
    children: List[subprocess.Popen] = []

    def _kill_children() -> None:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()

    def _discard() -> None:
        if staging is not None:
            staging.discard()

    try:
        for rank in range(1, n_ranks):
            children.append(subprocess.Popen(
                list(command), env=dict(env, **{ENV_RANK: str(rank)}),
                stdout=subprocess.DEVNULL,
            ))
            sys.stderr.write(f"mesh: rank {rank} pid {children[-1].pid}\n")
            sys.stderr.flush()
        if n_ranks > 1:
            # torch, and the device check, while the children start.
            from music_analyst_tpu_torch.device import resolve_device
            from music_analyst_tpu_torch.parallel import multihost

            resolve_device(device)
            backend = multihost.mesh_backend(n_ranks, device)
            sys.stderr.write(f"mesh: {n_ranks} ranks over {backend}\n")
            sys.stderr.flush()
    except BaseException:
        _kill_children()
        _discard()
        raise
    done = threading.Event()       # the watcher stands down
    left_body = threading.Event()  # rank 0 writes nothing after this
    ending = threading.Lock()
    failure: List[str] = []

    def _end(reason: str) -> None:
        with ending:
            done.set()
            for child in children:
                if child.poll() is None:
                    child.kill()
            _discard()
            sys.stderr.write(f"mesh: {reason}; every rank stopped, nothing "
                             f"published\n")
            sys.stderr.flush()
            os._exit(1)

    def _watch() -> None:
        while not done.is_set():
            for rank, child in enumerate(children, start=1):
                code = child.poll()
                if code in (None, 0):
                    continue
                with ending:
                    if done.is_set():
                        return
                    failure.append(f"rank {rank} exited with {code}")
                    for other in children:
                        if other.poll() is None:
                            other.kill()
                # Rank 0's command may still be writing its staged files:
                # it ends the run itself once it comes out of them.  If it
                # is stuck instead (a collective or the group's start
                # waiting on a dead peer), it writes nothing, and the run
                # ends here.
                left_body.wait(END_GRACE_S)
                _end(failure[0])
            time.sleep(0.05)

    if children:
        threading.Thread(target=_watch, name="mesh-watch",
                         daemon=True).start()
    try:
        if n_ranks > 1:
            multihost.initialize(address, n_ranks, 0, backend=backend,
                                 timeout_s=timeout_s)
        try:
            code = body()
        finally:
            if n_ranks > 1:
                multihost.shutdown()
            left_body.set()
        deadline = time.monotonic() + timeout_s
        while any(c.poll() is None for c in children):
            if failure:
                _end(failure[0])
            if time.monotonic() > deadline:
                _end("ranks still running at the deadline")
            time.sleep(0.05)
        for rank, child in enumerate(children, start=1):
            if child.returncode != 0:
                _end(failure[0] if failure else
                     f"rank {rank} exited with {child.returncode}")
        with ending:
            done.set()
        if code == 0 and staging is not None:
            staging.publish()
        return code
    except BaseException:
        left_body.set()
        if failure:
            # Whatever rank 0 raised, a rank had failed first.
            _end(failure[0])
        with ending:
            done.set()
        _kill_children()
        raise
    finally:
        left_body.set()
        with ending:
            done.set()
        _discard()
